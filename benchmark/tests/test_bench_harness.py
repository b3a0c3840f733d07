"""The benchmark's data layer and traffic generator, on the CPU."""
from __future__ import annotations

import collections
import json
import re
import shutil

import numpy as np
import pytest

from benchmark.harness import traffic
from benchmark.harness.core import ROOT, load_cell, load_reader, runner

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve_by_name(cell):
    loaded = load_cell(cell)
    assert loaded.config["model"]["output_shape"][0] in (256, 512)
    assert callable(runner(loaded).run) and callable(runner(loaded).control_readings)
    assert (ROOT / "benchmark" / "traffic" / f"{loaded.traffic_name}.json").is_file()


def test_the_runner_is_found_by_the_entry_name_and_reads_every_key():
    cell = load_cell("serve_512_bulk")
    assert runner(cell).__name__ == "benchmark.harness.serve"
    cell.traffic = dict(cell.traffic, clients=4)
    with pytest.raises(ValueError, match="clients"):
        runner(cell)
    cell.traffic = dict(load_cell("serve_512_bulk").traffic, entry="../core")
    with pytest.raises(ValueError):
        runner(cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_resolve_by_name(metric):
    assert callable(load_reader(metric))


def test_names_and_units_use_the_allowed_characters():
    names = ([m["name"] for m in METRICS] + [c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_layer_metrics_move(cell):
    loaded = load_cell(cell)
    reported = {m["name"] for m in loaded.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert loaded.per_layer
    assert all(m["moves"] in reported for m in loaded.per_layer)


def test_requests_repeat_for_a_seed():
    loaded = load_cell("serve_512_bulk")
    widths = {"a": 3, "b": 5}
    first = [next(g) for g in [traffic.serve_requests(loaded.traffic, widths, 2 ** 31 + 5)]
             for _ in range(50)]
    stream = traffic.serve_requests(loaded.traffic, widths, 2 ** 31 + 5)
    again = [next(stream) for _ in range(50)]
    other = traffic.serve_requests(loaded.traffic, widths, 7)
    different = [next(other) for _ in range(50)]
    assert all(np.array_equal(a.photos, b.photos) and np.array_equal(a.value, b.value)
               for a, b in zip(first, again))
    assert any(not np.array_equal(a.photos, b.photos) for a, b in zip(again, different))


def test_demo_sessions_repeat_for_a_seed():
    t = load_cell("serve_256_interactive").traffic
    widths = {"a": 3, "b": 5}

    def sessions(seed):
        stream = traffic.demo_sessions(t, widths, seed, 4)
        return [next(stream) for _ in range(12)]

    def same(x, y):
        return (np.array_equal(x.photos, y.photos) and x.checked == y.checked
                and x.events.keys() == y.events.keys()
                and all(str(x.events[k]) == str(y.events[k]) for k in x.events))

    assert all(same(a, b) for a, b in zip(sessions(2 ** 31 + 5), sessions(2 ** 31 + 5)))
    assert not all(same(a, b) for a, b in zip(sessions(2 ** 31 + 5), sessions(7)))


def test_demo_mix_is_exact_in_every_block():
    t = load_cell("serve_256_interactive").traffic
    widths = {f"attr{i}": 2 + i for i in range(11)}
    stream = traffic.demo_sessions(t, widths, 123, int(t["check_frames"]))
    sessions = [next(stream) for _ in range(40)]  # 10 blocks of 4 sizes
    assert collections.Counter(len(s) for s in sessions) == {6: 30, 1: 10}
    keys_per_session = t["frames_per_session"] // t["key_every"]
    kinds = collections.Counter(kind for s in sessions for kind, _ in s.events.values())
    assert kinds == {k: 40 * keys_per_session // 4 for k in t["key_block"]}
    for s in sessions:
        assert s.frames == t["frames_per_session"] and s.photos.max() < t["photo_pool"]
        assert len(s.checked) == t["check_frames"] and s.checked[0] == 0
        assert sorted(s.events) == list(range(t["key_every"] - 1, s.frames, t["key_every"]))
        attribute = 0
        for frame in sorted(s.events):  # each edit's row has the controlled attribute's width
            kind, arg = s.events[frame]
            if kind == "edit":
                assert arg.shape == (1, widths[f"attr{attribute}"])
            elif kind == "cycle":
                attribute = (attribute + arg) % len(widths)


def test_bulk_sizes_are_stratified_over_the_range():
    t = load_cell("serve_512_bulk").traffic
    stream = traffic.serve_requests(t, {"a": 4}, 9)
    requests = [next(stream) for _ in range(32)]
    sizes = sorted(len(r.photos) for r in requests[:16])
    assert sizes == traffic.size_block(t["photos_per_request"])
    assert 48 <= min(sizes) and max(sizes) <= 256
    assert all(r.value.shape == (len(r.photos), 4) and r.rotations is None for r in requests)
    # each request's photos are one run of the pool, passed as a view
    pool = np.arange(t["photo_pool"])
    assert all(np.array_equal(pool[r.rows], r.photos) for r in requests)


def test_reservoir_keeps_a_seeded_sample_and_the_longest():
    pool = [traffic.Request(i, np.arange(1 + (i == 17) * 9), "a", np.zeros((1, 1)), None)
            for i in range(100)]

    def sample(seed):
        r = traffic.Reservoir(5, seed)
        for request in pool:
            r.offer(request, None)
        return [req.index for req, _ in r.sample()]

    assert sample(3) == sample(3)
    assert 17 in sample(3) and len(sample(3)) in (5, 6)
    assert sample(3) != sample(4)


def test_a_new_workload_is_found_from_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    mix = json.loads((root / "benchmark" / "traffic" / "demo_session.json").read_text())
    mix["photos_per_session"] = {"values": [16], "weights": [1]}
    (root / "benchmark" / "traffic" / "demo_16.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "serve_256_sixteen", "config": "confignet_256",
                               "traffic": "demo_16", "chips": 1, "why": "a test cell"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "serve_256_interactive" in metric.get("workloads", []):
            metric["workloads"].append("serve_256_sixteen")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("serve_256_sixteen", root)
    assert cell.traffic["photos_per_session"]["values"] == [16]
    assert {m["name"] for m in cell.end_to_end} == {"demo_img_s", "frame_p95_ms", "setup_s"}
    assert all(p.read_bytes() == data for p, data in before.items())
