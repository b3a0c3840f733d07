"""The port's spans and counters (confignet_tpu_torch/core/tracing.py) and
the benchmark's readers of them (benchmark/harness/program.py).

On the CPU: a span is the shared null context while no profiler records,
and a ``record_function`` range while one does; the serving, demo and input
paths record their spans and count their rows under ``torch.profiler``; the
readers' arithmetic on a hand-built trace; the operators' ``--profile_dir``
trace shows the spans.  The test marked ``gpu`` traces a captured render on
the card and finds the graph cache's spans on the host and none among the
device's events; it imports no JAX, so on a machine without it:
python -m pytest --noconftest -m gpu tests/test_torch_tracing.py
"""
import json
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helpers import TINY_FIRST_STAGE_CONFIG
from benchmark.harness import program
from benchmark.harness.core import Context
from benchmark.harness.trace import Slice
from confignet_tpu_torch.core import tracing
from confignet_tpu_torch.core.profiling import maybe_trace
from confignet_tpu_torch.data.prefetch import BatchPrefetcher
from confignet_tpu_torch.serving import ConfigNetServer
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)


def _photos(n, seed, size=128):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def test_without_a_profiler_a_span_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("confignet.io.inputs") is tracing.span("confignet.splice")
    before_total = tracing.totals.get("rows.run", 0)
    before_traced = tracing.traced.get("rows.run", 0)
    with tracing.span("confignet.io.join"):
        tracing.count("rows.run", 4)
    assert tracing.totals["rows.run"] == before_total + 4
    assert tracing.traced.get("rows.run", 0) == before_traced


def test_under_a_profiler_a_span_is_a_range_and_the_traced_tally_counts():
    before = dict(tracing.traced)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("confignet.io.join"):
            tracing.count("rows.requested", 3)
    names = [e.name for e in prof.events()]
    assert names.count("confignet.io.join") == 1
    assert tracing.traced["rows.requested"] == before.get("rows.requested", 0) + 3


# -- the program's paths under a profiler (CPU) -------------------------------------------


@pytest.fixture(scope="module")
def model():
    return ConfigNet(dict(TINY_FIRST_STAGE_CONFIG, seed=5), device="cpu")


def _render(model):
    server = ConfigNetServer(model, chunk=4, device="cpu")
    photos = _photos(5, 0)
    return lambda: server.render_with_attribute(photos, "blendshape_values", np.zeros((1, 8)))


def _generate(model):
    lat = np.random.default_rng(1).normal(size=(5, model.config["latent_dim"])).astype(np.float32)
    return lambda: model.generate_images(lat, np.zeros((5, 3), np.float32), batch_chunk=4)


def _encode(model):
    photos = _photos(5, 2)
    return lambda: model.encode_images(photos, batch_chunk=4)


def _splice(model):
    lat = np.zeros((6, model.config["latent_dim"]), np.float32)
    return lambda: model.set_facemodel_param_in_latents(lat, "head_hair_color", np.ones(3))


def _prefetch(model):
    prefetcher = BatchPrefetcher(lambda: {"x": np.zeros((2, 3), np.float32)}, device="cpu")

    def call():
        try:
            return prefetcher.next()
        finally:
            prefetcher.close()
    return call


IO = ("confignet.io.inputs", "confignet.io.d2h", "confignet.io.join")


@pytest.mark.parametrize("make, spans, rows", [
    (_render, IO, (5, 8)),
    (_generate, IO, (5, 8)),
    (_encode, IO, (5, 8)),
    (_splice, ("confignet.splice",), (0, 0)),
    (_prefetch, ("confignet.data.wait",), (0, 0)),
], ids=["render_with_attribute", "generate_images", "encode_images", "splice", "prefetch"])
def test_a_profiled_call_records_its_spans_and_rows(model, make, spans, rows):
    call = make(model)
    before = dict(tracing.traced)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    names = {e.name for e in prof.events()}
    assert set(spans) <= names
    # no graph spans on the CPU: every cache call runs directly
    assert not {n for n in names if n.startswith("confignet.graph.")}
    counted = tuple(tracing.traced.get(k, 0) - before.get(k, 0)
                    for k in ("rows.requested", "rows.run"))
    assert counted == rows


def test_the_profile_dir_trace_holds_the_programs_spans(model, tmp_path):
    call = _splice(model)
    with maybe_trace(str(tmp_path)):
        call()
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "confignet.splice" in names


# -- the benchmark's readers, on a hand-built trace -----------------------------------------


def _slice():
    """Three frames of 10 s: the first with overlapping io spans and device
    work inside them, the second with one io span, the third with none."""
    spans = [(0.0, 10.0, "bench.request"), (10.0, 20.0, "bench.request"),
             (20.0, 30.0, "bench.request")]
    host = [(1.0, 3.0, "confignet.io.inputs"), (2.0, 4.0, "confignet.io.d2h"),
            (6.0, 7.0, "confignet.io.join"), (11.0, 13.0, "confignet.io.d2h"),
            (2.5, 2.6, "aten::copy_"), (5.0, 9.0, "confignet.graph.launch"),
            (21.0, 22.0, "confignet.splice")]
    device = [(2.5, 3.5, "kernel"), (12.0, 12.5, "kernel"), (5.0, 9.0, "kernel")]
    return Slice(device, spans, host)


@pytest.mark.parametrize("prefix, want_ms", [
    # frame 1: union 1-4 and 6-7 (4 s) less 1 s busy = 3 s; frame 2: 2 s less
    # 0.5 s; frame 3: none; the median 1.5 s
    ("confignet.io.", 1500.0),
    # frame 1: 4 s, all busy; frames 2-3: none
    ("confignet.graph.", 0.0),
    # frame 3 alone: 1 s
    ("confignet.splice", 0.0),
])
def test_host_ms_is_the_median_of_a_familys_union_less_device_busy(prefix, want_ms):
    ctx = Context("demo", slice=_slice())
    assert program.median_host_ms(ctx, "demo", prefix) == pytest.approx(want_ms)
    assert program.median_host_ms(ctx, "serve", prefix) is None
    assert program.median_host_ms(ctx, "demo", "confignet.nothing.") is None


def test_input_wait_is_the_spans_sum_over_the_steps():
    spans = [(0.0, 1.0, "bench.data_wait"), (1.0, 5.0, "bench.step"),
             (5.0, 6.0, "bench.data_wait"), (6.0, 10.0, "bench.step")]
    host = [(0.2, 0.7, "confignet.data.wait"), (5.0, 5.25, "confignet.data.wait"),
            (12.0, 13.0, "confignet.data.wait")]  # outside the window
    ctx = Context("train", slice=Slice([], spans, host))
    assert program.mean_span_ms_per_step(ctx, "train", "confignet.data.wait") == \
        pytest.approx(1e3 * 0.75 / 2)
    assert program.mean_span_ms_per_step(Context("train", slice=Slice([], spans, [])), "train",
                                         "confignet.data.wait") is None


def test_counter_readers_take_the_traced_tally_and_the_total(monkeypatch):
    fake = types.SimpleNamespace(traced={"rows.requested": 2432, "rows.run": 2656},
                                 totals={"graph.first_call_s": 4.5})
    monkeypatch.setattr(program, "counters", lambda: fake)
    ctx = Context("serve", slice=_slice())
    assert program.chunk_fill(ctx, "serve") == pytest.approx(100.0 * 2432 / 2656)
    assert program.first_call_s(ctx, "serve") == 4.5
    assert program.chunk_fill(ctx, "demo") is None and program.first_call_s(ctx, "train") is None


def test_readers_read_nothing_from_a_program_without_the_counters(monkeypatch):
    # as on a program that has no core/tracing.py: its import fails
    monkeypatch.setitem(sys.modules, "confignet_tpu_torch.core.tracing", None)
    assert program.counters() is None
    ctx = Context("serve", slice=_slice())
    assert program.chunk_fill(ctx, "serve") is None and program.first_call_s(ctx, "serve") is None


# -- on the card -------------------------------------------------------------------------------


@pytest.mark.gpu
def test_card_replay_records_the_graph_spans_on_the_host_only():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.harness.trace import Tracer

    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG, seed=3))
    lat = np.random.default_rng(4).normal(size=(5, model.config["latent_dim"])).astype(np.float32)
    rot = np.zeros((5, 3), np.float32)
    first = tracing.totals.get("graph.first_call_s", 0.0)
    model.generate_images(lat, rot, batch_chunk=4)  # captures
    assert tracing.totals["graph.first_call_s"] > first
    tracer = Tracer()
    tracer.start()
    with torch.profiler.record_function("bench.request"):
        model.generate_images(lat, rot, batch_chunk=4)  # replays
    s = tracer.stop()
    names = {n for _, _, n in s.host}
    assert {"confignet.graph.key", "confignet.graph.launch", "confignet.io.h2d",
            "confignet.io.d2h"} <= names
    assert "confignet.graph.first_call" not in names
    assert s.device and not [n for _, _, n in s.device if n.startswith("confignet.")]
