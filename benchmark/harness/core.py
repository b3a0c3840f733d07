"""What every run shares: finding a cell's files by name, the chip and
import checks, the run's context for the metric readers, and the result
line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration is ``configs[].file`` and its traffic
``benchmark/traffic/<traffic>.json``, whose ``entry`` names the runner
``benchmark/harness/<entry>.py``; a per-layer metric ``<name>`` is read
by ``benchmark/metrics/<name>.py``'s ``read(ctx)``.  A new cell, traffic
mix or metric is a new file and a new entry: no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
# top-level module names no run may load: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "confignet_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = workloads[name]
    config_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / config_entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"], traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def load_reader(metric: str, root: Path = ROOT):
    """``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def resolve(spec: str):
    """The object ``module:name`` that a traffic file names."""
    module, _, name = spec.partition(":")
    return getattr(importlib.import_module(module), name)


def runner(cell: Cell):
    """The runner module of the cell's traffic ``entry``
    (``benchmark/harness/<entry>.py``), after checking that the runner reads
    every key the traffic file sets."""
    entry = cell.traffic["entry"]
    if not entry.isidentifier():
        raise ValueError(f"bad entry {entry!r} in traffic {cell.traffic_name}")
    module = importlib.import_module(f"benchmark.harness.{entry}")
    unread = set(cell.traffic) - set(module.TRAFFIC_KEYS) - {"entry"}
    if unread:
        raise ValueError(f"traffic {cell.traffic_name}: keys {sorted(unread)} are read by "
                         f"no part of the {entry} runner")
    return module


def forbidden_loaded() -> List[str]:
    """The forbidden top-level modules in ``sys.modules``, compared whole
    (``confignet_tpu_torch`` is not ``confignet_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


@dataclass
class Context:
    """What the per-layer readers read: the cell's entry (its runner's
    name), the traced slice, and the harness's counts over it."""
    entry: str
    slice: Any = None  # trace.Slice
    flops_done: Optional[float] = None
    kernel_bound_s: Optional[float] = None
    data_waits_s: List[float] = field(default_factory=list)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """A runner's result: the end-to-end readings, the checks, the counts."""
    metrics: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    context: Context
    extra: Dict[str, Any] = field(default_factory=dict)


def result_line(cell: Cell, outcome: Outcome, trace: bool, device_name: str) -> Tuple[str, str]:
    """(the result's JSON line, the checks' lines for standard error)."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics: Dict[str, Dict[str, Any]] = {}
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line: Dict[str, Any] = {}
    if trace:
        for m in cell.per_layer:
            value = load_reader(m["name"])(outcome.context)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
        s = outcome.context.slice
        if s is not None:
            device.update(busy_s=s.busy_s, window_s=s.window_s)
            line["breakdown"] = {"device_ops": s.device_ops(), "idle_gaps": s.idle_gaps()}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(outcome.metrics[m["name"]]), "unit": units[m["name"]]}
    correct = bool(outcome.checks) and all(c.ok for c in outcome.checks)
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": device, **line,
              "checks": {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}}
    err = "\n".join(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}"
                    for c in outcome.checks)
    return json.dumps(result), err
