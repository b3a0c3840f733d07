"""The per-layer readings of the program's own spans and counters
(``confignet_tpu_torch/core/tracing.py``).

Spans are the ``confignet.*`` ranges, which the traced slice keeps among its
host ranges (``Slice.host``); counters are read from the program's module,
their process totals or their tallies over the traced slice.  Each reader
returns None where the program records nothing of the kind (a program
without these spans and counters), and never raises for it.
"""
from __future__ import annotations

import bisect
import importlib
import statistics
from typing import Optional

from benchmark.harness.trace import union

REQUEST = "bench.request"
STEP = "bench.step"


def counters():
    """The program's tracing module (``totals``, ``traced``), or None where
    the program has none."""
    try:
        return importlib.import_module("confignet_tpu_torch.core.tracing")
    except ImportError:
        return None


def median_host_ms(ctx, entry: str, prefix: str) -> Optional[float]:
    """Per traced request (``bench.request``: a frame or a request): the union
    of the family's spans that start inside it, less the device-busy time
    within that union; the median over the traced requests, in ms (a request
    with none of the family's spans reads 0)."""
    if ctx.entry != entry or ctx.slice is None:
        return None
    s = ctx.slice
    spans = sorted((a, b) for a, b, n in s.host if n.startswith(prefix))
    if not spans:
        return None
    starts = [a for a, _ in spans]
    own = []
    for lo, hi, name in s.spans:
        if name != REQUEST:
            continue
        inside = spans[bisect.bisect_left(starts, lo):bisect.bisect_right(starts, hi)]
        merged = union([(a, min(b, hi)) for a, b in inside])
        own.append(sum((b - a) - s.busy_within(a, b) for a, b in merged))
    return 1e3 * statistics.median(own) if own else None


def mean_span_ms_per_step(ctx, entry: str, name: str) -> Optional[float]:
    """The summed length of the spans ``name`` inside the traced window over
    the number of traced steps (``bench.step``), in ms."""
    if ctx.entry != entry or ctx.slice is None:
        return None
    lo, hi = ctx.slice.window
    waits = [(a, b) for a, b, n in ctx.slice.host if n == name]
    steps = sum(1 for _, _, n in ctx.slice.spans if n == STEP)
    if not waits or not steps:
        return None
    return 1e3 * sum(min(b, hi) - max(a, lo) for a, b in waits if b > lo and a < hi) / steps


def chunk_fill(ctx, entry: str) -> Optional[float]:
    """Rows requested over rows the chunks ran (padding included) in the
    traced slice, in %."""
    tracing = counters()
    if ctx.entry != entry or ctx.slice is None or tracing is None:
        return None
    run = tracing.traced.get("rows.run", 0)
    return 100.0 * tracing.traced.get("rows.requested", 0) / run if run else None


def first_call_s(ctx, entry: str) -> Optional[float]:
    """The host seconds of the graph caches' first calls of a key (eager
    runs and captures) over the run, set-up included."""
    tracing = counters()
    if ctx.entry != entry or tracing is None:
        return None
    return tracing.totals.get("graph.first_call_s")
