"""The traced slice of a run: ``torch.profiler`` over the first
``trace_seconds`` of the window, reduced to intervals.

Device activity is every CUDA-side event (kernels, copies, sets) except the
user-annotation ranges, which span kernels counted themselves.  The
harness's own spans are ``record_function`` ranges named ``bench.*``; the
traced window runs from the first such span's start to the last one's end.
Times are seconds on the profiler's clock.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[float, float]

SPAN_PREFIX = "bench."
KERNEL_MARKS = ("rotate3d_", "adain_fwd", "adain_bwd")


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def covered(merged: Sequence[Interval], start: float, end: float) -> float:
    """How much of [start, end] the sorted, disjoint ``merged`` intervals
    cover (only those that reach into it are visited)."""
    total = 0.0
    for a, b in merged[max(bisect.bisect_right(merged, (start, float("inf"))) - 1, 0):]:
        if a >= end:
            break
        total += max(0.0, min(b, end) - max(a, start))
    return total


def is_kernel_of_port(name: str) -> bool:
    """Whether a device op is one of the port's four hand-written kernels."""
    return any(mark in name for mark in KERNEL_MARKS)


class Slice:
    """What the reduction keeps of a traced slice."""

    def __init__(self, device: List[Tuple[float, float, str]], spans: List[Tuple[float, float, str]],
                 host: List[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.window = (self.spans[0][0], self.spans[-1][1]) if self.spans else (0.0, 0.0)
        lo, hi = self.window
        self.device = [(max(a, lo), min(b, hi), n) for a, b, n in device if b > lo and a < hi]
        self.busy = union([(a, b) for a, b, _ in self.device])
        self.host = sorted(host)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def kernel_s(self) -> float:
        """Summed device time of the port's kernels."""
        return sum(b - a for a, b, n in self.device if is_kernel_of_port(n))

    def busy_within(self, start: float, end: float) -> float:
        return covered(self.busy, start, end)

    def device_ops(self, top: int = 10) -> List[List]:
        totals: Dict[str, float] = {}
        for a, b, n in self.device:
            totals[n] = totals.get(n, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def _host_label(self, t: float) -> str:
        """The innermost harness span and profiled host op under time ``t``;
        "Python" where no op is (the host runs Python between ops)."""
        span = next((n for a, b, n in reversed(self.spans) if a <= t <= b), "outside spans")
        inner: Optional[Tuple[float, str]] = None
        for a, b, n in self.host:
            if a > t:
                break
            if b >= t and (inner is None or b - a < inner[0]):
                inner = (b - a, n)
        return f"{span} > {'Python' if inner is None else inner[1]}"

    def idle_gaps(self, top: int = 10) -> List[List]:
        lo, hi = self.window
        edges = [lo] + [x for ab in self.busy for x in ab] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_label((a + b) / 2), b - a] for a, b in gaps[:top]]


class Tracer:
    """Starts and stops ``torch.profiler`` around part of the window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.active = False

    def start(self) -> None:
        self._prof.start()
        self.active = True

    def stop(self) -> Slice:
        """Waits for the queued device work (a ``bench.drain`` span, so the
        traced window holds it), stops and reduces the trace."""
        with torch.profiler.record_function(SPAN_PREFIX + "drain"):
            torch.cuda.synchronize()
        self._prof.stop()
        self.active = False
        device, spans, host = [], [], []
        for e in self._prof.events():
            start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type.name == "CUDA":
                if not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)):
                    device.append((start, end, e.name))
            elif e.name.startswith(SPAN_PREFIX):
                spans.append((start, end, e.name))
            else:
                host.append((start, end, e.name))
        return Slice(device, spans, host)
