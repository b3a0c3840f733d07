"""The program's own spans and counters.

A span is a ``torch.profiler.record_function`` range, the mechanism that
:func:`core.profiling.maybe_trace` (the CLIs' ``--profile_dir``) and the
benchmark's harness use, so it lands in the same profiler trace, on the same
clock as the device's events, and shows in a Chrome trace without an
exporter of its own.  A span is recorded only while a profiler records on
the calling thread; otherwise :func:`span` returns one shared null context
(an ungated range costs several microseconds of host time even with no
profiler running; the check costs a fraction of one).  A span's parent is
the span that encloses it on the same thread: a frame or a request runs
synchronously on one thread.

Spans sit at the boundaries where host work happens, never inside a function
that a CUDA graph captures (it would record once, at capture, and never at a
replay) and never in the kernels' wrappers.  Names begin ``confignet.``:

- ``confignet.splice``: the demo's attribute splice into latents on the host;
- ``confignet.io.inputs``: a chunk's inputs prepared on the host (slices,
  padding, contiguous copies, uint8 to float32);
- ``confignet.io.h2d``: the inputs copied into a graph's buffers;
- ``confignet.io.d2h``: a chunk's outputs to the host, with the wait for the
  replay;
- ``confignet.io.join``: padding stripped and the chunks concatenated;
- ``confignet.graph.key``: a graph cache's key of a call;
- ``confignet.graph.launch``: a graph's replay;
- ``confignet.graph.first_call``: a key's first calls (the eager run, the
  capture);
- ``confignet.data.wait``: the train loop's wait for its next batch.

A counter keeps a process-wide total (:data:`totals`) and a second tally
(:data:`traced`) counted only while a profiler records on the calling
thread: a benchmark's traced slice.  Counters: ``rows.requested`` and
``rows.run`` (rows asked for, and rows the chunks ran with their padding)
and ``graph.first_call_s`` (the host seconds of the ``graph.first_call``
spans).
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

_NULL = contextlib.nullcontext()

# counter name -> total over the process, and over the profiled calls only
totals: Dict[str, float] = {}
traced: Dict[str, float] = {}


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records
    on this thread, else a shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``, and to its traced tally while a
    profiler records on this thread."""
    totals[name] = totals.get(name, 0) + n
    if torch.autograd._profiler_enabled():
        traced[name] = traced.get(name, 0) + n

