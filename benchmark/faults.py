"""Faults planted in the program for the checks' controls: each a context
manager that breaks the timed path underneath while it is open."""
from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def half_batch_in_captured_graph():
    """The train step's CUDA graph built over the first half of every batch
    field's rows: the eager first step is whole, the captured step and every
    replay train on half of the batch."""
    from confignet_tpu_torch.core import graphs

    run_step = graphs.GraphCache.run_step

    def faulty(self, name, fn, tensors, *args, **kwargs):
        def half(*leaves):
            if torch.cuda.is_current_stream_capturing():
                leaves = [x[:max(1, x.shape[0] // 2)] if x.dim() else x for x in leaves]
            return fn(*leaves)
        return run_step(self, name, half, tensors, *args, **kwargs)

    graphs.GraphCache.run_step = faulty
    try:
        yield
    finally:
        graphs.GraphCache.run_step = run_step


FAULTS = {"half_batch_in_captured_graph": half_batch_in_captured_graph}
