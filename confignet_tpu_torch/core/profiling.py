"""Optional profiler hook (counterpart of ``confignet_tpu/core/profiling.py``).

The CLIs take ``--profile_dir``; when it is set, training runs inside
:func:`maybe_trace`, a ``torch.profiler`` trace of the CPU (and the
card, where there is one) that writes a Chrome trace into that directory
(open it in Perfetto or chrome://tracing).  Without a directory it is a null
context and costs nothing.

The JAX module's ``enable_persistent_compilation_cache`` has no counterpart:
the port compiles nothing at run time except its CUDA kernels, which are
built once into ``confignet_tpu_torch/_build/`` and reused.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def _trace(profile_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def maybe_trace(profile_dir=None):
    """Context manager: a ``torch.profiler`` trace written into
    ``profile_dir`` when a directory is given, else a no-op."""
    if not profile_dir:
        return contextlib.nullcontext()
    return _trace(profile_dir)
