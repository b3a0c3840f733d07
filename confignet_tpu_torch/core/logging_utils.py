"""Logging helpers (counterpart of ``confignet_tpu/core/logging_utils.py``).
Only :func:`agg_pyplot` is ported so far; the TensorBoard writer and the
loss flusher come with the ``train()`` loops."""
from __future__ import annotations


def agg_pyplot():
    """pyplot with the Agg backend pinned, imported on first use: plots are
    written from worker threads, where an interactive backend would fail,
    and a process that never plots never loads matplotlib."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    from matplotlib import pyplot as plt

    return plt
