"""The arithmetic the per-layer metric files share.  Each reader takes the
run's context (``harness.context.Context``) and returns a number, or None
where the cell has nothing for it to read."""
from __future__ import annotations

import statistics
from typing import Optional

from benchmark.counts.kernels import F32_FLOPS_PER_S


def mfu(ctx, entry: str) -> Optional[float]:
    """The requested work's operations over the traced window, as a share
    of the card's float32 peak, in %."""
    if ctx.entry != entry or ctx.slice is None or ctx.flops_done is None:
        return None
    return 100.0 * ctx.flops_done / ctx.slice.window_s / F32_FLOPS_PER_S


def kernel_roofline(ctx, entry: str) -> Optional[float]:
    """The port's kernels' summed bound times over their summed device time, in %."""
    if ctx.entry != entry or ctx.slice is None or not ctx.kernel_bound_s:
        return None
    kernel_s = ctx.slice.kernel_s()
    return 100.0 * ctx.kernel_bound_s / kernel_s if kernel_s > 0 else None


def idle_share(ctx, entry: str) -> Optional[float]:
    """1 - the union of device activity over the traced window, in %."""
    if ctx.entry != entry or ctx.slice is None or ctx.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s / ctx.slice.window_s)


def median_frontend_ms(ctx, entry: str) -> Optional[float]:
    """Per request span: its length less the device-busy time inside it;
    the median over the traced requests, in ms."""
    if ctx.entry != entry or ctx.slice is None:
        return None
    own = [(b - a) - ctx.slice.busy_within(a, b) for a, b, n in ctx.slice.spans
           if n == "bench.request"]
    return 1e3 * statistics.median(own) if own else None


def mean_data_wait_ms(ctx, entry: str) -> Optional[float]:
    """The harness's host span around the prefetcher's ``next()``, mean per
    traced step, in ms."""
    if ctx.entry != entry or not ctx.data_waits_s:
        return None
    return 1e3 * statistics.fmean(ctx.data_waits_s)
