"""The four kernel wrappers' launch counters, and the launches a unit of the
port's work makes.

Each wrapper adds one to its ``launches`` where it launches its kernel and
nowhere else (``cuda_build.count_launch``); on a CPU tensor it takes its
plain version and counts nothing.  A caller zeroes the counters before a
window of work and holds them to the window's units after it, so a window
that took the plain path on the card shows.  A replayed CUDA graph
(``core/graphs.py``) calls no wrapper: the launches counted when it was
captured are added at each replay (:func:`add_launches`).
"""
from __future__ import annotations

from confignet_tpu_torch.ops import cuda_build
from confignet_tpu_torch.ops.adain_cuda import fused_adain_backward, fused_adain_forward
from confignet_tpu_torch.ops.rotate_cuda import rotate_3d_grid_forward, rotate_3d_grid_transpose

KERNEL_WRAPPERS = (rotate_3d_grid_forward, rotate_3d_grid_transpose, fused_adain_forward,
                   fused_adain_backward)
LAUNCH_NAMES = ("rotate", "transpose", "adain", "adain_backward")
# the generator's ConvAdaIN sites at each output size
ADAIN_SITES = {128: 5, 256: 6, 512: 7}


def launch_counts() -> tuple:
    return tuple(w.launches for w in KERNEL_WRAPPERS)


def recorded_launches(counts: dict) -> tuple:
    """A capture's launches by wrapper (``cuda_build.recording_launches``) as
    a tuple in ``LAUNCH_NAMES`` order."""
    return tuple(counts.get(w, 0) for w in KERNEL_WRAPPERS)


def add_launches(counts: tuple) -> None:
    """Add a tuple of launches, in ``LAUNCH_NAMES`` order, to the four
    counters: what one replay of a captured graph launched."""
    for wrapper, n in zip(KERNEL_WRAPPERS, counts):
        if n:
            cuda_build.add_launches(wrapper, n)


def zero_launch_counts() -> None:
    for wrapper in KERNEL_WRAPPERS:
        wrapper.launches = 0


def unit_launches(unit: str, size: int) -> tuple:
    """Kernel launches (rotation, transpose, AdaIN, AdaIN backward) of one
    ``unit`` at ``size`` px: a generator "forward"; a "train_step" (the D
    updates render twice, the G step renders two halves and differentiates
    them); a "fine_tune_iteration" (the gather resample, so no rotation
    kernel)."""
    sites = ADAIN_SITES[size]
    return {"forward": (1, 0, sites, 0), "train_step": (4, 2, 4 * sites, 2 * sites),
            "fine_tune_iteration": (0, 0, sites, sites)}[unit]


def scaled(n: int, unit: tuple) -> tuple:
    return tuple(n * u for u in unit)
