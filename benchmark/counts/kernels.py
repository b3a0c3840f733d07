"""Operations, bytes and bound times of the port's four kernels at a
configuration's shapes, and which launches a unit of work makes.

The peaks and per-element counts are the published H100 SXM figures and the
kernels' arithmetic: bytes are each input read once and each output written
once; a launch's bound is the larger of bytes over the HBM bandwidth and
operations over the float32 peak (no tensor cores, TF32 off).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ROTATE_FLOPS_PER_ELEMENT = 21  # 7 lerps of 3 operations
TRANSPOSE_FLOPS_PER_ELEMENT = 25  # 3 (1 - d), 14 weight products, 8 accumulating adds
ADAIN_FLOPS_PER_ELEMENT = 7  # mean 1, centred variance 3, normalise+modulate 3
F32_BYTES = 4

Launch = Tuple[str, int]  # (kind, batch)


def adain_sites(model: Dict) -> List[Tuple[int, int]]:
    """(positions, channels) of each AdaIN site of the generator: two 3D
    blocks, the 2D chain, the 128px and 256px extra blocks by output size."""
    side = int(model["const_input_shape"][0])
    nf = int(model["n_generator_features"])
    size = int(model["output_shape"][0])
    sites = [((2 * side) ** 3, nf), ((4 * side) ** 3, nf // 2), ((4 * side) ** 2, nf),
             ((8 * side) ** 2, nf // 4), ((16 * side) ** 2, nf // 8)]
    if size > 128:
        sites.append(((32 * side) ** 2, nf // 8))
    if size > 256:
        sites.append(((64 * side) ** 2, nf // 16))
    return sites


def rotation_volume(model: Dict) -> Tuple[int, int]:
    """(side, channels) of the rotated volume."""
    return 4 * int(model["const_input_shape"][2]), int(model["n_generator_features"]) // 2


def bound_s(n_bytes: float, flops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def launch_bound_s(kind: str, batch: int, model: Dict) -> float:
    """The bound of the launches of one ``kind`` at ``batch`` rows: one
    rotation or transpose launch, or one AdaIN launch at every site."""
    if kind in ("rotate_fwd", "rotate_transpose"):
        side, channels = rotation_volume(model)
        elements = batch * side ** 3 * channels
        per = ROTATE_FLOPS_PER_ELEMENT if kind == "rotate_fwd" else TRANSPOSE_FLOPS_PER_ELEMENT
        return bound_s(2 * elements * F32_BYTES + batch * 9 * F32_BYTES, per * elements)
    total = 0.0
    for positions, channels in adain_sites(model):
        elements = batch * positions * channels
        params = batch * channels
        if kind == "adain_fwd":
            total += bound_s((2 * elements + 2 * params) * F32_BYTES, ADAIN_FLOPS_PER_ELEMENT * elements)
        elif kind == "adain_bwd":
            total += bound_s((3 * elements + 3 * params) * F32_BYTES, 0.0)
        else:
            raise ValueError(f"unknown launch kind {kind!r}")
    return total


def generator_forward(batch: int, grad: bool) -> List[Launch]:
    """One generator forward at ``batch`` rows; with ``grad`` its backward
    too (the transpose and the AdaIN backward)."""
    out = [("rotate_fwd", batch), ("adain_fwd", batch)]
    return out + ([("rotate_transpose", batch), ("adain_bwd", batch)] if grad else [])


def serving_chunk(chunk: int) -> List[Launch]:
    """A served chunk: one generator forward over the padded chunk."""
    return generator_forward(chunk, grad=False)


def stage2_step(batch: int) -> List[Launch]:
    """A stage-2 step: the image-D fakes and the synthetic-D fakes at the
    batch without gradient, the generator player's two halves with it."""
    half = batch // 2
    return (generator_forward(batch, False) * 2 + generator_forward(half, True)
            + generator_forward(batch - half, True))


def plan_bound_s(plan: List[Launch], model: Dict) -> float:
    return sum(launch_bound_s(kind, batch, model) for kind, batch in plan)
