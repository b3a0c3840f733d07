"""Normalisation primitives of the generator (counterpart of
``confignet_tpu/ops/norms.py``).

``spatial_instance_norm`` is the Keras ``LayerNormalization`` over the
spatial axes used inside AdaIN: ``(x - mean) * rsqrt(var + eps)``, eps 1e-3
INSIDE the rsqrt, biased variance ``mean((x - mean)^2)`` (reference:
confignet/dnn_models/building_blocks.py:132-133).  The discriminator's
``std_instance_norm`` and ``layer_style`` come with the training slice.
"""
from __future__ import annotations

from typing import Sequence

import torch

from confignet_tpu_torch.ops.adain_cuda import fused_adain, fused_adain_plain, resolve_adain_impl


def spatial_instance_norm(x: torch.Tensor, spatial_axes: Sequence[int], eps: float = 1e-3) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) over ``spatial_axes``, no affine."""
    axes = tuple(spatial_axes)
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def adain_modulate(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   spatial_axes: Sequence[int], eps: float = 1e-3, impl: str = "auto") -> torch.Tensor:
    """AdaIN: instance-normalise, then ``norm(x) * (scale + 1) + bias`` with
    (B, C) scale/bias (reference: building_blocks.py:135-149).

    With the full spatial axes this is the fused AdaIN: ``impl`` "kernel"
    (or "auto" on a CUDA tensor) goes through the CUDA kernel's wrapper,
    "plain" (or "auto" on a CPU tensor) through its plain version.  Any
    other axis selection is plain torch.
    """
    if tuple(spatial_axes) == tuple(range(1, x.ndim - 1)):
        if resolve_adain_impl(impl, x) == "kernel":
            return fused_adain(x, scale, bias, eps)
        return fused_adain_plain(x, scale, bias, eps)
    normed = spatial_instance_norm(x, spatial_axes, eps)
    shape = [x.shape[0]] + [1] * (x.ndim - 2) + [x.shape[-1]]
    return normed * (scale.reshape(shape) + 1.0) + bias.reshape(shape)
