"""Normalisation primitives (counterpart of ``confignet_tpu/ops/norms.py``).

Two instance-norm flavours, NOT interchangeable:

- ``spatial_instance_norm`` is the Keras ``LayerNormalization`` over the
  spatial axes used inside AdaIN: ``(x - mean) * rsqrt(var + eps)``, eps
  1e-3 INSIDE the rsqrt, biased variance ``mean((x - mean)^2)`` (reference:
  confignet/dnn_models/building_blocks.py:132-133).
- ``std_instance_norm`` is the discriminator blocks' keras-contrib
  ``InstanceNormalization``: ``(x - mean) / (std + eps)``, eps 1e-3 OUTSIDE
  the sqrt, then a per-channel affine (reference:
  confignet/dnn_models/instance_normalization.py:117-119).

``layer_style`` gives the style heads' statistics, ``concat(mean,
sqrt(var + 1e-6))`` with eps inside the sqrt.
"""
from __future__ import annotations

from typing import Sequence

import torch



def spatial_instance_norm(x: torch.Tensor, spatial_axes: Sequence[int], eps: float = 1e-3) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) over ``spatial_axes``, no affine."""
    axes = tuple(spatial_axes)
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def std_instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      spatial_axes: Sequence[int], eps: float = 1e-3) -> torch.Tensor:
    """(x - mean) / (std + eps) * gamma + beta over ``spatial_axes``;
    ``gamma``/``beta`` are per-channel (last axis)."""
    axes = tuple(spatial_axes)
    mean = x.mean(dim=axes, keepdim=True)
    std = torch.sqrt((x - mean).square().mean(dim=axes, keepdim=True))
    return (x - mean) / (std + eps) * gamma + beta


def layer_style(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-channel spatial mean and sqrt(var + eps) of a (B, H, W, C) or
    (B, D, H, W, C) tensor, concatenated: (B, 2C)."""
    if x.ndim not in (4, 5):
        raise NotImplementedError(f"unsupported rank {x.ndim}")
    axes = tuple(range(1, x.ndim - 1))
    mean = x.mean(dim=axes)
    std = torch.sqrt((x - x.mean(dim=axes, keepdim=True)).square().mean(dim=axes) + eps)
    return torch.cat([mean, std], dim=-1)


def adain_modulate(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   spatial_axes: Sequence[int], eps: float = 1e-3, impl: str = "auto") -> torch.Tensor:
    """AdaIN: instance-normalise, then ``norm(x) * (scale + 1) + bias`` with
    (B, C) scale/bias (reference: building_blocks.py:135-149).

    With the full spatial axes this is the fused kernel's plain maths, in
    float32; ``impl`` is accepted and ignored (the reference has no kernels).
    """
    if tuple(spatial_axes) == tuple(range(1, x.ndim - 1)):
        return adain_plain(x, scale, bias, eps)
    normed = spatial_instance_norm(x, spatial_axes, eps)
    shape = [x.shape[0]] + [1] * (x.ndim - 2) + [x.shape[-1]]
    return normed * (scale.reshape(shape) + 1.0) + bias.reshape(shape)


def adain_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-3) -> torch.Tensor:
    """The fused AdaIN's plain maths: statistics over every spatial position
    in float32, ``(x - mean) * rsqrt(var + eps) * (scale + 1) + bias``, cast
    once to x's dtype."""
    x3 = x.reshape(x.shape[0], -1, x.shape[-1]).float()
    mean = x3.mean(dim=1, keepdim=True)
    var = (x3 - mean).square().mean(dim=1, keepdim=True)
    out = (x3 - mean) * torch.rsqrt(var + eps) * (scale.float()[:, None, :] + 1.0) + bias.float()[:, None, :]
    return out.to(x.dtype).reshape(x.shape)
