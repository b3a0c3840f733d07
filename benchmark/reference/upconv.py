"""Nearest-2x upsample + conv as one module (counterpart of
``confignet_tpu/ops/upconv.py``), in its naive form only: the upsample is
materialised and the stock SAME conv runs on it.  The port's default
sub-pixel rewrite shares this parameter layout and is tested against this
form.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from benchmark.reference.initializers import init_kernel_
from benchmark.reference.conv3d import conv_channels_last, promote
from benchmark.reference.resample import upsample2d_nearest, upsample3d_nearest


def resolve_upconv_impl(name: str) -> str:
    """The reference always takes the naive form (upsample, then conv), the
    oracle of the sub-pixel rewrite; ``name`` is checked and ignored."""
    if name not in ("auto", "naive", "subpixel"):
        raise ValueError(f"unknown upconv impl {name!r} (naive|subpixel|auto)")
    return "naive"


class UpConv(nn.Module):
    """Nearest-2x upsample followed by a stride-1 SAME conv (rank 2 or 3).
    ``impl``: "naive" | "subpixel" | "auto"."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 dtype: Optional[torch.dtype] = None, impl: str = "auto"):
        super().__init__()
        if len(kernel_size) not in (2, 3):
            raise ValueError("UpConv supports rank-2 and rank-3 convs")
        self.dtype = dtype
        self.impl = resolve_upconv_impl(impl)
        self.weight = nn.Parameter(torch.empty(features, in_features, *kernel_size))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_kernel_(self.weight, "glorot_uniform", generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The kernel is promoted to the compute dtype BEFORE the taps are
        # collapsed, as the JAX module does.
        x, weight, bias = promote(self.dtype, x, self.weight, self.bias)
        up = upsample2d_nearest if weight.ndim == 4 else upsample3d_nearest
        return conv_channels_last(up(x), weight) + bias
