"""Nearest-2x upsample + conv as one module (counterpart of
``confignet_tpu/ops/upconv.py``).

Convolving a nearest-upsampled tensor rewrites exactly as a conv on the
SMALL grid with per-output-phase kernels whose taps are sums of the original
taps, followed by a depth-to-space interleave ("subpixel", the default).
Per spatial dim, output parity r selects a collapsed tap vector (TF/XLA
"SAME" padding):

    k=3 (3D blocks, pad 1+1):  r=0: [W0, W1+W2]      at offsets {-1, 0}
                               r=1: [W0+W1, W2]      at offsets { 0,+1}
    k=4 (2D blocks, pad 1+2):  r=0: [W0, W1+W2, W3]  at offsets {-1,0,+1}
                               r=1: [0,  W0+W1, W2+W3]

"naive" materialises the upsample and runs the stock SAME conv; it is the
oracle the rewrite is tested against.  Both share one parameter layout.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from confignet_tpu_torch.core.constants import device_constant
from confignet_tpu_torch.core.initializers import init_kernel_
from confignet_tpu_torch.ops.conv3d import conv_channels_last, promote
from confignet_tpu_torch.ops.resample import upsample2d_nearest, upsample3d_nearest

# Per-dim tap-collapse matrices T[r]: (n_out_taps, k); the phase-r kernel is
# T[r] @ W along that spatial dim.
_T_K3 = (
    np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 1.0]]),
    np.array([[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]),
)
_T_K4 = (
    np.array([[1.0, 0, 0, 0], [0, 1.0, 1.0, 0], [0, 0, 0, 1.0]]),
    np.array([[0.0, 0, 0, 0], [1.0, 1.0, 0, 0], [0, 0, 1.0, 1.0]]),
)


def _taps(name: str, mats, kernel: torch.Tensor):
    return [device_constant((name, r), lambda m=m: m, kernel.dtype, kernel.device)
            for r, m in enumerate(mats)]


def up2_conv2d_subpixel(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """conv_same(up2(x), weight) for a 4x4 kernel without materialising the
    upsample.  x: (B, H, W, Ci); weight: (Co, Ci, 4, 4) -> (B, 2H, 2W, Co)."""
    b, h, w, _ = x.shape
    if tuple(weight.shape[2:]) != (4, 4):
        raise ValueError("2D subpixel path is derived for k=4")
    co = weight.shape[0]
    kernel = weight.permute(2, 3, 1, 0)  # HWIO, as the derivation is written
    t = _taps("upconv_k4", _T_K4, kernel)
    phases = [torch.einsum("ay,bx,yxio->abio", t[ry], t[rx], kernel)
              for ry, rx in itertools.product((0, 1), (0, 1))]
    kp = torch.cat(phases, dim=-1).permute(3, 2, 0, 1)  # (4*Co, Ci, 3, 3)
    out = conv_channels_last(x, kp, padding=1)
    out = out.reshape(b, h, w, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, 2 * h, 2 * w, co)


def up2_conv3d_subpixel(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """conv_same(up2(x), weight) for a 3x3x3 kernel on the small grid.
    x: (B, D, H, W, Ci); weight: (Co, Ci, 3, 3, 3) -> (B, 2D, 2H, 2W, Co).
    One (2,2,2)-tap conv gives all 8 phases as channel groups at D+1
    positions per dim; phase r along a dim reads position m + r."""
    b, d, h, w, _ = x.shape
    if tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError("3D subpixel path is derived for k=3")
    co = weight.shape[0]
    kernel = weight.permute(2, 3, 4, 1, 0)  # DHWIO
    t = _taps("upconv_k3", _T_K3, kernel)
    phase_list = list(itertools.product((0, 1), repeat=3))
    phases = [torch.einsum("ad,bh,cw,dhwio->abcio", t[rd], t[rh], t[rw], kernel)
              for rd, rh, rw in phase_list]
    kp = torch.cat(phases, dim=-1).permute(4, 3, 0, 1, 2)  # (8*Co, Ci, 2, 2, 2)
    out = conv_channels_last(x, kp, padding=1)  # (B, D+1, H+1, W+1, 8*Co)
    parts = [out[:, rd:rd + d, rh:rh + h, rw:rw + w, i * co:(i + 1) * co]
             for i, (rd, rh, rw) in enumerate(phase_list)]
    y = torch.stack(parts, dim=4).reshape(b, d, h, w, 2, 2, 2, co)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape(b, 2 * d, 2 * h, 2 * w, co)


def resolve_upconv_impl(name: str) -> str:
    """"auto" -> "subpixel"; "naive" stays as the oracle."""
    if name == "auto":
        return "subpixel"
    if name not in ("naive", "subpixel"):
        raise ValueError(f"unknown upconv impl {name!r} (naive|subpixel|auto)")
    return name


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
        rank = weight.ndim - 2
        if self.impl == "subpixel":
            out = (up2_conv2d_subpixel if rank == 2 else up2_conv3d_subpixel)(x, weight)
        else:
            up = upsample2d_nearest if rank == 2 else upsample3d_nearest
            out = conv_channels_last(up(x), weight)
        return out + bias
