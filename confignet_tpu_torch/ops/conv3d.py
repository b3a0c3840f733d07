"""Convolutions on channels-last tensors (counterpart of
``confignet_tpu/ops/conv3d.py``).

The port keeps the JAX layout at every public function: (B, *spatial, C)
activations.  :func:`conv_channels_last` runs ``F.conv2d``/``F.conv3d`` on
the channels-first view ``x.movedim(-1, 1)`` (which in memory is
``channels_last``/``channels_last_3d``, so no copy is made) and pads the way
TF/XLA "SAME" does: for an even kernel the extra row goes AFTER (a 4x4
kernel pads 1 before and 2 after), which ``padding="same"`` in torch would
not reproduce.  The TPU-only ``zdecomp`` lowering is not ported.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from confignet_tpu_torch.core.initializers import init_kernel_


def promote(dtype: Optional[torch.dtype], *tensors: Optional[torch.Tensor]):
    """flax ``promote_dtype``: cast inputs and parameters to ``dtype``, or,
    when it is None, to their common promoted type.  None (an absent bias)
    passes through."""
    present = [t for t in tensors if t is not None]
    if dtype is None:
        dtype = present[0].dtype
        for t in present[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
    return tuple(None if t is None else t.to(dtype) for t in tensors)


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_channels_last(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                       stride: int = 1, padding: Union[str, int] = "SAME",
                       groups: int = 1) -> torch.Tensor:
    """x (B, *spatial, Ci) with a torch-layout kernel (Co, Ci / groups, *taps)
    -> contiguous (B, *spatial', Co).  ``padding``: "SAME" (TF rule), "VALID"
    or an int applied on both sides of every spatial axis."""
    rank = x.ndim - 2
    xc = x.movedim(-1, 1)
    conv_pad: Union[int, Sequence[int]] = 0
    if padding == "SAME":
        pads = [_same_pads(x.shape[1 + i], weight.shape[2 + i], stride) for i in range(rank)]
        if all(lo == hi for lo, hi in pads):
            conv_pad = tuple(lo for lo, _ in pads)
        else:
            xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi])
    elif isinstance(padding, int):
        conv_pad = padding
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    conv = F.conv2d if rank == 2 else F.conv3d
    out = conv(xc, weight, bias, stride=stride, padding=conv_pad, groups=groups)
    return out.movedim(1, -1).contiguous()


class Conv3d(nn.Module):
    """Stride-1 SAME 3D conv, parameter-compatible with the JAX ``Conv3d``
    (kernel DHWIO there, OIDHW here; see core/model_io.py)."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if len(kernel_size) != 3:
            raise ValueError("Conv3d requires a rank-3 kernel_size")
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, *kernel_size))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_kernel_(self.weight, "glorot_uniform", generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = promote(self.dtype, x, self.weight, self.bias)
        return conv_channels_last(x, weight, bias)
