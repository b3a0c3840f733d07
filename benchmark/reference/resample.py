"""Nearest-neighbour 2x upsampling (counterpart of
``confignet_tpu/ops/resample.py``; reference ``UpSampling2D``/``UpSampling3D``)."""
from __future__ import annotations

import torch


def upsample2d_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, fH, fW, C), nearest."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


def upsample3d_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, fD, fH, fW, C), nearest."""
    b, d, h, w, c = x.shape
    x = x[:, :, None, :, None, :, None, :].expand(b, d, factor, h, factor, w, factor, c)
    return x.reshape(b, d * factor, h * factor, w * factor, c)
