"""Image helpers of the training step (counterpart of the device-side part
of ``confignet_tpu/core/images.py``)."""
from __future__ import annotations

import torch


def batched_hflip(images: torch.Tensor, flip_mask: torch.Tensor) -> torch.Tensor:
    """Horizontal flip (axis 2, W of NHWC) of the images where ``flip_mask``
    (B,) is true, as the JAX ``batched_hflip`` blends it."""
    mask = flip_mask.to(images.dtype).reshape(-1, 1, 1, 1)
    return images * (1 - mask) + images.flip(2) * mask
