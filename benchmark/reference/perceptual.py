"""Perceptual loss on VGG activations (counterpart of
``confignet_tpu/losses/perceptual.py``; reference: confignet/perceptual_loss.py).

- ``"imagenet"``: VGG19 activations at Keras layer indices [1, 2, 8, 13]
  with caffe-style preprocessing;
- ``"VGGFace"``: VGG16 at [1, 2, 8, 12] with the VGGFace mean subtraction.

The loss is the sum over taps of the MSE between the whole-batch flattened
activations (reference: perceptual_loss.py:63-82).  The VGG is frozen: its
parameters never require grad.  The benchmark makes its weights (none are
fetched).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from benchmark.reference.vgg import VGGFeatures, vgg19_preprocess, vggface_preprocess

_MODE_SETTINGS = {
    "imagenet": dict(arch="vgg19", taps=(1, 2, 8, 13), seed=1901),
    "VGGFace": dict(arch="vgg16", taps=(1, 2, 8, 12), seed=1602),
}


class PerceptualLoss(nn.Module):
    def __init__(self, model_type: str = "imagenet", dtype: Optional[torch.dtype] = None,
                 taps: Optional[Sequence[int]] = None):
        super().__init__()
        if model_type not in _MODE_SETTINGS:
            raise ValueError(f"unknown perceptual loss mode {model_type!r}")
        self.model_type = model_type
        settings = _MODE_SETTINGS[model_type]
        self.vgg = VGGFeatures(settings["arch"], tuple(taps) if taps is not None else settings["taps"],
                               dtype=dtype)
        self.vgg.requires_grad_(False)

    def _preprocess(self, images: torch.Tensor) -> torch.Tensor:
        if self.model_type == "VGGFace":
            return vggface_preprocess(images)
        return vgg19_preprocess(images)

    def activations(self, images: torch.Tensor) -> List[torch.Tensor]:
        return self.vgg(self._preprocess(images))

    def loss_fn(self, predicted: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        if predicted.ndim == 3:
            predicted = predicted[None]
        if data.ndim == 3:
            data = data[None]
        total = 0.0
        for a_p, a_d in zip(self.activations(predicted), self.activations(data)):
            total = total + (a_p.reshape(-1) - a_d.reshape(-1)).square().mean()
        return total

    def loss(self, predicted: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        """:meth:`loss_fn` on the module's own VGG weights."""
        return self.loss_fn(predicted, data)
