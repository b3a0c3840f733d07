"""VGG-16 / VGG-19 feature extractors for the perceptual losses (counterpart
of ``confignet_tpu/models/backbones/vgg.py``).

The reference taps Keras VGG19 (ImageNet) activations at layer indices
[1, 2, 8, 13] and a VGGFace VGG16 at [1, 2, 8, 12] (reference:
confignet/perceptual_loss.py:18-41).  Keras layer indices count the input
as 0 and then each block's convs and its pool in order; :func:`keras_layer_names`
reproduces that numbering.  The module builds only as deep as the deepest
tap.  Kernels are flax's ``he_normal``, biases zero; the convs have no
compute dtype, so inputs are promoted to float32 (flax ``promote_dtype``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.constants import device_constant
from benchmark.reference.resnet import IMAGENET_BGR_MEAN
from benchmark.reference.blocks import Conv2d

VGGFACE_MEAN = (93.5940, 104.7624, 129.1863)

# (convs_per_block, channels)
_VGG_CFG = {
    "vgg16": ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    "vgg19": ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def keras_layer_names(arch: str) -> List[str]:
    """Sequential layer names in Keras order (index 0 is the input)."""
    convs_per_block, _ = _VGG_CFG[arch]
    names = ["input"]
    for block, n_convs in enumerate(convs_per_block, start=1):
        names += [f"block{block}_conv{conv}" for conv in range(1, n_convs + 1)]
        names.append(f"block{block}_pool")
    return names


class VGGFeatures(nn.Module):
    """Runs the VGG layers up to the deepest tap and returns the activations
    at ``taps`` (Keras layer indices, post-ReLU or post-pool)."""

    def __init__(self, arch: str = "vgg19", taps: Sequence[int] = (1, 2, 8, 13),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.taps = tuple(taps)
        names = keras_layer_names(arch)[1:max(self.taps) + 1]
        self.layers = names  # "blockB_convK" (a Conv2d attribute) or "blockB_pool"
        _, channels = _VGG_CFG[arch]
        features = 3
        for name in names:
            if "_conv" in name:
                out = channels[int(name[5]) - 1]
                self.add_module(name, Conv2d(features, out, (3, 3), dtype=dtype,
                                             kernel_init="he_normal"))
                features = out

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs = {}
        for index, name in enumerate(self.layers, start=1):
            if name.endswith("_pool"):
                x = F.max_pool2d(x.movedim(-1, 1), 2, stride=2).movedim(1, -1)
            else:
                x = torch.relu(getattr(self, name)(x))
            outputs[index] = x
        return [outputs[t] for t in self.taps]


def vgg19_preprocess(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> Keras VGG19 'caffe' preprocessing: scale to
    [0, 255], reverse the channels, subtract the BGR ImageNet means."""
    x = ((images + 1.0) * 127.5).flip(-1)
    return x - device_constant("imagenet_bgr_mean", lambda: IMAGENET_BGR_MEAN, x.dtype, x.device)


def vggface_preprocess(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> VGGFace preprocessing: scale to [0, 255] and
    subtract the VGGFace means, no channel flip."""
    x = (images + 1.0) * 127.5
    return x - device_constant("vggface_mean", lambda: VGGFACE_MEAN, x.dtype, x.device)
