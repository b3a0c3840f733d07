"""Real-image encoder: ResNet50 trunk + rotation and embedding heads
(counterpart of ``confignet_tpu/models/real_encoder.py``; reference:
confignet/dnn_models/real_encoder.py).

Both heads are zero-initialised, so a fresh encoder emits the latent-space
center and a neutral pose.  The rotation head is
``tanh(dense(features)) * pi * [r[0][1], r[1][1], r[2][1]] / 180``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from benchmark.reference.resnet import ResNet50, resnet50_preprocess
from benchmark.reference.blocks import Dense


class RealEncoder(nn.Module):
    def __init__(self, latent_dim: int, rotation_ranges: Sequence[Sequence[float]],
                 dtype: Optional[torch.dtype] = None, trunk_norm: str = "frozen"):
        super().__init__()
        self.resnet = ResNet50(dtype=dtype, norm=trunk_norm)
        self.rotation_regressor = Dense(2048, 3, dtype=dtype, kernel_init="zeros")
        self.feature_to_latent = Dense(2048, latent_dim, dtype=dtype, kernel_init="zeros")
        multiplier = np.pi * np.asarray(
            [rotation_ranges[0][1], rotation_ranges[1][1], rotation_ranges[2][1]],
            np.float32) / 180.0
        self.register_buffer("rotation_multiplier", torch.tensor(multiplier.tolist(), dtype=torch.float32),
                             persistent=False)

    def forward(self, input_img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        features = self.resnet(resnet50_preprocess(input_img))
        rotation = torch.tanh(self.rotation_regressor(features)) * self.rotation_multiplier
        return self.feature_to_latent(features), rotation
