"""Multi-scale style discriminator and latent regressor (counterpart of
``confignet_tpu/models/discriminator.py``; reference:
confignet/dnn_models/hologan_discriminator.py).

``HologanDiscriminator`` stacks ``num_resample`` stride-2 DiscrBlocks with
``min(2^i * expansion, max_feature_maps)`` features.  At each scale a
Dense(1) style classifier scores the concat(mean, std) channel statistics;
the trunk output is flattened into a final Dense(1).  The call returns a
dict of logits in insertion order, ``discr_style_0..n-1`` then
``discr_final``, which the losses enumerate.

``HologanLatentRegressor`` is the same trunk without style heads, ending in
a Dense(latent_dim + 3) that regresses the latent and the rotation.

Both flatten the (B, H, W, C) trunk output in channels-last order, as the
JAX modules do, so the Dense weights carried across from JAX line up.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from confignet_tpu_torch.models.blocks import Conv2d, Dense, DiscrBlock


def _block_features(i: int, expansion: int, max_features: int) -> int:
    return min((2 ** i) * expansion, max_features)


class _Trunk(nn.Module):
    """The optional 1x1 ``from_rgb`` conv and the DiscrBlocks, shared by both
    modules; ``final_features`` is the flattened trunk output size."""

    def __init__(self, img_shape: Sequence[int], num_resample: int, disc_kernel_size: int,
                 disc_expansion_factor: int, disc_max_feature_maps: int,
                 initial_from_rgb_layer_in_discr: bool, dtype: Optional[torch.dtype],
                 return_styles: bool):
        super().__init__()
        self.num_resample = num_resample
        self.from_rgb = (Conv2d(3, 3, (1, 1), dtype=dtype) if initial_from_rgb_layer_in_discr
                         else None)
        features, height, width = 3, int(img_shape[0]), int(img_shape[1])
        self.block_features = []
        for i in range(num_resample):
            out = _block_features(i, disc_expansion_factor, disc_max_feature_maps)
            self.add_module(f"block_{i}", DiscrBlock(features, out, disc_kernel_size,
                                                     return_styles=return_styles, dtype=dtype))
            self.block_features.append(out)
            features, height, width = out, -(-height // 2), -(-width // 2)
        self.final_features = features * height * width

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.from_rgb is None else self.from_rgb(x)


class HologanDiscriminator(_Trunk):
    def __init__(self, img_shape: Sequence[int], num_resample: int = 5, disc_kernel_size: int = 3,
                 disc_expansion_factor: int = 48, disc_max_feature_maps: int = 512,
                 initial_from_rgb_layer_in_discr: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(img_shape, num_resample, disc_kernel_size, disc_expansion_factor,
                         disc_max_feature_maps, initial_from_rgb_layer_in_discr, dtype,
                         return_styles=True)
        for i, features in enumerate(self.block_features):
            self.add_module(f"style_classifier_{i}", Dense(2 * features, 1, dtype=dtype))
        self.disc_map = Dense(self.final_features, 1, dtype=dtype)

    def forward(self, input_img: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(input_img)
        outputs: Dict[str, torch.Tensor] = {}
        for i in range(self.num_resample):
            x, styles = getattr(self, f"block_{i}")(x)
            outputs[f"discr_style_{i}"] = getattr(self, f"style_classifier_{i}")(styles)
        outputs["discr_final"] = self.disc_map(x.reshape(x.shape[0], -1))
        return outputs


class HologanLatentRegressor(_Trunk):
    def __init__(self, latent_dim: int, img_shape: Sequence[int], num_resample: int = 5,
                 disc_kernel_size: int = 3, disc_expansion_factor: int = 48,
                 disc_max_feature_maps: int = 512, initial_from_rgb_layer_in_discr: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(img_shape, num_resample, disc_kernel_size, disc_expansion_factor,
                         disc_max_feature_maps, initial_from_rgb_layer_in_discr, dtype,
                         return_styles=False)
        self.latent_predictor = Dense(self.final_features, latent_dim + 3, dtype=dtype)

    def forward(self, input_img: torch.Tensor) -> torch.Tensor:
        x = self.stem(input_img)
        for i in range(self.num_resample):
            x = getattr(self, f"block_{i}")(x)
        return self.latent_predictor(x.reshape(x.shape[0], -1))
