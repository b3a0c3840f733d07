"""ConfigNet second stage, inference half (counterpart of
``confignet_tpu/training/second_stage.py``): adds the real-image encoder
and ``encode_images``.  Training and the one-shot fine-tune come with later
slices, in this file.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from confignet_tpu_torch.core import initializers
from confignet_tpu_torch.models.real_encoder import RealEncoder
from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage


class ConfigNet(ConfigNetFirstStage):
    MODEL_TYPE = "ConfigNet"
    WEIGHT_TREES = ConfigNetFirstStage.WEIGHT_TREES + ("real_encoder",)

    def __init__(self, config: Dict[str, Any], device: Optional[Union[str, torch.device]] = None,
                 initialize: bool = True):
        super().__init__(config, device=device, initialize=initialize)
        self.config["model_type"] = self.MODEL_TYPE

    def _build_modules(self) -> None:
        super()._build_modules()
        self.real_encoder = RealEncoder(
            latent_dim=self.config["latent_dim"],
            rotation_ranges=tuple(tuple(r) for r in self.config["rotation_ranges"]),
            dtype=self.compute_dtype, trunk_norm=self.config.get("encoder_norm", "frozen"))

    def initialize_network(self) -> None:
        super().initialize_network()
        rng = torch.Generator().manual_seed(int(self.config.get("seed", 0)) + 1)
        initializers.initialize(self.real_encoder, rng)

    @torch.inference_mode()
    def encode_images(self, input_images, batch_chunk: int = 32) -> Tuple[np.ndarray, np.ndarray]:
        """Images (uint8 or [-1, 1] float) -> float32 (latents, rotations)."""
        input_images = np.asarray(input_images)
        if input_images.dtype == np.uint8:
            input_images = input_images.astype(np.float32) / 127.5 - 1.0
        input_images = input_images.astype(np.float32)
        if input_images.ndim == 3:
            input_images = input_images[np.newaxis]

        n = input_images.shape[0]
        chunk = min(batch_chunk, max(n, 1))
        lat_out, rot_out = [], []
        for start in range(0, n, chunk):
            imgs = input_images[start:start + chunk]
            pad = chunk - imgs.shape[0]
            if pad:
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, axis=0)])
            lat, rot = self.real_encoder(torch.from_numpy(imgs).to(self.device))
            lat_out.append(lat.float().cpu().numpy()[:chunk - pad])
            rot_out.append(rot.float().cpu().numpy()[:chunk - pad])
        return np.concatenate(lat_out), np.concatenate(rot_out)
