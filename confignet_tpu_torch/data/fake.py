"""A random training set for measuring the trainers without real data."""
from __future__ import annotations

import numpy as np


class FakeDataset:
    """A training set in the shape the trainer reads: uint8 images, eye masks,
    face-model metadata and rotations within the configured ranges."""

    def __init__(self, n_images: int, img_size: int, facemodel_dims: dict, seed: int):
        rng = np.random.default_rng(seed)
        self.imgs = rng.integers(0, 256, (n_images, img_size, img_size, 3), dtype=np.uint8)
        self.eye_masks = (rng.random((n_images, img_size, img_size)) > 0.95).astype(np.uint8)
        self.metadata_inputs = {name: rng.normal(size=(n_images, dim)).astype(np.float32)
                                for name, dim in facemodel_dims.items()}
        ranges = np.radians(np.asarray(((-30, 30), (-10, 10), (0, 0)), np.float64))
        self.metadata_inputs["rotations"] = rng.uniform(
            ranges[:, 0], ranges[:, 1], size=(n_images, 3)).astype(np.float32)
