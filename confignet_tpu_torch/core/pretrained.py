"""Locating and applying pretrained Keras backbone weights (counterpart of
``confignet_tpu/core/pretrained.py``).

A ``backbones_dir`` config key (``--backbones_dir`` on the training CLIs)
names a directory of the standard notop ``.h5`` files.  Each backbone loads
its file when it is there; a missing file is skipped without a message and
the backbone keeps its seeded weights, as in the JAX package.

Reference behaviour: every reference backbone loads ImageNet/VGGFace
weights at construction (perceptual_loss.py:18-41, real_encoder.py:13,
inception_distance.py:11, celeba_attribute_prediction.py:56).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

BACKBONE_FILES = {
    "vgg19": "vgg19_notop.h5",
    "vggface": "vggface_vgg16_notop.h5",
    "inception_v3": "inception_v3_notop.h5",
    "mobilenet_v2": "mobilenet_v2_notop.h5",
    "resnet50": "resnet50_notop.h5",
}


def backbone_path(backbones_dir: Optional[str], key: str) -> Optional[str]:
    """The path of the standard weight file for ``key``, if it exists."""
    if not backbones_dir:
        return None
    path = os.path.join(backbones_dir, BACKBONE_FILES[key])
    return path if os.path.exists(path) else None


def maybe_load(loader: Callable[[str], None], backbones_dir: Optional[str], key: str) -> bool:
    """Call ``loader(path)`` when the weight file for ``key`` exists, and
    say so, so a training log shows which backbones are pretrained."""
    path = backbone_path(backbones_dir, key)
    if path is None:
        return False
    loader(path)
    print(f"Loaded pretrained {key} backbone from {path}")
    return True
