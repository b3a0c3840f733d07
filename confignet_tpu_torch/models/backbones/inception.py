"""InceptionV3 feature extractor for FID/KID (counterpart of
``confignet_tpu/models/backbones/inception.py``; reference use:
confignet/metrics/inception_distance.py:9-27, Keras
``InceptionV3(include_top=False, pooling="avg")``).

The standard graph on (B, H, W, 3): stem -> mixed 5b-5d (35x35 at 299px) ->
reduction 6a -> mixed 6b-6e (factorised 7x7) -> reduction 7a -> mixed 7b-7c
-> global average pool to 2048 features.  Every conv is a bias-free conv,
inference batch norm with eps 1e-3 and a ReLU (``ConvBN``, 94 of them, under
the JAX module names, so ``core/model_io.load_jax_params`` carries weights
across).  As in the JAX module:

- the stride-2 convs and the 3x3/2 max pools are VALID; every other conv is
  TF "SAME", which is symmetric for these odd kernels (1x7 pads 0 and 3);
- the branch pools are 3x3/1 SAME average pools that divide by the count of
  real (unpadded) cells (``count_include_pad=False``, as Keras does);
- with ``dtype`` given (bf16), each conv casts its input and kernel to it
  (flax ``promote_dtype``); the batch norm's float32 statistics promote the
  result back to float32, so only the convolutions run in bf16.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from confignet_tpu_torch.models.backbones.resnet import FrozenBatchNorm
from confignet_tpu_torch.models.blocks import Conv2d


class ConvBN(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: Sequence[int], stride: int = 1,
                 padding: str = "SAME", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(in_features, features, tuple(kernel), stride=stride, padding=padding,
                           dtype=dtype, kernel_init="he_normal", use_bias=False)
        self.bn = FrozenBatchNorm(features, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    out = F.avg_pool2d(x.movedim(-1, 1), 3, stride=1, padding=1, count_include_pad=False)
    return out.movedim(1, -1)


def _max_pool_valid(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.movedim(-1, 1), 3, stride=2).movedim(1, -1)


class InceptionV3(nn.Module):
    """Returns globally average-pooled 2048-dim features of (B, H, W, 3)."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype

        def cb(name, features, kernel, stride=1, padding="SAME", *, cin):
            self.add_module(name, ConvBN(cin, features, kernel, stride, padding, dtype))
            return features

        c = cb("stem_1", 32, (3, 3), 2, "VALID", cin=3)
        c = cb("stem_2", 32, (3, 3), 1, "VALID", cin=c)
        c = cb("stem_3", 64, (3, 3), cin=c)
        c = cb("stem_4", 80, (1, 1), 1, "VALID", cin=c)
        c = cb("stem_5", 192, (3, 3), 1, "VALID", cin=c)

        for i, pool_features in enumerate([32, 64, 64]):
            name = f"mixed5{'bcd'[i]}"
            cb(f"{name}_1x1", 64, (1, 1), cin=c)
            cb(f"{name}_5x5_1", 48, (1, 1), cin=c)
            cb(f"{name}_5x5_2", 64, (5, 5), cin=48)
            cb(f"{name}_3x3dbl_1", 64, (1, 1), cin=c)
            cb(f"{name}_3x3dbl_2", 96, (3, 3), cin=64)
            cb(f"{name}_3x3dbl_3", 96, (3, 3), cin=96)
            cb(f"{name}_pool", pool_features, (1, 1), cin=c)
            c = 64 + 64 + 96 + pool_features

        cb("mixed6a_3x3", 384, (3, 3), 2, "VALID", cin=c)
        cb("mixed6a_3x3dbl_1", 64, (1, 1), cin=c)
        cb("mixed6a_3x3dbl_2", 96, (3, 3), cin=64)
        cb("mixed6a_3x3dbl_3", 96, (3, 3), 2, "VALID", cin=96)
        c = 384 + 96 + c

        for i, c7 in enumerate([128, 160, 160, 192]):
            name = f"mixed6{'bcde'[i]}"
            cb(f"{name}_1x1", 192, (1, 1), cin=c)
            cb(f"{name}_7x7_1", c7, (1, 1), cin=c)
            cb(f"{name}_7x7_2", c7, (1, 7), cin=c7)
            cb(f"{name}_7x7_3", 192, (7, 1), cin=c7)
            cb(f"{name}_7x7dbl_1", c7, (1, 1), cin=c)
            cb(f"{name}_7x7dbl_2", c7, (7, 1), cin=c7)
            cb(f"{name}_7x7dbl_3", c7, (1, 7), cin=c7)
            cb(f"{name}_7x7dbl_4", c7, (7, 1), cin=c7)
            cb(f"{name}_7x7dbl_5", 192, (1, 7), cin=c7)
            cb(f"{name}_pool", 192, (1, 1), cin=c)
            c = 4 * 192

        cb("mixed7a_3x3_1", 192, (1, 1), cin=c)
        cb("mixed7a_3x3_2", 320, (3, 3), 2, "VALID", cin=192)
        cb("mixed7a_7x7x3_1", 192, (1, 1), cin=c)
        cb("mixed7a_7x7x3_2", 192, (1, 7), cin=192)
        cb("mixed7a_7x7x3_3", 192, (7, 1), cin=192)
        cb("mixed7a_7x7x3_4", 192, (3, 3), 2, "VALID", cin=192)
        c = 320 + 192 + c

        for i in range(2):
            name = f"mixed7{'bc'[i]}"
            cb(f"{name}_1x1", 320, (1, 1), cin=c)
            cb(f"{name}_3x3_1", 384, (1, 1), cin=c)
            cb(f"{name}_3x3_2a", 384, (1, 3), cin=384)
            cb(f"{name}_3x3_2b", 384, (3, 1), cin=384)
            cb(f"{name}_3x3dbl_1", 448, (1, 1), cin=c)
            cb(f"{name}_3x3dbl_2", 384, (3, 3), cin=448)
            cb(f"{name}_3x3dbl_3a", 384, (1, 3), cin=384)
            cb(f"{name}_3x3dbl_3b", 384, (3, 1), cin=384)
            cb(f"{name}_pool", 192, (1, 1), cin=c)
            c = 320 + 768 + 768 + 192
        assert c == 2048

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = lambda name: getattr(self, name)  # noqa: E731
        cat = lambda *xs: torch.cat(xs, dim=-1)  # noqa: E731

        for name in ("stem_1", "stem_2", "stem_3"):
            x = m(name)(x)
        x = _max_pool_valid(x)
        x = m("stem_5")(m("stem_4")(x))
        x = _max_pool_valid(x)

        for b in "bcd":
            n = f"mixed5{b}"
            x = cat(m(f"{n}_1x1")(x),
                    m(f"{n}_5x5_2")(m(f"{n}_5x5_1")(x)),
                    m(f"{n}_3x3dbl_3")(m(f"{n}_3x3dbl_2")(m(f"{n}_3x3dbl_1")(x))),
                    m(f"{n}_pool")(_avg_pool_same(x)))

        x = cat(m("mixed6a_3x3")(x),
                m("mixed6a_3x3dbl_3")(m("mixed6a_3x3dbl_2")(m("mixed6a_3x3dbl_1")(x))),
                _max_pool_valid(x))

        for b in "bcde":
            n = f"mixed6{b}"
            b2 = m(f"{n}_7x7_3")(m(f"{n}_7x7_2")(m(f"{n}_7x7_1")(x)))
            b3 = m(f"{n}_7x7dbl_1")(x)
            for k in range(2, 6):
                b3 = m(f"{n}_7x7dbl_{k}")(b3)
            x = cat(m(f"{n}_1x1")(x), b2, b3, m(f"{n}_pool")(_avg_pool_same(x)))

        b1 = m("mixed7a_3x3_2")(m("mixed7a_3x3_1")(x))
        b2 = x
        for k in range(1, 5):
            b2 = m(f"mixed7a_7x7x3_{k}")(b2)
        x = cat(b1, b2, _max_pool_valid(x))

        for b in "bc":
            n = f"mixed7{b}"
            b2 = m(f"{n}_3x3_1")(x)
            b3 = m(f"{n}_3x3dbl_2")(m(f"{n}_3x3dbl_1")(x))
            x = cat(m(f"{n}_1x1")(x),
                    m(f"{n}_3x3_2a")(b2), m(f"{n}_3x3_2b")(b2),
                    m(f"{n}_3x3dbl_3a")(b3), m(f"{n}_3x3dbl_3b")(b3),
                    m(f"{n}_pool")(_avg_pool_same(x)))

        return x.mean(dim=(1, 2))


def inception_preprocess(images_uint8_or_float: torch.Tensor) -> torch.Tensor:
    """Keras 'tf' mode: [0, 255] -> [-1, 1], no channel flip."""
    return images_uint8_or_float.float() / 127.5 - 1.0


def inception_conv_bn_order():
    """The ``ConvBN`` module names in the creation order of the Keras
    InceptionV3 graph (keras.applications.inception_v3 makes the same 94
    conv2d_bn calls in this sequence), for the ordered h5 loader."""
    names = [f"stem_{i}" for i in range(1, 6)]
    for b in "bcd":
        names += [f"mixed5{b}_{s}" for s in
                  ("1x1", "5x5_1", "5x5_2", "3x3dbl_1", "3x3dbl_2", "3x3dbl_3", "pool")]
    names += ["mixed6a_3x3", "mixed6a_3x3dbl_1", "mixed6a_3x3dbl_2", "mixed6a_3x3dbl_3"]
    for b in "bcde":
        names += [f"mixed6{b}_{s}" for s in
                  ("1x1", "7x7_1", "7x7_2", "7x7_3",
                   "7x7dbl_1", "7x7dbl_2", "7x7dbl_3", "7x7dbl_4", "7x7dbl_5", "pool")]
    names += [f"mixed7a_{s}" for s in
              ("3x3_1", "3x3_2", "7x7x3_1", "7x7x3_2", "7x7x3_3", "7x7x3_4")]
    for b in "bc":
        names += [f"mixed7{b}_{s}" for s in
                  ("1x1", "3x3_1", "3x3_2a", "3x3_2b",
                   "3x3dbl_1", "3x3dbl_2", "3x3dbl_3a", "3x3dbl_3b", "pool")]
    assert len(names) == 94
    return names
