"""MobileNetV2 backbone for the CelebA attribute classifier (counterpart of
``confignet_tpu/models/backbones/mobilenet.py``; reference use:
confignet/metrics/celeba_attribute_prediction.py:56, Keras
``MobileNetV2(include_top=False)``).

Stem 3x3/2 conv(32), the inverted-residual stages (expansion, out channels,
repeats, stride) of ``_STAGES``, a final 1x1 conv(1280); every conv is
bias-free and followed by a norm, with ReLU6 after all but the projections.
The modules carry the JAX names (``stem``, ``stage{i}_block{j}/expand``,
``depthwise``, ``project``, ``*_bn``, ``head``), so ``core/model_io``
carries params and ``batch_stats`` across.

- TF "SAME" at stride 2 pads asymmetrically (0 before, 1 after on an even
  size); ``ops/conv3d.conv_channels_last`` pads that way.
- The depthwise kernel, flax (3, 3, 1, C), is (C, 1, 3, 3) here with
  ``groups=C``.
- ``trainable_bn=False`` norms with :class:`FrozenBatchNorm` (eps 1e-3, the
  Keras import's statistics as parameters); ``trainable_bn=True`` with
  :class:`BatchNorm`, flax's ``nn.BatchNorm`` (momentum 0.9 in the trunk).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from confignet_tpu_torch.models.backbones.resnet import FrozenBatchNorm
from confignet_tpu_torch.models.blocks import Conv2d

_STAGES = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over every axis but the last.

    - Train mode normalises with the batch statistics, computed in float32
      as flax computes them: the mean, and the biased variance
      ``max(E[x^2] - E[x]^2, 0)``; gradients flow through both.  The running
      statistics follow ``ra = m * ra + (1 - m) * batch``, the biased
      variance included (torch's BatchNorm takes ``1 - m`` and stores the
      unbiased variance, so it is not used).
    - Eval mode normalises with the running statistics.
    - ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``.

    The parameters are ``scale`` and ``bias``; the statistics are the
    buffers ``mean`` and ``var`` (flax's ``batch_stats`` collection).
    """

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for t, value in ((self.scale, 1.0), (self.bias, 0.0), (self.mean, 0.0), (self.var, 1.0)):
            nn.init.constant_(t, value)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            axes = tuple(range(x.ndim - 1))
            xf = x.to(torch.promote_types(x.dtype, torch.float32))  # flax's statistics dtype
            mean = xf.mean(dim=axes)
            var = torch.clamp(xf.square().mean(dim=axes) - mean.square(), min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean.detach(), alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var.detach(), alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class _Frozen(FrozenBatchNorm):
    """FrozenBatchNorm (eps 1e-3) with the live norm's call signature."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-3)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return super().forward(x)


def _make_norm(trainable_bn: bool, features: int) -> nn.Module:
    return BatchNorm(features, momentum=0.9) if trainable_bn else _Frozen(features)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(relu(x), 6), with relu's zero gradient at exactly 0, as JAX's."""
    return torch.relu(x).clamp(max=6.0)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
          dtype: Optional[torch.dtype] = None) -> Conv2d:
    return Conv2d(cin, cout, (kernel, kernel), stride=stride, dtype=dtype,
                  kernel_init="he_normal", use_bias=False, groups=groups)


class InvertedResidual(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int, expansion: int,
                 dtype: Optional[torch.dtype] = None, trainable_bn: bool = False):
        super().__init__()
        hidden = in_channels * expansion
        self.residual = stride == 1 and in_channels == out_channels
        if expansion != 1:
            self.expand = _conv(in_channels, hidden, 1, dtype=dtype)
            self.expand_bn = _make_norm(trainable_bn, hidden)
        else:
            self.expand = None
        self.depthwise = _conv(hidden, hidden, 3, stride=stride, groups=hidden, dtype=dtype)
        self.depthwise_bn = _make_norm(trainable_bn, hidden)
        self.project = _conv(hidden, out_channels, 1, dtype=dtype)
        self.project_bn = _make_norm(trainable_bn, out_channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = x
        if self.expand is not None:
            y = relu6(self.expand_bn(self.expand(y), train))
        y = relu6(self.depthwise_bn(self.depthwise(y), train))
        y = self.project_bn(self.project(y), train)
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    """Returns the final (B, H/32, W/32, 1280) feature map of (B, H, W, 3)."""

    def __init__(self, dtype: Optional[torch.dtype] = None, trainable_bn: bool = False):
        super().__init__()
        self.stem = _conv(3, 32, 3, stride=2, dtype=dtype)
        self.stem_bn = _make_norm(trainable_bn, 32)
        self.block_names = []
        in_ch = 32
        for stage_idx, (expansion, out_ch, repeats, stride) in enumerate(_STAGES):
            for block_idx in range(repeats):
                name = f"stage{stage_idx}_block{block_idx}"
                self.add_module(name, InvertedResidual(
                    in_ch, out_ch, stride if block_idx == 0 else 1, expansion, dtype=dtype,
                    trainable_bn=trainable_bn))
                self.block_names.append(name)
                in_ch = out_ch
        self.head = _conv(in_ch, 1280, 1, dtype=dtype)
        self.head_bn = _make_norm(trainable_bn, 1280)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = relu6(self.stem_bn(self.stem(x), train))
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return relu6(self.head_bn(self.head(x), train))


def mobilenet_preprocess(images_0_255: torch.Tensor) -> torch.Tensor:
    """Keras 'tf' mode: [0, 255] -> [-1, 1]."""
    return images_0_255.float() / 127.5 - 1.0


def mobilenet_conv_bn_order():
    """(conv_paths, bn_paths) in Keras MobileNetV2 creation order, for the
    ordered h5 loader: the stem, then expand (not in block 0), depthwise and
    project of each inverted-residual block, then the 1280 head conv."""
    conv_paths, bn_paths = ["stem"], ["stem_bn"]
    for stage_idx, (expansion, _, repeats, _) in enumerate(_STAGES):
        for block_idx in range(repeats):
            name = f"stage{stage_idx}_block{block_idx}"
            parts = (("expand", "depthwise", "project") if expansion != 1
                     else ("depthwise", "project"))
            conv_paths += [f"{name}/{part}" for part in parts]
            bn_paths += [f"{name}/{part}_bn" for part in parts]
    conv_paths.append("head")
    bn_paths.append("head_bn")
    assert len(conv_paths) == 52 and len(bn_paths) == 52
    return conv_paths, bn_paths
