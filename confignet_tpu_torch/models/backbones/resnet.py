"""ResNet50 backbone, Keras-v1 layout (counterpart of
``confignet_tpu/models/backbones/resnet.py``; reference use:
confignet/dnn_models/real_encoder.py:13).

- stem: pad 3, VALID 7x7/2 conv (64) -> norm -> ReLU -> 3x3/2 max pool
  over a -inf pad of 1;
- 4 stages of bottleneck blocks [3, 4, 6, 3], widths (64, 128, 256, 512),
  expansion 4; the first block of each stage has a projection shortcut and
  stages 2-4 put their stride on the block's FIRST 1x1 conv (Keras v1);
- every conv has a bias; kernels are flax's ``he_normal``;
- norm "frozen" is inference-mode batch norm (eps 1.001e-5), "group" is
  flax ``GroupNorm(min(32, C))`` with eps 1e-6.

The trunk takes (B, H, W, 3) and gives (B, 2048), as the JAX trunk does.
Inside, a trunk whose convolutions compute in float32, called with autograd
off (serving, encoding), runs channels-first (NCHW): cuDNN's float32
kernels are native there, and channels-last tensors cost a layout transpose
on each side of every convolution.  A bfloat16 trunk runs channels-last,
where the tensor cores' kernels are native, and so does a call that records
a backward: cuDNN's float32 weight gradients of the 1x1 convolutions are
several times slower on NCHW tensors.  One forward serves both layouts
(``channels_first`` below).  On that channels-first route a convolution
whose norm was folded into it (:func:`fold_frozen_norms`, the server's
snapshot) runs without its bias, and one pass adds the bias, the block's
shortcut and the ReLU after it (``ops/epilogue_cuda.conv_epilogue``): the
same float32 additions in the same order as the separate passes.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from confignet_tpu_torch.core import tracing
from confignet_tpu_torch.core.constants import device_constant
from confignet_tpu_torch.models.blocks import Conv2d
from confignet_tpu_torch.ops.epilogue_cuda import conv_epilogue

# the BGR ImageNet means of Keras' 'caffe' preprocessing
IMAGENET_BGR_MEAN = (103.939, 116.779, 123.68)


class FrozenBatchNorm(nn.Module):
    """y = gamma * (x - mean) / sqrt(var + eps) + beta with frozen statistics.
    The statistics are parameters, as in the JAX tree."""

    def __init__(self, features: int, eps: float = 1.001e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty(features))
        self.beta = nn.Parameter(torch.empty(features))
        self.moving_mean = nn.Parameter(torch.empty(features))
        self.moving_variance = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for p, value in ((self.gamma, 1.0), (self.beta, 0.0),
                         (self.moving_mean, 0.0), (self.moving_variance, 1.0)):
            nn.init.constant_(p, value)

    def scale_shift(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift) of ``y = x * scale + shift``: the forward's and the
        fold's (:func:`fold_frozen_norms`) one formula."""
        inv = torch.rsqrt(self.moving_variance + self.eps) * self.gamma
        return inv, self.beta - self.moving_mean * inv

    def forward(self, x: torch.Tensor, channels_first: bool = False) -> torch.Tensor:
        scale, shift = self.scale_shift()
        if channels_first:
            scale, shift = scale[:, None, None], shift[:, None, None]
        return x * scale + shift


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` on (B, H, W, C), or (B, C, H, W)
    with ``channels_first``: statistics in float32, eps 1e-6, parameters
    ``scale``/``bias``."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, channels_first: bool = False) -> torch.Tensor:
        if channels_first:
            return F.group_norm(x.float(), self.num_groups, self.scale, self.bias, self.eps)
        out = F.group_norm(x.float().movedim(-1, 1), self.num_groups, self.scale, self.bias,
                           self.eps)
        return out.movedim(1, -1)


def _resnet_norm(norm: str, features: int) -> nn.Module:
    if norm == "group":
        return GroupNorm(min(32, features), features)
    if norm != "frozen":
        raise ValueError(f"unknown resnet norm {norm!r} (frozen|group)")
    return FrozenBatchNorm(features)


# (convolution, the norm after it) of the stem and of a bottleneck block, in
# the order they run: the Keras name map and the fold read them
STEM_CONV_NORM = ("stem_conv", "stem_bn")
BLOCK_CONV_NORMS = (("shortcut_conv", "shortcut_bn"), ("conv1", "bn1"), ("conv2", "bn2"),
                    ("conv3", "bn3"))


def _computes_in_float32(conv: Conv2d) -> bool:
    """Whether ``conv`` computes in float32 (no lower compute dtype set):
    the test for the channels-first route and for :func:`fold_frozen_norms`."""
    return conv.dtype in (None, torch.float32)


def _conv_norm(conv: Conv2d, norm: nn.Module, x: torch.Tensor,
               channels_first: bool) -> torch.Tensor:
    """``norm(conv(x))`` in either layout; a folded norm is ``nn.Identity``."""
    y = conv(x, channels_first)
    return y if isinstance(norm, nn.Identity) else norm(y, channels_first)


def _folded(norms: Sequence[nn.Module], channels_first: bool) -> bool:
    """Whether convolutions followed by ``norms`` take the fused epilogue:
    every norm folded (:func:`fold_frozen_norms`), on the channels-first
    route, autograd off (the kernel has no backward)."""
    return (channels_first and not torch.is_grad_enabled()
            and all(isinstance(norm, nn.Identity) for norm in norms))


def _pad_spatial(x: torch.Tensor, pad: int, channels_first: bool,
                 value: float = 0.0) -> torch.Tensor:
    pads = (pad,) * 4 if channels_first else (0, 0) + (pad,) * 4
    return F.pad(x, pads, value=value)


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, width: int, stride: int = 1,
                 project_shortcut: bool = False, dtype: Optional[torch.dtype] = None,
                 norm: str = "frozen"):
        super().__init__()

        def conv(cin, cout, k, s=1):
            return Conv2d(cin, cout, (k, k), stride=s, dtype=dtype, kernel_init="he_normal")

        self.project_shortcut = project_shortcut
        if project_shortcut:
            self.shortcut_conv = conv(in_features, width * 4, 1, stride)
            self.shortcut_bn = _resnet_norm(norm, width * 4)
        self.conv1 = conv(in_features, width, 1, stride)
        self.bn1 = _resnet_norm(norm, width)
        self.conv2 = conv(width, width, 3)
        self.bn2 = _resnet_norm(norm, width)
        self.conv3 = conv(width, width * 4, 1)
        self.bn3 = _resnet_norm(norm, width * 4)

    def forward(self, x: torch.Tensor, channels_first: bool = False) -> torch.Tensor:
        norms = (self.bn1, self.bn2, self.bn3)
        if self.project_shortcut:
            norms += (self.shortcut_bn,)
        if _folded(norms, channels_first):
            return self._fused_forward(x)
        shortcut = x
        if self.project_shortcut:
            shortcut = _conv_norm(self.shortcut_conv, self.shortcut_bn, x, channels_first)
        y = torch.relu(_conv_norm(self.conv1, self.bn1, x, channels_first))
        y = torch.relu(_conv_norm(self.conv2, self.bn2, y, channels_first))
        y = _conv_norm(self.conv3, self.bn3, y, channels_first)
        return torch.relu(y + shortcut)

    def _fused_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The folded block on channels-first ``x``: each convolution without
        its bias, then one epilogue pass (three a block)."""
        y = conv_epilogue(self.conv1(x, True, add_bias=False), self.conv1.bias)
        y = conv_epilogue(self.conv2(y, True, add_bias=False), self.conv2.bias)
        y = self.conv3(y, True, add_bias=False)
        if not self.project_shortcut:
            return conv_epilogue(y, self.conv3.bias, residual=x)
        shortcut = self.shortcut_conv(x, True, add_bias=False)
        return conv_epilogue(y, self.conv3.bias, shortcut=shortcut,
                             shortcut_bias=self.shortcut_conv.bias)


class ResNet50(nn.Module):
    """Returns globally average-pooled 2048-dim features of (B, H, W, 3)."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 stage_widths: Sequence[int] = (64, 128, 256, 512), norm: str = "frozen"):
        super().__init__()
        self.stem_conv = Conv2d(3, 64, (7, 7), stride=2, padding="VALID", dtype=dtype,
                                kernel_init="he_normal")
        self.stem_bn = _resnet_norm(norm, 64)
        self.block_names = []
        features = 64
        for stage, (n_blocks, width) in enumerate(zip(stage_sizes, stage_widths)):
            for block in range(n_blocks):
                name = f"stage{stage + 1}_block{block + 1}"
                self.add_module(name, BottleneckBlock(
                    features, width, stride=2 if (stage > 0 and block == 0) else 1,
                    project_shortcut=(block == 0), dtype=dtype, norm=norm))
                self.block_names.append(name)
                features = width * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, 2048).  A float32 trunk called with autograd
        off transposes its 3-channel input once and runs channels-first from
        the stem to the pooling; any other call runs channels-last.  A
        folded trunk on that route runs each convolution's bias, shortcut
        and ReLU as one epilogue pass."""
        channels_first = _computes_in_float32(self.stem_conv) and not torch.is_grad_enabled()
        if channels_first:
            tracing.count("resnet.channels_first")
            if _folded((self.stem_bn,), channels_first):
                tracing.count("resnet.fused_epilogue")
            x = x.movedim(-1, 1).contiguous()
        return self.features(x, channels_first)

    def features(self, x: torch.Tensor, channels_first: bool) -> torch.Tensor:
        """The pooled features of (B, H, W, 3), or of (B, 3, H, W) with
        ``channels_first``."""
        x = _pad_spatial(x, 3, channels_first)
        if _folded((self.stem_bn,), channels_first):
            x = conv_epilogue(self.stem_conv(x, True, add_bias=False), self.stem_conv.bias)
        else:
            x = torch.relu(_conv_norm(self.stem_conv, self.stem_bn, x, channels_first))
        x = _pad_spatial(x, 1, channels_first, float("-inf"))
        if channels_first:
            x = F.max_pool2d(x, 3, stride=2)
        else:
            x = F.max_pool2d(x.movedim(-1, 1), 3, stride=2).movedim(1, -1)
        for name in self.block_names:
            x = getattr(self, name)(x, channels_first)
        return x.mean(dim=(2, 3) if channels_first else (1, 2))


@torch.no_grad()
def fold_frozen_norms(resnet: ResNet50) -> int:
    """Fold, in place, each :class:`FrozenBatchNorm` of ``resnet`` into the
    convolution before it: ``W * scale`` per output channel and
    ``b * scale + shift``, in the parameters' dtype; the norm becomes
    ``nn.Identity``.  Only a convolution that computes in float32 takes its
    norm: after a lower-precision one the norm's float32 multiply is what
    lifts the stream back to float32, so that norm stays.  Group norms stay.
    The norms' statistics leave the tree, so this is for an inference copy
    (the server's snapshot).  Returns the number of norms folded."""
    owners = [(resnet, (STEM_CONV_NORM,))]
    owners += [(getattr(resnet, name), BLOCK_CONV_NORMS) for name in resnet.block_names]
    folded = 0
    for owner, pairs in owners:
        for conv_name, norm_name in pairs:
            norm = getattr(owner, norm_name, None)
            if not isinstance(norm, FrozenBatchNorm):
                continue
            conv = getattr(owner, conv_name)
            if not _computes_in_float32(conv):
                continue
            scale, shift = norm.scale_shift()
            conv.weight.mul_(scale.view(-1, *(1,) * (conv.weight.ndim - 1)))
            conv.bias.mul_(scale).add_(shift)
            setattr(owner, norm_name, nn.Identity())
            folded += 1
    return folded


def resnet50_preprocess(images_unit_range: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> Keras ResNet50 'caffe' preprocessing: scale to [0, 255],
    reverse the channels, subtract the BGR ImageNet means."""
    x = (images_unit_range + 1.0) * 127.5
    x = x.flip(-1)
    return x - device_constant("imagenet_bgr_mean", lambda: IMAGENET_BGR_MEAN, x.dtype, x.device)


def resnet50_keras_name_map(legacy: bool = False):
    """Keras layer name -> (module path, "conv" | "bn") for
    ``models/backbones/loader.load_keras_h5_mapped``.  Two generations of
    Keras ResNet50 naming describe the same graph: ``conv2_block1_1_conv``
    (keras.applications.resnet, 2.2.4+) and, with ``legacy``,
    ``res2a_branch2a`` / ``bn2a_branch2a``."""
    stem_conv, stem_bn = STEM_CONV_NORM
    if legacy:
        mapping = {"conv1": (stem_conv, "conv"), "bn_conv1": (stem_bn, "bn")}
    else:
        mapping = {"conv1_conv": (stem_conv, "conv"), "conv1_bn": (stem_bn, "bn")}
    # (index in the current naming, branch in the legacy one) of BLOCK_CONV_NORMS
    parts = tuple(zip((0, 1, 2, 3), ("branch1", "branch2a", "branch2b", "branch2c"),
                      BLOCK_CONV_NORMS))
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        for block in range(1, n_blocks + 1):
            ours = f"stage{stage + 1}_block{block}"
            for idx, branch, (conv, bn) in parts:
                if idx == 0 and block != 1:  # the projection shortcut
                    continue
                if legacy:
                    base = f"{stage + 2}{chr(ord('a') + block - 1)}"
                    conv_name, bn_name = f"res{base}_{branch}", f"bn{base}_{branch}"
                else:
                    base = f"conv{stage + 2}_block{block}"
                    conv_name, bn_name = f"{base}_{idx}_conv", f"{base}_{idx}_bn"
                mapping[conv_name] = (f"{ours}/{conv}", "conv")
                mapping[bn_name] = (f"{ours}/{bn}", "bn")
    return mapping
