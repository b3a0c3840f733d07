"""Building-block modules (counterpart of ``confignet_tpu/models/blocks.py``).

Parity notes vs the reference (confignet/dnn_models/building_blocks.py):

- Keras ``LeakyReLU()`` defaults to slope 0.3; the AdaIN MLPs use 0.2
  (hologan_generator.py:21).  The slopes are passed explicitly below.
- Dense/Conv kernels are glorot-uniform, biases zero.
- ``MLP`` with ``num_layers=N`` means N-1 hidden (Dense + LeakyReLU) layers
  followed by a final Dense (building_blocks.py:152-173).
- In bf16 mode every Dense/Conv casts its input and parameters to the
  compute dtype, as flax ``promote_dtype`` does.

Module attributes carry the flax module names (``dense_0``, ``conv_0``,
``adain``, ``mlp``, ``conv``, ``in_gamma``), so JAX checkpoints map onto them
by path.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from confignet_tpu_torch.core.initializers import init_kernel_
from confignet_tpu_torch.ops import conv_double_backward
from confignet_tpu_torch.ops.conv3d import (Conv3d, channels_first_padded, conv_channels_first,
                                           conv_channels_last, promote)
from confignet_tpu_torch.ops.norms import adain_modulate, layer_style, std_instance_norm
from confignet_tpu_torch.ops.upconv import UpConv


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.3) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


class LeakyReLUUnitGradAtZero(torch.autograd.Function):
    """``F.leaky_relu`` whose gradient at exactly 0 is 1, as
    ``jax.nn.leaky_relu``'s (``F.leaky_relu``'s is the slope there).  An MLP
    meets exact zeros when a zero input reaches a zero-initialised bias, as
    the expression inversion's first step does.  The forward is the one
    ``F.leaky_relu`` kernel; the backward is built of differentiable ops, so
    the R1 penalty can differentiate it again."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, negative_slope: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.negative_slope = negative_slope
        return F.leaky_relu(x, negative_slope)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, grad, grad * ctx.negative_slope), None


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel (in, out) there, (out, in) here."""

    def __init__(self, in_features: int, features: int, dtype: Optional[torch.dtype] = None,
                 kernel_init: str = "glorot_uniform"):
        super().__init__()
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_kernel_(self.weight, self.kernel_init, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = promote(self.dtype, x, self.weight, self.bias)
        return F.linear(x, weight, bias)


class Conv2d(nn.Module):
    """flax ``nn.Conv`` on (B, H, W, C): kernel HWIO there, OIHW here;
    ``padding`` "SAME" (TF rule) or "VALID".  ``groups`` is flax's
    ``feature_group_count``: a depthwise kernel (kh, kw, 1, C) there is
    (C, 1, kh, kw) here.  With ``use_bias=False`` there is no bias
    parameter, as in flax.  ``forward(x, channels_first=True)`` takes and
    gives (B, C, H, W) instead: the same convolution.  ``forward(x,
    add_bias=False)`` leaves the bias out, for a caller that adds it in a
    fused epilogue (``models/backbones/resnet.py``)."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 stride: int = 1, padding: str = "SAME", dtype: Optional[torch.dtype] = None,
                 kernel_init: str = "glorot_uniform", use_bias: bool = True, groups: int = 1):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(features, in_features // groups, *kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_kernel_(self.weight, self.kernel_init, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, channels_first: bool = False,
                add_bias: bool = True) -> torch.Tensor:
        x, weight, bias = promote(self.dtype, x, self.weight, self.bias if add_bias else None)
        conv = conv_channels_first if channels_first else conv_channels_last
        return conv(x, weight, bias, stride=self.stride, padding=self.padding, groups=self.groups)


class DiscrConv2d(Conv2d):
    """:class:`Conv2d` whose backward is differentiable through cuDNN's own
    gradient kernels (ops/conv_double_backward.py): the discriminator
    trunks' convolutions, which the R1 penalty differentiates twice.  The
    same parameters; an asymmetric SAME padding stays an ``F.pad`` before
    the convolution."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = promote(self.dtype, x, self.weight, self.bias)
        xc, conv_pad = channels_first_padded(x.movedim(-1, 1), weight, self.stride, self.padding)
        out = conv_double_backward.conv2d(xc, weight, bias, self.stride, conv_pad, self.groups)
        return out.movedim(1, -1).contiguous()


class MLP(nn.Module):
    """Generic Dense/LeakyReLU stack (reference ``MLPSimple``)."""

    def __init__(self, num_layers: int, num_in: int, num_hidden: int, num_out: int,
                 negative_slope: float = 0.3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        self.negative_slope = negative_slope
        dims = [num_in] + [num_hidden] * (num_layers - 1) + [num_out]
        for i in range(num_layers):
            self.add_module(f"dense_{i}", Dense(dims[i], dims[i + 1], dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.num_layers - 1:
                x = LeakyReLUUnitGradAtZero.apply(x, self.negative_slope)
        return x


class AdaIN(nn.Module):
    """Adaptive instance norm: an MLP maps z to per-channel (scale, bias);
    the input is instance-normalised over its spatial axes and modulated with
    ``x * (scale + 1) + bias`` (reference: building_blocks.py:114-149).
    ``adain_impl`` selects the fused kernel or its plain version
    (ops/norms.adain_modulate)."""

    def __init__(self, num_features: int, z_dim: int, mlp_num_units: int, mlp_num_layers: int,
                 dtype: Optional[torch.dtype] = None, adain_impl: str = "auto"):
        super().__init__()
        self.num_features = num_features
        self.adain_impl = adain_impl
        self.mlp = MLP(mlp_num_layers, z_dim, mlp_num_units, num_features * 2,
                       negative_slope=0.2, dtype=dtype)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        # The reference reshapes the MLP output to (B, 2, C): scale first.
        params = self.mlp(z).reshape(x.shape[0], 2, self.num_features)
        scale, bias = params[:, 0], params[:, 1]
        return adain_modulate(x, scale, bias, tuple(range(1, x.ndim - 1)), impl=self.adain_impl)


class ConvAdaIN(nn.Module):
    """(Up)conv -> LeakyReLU -> AdaIN, rank-generic (2D and 3D).

    Reference: ``Conv2dAdaIn``/``Conv3dAdaIn`` (building_blocks.py:11-80).
    ``pre_upsample`` absorbs the preceding nearest-2x upsample into the conv
    (ops/upconv.py).  ``double_conv`` inserts a second conv.
    """

    def __init__(self, in_features: int, num_feature_maps: int, kernel_size: int, rank: int,
                 z_dim: int, mlp_num_units: int, mlp_num_layers: int, double_conv: bool = False,
                 conv_negative_slope: float = 0.3, dtype: Optional[torch.dtype] = None,
                 pre_upsample: bool = False, upconv_impl: str = "auto",
                 adain_impl: str = "auto"):
        super().__init__()
        self.conv_negative_slope = conv_negative_slope
        ksize = (kernel_size,) * rank

        def conv(cin):
            if rank == 3:
                return Conv3d(cin, num_feature_maps, ksize, dtype=dtype)
            return Conv2d(cin, num_feature_maps, ksize, dtype=dtype)

        if pre_upsample:
            self.conv_0 = UpConv(in_features, num_feature_maps, ksize, dtype=dtype, impl=upconv_impl)
        else:
            self.conv_0 = conv(in_features)
        self.conv_1 = conv(num_feature_maps) if double_conv else None
        self.adain = AdaIN(num_feature_maps, z_dim, mlp_num_units, mlp_num_layers,
                           dtype=dtype, adain_impl=adain_impl)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_0(x)
        if self.conv_1 is not None:
            x = self.conv_1(leaky_relu(x, self.conv_negative_slope))
        x = leaky_relu(x, self.conv_negative_slope)
        return self.adain(x, z)


class DiscrBlock(nn.Module):
    """Stride-2 SAME conv block (TF padding: 0 before, 1 after for an even
    size and a 3x3 kernel), optionally returning style statistics
    (reference: building_blocks.py:83-111); the conv is a
    :class:`DiscrConv2d`.  The styles are taken from the
    conv output BEFORE the LeakyReLU; the block output goes through
    LeakyReLU(0.3) and then ``std_instance_norm`` with the per-channel
    ``in_gamma`` (ones) and ``in_beta`` (zeros)."""

    def __init__(self, in_features: int, num_feature_maps: int, kernel_size: int,
                 return_styles: bool = True, conv_negative_slope: float = 0.3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.return_styles = return_styles
        self.conv_negative_slope = conv_negative_slope
        self.conv = DiscrConv2d(in_features, num_feature_maps, (kernel_size, kernel_size),
                                stride=2, dtype=dtype)
        self.in_gamma = nn.Parameter(torch.ones(num_feature_maps))
        self.in_beta = nn.Parameter(torch.zeros(num_feature_maps))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.in_gamma)
        nn.init.zeros_(self.in_beta)

    def forward(self, x: torch.Tensor):
        x = self.conv(x)
        styles = layer_style(x) if self.return_styles else None
        x = leaky_relu(x, self.conv_negative_slope)
        x = std_instance_norm(x, self.in_gamma, self.in_beta, spatial_axes=(1, 2))
        return (x, styles) if self.return_styles else x
