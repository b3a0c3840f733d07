"""HoloGAN-style volumetric generator (counterpart of
``confignet_tpu/models/generator.py``; reference:
confignet/dnn_models/hologan_generator.py).

1. A learned constant (4, 4, 4, 512) input, a flat parameter initialised to
   ones.
2. Two upsample + Conv3D + AdaIN blocks -> a (16, 16, 16, nf/2) volume.
3. The volume is rotated by per-sample Euler angles (trilinear resample:
   the CUDA kernels or the gather form, ``rotation_resample``).
4. Two Conv3D(nf/4) + LeakyReLU(0.3), the depth collapse to
   (16, 16, 16 * nf/4), a 1x1 projection to 512 + LeakyReLU(0.2).
5. The 2D ConvAdaIN chain to the output size, a final up-conv(3, 4x4), tanh.

The latent is one vector for every AdaIN or a 5-way list feeding
[z_3d_0, z_3d_1, z_2d_0, z_2d_1, z_2d_2].
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from benchmark.reference.transforms import euler_angles_to_matrix, rotate_3d_grid
from benchmark.reference.blocks import Conv2d, ConvAdaIN, leaky_relu
from benchmark.reference.conv3d import Conv3d
from benchmark.reference.upconv import UpConv

LatentInput = Union[torch.Tensor, Sequence[torch.Tensor], Dict[str, torch.Tensor]]

_Z_KEYS = ("z_3d_0", "z_3d_1", "z_2d_0", "z_2d_1", "z_2d_2")


def resolve_rotation_impl(name: str, x: torch.Tensor):
    """The gather form in float32 for every setting.  The port's training
    kernels ("kernel_train", and "auto_train" on a CUDA tensor) define the
    transform's gradient as zero, so there the transform is detached; on the
    CPU "auto_train" is the port's gather form, which differentiates it."""
    if name not in ("auto", "auto_train", "gather", "kernel", "kernel_train"):
        raise ValueError(f"unknown rotation_resample implementation {name!r}")
    detach = name == "kernel_train" or (name == "auto_train" and x.is_cuda)

    def rotate(grid: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
        return rotate_3d_grid(grid.float(), transform.detach() if detach else transform).to(grid.dtype)

    return rotate


def build_input_dict(latent_vector, rotation) -> Dict[str, torch.Tensor]:
    """Map a single latent (or 5-way latent list) + rotation to per-block
    inputs (reference: hologan_generator.py:109-127)."""
    if isinstance(latent_vector, (list, tuple)):
        input_dict = dict(zip(_Z_KEYS, latent_vector))
    else:
        input_dict = {key: latent_vector for key in _Z_KEYS}
    input_dict["rotation"] = rotation
    return input_dict


class HologanGenerator(nn.Module):
    def __init__(self, latent_dim: int, output_shape: Sequence[int], n_adain_mlp_units: int = 128,
                 n_adain_mlp_layers: int = 2, gen_output_activation: str = "tanh",
                 const_shape: Sequence[int] = (4, 4, 4, 512), n_features_first: int = 256,
                 dtype: Optional[torch.dtype] = None, rotation_resample: str = "auto",
                 upconv_impl: str = "auto", adain_impl: str = "auto"):
        super().__init__()
        if tuple(output_shape[:2]) not in ((128, 128), (256, 256), (512, 512)):
            # The fixed upsample chain (16px base, 3 doublings + the two gated
            # extra blocks) can only hit these square sizes.
            raise ValueError(
                f"output_shape {tuple(output_shape)} unsupported: the generator renders "
                "square 128/256/512 images")
        if gen_output_activation not in ("tanh", None, "linear"):
            raise ValueError(f"unknown output activation {gen_output_activation!r}")
        self.output_size = int(output_shape[0])
        self.const_shape = tuple(const_shape)
        self.dtype = dtype
        self.rotation_resample = rotation_resample
        self.gen_output_activation = gen_output_activation
        nf = n_features_first
        self.learned_input = nn.Parameter(torch.ones(math.prod(self.const_shape)))

        def block(cin, cout, name, rank, pre_upsample=True):
            self.add_module(name, ConvAdaIN(
                cin, cout, kernel_size=3 if rank == 3 else 4, rank=rank, z_dim=latent_dim,
                mlp_num_units=n_adain_mlp_units, mlp_num_layers=n_adain_mlp_layers,
                dtype=dtype, pre_upsample=pre_upsample, upconv_impl=upconv_impl,
                adain_impl=adain_impl))

        block(self.const_shape[-1], nf, "map_3d_0", 3)
        block(nf, nf // 2, "map_3d_1", 3)
        self.map_3d_post_0 = Conv3d(nf // 2, nf // 4, (3, 3, 3), dtype=dtype)
        self.map_3d_post_1 = Conv3d(nf // 4, nf // 4, (3, 3, 3), dtype=dtype)
        # the rotated volume has 4x the constant's side; its depth collapses
        # into channels
        volume_side = 4 * self.const_shape[2]
        self.projection_conv = Conv2d(volume_side * (nf // 4), 512, (1, 1), dtype=dtype)
        block(512, nf, "map_2d_0", 2, pre_upsample=False)
        block(nf, nf // 4, "map_2d_1", 2)
        block(nf // 4, nf // 8, "map_2d_2", 2)
        self.extra_blocks = []
        if self.output_size > 128:
            block(nf // 8, nf // 8, "map_2d_2b", 2)
            self.extra_blocks.append("map_2d_2b")
        if self.output_size > 256:
            block(nf // 8, nf // 16, "map_2d_2c", 2)
            self.extra_blocks.append("map_2d_2c")
        last = nf // 16 if self.output_size > 256 else nf // 8
        self.map_final = UpConv(last, 3, (4, 4), dtype=dtype, impl=upconv_impl)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.learned_input)

    def forward(self, inputs: LatentInput, rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
        if isinstance(inputs, dict):
            input_dict = inputs
        else:
            if rotation is None:
                latent_vector, rotation = inputs[0], inputs[1]
            else:
                latent_vector = inputs
            input_dict = build_input_dict(latent_vector, rotation)

        batch = input_dict["z_3d_0"].shape[0]
        x = self.learned_input.expand(batch, -1).reshape(batch, *self.const_shape)
        if self.dtype is not None:
            x = x.to(self.dtype)

        x = self.map_3d_0(x, input_dict["z_3d_0"])
        x = self.map_3d_1(x, input_dict["z_3d_1"])

        # In float32 mode the resample runs in float32 (the reference casts
        # explicitly); in bf16 mode it stays bf16.  Coordinates are float32
        # either way.
        transforms = euler_angles_to_matrix(input_dict["rotation"].float())
        x = x.to(self.dtype or torch.float32)
        x = resolve_rotation_impl(self.rotation_resample, x)(x, transforms)

        x = leaky_relu(self.map_3d_post_0(x), 0.3)
        x = leaky_relu(self.map_3d_post_1(x), 0.3)

        # Depth collapse (b, d, h, w, c) -> (b, d, h, w*c): channel index
        # w*C + c, image axes are the volume's (d, h).  x is channels-last.
        b, d, h, w, c = x.shape
        x = x.reshape(b, d, h, w * c)
        x = leaky_relu(self.projection_conv(x), 0.2)  # tf.nn.leaky_relu default

        x = self.map_2d_0(x, input_dict["z_2d_0"])
        x = self.map_2d_1(x, input_dict["z_2d_1"])
        x = self.map_2d_2(x, input_dict["z_2d_2"])
        for name in self.extra_blocks:
            x = getattr(self, name)(x, input_dict["z_2d_2"])

        x = self.map_final(x)
        if self.gen_output_activation == "tanh":
            x = torch.tanh(x)
        return x
