"""The benchmark's weights and data, made on the device from ``--seed``.

The weights are the reference's trees (``reference/model.py``) filled in
a few large calls: every kernel (each parameter of two or more dimensions)
from one uniform draw, shaped to the layer's declared initialiser
(glorot-uniform, or he-normal as a truncated normal); the rest keep their
constructors' constants (ones and zeros).  The encoder's two heads, which a
fresh model zero-initialises, are scaled so that the random trunk's features
give latents and poses of unit scale, so renders vary with the photo.  One
state dict per tree goes to the port and, after the window, to the
reference.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

from benchmark.reference import model as ref
from benchmark.reference.resnet import resnet50_preprocess

# the constant of a unit normal truncated to [-2, 2], as the he-normal init uses
_TRUNCATED_STD = 0.87962566103423978


def _kernels(tree: torch.nn.Module):
    """(owner, name, parameter) of every kernel of ``tree``."""
    for owner in tree.modules():
        for name, p in owner.named_parameters(recurse=False):
            if p.ndim >= 2:
                yield owner, name, p


@torch.no_grad()
def fill_kernels(trees: Iterable[torch.nn.Module], generator: torch.Generator) -> None:
    kernels = [k for tree in trees for k in _kernels(tree)]
    total = sum(p.numel() for _, _, p in kernels)
    device = kernels[0][2].device
    flat = torch.rand(total, generator=generator, device=device, dtype=torch.float32)
    offset = 0
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    hi = 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    for owner, name, p in kernels:
        u = flat[offset:offset + p.numel()].view(p.shape)
        offset += p.numel()
        receptive = math.prod(p.shape[2:])
        fan_in, fan_out = p.shape[1] * receptive, p.shape[0] * receptive
        if getattr(owner, "kernel_init", "glorot_uniform") == "he_normal":
            std = math.sqrt(2.0 / fan_in) / _TRUNCATED_STD
            p.copy_(torch.erfinv((lo + u * (hi - lo)) * 2 - 1) * (math.sqrt(2) * std))
        else:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            p.copy_((u * 2 - 1) * limit)


@torch.no_grad()
def scale_encoder_heads(encoder: torch.nn.Module, photos_u8: torch.Tensor) -> None:
    """Scale the encoder's heads to unit-scale outputs on ``photos_u8``."""
    features = encoder.resnet(resnet50_preprocess(ref.unit_range(photos_u8))).float()
    rms = features.square().mean().sqrt()
    for head in (encoder.feature_to_latent, encoder.rotation_regressor):
        std = head.weight.float().square().mean().sqrt()
        head.weight.mul_(1.0 / (math.sqrt(head.weight.shape[1]) * rms * std))


def make_trees(config: Dict, trees, seed: int, device, photos_u8: torch.Tensor
               ) -> Dict[str, torch.nn.Module]:
    """The reference's ``trees`` on ``device`` with the benchmark's weights
    from ``seed``; ``photos_u8``: a few photos that scale the encoder's
    heads.  The EMA generator starts as the generator, as in a fresh model."""
    with torch.device(device):
        built = ref.build(config["model"], trees)
    # a fresh model's EMA generator is a copy of its generator
    copied = "generator" in built and "generator_smoothed" in built
    generator = torch.Generator(device=device).manual_seed(int(seed))
    fill_kernels([built[t] for t in sorted(built) if not (copied and t == "generator_smoothed")],
                 generator)
    if copied:
        built["generator_smoothed"].load_state_dict(built["generator"].state_dict())
    if "real_encoder" in built:
        scale_encoder_heads(built["real_encoder"], photos_u8)
    return built


def state_dicts(trees: Dict[str, torch.nn.Module], device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """Each tree's state dict, copied to ``device``."""
    return {name: {k: v.detach().to(device, copy=True) for k, v in tree.state_dict().items()}
            for name, tree in trees.items()}


def random_u8(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Seeded uint8 noise of ``shape`` on ``device``, in one call."""
    return torch.randint(0, 256, tuple(shape), generator=generator, device=device,
                         dtype=torch.uint8)
