"""ConfigNet in plain PyTorch: the module trees of both stages, the serving
pipeline (encode, splice one attribute, render, uint8) and the stage-2
train step, built from a configuration file of ``benchmark/configs``.

A frozen copy of the port's maths with the kernels' plain versions: the
rotation is the gather form in float32, every AdaIN the plain statistics,
every up-convolution the naive upsample-then-conv form, and Adam a
per-parameter loop.  It imports nothing of the port, so a change to the
port cannot change what it is judged against.  The tree names, and so the
state dicts, are the port's, and the benchmark hands one state dict to both.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.blocks import MLP
from benchmark.reference.discriminator import HologanDiscriminator, HologanLatentRegressor
from benchmark.reference.gan import (
    compute_discriminator_loss, compute_latent_discriminator_loss, eye_loss, gan_d_loss,
    gan_g_loss, normalized_latent_regression_loss)
from benchmark.reference.generator import HologanGenerator
from benchmark.reference.perceptual import PerceptualLoss
from benchmark.reference.real_encoder import RealEncoder
from benchmark.reference.state import PlainAdam, ema_update, make_adam
from benchmark.reference.synthetic_encoder import SyntheticDataEncoder

# the trees of a ConfigNet checkpoint, under the port's names
TREES = ("generator", "generator_smoothed", "latent_regressor", "synthetic_encoder",
         "discriminator", "synth_discriminator", "latent_discriminator", "real_encoder")
# the trees the serving pipeline reads
SERVING_TREES = ("real_encoder", "synthetic_encoder", "generator_smoothed")
# each player's trees, under one Adam
PLAYER_TREES = {
    "generator": ("generator", "latent_regressor", "synthetic_encoder", "real_encoder"),
    "discriminator": ("discriminator",),
    "synth_discriminator": ("synth_discriminator",),
    "latent_discriminator": ("latent_discriminator",),
}


def facemodel_inputs(config: Dict[str, Any]):
    """(name, (input_dim, latent_dim)) sorted by name, as the model orders them."""
    return tuple(sorted((k, tuple(v)) for k, v in config["facemodel_inputs"].items()))


def latent_slice(config: Dict[str, Any], name: str) -> slice:
    """Where ``name``'s encoding sits in the latent."""
    start = 0
    for other, (_, width) in facemodel_inputs(config):
        if other == name:
            return slice(start, start + width)
        start += width
    raise KeyError(name)


def build(config: Dict[str, Any], trees=TREES) -> Dict[str, torch.nn.Module]:
    """The named trees of a ConfigNet at ``config`` (constructor weights;
    the benchmark loads its own)."""
    inputs = facemodel_inputs(config)
    latent_dim = sum(v[1] for _, v in inputs)
    size = tuple(config["output_shape"][:2])

    def generator(train: bool):
        return HologanGenerator(
            latent_dim=latent_dim, output_shape=size,
            n_adain_mlp_units=config["n_adain_mlp_units"],
            n_adain_mlp_layers=config["n_adain_mlp_layers"],
            gen_output_activation=config["gen_output_activation"],
            const_shape=tuple(config["const_input_shape"]),
            n_features_first=config["n_generator_features"],
            rotation_resample=config.get("rotation_resample_train", "auto_train") if train
            else "gather")

    discriminator = dict(
        img_shape=size, num_resample=config["n_discr_layers"],
        disc_kernel_size=config["discr_conv_kernel_size"],
        disc_expansion_factor=config["n_discr_features_at_layer_0"],
        disc_max_feature_maps=config["max_discr_filters"],
        initial_from_rgb_layer_in_discr=config["initial_from_rgb_layer_in_discr"])
    makers: Dict[str, Callable[[], torch.nn.Module]] = {
        "generator": lambda: generator(True),
        "generator_smoothed": lambda: generator(False),
        "latent_regressor": lambda: HologanLatentRegressor(latent_dim=latent_dim, **discriminator),
        "synthetic_encoder": lambda: SyntheticDataEncoder(
            inputs, num_layers=config["num_synth_encoder_layers"]),
        "discriminator": lambda: HologanDiscriminator(**discriminator),
        "synth_discriminator": lambda: HologanDiscriminator(**discriminator),
        "latent_discriminator": lambda: MLP(config["n_latent_discr_layers"], latent_dim,
                                            latent_dim, 1),
        "real_encoder": lambda: RealEncoder(
            latent_dim=latent_dim, rotation_ranges=tuple(tuple(r) for r in config["rotation_ranges"])),
        "perceptual_loss": lambda: PerceptualLoss("imagenet"),
    }
    return {name: makers[name]() for name in trees}


def unit_range(u8: torch.Tensor) -> torch.Tensor:
    return u8.float() / 127.5 - 1.0


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] renders -> uint8, truncating, as the served bytes are made."""
    return ((torch.clamp(images.float(), -1, 1) + 1) * 127.5).to(torch.uint8)


@torch.no_grad()
def render_with_attribute(trees: Dict[str, torch.nn.Module], config: Dict[str, Any],
                          photos: torch.Tensor, param_name: str, value: torch.Tensor,
                          rotations: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 photos (B, H, W, 3) -> the renders with ``param_name`` set to
    ``value`` (one row, broadcast, or one per photo), at ``rotations`` or at
    the encoder's pose: float32 in [-1, 1]."""
    latents, encoded_rotations = trees["real_encoder"](unit_range(photos))
    encoded = trees["synthetic_encoder"].encode_single_param(param_name, value)
    latents = latents.clone()
    latents[:, latent_slice(config, param_name)] = encoded.expand(latents.shape[0], -1)
    poses = encoded_rotations if rotations is None else rotations
    return trees["generator_smoothed"](latents, poses)


# -- the stage-2 train step -----------------------------------------------------


def batched_hflip(images: torch.Tensor, flip_mask: torch.Tensor) -> torch.Tensor:
    mask = flip_mask.to(images.dtype).reshape(-1, 1, 1, 1)
    return images * (1 - mask) + images.flip(2) * mask


class Stage2Trainer:
    """The stage-2 step over ``trees`` (which it updates in place), its
    random draws from a ``torch.Generator`` on the trees' device seeded
    with ``seed``, taken in the port's order: the image-D, synthetic-D and
    latent-D hflip masks, then the generator player's."""

    def __init__(self, trees: Dict[str, torch.nn.Module], config: Dict[str, Any], seed: int,
                 device):
        self.trees, self.config = trees, config
        # on the meta device (operation counts) there is nothing to draw
        self.draws = (None if torch.device(device).type == "meta"
                      else torch.Generator(device=device).manual_seed(int(seed)))
        self.device = device
        for tree in trees.values():
            tree.eval()
        trees["generator_smoothed"].requires_grad_(False)
        trees["perceptual_loss"].requires_grad_(False)
        self.params = {player: [p for t in names for p in trees[t].parameters()]
                       for player, names in PLAYER_TREES.items()}
        self.optimizers: Dict[str, PlainAdam] = {
            player: make_adam(params, config["optimizer"]) for player, params in self.params.items()}
        self.last_grads: Dict[str, List[torch.Tensor]] = {}

    def _flip(self, n: int) -> torch.Tensor:
        return torch.rand((n,), generator=self.draws, device=self.device) < 0.5

    def _update(self, player: str, loss: torch.Tensor) -> None:
        params = self.params[player]
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        self.last_grads[player] = [g.detach() for g in grads]
        self.optimizers[player].step(grads)

    def _generator_losses(self, gb: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        t, cfg = self.trees, self.config
        w_img, w_reg = cfg["image_loss_weight"], cfg["latent_regression_weight"]
        losses: Dict[str, torch.Tensor] = {}
        synth_latents = t["synthetic_encoder"](list(gb["g_facemodel"]))
        out_synth = t["generator"](synth_latents, gb["g_rotations"])
        real_imgs = batched_hflip(unit_range(gb["g_real_imgs"]), self._flip(gb["g_real_imgs"].shape[0]))
        real_latents, real_rotations = t["real_encoder"](real_imgs)
        out_real = t["generator"](real_latents, real_rotations)
        gt_synth = unit_range(gb["g_gt_imgs"])
        perceptual = t["perceptual_loss"]
        losses["image_loss_synth"] = w_img * perceptual.loss_fn(gt_synth, out_synth)
        losses["image_loss_real"] = w_img * perceptual.loss_fn(real_imgs, out_real)
        if cfg.get("pixel_loss_weight", 0.0) > 0.0 or cfg.get("encoder_inversion_weight", 0.0) > 0.0:
            raise ValueError("the reference step has no pixel or encoder-inversion loss")
        losses["eye_loss"] = cfg["eye_loss_weight"] * eye_loss(gt_synth, out_synth, gb["g_eye_masks"])
        for i, head in enumerate(t["synth_discriminator"](out_synth).values()):
            losses[f"GAN_loss_synth_{i}"] = gan_g_loss(head)
        for i, head in enumerate(t["discriminator"](out_real).values()):
            losses[f"GAN_loss_real_{i}"] = gan_g_loss(head)
        ld_real = t["latent_discriminator"](real_latents)
        ld_synth = t["latent_discriminator"](synth_latents)
        labels = torch.cat([torch.zeros_like(ld_real), torch.ones_like(ld_synth)], dim=0)
        losses["latent_GAN_loss"] = cfg["domain_adverserial_loss_weight"] * gan_d_loss(
            labels, torch.cat([ld_real, ld_synth], dim=0))
        if w_reg > 0.0:
            stacked_rotations = torch.cat([gb["g_rotations"], real_rotations], dim=0)
            labels = torch.cat([torch.cat([synth_latents, real_latents], dim=0),
                                cfg["latent_regressor_rot_weight"] * stacked_rotations], dim=-1)
            losses["latent_regression_loss"] = normalized_latent_regression_loss(
                t["latent_regressor"](torch.cat([out_synth, out_real], dim=0)), labels, w_reg)
        losses["loss_sum"] = sum(losses.values())
        return losses

    def step(self, b: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One step on a device batch; returns each player's loss sum."""
        t, r1_heads = self.trees, self.config.get("r1_heads", "all")
        n = b["d_real_imgs"].shape[0]
        if self.config.get("n_discriminator_updates", 1) != 1 or \
                self.config.get("n_generator_updates", 1) != 1:
            raise ValueError("the reference step takes one update per player")
        real = batched_hflip(unit_range(b["d_real_imgs"]), self._flip(n))
        with torch.no_grad():
            latents, rotations = t["real_encoder"](unit_range(b["d_input_imgs"]))
            fake = t["generator"](latents, rotations)
        d = compute_discriminator_loss(t["discriminator"], real, fake, r1_heads=r1_heads)
        self._update("discriminator", d["loss_sum"])

        synth_real = batched_hflip(unit_range(b["synth_d_real_imgs"]), self._flip(n))
        with torch.no_grad():
            synth_fake = t["generator"](t["synthetic_encoder"](list(b["synth_d_facemodel"])),
                                        b["synth_d_rotations"])
        sd = compute_discriminator_loss(t["synth_discriminator"], synth_real, synth_fake,
                                        r1_heads=r1_heads)
        self._update("synth_discriminator", sd["loss_sum"])

        imgs = batched_hflip(unit_range(b["latent_d_real_imgs"]), self._flip(n))
        with torch.no_grad():
            real_latents = t["real_encoder"](imgs)[0]
            fake_latents = t["synthetic_encoder"](list(b["latent_d_facemodel"]))
        ld = compute_latent_discriminator_loss(t["latent_discriminator"], real_latents, fake_latents)
        self._update("latent_discriminator", ld["loss_sum"])

        g = self._generator_losses(b)
        self._update("generator", g["loss_sum"])
        ema_update(t["generator_smoothed"], t["generator"])
        return {"d": d["loss_sum"].detach(), "g": g["loss_sum"].detach(),
                "latent_d": ld["loss_sum"].detach(), "synth_d": sd["loss_sum"].detach()}


def as_device_batch(host: Dict[str, Any], device) -> Dict[str, Any]:
    """A host batch (numpy arrays, tuples of them) on the device."""
    def put(v):
        if isinstance(v, (list, tuple)):
            return [put(x) for x in v]
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return {k: put(v) for k, v in host.items()}
