"""LatentGAN: a small MLP GAN over ConfigNet's latent space, so faces can be
sampled without a photo (counterpart of ``confignet_tpu/training/latent_gan.py``;
reference: confignet/latent_gan.py).

G and D are 3-layer MLPs (hidden ``int(1.5 * latent_dim)``) under the JAX
parameter names, so ``load_jax_params`` and the checkpoint files carry
weights across.  One train step (:meth:`LatentGAN._build_train_step`) runs
the JAX step's order (latent_gan.py:121-167): the D update with R1 on
G(noise), the G update against the already-updated D, then the EMA of G.
Noise comes from a ``torch.Generator`` on the model's device through
:meth:`LatentGAN._sample_noise`, which a caller may override to pin it.  The
MLPs are plain torch: the JAX package runs them as XLA, with no Pallas
kernel.  ``train``, ``setup_logs`` and the verbose logs (FID/KID, the
TensorBoard writer) come with the metrics and infrastructure slices.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from confignet_tpu_torch.core import initializers
from confignet_tpu_torch.core.config import merge_configs
from confignet_tpu_torch.core.device import resolve_device
from confignet_tpu_torch.core.model_io import (
    check_not_reference_format, export_jax_params, load_jax_params, load_model_weights,
    save_model_weights)
from confignet_tpu_torch.losses.gan import compute_latent_discriminator_loss, gan_g_loss
from confignet_tpu_torch.models.blocks import MLP
from confignet_tpu_torch.training.state import ema_update, make_adam

DEFAULT_CONFIG: Dict[str, Any] = {
    "model_type": "LatentGAN",
    "latent_dim": None,
    "optimizer": {"lr": 0.00005, "beta_1": 0.0, "beta_2": 0.9, "amsgrad": False},
    "batch_size": 32,
    "num_mlp_layers": 3,
    "latent_distribution_type": "normal",
    "hidden_layer_size_multiplier": 1.5,
    "n_samples_for_metrics": 1000,
    "verbose_log_period": 500,
    "loss_print_period": 50,
    "logging_img_square_size": 6,
    "seed": 0,
}

# the parameter trees of the checkpoint (latent_gan.py:308-314); G and D are
# the two players, each under its own Adam
WEIGHT_TREES = ("generator", "generator_smoothed", "discriminator")

Losses = Dict[str, Dict[str, torch.Tensor]]


class LatentGAN:
    MODEL_TYPE = "LatentGAN"

    def __init__(self, config: Dict[str, Any], device: Optional[Union[str, torch.device]] = None):
        self.config = merge_configs(DEFAULT_CONFIG, config)
        self.config["model_type"] = self.MODEL_TYPE
        if self.config["latent_dim"] is None:
            raise ValueError("LatentGAN config requires latent_dim")
        self.device = resolve_device(device)

        latent_dim = self.config["latent_dim"]
        hidden = int(latent_dim * self.config["hidden_layer_size_multiplier"])
        self.generator = MLP(self.config["num_mlp_layers"], latent_dim, hidden, latent_dim)
        self.discriminator = MLP(self.config["num_mlp_layers"], latent_dim, hidden, 1)
        # seeded init on the CPU (the same weights on every device)
        rng = torch.Generator().manual_seed(int(self.config.get("seed", 0)))
        initializers.initialize(self.generator, rng)
        initializers.initialize(self.discriminator, rng)
        self.generator_smoothed = copy.deepcopy(self.generator).requires_grad_(False)
        for name in WEIGHT_TREES:
            getattr(self, name).to(self.device).eval()
        self._draws = torch.Generator(device=self.device).manual_seed(int(self.config.get("seed", 0)))
        self._make_optimizers()

    def _make_optimizers(self) -> None:
        """A fresh Adam per player (``set_weights`` resets them, as the JAX
        package resets its optimizer states)."""
        self.optimizers = {name: make_adam(getattr(self, name).parameters(), self.config["optimizer"])
                           for name in ("generator", "discriminator")}

    # ------------------------------------------------------------------
    # The train step
    # ------------------------------------------------------------------

    def _sample_noise(self, n: int) -> torch.Tensor:
        """The step's input noise (override to pin it)."""
        shape = (n, self.config["latent_dim"])
        if self.config["latent_distribution_type"] == "uniform":
            return torch.rand(shape, generator=self._draws, device=self.device) * 2 - 1
        return torch.randn(shape, generator=self._draws, device=self.device)

    def _update(self, player: str, loss: torch.Tensor) -> None:
        """One Adam step of ``player`` on the gradient of ``loss`` with
        respect to its own parameters only."""
        params = list(getattr(self, player).parameters())
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizers[player].step()
        for p in params:
            p.grad = None

    def _build_train_step(self) -> Callable[[torch.Tensor], Losses]:
        """``step(real_embeddings) -> {"d": ..., "g": ...}`` loss dicts
        (detached 0-d tensors on the device); updates G, D, their Adams and
        the EMA generator in place."""
        batch_size = self.config["batch_size"]

        def step(real_embeddings: torch.Tensor) -> Losses:
            # the discriminator, on G(noise) of the pre-step generator
            with torch.no_grad():
                fake_embeddings = self.generator(self._sample_noise(batch_size))
            d_losses = compute_latent_discriminator_loss(self.discriminator, real_embeddings,
                                                         fake_embeddings)
            self._update("discriminator", d_losses["loss_sum"])

            # the generator, against the updated discriminator
            scores = self.discriminator(self.generator(self._sample_noise(batch_size)))
            g_losses = {"gan_loss": gan_g_loss(scores)}
            g_losses["loss_sum"] = g_losses["gan_loss"]
            self._update("generator", g_losses["loss_sum"])

            ema_update(self.generator_smoothed, self.generator)
            return {"d": {k: v.detach() for k, v in d_losses.items()},
                    "g": {k: v.detach() for k, v in g_losses.items()}}

        return step

    # ------------------------------------------------------------------
    # Embeddings and sampling
    # ------------------------------------------------------------------

    def extract_embeddings(self, confignet_model, training_set, max_chunk_size: int = 1000) -> np.ndarray:
        """Embed ``training_set.imgs`` through the ConfigNet's real encoder
        in chunks (latent_gan.py:171-182)."""
        n_imgs = training_set.imgs.shape[0]
        embeddings = np.zeros((n_imgs, self.config["latent_dim"]), np.float32)
        for start in range(0, n_imgs, max_chunk_size):
            end = min(start + max_chunk_size, n_imgs)
            print(f"Extracting embeddings {start}:{end} of {n_imgs}")
            embeddings[start:end], _ = confignet_model.encode_images(training_set.imgs[start:end])
        return embeddings

    def sample_input_latent_vector(self, n_samples: int) -> np.ndarray:
        """Input noise from the global np.random, as the JAX package draws it."""
        if self.config["latent_distribution_type"] == "uniform":
            return np.random.uniform(-1, 1, (n_samples, self.config["latent_dim"]))
        return np.random.normal(0, 1, (n_samples, self.config["latent_dim"]))

    @torch.inference_mode()
    def generate_latents_smoothed(self, input_latents) -> np.ndarray:
        """The EMA generator's latents for the given input noise (float32)."""
        noise = torch.from_numpy(np.asarray(input_latents, np.float32)).to(self.device)
        return self.generator_smoothed(noise).float().cpu().numpy()

    def generate_latents(self, n_samples: int, truncation: float = 1.0) -> np.ndarray:
        """Sample latents; ``truncation`` scales the input noise
        (latent_gan.py:300-304)."""
        noise = self.sample_input_latent_vector(n_samples) * truncation
        return self.generate_latents_smoothed(noise.astype(np.float32))

    # ------------------------------------------------------------------
    # Weights and checkpoint files
    # ------------------------------------------------------------------

    def get_weights(self) -> Dict[str, Dict[str, np.ndarray]]:
        """{tree: {pytree path: ndarray}} for every tree in ``WEIGHT_TREES``."""
        return {name: export_jax_params(getattr(self, name)) for name in WEIGHT_TREES}

    def set_weights(self, weights: Dict[str, Dict[str, np.ndarray]]) -> None:
        """Load every tree of ``WEIGHT_TREES``; the optimizer states are reset."""
        for name in WEIGHT_TREES:
            load_jax_params(getattr(self, name), weights[name])
        self._make_optimizers()

    def save(self, output_dir: str, output_filename: str) -> None:
        """Write ``<output_filename>.npz`` and ``.json``, as the JAX package
        writes them."""
        save_model_weights(self.get_weights(), output_dir, output_filename)
        with open(os.path.join(output_dir, output_filename + ".json"), "w") as fp:
            json.dump(self.config, fp, indent=4)

    @classmethod
    def load(cls, file_path: str, device: Optional[Union[str, torch.device]] = None) -> "LatentGAN":
        """Load a LatentGAN checkpoint written by either package on
        ``device``; a reference-release npz raises NotImplementedError."""
        npz_path = os.path.splitext(file_path)[0] + ".npz"
        check_not_reference_format(npz_path)
        with open(file_path, "r") as fp:
            config = json.load(fp)
        gan = cls(config, device=device)
        gan.set_weights(load_model_weights(npz_path))
        return gan
