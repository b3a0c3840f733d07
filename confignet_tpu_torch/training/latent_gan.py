"""LatentGAN: a small MLP GAN over ConfigNet's latent space, so faces can be
sampled without a photo (counterpart of ``confignet_tpu/training/latent_gan.py``;
reference: confignet/latent_gan.py).

G and D are 3-layer MLPs (hidden ``int(1.5 * latent_dim)``) under the JAX
parameter names, so ``load_jax_params`` and the checkpoint files carry
weights across.  One train step (:meth:`LatentGAN._build_train_step`) runs
the JAX step's order (latent_gan.py:121-167): the D update with R1 on
G(noise), the G update against the already-updated D, then the EMA of G.
Noise comes from a ``torch.Generator`` on the model's device through
:meth:`LatentGAN._sample_noise`, which a caller may override to pin it.  On
the card the step and the EMA generator's sampling run as captured CUDA
graphs (``core/graphs.py``), as the JAX package jits both: the step's
first call eagerly, every later one a replay that draws its noise afresh;
the sampler a chunk of ``SAMPLE_CHUNK`` latents a replay.  The
MLPs are plain torch: the JAX package runs them as XLA, with no Pallas
kernel.  :meth:`LatentGAN.train` (latent_gan.py:184-285) embeds the training
set once, keeps the embeddings on the device, fetches the losses a window
at a time and, every ``verbose_log_period`` steps, renders a panel, saves
``checkpoints/<step>`` and scores KID/FID of the ConfigNet's renders.
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
from confignet_tpu_torch.core.graphs import GraphCache, copy_out
from confignet_tpu_torch.core.images import build_image_matrix
from confignet_tpu_torch.core.logging_utils import LossFlusher, TensorBoardWriter
from confignet_tpu_torch.core.model_io import (
    export_jax_params, load_jax_params, load_model_weights, npz_is_reference_format,
    save_model_weights)
from confignet_tpu_torch.losses.gan import (
    compute_latent_discriminator_loss, gan_g_loss, lead_autograd_sequence)
from confignet_tpu_torch.models.blocks import MLP
from confignet_tpu_torch.training.state import (
    ema_update, make_adam, optimizer_constants, optimizer_state)

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
# the sampler's device batch: each request is cut into chunks of this many
# latents, the last padded, one captured graph a chunk
SAMPLE_CHUNK = 256

Losses = Dict[str, Dict[str, torch.Tensor]]


class LatentGAN:
    MODEL_TYPE = "LatentGAN"
    WEIGHT_TREES = WEIGHT_TREES

    def __init__(self, config: Dict[str, Any], device: Optional[Union[str, torch.device]] = None):
        self.config = merge_configs(DEFAULT_CONFIG, config)
        self.config["model_type"] = self.MODEL_TYPE
        if self.config["latent_dim"] is None:
            raise ValueError("LatentGAN config requires latent_dim")
        self.device = resolve_device(device)
        self._draws = torch.Generator(device=self.device).manual_seed(int(self.config.get("seed", 0)))
        self.log_writer: Optional[TensorBoardWriter] = None
        self.inputs_for_logs: Optional[Dict[str, np.ndarray]] = None
        self.inputs_for_metrics: Optional[Dict[str, np.ndarray]] = None
        self.metrics: Dict[str, list] = {}
        self._inception_metric_object = None
        self._train_step_fn: Optional[Callable[[torch.Tensor], Losses]] = None
        # the sampler's captured graphs (on the card)
        self._graphs = GraphCache(self.device)

        self.initialize_network()

    def initialize_network(self) -> None:
        """The generator and discriminator MLPs from the config's seed (on
        the CPU, so every device gets the same weights), the EMA copy of the
        generator and a fresh Adam per player."""
        latent_dim = self.config["latent_dim"]
        hidden = int(latent_dim * self.config["hidden_layer_size_multiplier"])
        self.generator = MLP(self.config["num_mlp_layers"], latent_dim, hidden, latent_dim)
        self.discriminator = MLP(self.config["num_mlp_layers"], latent_dim, hidden, 1)
        rng = torch.Generator().manual_seed(int(self.config.get("seed", 0)))
        initializers.initialize(self.generator, rng)
        initializers.initialize(self.discriminator, rng)
        self.generator_smoothed = copy.deepcopy(self.generator).requires_grad_(False)
        for name in WEIGHT_TREES:
            getattr(self, name).to(self.device).eval()
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
        (detached 0-d tensors on the device, the step's own); updates G, D,
        their Adams and the EMA generator in place.  On the card the step
        is a CUDA graph of a cache of its own (``step.graphs``): the first
        call runs eagerly, the second captures, later calls replay, each
        drawing fresh noise from the model's registered generator."""
        if self.device.type == "cuda":
            lead_autograd_sequence()
        batch_size = self.config["batch_size"]
        graphs = GraphCache(self.device)

        def update(real_embeddings: torch.Tensor) -> Losses:
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
            # keys sorted, as the JAX step's jit returns its dicts
            return {"d": {k: v.detach() for k, v in sorted(d_losses.items())},
                    "g": {k: v.detach() for k, v in sorted(g_losses.items())}}

        def step(real_embeddings: torch.Tensor) -> Losses:
            losses = graphs.run_step(
                ("latent_gan_step", batch_size, optimizer_constants(self.optimizers)), update,
                (real_embeddings,), [getattr(self, tree) for tree in WEIGHT_TREES],
                lambda: optimizer_state(self.optimizers), (self._draws,))
            return copy_out(losses)

        step.graphs = graphs
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

    # ------------------------------------------------------------------
    # The training loop (latent_gan.py:184-285)
    # ------------------------------------------------------------------

    def setup_logs(self, log_dir, training_set, confignet_model) -> None:
        """The TensorBoard writer, the fixed inputs of the panel and the
        metrics (from the global ``np.random``, in the JAX package's order)
        and the FID/KID harness over ``training_set``."""
        os.makedirs(log_dir, exist_ok=True)
        self.log_writer = TensorBoardWriter(log_dir)
        n_logged = self.config["logging_img_square_size"] ** 2
        self.inputs_for_logs = {"latents": self.sample_input_latent_vector(n_logged),
                                "rotations": np.zeros((n_logged, 3), np.float32)}
        n_metrics = self.config["n_samples_for_metrics"]
        self.inputs_for_metrics = {"latents": self.sample_input_latent_vector(n_metrics),
                                   "rotations": confignet_model.sample_rotations(n_metrics)}
        try:
            from confignet_tpu_torch.metrics.inception import InceptionMetrics

            self._inception_metric_object = InceptionMetrics(
                confignet_model.config, training_set, n_samples_for_metrics=n_metrics,
                device=self.device)
        except Exception as exc:  # the JAX trainer trains on without metrics too
            print(f"WARNING: inception metrics disabled ({exc})")
            self._inception_metric_object = None

    def train(self, training_set, confignet_model, output_dir, log_dir, n_iters: int) -> None:
        """``n_iters`` steps on minibatches (``np.random.randint`` indexes)
        of the training set's ConfigNet embeddings, held on the device."""
        self.setup_logs(log_dir, training_set, confignet_model)
        gt_embeddings = self.extract_embeddings(confignet_model, training_set)
        gt_embeddings_dev = torch.from_numpy(gt_embeddings).to(self.device)
        if self._train_step_fn is None:
            self._train_step_fn = self._build_train_step()

        batch_size = self.config["batch_size"]
        verbose_p = self.config["verbose_log_period"]
        # no per-step device -> host fetch: the losses come a window at a time
        flusher = LossFlusher(self.config.get("loss_print_period", 50))
        steps_pending = []
        for step_number in range(n_iters):
            idx = np.random.randint(0, gt_embeddings.shape[0], batch_size)
            real = gt_embeddings_dev[torch.from_numpy(idx).to(self.device)]
            losses = self._train_step_fn(real)
            steps_pending.append(step_number)

            flush_due = flusher.append(losses)
            at_verbose = step_number % verbose_p == 0
            if not (flush_due or at_verbose or step_number == n_iters - 1):
                continue
            fetched = flusher.flush()
            for step, step_losses in zip(steps_pending, fetched):
                self._write_scalar_logs(step, step_losses["d"], step_losses["g"])
            print("[step: %d] [D loss: %f] [G loss: %f]"
                  % (step_number, fetched[-1]["d"]["loss_sum"], fetched[-1]["g"]["loss_sum"]))
            steps_pending = []
            if at_verbose:
                self._write_verbose_logs(output_dir, step_number, confignet_model)

    def _write_scalar_logs(self, step_number, d_loss, g_loss) -> None:
        if self.log_writer is not None:
            for key, value in d_loss.items():
                self.log_writer.scalar("discr_" + key, float(value), step_number)
            for key, value in g_loss.items():
                self.log_writer.scalar("gen_" + key, float(value), step_number)

    def write_logs(self, output_dir, step_number, d_loss, g_loss, confignet_model) -> None:
        self._write_scalar_logs(step_number, d_loss, g_loss)
        if step_number % self.config["verbose_log_period"] != 0:
            return
        self._write_verbose_logs(output_dir, step_number, confignet_model)

    def _write_verbose_logs(self, output_dir, step_number, confignet_model) -> None:
        """The panel of the EMA generator's latents, ``checkpoints/<step>``,
        and KID/FID of the ConfigNet's renders of the metric latents."""
        predicted = self.generate_latents_smoothed(self.inputs_for_logs["latents"])
        generated_images = confignet_model.generate_images(predicted, self.inputs_for_logs["rotations"])
        square = self.config["logging_img_square_size"]
        combined = build_image_matrix(generated_images, square, square)
        if self.log_writer is not None:
            self.log_writer.image("generated_images", combined, step_number)

        checkpoint_dir = os.path.join(output_dir, "checkpoints")
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.save(checkpoint_dir, str(step_number).zfill(6))

        if self._inception_metric_object is not None:
            predicted = self.generate_latents_smoothed(self.inputs_for_metrics["latents"])
            generated_images = confignet_model.generate_images(
                predicted, self.inputs_for_metrics["rotations"])
            kid, fid = self._inception_metric_object.get_metrics(generated_images)
            self.metrics.setdefault("training_step_number", []).append(step_number)
            self.metrics.setdefault("kid", []).append(float(kid))
            self.metrics.setdefault("fid", []).append(float(fid))
            if self.log_writer is not None:
                self.log_writer.scalar("metrics/kid", kid, step_number)
                self.log_writer.scalar("metrics/fid", fid, step_number)

    def sample_input_latent_vector(self, n_samples: int) -> np.ndarray:
        """Input noise from the global np.random, as the JAX package draws it."""
        if self.config["latent_distribution_type"] == "uniform":
            return np.random.uniform(-1, 1, (n_samples, self.config["latent_dim"]))
        return np.random.normal(0, 1, (n_samples, self.config["latent_dim"]))

    @torch.inference_mode()
    def generate_latents_smoothed(self, input_latents) -> np.ndarray:
        """The EMA generator's latents for the given input noise (float32),
        in chunks of ``SAMPLE_CHUNK`` rows (the last padded with zeros), each
        on the card a replay of the chunk's captured graph."""
        noise = np.asarray(input_latents, np.float32)
        out = []
        for start in range(0, noise.shape[0], SAMPLE_CHUNK):
            piece = noise[start:start + SAMPLE_CHUNK]
            chunk = np.zeros((SAMPLE_CHUNK,) + noise.shape[1:], np.float32)
            chunk[:piece.shape[0]] = piece
            latents = self._graphs.run("generate_latents", self.generator_smoothed,
                                       (torch.from_numpy(chunk),), (self.generator_smoothed,))
            out.append(latents[:piece.shape[0]].float().cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, self.config["latent_dim"]), np.float32)

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
        """Load a LatentGAN checkpoint written by either package, or a
        reference release (sniffed from the npz's keys), on ``device``."""
        npz_path = os.path.splitext(file_path)[0] + ".npz"
        if npz_is_reference_format(npz_path):
            from confignet_tpu_torch.core.reference_import import load_reference_latent_gan

            return load_reference_latent_gan(file_path, device=device)
        with open(file_path, "r") as fp:
            config = json.load(fp)
        gan = cls(config, device=device)
        gan.set_weights(load_model_weights(npz_path))
        return gan
