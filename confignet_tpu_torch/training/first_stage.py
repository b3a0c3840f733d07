"""ConfigNet first stage (counterpart of ``confignet_tpu/training/first_stage.py``).

Holds the configuration schema, the face-model input bookkeeping, the seven
parameter trees of the JAX checkpoint (``WEIGHT_TREES``), one Adam per
player and the fused stage-1 training step (:meth:`_build_train_step`), plus
the checkpoint files (:meth:`save`, :meth:`load`: the JAX package's json,
npz, distribution pickle and log), the host-side sampling helpers, the
latent-manipulation API, image generation and the fused generator ->
InceptionV3 features of FID/KID (:meth:`_metric_features_for_latents`), and
the training loop (:meth:`ConfigNetFirstStage.train`; first_stage.py:711-1031):
batches staged on the device by a prefetch thread, losses fetched a window
at a time, and checkpoints (loss tables and plots, image panels, FID/KID,
the weight files) run inline or on a worker thread from clones of the
parameters.

The step copies the JAX step's order: (a) the image-D update on hflipped
real images against ``G(z, rot)`` from the pre-step generator, computed
without gradient; (b) the synthetic-D update likewise; (c) the latent-D
update on ``z ~ prior`` against ``E_s(facemodel)``; (d) the generator
player's update (generator, latent regressor and synthetic encoder under one
Adam) against the already-updated discriminators; (e) the EMA of the
generator.  The second stage (``second_stage.py``) reuses the step and
swaps in its own image-D fakes, latent-D reals and generator losses.  Each
player's gradient is taken with ``torch.autograd.grad`` over its own
parameters only, so the G step's backward never reaches a D optimizer.
Random draws come from one ``torch.Generator`` on the model's device, seeded
from ``config["seed"]``, through three methods a caller may override
(:meth:`_sample_latent`, :meth:`_sample_rotations`, :meth:`_flip_mask`).

Over a data-parallel mesh (``train(mesh=...)``, ``parallel/mesh.py``; one
process per card) every rank holds the same parameters and its own rows of
the global batch: the host batch gathers only this rank's rows of the global
index draws, the step's draws are taken at the global batch (the seeded
generators run in lockstep) and cut to this rank's rows, and each player's
gradient is averaged over the ranks (one coalesced all-reduce) before its
Adam step, so the step is the single-device step at the global batch.
"""
from __future__ import annotations

import copy
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from confignet_tpu_torch.core import initializers
from confignet_tpu_torch.core.async_checkpoint import CheckpointWorker
from confignet_tpu_torch.core.chunks import run_chunked
from confignet_tpu_torch.core.config import merge_configs
from confignet_tpu_torch.core.constants import device_constant
from confignet_tpu_torch.core.device import resolve_device
from confignet_tpu_torch.core.graphs import GraphCache, copy_out, flatten, unflatten
from confignet_tpu_torch.core.tracing import span
from confignet_tpu_torch.core.images import batched_hflip, build_image_matrix, write_jpeg, write_png
from confignet_tpu_torch.core.logging_utils import (
    LossFlusher, TensorBoardWriter, log_loss_vals, update_loss_dict)
from confignet_tpu_torch.core.model_io import (
    export_jax_params, export_jax_tensors, load_jax_params, load_model_weights, load_weights_orbax,
    npz_is_reference_format, save_model_weights, save_weights_orbax)
from confignet_tpu_torch.core.pretrained import maybe_load
from confignet_tpu_torch.data.prefetch import BatchPrefetcher
from confignet_tpu_torch.core.pickles import read_pickle, write_pickle
from confignet_tpu_torch.losses.gan import (
    compute_discriminator_loss, compute_latent_discriminator_loss, eye_loss, gan_g_loss,
    latent_regression_loss, lead_autograd_sequence)
from confignet_tpu_torch.losses.perceptual import PerceptualLoss
from confignet_tpu_torch.models.blocks import MLP
from confignet_tpu_torch.models.discriminator import HologanDiscriminator, HologanLatentRegressor
from confignet_tpu_torch.models.generator import HologanGenerator
from confignet_tpu_torch.models.synthetic_encoder import SyntheticDataEncoder
from confignet_tpu_torch.parallel.mesh import all_reduce_mean, process_slice, replicate
from confignet_tpu_torch.runtime import gather_images, gather_rows
from confignet_tpu_torch.training.state import (
    ema_update, make_adam, optimizer_constants, optimizer_state)

# generator batches: generate_images' and the fused FID/KID path's
RENDER_CHUNK = 32
METRIC_CHUNK = 64

# The config schema: the same keys and semantics as the JAX package's
# DEFAULT_CONFIG (and the reference's, confignet_first_stage.py:24-84), so
# saved configs load unchanged.  ``facemodel_inputs`` maps each face-model
# parameter to (input_dim, latent_slice_dim).
DEFAULT_CONFIG: Dict[str, Any] = {
    "model_type": None,
    "latent_dim": 128,
    "output_shape": (128, 128, 3),
    "const_input_shape": (4, 4, 4, 512),
    "n_adain_mlp_layers": 2,
    "n_adain_mlp_units": 128,
    "gen_output_activation": "tanh",
    "n_discr_features_at_layer_0": 48,
    "max_discr_filters": 512,
    "n_discr_layers": 5,
    "discr_conv_kernel_size": 3,
    "latent_regression_weight": 10.0,
    "use_style_discriminator": True,
    "rotation_ranges": ((-30, 30), (-10, 10), (0, 0)),
    "relu_before_in": True,
    "initial_from_rgb_layer_in_discr": True,
    "adain_on_learned_input": False,
    "latent_regressor_rot_weight": 5.0,
    "optimizer": {"lr": 0.0004, "beta_1": 0.0, "beta_2": 0.9, "amsgrad": False},
    "batch_size": 24,
    "n_discriminator_updates": 1,
    "n_generator_updates": 1,
    "latent_distribution": "normal",
    "metrics_checkpoint_period": 1000,
    "image_checkpoint_period": 500,
    "facemodel_inputs": {
        "texture_embedding": (None, 30),
        "geometry_identity_params": (None, 30),
        "blendshape_values": (None, 30),
        "beard_style_embedding": (None, 7),
        "eyebrow_style_embedding": (None, 7),
        "lower_eyelash_style": (None, 2),
        "upper_eyelash_style": (None, 2),
        "head_hair_style_embedding": (None, 9),
        "eye_color": (None, 3),
        "head_hair_color": (None, 3),
        "hdri_embedding": (None, 20),
        "bone_rotations:left_eye": (None, 2),
    },
    "num_synth_encoder_layers": 2,
    "n_latent_discr_layers": 4,
    "image_loss_weight": 0.00005,
    "eye_loss_weight": 5,
    "domain_adverserial_loss_weight": 5.0,
    "pixel_loss_weight": 0.0,
    "n_generator_features": 256,
    "compute_dtype": "float32",  # "bfloat16" for throughput
    "perceptual_taps": None,
    "rotation_resample": "auto",  # inference: auto | gather | kernel (models/generator.py)
    "rotation_resample_train": "auto_train",  # train steps: auto_train | gather | kernel_train
    "adain_impl": "auto",  # auto | kernel | plain (ops/adain_cuda.py)
    "upconv_impl": "auto",  # naive | subpixel | auto (ops/upconv.py)
    "backbones_dir": None,
    "r1_heads": "all",
    "loss_print_period": 50,
    "async_checkpointing": True,
    "checkpoint_format": "npz",
    "seed": 0,
}

# each stage-1 player's parameter trees, updated by one optimizer
PLAYER_TREES: Dict[str, Tuple[str, ...]] = {
    "generator": ("generator", "latent_regressor", "synthetic_encoder"),
    "discriminator": ("discriminator",),
    "synth_discriminator": ("synth_discriminator",),
    "latent_discriminator": ("latent_discriminator",),
}

Batch = Dict[str, Any]

# the trees an image checkpoint renders, encodes and scores with
INFERENCE_TREES = ("generator_smoothed", "synthetic_encoder", "real_encoder")


def _use_async_checkpointing(config: Dict[str, Any], mesh=None) -> bool:
    """Checkpoints run on the worker thread unless the config asks for the
    reference's inline block, or the run is spread over several processes:
    then every rank takes the inline path at the same steps, as every host
    of the JAX package does."""
    return bool(config.get("async_checkpointing", True)) and (mesh is None or mesh.size == 1)

# rotation_resample values that only the JAX package knows (its TPU
# lowerings and its matmul form, confignet_tpu/models/generator.py:45-77,
# 109); a JAX config carrying one loads with the port's automatic choice
_JAX_ONLY_RESAMPLE = ("pallas", "pallas_fused", "zdecomp", "matmul")


def _port_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """A saved config with the JAX-only ``rotation_resample`` and
    ``rotation_resample_train`` values replaced by "auto" and "auto_train"."""
    config = dict(config)
    for key, auto in (("rotation_resample", "auto"), ("rotation_resample_train", "auto_train")):
        if config.get(key) in _JAX_ONLY_RESAMPLE:
            config[key] = auto
    return config


def uint8_from_unit_range(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> uint8: (x + 1) * 127.5, clipped, truncated."""
    return torch.clamp((x.float() + 1.0) * 127.5, 0.0, 255.0).to(torch.uint8)


def _stack(values: List[Any]) -> Any:
    """Stack per-sub-update host arrays (or tuples of arrays) on a new
    leading axis."""
    if isinstance(values[0], (tuple, list)):
        return tuple(np.stack(parts) for parts in zip(*values))
    return np.stack(values)


def checkpoint_chunks(model: "ConfigNetFirstStage", n_samples_for_metrics: int) -> int:
    """Generator forwards of one stage-1 checkpoint: the render panel and the
    synthetic panel in batches of RENDER_CHUNK, and the metric latents in
    batches of METRIC_CHUNK."""
    panel = model.n_checkpoint_rotations * model.n_checkpoint_samples
    return 2 * -(-panel // RENDER_CHUNK) + -(-n_samples_for_metrics // METRIC_CHUNK)


class ConfigNetFirstStage:
    MODEL_TYPE = "ConfigNetFirstStage"
    # parameter trees, under their checkpoint names (first_stage.py:1239-1250)
    WEIGHT_TREES = ("generator", "generator_smoothed", "latent_regressor", "synthetic_encoder",
                    "discriminator", "synth_discriminator", "latent_discriminator")
    # each player's trees under one Adam (a subclass adds its own)
    PLAYER_TREES = PLAYER_TREES

    def __init__(self, config: Dict[str, Any], device: Optional[Union[str, torch.device]] = None,
                 initialize: bool = True):
        self.device = resolve_device(device)
        self.config = merge_configs(DEFAULT_CONFIG, config)
        self.config["model_type"] = self.MODEL_TYPE

        # Drop inputs without a known input dim, sort alphabetically and
        # derive latent_dim as the sum of the latent slices (reference:
        # confignet_first_stage.py:114-120).
        inputs = {k: tuple(v) for k, v in self.config["facemodel_inputs"].items()
                  if v[0] is not None}
        self.config["facemodel_inputs"] = dict(sorted(inputs.items()))
        self.config["latent_dim"] = int(sum(v[1] for v in self.config["facemodel_inputs"].values()))

        # Host batch indices: a RandomState of its own, seeded from the global
        # numpy stream (as the JAX trainer's), so other np.random use cannot
        # shift the batch order.
        self._batch_rng = np.random.RandomState(np.random.randint(0, 2**31))
        self._fine_tuned_generator_params = None
        # the data-parallel mesh this model trains over (setup_training), or None
        self.mesh = None
        self.g_losses: Dict[str, List[float]] = {}
        self.d_losses: Dict[str, List[float]] = {}
        self.synth_d_losses: Dict[str, List[float]] = {}
        self.latent_d_losses: Dict[str, List[float]] = {}
        self.metrics: Dict[str, List] = {}
        self.facemodel_param_distributions = None
        # an InceptionMetrics for FID/KID, set by setup_training (or whoever
        # scores the model)
        self._inception_metric_object = None

        self.n_checkpoint_rotations = 6
        self.n_checkpoint_samples = 10
        # checkpoint blocks dispatched (inline or to the worker)
        self.checkpoint_events_run = 0
        self.log_writer: Optional[TensorBoardWriter] = None
        self.aml_sink: Optional[Callable[[str, float], None]] = None  # callable(name, value)
        self._checkpoint_visualization_input: Optional[Dict[str, Any]] = None
        self._generator_input_for_metrics: Optional[Dict[str, Any]] = None
        self._train_step_fn = None
        # async checkpoints: the worker thread, the inference modules it
        # renders with (built once, refilled from each snapshot) and, while a
        # job runs, those modules in place of the live ones
        self._checkpoint_worker: Optional[CheckpointWorker] = None
        self._snapshot_modules: Optional[Dict[str, torch.nn.Module]] = None
        self._inference_params_override: Optional[Dict[str, torch.nn.Module]] = None
        # the captured graphs of the inference paths and the fine-tune (on
        # the card), and those of the snapshot modules, which go with them
        self._graphs = GraphCache(self.device)
        self._snapshot_graphs: Optional[GraphCache] = None
        self._build_modules()
        if initialize:
            self.initialize_network()
        self._to_device()
        self._draws = torch.Generator(device=self.device).manual_seed(int(self.config.get("seed", 0)))
        self._make_optimizers()

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.config.get("compute_dtype") == "bfloat16" else None

    @property
    def _fine_tuned_generator_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The fine-tuned generator's state_dict, or None to render with the
        EMA generator.  Setting it builds, once, the inference generator that
        carries those weights (:meth:`_inference_generator`)."""
        return self._fine_tuned_state

    @_fine_tuned_generator_params.setter
    def _fine_tuned_generator_params(self, state: Optional[Dict[str, torch.Tensor]]) -> None:
        self._fine_tuned_state = state
        self._fine_tuned_generator = None
        if state is not None:
            generator = copy.deepcopy(self.generator_smoothed)
            generator.load_state_dict(state)
            self._fine_tuned_generator = generator

    @property
    def facemodel_inputs_tuple(self) -> Tuple:
        return tuple((name, tuple(dims)) for name, dims in self.config["facemodel_inputs"].items())

    @property
    def facemodel_input_dim(self) -> int:
        """Total face-model input dims (reference: confignet_first_stage.py:209-215)."""
        return int(sum(v[0] for v in self.config["facemodel_inputs"].values()))

    # ------------------------------------------------------------------
    # Modules, parameters, optimizers
    # ------------------------------------------------------------------

    def _generator(self, rotation_resample: str) -> HologanGenerator:
        cfg = self.config
        return HologanGenerator(
            latent_dim=cfg["latent_dim"], output_shape=tuple(cfg["output_shape"][:2]),
            n_adain_mlp_units=cfg["n_adain_mlp_units"],
            n_adain_mlp_layers=cfg["n_adain_mlp_layers"],
            gen_output_activation=cfg["gen_output_activation"],
            const_shape=tuple(cfg["const_input_shape"]),
            n_features_first=cfg.get("n_generator_features", 256), dtype=self.compute_dtype,
            rotation_resample=rotation_resample,
            upconv_impl=cfg.get("upconv_impl", "auto"), adain_impl=cfg.get("adain_impl", "auto"))

    def _build_modules(self) -> None:
        cfg = self.config
        # The training generator resamples with a zero transform gradient
        # (train steps never optimise rotations); the EMA generator renders.
        self.generator = self._generator(cfg.get("rotation_resample_train", "auto_train"))
        self.generator_smoothed = self._generator(cfg.get("rotation_resample", "auto"))
        self.synthetic_encoder = SyntheticDataEncoder(
            self.facemodel_inputs_tuple, num_layers=cfg["num_synth_encoder_layers"],
            dtype=self.compute_dtype)
        discriminator_kwargs = dict(
            img_shape=tuple(cfg["output_shape"][:2]), num_resample=cfg["n_discr_layers"],
            disc_kernel_size=cfg["discr_conv_kernel_size"],
            disc_expansion_factor=cfg["n_discr_features_at_layer_0"],
            disc_max_feature_maps=cfg["max_discr_filters"],
            initial_from_rgb_layer_in_discr=cfg["initial_from_rgb_layer_in_discr"],
            dtype=self.compute_dtype)
        self.discriminator = HologanDiscriminator(**discriminator_kwargs)
        self.synth_discriminator = HologanDiscriminator(**discriminator_kwargs)
        self.latent_regressor = HologanLatentRegressor(latent_dim=cfg["latent_dim"],
                                                       **discriminator_kwargs)
        self.latent_discriminator = MLP(cfg["n_latent_discr_layers"], cfg["latent_dim"],
                                        cfg["latent_dim"], 1, dtype=self.compute_dtype)
        self.perceptual_loss = PerceptualLoss("imagenet", taps=cfg.get("perceptual_taps"))
        maybe_load(self.perceptual_loss.load_keras_weights, cfg.get("backbones_dir"), "vgg19")

    def initialize_network(self) -> None:
        """Seeded init on the CPU (the same weights on every device); the EMA
        generator starts as a copy of the generator."""
        rng = torch.Generator().manual_seed(int(self.config.get("seed", 0)))
        for name in ("generator", "synthetic_encoder", "discriminator", "synth_discriminator",
                     "latent_discriminator", "latent_regressor"):
            initializers.initialize(getattr(self, name), rng)
        self.generator_smoothed.load_state_dict(self.generator.state_dict())

    def _to_device(self) -> None:
        for name in self.WEIGHT_TREES:
            getattr(self, name).to(self.device).eval()
        self.perceptual_loss.to(self.device)
        self.generator_smoothed.requires_grad_(False)

    def _make_optimizers(self) -> None:
        """A fresh Adam per player (``set_weights`` resets them, as the JAX
        package resets its optimizer states)."""
        self._player_params = {
            player: [p for tree in trees for p in getattr(self, tree).parameters()]
            for player, trees in self.PLAYER_TREES.items()}
        self.optimizers = {player: make_adam(params, self.config["optimizer"])
                           for player, params in self._player_params.items()}

    # ------------------------------------------------------------------
    # Weights in the JAX package's checkpoint format
    # ------------------------------------------------------------------

    def get_weights(self) -> Dict[str, Dict[str, np.ndarray]]:
        """{tree: {pytree path: ndarray}} for every tree in ``WEIGHT_TREES``."""
        return {name: export_jax_params(getattr(self, name)) for name in self.WEIGHT_TREES}

    def set_weights(self, weights: Dict[str, Dict[str, np.ndarray]]) -> None:
        """Load {tree: {pytree path: ndarray}}; every tree in ``WEIGHT_TREES``
        must be present.  The optimizer states are reset."""
        for name in self.WEIGHT_TREES:
            if name not in weights:
                raise KeyError(f"weights have no {name!r} tree")
            load_jax_params(getattr(self, name), weights[name])
        self._make_optimizers()

    def first_moments(self) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
        """{player: {tree: {pytree path: ndarray}}}: each optimizer's Adam
        first moment in the checkpoint layout (zeros before its first step).
        With ``beta_1 = 0`` it is the gradient of the player's last update."""
        moments = {}
        for player, trees in self.PLAYER_TREES.items():
            state = self.optimizers[player].state
            moments[player] = {
                tree: export_jax_tensors(
                    (name, state[p]["exp_avg"] if p in state else torch.zeros_like(p))
                    for name, p in getattr(self, tree).named_parameters())
                for tree in trees}
        return moments

    # ------------------------------------------------------------------
    # Log state and checkpoint files (first_stage.py:685-709, 1275-1359)
    # ------------------------------------------------------------------

    def get_training_step_number(self) -> int:
        return 0 if "loss_sum" not in self.g_losses else len(self.g_losses["loss_sum"]) - 1

    def get_resume_step(self) -> int:
        """The first step a resumed run takes: the count of completed steps
        in the loss history."""
        return 0 if "loss_sum" not in self.g_losses else len(self.g_losses["loss_sum"])

    def get_batch_size(self) -> int:
        return self.config["batch_size"]

    def get_log_dict(self) -> Dict[str, Any]:
        return {"g_losses": self.g_losses, "d_losses": self.d_losses, "metrics": self.metrics}

    def set_logs(self, log_dict: Dict[str, Any]) -> None:
        self.g_losses = log_dict["g_losses"]
        self.d_losses = log_dict["d_losses"]
        self.metrics = log_dict["metrics"]

    def save(self, output_dir: str, output_filename: str) -> None:
        """Write ``<output_filename>.json``, ``.npz``,
        ``_facemodel_distr.pck`` and ``_log.json`` under ``output_dir``, as
        the JAX package writes them."""
        self._write_checkpoint_files(self.get_weights(), self.get_log_dict(), output_dir,
                                     output_filename)

    def _write_checkpoint_files(self, weights: Dict[str, Any], log_dict: Dict[str, Any],
                                output_dir: str, output_filename: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        stem = os.path.join(output_dir, output_filename)
        if self.config.get("checkpoint_format", "npz") == "orbax":
            save_weights_orbax(weights, stem + ".orbax")
        save_model_weights(weights, output_dir, output_filename)
        with open(stem + ".json", "w") as fp:
            json.dump(self._json_safe_config(), fp, indent=4)
        write_pickle(self.facemodel_param_distributions, stem + "_facemodel_distr.pck")
        with open(stem + "_log.json", "w") as fp:
            json.dump(log_dict, fp)

    def _json_safe_config(self) -> Dict[str, Any]:
        def sanitize(obj):
            if isinstance(obj, dict):
                return {k: sanitize(v) for k, v in obj.items()}
            if isinstance(obj, (tuple, list)):
                return [sanitize(v) for v in obj]
            if isinstance(obj, np.integer):
                return int(obj)
            if isinstance(obj, np.floating):
                return float(obj)
            return obj

        return sanitize(self.config)

    @classmethod
    def load(cls, file_path: str, device: Optional[Union[str, torch.device]] = None):
        """Load a checkpoint written by either package, or a reference
        release (Keras weight lists, sniffed from the npz's keys and read by
        ``core/reference_import``; its ``model_type`` picks the class), from
        the json's path on ``device``, with its log and distributions where
        present.  An orbax directory raises NotImplementedError."""
        stem = os.path.splitext(file_path)[0]
        if not os.path.exists(stem + ".npz") and os.path.isdir(stem + ".orbax"):
            load_weights_orbax(stem + ".orbax")
        if npz_is_reference_format(stem + ".npz"):
            from confignet_tpu_torch.core.reference_import import load_reference_confignet

            model = load_reference_confignet(file_path, device=device)
        else:
            with open(file_path, "r") as fp:
                config = json.load(fp)
            model = cls(_port_config(config), device=device, initialize=False)
            model.set_weights(load_model_weights(stem + ".npz"))

        if os.path.exists(stem + "_log.json"):
            with open(stem + "_log.json", "r") as fp:
                model.set_logs(json.load(fp))
        if os.path.exists(stem + "_facemodel_distr.pck"):
            model.facemodel_param_distributions = read_pickle(stem + "_facemodel_distr.pck")
        else:
            print("WARNING: facemodel param distributions not loaded")
        return model

    # ------------------------------------------------------------------
    # Random draws of the step (override to pin them)
    # ------------------------------------------------------------------

    def _sample_latent(self, n: int) -> torch.Tensor:
        shape = (n, self.config["latent_dim"])
        if self.config["latent_distribution"] == "uniform":
            return torch.rand(shape, generator=self._draws, device=self.device) * 2 - 1
        return torch.randn(shape, generator=self._draws, device=self.device)

    def _sample_rotations(self, n: int) -> torch.Tensor:
        """Uniform in the configured ranges, in radians."""
        degrees = tuple(tuple(r) for r in self.config["rotation_ranges"])
        ranges = device_constant(("rotation_ranges", degrees),
                                 lambda: np.asarray(degrees, np.float32) * np.pi / 180.0,
                                 torch.float32, self.device)
        u = torch.rand((n, 3), generator=self._draws, device=self.device)
        return ranges[:, 0] + u * (ranges[:, 1] - ranges[:, 0])

    def _flip_mask(self, n: int) -> torch.Tensor:
        """Bernoulli(0.5) per image: which real images are hflipped."""
        return torch.rand((n,), generator=self._draws, device=self.device) < 0.5

    def _draw(self, draw: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
        """``draw`` (one of the three above) for ``n`` rows of this rank: over
        a mesh the draw is taken at the global batch, ``n`` rows a rank, and
        cut to this rank's rows, so the ranks together draw what one device
        draws at the global batch."""
        size = 1 if self.mesh is None else self.mesh.size
        return draw(n * size)[process_slice(n * size, self.mesh)]

    @staticmethod
    def _to_unit_range(u8: torch.Tensor) -> torch.Tensor:
        return u8.float() / 127.5 - 1.0

    # ------------------------------------------------------------------
    # The fused train step
    # ------------------------------------------------------------------

    def _update(self, player: str, loss: torch.Tensor) -> None:
        """One Adam step of ``player`` on the gradient of ``loss`` with
        respect to its own parameters (zero for a parameter loss ignores,
        as the JAX step's)."""
        params = self._player_params[player]
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        # over a mesh: the mean of the ranks' gradients, the global batch's
        all_reduce_mean(self.mesh, grads)
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizers[player].step()
        for p in params:
            p.grad = None

    def _image_d_fakes(self, b: Batch, batch_size: int) -> torch.Tensor:
        """The image discriminator's fakes, without gradient: G(z, rot) of
        the pre-step generator, z and rot from the prior."""
        z = self._draw(self._sample_latent, batch_size)
        rot = self._draw(self._sample_rotations, batch_size)
        with torch.no_grad():
            return self.generator(z, rot)

    def _latent_d_reals(self, b: Batch, batch_size: int) -> torch.Tensor:
        """The latent discriminator's real side: z ~ prior."""
        return self._draw(self._sample_latent, batch_size)

    def _generator_losses(self, gb: Batch, batch_size: int) -> Dict[str, torch.Tensor]:
        """The generator player's losses (first_stage.py:401-435): prior
        draws for the real-set half of the batch."""
        n_real = batch_size - gb["g_gt_imgs"].shape[0]
        z_real = self._draw(self._sample_latent, n_real)
        rot_real = self._draw(self._sample_rotations, n_real)
        cfg = self.config
        losses: Dict[str, torch.Tensor] = {}
        synth_latents = self.synthetic_encoder(gb["g_facemodel"])
        out_synth = self.generator(synth_latents, gb["g_rotations"])
        out_real = self.generator(z_real, rot_real)

        gt = self._to_unit_range(gb["g_gt_imgs"])
        losses["image_loss"] = cfg["image_loss_weight"] * self.perceptual_loss.loss_fn(gt, out_synth)
        if cfg.get("pixel_loss_weight", 0.0) > 0.0:
            losses["pixel_loss"] = cfg["pixel_loss_weight"] * (gt - out_synth).abs().mean()
        losses["eye_loss"] = cfg["eye_loss_weight"] * eye_loss(gt, out_synth, gb["g_eye_masks"])

        for i, head in enumerate(self.synth_discriminator(out_synth).values()):
            losses[f"GAN_loss_synth_{i}"] = gan_g_loss(head)
        for i, head in enumerate(self.discriminator(out_real).values()):
            losses[f"GAN_loss_real_{i}"] = gan_g_loss(head)
        losses["latent_GAN_loss"] = cfg["domain_adverserial_loss_weight"] * gan_g_loss(
            self.latent_discriminator(synth_latents))

        stacked_latents = torch.cat([synth_latents, z_real], dim=0)
        stacked_outputs = torch.cat([out_synth, out_real], dim=0)
        stacked_rotations = torch.cat([gb["g_rotations"], rot_real], dim=0)
        labels = torch.cat([stacked_latents,
                            cfg["latent_regressor_rot_weight"] * stacked_rotations], dim=-1)
        losses["latent_regression_loss"] = cfg["latent_regression_weight"] * latent_regression_loss(
            self.latent_regressor(stacked_outputs), labels)
        losses["loss_sum"] = sum(losses.values())
        return losses

    def _build_train_step(self) -> Callable[[Batch], Dict[str, Dict[str, torch.Tensor]]]:
        """``step(host_batch) -> {"d", "g", "latent_d", "synth_d"}`` loss
        dicts (detached 0-d tensors on the device, keys sorted, the step's
        own).  Updates the parameters, the optimizers and the EMA generator
        in place.  A stage supplies the image-D fakes, the latent-D reals
        and the generator player's losses (:meth:`_image_d_fakes`,
        :meth:`_latent_d_reals`, :meth:`_generator_losses`).

        On the card the step is a CUDA graph, as the JAX step is one jitted
        program: ``step.graphs``, a cache of this step's own, runs the first
        call of a batch layout eagerly (which builds Adam's state and
        cuDNN's plans), captures the second and replays it from then on,
        with the model's draw generator registered so each replay draws
        afresh; the loss dicts are copied out of the graph's buffers before
        the step returns.  A step over a mesh runs eagerly: its gradient
        all-reduce (gloo or NCCL) is not captured."""
        if self.device.type == "cuda":
            lead_autograd_sequence()
        r1_heads = self.config.get("r1_heads", "all")
        n_d_updates, n_g_updates, multi, sub_batch = self._sub_update_plan()
        graphs = GraphCache(self.device)

        def update(batch: Batch) -> Dict[str, Dict[str, torch.Tensor]]:
            batch_size = batch["d_real_imgs"].shape[1 if multi else 0]

            for u in range(n_d_updates):
                b = sub_batch(batch, u, g_fields=False)

                # (a) image discriminator: real set vs fakes of the pre-step G
                real_imgs = batched_hflip(self._to_unit_range(b["d_real_imgs"]),
                                          self._draw(self._flip_mask, batch_size))
                fake_imgs = self._image_d_fakes(b, batch_size)
                d_losses = compute_discriminator_loss(self.discriminator, real_imgs, fake_imgs,
                                                      r1_heads=r1_heads)
                self._update("discriminator", d_losses["loss_sum"])

                # (b) synthetic discriminator: synth set vs G(E_s(params))
                synth_real = batched_hflip(self._to_unit_range(b["synth_d_real_imgs"]),
                                           self._draw(self._flip_mask, batch_size))
                with torch.no_grad():
                    synth_latents = self.synthetic_encoder(b["synth_d_facemodel"])
                    synth_fake = self.generator(synth_latents, b["synth_d_rotations"])
                synth_d_losses = compute_discriminator_loss(
                    self.synth_discriminator, synth_real, synth_fake, r1_heads=r1_heads)
                self._update("synth_discriminator", synth_d_losses["loss_sum"])

                # (c) latent discriminator: real latents vs E_s(params)
                real_latents = self._latent_d_reals(b, batch_size)
                with torch.no_grad():
                    fake_latents = self.synthetic_encoder(b["latent_d_facemodel"])
                latent_d_losses = compute_latent_discriminator_loss(
                    self.latent_discriminator, real_latents, fake_latents)
                self._update("latent_discriminator", latent_d_losses["loss_sum"])

            # (d) the generator player, against the updated discriminators
            for u in range(n_g_updates):
                g_losses = self._generator_losses(sub_batch(batch, u, g_fields=True), batch_size)
                self._update("generator", g_losses["loss_sum"])

            # (e) EMA
            ema_update(self.generator_smoothed, self.generator)
            # keys sorted, as the JAX step's jit returns its dicts, so the
            # loss tables' columns come in the same order
            return {name: {k: v.detach() for k, v in sorted(losses.items())}
                    for name, losses in (("d", d_losses), ("g", g_losses),
                                         ("latent_d", latent_d_losses),
                                         ("synth_d", synth_d_losses))}

        def step(host_batch: Batch) -> Dict[str, Dict[str, torch.Tensor]]:
            batch = self._batch_to_device(host_batch)
            if self.mesh is not None:
                return update(batch)
            leaves, structure = flatten(batch)
            losses = graphs.run_step(
                self._train_step_name(structure, r1_heads),
                lambda *tensors: update(unflatten(structure, tensors)), leaves,
                self._train_step_modules(), lambda: optimizer_state(self.optimizers),
                (self._draws,))
            return copy_out(losses)

        step.graphs = graphs
        return step

    def _train_step_name(self, structure: tuple, r1_heads: str) -> tuple:
        """The train step's name in its graph cache: the batch's structure
        (:func:`graphs.flatten`), the R1 heads, the sub-update plan, the
        compute dtype and the optimizers' hyperparameters (the capture
        holds them as constants)."""
        return ("train_step", structure, r1_heads, self._n_player_updates(),
                self.config.get("compute_dtype"), optimizer_constants(self.optimizers))

    def _train_step_modules(self) -> List[torch.nn.Module]:
        """Every module a train step reads: the weight trees and the
        perceptual loss's network."""
        return [getattr(self, tree) for tree in self.WEIGHT_TREES] + [self.perceptual_loss]

    # ------------------------------------------------------------------
    # Host-side batch assembly
    # ------------------------------------------------------------------

    def _facemodel_batch(self, dataset, idxs) -> Tuple[np.ndarray, ...]:
        return tuple(np.ascontiguousarray(dataset.metadata_inputs[name][idxs], dtype=np.float32)
                     for name in self.config["facemodel_inputs"].keys())

    def _n_player_updates(self) -> Tuple[int, int]:
        return (int(self.config.get("n_discriminator_updates", 1)),
                int(self.config.get("n_generator_updates", 1)))

    def _sub_update_plan(self):
        """``(n_d, n_g, multi, sub_batch)``.  With n_*_updates > 1 the host
        stacks a fresh batch per sub-update along a leading axis (each
        sub-step of the reference resamples its own batch,
        confignet_first_stage.py:604-612); ``sub_batch(batch, u, g_fields)``
        picks one player's field group for sub-update ``u``."""
        n_d, n_g = self._n_player_updates()
        multi = n_d > 1 or n_g > 1

        def sub_batch(batch: Batch, u: int, g_fields: bool) -> Batch:
            picked = {k: v for k, v in batch.items() if k.startswith("g_") == g_fields}
            if not multi:
                return picked
            return {k: [x[u] for x in v] if isinstance(v, list) else v[u]
                    for k, v in picked.items()}

        return n_d, n_g, multi, sub_batch

    def _batch_to_device(self, batch: Batch) -> Batch:
        """Host arrays (and tuples of them) -> tensors (lists) on the device;
        tensors already there (a prefetched batch) pass through."""
        def put(value):
            if isinstance(value, (tuple, list)):
                return [put(v) for v in value]
            if isinstance(value, torch.Tensor):
                return value.to(self.device)
            return torch.from_numpy(np.ascontiguousarray(value)).to(self.device)

        return {k: put(v) for k, v in batch.items()}

    def _sample_host_batch(self, real_training_set, synth_training_set) -> Batch:
        """The host batch: one draw, or with ``n_discriminator_updates`` /
        ``n_generator_updates`` > 1 a fresh draw per sub-update stacked on a
        leading axis (D fields carry n_d entries, G fields n_g)."""
        n_d, n_g = self._n_player_updates()
        if n_d == 1 and n_g == 1:
            return self._sample_host_batch_single(real_training_set, synth_training_set)
        draws = [self._sample_host_batch_single(real_training_set, synth_training_set,
                                                d_fields=u < n_d, g_fields=u < n_g)
                 for u in range(max(n_d, n_g))]
        return {k: _stack([d[k] for d in draws[:(n_g if k.startswith("g_") else n_d)]])
                for k in draws[0]}

    def _sample_host_batch_single(self, real_training_set, synth_training_set,
                                  d_fields: bool = True, g_fields: bool = True) -> Batch:
        """One host batch, drawn from ``self._batch_rng`` in the JAX package's
        order (first_stage.py:633-681).  Over a mesh every rank draws the same
        global index arrays and gathers only its own rows of them."""
        rng = self._batch_rng
        batch_size = self.config["batch_size"]
        n_synth = batch_size // 2
        n_synth_imgs = synth_training_set.imgs.shape[0]
        rotations = synth_training_set.metadata_inputs["rotations"]
        batch: Batch = {}
        if d_fields:
            rows = process_slice(batch_size, self.mesh)
            d_idx = rng.randint(0, real_training_set.imgs.shape[0], batch_size)[rows]
            sd_idx = rng.randint(0, n_synth_imgs, batch_size)[rows]
            sd_fm_idx = rng.randint(0, n_synth_imgs, batch_size)[rows]
            ld_fm_idx = rng.randint(0, n_synth_imgs, batch_size)[rows]
            batch.update({
                "d_real_imgs": gather_images(real_training_set.imgs, d_idx),
                "synth_d_real_imgs": gather_images(synth_training_set.imgs, sd_idx),
                "synth_d_facemodel": self._facemodel_batch(synth_training_set, sd_fm_idx),
                "synth_d_rotations": np.ascontiguousarray(rotations[sd_fm_idx], dtype=np.float32),
                "latent_d_facemodel": self._facemodel_batch(synth_training_set, ld_fm_idx),
            })
        if g_fields:
            g_idx = rng.randint(0, n_synth_imgs, n_synth)[process_slice(n_synth, self.mesh)]
            batch.update({
                "g_facemodel": self._facemodel_batch(synth_training_set, g_idx),
                "g_rotations": np.ascontiguousarray(rotations[g_idx], dtype=np.float32),
                "g_gt_imgs": gather_images(synth_training_set.imgs, g_idx),
                "g_eye_masks": gather_rows(np.asarray(synth_training_set.eye_masks), g_idx),
            })
        return batch

    # ------------------------------------------------------------------
    # The training loop (first_stage.py:711-861)
    # ------------------------------------------------------------------

    def setup_training(self, log_dir, synth_training_set, n_samples_for_metrics,
                       real_training_set=None, mesh=None) -> None:
        """The TensorBoard writer, the FID/KID harness and the fixed inputs
        of the metrics and the checkpoint panels, drawn from the global
        ``np.random`` in the JAX package's order: the metric sample's
        indexes, the metric latents and rotations, the panel latents, then
        the panel's face-model indexes.  Over a ``mesh`` (see
        :meth:`_use_mesh`) every rank sets up alike, and only rank 0 makes
        the log directory and its writer."""
        if real_training_set is None:
            real_training_set = synth_training_set
        self._use_mesh(mesh)
        if self._writes_files():
            os.makedirs(log_dir, exist_ok=True)
            self.log_writer = TensorBoardWriter(log_dir)

        try:
            from confignet_tpu_torch.metrics.inception import InceptionMetrics

            self._inception_metric_object = InceptionMetrics(
                self.config, real_training_set, n_samples_for_metrics=n_samples_for_metrics,
                device=self.device)
        except Exception as exc:  # the JAX trainer trains on without metrics too
            print(f"WARNING: inception metrics disabled ({exc})")
            self._inception_metric_object = None

        self._generator_input_for_metrics = {
            "latent": self.sample_latent_vector(n_samples_for_metrics),
            "rotation": self.sample_rotations(n_samples_for_metrics),
        }
        checkpoint_latent = self.sample_latent_vector(self.n_checkpoint_samples)
        checkpoint_latent = np.vstack([checkpoint_latent] * self.n_checkpoint_rotations)
        ranges = np.asarray(self.config["rotation_ranges"], np.float32)
        yaw = np.pi * np.linspace(ranges[0][0], ranges[0][1], self.n_checkpoint_rotations) / 180
        checkpoint_rotation = np.zeros((self.n_checkpoint_rotations, 3), np.float32)
        checkpoint_rotation[:, 0] = yaw
        checkpoint_rotation = np.repeat(checkpoint_rotation, self.n_checkpoint_samples, axis=0)
        self._checkpoint_visualization_input = {"latent": checkpoint_latent,
                                                "rotation": checkpoint_rotation}

        self.facemodel_param_distributions = synth_training_set.metadata_input_distributions
        viz_idx = np.random.randint(0, synth_training_set.imgs.shape[0], self.n_checkpoint_samples)
        self._checkpoint_visualization_input["facemodel_params"] = [
            np.tile(p, (self.n_checkpoint_rotations, 1))
            for p in self._facemodel_batch(synth_training_set, viz_idx)]
        self._checkpoint_visualization_input["gt_imgs"] = np.copy(
            synth_training_set.imgs[viz_idx]).astype(np.float32)

    def _use_mesh(self, mesh) -> None:
        """Train over ``mesh`` (``parallel/mesh.py``), or on this device alone
        with None.  The batch must shard evenly (its generator half too), the
        model must live on the mesh's device, and every rank takes rank 0's
        parameter trees and Adam moments (with ``amsgrad``, the running
        maximum too)."""
        self.mesh = mesh
        if mesh is None:
            return
        if self.config["batch_size"] % (2 * mesh.size) != 0:
            raise ValueError(
                "batch_size must be divisible by 2 * mesh size so the G-step "
                f"half-batch shards evenly; got batch_size={self.config['batch_size']} "
                f"over {mesh.size} devices")
        self._check_mesh_device(mesh)
        for tree in self.WEIGHT_TREES:
            replicate(mesh, getattr(self, tree))
        replicate(mesh, [state[key] for optimizer in self.optimizers.values()
                         for state in optimizer.state.values()
                         for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")
                         if key in state])

    def _check_mesh_device(self, mesh) -> None:
        # an empty tensor resolves "cuda" to the current card's index
        if torch.empty(0, device=self.device).device != torch.empty(0, device=mesh.device).device:
            raise ValueError(f"the model lives on {self.device}, the mesh on {mesh.device}")

    def _writes_files(self) -> bool:
        """Whether this process writes the run's files, logs and sinks: rank
        0 of a mesh, or the only process."""
        return self.mesh is None or self.mesh.rank == 0

    def train(self, real_training_set, synth_training_set, output_dir, log_dir,
              n_steps=100000, n_samples_for_metrics=1000, aml_run=None,
              mesh=None) -> Dict[str, float]:
        """Train from :meth:`get_resume_step` to ``n_steps``; returns
        ``{"loop_seconds", "steps_run"}``, the loop's wall time (the last
        checkpoint's drain included) and its steps.  ``aml_run``: anything
        with ``log(name, value)``, which then receives the latest losses,
        metrics and timings in place of the loss plots.  ``mesh``: a
        data-parallel mesh (``parallel.create_mesh()``), one process per
        card, each calling ``train`` alike; the losses logged are the global
        batch's, and only rank 0 writes files."""
        self.setup_training(log_dir, synth_training_set, n_samples_for_metrics,
                            real_training_set=real_training_set, mesh=mesh)
        return self._run_training(real_training_set, synth_training_set, output_dir, n_steps,
                                  aml_run)

    def _run_training(self, real_training_set, synth_training_set, output_dir, n_steps,
                      aml_run) -> Dict[str, float]:
        if aml_run is not None and self._writes_files():
            self.aml_sink = lambda name, value: aml_run.log(name, value)
        start_step = self.get_resume_step()
        if self._train_step_fn is None:
            self._train_step_fn = self._build_train_step()

        # No per-step device -> host fetch: the losses are fetched a window
        # at a time, and the host batches are drawn and sent to the device on
        # a background thread while the current step runs.
        prefetcher = BatchPrefetcher(
            lambda: self._sample_host_batch(real_training_set, synth_training_set),
            depth=self.config.get("prefetch_depth", 2), device=self.device)
        if _use_async_checkpointing(self.config, self.mesh):
            self._checkpoint_worker = CheckpointWorker()
        loop_start = time.perf_counter()
        try:
            self._train_loop(prefetcher, start_step, n_steps, output_dir)
        finally:
            prefetcher.close()
            # the step goes with the loop, and its graphs' memory (on the
            # card a step's activations) with it; a later train() builds anew
            self._train_step_fn = None
            if self._checkpoint_worker is not None:
                worker, self._checkpoint_worker = self._checkpoint_worker, None
                worker.close()  # runs the pending jobs, re-raises a failure
        # a resumed model whose history already reaches n_steps runs no step
        return {"loop_seconds": time.perf_counter() - loop_start,
                "steps_run": max(0, n_steps - start_step)}

    def _train_loop(self, prefetcher, start_step, n_steps, output_dir) -> None:
        flusher = LossFlusher(self.config.get("loss_print_period", 50), mesh=self.mesh)
        image_p = self.config["image_checkpoint_period"]
        metrics_p = self.config["metrics_checkpoint_period"]
        window_start, window_len = time.perf_counter(), 0
        for step in range(start_step, n_steps):
            losses = self._train_step_fn(prefetcher.next())
            window_len += 1

            flush_due = flusher.append(losses)
            at_checkpoint = step % image_p == 0 or step % metrics_p == 0
            if not (flush_due or at_checkpoint or step == n_steps - 1):
                continue

            for fetched in flusher.flush():
                update_loss_dict(self.g_losses, fetched["g"])
                update_loss_dict(self.d_losses, fetched["d"])
                update_loss_dict(self.synth_d_losses, fetched["synth_d"])
                update_loss_dict(self.latent_d_losses, fetched["latent_d"])
            # the flush waited for the device, so this is a true time per step
            # averaged over the window
            iter_time = (time.perf_counter() - window_start) / max(window_len, 1)
            window_start = time.perf_counter()
            window_len = 0
            print("[step %d] [D loss: %f] [synth_D loss: %f] [latent_D_loss: %f] [G loss: %f]"
                  % (step, self.d_losses["loss_sum"][-1], self.synth_d_losses["loss_sum"][-1],
                     self.latent_d_losses["loss_sum"][-1], self.g_losses["loss_sum"][-1]))
            if at_checkpoint:
                self.run_checkpoints(output_dir, iter_time)

    # ------------------------------------------------------------------
    # Checkpoints and metrics (first_stage.py:863-1031)
    # ------------------------------------------------------------------

    def run_checkpoints(self, output_dir: str, iteration_time: float) -> None:
        """The checkpoint block: inline (the reference's order,
        confignet_first_stage.py:616-626) or, with ``async_checkpointing``,
        on the worker thread from clones of the parameters taken here,
        before the next step updates them in place.  Over a mesh of several
        processes every rank runs the block inline at the same steps, as
        every host of the JAX package does, so no rank waits in a collective
        while another scores; only rank 0 writes (the others pass no
        ``output_dir`` down)."""
        step_number = self.get_training_step_number()
        image_due = step_number % self.config["image_checkpoint_period"] == 0
        metrics_due = step_number % self.config["metrics_checkpoint_period"] == 0
        if not (image_due or metrics_due):
            return
        self.checkpoint_events_run += 1

        if self._checkpoint_worker is None:
            writes = self._writes_files()
            losses = {"g": self.g_losses, "d": self.d_losses,
                      "synth_d": self.synth_d_losses, "latent_d": self.latent_d_losses}
            self._run_checkpoints_body(output_dir if writes else None, iteration_time, step_number,
                                       image_due, metrics_due, losses,
                                       self.get_weights() if metrics_due and writes else None)
            return

        # Clones on the device, queued on the current stream ahead of the next
        # step's in-place updates.  An image-only checkpoint clones the
        # inference trees; a save clones every tree.
        inference_trees = [tree for tree in INFERENCE_TREES if tree in self.WEIGHT_TREES]
        with torch.no_grad():
            snapshot = {tree: {name: tensor.clone()
                               for name, tensor in getattr(self, tree).state_dict().items()}
                        for tree in (self.WEIGHT_TREES if metrics_due else inference_trees)}
        if self._snapshot_modules is None:
            # built once and refilled in place from each snapshot, so their
            # graphs serve every checkpoint of the run
            self._snapshot_modules = {
                tree: copy.deepcopy(getattr(self, tree)).requires_grad_(False).eval()
                for tree in inference_trees}
            self._snapshot_graphs = GraphCache(self.device)
        # the loss histories are lists the main thread keeps appending to
        losses = {group: {k: list(v) for k, v in history.items()}
                  for group, history in (("g", self.g_losses), ("d", self.d_losses),
                                         ("synth_d", self.synth_d_losses),
                                         ("latent_d", self.latent_d_losses))}

        def job():
            modules = self._snapshot_modules
            for tree, module in modules.items():
                module.load_state_dict(snapshot[tree])
            weights = None
            if metrics_due:
                weights = {tree: export_jax_tensors(
                    (name, snapshot[tree][name]) for name, _ in getattr(self, tree).named_parameters())
                    for tree in self.WEIGHT_TREES}
            self._inference_params_override = modules
            try:
                self._run_checkpoints_body(output_dir, iteration_time, step_number, image_due,
                                           metrics_due, losses, weights)
            finally:
                self._inference_params_override = None

        self._checkpoint_worker.submit(job)

    def _run_checkpoints_body(self, output_dir: Optional[str], iteration_time: float,
                              step_number: int, image_due: bool, metrics_due: bool,
                              losses: Dict[str, Dict],
                              weights: Optional[Dict[str, Dict[str, np.ndarray]]]) -> None:
        """Score, render and write one checkpoint; with ``output_dir`` None
        (a rank that does not write) it scores and renders, and writes
        nothing."""
        checkpoint_start = time.perf_counter()
        if image_due and output_dir is not None:
            log_loss_vals(losses["synth_d"], output_dir, step_number, "synth_discriminator_",
                          self.log_writer, self.aml_sink)
            log_loss_vals(losses["latent_d"], output_dir, step_number, "latent_discriminator_",
                          self.log_writer, self.aml_sink)

        if metrics_due:
            self.calculate_metrics(output_dir, step_number=step_number)
            if output_dir is not None:
                log_dict = {"g_losses": losses["g"], "d_losses": losses["d"],
                            "metrics": self.metrics}
                self._write_checkpoint_files(weights, log_dict,
                                             os.path.join(output_dir, "checkpoints"),
                                             str(step_number).zfill(6))

        if image_due:
            self.image_checkpoint(output_dir, step_number=step_number)
            if output_dir is not None:
                log_loss_vals(losses["g"], output_dir, step_number, "generator_",
                              self.log_writer, self.aml_sink)
                log_loss_vals(losses["d"], output_dir, step_number, "discriminator_",
                              self.log_writer, self.aml_sink)

            checkpoint_time = time.perf_counter() - checkpoint_start
            print("Training iteration time: %f" % iteration_time)
            print("Checkpoint time: %f" % checkpoint_time)
            if self.log_writer is not None:
                self.log_writer.scalar("perf/training_iter_time", iteration_time, step_number)
                self.log_writer.scalar("perf/checkpoint_time", checkpoint_time, step_number)
            if self.aml_sink is not None:
                self.aml_sink("Training iter time", iteration_time)
                self.aml_sink("Checkpoint time", checkpoint_time)

    def image_checkpoint(self, output_dir: Optional[str], step_number: Optional[int] = None) -> None:
        """``output_imgs/<step>.png``: the panel latents rendered at six yaws
        (rows), then the synthetic-data panel."""
        if step_number is None:
            step_number = self.get_training_step_number()
        viz = self._checkpoint_visualization_input
        generated = self.generate_images(viz["latent"], viz["rotation"])
        combined = build_image_matrix(generated, self.n_checkpoint_rotations, self.n_checkpoint_samples)
        self._save_panel(output_dir, str(step_number).zfill(6) + ".png", combined,
                         "generated_images", step_number)
        self.synth_data_image_checkpoint(output_dir, step_number=step_number)

    def synth_data_image_checkpoint(self, output_dir: Optional[str],
                                    step_number: Optional[int] = None) -> None:
        """``output_imgs/<step>_synth.jpg``: the synthetic ground truth, then
        its face-model parameters rendered at six yaws."""
        if step_number is None:
            step_number = self.get_training_step_number()
        viz = self._checkpoint_visualization_input
        generated = self.generate_images_from_facemodel(viz["facemodel_params"], viz["rotation"])
        generated = np.vstack((viz["gt_imgs"].astype(np.uint8), generated))
        combined = build_image_matrix(generated, self.n_checkpoint_rotations + 1,
                                      self.n_checkpoint_samples)
        self._save_panel(output_dir, str(step_number).zfill(6) + "_synth.jpg", combined,
                         "generated_synth_images", step_number)

    def _save_panel(self, output_dir: Optional[str], filename: str, panel: np.ndarray, tag: str,
                    step_number: int) -> None:
        """``output_dir/output_imgs/<filename>`` and the TensorBoard image
        ``tag``; nothing without an ``output_dir`` (a rank that does not
        write)."""
        if output_dir is None:
            return
        img_dir = os.path.join(output_dir, "output_imgs")
        os.makedirs(img_dir, exist_ok=True)
        self._imwrite(os.path.join(img_dir, filename), panel)
        if self.log_writer is not None:
            self.log_writer.image(tag, panel, step_number)

    @staticmethod
    def _imwrite(path: str, img_bgr: np.ndarray) -> None:
        """Write a BGR panel with cv2 where it can be imported (with the JAX
        package's parameters: PNG at zlib level 1), else with the port's own
        PNG or baseline JPEG writer, by the path's extension."""
        try:
            import cv2
        except ImportError:
            (write_png if path.endswith(".png") else write_jpeg)(path, img_bgr)
            return
        params = [cv2.IMWRITE_PNG_COMPRESSION, 1] if path.endswith(".png") else []
        cv2.imwrite(path, img_bgr, params)

    def generate_output_for_metrics(self) -> np.ndarray:
        m = self._generator_input_for_metrics
        return self.generate_images(m["latent"], m["rotation"])

    def _metric_latents_and_rotations(self):
        """The (latent, rotation) pair FID/KID scores; stage 2 encodes its
        fixed real images instead."""
        m = self._generator_input_for_metrics
        return m["latent"], m["rotation"]

    def calculate_metrics(self, output_dir: Optional[str], step_number: Optional[int] = None) -> None:
        """KID and FID of the metric latents' renders through the fused
        generator -> Inception path, appended to ``metrics`` (and written
        under ``output_dir`` where one is given)."""
        if self._inception_metric_object is None:
            return
        if step_number is None:
            step_number = self.get_training_step_number()
        latent, rotation = self._metric_latents_and_rotations()
        features = self._metric_features_for_latents(latent, rotation)
        self.metrics.setdefault("training_step_number", []).append(step_number)
        self._inception_metric_object.update_and_log_metrics(
            None, self.metrics, output_dir, self.aml_sink, self.log_writer, features=features)

    # ------------------------------------------------------------------
    # Host-side sampling helpers, from the global np.random as the JAX
    # package's (the same seed gives the same bytes)
    # ------------------------------------------------------------------

    def sample_latent_vector(self, n_samples: int) -> np.ndarray:
        if self.config["latent_distribution"] == "uniform":
            return np.random.uniform(-1, 1, (n_samples, self.config["latent_dim"]))
        return np.random.normal(0, 1, (n_samples, self.config["latent_dim"]))

    def sample_rotations(self, n_samples: int, axes=(0, 1, 2)) -> np.ndarray:
        """Uniform in the configured ranges (degrees), returned in radians."""
        rotation = np.zeros((n_samples, 3), np.float32)
        for axis in axes:
            lo, hi = self.config["rotation_ranges"][axis]
            rotation[:, axis] = np.pi * np.random.uniform(lo, hi, n_samples) / 180.0
        return rotation

    def sample_facemodel_params(self, n_samples: int) -> List[np.ndarray]:
        return [self.facemodel_param_distributions[name].sample(n_samples)[0]
                for name in self.config["facemodel_inputs"].keys()]

    # ------------------------------------------------------------------
    # Latent manipulation API
    # ------------------------------------------------------------------

    def get_facemodel_param_idxs_in_latent(self, param_name: str) -> range:
        names = list(self.config["facemodel_inputs"].keys())
        dims = list(self.config["facemodel_inputs"].values())
        idx = names.index(param_name)
        start = int(sum(d[1] for d in dims[:idx]))
        return range(start, start + dims[idx][1])

    @torch.inference_mode()
    def set_facemodel_param_in_latents(self, latents, param_name: str, param_value) -> np.ndarray:
        with span("confignet.splice"):
            param_value = np.asarray(param_value, dtype=np.float32)
            if param_value.ndim == 1:
                param_value = param_value[np.newaxis]
            encoded = self._inference_synthetic_encoder().encode_single_param(
                param_name, torch.from_numpy(param_value).to(self.device))
            idxs = self.get_facemodel_param_idxs_in_latent(param_name)
            new_latents = np.copy(latents)
            new_latents[:, list(idxs)] = encoded.float().cpu().numpy().astype(new_latents.dtype)
            return new_latents

    def fit_facemodel_expression_params_to_latent(
            self, latent, unused_expr_idxs=None, param_name: str = "blendshape_values",
            n_iters: int = 2000, learning_rate: float = 0.05, verbose: bool = False) -> np.ndarray:
        """Invert one parameter's synthetic-encoder MLP by projected SGD on
        the device: from zeros, ``n_iters`` steps on the mean squared error
        to the latent slice, each clipped to [0, 1] with the
        ``unused_expr_idxs`` held at 0 (first_stage.py:1080-1117; reference:
        confignet_first_stage.py:646-680).  Returns (1, input_dim) float32."""
        idxs = self.get_facemodel_param_idxs_in_latent(param_name)
        target = torch.from_numpy(np.asarray(latent)[:, list(idxs)].astype(np.float32)).to(self.device)
        input_dim = dict(self.config["facemodel_inputs"])[param_name][0]
        mask = torch.ones((1, input_dim), device=self.device)
        if unused_expr_idxs is not None:
            mask[:, list(unused_expr_idxs)] = 0.0

        encoder = self._inference_synthetic_encoder()

        def loss_of(values):
            return (target - encoder.encode_single_param(param_name, values)).square().mean()

        values = torch.zeros((1, input_dim), device=self.device)
        with torch.enable_grad():
            for _ in range(n_iters):
                values.requires_grad_(True)
                (grad,) = torch.autograd.grad(loss_of(values), values)
                values = torch.clamp(values.detach() - learning_rate * grad, 0.0, 1.0) * mask
        if verbose:
            with torch.no_grad():
                print(f"fit_facemodel_expression_params_to_latent: final loss {float(loss_of(values)):f}")
        return values.cpu().numpy()

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    def _inference_generator(self) -> HologanGenerator:
        """The generator that renders: a checkpoint job's snapshot while one
        runs, else the copy carrying the fine-tuned weights where they were
        set, else the EMA generator."""
        if self._inference_params_override is not None:
            return self._inference_params_override["generator_smoothed"]
        if self._fine_tuned_generator is None:
            return self.generator_smoothed
        return self._fine_tuned_generator

    def _inference_graphs(self) -> GraphCache:
        """The graph cache of the modules that render: a checkpoint job's
        snapshot's while one runs (it goes with the snapshot), else the
        model's."""
        if self._inference_params_override is not None:
            return self._snapshot_graphs
        return self._graphs

    def _inference_synthetic_encoder(self) -> SyntheticDataEncoder:
        """The synthetic encoder of a checkpoint job's snapshot while one
        runs, else the live one."""
        if self._inference_params_override is not None:
            return self._inference_params_override["synthetic_encoder"]
        return self.synthetic_encoder

    def generate_images(self, latent_vectors, rotations,
                        batch_chunk: int = RENDER_CHUNK) -> np.ndarray:
        """Inference-generator forward -> uint8 images, chunked at a fixed
        batch size (the tail padded by repeating its last row); on the card
        each chunk replays the graph of its generator and shape."""
        latent_vectors = np.asarray(latent_vectors, np.float32)
        rotations = np.asarray(rotations, np.float32)
        n = latent_vectors.shape[0]
        if n == 0:
            return np.zeros((0,), np.uint8)
        gen = self._inference_generator()

        def render(latents: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
            return uint8_from_unit_range(gen(latents, rotations))

        return run_chunked(self._inference_graphs(), "generate_images", render,
                           (latent_vectors, rotations), modules=(gen,), chunk=min(batch_chunk, n))

    def _metric_features_for_latents(self, latent_vectors, rotations,
                                     batch_chunk: int = METRIC_CHUNK) -> np.ndarray:
        """The fused generator -> InceptionV3 path of FID/KID
        (first_stage.py:1147-1167) over the metric latents -> float32
        (n, 2048), chunked at a fixed batch size (the tail padded by
        repeating its last row), each chunk one replay of its graph on the
        card.  The images are quantised on the device as ``generate_images``
        quantises them (clip, truncate to uint8, back to float), so the
        features are those of the saved uint8 images, and the images never
        cross to the host."""
        latent_vectors = np.asarray(latent_vectors, np.float32)
        rotations = np.asarray(rotations, np.float32)
        n = latent_vectors.shape[0]
        extractor = self._inception_metric_object.inception_feature_extractor
        if n == 0:
            return np.zeros((0, extractor.feature_dim), np.float32)
        generator = self._inference_generator()

        def fused(latents: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
            return extractor.features(uint8_from_unit_range(generator(latents, rotations)).float())

        return run_chunked(self._inference_graphs(), "metric_features", fused,
                           (latent_vectors, rotations), modules=(generator, extractor.module),
                           chunk=min(batch_chunk, n))

    def generate_images_from_facemodel(self, facemodel_params, rotations) -> np.ndarray:
        """Face-model parameters (one array per input, in config order) ->
        synthetic-encoder latents -> uint8 images."""
        with torch.inference_mode():
            latents = self._inference_synthetic_encoder()(
                [torch.from_numpy(np.asarray(p, np.float32)).to(self.device) for p in facemodel_params])
        return self.generate_images(latents.float().cpu().numpy(), rotations)
