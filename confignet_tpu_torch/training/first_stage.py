"""ConfigNet first stage, inference half (counterpart of
``confignet_tpu/training/first_stage.py``).

Holds the configuration schema, the face-model input bookkeeping, the
generator (training weights and the ``generator_smoothed`` EMA weights used
for inference) and the synthetic encoder, plus the latent-manipulation and
image-generation API.  Training comes with a later slice, in this file.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from confignet_tpu_torch.core.config import merge_configs
from confignet_tpu_torch.core.device import resolve_device
from confignet_tpu_torch.core import initializers
from confignet_tpu_torch.core.model_io import export_jax_params, load_jax_params
from confignet_tpu_torch.models.generator import HologanGenerator
from confignet_tpu_torch.models.synthetic_encoder import SyntheticDataEncoder

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
    "rotation_resample": "auto",  # auto | gather | kernel (models/generator.py)
    "adain_impl": "auto",  # auto | kernel | plain (ops/adain_cuda.py)
    "upconv_impl": "auto",  # naive | subpixel | auto (ops/upconv.py)
    "backbones_dir": None,
    "r1_heads": "all",
    "loss_print_period": 50,
    "async_checkpointing": True,
    "checkpoint_format": "npz",
    "seed": 0,
}


def uint8_from_unit_range(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> uint8: (x + 1) * 127.5, clipped, truncated."""
    return torch.clamp((x.float() + 1.0) * 127.5, 0.0, 255.0).to(torch.uint8)


class ConfigNetFirstStage:
    MODEL_TYPE = "ConfigNetFirstStage"
    # parameter trees this half holds, under their checkpoint names
    WEIGHT_TREES = ("generator", "generator_smoothed", "synthetic_encoder")

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

        self._fine_tuned_generator_params = None
        self._build_modules()
        if initialize:
            self.initialize_network()
        self._to_device()

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.config.get("compute_dtype") == "bfloat16" else None

    @property
    def facemodel_inputs_tuple(self) -> Tuple:
        return tuple((name, tuple(dims)) for name, dims in self.config["facemodel_inputs"].items())

    def _generator(self) -> HologanGenerator:
        cfg = self.config
        return HologanGenerator(
            latent_dim=cfg["latent_dim"], output_shape=tuple(cfg["output_shape"][:2]),
            n_adain_mlp_units=cfg["n_adain_mlp_units"],
            n_adain_mlp_layers=cfg["n_adain_mlp_layers"],
            gen_output_activation=cfg["gen_output_activation"],
            const_shape=tuple(cfg["const_input_shape"]),
            n_features_first=cfg.get("n_generator_features", 256), dtype=self.compute_dtype,
            rotation_resample=cfg.get("rotation_resample", "auto"),
            upconv_impl=cfg.get("upconv_impl", "auto"), adain_impl=cfg.get("adain_impl", "auto"))

    def _build_modules(self) -> None:
        self.generator = self._generator()
        self.generator_smoothed = self._generator()
        self.synthetic_encoder = SyntheticDataEncoder(
            self.facemodel_inputs_tuple, num_layers=self.config["num_synth_encoder_layers"],
            dtype=self.compute_dtype)

    def initialize_network(self) -> None:
        """Seeded init on the CPU (the same weights on every device); the EMA
        generator starts as a copy of the generator."""
        rng = torch.Generator().manual_seed(int(self.config.get("seed", 0)))
        initializers.initialize(self.generator, rng)
        initializers.initialize(self.synthetic_encoder, rng)
        self.generator_smoothed.load_state_dict(self.generator.state_dict())

    def _to_device(self) -> None:
        for name in self.WEIGHT_TREES:
            getattr(self, name).to(self.device).eval()

    # ------------------------------------------------------------------
    # Weights in the JAX package's checkpoint format
    # ------------------------------------------------------------------

    def get_weights(self) -> Dict[str, Dict[str, np.ndarray]]:
        """{tree: {pytree path: ndarray}} for the trees this half holds."""
        return {name: export_jax_params(getattr(self, name)) for name in self.WEIGHT_TREES}

    def set_weights(self, weights: Dict[str, Dict[str, np.ndarray]]) -> None:
        """Load {tree: {pytree path: ndarray}}; every tree this half holds
        must be present.  Trees of the training slice (discriminators,
        latent regressor) are not held yet and are ignored."""
        for name in self.WEIGHT_TREES:
            if name not in weights:
                raise KeyError(f"weights have no {name!r} tree")
            load_jax_params(getattr(self, name), weights[name])

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
        param_value = np.asarray(param_value, dtype=np.float32)
        if param_value.ndim == 1:
            param_value = param_value[np.newaxis]
        encoded = self.synthetic_encoder.encode_single_param(
            param_name, torch.from_numpy(param_value).to(self.device))
        idxs = self.get_facemodel_param_idxs_in_latent(param_name)
        new_latents = np.copy(latents)
        new_latents[:, list(idxs)] = encoded.float().cpu().numpy().astype(new_latents.dtype)
        return new_latents

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    def _inference_generator(self) -> HologanGenerator:
        """The EMA generator, or a copy carrying the fine-tuned weights."""
        if self._fine_tuned_generator_params is None:
            return self.generator_smoothed
        gen = copy.deepcopy(self.generator_smoothed)
        gen.load_state_dict(self._fine_tuned_generator_params)
        return gen

    @torch.inference_mode()
    def generate_images(self, latent_vectors, rotations, batch_chunk: int = 32) -> np.ndarray:
        """Inference-generator forward -> uint8 images, chunked at a fixed
        batch size (the tail padded by repeating its last row)."""
        latent_vectors = np.asarray(latent_vectors, np.float32)
        rotations = np.asarray(rotations, np.float32)
        n = latent_vectors.shape[0]
        chunk = min(batch_chunk, max(n, 1))
        gen = self._inference_generator()
        outputs: List[np.ndarray] = []
        for start in range(0, n, chunk):
            lat = latent_vectors[start:start + chunk]
            rot = rotations[start:start + chunk]
            pad = chunk - lat.shape[0]
            if pad:
                lat = np.concatenate([lat, np.repeat(lat[-1:], pad, axis=0)])
                rot = np.concatenate([rot, np.repeat(rot[-1:], pad, axis=0)])
            img = gen(torch.from_numpy(lat).to(self.device), torch.from_numpy(rot).to(self.device))
            imgs = uint8_from_unit_range(img).cpu().numpy()
            outputs.append(imgs[:chunk - pad])
        if not outputs:
            return np.zeros((0,), np.uint8)
        return np.concatenate(outputs, axis=0)
