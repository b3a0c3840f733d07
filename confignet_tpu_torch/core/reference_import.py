"""Import checkpoints of the original TensorFlow ConfigNet, the paper's
released models (counterpart of ``confignet_tpu/core/reference_import.py``).

The reference saves ``np.savez(**{model: get_weights_list})`` beside a config
json (confignet_first_stage.py:173-206, latent_gan.py:48-81).  Keras
``get_weights()`` returns a flat list in object-graph order (sub-layer
attribute order, depth first; kernel before bias, gamma before beta).  The
tables below declare that order per model as the JAX package's pytree
paths, the same tables as the JAX package's.  :func:`assign_weight_list`
zips a list onto one tree's parameters keyed by those paths (the form
``get_weights`` returns), strict on counts and shapes, and the model's
``set_weights`` (``core/model_io.load_jax_params``) carries the tree into
the torch modules, so the only mapping from pytree paths to torch names is
the one every checkpoint already goes through.

- The generator's ``learned_input`` Dense has a dead, all-zero kernel (its
  input is a constant zero); its bias is the learned constant, and the kernel
  is checked to be zero and dropped.
- The real encoder's ResNet50 carries its batch-norm statistics as
  parameters, in Keras order (gamma, beta, moving_mean, moving_variance).
- The two python-list attributes of the discriminator are grouped in the
  order TF 2.1 wrote; :func:`load_reference_confignet` falls back to the
  interleaved order of other Keras versions when the grouped one does not
  fit.

The distribution pickle of a release names the reference's classes
(``confignet.neural_renderer_dataset``); ``core/pickles.read_pickle`` maps
them onto the port's.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from confignet_tpu_torch.core import pickles
from confignet_tpu_torch.core.resnet50_keras_order import RESNET50_KERAS_WEIGHT_NAMES

Path = Tuple[str, ...]
# the sentinel path of the generator's dead learned-input kernel
DROP_ZERO_KERNEL: Path = ("__drop_zero_kernel__",)


def _adain_block_paths(prefix: str) -> List[Path]:
    """Conv{2,3}dAdaIn weight order: conv kernel/bias, then the AdaIN MLP's
    dense layers (building_blocks.py: map_* assigned before adain)."""
    return [
        (prefix, "conv_0", "kernel"),
        (prefix, "conv_0", "bias"),
        (prefix, "adain", "mlp", "dense_0", "kernel"),
        (prefix, "adain", "mlp", "dense_0", "bias"),
        (prefix, "adain", "mlp", "dense_1", "kernel"),
        (prefix, "adain", "mlp", "dense_1", "bias"),
    ]


def generator_weight_paths(output_size: int) -> List[Path]:
    """Keras weight order of HologanGenerator (hologan_generator.py:23-101);
    the leading learned-input Dense gives (kernel, bias), the kernel at
    :data:`DROP_ZERO_KERNEL`."""
    paths: List[Path] = [DROP_ZERO_KERNEL, ("learned_input",)]
    paths += _adain_block_paths("map_3d_0")
    paths += _adain_block_paths("map_3d_1")
    paths += [
        ("map_3d_post_0", "kernel"), ("map_3d_post_0", "bias"),
        ("map_3d_post_1", "kernel"), ("map_3d_post_1", "bias"),
        ("projection_conv", "kernel"), ("projection_conv", "bias"),
    ]
    paths += _adain_block_paths("map_2d_0")
    paths += _adain_block_paths("map_2d_1")
    paths += _adain_block_paths("map_2d_2")
    if output_size > 128:
        paths += _adain_block_paths("map_2d_2b")
    if output_size > 256:
        paths += _adain_block_paths("map_2d_2c")
    paths += [("map_final", "kernel"), ("map_final", "bias")]
    return paths


def _discriminator_block_paths(i: int) -> List[Path]:
    return [(f"block_{i}", "conv", "kernel"), (f"block_{i}", "conv", "bias"),
            (f"block_{i}", "in_gamma"), (f"block_{i}", "in_beta")]


def discriminator_weight_paths(num_resample: int, from_rgb: bool = True,
                               list_ordering: str = "grouped") -> List[Path]:
    """HologanDiscriminator order (hologan_discriminator.py:19-46): the
    from-RGB conv, the conv blocks and style classifiers, the final dense.
    ``list_ordering`` "grouped" puts every conv block before every style
    classifier (the TF 2.1 order); "interleaved" alternates them."""
    paths: List[Path] = [("from_rgb", "kernel"), ("from_rgb", "bias")] if from_rgb else []
    style = lambda i: [(f"style_classifier_{i}", "kernel"), (f"style_classifier_{i}", "bias")]
    if list_ordering == "grouped":
        for i in range(num_resample):
            paths += _discriminator_block_paths(i)
        for i in range(num_resample):
            paths += style(i)
    elif list_ordering == "interleaved":
        for i in range(num_resample):
            paths += _discriminator_block_paths(i) + style(i)
    else:
        raise ValueError(f"unknown list_ordering {list_ordering!r}")
    return paths + [("disc_map", "kernel"), ("disc_map", "bias")]


def latent_regressor_weight_paths(num_resample: int, from_rgb: bool = True) -> List[Path]:
    paths: List[Path] = [("from_rgb", "kernel"), ("from_rgb", "bias")] if from_rgb else []
    for i in range(num_resample):
        paths += _discriminator_block_paths(i)
    return paths + [("latent_predictor", "kernel"), ("latent_predictor", "bias")]


def mlp_weight_paths(num_layers: int) -> List[Path]:
    paths: List[Path] = []
    for i in range(num_layers):
        paths += [(f"dense_{i}", "kernel"), (f"dense_{i}", "bias")]
    return paths


def synthetic_encoder_weight_paths(facemodel_inputs: Sequence, num_layers: int = 2) -> List[Path]:
    """The per-parameter MLPs in ``facemodel_inputs`` (alphabetical) order
    (synthetic_encoder.py:19-33)."""
    paths: List[Path] = []
    for name, _dims in facemodel_inputs:
        for i in range(num_layers):
            paths += [(f"mlp_{name}", f"dense_{i}", "kernel"), (f"mlp_{name}", f"dense_{i}", "bias")]
    return paths


def _resnet50_layer_to_path(layer_name: str) -> Path:
    """A Keras ResNet50 layer name -> the encoder's module path."""
    if layer_name == "conv1_conv":
        return ("resnet", "stem_conv")
    if layer_name == "conv1_bn":
        return ("resnet", "stem_bn")
    # conv{S}_block{B}_{J}_{conv|bn}, S in 2..5 -> stage{S-1}, J in 0..3
    stage_part, block_part, j, kind = layer_name.split("_")
    stage, block = int(stage_part[4:]) - 1, int(block_part[5:])
    if kind == "conv":
        sub = "shortcut_conv" if j == "0" else f"conv{j}"
    else:
        sub = "shortcut_bn" if j == "0" else f"bn{j}"
    return ("resnet", f"stage{stage}_block{block}", sub)


def real_encoder_weight_paths() -> List[Path]:
    """RealEncoder order (real_encoder.py:9-22): the ResNet50's weights in
    measured Keras order, then the rotation regressor and the latent head."""
    paths = []
    for name in RESNET50_KERAS_WEIGHT_NAMES:
        layer, leaf = name.rsplit("/", 1)
        paths.append(_resnet50_layer_to_path(layer) + (leaf,))
    return paths + [("rotation_regressor", "kernel"), ("rotation_regressor", "bias"),
                    ("feature_to_latent", "kernel"), ("feature_to_latent", "bias")]


def assign_weight_list(params: Dict[str, np.ndarray], weight_list: Sequence[np.ndarray],
                       paths: List[Path], model_name: str = "") -> Dict[str, np.ndarray]:
    """A copy of ``params`` (one tree's parameters keyed by pytree path,
    ``a/b/kernel``, in JAX layout) with the Keras list zipped onto the
    declared paths.  Raises on a count, a path or a shape that does not
    match, and on a live learned-input kernel."""
    flat = dict(params)
    weight_list = list(weight_list)
    if len(weight_list) != len(paths):
        raise ValueError(f"{model_name}: expected {len(paths)} weights, got {len(weight_list)}")
    for offset, (path, weight) in enumerate(zip(paths, weight_list)):
        weight = np.asarray(weight)
        if path == DROP_ZERO_KERNEL:
            if np.any(weight != 0):
                raise ValueError(f"{model_name}[{offset}]: learned-input kernel expected to be "
                                 "all-zero (it is dead in the reference); refusing import")
            continue
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"{model_name}[{offset}]: no parameter at {key}")
        target_shape = tuple(np.shape(flat[key]))
        if tuple(weight.shape) != target_shape:
            raise ValueError(f"{model_name}[{offset}] {key}: shape {weight.shape} != expected "
                             f"{target_shape}")
        flat[key] = weight.astype(np.float32)
    return flat


def load_reference_pickle(path: str):
    """Load a pickle written by the TF reference, the JAX package or the
    port (a release's face-model distributions, the HDRI model) through the
    port's unpickler, which maps each package's classes onto the port's."""
    return pickles.read_pickle(path)


def _read_json(path: str) -> dict:
    with open(path, "r") as fp:
        return json.load(fp)


def load_reference_confignet(json_path: str, device: Optional[Union[str, torch.device]] = None):
    """A ``ConfigNet`` (``model_type`` "ConfigNet") or ``ConfigNetFirstStage``
    on ``device`` with the weights of a reference-format checkpoint (json +
    npz of Keras weight lists).  Without ``real_encoder_weights`` a ConfigNet
    keeps its seeded encoder.  The log and distributions are the caller's
    (``ConfigNetFirstStage.load``)."""
    from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage, _port_config
    from confignet_tpu_torch.training.second_stage import ConfigNet

    config = _read_json(json_path)
    model_cls = ConfigNet if config.get("model_type") == "ConfigNet" else ConfigNetFirstStage
    with np.load(os.path.splitext(json_path)[0] + ".npz", allow_pickle=True) as npz:
        data = {key: list(npz[key]) for key in npz.files}
    with_encoder = model_cls is ConfigNet and "real_encoder_weights" in data
    # every tree is assigned below, but for a ConfigNet's missing encoder
    model = model_cls(_port_config(config), device=device,
                      initialize=model_cls is ConfigNet and not with_encoder)
    size = model.config["output_shape"][0]
    n_resample = model.config["n_discr_layers"]
    from_rgb = model.config["initial_from_rgb_layer_in_discr"]

    def assign_discriminator(params, weight_list, name):
        try:
            return assign_weight_list(params, weight_list,
                                      discriminator_weight_paths(n_resample, from_rgb, "grouped"), name)
        except (ValueError, KeyError):
            return assign_weight_list(params, weight_list,
                                      discriminator_weight_paths(n_resample, from_rgb, "interleaved"),
                                      name)

    weights = model.get_weights()
    for tree in ("generator", "generator_smoothed"):
        weights[tree] = assign_weight_list(weights[tree], data[tree + "_weights"],
                                           generator_weight_paths(size), tree)
    for tree in ("discriminator", "synth_discriminator"):
        weights[tree] = assign_discriminator(weights[tree], data[tree + "_weights"], tree)
    weights["latent_regressor"] = assign_weight_list(
        weights["latent_regressor"], data["latent_regressor_weights"],
        latent_regressor_weight_paths(n_resample, from_rgb), "latent_regressor")
    weights["latent_discriminator"] = assign_weight_list(
        weights["latent_discriminator"], data["latent_discriminator_weights"],
        mlp_weight_paths(model.config["n_latent_discr_layers"]), "latent_discriminator")
    weights["synthetic_encoder"] = assign_weight_list(
        weights["synthetic_encoder"], data["synthetic_encoder_weights"],
        synthetic_encoder_weight_paths(model.facemodel_inputs_tuple,
                                       model.config["num_synth_encoder_layers"]),
        "synthetic_encoder")
    if with_encoder:
        weights["real_encoder"] = assign_weight_list(
            weights["real_encoder"], data["real_encoder_weights"], real_encoder_weight_paths(),
            "real_encoder")
    model.set_weights(weights)
    return model


def load_reference_latent_gan(json_path: str, device: Optional[Union[str, torch.device]] = None):
    """A ``LatentGAN`` on ``device`` from a reference-format checkpoint: the
    npz keys ``generator_weights``, ``smoothed_generator_weights`` and
    ``discriminator_weights`` (latent_gan.py:48-81), each an MLP of
    ``num_mlp_layers`` Dense layers."""
    from confignet_tpu_torch.training.latent_gan import LatentGAN

    gan = LatentGAN(_read_json(json_path), device=device)
    paths = mlp_weight_paths(gan.config["num_mlp_layers"])
    weights = gan.get_weights()
    with np.load(os.path.splitext(json_path)[0] + ".npz", allow_pickle=True) as data:
        for tree, key in (("generator", "generator_weights"),
                          ("generator_smoothed", "smoothed_generator_weights"),
                          ("discriminator", "discriminator_weights")):
            weights[tree] = assign_weight_list(weights[tree], data[key], paths, "latentgan_" + tree)
    gan.set_weights(weights)
    return gan
