"""Import the standard Keras ``.h5`` weight files into the port's backbones
(counterpart of ``confignet_tpu/models/backbones/loader.py``).

The loaders work on one module's parameters as ``core/model_io`` exports
them: a flat dict keyed by the JAX package's pytree paths
(``block1_conv1/kernel``), in flax layout, which is Keras's too (HWIO conv
kernels), so a Keras array is stored unchanged.  Each returns a new dict;
:func:`load_into` exports a module, runs a loader and loads the result back
through ``load_jax_params``, which refuses a key or a shape that does not
fit.  The batch-norm statistics go into the frozen norms' parameters
(``gamma``, ``beta``, ``moving_mean``, ``moving_variance``), as in the JAX
trees.

- :func:`load_keras_h5_weights`: by layer name (VGG19, VGGFace VGG16; the
  files the reference downloads at perceptual_loss.py:19,30-32);
- :func:`load_keras_h5_ordered`: by creation order, for the models whose
  Keras names are global counters (InceptionV3, MobileNetV2);
- :func:`load_keras_h5_mapped`: by an explicit layer-name map (ResNet50).

``h5py`` is imported inside the functions, so the package imports without it.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
from torch import nn

from confignet_tpu_torch.core.model_io import export_jax_params, load_jax_params

Flat = Dict[str, np.ndarray]


def load_into(module: nn.Module, transfer: Callable[[Flat], Flat]) -> None:
    """``module``'s parameters through ``transfer`` (one of the loaders
    below, its file and paths bound) and back into ``module``."""
    load_jax_params(module, transfer(export_jax_params(module)))


def _weight_root(f):
    return f["model_weights"] if "model_weights" in f else f


def _decoded(names) -> List[str]:
    return [n.decode() if isinstance(n, bytes) else n for n in names]


def _layer_arrays(group) -> Dict[str, np.ndarray]:
    """{leaf name without ``:0``: array} of one layer's ``weight_names``."""
    return {wn.split("/")[-1].split(":")[0]: np.asarray(group[wn])
            for wn in _decoded(group.attrs.get("weight_names", []))}


def _canonical_name(key: str) -> str:
    stem = key.split(":")[0]
    for candidate in ("kernel", "bias", "W", "b"):
        if stem == candidate or stem.endswith("_" + candidate):
            return {"W": "kernel", "b": "bias"}.get(candidate, candidate)
    return stem


def _is_weight_key(key: str) -> bool:
    return _canonical_name(key) in ("kernel", "bias")


def load_keras_h5_weights(params: Flat, h5_path: str) -> Flat:
    """``params`` with the kernel and bias of every layer whose name is a
    top-level module of the model replaced by the file's.  Raises when no
    layer name matches (counter-named files need the ordered loader)."""
    import h5py

    new_params = dict(params)
    modules = {key.split("/")[0] for key in params}
    matched = 0
    with h5py.File(h5_path, "r") as f:
        root = _weight_root(f)
        for layer_name in list(root.keys()):
            if layer_name not in modules:
                continue
            sub = root[layer_name]
            # Keras nests again by layer name (possibly with suffixes)
            while len(sub.keys()) == 1 and not _is_weight_key(list(sub.keys())[0]):
                sub = sub[list(sub.keys())[0]]
            for key in sub.keys():
                leaf = _canonical_name(key)
                if leaf in ("kernel", "bias") and f"{layer_name}/{leaf}" in new_params:
                    new_params[f"{layer_name}/{leaf}"] = np.asarray(sub[key])
            matched += 1
    if matched == 0:
        raise ValueError(f"no layer names in {h5_path} match this model's modules; for "
                         "InceptionV3/MobileNetV2 use load_keras_h5_ordered, for ResNet50 use "
                         "load_keras_h5_mapped")
    return new_params


def _set_path(params: Flat, path: str, leaf_updates: Dict[str, np.ndarray]) -> None:
    if not any(key.startswith(path + "/") for key in params):
        raise KeyError(path)
    for leaf, value in leaf_updates.items():
        params[f"{path}/{leaf}"] = value


def load_keras_h5_ordered(params: Flat, h5_path: str, conv_paths: Sequence[str],
                          bn_paths: Sequence[str]) -> Flat:
    """Conv kernels (and biases) and batch norms transferred by CREATION
    ORDER: ``conv_paths[i]`` receives the i-th conv-bearing layer's kernel
    (a Keras depthwise ``(h, w, C, 1)`` becomes flax's ``(h, w, 1, C)``),
    ``bn_paths[i]`` the i-th batch norm's ``beta`` and statistics, and its
    ``gamma`` where the layer has one (InceptionV3's norms have none and keep
    theirs).

    The file's ``layer_names`` are topological order, which scrambles
    parallel branches; when every weighted layer has a Keras global-counter
    name (``conv2d_42``, ``batch_normalization_42``) the counter is creation
    order and the layers are sorted by it.  Semantic names (MobileNetV2's
    ``block_13_expand``) keep file order, right for a linear chain; a file
    that mixes the two raises."""
    import h5py

    counter_re = re.compile(r"^[a-z_0-9]*?[a-z](?:_(\d+))?$")

    def creation_index(name: str) -> int:
        match = counter_re.fullmatch(name)
        return int(match.group(1)) if match and match.group(1) else 0

    new_params = dict(params)
    conv_seen = bn_seen = 0
    with h5py.File(h5_path, "r") as f:
        root = _weight_root(f)
        layer_names = _decoded(root.attrs["layer_names"])
        weighted = [n for n in layer_names if len(root[n].attrs.get("weight_names", []))]
        counter_named = [bool(re.fullmatch(r"(conv2d|batch_normalization)(_\d+)?", n))
                         for n in weighted]
        if counter_named and all(counter_named):
            layer_names = sorted(layer_names, key=creation_index)
        elif any(counter_named):
            raise ValueError("h5 mixes counter-style layer names "
                             f"({[n for n, c in zip(weighted, counter_named) if c][:3]}...) with "
                             "semantic names; creation order is ambiguous; rename the layers or "
                             "load with explicit per-layer paths")
        for layer_name in layer_names:
            arrays = _layer_arrays(root[layer_name])
            if not arrays:
                continue
            if "moving_mean" in arrays:  # a BatchNormalization layer
                if bn_seen >= len(bn_paths):
                    raise ValueError(f"h5 has more BN layers than expected ({len(bn_paths)})")
                updates = {k: arrays[k] for k in ("beta", "moving_mean", "moving_variance")}
                if "gamma" in arrays:
                    updates["gamma"] = arrays["gamma"]
                _set_path(new_params, bn_paths[bn_seen], updates)
                bn_seen += 1
            elif "depthwise_kernel" in arrays or "kernel" in arrays:
                if conv_seen >= len(conv_paths):
                    raise ValueError(f"h5 has more conv layers than expected ({len(conv_paths)})")
                if "depthwise_kernel" in arrays:
                    kernel = np.transpose(arrays["depthwise_kernel"], (0, 1, 3, 2))
                else:
                    kernel = arrays["kernel"]
                updates = {"kernel": kernel}
                if "bias" in arrays:
                    updates["bias"] = arrays["bias"]
                _set_path(new_params, conv_paths[conv_seen], updates)
                conv_seen += 1
    if conv_seen != len(conv_paths) or bn_seen != len(bn_paths):
        raise ValueError(f"h5 transferred {conv_seen}/{len(conv_paths)} convs and "
                         f"{bn_seen}/{len(bn_paths)} BNs: architecture mismatch")
    return new_params


def load_keras_h5_mapped(params: Flat, h5_path: str,
                         name_map: Dict[str, Tuple[str, str]]) -> Flat:
    """Weights transferred by an explicit {Keras layer name: (module path,
    "conv" | "bn")} map (models with stable semantic Keras names, such as
    ResNet50).  Raises when fewer than half the mapped layers are in the
    file, the sign of the other naming generation."""
    import h5py

    new_params = dict(params)
    found = 0
    with h5py.File(h5_path, "r") as f:
        root = _weight_root(f)
        for layer_name in root.keys():
            if layer_name not in name_map:
                continue
            path, kind = name_map[layer_name]
            arrays = _layer_arrays(root[layer_name])
            if kind == "conv":
                updates = {"kernel": arrays["kernel"]}
                if "bias" in arrays:
                    updates["bias"] = arrays["bias"]
            else:
                updates = {k: arrays[k] for k in ("gamma", "beta", "moving_mean", "moving_variance")
                           if k in arrays}
            _set_path(new_params, path, updates)
            found += 1
    if found < len(name_map) // 2:
        raise ValueError(f"only {found}/{len(name_map)} mapped layers found in {h5_path}")
    return new_params
