"""Checkpoint files and the weight bridge between the JAX package's
checkpoint format and the port's modules (counterpart of
``confignet_tpu/core/model_io.py``).

A checkpoint is the JAX package's set of files, so either package reads
what the other writes:

- ``<name>.json``: the merged config, with ``model_type``;
- ``<name>.npz``: every parameter, keyed ``<tree>/<flattened/pytree/path>``;
- ``<name>_facemodel_distr.pck``: the sampling distributions (``core/pickles.py``);
- ``<name>_log.json``: the loss and metric history.

The port's module attributes carry the flax module names, so a pytree path
maps onto a torch parameter name by turning ``/`` into ``.`` and ``kernel``
into ``weight``; only the layout of kernels changes:

- Dense ``(in, out)`` -> ``(out, in)``;
- Conv2D HWIO -> OIHW (a depthwise (kh, kw, 1, C) becomes (C, 1, kh, kw)),
  Conv3D DHWIO -> OIDHW;
- everything else (biases, norm parameters, ``learned_input``) as is.

A flax ``batch_stats`` collection (the running ``mean`` and ``var`` of a
live BatchNorm) maps onto the buffers of those names, the same way
(``collection="batch_stats"``).

The JAX package's other weight formats are not read: the orbax directory
needs JAX's libraries, and a reference-release npz (Keras weight lists)
needs the Keras-order importer, which is not ported yet (ROADMAP.md queue 1
item 7).  Both raise ``NotImplementedError``.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

# JAX kernel layout -> torch weight layout, by rank.
_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_JAX = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _flatten(tree: Dict[str, Any], prefix: str, out: Dict[str, np.ndarray]) -> None:
    for name, value in tree.items():
        key = f"{prefix}/{name}" if prefix else str(name)
        if isinstance(value, dict):
            _flatten(value, key, out)
        else:
            out[key] = np.asarray(value)


def flatten_param_trees(trees: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """{"generator": nested dict, ...} -> {"generator/path/to/leaf": ndarray}.
    ``None`` trees are skipped."""
    flat: Dict[str, np.ndarray] = {}
    for tree_name, tree in trees.items():
        if tree is not None:
            _flatten(tree, tree_name, flat)
    return flat


def unflatten_param_trees(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_param_trees`."""
    trees: Dict[str, Any] = {}
    for key, value in flat.items():
        node = trees
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(value)
    return trees


def _jax_key(torch_name: str) -> str:
    parts = torch_name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


# the buffers that hold a flax BatchNorm's ``batch_stats``
BATCH_STAT_NAMES = ("mean", "var")


def _collection(model: nn.Module, collection: str) -> Dict[str, torch.Tensor]:
    """The tensors of a flax variable collection: "params" (the parameters)
    or "batch_stats" (the ``mean`` / ``var`` buffers)."""
    if collection == "params":
        return dict(model.named_parameters())
    if collection == "batch_stats":
        return {name: buf for name, buf in model.named_buffers()
                if name.rsplit(".", 1)[-1] in BATCH_STAT_NAMES}
    raise ValueError(f"unknown variable collection {collection!r} (params|batch_stats)")


def load_jax_params(model: nn.Module, flat: Dict[str, np.ndarray], collection: str = "params") -> None:
    """Copy JAX parameters (or another flax collection's variables), keyed by
    their pytree path within ONE tree (e.g. ``map_3d_0/conv_0/kernel``),
    into ``model``.

    Raises on a missing key, an unused key or a shape mismatch, so a load
    either sets every parameter or fails.
    """
    params = _collection(model, collection)
    by_key = {_jax_key(name): name for name in params}
    missing = sorted(set(by_key) - set(flat))
    unused = sorted(set(flat) - set(by_key))
    if missing or unused:
        raise KeyError(f"parameter keys do not match: missing {missing[:8]}, unused {unused[:8]}"
                       f" ({len(missing)} missing, {len(unused)} unused)")
    with torch.no_grad():
        for key, name in by_key.items():
            value = np.array(flat[key], dtype=np.float32)  # a writable copy
            param = params[name]
            if name.endswith("weight"):
                value = value.transpose(_TO_TORCH[value.ndim])
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)} (torch layout) does not "
                                 f"match parameter {name} of shape {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def export_jax_tensors(named: Iterable[Tuple[str, torch.Tensor]],
                       dtype: torch.dtype = torch.float32) -> Dict[str, np.ndarray]:
    """(torch parameter name, tensor of that parameter's shape) pairs -> numpy
    arrays of ``dtype`` in JAX layout under the parameters' pytree-path keys
    (the parameters themselves, or per-parameter optimizer state).  The arrays
    are copies: later updates of the tensors do not show in them."""
    flat = {}
    for name, tensor in named:
        value = tensor.detach().to("cpu", dtype, copy=True).numpy()
        if name.endswith("weight"):
            value = np.ascontiguousarray(value.transpose(_TO_JAX[value.ndim]))
        flat[_jax_key(name)] = value
    return flat


def export_jax_params(model: nn.Module, collection: str = "params") -> Dict[str, np.ndarray]:
    """Inverse of :func:`load_jax_params`: the model's parameters (or batch
    statistics) as float32 numpy arrays in JAX layout under their pytree-path
    keys."""
    return export_jax_tensors(_collection(model, collection).items())


# ----------------------------------------------------------------------
# Checkpoint files
# ----------------------------------------------------------------------

def save_model_weights(trees: Dict[str, Any], output_dir: str, output_filename: str) -> str:
    """Write {tree: {pytree path: ndarray}} (or nested dicts) as
    ``<output_filename>.npz`` under the JAX package's keys."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, output_filename + ".npz")
    np.savez(path, **flatten_param_trees(trees))
    return path


def load_model_weights(npz_path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """An npz of either package -> {tree: {pytree path: ndarray}}, the form
    ``get_weights`` returns and ``set_weights`` takes."""
    trees: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(npz_path, allow_pickle=False) as data:
        for key in data.files:
            tree_name, _, path = key.partition("/")
            trees.setdefault(tree_name, {})[path] = data[key]
    return trees


def npz_is_reference_format(npz_path: str) -> bool:
    """True for a reference-release npz: Keras ``get_weights()`` lists keyed
    ``<model>_weights`` instead of ``<tree>/<path>``.  Only the key listing
    is read, so no pickle is executed."""
    with np.load(npz_path, allow_pickle=False) as data:
        files = list(data.files)
    return bool(files) and all(k.endswith("_weights") for k in files)


def check_not_reference_format(npz_path: str) -> None:
    if npz_is_reference_format(npz_path):
        raise NotImplementedError(f"{npz_path} is a reference-release checkpoint (Keras weight "
                                  "lists); importing those is not ported yet (ROADMAP.md queue 1 "
                                  "item 7)")


def save_weights_orbax(trees: Dict[str, Any], checkpoint_dir: str) -> None:
    raise NotImplementedError("the orbax checkpoint format needs JAX's libraries; the port writes "
                              "npz (checkpoint_format='npz')")


def load_weights_orbax(checkpoint_dir: str) -> Dict[str, Any]:
    raise NotImplementedError(f"{checkpoint_dir} is an orbax checkpoint, which needs JAX's "
                              "libraries; re-save it as npz with the JAX package")


def attempt_reloading_checkpoint(output_dir: str, dnn_loader: Optional[Callable] = None):
    """Preemption recovery: load the newest checkpoint json (by name; not a
    ``_log.json``) from ``<output_dir>/checkpoints``, else from
    ``$PT_PREV_OUTPUT_DIR/checkpoints``; None when neither has one."""
    if dnn_loader is None:
        dnn_loader = load_confignet
    candidate_dirs = [os.path.join(output_dir, "checkpoints")]
    if "PT_PREV_OUTPUT_DIR" in os.environ:
        candidate_dirs.append(os.path.join(os.environ["PT_PREV_OUTPUT_DIR"], "checkpoints"))

    print("Attempting to restart job from checkpoint. Potential checkpoint dirs are:")
    for candidate in candidate_dirs:
        print(candidate)
    for checkpoint_dir in candidate_dirs:
        checkpoint_files = sorted(path for path in glob.glob(os.path.join(checkpoint_dir, "*.json"))
                                  if not path.endswith("_log.json"))
        if checkpoint_files:
            print("Found loadable checkpoint")
            return dnn_loader(checkpoint_files[-1])
    return None


def load_confignet(model_path: str, device: Optional[Union[str, torch.device]] = None):
    """Load a checkpoint that either package wrote (``ConfigNetFirstStage``,
    ``ConfigNet`` or ``LatentGAN``), by the ``model_type`` of its json, on
    ``device`` (the GPU unless given)."""
    with open(model_path, "r") as fp:
        model_type = json.load(fp)["model_type"]
    if model_type == "ConfigNetFirstStage":
        from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage as model_cls
    elif model_type == "ConfigNet":
        from confignet_tpu_torch.training.second_stage import ConfigNet as model_cls
    elif model_type == "LatentGAN":
        from confignet_tpu_torch.training.latent_gan import LatentGAN as model_cls
    else:
        raise ValueError(f"unknown model_type {model_type!r} in {model_path}")
    return model_cls.load(model_path, device=device)
