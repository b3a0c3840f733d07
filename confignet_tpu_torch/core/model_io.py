"""The weight bridge between the JAX package's checkpoint format and the
port's modules (counterpart of ``confignet_tpu/core/model_io.py``).

The npz format keys every parameter ``<tree>/<flattened/pytree/path>``.
The port's module attributes carry the flax module names, so a pytree path
maps onto a torch parameter name by turning ``/`` into ``.`` and ``kernel``
into ``weight``; only the layout of kernels changes:

- Dense ``(in, out)`` -> ``(out, in)``;
- Conv2D HWIO -> OIHW, Conv3D DHWIO -> OIDHW;
- everything else (biases, norm parameters, ``learned_input``) as is.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

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


def load_jax_params(model: nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Copy JAX parameters, keyed by their pytree path within ONE tree (e.g.
    ``map_3d_0/conv_0/kernel``), into ``model``.

    Raises on a missing key, an unused key or a shape mismatch, so a load
    either sets every parameter or fails.
    """
    params = dict(model.named_parameters())
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


def export_jax_tensors(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """(torch parameter name, tensor of that parameter's shape) pairs -> float32
    numpy arrays in JAX layout under the parameters' pytree-path keys (the
    parameters themselves, or per-parameter optimizer state)."""
    flat = {}
    for name, tensor in named:
        value = tensor.detach().to("cpu", torch.float32).numpy()
        if name.endswith("weight"):
            value = np.ascontiguousarray(value.transpose(_TO_JAX[value.ndim]))
        flat[_jax_key(name)] = value
    return flat


def export_jax_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """Inverse of :func:`load_jax_params`: the model's parameters as float32
    numpy arrays in JAX layout under their pytree-path keys."""
    return export_jax_tensors(model.named_parameters())
