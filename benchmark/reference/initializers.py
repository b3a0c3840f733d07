"""Parameter initialisers with the JAX package's distributions (flax's
``glorot_uniform`` and ``he_normal``), drawn from an explicit
``torch.Generator``.

Every module that owns parameters defines ``reset_parameters(generator)``;
:func:`initialize` calls it on a whole module tree in registration order,
so one seeded generator gives the same weights on every device.  The
numbers differ from ``jax.random``'s; tests that compare the two packages
copy weights across instead (core/model_io.py).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def _fans(weight: torch.Tensor):
    """(fan_in, fan_out) of a torch-layout kernel: (out, in, *taps)."""
    receptive = math.prod(weight.shape[2:]) if weight.ndim > 2 else 1
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def init_kernel_(weight: torch.Tensor, kind: str, generator: Optional[torch.Generator]) -> None:
    """Fill a Dense/Conv kernel in place: "glorot_uniform", "he_normal"
    (a normal truncated at two standard deviations, as flax's) or "zeros"."""
    with torch.no_grad():
        if kind == "zeros":
            weight.zero_()
            return
        fan_in, fan_out = _fans(weight)
        if kind == "glorot_uniform":
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            weight.uniform_(-limit, limit, generator=generator)
        elif kind == "he_normal":
            # flax: variance_scaling(2, "fan_in", "truncated_normal"); the
            # constant is the std of a unit normal truncated to [-2, 2].
            std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
            lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
            hi = 0.5 * (1 + math.erf(2 / math.sqrt(2)))
            weight.uniform_(lo, hi, generator=generator)
            weight.mul_(2).sub_(1).erfinv_().mul_(math.sqrt(2) * std)
        else:
            raise ValueError(f"unknown kernel init {kind!r}")


def initialize(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter of ``module`` from ``generator``."""
    for sub in module.modules():
        if hasattr(sub, "reset_parameters"):
            sub.reset_parameters(generator)
    return module
