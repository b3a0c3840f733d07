"""Synthetic-metadata encoder: one small MLP per face-model parameter
(counterpart of ``confignet_tpu/models/synthetic_encoder.py``; reference:
confignet/dnn_models/synthetic_encoder.py).

Outputs are concatenated in the key order of ``facemodel_inputs``, which the
orchestrator has already sorted alphabetically.  One parameter can be
re-encoded alone and spliced into an existing latent
(:meth:`SyntheticDataEncoder.encode_single_param`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from benchmark.reference.blocks import MLP

FacemodelInputs = Union[Sequence[torch.Tensor], Dict[str, torch.Tensor], torch.Tensor]


class SyntheticDataEncoder(nn.Module):
    """``facemodel_inputs``: sorted sequence of (name, (input_dim, latent_dim))."""

    def __init__(self, facemodel_inputs: Tuple, num_layers: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.facemodel_inputs = tuple((name, tuple(dims)) for name, dims in facemodel_inputs)
        for name, (input_dim, latent_dim) in self.facemodel_inputs:
            self.add_module(f"mlp_{name}", MLP(num_layers, input_dim, input_dim, latent_dim,
                                               dtype=dtype))

    @property
    def param_names(self) -> List[str]:
        return [name for name, _ in self.facemodel_inputs]

    def split_stacked_input(self, stacked: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Split a stacked (B, sum(input_dims)) vector into the per-parameter
        dict (reference: synthetic_encoder.py:35-48)."""
        out = {}
        offset = 0
        for name, (input_dim, _) in self.facemodel_inputs:
            out[name] = stacked[:, offset:offset + input_dim]
            offset += input_dim
        return out

    def _normalize_inputs(self, inputs: FacemodelInputs) -> Dict[str, torch.Tensor]:
        if isinstance(inputs, dict):
            return inputs
        if isinstance(inputs, (list, tuple)):
            return dict(zip(self.param_names, inputs))
        return self.split_stacked_input(inputs)

    def forward(self, inputs: FacemodelInputs) -> torch.Tensor:
        input_dict = self._normalize_inputs(inputs)
        return torch.cat([self.encode_single_param(name, input_dict[name])
                          for name in self.param_names], dim=1)

    def encode_single_param(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """Run just one per-parameter MLP (for latent splicing)."""
        return getattr(self, f"mlp_{name}")(value)
