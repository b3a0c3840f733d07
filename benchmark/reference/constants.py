"""Small constant tensors built once per (name, dtype, device).

The JAX package's constants (the VGG/ResNet channel means, the up-conv tap
matrices, the resample's lattice coordinates) are folded into the compiled
step; eager PyTorch would copy each from the host on every call.  Here each
is built on its device the first time it is asked for and reused after.
The tensors are shared: callers must not write to them.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import numpy as np
import torch

_cache: Dict[Tuple[Hashable, torch.dtype, torch.device], torch.Tensor] = {}


def device_constant(name: Hashable, make: Callable[[], np.ndarray], dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """The constant ``make()`` as a ``dtype`` tensor on ``device``, made on
    the first call for this (name, dtype, device).  It is built outside
    inference mode, so autograd may save it for a backward pass whatever
    mode the first caller ran in."""
    key = (name, dtype, torch.device(device))
    tensor = _cache.get(key)
    if tensor is None:
        with torch.inference_mode(False):
            tensor = torch.as_tensor(np.asarray(make()), dtype=dtype, device=device)
        _cache[key] = tensor
    return tensor
