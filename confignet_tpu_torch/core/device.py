"""Device selection for the port's entry points."""
from __future__ import annotations

import functools
import subprocess
from typing import Optional, Union

import torch


@functools.lru_cache(maxsize=None)
def card_line() -> str:
    """The first card's name and power limit as nvidia-smi prints them."""
    result = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60, check=True)
    return result.stdout.strip().splitlines()[0]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Without a GPU, ``cuda`` (named or by default) raises rather
    than falling back to the CPU, so a run never measures the wrong device."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device
