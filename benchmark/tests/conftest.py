"""Shared fixtures of the benchmark's own tests: a CPU size of the
256px configuration and the cells at that size."""
from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

from benchmark.harness.core import load_cell

TINY = json.loads((Path(__file__).parent / "data" / "confignet_tiny.json").read_text())
# CPU sizes of the cells' traffic: small pools and chunks, few checked requests
TINY_TRAFFIC = {"serve_256_interactive": dict(photo_pool=16, frames_per_session=12, key_every=2,
                                              check_sessions=2, check_frames=3),
                "serve_512_bulk": dict(photo_pool=16, chunk=4, check_sample=2,
                                       photos_per_request={"uniform": [3, 9], "strata": 4}),
                "train_256_stage2": dict(real_images=16, synth_images=16)}


def tiny_cell(name: str):
    """The cell ``name`` with the CPU configuration and traffic sizes."""
    cell = load_cell(name)
    cell.config = copy.deepcopy(TINY)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC[name])
    return cell


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def gpu():
    """The card, or a skip: decided here, never while a module is imported.
    TF32 is off while the test runs, as a benchmark run turns it off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
