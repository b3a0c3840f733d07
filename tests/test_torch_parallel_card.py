"""CPU ranks launched by torchrun on a machine with a card.

The training CLI run as ``torchrun ... --device cpu`` initialises its group
with ``maybe_initialize_distributed("cpu")``; the backend must follow the
device, so the ranks run over gloo and their collectives take CPU tensors
although CUDA is visible.  Two ranks of ``tests/torch_parallel_child.py``
run the primitives under torchrun and are held to numpy.

Marked ``gpu``; skips when no CUDA device is present.  This file imports
neither JAX nor the JAX package, so it also runs on a machine without them:
python -m pytest --noconftest -m gpu tests/test_torch_parallel_card.py
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

REPO = Path(__file__).resolve().parent.parent
CHILD = REPO / "tests" / "torch_parallel_child.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cpu_ranks_beside_a_card_run_over_gloo(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    inputs = {"x": rng.normal(size=(8, 3, 5)).astype(np.float32),
              "x1": rng.normal(size=(2, 8, 4)).astype(np.float32)}
    for rank in range(2):
        inputs[f"rank{rank}"] = rng.normal(size=(3, 5)).astype(np.float32)
        inputs[f"c{rank}"] = rng.normal(size=(3, 5)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **inputs)
    (tmp_path / "config.json").write_text(json.dumps({}))
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         "--master_addr=127.0.0.1", f"--master_port={_free_port()}", str(CHILD), "primitives",
         str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]

    stacked = np.stack([inputs["rank0"], inputs["rank1"]])
    for rank in range(2):
        with np.load(tmp_path / f"result_{rank}.npz") as npz:
            result = dict(npz)
        assert str(result["backend"]) == "gloo"
        np.testing.assert_array_equal(result["shard/a"], inputs["x"][4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(result["replicate/w"], inputs["rank0"])
        np.testing.assert_allclose(result["mean/f32"], stacked.mean(0), rtol=1e-6)
        np.testing.assert_array_equal(result["gather"], inputs["x"])
        np.testing.assert_allclose(result["sum/grad"], inputs["c0"] + inputs["c1"], rtol=1e-6)
