"""Package rules of the port: it imports nothing of JAX, flax or the JAX
package, and its entry points run on the GPU unless told otherwise."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from helpers import TINY_FIRST_STAGE_CONFIG

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "confignet_tpu")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_no_jax():
    files = sorted((REPO / "confignet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                                     REPO / "chip_ab.py"]
    assert len(files) > 10
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


# what the card's machine lacks: imported only inside the functions that use it
LAZY = ("cv2", "matplotlib", "h5py")


def test_importing_the_port_leaves_jax_unloaded():
    """The port's modules and chip_smoke.py's imports load neither JAX nor
    the JAX package, nor cv2, matplotlib or h5py.  This pytest process has
    JAX loaded already (tests/conftest.py), so the check runs in a fresh
    interpreter."""
    code = ("import sys, confignet_tpu_torch.serving, confignet_tpu_torch.training.second_stage, "
            "confignet_tpu_torch.training.latent_gan, confignet_tpu_torch.core.pickles, "
            "confignet_tpu_torch.metrics.controllability, confignet_tpu_torch.metrics.inception, "
            "confignet_tpu_torch.data.dataset, confignet_tpu_torch.data.procedural, "
            "confignet_tpu_torch.apps.evaluate_confignet_controllability, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in %r]; "
            "print(bad); sys.exit(1 if bad else 0)" % (FORBIDDEN + LAZY,))
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stdout + result.stderr


def test_distribution_pickle_round_trip_leaves_jax_unloaded(tmp_path):
    """The port writes a pickle under the JAX package's class names and
    reads it back in a fresh interpreter without loading either."""
    code = ("import pickle, sys, numpy as np; "
            "from confignet_tpu_torch.core.pickles import read_pickle, write_pickle; "
            "from confignet_tpu_torch.data.distributions import fit_distribution; "
            "d = {k: fit_distribution(np.random.default_rng(0).normal(size=(20, 3)), k) "
            "for k in ('GMM', 'one_hot', 'exemplar')}; "
            "write_pickle(d, sys.argv[1]); back = read_pickle(sys.argv[1]); "
            "assert {k: type(v) for k, v in back.items()} == {k: type(v) for k, v in d.items()}; "
            "assert b'confignet_tpu.data.distributions' in open(sys.argv[1], 'rb').read(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in %r]; "
            "print(bad); sys.exit(1 if bad else 0)" % (FORBIDDEN,))
    result = subprocess.run([sys.executable, "-c", code, str(tmp_path / "d.pck")], cwd=REPO,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stdout + result.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from confignet_tpu_torch.serving import ConfigNetServer
    from confignet_tpu_torch.training.second_stage import ConfigNet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ConfigNet(dict(TINY_FIRST_STAGE_CONFIG))
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ConfigNetServer(model)


def test_kernel_wrappers_refuse_non_cuda_devices():
    """A wrapper takes its plain version only for CPU tensors; anything else
    that is not CUDA raises instead of falling back."""
    from confignet_tpu_torch.ops.adain_cuda import fused_adain
    from confignet_tpu_torch.ops.rotate_cuda import rotate_3d_grid_kernel, rotate_3d_grid_transpose

    meta = torch.empty((1, 4, 4, 4, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rotate_3d_grid_kernel(meta, torch.empty((1, 3, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        rotate_3d_grid_transpose(meta, torch.empty((1, 3, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        fused_adain(meta, torch.empty((1, 2), device="meta"), torch.empty((1, 2), device="meta"))
