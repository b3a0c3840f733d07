"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips when no CUDA device is present.  This file
imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from confignet_tpu_torch.core.transforms import euler_angles_to_matrix
from confignet_tpu_torch.ops.adain_cuda import fused_adain, fused_adain_plain
from confignet_tpu_torch.ops.rotate_cuda import rotate_3d_grid_kernel, rotate_3d_grid_plain

pytestmark = pytest.mark.gpu

# float32: absolute, the interpolation/statistics contracts of the JAX
# kernels (tests/test_pallas_interpret.py).  bfloat16: 3e-2 of
# max(1, |value|) -- kernel and plain version each round once to bf16, and
# one bf16 ulp is 2^-7 relative (0.03125 in [4, 8)).
TOL = {torch.float32: {"rotate": 2e-5, "adain": 1e-4}, torch.bfloat16: {"rotate": 3e-2, "adain": 3e-2}}


def checked_error(got, want):
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        diff = diff / want.float().abs().clamp(min=1.0)
    return diff.max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _poses(batch, rng):
    rot = rng.uniform(-1, 1, size=(batch, 3)) * np.array([np.pi / 6, np.pi / 18, 0.0])
    rot[0] = 0.0
    rot[-1] = [np.pi / 2, 0.0, 0.0]
    return torch.from_numpy(rot.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size,channels", [(16, 128), (8, 3)])
def test_rotate_kernel_matches_plain(cuda, dtype, size, channels):
    rng = np.random.default_rng(0)
    grid = torch.from_numpy(rng.normal(size=(5, size, size, size, channels)).astype(np.float32))
    grid = grid.to(cuda, dtype)
    transform = euler_angles_to_matrix(_poses(5, rng)).to(cuda)
    before = rotate_3d_grid_kernel.launches
    got = rotate_3d_grid_kernel(grid, transform)
    torch.cuda.synchronize()
    assert rotate_3d_grid_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == grid.shape
    err = checked_error(got, rotate_3d_grid_plain(grid, transform))
    assert err <= TOL[dtype]["rotate"], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 8, 8, 8, 256), (4, 64, 64, 32), (2, 256, 256, 16), (3, 5, 7, 48),
                                   (2, 3, 3, 5)])
def test_adain_kernel_matches_plain(cuda, dtype, shape):
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=shape) * 3 + 1).astype(np.float32)).to(cuda, dtype)
    scale = torch.from_numpy(rng.normal(size=(shape[0], shape[-1])).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(size=(shape[0], shape[-1])).astype(np.float32)).to(cuda, dtype)
    before = fused_adain.launches
    got = fused_adain(x, scale, bias)
    torch.cuda.synchronize()
    assert fused_adain.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    err = checked_error(got, fused_adain_plain(x, scale, bias))
    assert err <= TOL[dtype]["adain"], err


def test_adain_kernel_reads_strided_bf16_params(cuda):
    """scale/bias as the AdaIN module passes them: bf16 row views of one
    (B, 2, C) MLP output, read without a copy."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, 16, 16, 24)).astype(np.float32)).to(cuda, torch.bfloat16)
    params = torch.from_numpy(rng.normal(size=(3, 2, 24)).astype(np.float32)).to(cuda, torch.bfloat16)
    scale, bias = params[:, 0], params[:, 1]
    assert not scale.is_contiguous()
    err = checked_error(fused_adain(x, scale, bias), fused_adain_plain(x, scale, bias))
    assert err <= TOL[torch.bfloat16]["adain"], err


def test_wrappers_raise_on_bad_inputs(cuda):
    grid = torch.zeros((2, 4, 4, 4, 8), device=cuda)
    eye = torch.eye(3, device=cuda).expand(2, 3, 3).contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        rotate_3d_grid_kernel(grid.transpose(1, 2), eye)
    with pytest.raises(TypeError):
        rotate_3d_grid_kernel(grid.half(), eye)
    with pytest.raises(ValueError, match="same CUDA device"):
        rotate_3d_grid_kernel(grid, eye.cpu())
    x = torch.zeros((2, 4, 4, 8), device=cuda)
    with pytest.raises(ValueError, match="scale"):
        fused_adain(x, torch.zeros((2, 4), device=cuda), torch.zeros((2, 8), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fused_adain(x.transpose(1, 2), torch.zeros((2, 8), device=cuda), torch.zeros((2, 8), device=cuda))
