"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips when no CUDA device is present.  This file
imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from confignet_tpu_torch.core.transforms import euler_angles_to_matrix
from confignet_tpu_torch.ops.adain_cuda import (
    adain_route, device_limits, fused_adain,
    fused_adain_backward, fused_adain_backward_plain, fused_adain_forward, fused_adain_plain,
    fused_adain_plain_with_stats, launch_forward)
from confignet_tpu_torch.ops.rotate_cuda import (
    rotate_3d_grid_forward, rotate_3d_grid_kernel, rotate_3d_grid_kernel_train, rotate_3d_grid_plain,
    rotate_3d_grid_transpose, rotate_3d_grid_transpose_plain)

pytestmark = pytest.mark.gpu

# float32: absolute, the interpolation/statistics/transpose contracts of the
# JAX kernels (tests/test_pallas_interpret.py).  bfloat16: 3e-2 of
# max(1, |value|) -- kernel and plain version each round once to bf16, and
# one bf16 ulp is 2^-7 relative (0.03125 in [4, 8)).
TOL = {torch.float32: {"rotate": 2e-5, "adain": 1e-4, "transpose": 2e-4},
       torch.bfloat16: {"rotate": 3e-2, "adain": 3e-2, "transpose": 3e-2}}


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


def _transforms(case, batch, rng):
    """(B, 3, 3) transforms: the reference poses, or a degenerate case."""
    if case == "reference":
        return euler_angles_to_matrix(_poses(batch, rng))
    if case == "yaw90":
        return euler_angles_to_matrix(torch.tensor([[np.pi / 2, 0.0, 0.0]] * batch))
    if case == "axis90":  # 90 degrees about each axis in turn
        return euler_angles_to_matrix(torch.eye(3)[torch.arange(batch) % 3] * (np.pi / 2))
    if case == "scale2":  # most points clamped to the border
        return 2 * torch.eye(3).expand(batch, 3, 3).contiguous()
    if case == "zero":  # every point in one cell
        return torch.zeros((batch, 3, 3))
    raise ValueError(case)


ROTATE_CASES = [("reference", 16, 128), ("reference", 8, 3), ("yaw90", 16, 128),
                ("axis90", 8, 8), ("scale2", 16, 32), ("zero", 8, 8)]


def _rotate_inputs(case, size, channels, dtype, device, seed, batch=5):
    rng = np.random.default_rng(seed)
    grid = torch.from_numpy(rng.normal(size=(batch, size, size, size, channels)).astype(np.float32))
    return grid.to(device, dtype), _transforms(case, batch, rng).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,size,channels", ROTATE_CASES)
def test_rotate_kernel_matches_plain(cuda, dtype, case, size, channels):
    """The forward kernel on the slab route against its plain version, at
    the reference poses and degenerate transforms."""
    grid, transform = _rotate_inputs(case, size, channels, dtype, cuda, 0)
    want = rotate_3d_grid_plain(grid, transform)
    before = rotate_3d_grid_forward.launches
    got = rotate_3d_grid_kernel(grid, transform)
    torch.cuda.synchronize()
    assert rotate_3d_grid_forward.launches == before + 1
    assert got.dtype == dtype and got.shape == grid.shape
    err = checked_error(got, want)
    assert err <= TOL[dtype]["rotate"], err


ADAIN_SHAPES = [(4, 8, 8, 8, 256), (4, 64, 64, 32), (2, 256, 256, 16), (3, 5, 7, 48), (2, 3, 3, 5)]
# the six 256px sites as (B, P, C) at a small batch
ADAIN_SITES_256 = [(3, 512, 256), (3, 4096, 128), (3, 256, 256), (3, 1024, 64), (3, 4096, 32),
                   (3, 16384, 32)]
# the same sites at the one-shot fine-tune's batch of one photo
ADAIN_SITES_256_B1 = [(1,) + site[1:] for site in ADAIN_SITES_256]
# the 512px generator's seventh site (map_2d_2c) at the fine-tune's and the G step's batches
ADAIN_SITE_512 = [(1, 65536, 16), (12, 65536, 16)]
# the co-resident route with a short last part and a short last wave, and
# with 96 channels in groups (32 float32 or 64 bfloat16 channels, the last
# bfloat16 group half empty)
ADAIN_RESIDENT_ODD = [(7, 70001, 16), (3, 60000, 96)]


def adain_inputs(shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=shape) * 3 + 1).astype(np.float32)).to(device, dtype)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
    scale = torch.from_numpy(rng.normal(size=(shape[0], shape[-1])).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.normal(size=(shape[0], shape[-1])).astype(np.float32)).to(device, dtype)
    return x, g, scale, bias


def sum_error(got, want):
    """dscale/dbias: error over max(1, max |want|)."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ADAIN_SHAPES)
def test_adain_kernel_matches_plain(cuda, dtype, shape):
    x, _, scale, bias = adain_inputs(shape, dtype, cuda, 1)
    before = fused_adain_forward.launches
    got = fused_adain(x, scale, bias)
    torch.cuda.synchronize()
    assert fused_adain_forward.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want, want_stats = fused_adain_plain_with_stats(x, scale, bias)
    err = checked_error(got, want)
    assert err <= TOL[dtype]["adain"], err
    _, stats = fused_adain_forward(x, scale, bias)
    assert stats.dtype == torch.float32 and stats.shape == want_stats.shape
    assert sum_error(stats, want_stats) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ADAIN_SHAPES + ADAIN_SITES_256 + ADAIN_SITES_256_B1 + ADAIN_SITE_512
                         + ADAIN_RESIDENT_ODD)
def test_adain_both_forward_routes_match_plain(cuda, dtype, shape):
    """Both forward routes, the cluster route and the co-resident one, each
    on the shapes adain_route sends to it, against the plain version;
    (2, 256, 256, 16) in float32 and the 512 site take the co-resident
    route.  Two launches agree bit for bit (fixed-order merges)."""
    x, _, scale, bias = adain_inputs(shape, dtype, cuda, 5)
    batch, channels = shape[0], shape[-1]
    positions = x.numel() // (batch * channels)
    smem, sms = device_limits(x.device.index)
    picked = adain_route(batch, positions, channels, dtype, smem, sms)
    if shape == (2, 256, 256, 16) and dtype == torch.float32:
        assert picked.route == "resident"
    if shape in ADAIN_SITES_256 + ADAIN_SITES_256_B1:
        assert picked.route == "one_pass"
    if shape in ADAIN_SITE_512 + ADAIN_RESIDENT_ODD:
        assert picked.route == "resident"
    want, want_stats = fused_adain_plain_with_stats(x, scale, bias)
    got, stats = launch_forward(x, scale, bias, 1e-3, picked)
    again, stats_again = launch_forward(x, scale, bias, 1e-3, picked)
    torch.cuda.synchronize()
    assert checked_error(got, want) <= TOL[dtype]["adain"], picked
    assert sum_error(stats, want_stats) <= 1e-4, picked
    assert torch.equal(got, again) and torch.equal(stats, stats_again), picked


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ADAIN_SITES_256 + ADAIN_SITES_256_B1 + ADAIN_SHAPES + ADAIN_SITE_512
                         + ADAIN_RESIDENT_ODD)
def test_adain_backward_kernel_matches_plain(cuda, dtype, shape):
    """The backward kernel on the route adain_route picks against its plain
    version on the same saved statistics; two launches agree bit for bit
    (fixed-order sums, no atomics)."""
    x, g, scale, bias = adain_inputs(shape, dtype, cuda, 6)
    _, stats = fused_adain_forward(x, scale, bias)
    want = fused_adain_backward_plain(x, g, stats, scale, bias.dtype)
    before = fused_adain_backward.launches
    got = fused_adain_backward(x, g, stats, scale, bias.dtype)
    again = fused_adain_backward(x, g, stats, scale, bias.dtype)
    torch.cuda.synchronize()
    assert fused_adain_backward.launches == before + 2
    batch, channels = shape[0], shape[-1]
    positions = x.numel() // (batch * channels)
    if shape in ADAIN_SITE_512 + ADAIN_RESIDENT_ODD:
        assert adain_route(batch, positions, channels, dtype, *device_limits(x.device.index),
                           backward=True).route == "resident"
    for name, a, b, c in zip(("dx", "dscale", "dbias"), got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape, name
        assert torch.equal(a, b), name
        err = checked_error(a, c) if name == "dx" else sum_error(a, c)
        tol = TOL[dtype]["adain"] if name == "dx" or dtype == torch.bfloat16 else 1e-4
        assert err <= tol, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,size,channels", ROTATE_CASES)
def test_transpose_kernel_matches_plain(cuda, dtype, case, size, channels):
    """The transpose kernel on the owner-computes route against its plain
    version (index_add_ in float32).  It sums every cell in a fixed order,
    so its two launches are equal bit for bit."""
    ct, transform = _rotate_inputs(case, size, channels, dtype, cuda, 3, batch=12)
    before = rotate_3d_grid_transpose.launches
    got = rotate_3d_grid_transpose(ct, transform)
    again = rotate_3d_grid_transpose(ct, transform)
    torch.cuda.synchronize()
    assert rotate_3d_grid_transpose.launches == before + 2
    assert got.dtype == dtype and got.shape == ct.shape
    want = rotate_3d_grid_transpose_plain(ct, transform)
    assert checked_error(got, want) <= TOL[dtype]["transpose"]
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [128, 27])
def test_rotate_kernels_take_unaligned_views(cuda, dtype, channels):
    """A contiguous grid and ct that start off a 16-byte boundary go through
    the scalar edge of the 16-byte path, forward and transpose; 27 channels
    (no whole 16-byte vector) take it at any alignment."""
    rng = np.random.default_rng(9)
    shape = (3, 16, 16, 16, channels)
    n = int(np.prod(shape))
    buf = torch.from_numpy(rng.normal(size=2 * n + 1).astype(np.float32)).to(cuda, dtype)
    grid, ct = buf[1:1 + n].view(shape), buf[1 + n:].view(shape)
    assert grid.is_contiguous() and grid.data_ptr() % 16 != 0
    transform = euler_angles_to_matrix(_poses(3, rng)).to(cuda)
    got = rotate_3d_grid_forward(grid, transform)
    assert checked_error(got, rotate_3d_grid_plain(grid, transform)) <= TOL[dtype]["rotate"]
    grad = rotate_3d_grid_transpose(ct, transform)
    again = rotate_3d_grid_transpose(ct, transform)
    torch.cuda.synchronize()
    assert torch.equal(grad, again)
    want = rotate_3d_grid_transpose_plain(ct, transform)
    assert checked_error(grad, want) <= TOL[dtype]["transpose"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_backwards_match_plain_path(cuda, dtype):
    """Both autograd Functions on CUDA tensors (kernels forward; transpose
    and AdaIN backward kernels) against the same Functions on the
    CPU, where they run their plain versions."""
    rng = np.random.default_rng(4)
    grid = rng.normal(size=(4, 16, 16, 16, 32)).astype(np.float32)
    ct = rng.normal(size=grid.shape).astype(np.float32)
    x = (rng.normal(size=(4, 32, 32, 24)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    scale, bias = (rng.normal(size=(4, 24)).astype(np.float32) for _ in range(2))
    transform = euler_angles_to_matrix(_poses(4, rng))

    def run(device):
        g = torch.from_numpy(grid).to(device, dtype).requires_grad_(True)
        angles_t = transform.to(device).requires_grad_(True)
        out = rotate_3d_grid_kernel_train(g, angles_t)
        (out.float() * torch.from_numpy(ct).to(device)).sum().backward()
        xs = [torch.from_numpy(a).to(device, dt).requires_grad_(True)
              for a, dt in ((x, dtype), (scale, dtype), (bias, torch.float32))]
        (fused_adain(*xs).float() * torch.from_numpy(w).to(device)).sum().backward()
        assert torch.count_nonzero(angles_t.grad) == 0
        return [t.grad.cpu() for t in [g] + xs]

    def launches():
        return (rotate_3d_grid_forward.launches, rotate_3d_grid_transpose.launches,
                fused_adain_forward.launches, fused_adain_backward.launches)

    before = launches()
    got = run(cuda)
    torch.cuda.synchronize()
    assert launches() == tuple(n + 1 for n in before)
    want = run(torch.device("cpu"))
    for name, a, b in zip(("grid", "x", "scale", "bias"), got, want):
        assert a.dtype == b.dtype, name
        scale_of = b.float().abs().max().clamp(min=1.0).item()
        assert (a.float() - b.float()).abs().max().item() <= TOL[dtype]["adain"] * scale_of, name


def test_kernel_mode_refuses_transform_grad(cuda):
    grid = torch.zeros((2, 4, 4, 4, 8), device=cuda, requires_grad=True)
    eye = torch.eye(3, device=cuda).expand(2, 3, 3).contiguous().requires_grad_(True)
    with pytest.raises(ValueError, match="transform"):
        rotate_3d_grid_kernel(grid, eye)


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


def test_adain_backward_kernel_reads_strided_bf16_scale(cuda):
    """The backward kernel with the forward's bf16 row-view scale: dscale
    comes back bf16 and contiguous, dbias in the bias dtype."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(3, 16, 16, 24)).astype(np.float32)).to(cuda, torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    params = torch.from_numpy(rng.normal(size=(3, 2, 24)).astype(np.float32)).to(cuda, torch.bfloat16)
    scale, bias = params[:, 0], params[:, 1].float()
    assert not scale.is_contiguous()
    _, stats = fused_adain_forward(x, scale, bias)
    got = fused_adain_backward(x, g, stats, scale, bias.dtype)
    want = fused_adain_backward_plain(x, g, stats, scale.contiguous(), bias.dtype)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    assert checked_error(got[0], want[0]) <= TOL[torch.bfloat16]["adain"]
    for a, b in zip(got[1:], want[1:]):
        assert sum_error(a, b) <= TOL[torch.bfloat16]["adain"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adain_kernels_take_unaligned_views(cuda, dtype):
    """A contiguous view that starts off a 16-byte boundary goes through the
    scalar-access kernels, forward and backward."""
    rng = np.random.default_rng(8)
    shape = (3, 8, 8, 32)
    buf = torch.from_numpy(rng.normal(size=2 * np.prod(shape) + 1).astype(np.float32)).to(cuda, dtype)
    x, g = buf[1:1 + np.prod(shape)].view(shape), buf[1 + np.prod(shape):].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    scale, bias = (torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32)).to(cuda)
                   for _ in range(2))
    out, stats = fused_adain_forward(x, scale, bias)
    want, want_stats = fused_adain_plain_with_stats(x, scale, bias)
    assert checked_error(out, want) <= TOL[dtype]["adain"]
    assert sum_error(stats, want_stats) <= 1e-4
    got = fused_adain_backward(x, g, stats, scale, bias.dtype)
    want = fused_adain_backward_plain(x, g, stats, scale, bias.dtype)
    assert checked_error(got[0], want[0]) <= TOL[dtype]["adain"]
    for a, b in zip(got[1:], want[1:]):
        assert sum_error(a, b) <= TOL[dtype]["adain"]


def test_wrappers_raise_on_bad_inputs(cuda):
    grid = torch.zeros((2, 4, 4, 4, 8), device=cuda)
    eye = torch.eye(3, device=cuda).expand(2, 3, 3).contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        rotate_3d_grid_kernel(grid.transpose(1, 2), eye)
    with pytest.raises(ValueError, match="contiguous"):
        rotate_3d_grid_transpose(grid.transpose(1, 2), eye)
    with pytest.raises(TypeError):
        rotate_3d_grid_transpose(grid.half(), eye)
    with pytest.raises(TypeError):
        rotate_3d_grid_kernel(grid.half(), eye)
    with pytest.raises(ValueError, match="same CUDA device"):
        rotate_3d_grid_kernel(grid, eye.cpu())
    x = torch.zeros((2, 4, 4, 8), device=cuda)
    with pytest.raises(ValueError, match="scale"):
        fused_adain(x, torch.zeros((2, 4), device=cuda), torch.zeros((2, 8), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fused_adain(x.transpose(1, 2), torch.zeros((2, 8), device=cuda), torch.zeros((2, 8), device=cuda))
