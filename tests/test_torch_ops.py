"""The port's ops (confignet_tpu_torch.ops, core.transforms) against the JAX
package on the CPU: the same numpy inputs through both, weights copied
across with load_jax_params.  The kernels' CPU paths are their plain
versions; the JAX side runs its Pallas kernels in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confignet_tpu.core import transforms as jax_transforms
from confignet_tpu.ops.adain_pallas import fused_adain as jax_fused_adain
from confignet_tpu.ops.conv3d import Conv3d as JaxConv3d
from confignet_tpu.ops.norms import adain_modulate as jax_adain_modulate
from confignet_tpu.ops.rotate_pallas import rotate_3d_grid_pallas
from confignet_tpu.ops.upconv import UpConv as JaxUpConv
from confignet_tpu_torch.core import transforms
from confignet_tpu_torch.core.model_io import load_jax_params
from confignet_tpu_torch.ops.adain_cuda import fused_adain, fused_adain_plain
from confignet_tpu_torch.ops.conv3d import Conv3d
from confignet_tpu_torch.ops.norms import adain_modulate
from confignet_tpu_torch.ops.rotate_cuda import rotate_3d_grid_kernel, rotate_3d_grid_plain
from confignet_tpu_torch.ops.upconv import UpConv

torch.set_num_threads(1)


def _flat(params):
    return {k: np.asarray(v) for k, v in params.items()}


def poses(batch, rng):
    """The reference pose distribution (yaw +-30deg, pitch +-10deg, roll 0),
    with row 0 the zero rotation (floor == ceil at the borders), row 1 yaw
    90deg (lands within an ulp of the lattice) and row 2 yaw 45deg + pitch
    10deg (corners leave the volume: clamping)."""
    rot = rng.uniform(-1, 1, size=(batch, 3)) * np.array([np.pi / 6, np.pi / 18, 0.0])
    rot[0] = 0.0
    rot[1] = [np.pi / 2, 0.0, 0.0]
    rot[2] = [np.pi / 4, np.pi / 18, 0.0]
    return rot.astype(np.float32)


def rotation_case(size=8, channels=8, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(batch, size, size, size, channels)).astype(np.float32)
    return grid, poses(batch, rng)


# ---------------------------------------------------------------------------
# AdaIN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 16, 16, 32), (2, 8, 8, 8, 16)])
def test_adain_plain_matches_jax_f32(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    scale = rng.normal(size=(shape[0], shape[-1])).astype(np.float32)
    bias = rng.normal(size=(shape[0], shape[-1])).astype(np.float32)
    axes = tuple(range(1, len(shape) - 1))
    want_xla = np.asarray(jax_adain_modulate(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), axes))
    want_pallas = np.asarray(jax_fused_adain(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-3, True))
    tx, ts, tb = map(torch.from_numpy, (x, scale, bias))
    for got in (fused_adain_plain(tx, ts, tb), fused_adain(tx, ts, tb),
                adain_modulate(tx, ts, tb, axes), adain_modulate(tx, ts, tb, axes, impl="kernel")):
        np.testing.assert_allclose(got.numpy(), want_xla, atol=2e-5)
        np.testing.assert_allclose(got.numpy(), want_pallas, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (2, 4, 4, 4, 16)])
def test_adain_plain_matches_jax_bf16(shape):
    """bf16 x with f32 scale/bias: output bf16, within 3e-2 of the Pallas
    kernel (the tolerance of tests/test_pallas_interpret.py)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    scale = rng.normal(size=(shape[0], shape[-1])).astype(np.float32)
    bias = rng.normal(size=(shape[0], shape[-1])).astype(np.float32)
    want = np.asarray(jax_fused_adain(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                                      jnp.asarray(bias), 1e-3, True), np.float32)
    got = fused_adain(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_adain_partial_axes_stays_plain():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    scale = rng.normal(size=(2, 8)).astype(np.float32)
    bias = rng.normal(size=(2, 8)).astype(np.float32)
    want = np.asarray(jax_adain_modulate(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), (1,)))
    got = adain_modulate(*map(torch.from_numpy, (x, scale, bias)), spatial_axes=(1,), impl="kernel")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


# ---------------------------------------------------------------------------
# Rotation
# ---------------------------------------------------------------------------

def test_euler_matrix_matches_jax():
    rot = poses(6, np.random.default_rng(4))
    want = np.asarray(jax_transforms.euler_angles_to_matrix(jnp.asarray(rot)))
    got = transforms.euler_angles_to_matrix(torch.from_numpy(rot)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_source_coords_match_jax():
    grid, rot = rotation_case()
    mats = np.array(jax_transforms.euler_angles_to_matrix(jnp.asarray(rot)))
    jf, jc, jd = jax_transforms._source_coords(jnp.asarray(grid), jnp.asarray(mats))
    tf, tc, td = transforms._source_coords(torch.from_numpy(grid), torch.from_numpy(mats))
    # a point within an ulp of a cell border may land in either cell; the
    # interpolation is continuous there, so compare the source position
    np.testing.assert_allclose(tf.numpy() + td.numpy(), np.asarray(jf) + np.asarray(jd), atol=1e-5)
    assert tc.dtype == torch.int32 and np.all(tc.numpy() <= grid.shape[1] - 1)


@pytest.mark.parametrize("channels", [8, 3])
def test_rotation_gather_and_plain_match_jax(channels):
    """Gather form and the kernel's plain version against the JAX gather
    form, the Pallas kernel in interpret mode and the numpy oracle, atol
    2e-5 (the kernel contract of tests/test_pallas_interpret.py)."""
    grid, rot = rotation_case(channels=channels)
    mats = np.array(jax_transforms.euler_angles_to_matrix(jnp.asarray(rot)))
    wants = [
        np.asarray(jax_transforms.rotate_3d_grid(jnp.asarray(grid), jnp.asarray(mats))),
        np.asarray(rotate_3d_grid_pallas(jnp.asarray(grid), jnp.asarray(mats), interpret=True)),
        jax_transforms.rotate_3d_grid_reference_numpy(grid, mats),
    ]
    tg, tm = torch.from_numpy(grid), torch.from_numpy(mats)
    for got in (transforms.rotate_3d_grid(tg, tm), rotate_3d_grid_plain(tg, tm),
                rotate_3d_grid_kernel(tg, tm)):
        for want in wants:
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_rotation_plain_bf16_accumulates_in_f32():
    grid, rot = rotation_case(seed=5)
    mats = transforms.euler_angles_to_matrix(torch.from_numpy(rot))
    g16 = torch.from_numpy(grid).bfloat16()
    got = rotate_3d_grid_kernel(g16, mats)
    assert got.dtype == torch.bfloat16
    want = jax_transforms.rotate_3d_grid_reference_numpy(g16.float().numpy(), mats.numpy())
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_rotation_gather_is_differentiable_in_transform():
    grid, rot = rotation_case(batch=3, seed=6)
    angles = torch.from_numpy(rot).requires_grad_(True)
    out = transforms.rotate_3d_grid(torch.from_numpy(grid), transforms.euler_angles_to_matrix(angles))
    out.square().sum().backward()
    assert torch.isfinite(angles.grad).all() and angles.grad[:, :2].abs().sum() > 0


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel_size,shape", [((3, 3, 3), (2, 4, 4, 4, 6)), ((4, 4), (2, 8, 8, 6))])
def test_upconv_subpixel_equals_naive_equals_jax(kernel_size, shape):
    """k=3 (3D) and k=4 (2D, whose SAME padding is 1 before, 2 after)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    jmod = JaxUpConv(features=5, kernel_size=kernel_size, impl="naive")
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = dict(params, bias=jnp.asarray(rng.normal(size=(5,)), jnp.float32))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    for impl in ("subpixel", "naive"):
        mod = UpConv(shape[-1], 5, kernel_size, impl=impl)
        load_jax_params(mod, _flat(params))
        with torch.no_grad():
            got = mod(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_upconv_bf16_collapses_promoted_taps():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    jmod = JaxUpConv(features=3, kernel_size=(4, 4), dtype=jnp.bfloat16, impl="subpixel")
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)), np.float32)
    mod = UpConv(4, 3, (4, 4), dtype=torch.bfloat16)
    load_jax_params(mod, _flat(params))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2)


def test_conv3d_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 6, 6, 6, 5)).astype(np.float32)
    jmod = JaxConv3d(features=7, kernel_size=(3, 3, 3))
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    params = dict(params, bias=jnp.asarray(rng.normal(size=(7,)), jnp.float32))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = Conv3d(5, 7, (3, 3, 3))
    load_jax_params(mod, _flat(params))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
