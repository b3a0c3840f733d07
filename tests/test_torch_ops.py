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
from confignet_tpu.ops import norms as jax_norms
from confignet_tpu.ops.adain_pallas import _spatial_stats
from confignet_tpu.ops.adain_pallas import fused_adain as jax_fused_adain
from confignet_tpu.ops.conv3d import Conv3d as JaxConv3d
from confignet_tpu.ops.norms import adain_modulate as jax_adain_modulate
from confignet_tpu.ops.rotate_pallas import _pack_point_inputs, _rotate_grad_grid, rotate_3d_grid_pallas
from confignet_tpu.ops.upconv import UpConv as JaxUpConv
from benchmark.counts.kernels import adain_sites, rotation_volume
from confignet_tpu_torch.core import transforms
from confignet_tpu_torch.core.model_io import load_jax_params
from confignet_tpu_torch.ops import norms
from confignet_tpu_torch.ops.adain_cuda import (
    adain_resident_plan, adain_route, fused_adain, fused_adain_backward,
    fused_adain_backward_plain, fused_adain_plain, fused_adain_plain_with_stats)
from confignet_tpu_torch.ops.conv3d import Conv3d, conv_channels_last
from confignet_tpu_torch.ops.norms import adain_modulate
from confignet_tpu_torch.ops.rotate_cuda import (
    rotate_3d_grid_kernel, rotate_3d_grid_kernel_train, rotate_3d_grid_plain,
    rotate_3d_grid_transpose_plain, rotate_plan)
from confignet_tpu_torch.training.first_stage import DEFAULT_CONFIG
from confignet_tpu_torch.ops.upconv import UpConv

torch.set_num_threads(1)

H100 = (232448, 132)  # opt-in shared memory per block, SMs


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


def _adain_oracle(x, scale, bias, eps=1e-3):
    normed = jax_norms.spatial_instance_norm(x, tuple(range(1, x.ndim - 1)), eps)
    shape = [x.shape[0]] + [1] * (x.ndim - 2) + [x.shape[-1]]
    return normed * (jnp.reshape(scale, shape) + 1.0) + jnp.reshape(bias, shape)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (2, 4, 4, 4, 8)])
def test_adain_function_gradients_match_jax(shape):
    """The autograd Function's backward (plain bodies on the CPU) against the
    JAX custom VJP around the Pallas kernel (interpret mode) and against
    autodiff of the XLA composition, atol/rtol 1e-4
    (tests/test_pallas_interpret.py)."""
    rng = np.random.default_rng(2)
    x, w = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    scale, bias = (rng.normal(size=(shape[0], shape[-1])).astype(np.float32) for _ in range(2))
    jargs = tuple(map(jnp.asarray, (x, scale, bias)))
    want_vjp = jax.grad(lambda *a: jnp.sum(jax_fused_adain(*a, 1e-3, True) * w), argnums=(0, 1, 2))(*jargs)
    want_ad = jax.grad(lambda *a: jnp.sum(_adain_oracle(*a) * w), argnums=(0, 1, 2))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    out = fused_adain(*targs)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for got, a, b in zip(targs, want_vjp, want_ad):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(a), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


def test_adain_function_cotangent_dtypes():
    """Each cotangent in its own primal's dtype: bf16 x, bf16 scale, f32
    bias (tests/test_pallas_interpret.py:140-156)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 4, 4, 8)).astype(np.float32)).bfloat16().requires_grad_(True)
    scale = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32)).bfloat16().requires_grad_(True)
    bias = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32)).requires_grad_(True)
    fused_adain(x, scale, bias).float().sum().backward()
    assert (x.grad.dtype, scale.grad.dtype, bias.grad.dtype) == (torch.bfloat16, torch.bfloat16,
                                                                  torch.float32)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (2, 4, 4, 4, 8), (3, 5, 7, 6)])
def test_adain_plain_stats_match_jax(shape):
    """The plain forward's saved statistics (mean, rstd) against JAX's
    _spatial_stats, and its output against the plain version's."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    scale, bias = (rng.normal(size=(shape[0], shape[-1])).astype(np.float32) for _ in range(2))
    mean, var = _spatial_stats(jnp.asarray(x).reshape(shape[0], -1, shape[-1]))
    out, stats = fused_adain_plain_with_stats(*map(torch.from_numpy, (x, scale, bias)))
    assert stats.dtype == torch.float32 and stats.shape == (shape[0], 2, shape[-1])
    np.testing.assert_allclose(stats[:, 0].numpy(), np.asarray(mean)[:, 0], atol=1e-6)
    np.testing.assert_allclose(stats[:, 1].numpy(), np.asarray(jax.lax.rsqrt(var + 1e-3))[:, 0],
                               rtol=1e-5)
    assert torch.equal(out, fused_adain_plain(*map(torch.from_numpy, (x, scale, bias))))


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (2, 4, 4, 4, 8), (3, 5, 7, 6)])
def test_adain_backward_plain_matches_jax_vjp(shape):
    """fused_adain_backward_plain fed the plain forward's saved statistics,
    against jax.grad through the Pallas kernel's custom VJP (interpret
    mode), atol/rtol 1e-4 (tests/test_pallas_interpret.py:105-123)."""
    rng = np.random.default_rng(6)
    x, w = ((rng.normal(size=shape) * 3 + 1).astype(np.float32) for _ in range(2))
    scale, bias = (rng.normal(size=(shape[0], shape[-1])).astype(np.float32) for _ in range(2))
    want = jax.grad(lambda *a: jnp.sum(jax_fused_adain(*a, 1e-3, True) * w),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (x, scale, bias)))
    tx, ts, tb = map(torch.from_numpy, (x, scale, bias))
    _, stats = fused_adain_plain_with_stats(tx, ts, tb)
    got = fused_adain_backward_plain(tx, torch.from_numpy(w), stats, ts, tb.dtype)
    wrapped = fused_adain_backward(tx, torch.from_numpy(w), stats, ts, tb.dtype)  # CPU: plain
    assert all(torch.equal(a, b) for a, b in zip(got, wrapped))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cotangent", ["bfloat16", "float32"])
def test_adain_backward_plain_mixed_dtypes_match_jax(cotangent):
    """bf16 x and scale, f32 bias: each cotangent in its own primal's dtype,
    as in JAX (tests/test_pallas_interpret.py:140-156), and within 3e-2 of
    max(1, |value|) of JAX's, whose bf16 output cotangent (or an f32 one,
    cast to the output's bf16 as autograd does) is the same."""
    rng = np.random.default_rng(7)
    shape = (2, 6, 6, 16)
    x, w = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    scale, bias = (rng.normal(size=(2, 16)).astype(np.float32) for _ in range(2))
    jx, js = jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, s, b: jax_fused_adain(a, s, b, 1e-3, True), jx, js, jnp.asarray(bias))
    want = vjp(jnp.asarray(w, jnp.bfloat16))
    tx, ts = torch.from_numpy(x).bfloat16(), torch.from_numpy(scale).bfloat16()
    _, stats = fused_adain_plain_with_stats(tx, ts, torch.from_numpy(bias))
    g = torch.from_numpy(w).to(getattr(torch, cotangent)).bfloat16()
    got = fused_adain_backward_plain(tx, g, stats, ts, torch.float32)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    assert [str(t.dtype) for t in want] == ["bfloat16", "bfloat16", "float32"]
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        err = np.abs(a.float().numpy() - b) / np.maximum(1.0, np.abs(b))
        assert err.max() <= 3e-2, err.max()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adain_route_takes_one_pass_at_256px(dtype, backward):
    """Under an H100's 227 KB of opt-in shared memory per block and 132
    SMs, every 256px AdaIN site at the main path's batches
    (the fine-tune's 1 too) takes the one-pass cluster route, within the
    card's limits; the 512px site does not fit a cluster and takes one pass
    over co-resident blocks, its grid one block per SM at most; a slab
    larger than the card's SMs hold is refused."""
    sites = ((512, 256), (4096, 128), (256, 256), (1024, 64), (4096, 32), (16384, 32))
    for batch in (1, 12, 24, 32, 256):
        for positions, channels in sites:
            plan = adain_route(batch, positions, channels, dtype, *H100, backward)
            assert plan.route == "one_pass", (batch, positions, channels, plan)
            assert plan.parts in (1, 2, 4, 8, 16) and plan.group % plan.vec == 0, plan
            assert plan.shared_bytes <= (232448 // 2 if plan.parts > 8 else 232448), plan
            assert plan.vec == 16 // torch.empty((), dtype=dtype).element_size()
    resident = adain_route(256, 65536, 16, torch.float32, *H100, backward)
    assert resident == adain_resident_plan(256, 65536, 16, torch.float32, *H100, backward)
    assert resident.route == "resident" and resident.shared_bytes <= H100[0], resident
    assert resident.wave * resident.parts <= H100[1]
    elem = torch.empty((), dtype=dtype).element_size()
    larger = H100[0] * H100[1] // (16 * elem) + 1  # rows of 16 channels: more than the SMs hold
    assert adain_resident_plan(2, larger, 16, dtype, *H100, backward) is None
    with pytest.raises(ValueError, match=f"\\({larger}, 16\\)"):
        adain_route(2, larger, 16, dtype, *H100, backward)
    odd = adain_route(2, 9, 5, dtype, *H100, backward)
    assert (odd.route, odd.group, odd.vec, odd.parts) == ("one_pass", 5, 1, 1)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("size", [128, 256, 512])
def test_every_generator_launch_has_a_kernel_route(size, sms, dtype, backward):
    """Every AdaIN site and the rotation volume of the 128, 256 and 512px
    generators (derived from the config as the benchmark's kernel counts
    derive them), at batches 1 to 256, get a plan on H100 SXM (132 SMs) and
    PCIe (114 SMs) cards: the cluster or co-resident route for AdaIN, the
    slab forward or the owner-computes transpose for the rotation, each
    within the card's limits.  No launch of the port falls outside the
    kernels' range, where the planners raise."""
    model = dict(DEFAULT_CONFIG, output_shape=(size, size, 3))
    smem = H100[0]
    side, volume_channels = rotation_volume(model)
    for batch in (1, 6, 12, 24, 32, 64, 128, 256):
        for positions, channels in adain_sites(model):
            plan = adain_route(batch, positions, channels, dtype, smem, sms, backward)
            assert plan.shared_bytes <= smem and channels % plan.vec == 0, plan
            if plan.route == "one_pass":
                assert plan.parts <= 16, plan
            else:
                assert plan.route == "resident" and plan.wave * plan.parts <= sms, plan
        rotation = rotate_plan(batch, side, volume_channels, dtype, smem, sms,
                               transpose=backward)
        assert 0 < rotation.shared_bytes <= smem and rotation.blocks >= batch, rotation


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


@pytest.mark.parametrize("size,channels,batch,seed", [(8, 4, 2, 2), (8, 8, 3, 0)])
def test_rotation_transpose_plain_matches_jax(size, channels, batch, seed):
    """The transpose kernel's plain version against the Pallas transpose in
    interpret mode and against jax.grad of the gather form, atol 2e-4 (the
    contract of tests/test_pallas_interpret.py:41-62); the poses include the
    zero rotation (floor == ceil at the borders, two corners on one cell)."""
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(batch, size, size, size, channels)).astype(np.float32)
    rot = rng.uniform(-1, 1, size=(batch, 3)) * np.array([np.pi / 6, np.pi / 18, 0.0])
    rot[0] = 0.0
    mats = jax_transforms.euler_angles_to_matrix(jnp.asarray(rot, jnp.float32))
    ct = rng.normal(size=grid.shape).astype(np.float32)
    want_grad = jax.grad(lambda g: jnp.sum(jax_transforms.rotate_3d_grid(g, mats) * ct))(jnp.asarray(grid))
    f, c, d = jax_transforms._source_coords(jnp.asarray(grid), mats)
    pidx, sidx, frac = _pack_point_inputs(f, c, d, size)
    want_pallas = _rotate_grad_grid(jnp.asarray(ct).reshape(batch, size ** 3, channels), pidx, sidx,
                                    frac, size=size, point_block=256, interpret=True)
    got = rotate_3d_grid_transpose_plain(torch.from_numpy(ct), torch.from_numpy(np.array(mats)))
    assert got.dtype == torch.float32 and got.shape == grid.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want_grad), atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas).reshape(grid.shape), atol=2e-4)


def test_rotation_functions_backward_on_cpu():
    """The autograd Function (plain bodies on the CPU): the grid gradient
    equals torch autodiff of the gather form; kernel_train gives the
    transform a zero gradient; kernel refuses a transform that requires
    grad."""
    grid, rot = rotation_case(batch=3, seed=7)
    ct = torch.from_numpy(np.random.default_rng(8).normal(size=grid.shape).astype(np.float32))
    angles = torch.from_numpy(rot).requires_grad_(True)
    want = torch.from_numpy(grid).requires_grad_(True)
    (transforms.rotate_3d_grid(want, transforms.euler_angles_to_matrix(angles.detach())) * ct).sum().backward()
    for fn in (rotate_3d_grid_kernel, rotate_3d_grid_kernel_train):
        g = torch.from_numpy(grid).requires_grad_(True)
        out = fn(g, transforms.euler_angles_to_matrix(angles.detach()))
        assert out.grad_fn is not None
        (out * ct).sum().backward()
        np.testing.assert_allclose(g.grad.numpy(), want.grad.numpy(), atol=2e-5)

    g = torch.from_numpy(grid).requires_grad_(True)
    (rotate_3d_grid_kernel_train(g, transforms.euler_angles_to_matrix(angles)) * ct).sum().backward()
    assert torch.count_nonzero(angles.grad) == 0 and torch.count_nonzero(g.grad) > 0
    with pytest.raises(ValueError, match="transform"):
        rotate_3d_grid_kernel(g, transforms.euler_angles_to_matrix(angles))
    with torch.no_grad():  # nothing to differentiate: the kernel path is fine
        rotate_3d_grid_kernel(g, transforms.euler_angles_to_matrix(angles))


def test_rotation_gather_is_differentiable_in_transform():
    grid, rot = rotation_case(batch=3, seed=6)
    angles = torch.from_numpy(rot).requires_grad_(True)
    out = transforms.rotate_3d_grid(torch.from_numpy(grid), transforms.euler_angles_to_matrix(angles))
    out.square().sum().backward()
    assert torch.isfinite(angles.grad).all() and angles.grad[:, :2].abs().sum() > 0


# ---------------------------------------------------------------------------
# Discriminator norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 6, 5, 4), (2, 4, 3, 5, 6)])
def test_std_instance_norm_and_layer_style_match_jax(shape):
    """eps 1e-3 outside the sqrt (std_instance_norm), 1e-6 inside
    (layer_style); atol 2e-6."""
    rng = np.random.default_rng(10)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    gamma, beta = (rng.normal(size=(shape[-1],)).astype(np.float32) for _ in range(2))
    axes = tuple(range(1, len(shape) - 1))
    want = np.asarray(jax_norms.std_instance_norm(*map(jnp.asarray, (x, gamma, beta)), spatial_axes=axes))
    got = norms.std_instance_norm(*map(torch.from_numpy, (x, gamma, beta)), spatial_axes=axes)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    np.testing.assert_allclose(norms.layer_style(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_norms.layer_style(jnp.asarray(x))), atol=2e-6)


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [8, 7])
def test_stride2_same_padding_matches_jax(size):
    """TF SAME at stride 2 with a 3x3 kernel pads 0 before and 1 after for an
    even size, 1 and 1 for an odd one."""
    from confignet_tpu_torch.ops.conv3d import _same_pads

    assert _same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)  # HWIO
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = conv_channels_last(torch.from_numpy(x), torch.from_numpy(k).permute(3, 2, 0, 1), stride=2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


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
