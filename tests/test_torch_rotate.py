"""The rotation kernels' launch plan and the plain tiled twins of the slab
forward and the owner-computes transpose, against the plain versions and
the JAX package on the CPU: the Pallas kernels in interpret mode, the numpy
oracle (forward) and jax.grad of the JAX gather form (transpose)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confignet_tpu.core import transforms as jax_transforms
from confignet_tpu.ops.rotate_pallas import _pack_point_inputs, _rotate_grad_grid, rotate_3d_grid_pallas
from confignet_tpu_torch.ops.rotate_cuda import (
    H100_LIMITS, forward_shared_bytes, rotate_3d_grid_plain, rotate_3d_grid_tiled_plain,
    rotate_3d_grid_transpose_plain, rotate_3d_grid_transpose_tiled_plain, rotate_plan,
    transpose_shared_bytes)

torch.set_num_threads(1)

SMEM, SMS = H100_LIMITS


def _euler(rot):
    return np.array(jax_transforms.euler_angles_to_matrix(jnp.asarray(rot, jnp.float32)))


def transforms_for(case, batch, rng):
    """(B, 3, 3) float32 transforms of a named case."""
    if case in ("reference", "ragged"):
        rot = rng.uniform(-1, 1, size=(batch, 3)) * np.array([np.pi / 6, np.pi / 18, 0.0])
        rot[0] = 0.0
        rot[-1] = [np.pi / 4, np.pi / 18, 0.0]
        return _euler(rot)
    if case == "yaw90":
        return _euler(np.tile([np.pi / 2, 0.0, 0.0], (batch, 1)))
    if case == "axis90":
        return _euler(np.eye(3)[np.arange(batch) % 3] * np.pi / 2)
    if case == "scale2":
        return np.tile(2 * np.eye(3, dtype=np.float32), (batch, 1, 1))
    if case == "zero":
        return np.zeros((batch, 3, 3), np.float32)
    raise ValueError(case)


CASES = ["reference", "yaw90", "axis90", "scale2", "zero", "ragged"]


def case_inputs(case, seed):
    size, channels, batch = (8, 3, 3) if case == "ragged" else (8, 8, 3)
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(batch, size, size, size, channels)).astype(np.float32)
    return grid, transforms_for(case, batch, rng)


def tile_plans(shape, transpose):
    """The plan for an H100 and one with narrow, ragged channel groups (and
    one-plane windows for the forward), so every twin runs several tiles."""
    batch, size, channels = shape[0], shape[1], shape[4]
    plan = rotate_plan(batch, size, channels, torch.float32, SMEM, SMS, transpose=transpose)
    narrow = plan._replace(group=max(1, channels // 2 - 1), vec=1)
    return [plan, narrow if transpose else narrow._replace(window=1)]


@pytest.mark.parametrize("case", CASES)
def test_forward_tiled_twin_matches_plain_and_jax(case):
    """The slab forward's twin against the plain version, the Pallas kernel
    in interpret mode and the numpy oracle, atol 2e-5 (the kernel contract
    of tests/test_pallas_interpret.py)."""
    grid, mats = case_inputs(case, 0)
    wants = [np.asarray(rotate_3d_grid_pallas(jnp.asarray(grid), jnp.asarray(mats), interpret=True)),
             jax_transforms.rotate_3d_grid_reference_numpy(grid, mats)]
    tg, tm = torch.from_numpy(grid), torch.from_numpy(mats)
    plain = rotate_3d_grid_plain(tg, tm)
    for plan in tile_plans(grid.shape, transpose=False):
        got = rotate_3d_grid_tiled_plain(tg, tm, plan)
        assert got.dtype == torch.float32 and got.shape == tg.shape
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5)
        for want in wants:
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("case", CASES)
def test_transpose_tiled_twin_matches_plain_and_jax(case):
    """The owner-computes transpose's twin against the plain version, the
    Pallas transpose in interpret mode and jax.grad of the JAX gather form,
    atol 2e-4 (tests/test_pallas_interpret.py:41-62)."""
    grid, mats = case_inputs(case, 1)
    batch, size, channels = grid.shape[0], grid.shape[1], grid.shape[4]
    ct = np.random.default_rng(2).normal(size=grid.shape).astype(np.float32)
    want_grad = jax.grad(lambda g: jnp.sum(jax_transforms.rotate_3d_grid(g, jnp.asarray(mats)) * ct))(
        jnp.asarray(grid))
    f, c, d = jax_transforms._source_coords(jnp.asarray(grid), jnp.asarray(mats))
    pidx, sidx, frac = _pack_point_inputs(f, c, d, size)
    want_pallas = _rotate_grad_grid(jnp.asarray(ct).reshape(batch, size ** 3, channels), pidx, sidx,
                                    frac, size=size, point_block=256, interpret=True)
    tc, tm = torch.from_numpy(ct), torch.from_numpy(mats)
    plain = rotate_3d_grid_transpose_plain(tc, tm)
    for plan in tile_plans(grid.shape, transpose=True):
        got = rotate_3d_grid_transpose_tiled_plain(tc, tm, plan)
        assert got.dtype == torch.float32 and got.shape == tc.shape
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_grad), atol=2e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas).reshape(grid.shape), atol=2e-4)


def test_tiled_twins_bf16_round_once():
    """bf16 grid and ct: the twins accumulate in float32 and cast once, as
    the plain versions do (3e-2 of max(1, |value|))."""
    grid, mats = case_inputs("reference", 3)
    tg, tm = torch.from_numpy(grid).bfloat16(), torch.from_numpy(mats)
    for twin, plain in ((rotate_3d_grid_tiled_plain, rotate_3d_grid_plain),
                        (rotate_3d_grid_transpose_tiled_plain, rotate_3d_grid_transpose_plain)):
        got, want = twin(tg, tm), plain(tg, tm)
        assert got.dtype == torch.bfloat16
        err = ((got.float() - want.float()).abs() / want.float().abs().clamp(min=1.0)).max().item()
        assert err <= 3e-2, (twin.__name__, err)


def _coverage(plan, size, channels, transpose):
    """How often each (point or gradient cell, channel) of one sample is
    covered by the plan's blocks."""
    plane = size * size
    windows = size if transpose else -(-size // plan.window)
    span = plane if transpose else plan.window * plane
    groups = -(-channels // plan.group)
    cover = np.zeros((size ** 3, channels), np.int64)
    for w in range(windows):
        for g in range(groups):
            cover[w * span:(w + 1) * span, g * plan.group:(g + 1) * plan.group] += 1
    return cover, windows * groups


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rotate_plan_takes_the_slab_routes_at_main_path_shapes(dtype, transpose):
    """Under an H100's 227 KB of opt-in shared memory per block and 132 SMs,
    every S=16, C=128 shape that serving (B=32) and the train step (B=12, 24)
    launch, and B=256, takes the new route with 16-byte accesses, within the
    per-block limit, and covers every point and channel exactly once."""
    elem = torch.empty((), dtype=dtype).element_size()
    for batch in (12, 24, 32, 256):
        plan = rotate_plan(batch, 16, 128, dtype, SMEM, SMS, transpose=transpose)
        assert plan.route == ("owner" if transpose else "slab"), plan
        assert plan.vec == 16 // elem and plan.group % plan.vec == 0, plan
        assert plan.shared_bytes <= SMEM, plan
        want = (transpose_shared_bytes(16, plan.group) if transpose
                else forward_shared_bytes(16, plan.window, plan.group, elem))
        assert plan.shared_bytes == want
        cover, per_sample = _coverage(plan, 16, 128, transpose)
        assert (cover == 1).all(), plan
        assert plan.blocks == batch * per_sample, plan


@pytest.mark.parametrize("transpose", [False, True])
def test_rotate_plan_edges(transpose):
    """Three channels take scalar accesses in one ragged group; a grid larger
    than the slab kernels take (S > 32; S > 16 for the transpose) goes to
    route v1, as a function of the shape alone."""
    odd = rotate_plan(2, 8, 3, torch.bfloat16, SMEM, SMS, transpose=transpose)
    assert (odd.route, odd.vec, odd.group) == ("owner" if transpose else "slab", 1, 3)
    cover, _ = _coverage(odd, 8, 3, transpose)
    assert (cover == 1).all()
    big = rotate_plan(2, 40, 16, torch.float32, SMEM, SMS, transpose=transpose)
    assert big.route == "v1" and big.blocks == 2 * -(-40 ** 3 // 32)
    mid = rotate_plan(2, 24, 16, torch.float32, SMEM, SMS, transpose=transpose)
    assert mid.route == ("v1" if transpose else "slab")
