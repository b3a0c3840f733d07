"""The port's batched affine warp against the JAX package's and OpenCV's,
on the CPU.

- Seeded images and affines (rotation, scale, shear, shift; output shapes
  smaller and larger than the input, channels 1 and 3): within 1e-5 of
  JAX's ``affine_warp``.
- Against ``cv2.warpAffine`` on the interior within 2e-2, the bound of
  tests/test_warp.py (the borders differ by cv2's edge handling).
- The identity affine returns the input within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confignet_tpu.ops.warp import affine_warp as jax_affine_warp
from confignet_tpu_torch.ops.warp import affine_warp

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(1)


def _affines(batch, center, rng):
    out = []
    for _ in range(batch):
        M = cv2.getRotationMatrix2D(center, rng.uniform(-40, 40), rng.uniform(0.6, 1.4))
        M[:, :2] += rng.normal(scale=0.05, size=(2, 2))  # a little shear
        M[:, 2] += rng.normal(scale=3.0, size=2)
        out.append(M)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("in_hw,out_hw,channels", [((40, 50), (36, 48), 3), ((24, 24), (40, 32), 1),
                                                   ((64, 48), (64, 48), 3)])
def test_affine_warp_matches_jax(in_hw, out_hw, channels):
    rng = np.random.default_rng(sum(in_hw) + channels)
    imgs = rng.random((3, *in_hw, channels)).astype(np.float32)
    M = _affines(3, (in_hw[1] / 2, in_hw[0] / 2), rng)
    got = affine_warp(torch.from_numpy(imgs), torch.from_numpy(M), out_hw).numpy()
    want = np.asarray(jax_affine_warp(jnp.asarray(imgs), jnp.asarray(M), out_hw))
    assert got.shape == (3, *out_hw, channels) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_affine_warp_matches_cv2():
    rng = np.random.default_rng(0)
    img = rng.random((1, 40, 50, 3)).astype(np.float32)
    M = cv2.getRotationMatrix2D((25, 20), 12.0, 0.8).astype(np.float32)
    expected = cv2.warpAffine(img[0], M, (48, 36))
    got = affine_warp(torch.from_numpy(img), torch.from_numpy(M[None]), (36, 48))[0].numpy()
    interior = (slice(2, -2), slice(2, -2))
    np.testing.assert_allclose(got[interior], expected[interior], atol=2e-2)


def test_affine_warp_identity():
    img = np.random.default_rng(1).random((2, 16, 16, 1)).astype(np.float32)
    M = np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (2, 1, 1))
    out = affine_warp(torch.from_numpy(img), torch.from_numpy(M), (16, 16)).numpy()
    np.testing.assert_allclose(out, img, atol=1e-5)
