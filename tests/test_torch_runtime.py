"""The port's native host gather (``confignet_tpu_torch/runtime``) against
numpy indexing and against the JAX package's runtime, byte for byte, on
seeded uint8 arrays: in memory, as a read-only memmap (how the datasets
hold their images), through the C++ library and through the numpy path."""
import numpy as np
import pytest

import confignet_tpu.runtime as jax_runtime
from confignet_tpu_torch.runtime import gather_images, gather_rows, native, native_available


def _numpy_gather(images, indices, flips=None):
    out = images[indices].copy()
    if flips is not None:
        out[flips.astype(bool)] = out[flips.astype(bool)][:, :, ::-1]
    return out


@pytest.fixture(params=["array", "memmap"])
def images(request, tmp_path):
    data = np.random.default_rng(0).integers(0, 256, (16, 6, 10, 3), dtype=np.uint8)
    if request.param == "array":
        return data
    path = tmp_path / "imgs.dat"
    mm = np.memmap(path, np.uint8, "w+", shape=data.shape)
    mm[:] = data
    mm.flush()
    return np.memmap(path, np.uint8, "r", shape=data.shape)


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Which implementation runs: the C++ library (built into _build/ on
    first use) or the numpy path taken where no compiler is available."""
    if request.param == "native":
        assert native_available()
        assert native.library_path().parent.name == "_build"
    else:
        monkeypatch.setattr(native, "_get_lib", lambda: None)
    return request.param


def test_gather_rows_matches_numpy_and_jax(images, path):
    rng = np.random.default_rng(1)
    indices = rng.integers(-16, 16, 23)  # negative indices wrap, as numpy's do
    got = gather_rows(images, indices)
    np.testing.assert_array_equal(got, images[indices])
    np.testing.assert_array_equal(got, jax_runtime.gather_rows(images, indices % 16))
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    masks = (rng.random((16, 6, 10)) > 0.9).astype(np.uint8)  # the trainers' eye masks
    np.testing.assert_array_equal(gather_rows(masks, indices), masks[indices])


@pytest.mark.parametrize("with_flips", [False, True])
def test_gather_images_matches_numpy_and_jax(images, path, with_flips):
    rng = np.random.default_rng(2)
    indices = rng.integers(0, 16, 24)
    flips = (rng.random(24) < 0.5).astype(np.uint8) if with_flips else None
    got = gather_images(images, indices, flips)
    np.testing.assert_array_equal(got, _numpy_gather(np.asarray(images), indices, flips))
    np.testing.assert_array_equal(got, jax_runtime.gather_images(images, indices, flips))
    assert got.shape == (24, 6, 10, 3) and got.dtype == np.uint8


def test_out_of_range_indices_raise(path):
    images = np.zeros((4, 2, 2, 3), np.uint8)
    for bad in ([4], [-5]):
        with pytest.raises(IndexError):
            gather_rows(images, np.array(bad))
        with pytest.raises(IndexError):
            gather_images(images, np.array(bad))


def test_flip_flags_must_match_the_indices():
    images = np.zeros((4, 2, 2, 3), np.uint8)
    assert native_available()
    with pytest.raises(ValueError, match="flip flags"):
        gather_images(images, np.array([0, 1, 2]), np.array([1, 0], np.uint8))


def test_non_uint8_and_strided_arrays_take_numpy_indexing():
    rng = np.random.default_rng(3)
    floats = rng.normal(size=(8, 3, 3, 3)).astype(np.float32)
    strided = rng.integers(0, 256, (8, 4, 6, 3), dtype=np.uint8)[:, :, ::2]
    indices = np.array([7, 0, 3, 3])
    np.testing.assert_array_equal(gather_images(floats, indices), floats[indices])
    np.testing.assert_array_equal(gather_images(strided, indices, np.array([1, 0, 1, 0])),
                                  _numpy_gather(strided, indices, np.array([1, 0, 1, 0])))
