"""The port's InceptionV3, FID/KID and the fused generator -> Inception
feature path against the JAX package's, on the CPU, with the JAX weights
carried across (``core/model_io.load_jax_params``).

- ``InceptionV3`` at 128px: float32 within 1e-4 relative L2 of JAX's; the
  extractor's bf16 within 3e-2 (each package rounds its convolutions to
  bf16 on its own).
- ``get_features`` pads the tail chunk and gives each image the features it
  has alone.
- ``compute_FID`` (the low-rank cross-Gram path and the eigh path),
  ``compute_KID`` and ``_poly_kernel`` equal JAX's within rtol 1e-12.
- ``InceptionMetrics`` draws the same indexes after the same seed and
  scores the same.
- ``_metric_features_for_latents`` of a tiny ``ConfigNetFirstStage``
  against JAX's, with ``_inception_metric_object`` assigned on both sides.
"""
import numpy as np
import pytest
import torch
from flax import traverse_util

from confignet_tpu.metrics import inception as jax_inception
from confignet_tpu.models.backbones.inception import InceptionV3 as JaxInceptionV3
from confignet_tpu.training.first_stage import ConfigNetFirstStage as JaxFirstStage
from helpers import FakeDataset, TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.core.model_io import load_jax_params
from confignet_tpu_torch.metrics import inception
from confignet_tpu_torch.models.backbones.inception import InceptionV3
from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage

torch.set_num_threads(1)


def _flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def extractors():
    """The JAX extractor at 128px and the port's carrying its weights."""
    jax_ext = jax_inception.InceptionFeatureExtractor((128, 128, 3))
    port_ext = inception.InceptionFeatureExtractor((128, 128, 3), device="cpu")
    load_jax_params(port_ext.module, _flat(jax_ext.variables["params"]))
    return jax_ext, port_ext


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).integers(0, 256, (3, 128, 128, 3), dtype=np.uint8)


def test_inception_v3_float32_matches_jax(extractors, images):
    import jax.numpy as jnp

    jax_ext, _ = extractors
    module = InceptionV3()
    load_jax_params(module, _flat(jax_ext.variables["params"]))
    assert sum(1 for m in module.modules() if type(m).__name__ == "ConvBN") == 94
    x = images[:2].astype(np.float32) / 127.5 - 1.0
    want = np.asarray(JaxInceptionV3().apply(jax_ext.variables, jnp.asarray(x)))
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048) and got.std() > 0
    assert _rel_l2(got, want) < 1e-4


def test_extractor_bfloat16_features_match_jax(extractors, images):
    jax_ext, port_ext = extractors
    want = jax_ext.get_features(images, max_chunk_size=2)
    got = port_ext.get_features(images, max_chunk_size=2)
    assert got.dtype == np.float32 and got.shape == (3, 2048)
    assert _rel_l2(got, want) < 3e-2


def test_get_features_pads_the_tail(extractors, images):
    """Three images in chunks of 2: the padded tail gives the third image the
    features it has in a chunk of its own, and padding changes nothing."""
    _, port_ext = extractors
    chunked = port_ext.get_features(images, max_chunk_size=2)
    alone = port_ext.get_features(images[2:], max_chunk_size=1)
    np.testing.assert_allclose(chunked[2:], alone, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port_ext.get_features(images[:0]), np.zeros((0, 2048), np.float32))


@pytest.mark.parametrize("n_g,n_r,dim", [(64, 96, 256), (40, 50, 12)], ids=["gram", "eigh"])
def test_fid_kid_match_jax(n_g, n_r, dim):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(n_g, dim)).astype(np.float32)
    b = (rng.normal(size=(n_r, dim)) * 1.3 - 0.2).astype(np.float32)
    np.testing.assert_allclose(inception.compute_FID(a, b), jax_inception.compute_FID(a, b),
                               rtol=1e-12)
    np.testing.assert_allclose(inception.compute_KID(a, b), jax_inception.compute_KID(a, b),
                               rtol=1e-12)
    np.testing.assert_allclose(inception._poly_kernel(a, b), jax_inception._poly_kernel(a, b),
                               rtol=1e-12)


def test_inception_metrics_draws_and_scores_match_jax(tmp_path):
    dataset = FakeDataset(n_images=16, img_size=128)
    dataset.inception_features = np.random.default_rng(2).normal(size=(16, 2048)).astype(np.float32)
    config = {"output_shape": (128, 128, 3)}
    np.random.seed(7)
    want = jax_inception.InceptionMetrics(config, dataset, n_samples_for_metrics=10)
    np.random.seed(7)
    got = inception.InceptionMetrics(config, dataset, n_samples_for_metrics=10, device="cpu")
    np.testing.assert_array_equal(got.gt_inception_features, want.gt_inception_features)
    features = np.random.default_rng(3).normal(size=(12, 2048)).astype(np.float32)
    np.testing.assert_allclose(got.get_metrics(features=features),
                               want.get_metrics(features=features), rtol=1e-12)

    history = {"training_step_number": [5]}
    got.update_and_log_metrics(None, history, str(tmp_path), features=features)
    assert (tmp_path / "inception_metrics.png").exists()
    table = np.loadtxt(tmp_path / "inception_metrics.txt")
    np.testing.assert_allclose(table, [5, history["kid"][0], history["fid"][0]])
    with pytest.raises(NotImplementedError):
        inception.InceptionMetrics(dict(config, backbones_dir=str(tmp_path)), dataset, 2,
                                   device="cpu")


def test_fused_metric_features_match_jax(extractors):
    """Five latents in chunks of 2 (tail padded) through the EMA generator,
    the on-device uint8 quantisation and the bf16 Inception, on both sides;
    within 3e-2 relative L2 (bf16 Inception).  The fused features equal the
    port's own get_features of its generate_images renders."""
    jax_ext, port_ext = extractors
    dataset = FakeDataset(n_images=4, img_size=128)
    dataset.inception_features = np.zeros((4, 2048), np.float32)
    jax_model = JaxFirstStage(dict(TINY_FIRST_STAGE_CONFIG))
    port_model = ConfigNetFirstStage(dict(TINY_FIRST_STAGE_CONFIG), device="cpu", initialize=False)
    port_model.set_weights({name: _flat(tree) for name, tree in jax_model.get_weights().items()})
    jax_model._inception_metric_object = jax_inception.InceptionMetrics(jax_model.config, dataset, 2)
    jax_model._inception_metric_object.inception_feature_extractor = jax_ext
    assert port_model._inception_metric_object is None
    port_model._inception_metric_object = inception.InceptionMetrics(port_model.config, dataset, 2,
                                                                      device="cpu")
    port_model._inception_metric_object.inception_feature_extractor = port_ext

    rng = np.random.default_rng(4)
    latents = rng.normal(size=(5, port_model.config["latent_dim"])).astype(np.float32)
    rotations = (rng.uniform(-1, 1, (5, 3)) * [np.pi / 6, np.pi / 18, 0]).astype(np.float32)
    want = jax_model._metric_features_for_latents(latents, rotations, batch_chunk=2)
    got = port_model._metric_features_for_latents(latents, rotations, batch_chunk=2)
    assert got.shape == (5, 2048) and np.isfinite(got).all()
    assert _rel_l2(got, want) < 3e-2
    renders = port_model.generate_images(latents, rotations, batch_chunk=2)
    np.testing.assert_allclose(got, port_ext.get_features(renders, max_chunk_size=2),
                               rtol=1e-5, atol=1e-5)
