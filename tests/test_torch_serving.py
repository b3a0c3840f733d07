"""The port's ConfigNetServer against the JAX ConfigNetServer on the CPU,
over ConfigNet(TINY_FIRST_STAGE_CONFIG) with the weights the JAX server
snapshots copied into the port.  Bounds are those of tests/test_serving.py:
latents rtol 2e-2 (the random ResNet trunk amplifies to ~1e5), rotations
atol 1e-2, images a mean abs uint8 difference below 1.0."""
import numpy as np
import pytest
import torch
from flax import traverse_util

from helpers import TINY_FIRST_STAGE_CONFIG
from confignet_tpu.serving import ConfigNetServer as JaxServer
from confignet_tpu.training.second_stage import ConfigNet as JaxConfigNet
from confignet_tpu_torch.serving import ConfigNetServer
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)


def _flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def servers():
    jmodel = JaxConfigNet(dict(TINY_FIRST_STAGE_CONFIG))
    # The encoder heads are zero-initialised; give them seeded weights so
    # that latents and poses vary from photo to photo.
    weights = jmodel.get_weights()
    enc = _flat(weights["real_encoder"])
    rng = np.random.default_rng(0)
    for head, std in (("feature_to_latent", 1e-6), ("rotation_regressor", 3e-7)):
        enc[f"{head}/kernel"] = (rng.normal(size=enc[f"{head}/kernel"].shape) * std).astype(np.float32)
    weights["real_encoder"] = traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in enc.items()})
    jmodel.set_weights(weights)
    jsrv = JaxServer(jmodel, chunk=4)

    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    model.set_weights({**{name: _flat(tree) for name, tree in weights.items()},
                       "generator": _flat(jsrv._gen_params),
                       "generator_smoothed": _flat(jsrv._gen_params),
                       "synthetic_encoder": _flat(jsrv._synth_params),
                       "real_encoder": _flat(jsrv._enc_params)})
    return jsrv, ConfigNetServer(model, chunk=4, device="cpu"), model


def _photos(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 128, 128, 3), dtype=np.uint8)


def _close_images(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.mean(np.abs(a.astype(int) - b.astype(int))) < 1.0


def test_encode_and_generate_match_jax(servers):
    jsrv, srv, model = servers
    imgs = _photos(5, 0)  # 5 photos pad to two chunks of 4
    lat, rot = srv.encode(imgs)
    jlat, jrot = jsrv.encode(imgs)
    assert lat.shape == (5, model.config["latent_dim"]) and rot.shape == (5, 3)
    assert np.std(lat[:, 0]) > 0 and np.std(rot[:, 0]) > 0  # the photos differ
    np.testing.assert_allclose(lat, np.asarray(jlat, np.float32), rtol=2e-2,
                               atol=2e-2 * np.abs(jlat).max())
    np.testing.assert_allclose(rot, np.asarray(jrot, np.float32), atol=1e-2)

    out = srv.generate(jlat, jrot)
    _close_images(out, jsrv.generate(jlat, jrot))
    assert out.std() > 0
    # the unfused model API gives the same renders
    _close_images(model.generate_images(jlat, jrot, batch_chunk=4), out)
    mlat, mrot = model.encode_images(imgs, batch_chunk=4)
    np.testing.assert_allclose(mlat, lat, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("per_image", [False, True])
def test_render_with_attribute_matches_jax(servers, per_image):
    jsrv, srv, model = servers
    imgs = _photos(5, 1)
    n_blend = model.config["facemodel_inputs"]["blendshape_values"][0]
    rows = 5 if per_image else 1
    value = np.random.default_rng(2).normal(size=(rows, n_blend)).astype(np.float32)
    out = srv.render_with_attribute(imgs, "blendshape_values", value)
    _close_images(out, jsrv.render_with_attribute(imgs, "blendshape_values", value))

    rot0 = np.zeros((5, 3), np.float32)
    out_rot = srv.render_with_attribute(imgs, "blendshape_values", value, rotations=rot0)
    _close_images(out_rot, jsrv.render_with_attribute(imgs, "blendshape_values", value, rotations=rot0))

    # the unfused path: encode, splice on the host, generate
    lat, rot = model.encode_images(imgs)
    lat = model.set_facemodel_param_in_latents(lat, "blendshape_values", value)
    _close_images(out, model.generate_images(lat, rot))
    with pytest.raises(ValueError, match="batch dim"):
        srv.render_with_attribute(imgs, "blendshape_values", value[:1].repeat(3, axis=0))


def test_refresh_snapshot_semantics(servers):
    _, srv, model = servers
    lat = np.random.default_rng(3).normal(size=(2, model.config["latent_dim"])).astype(np.float32)
    rot = np.zeros((2, 3), np.float32)
    before = srv.generate(lat, rot)

    fine_tuned = {k: v.clone() for k, v in model.generator_smoothed.state_dict().items()}
    fine_tuned["learned_input"] += 0.5
    model._fine_tuned_generator_params = fine_tuned
    try:
        np.testing.assert_array_equal(srv.generate(lat, rot), before)  # snapshot is fixed
        srv.refresh()
        assert not np.array_equal(srv.generate(lat, rot), before)
    finally:
        model._fine_tuned_generator_params = None
        srv.refresh()
    np.testing.assert_array_equal(srv.generate(lat, rot), before)


def test_sample_requires_latent_gan(servers):
    _, srv, _ = servers
    with pytest.raises(ValueError, match="LatentGAN"):
        srv.sample(2)
