"""The port's reference-release importer against the JAX package's, on
TINY_FIRST_STAGE_CONFIG on the CPU.

- Every path table (generator at 128/256/512px, the discriminator in both
  list layouts, the latent regressor, the MLPs, the synthetic and real
  encoders) equals JAX's.
- A release written by ``tests/helpers.write_reference_checkpoint`` (every
  weight shifted by 0.5, so the assignment shows) loads through JAX's and
  the port's ``load_confignet`` to the same weights bit for bit, as the class
  its ``model_type`` names, with the log and the distributions of the
  reference-module pickle; both render the same latents within a mean abs
  uint8 difference below 1.0 (the bound of tests/test_torch_serving.py).
- ``assign_weight_list`` refuses a wrong count, a wrong shape and a live
  learned-input kernel with ValueError, as JAX's does.
- A release whose discriminators are in the interleaved list order loads
  through the fallback, equal to JAX's import.
- A reference LatentGAN loads through ``LatentGAN.load`` and
  ``load_confignet`` to JAX's weights bit for bit; ``generate_latents``
  within atol 1e-5 after the same seed.
"""
import json
import os

import numpy as np
import pytest
import torch
from flax import traverse_util

from confignet_tpu.core import model_io as jax_model_io
from confignet_tpu.core import reference_import as jax_ref
from confignet_tpu.training.first_stage import ConfigNetFirstStage as JaxFirstStage
from confignet_tpu.training.latent_gan import LatentGAN as JaxLatentGAN
from confignet_tpu.training.second_stage import ConfigNet as JaxConfigNet
from helpers import TINY_FIRST_STAGE_CONFIG, write_reference_checkpoint
from confignet_tpu_torch.core import model_io, reference_import
from confignet_tpu_torch.data import distributions
from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage
from confignet_tpu_torch.training.latent_gan import LatentGAN
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)

KINDS = {"first_stage": (JaxFirstStage, ConfigNetFirstStage), "confignet": (JaxConfigNet, ConfigNet)}


def _flat_trees(trees):
    return {name: {"/".join(p): np.asarray(v) for p, v in traverse_util.flatten_dict(tree).items()}
            for name, tree in trees.items() if tree is not None}


def _assert_same_weights(port_model, jax_model):
    want = _flat_trees(jax_model.get_weights())
    got = port_model.get_weights()
    assert set(got) == set(want)
    for tree, leaves in want.items():
        assert set(got[tree]) == set(leaves), tree
        for key, value in leaves.items():
            np.testing.assert_array_equal(got[tree][key], value, err_msg=f"{tree}/{key}")


def _obj_array(items):
    out = np.empty(len(items), dtype=object)
    out[:] = items
    return out


@pytest.fixture(scope="module")
def jax_models():
    return {kind: cls(dict(TINY_FIRST_STAGE_CONFIG)) for kind, (cls, _) in KINDS.items()}


@pytest.mark.parametrize("size", [128, 256, 512])
def test_path_tables_match_jax(size):
    assert reference_import.generator_weight_paths(size) == jax_ref.generator_weight_paths(size)
    for n_resample in (3, 5):
        for from_rgb in (True, False):
            for layout in ("grouped", "interleaved"):
                assert (reference_import.discriminator_weight_paths(n_resample, from_rgb, layout)
                        == jax_ref.discriminator_weight_paths(n_resample, from_rgb, layout))
            assert (reference_import.latent_regressor_weight_paths(n_resample, from_rgb)
                    == jax_ref.latent_regressor_weight_paths(n_resample, from_rgb))
    assert reference_import.mlp_weight_paths(4) == jax_ref.mlp_weight_paths(4)
    inputs = (("blendshape_values", (8, 6)), ("head_hair_color", (3, 4)))
    assert (reference_import.synthetic_encoder_weight_paths(inputs, 2)
            == jax_ref.synthetic_encoder_weight_paths(inputs, 2))
    assert reference_import.real_encoder_weight_paths() == jax_ref.real_encoder_weight_paths()
    with pytest.raises(ValueError, match="list_ordering"):
        reference_import.discriminator_weight_paths(3, True, "sideways")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_release_loads_like_jax(kind, jax_models, tmp_path):
    jmodel = jax_models[kind]
    path = write_reference_checkpoint(jmodel, str(tmp_path / "release"), shift=0.5)
    jloaded = jax_model_io.load_confignet(path)
    loaded = model_io.load_confignet(path, device="cpu")
    assert type(loaded) is KINDS[kind][1] and type(jloaded) is KINDS[kind][0]
    _assert_same_weights(loaded, jloaded)
    # the assignment happened: the generator moved by the shift
    before = _flat_trees(jmodel.get_weights())["generator"]["map_final/kernel"]
    np.testing.assert_array_equal(loaded.get_weights()["generator"]["map_final/kernel"],
                                  (before + 0.5).astype(np.float32))
    assert loaded.get_log_dict() == jloaded.get_log_dict()
    for name, distribution in loaded.facemodel_param_distributions.items():
        assert type(distribution) is distributions.ExemplarDistribution
        np.testing.assert_array_equal(distribution.exemplars,
                                      jloaded.facemodel_param_distributions[name].exemplars)

    rng = np.random.default_rng(3)
    latents = rng.normal(size=(4, loaded.config["latent_dim"])).astype(np.float32)
    rotations = (rng.uniform(-1, 1, (4, 3)) * [np.pi / 6, np.pi / 18, 0]).astype(np.float32)
    got = loaded.generate_images(latents, rotations)
    want = np.asarray(jloaded.generate_images(latents, rotations))
    assert got.shape == want.shape and got.std() > 0
    assert np.mean(np.abs(got.astype(int) - want.astype(int))) < 1.0
    # the class's own load sniffs the format too
    assert type(KINDS[kind][1].load(path, device="cpu")) is KINDS[kind][1]


def test_assign_weight_list_refusals(jax_models):
    jmodel = jax_models["first_stage"]
    params = jmodel.get_weights()["generator"]
    flat = {"/".join(p): np.asarray(v) for p, v in traverse_util.flatten_dict(params).items()}
    paths = reference_import.generator_weight_paths(128)
    weights = [np.zeros((1, flat["learned_input"].shape[0]), np.float32)]
    weights += [flat["/".join(p)] + 1.0 for p in paths[1:]]

    out = reference_import.assign_weight_list(flat, weights, paths, "generator")
    jout = jax_ref.assign_weight_list(params, weights, paths, "generator")
    for p, v in traverse_util.flatten_dict(jout).items():
        np.testing.assert_array_equal(out["/".join(p)], np.asarray(v))

    cases = {
        "shape": lambda w: w.__setitem__(3, np.zeros((1, 1), np.float32)),
        "learned-input kernel": lambda w: w.__setitem__(0, np.ones_like(w[0])),
        "expected": lambda w: w.pop(),
    }
    for message, corrupt in cases.items():
        bad = list(weights)
        corrupt(bad)
        with pytest.raises(ValueError, match=message):
            reference_import.assign_weight_list(flat, bad, paths, "generator")
        with pytest.raises(ValueError, match=message):
            jax_ref.assign_weight_list(params, bad, paths, "generator")


def test_interleaved_discriminators_load_through_the_fallback(jax_models, tmp_path):
    jmodel = jax_models["first_stage"]
    path = write_reference_checkpoint(jmodel, str(tmp_path / "release"), shift=0.25)
    n_res = jmodel.config["n_discr_layers"]
    grouped = jax_ref.discriminator_weight_paths(n_res, True, "grouped")
    interleaved = jax_ref.discriminator_weight_paths(n_res, True, "interleaved")
    npz = os.path.splitext(path)[0] + ".npz"
    with np.load(npz, allow_pickle=True) as data:
        lists = {key: data[key] for key in data.files}
    for key in ("discriminator_weights", "synth_discriminator_weights"):
        by_path = dict(zip(grouped, lists[key]))
        lists[key] = _obj_array([by_path[p] for p in interleaved])
    np.savez(npz, **lists)
    loaded = model_io.load_confignet(path, device="cpu")
    _assert_same_weights(loaded, jax_model_io.load_confignet(path))
    # the shifted weights landed where they belong
    want = _flat_trees(jmodel.get_weights())["discriminator"]
    for key, value in loaded.get_weights()["discriminator"].items():
        np.testing.assert_array_equal(value, (want[key] + 0.25).astype(np.float32))


def test_reference_latent_gan_loads_like_jax(tmp_path):
    jgan = JaxLatentGAN({"latent_dim": 10})
    paths = jax_ref.mlp_weight_paths(jgan.config["num_mlp_layers"])
    weights = jgan.get_weights()

    def weight_list(tree, shift):
        flat = traverse_util.flatten_dict(weights[tree])
        return _obj_array([np.asarray(flat[p], np.float32) + shift for p in paths])

    np.savez(tmp_path / "gan.npz", generator_weights=weight_list("generator", 0.1),
             smoothed_generator_weights=weight_list("generator_smoothed", 0.2),
             discriminator_weights=weight_list("discriminator", 0.3))
    with open(tmp_path / "gan.json", "w") as fp:
        json.dump(dict(jgan.config, model_type="LatentGAN"), fp)
    path = str(tmp_path / "gan.json")
    jloaded = jax_model_io.load_confignet(path)
    for loaded in (LatentGAN.load(path, device="cpu"), model_io.load_confignet(path, device="cpu")):
        assert type(loaded) is LatentGAN
        _assert_same_weights(loaded, jloaded)
        np.random.seed(4)
        got = loaded.generate_latents(6, truncation=0.7)
        np.random.seed(4)
        np.testing.assert_allclose(got, np.asarray(jloaded.generate_latents(6, truncation=0.7)),
                                   atol=1e-5)
