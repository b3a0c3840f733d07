"""The port's checkpoint files and host-side model API against the JAX
package's, on TINY_FIRST_STAGE_CONFIG on the CPU.

- JAX -> port: checkpoints the JAX ``ConfigNetFirstStage`` and ``ConfigNet``
  save load through the port's ``load_confignet`` as the right class, with
  the npz's keys and arrays exactly, the log, and distributions that sample
  the same bytes after the same ``np.random.seed``; renders within a mean
  abs uint8 difference below 1.0 (the bound of tests/test_serving.py).
- Port -> JAX: the same checks the other way, through the JAX package's
  ``load_confignet``, whose unpickler reads the port's distribution pickle.
- A reference-release checkpoint with a live learned-input kernel raises
  ``ValueError``, an orbax directory ``NotImplementedError``;
  ``attempt_reloading_checkpoint`` picks the newest
  json; a JAX config's JAX-only ``rotation_resample`` values load as "auto".
- The sampling helpers give JAX's bytes after the same seed; the
  expression inversion matches JAX within atol 1e-4 at 50 iterations;
  ``generate_images_from_facemodel`` renders within 1.0 of JAX's.
"""
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
from flax import traverse_util

from confignet_tpu.core import model_io as jax_model_io
from confignet_tpu.data import distributions as jax_distributions
from confignet_tpu.training.first_stage import ConfigNetFirstStage as JaxFirstStage
from confignet_tpu.training.second_stage import ConfigNet as JaxConfigNet
from helpers import TINY_FIRST_STAGE_CONFIG, write_reference_checkpoint
from confignet_tpu_torch.core import model_io
from confignet_tpu_torch.data import distributions
from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)

KINDS = {"first_stage": (JaxFirstStage, ConfigNetFirstStage), "confignet": (JaxConfigNet, ConfigNet)}
# the distribution of each input of the tiny config, plus the rotations (a
# dataset's distributions cover them too)
DISTRIBUTION_TYPES = {"blendshape_values": "GMM", "head_hair_color": "one_hot", "rotations": "exemplar"}
LOGS = {"g_losses": {"loss_sum": [3.0, 2.5, 2.25], "gan_loss": [1.0, 0.5, 0.25]},
        "d_losses": {"loss_sum": [1.5, 1.25, 1.0]},
        "metrics": {"training_step_number": [2], "fid": [123.5]}}


def _flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


def _fitted(module, seed):
    rng = np.random.default_rng(seed)
    dims = {"blendshape_values": 8, "head_hair_color": 3, "rotations": 3}
    return {name: module.fit_distribution(rng.normal(size=(20, dims[name])).astype(np.float32), kind)
            for name, kind in DISTRIBUTION_TYPES.items()}


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _close_images(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.mean(np.abs(a.astype(int) - b.astype(int))) < 1.0
    assert a.std() > 0


def _render_inputs(latent_dim, seed):
    rng = np.random.default_rng(seed)
    rotations = (rng.uniform(-1, 1, (5, 3)) * [np.pi / 6, np.pi / 18, 0]).astype(np.float32)
    return rng.normal(size=(5, latent_dim)).astype(np.float32), rotations


def _same_samples(got, want):
    """Each distribution draws the same bytes after the same seed."""
    assert set(got) == set(want)
    for name in want:
        np.random.seed(11)
        a = want[name].sample(7)[0]
        np.random.seed(11)
        b = got[name].sample(7)[0]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """{kind: (JAX model, json path)}: each JAX model with fitted JAX
    distributions and a loss history, saved by the JAX package."""
    out = {}
    for kind, (jax_cls, _) in KINDS.items():
        jmodel = jax_cls(dict(TINY_FIRST_STAGE_CONFIG))
        jmodel.facemodel_param_distributions = _fitted(jax_distributions, 0)
        jmodel.set_logs(json.loads(json.dumps(LOGS)))
        directory = str(tmp_path_factory.mktemp(f"jax_{kind}"))
        jmodel.save(directory, "model")
        out[kind] = jmodel, os.path.join(directory, "model.json")
    return out


@pytest.fixture(scope="module")
def port_models(jax_checkpoints):
    return {kind: model_io.load_confignet(path, device="cpu")
            for kind, (_, path) in jax_checkpoints.items()}


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_checkpoint_loads_in_port(jax_checkpoints, port_models, kind):
    jmodel, path = jax_checkpoints[kind]
    model = port_models[kind]
    assert type(model) is KINDS[kind][1]
    assert model.config["model_type"] == jmodel.config["model_type"]
    assert model.device == torch.device("cpu")

    saved = _npz(os.path.splitext(path)[0] + ".npz")
    got = model_io.flatten_param_trees(model.get_weights())
    assert set(got) == set(saved)
    assert ("real_encoder" in {k.split("/")[0] for k in got}) == (kind == "confignet")
    for key, value in saved.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)

    assert model.get_log_dict() == jmodel.get_log_dict() == LOGS
    assert model.get_resume_step() == jmodel.get_resume_step() == 3
    assert model.get_training_step_number() == jmodel.get_training_step_number() == 2
    assert model.get_batch_size() == jmodel.get_batch_size()
    assert all(type(d).__module__ == distributions.__name__
               for d in model.facemodel_param_distributions.values())
    _same_samples(model.facemodel_param_distributions, jmodel.facemodel_param_distributions)

    latents, rotations = _render_inputs(model.config["latent_dim"], 1)
    _close_images(model.generate_images(latents, rotations),
                  jmodel.generate_images(latents, rotations))


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_checkpoint_loads_in_jax(port_models, tmp_path, kind):
    model = port_models[kind]
    # the port's own weights (its seeded init, not the JAX package's), its
    # distributions and a longer history
    fresh = KINDS[kind][1](dict(TINY_FIRST_STAGE_CONFIG, seed=5), device="cpu")
    fresh.facemodel_param_distributions = _fitted(distributions, 1)
    logs = json.loads(json.dumps(LOGS))
    logs["g_losses"]["loss_sum"].append(2.0)
    fresh.set_logs(logs)
    fresh.save(str(tmp_path), "port")
    assert sorted(os.listdir(tmp_path)) == ["port.json", "port.npz", "port_facemodel_distr.pck",
                                            "port_log.json"]

    jmodel = jax_model_io.load_confignet(str(tmp_path / "port.json"))
    assert type(jmodel) is KINDS[kind][0]
    saved = _npz(str(tmp_path / "port.npz"))
    want = jax_model_io.flatten_param_trees(jmodel.get_weights())
    assert set(saved) == set(want) == set(model_io.flatten_param_trees(model.get_weights()))
    for key, value in saved.items():
        np.testing.assert_array_equal(np.asarray(want[key]), value, err_msg=key)

    assert jmodel.get_log_dict() == logs and jmodel.get_resume_step() == fresh.get_resume_step() == 4
    assert all(type(d).__module__ == jax_distributions.__name__
               for d in jmodel.facemodel_param_distributions.values())
    _same_samples(jmodel.facemodel_param_distributions, fresh.facemodel_param_distributions)

    latents, rotations = _render_inputs(fresh.config["latent_dim"], 2)
    _close_images(fresh.generate_images(latents, rotations),
                  jmodel.generate_images(latents, rotations))
    # the port reads its own files back exactly
    again = model_io.load_confignet(str(tmp_path / "port.json"), device="cpu")
    again_flat = model_io.flatten_param_trees(again.get_weights())
    assert all(np.array_equal(again_flat[k], v) for k, v in saved.items())
    np.testing.assert_array_equal(again.generate_images(latents, rotations),
                                  fresh.generate_images(latents, rotations))


def test_distribution_pickle_names_and_passthrough(tmp_path):
    """The port writes its classes under the JAX package's module path and
    nothing else; classes of other modules pass through both ways."""
    from helpers import FakeDistribution
    from confignet_tpu_torch.core.pickles import read_pickle, write_pickle

    distrs = {**_fitted(distributions, 2), "fake": FakeDistribution(np.ones((2, 3)))}
    path = str(tmp_path / "d.pck")
    write_pickle(distrs, path)
    raw = open(path, "rb").read()
    assert b"confignet_tpu.data.distributions" in raw and b"confignet_tpu_torch" not in raw
    back = read_pickle(path)
    assert {k: type(v) for k, v in back.items()} == {k: type(v) for k, v in distrs.items()}
    with open(path, "rb") as fp:  # plain pickle resolves the JAX package's classes
        plain = pickle.load(fp)
    assert type(plain["blendshape_values"]) is jax_distributions.GaussianDistribution
    _same_samples(back, distrs)


@pytest.mark.parametrize("module, name", [
    ("confignet_tpu.data.distributions", "fit_distribution"),
    ("confignet_tpu.core.model_io", "load_confignet"),
    ("confignet.neural_renderer_dataset", "NeuralRendererDataset"),
])
def test_distribution_pickle_refuses_other_package_names(tmp_path, module, name):
    """A name of either package that has no counterpart raises instead of
    importing the JAX package (protocol 0's GLOBAL opcode names it)."""
    from confignet_tpu_torch.core.pickles import read_pickle

    path = tmp_path / "d.pck"
    path.write_bytes(f"c{module}\n{name}\n.".encode())
    with pytest.raises(pickle.UnpicklingError, match=name):
        read_pickle(str(path))


def test_reference_and_orbax_checkpoints_are_refused(jax_checkpoints, tmp_path):
    jmodel, path = jax_checkpoints["first_stage"]
    # a reference release loads (tests/test_torch_reference_import.py) unless
    # the generator's dead learned-input kernel is live
    reference = write_reference_checkpoint(jmodel, str(tmp_path / "reference"))
    npz = os.path.splitext(reference)[0] + ".npz"
    with np.load(npz, allow_pickle=True) as data:
        lists = {key: data[key] for key in data.files}
    lists["generator_weights"][0] = np.ones_like(lists["generator_weights"][0])
    np.savez(npz, **lists)
    with pytest.raises(ValueError, match="learned-input kernel"):
        model_io.load_confignet(reference, device="cpu")

    orbax = tmp_path / "orbax"
    (orbax / "model.orbax").mkdir(parents=True)
    shutil.copy(path, orbax / "model.json")
    with pytest.raises(NotImplementedError, match="orbax"):
        model_io.load_confignet(str(orbax / "model.json"), device="cpu")
    with pytest.raises(NotImplementedError, match="orbax"):
        model_io.save_weights_orbax({}, str(orbax))


def test_orbax_checkpoint_format_is_refused_on_save(port_models, tmp_path):
    model = port_models["first_stage"]
    model.config["checkpoint_format"] = "orbax"
    try:
        with pytest.raises(NotImplementedError, match="orbax"):
            model.save(str(tmp_path), "model")
    finally:
        model.config["checkpoint_format"] = "npz"
    assert not os.listdir(tmp_path)


def test_jax_only_rotation_resample_values_load(jax_checkpoints, tmp_path):
    _, path = jax_checkpoints["first_stage"]
    with open(path) as fp:
        config = json.load(fp)
    config.update(rotation_resample="pallas", rotation_resample_train="pallas_fused",
                  conv3d_impl="zdecomp")
    with open(tmp_path / "m.json", "w") as fp:
        json.dump(config, fp)
    shutil.copy(os.path.splitext(path)[0] + ".npz", tmp_path / "m.npz")
    model = model_io.load_confignet(str(tmp_path / "m.json"), device="cpu")
    assert (model.config["rotation_resample"], model.config["rotation_resample_train"]) == (
        "auto", "auto_train")
    assert model.config["conv3d_impl"] == "zdecomp"
    assert model.facemodel_param_distributions is None  # no pickle beside it


def test_attempt_reloading_checkpoint(tmp_path, monkeypatch):
    def touch(directory, *names):
        os.makedirs(directory, exist_ok=True)
        for name in names:
            open(os.path.join(directory, name), "w").close()

    loaded = []

    def loader(path):
        loaded.append(os.path.relpath(path, tmp_path))
        return path

    monkeypatch.delenv("PT_PREV_OUTPUT_DIR", raising=False)
    assert model_io.attempt_reloading_checkpoint(str(tmp_path / "run"), loader) is None
    touch(tmp_path / "prev" / "checkpoints", "000007.json", "000009_log.json")
    monkeypatch.setenv("PT_PREV_OUTPUT_DIR", str(tmp_path / "prev"))
    model_io.attempt_reloading_checkpoint(str(tmp_path / "run"), loader)
    touch(tmp_path / "run" / "checkpoints", "000001.json", "000002.json", "000002_log.json",
          "000003_log.json", "000002.npz")
    model_io.attempt_reloading_checkpoint(str(tmp_path / "run"), loader)
    assert loaded == [os.path.join("prev", "checkpoints", "000007.json"),
                      os.path.join("run", "checkpoints", "000002.json")]


def test_sampling_helpers_match_jax(jax_checkpoints, port_models):
    jmodel, _ = jax_checkpoints["confignet"]
    model = port_models["confignet"]
    for call in (lambda m: m.sample_latent_vector(6), lambda m: m.sample_rotations(6),
                 lambda m: m.sample_rotations(4, axes=(0,)), lambda m: m.sample_facemodel_params(6)):
        np.random.seed(3)
        want = call(jmodel)
        np.random.seed(3)
        got = call(model)
        if isinstance(want, np.ndarray):
            got, want = [got], [want]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("unused", [None, (0, 3, 7)])
def test_expression_inversion_matches_jax(jax_checkpoints, port_models, unused):
    jmodel, _ = jax_checkpoints["first_stage"]
    model = port_models["first_stage"]
    rng = np.random.default_rng(4)
    value = rng.uniform(0, 1, (1, 8)).astype(np.float32)
    latent = model.set_facemodel_param_in_latents(
        rng.normal(size=(2, model.config["latent_dim"])).astype(np.float32), "blendshape_values", value)
    got = model.fit_facemodel_expression_params_to_latent(latent, unused_expr_idxs=unused, n_iters=50)
    want = jmodel.fit_facemodel_expression_params_to_latent(latent, unused_expr_idxs=unused, n_iters=50)
    assert got.shape == (1, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    assert got.min() >= 0.0 and got.max() <= 1.0 and np.any(got > 0)
    if unused is not None:
        assert not np.any(got[:, list(unused)])


def test_generate_images_from_facemodel_matches_jax(jax_checkpoints, port_models):
    jmodel, _ = jax_checkpoints["confignet"]
    model = port_models["confignet"]
    np.random.seed(8)
    params = model.sample_facemodel_params(5)
    rotations = model.sample_rotations(5)
    _close_images(model.generate_images_from_facemodel(params, rotations),
                  jmodel.generate_images_from_facemodel(params, rotations))


def test_load_without_a_device_needs_cuda(jax_checkpoints, monkeypatch):
    _, path = jax_checkpoints["first_stage"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        model_io.load_confignet(path)
