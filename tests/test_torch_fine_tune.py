"""The port's one-shot fine-tune (``ConfigNet.fine_tune_on_img``) against the
JAX package's, on TINY_FIRST_STAGE_CONFIG on the CPU, with the same
weights (generator trees, discriminators, regressor, encoder, VGG19 and
VGGFace) on both sides.

- One iteration through each package's fine-tune step on the same images,
  embedding split and rotations: the loss rtol 1e-4; the renders atol 1e-4;
  the Adam first moment of every optimised tensor (generator leaves,
  ``pre_expr``, ``expr``, ``post_expr``, ``rotations``), which after one
  step is 0.1 times its gradient, per leaf rtol 1e-3 with atol 1e-4 of the
  leaf's largest value and, over all of them, a relative L2 distance below
  1e-3 (the tolerances of ``tests/test_torch_train.py``).
- ``fine_tune_on_img(img, n_iters=2)`` end to end: each Adam step moves a
  value by at most about lr, so the returned embeddings and rotations and
  the fine-tuned generator are held within 2 * n_iters * lr of JAX's.  The
  encoder heads keep their zero initialisation here, so both packages start
  from the same encoding exactly.
- After a fine-tune, ``generate_images`` builds no generator: two calls give
  equal images with no ``copy.deepcopy`` or ``load_state_dict`` (counted).
"""
import copy

import numpy as np
import optax
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util
from PIL import Image

from confignet_tpu.core.images import unit_range_to_uint8 as jax_unit_range_to_uint8
from confignet_tpu.training.second_stage import ConfigNet as JaxConfigNet
from helpers import TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.core.images import unit_range_to_uint8, write_png
from confignet_tpu_torch.core.model_io import export_jax_params, export_jax_tensors, load_jax_params
from confignet_tpu_torch.parallel import Mesh
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)

LR = 1e-4  # the fine-tune's Adam (second_stage.py:714)


def _flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def models():
    jmodel = JaxConfigNet(dict(TINY_FIRST_STAGE_CONFIG))
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    model.set_weights({name: _flat(tree) for name, tree in jmodel.get_weights().items()})
    load_jax_params(model.perceptual_loss.vgg, _flat(jmodel.perceptual_loss.variables["params"]))
    load_jax_params(model.perceptual_loss_face_reco.vgg,
                    _flat(jmodel.perceptual_loss_face_reco.variables["params"]))
    return jmodel, model


def _photo(seed, n=None):
    shape = (128, 128, 3) if n is None else (n, 128, 128, 3)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _check_leaves(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        if value.size == 0:  # pre_expr: the expression slice opens the tiny config's latent
            continue
        assert np.abs(value).max() > 0, f"{key} has no gradient"
        np.testing.assert_allclose(got[key], value, rtol=1e-3, atol=1e-4 * np.abs(value).max(),
                                   err_msg=key)
    keys = sorted(want)
    want_all = np.concatenate([want[k].ravel() for k in keys])
    got_all = np.concatenate([got[k].ravel() for k in keys])
    assert np.linalg.norm(got_all - want_all) < 1e-3 * np.linalg.norm(want_all)


@pytest.mark.parametrize("n_imgs", [1, 2])
def test_one_iteration_matches_jax(models, n_imgs):
    jmodel, model = models
    rng = np.random.default_rng(n_imgs)
    images = rng.uniform(-1, 1, (n_imgs, 128, 128, 3)).astype(np.float32)
    embeddings = rng.normal(size=(n_imgs, model.config["latent_dim"])).astype(np.float32)
    rotations = (rng.uniform(-1, 1, (n_imgs, 3)) * [np.pi / 6, np.pi / 18, 0]).astype(np.float32)

    variables = model._fine_tune_variables(embeddings, rotations, force_neutral_expression=False)
    assert variables["pre_expr"].shape[0] == variables["post_expr"].shape[0] == 1
    assert variables["expr"].shape == (n_imgs, 6)

    # JAX: the optimised tree and optimiser as its fine_tune_on_img builds them
    opt_vars = {"generator": jax.device_get(jmodel.state.generator_smoothed),
                **{k: jnp.asarray(v.detach().numpy()) for k, v in variables.items()}}
    tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-7)
    state = jmodel.state
    step = jmodel._get_fine_tune_step(False, n_imgs, tx)
    _, opt_state, jloss, jout = step(
        opt_vars, tx.init(opt_vars), jnp.asarray(images), state.discriminator.params,
        state.latent_discriminator.params, state.generator.params["latent_regressor"],
        jmodel.perceptual_loss.variables["params"],
        jmodel.perceptual_loss_face_reco.variables["params"])
    mu = opt_state[0].mu
    want = {f"generator/{k}": v for k, v in _flat(mu["generator"]).items()}
    want.update({k: np.asarray(mu[k]) for k in variables})

    generator = model._fine_tune_generator()
    optimizer = model._fine_tune_optimizer(generator, variables, force_neutral_expression=False)
    losses, out = model._get_fine_tune_step(False, n_imgs)(generator, variables, optimizer,
                                                          torch.from_numpy(images))
    assert model._get_fine_tune_step(False, n_imgs) is model._get_fine_tune_step(False, n_imgs)
    np.testing.assert_allclose(float(losses["loss_sum"]), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4)

    moments = {p: optimizer.state[p]["exp_avg"] for group in optimizer.param_groups
               for p in group["params"]}
    got = {f"generator/{k}": v for k, v in export_jax_tensors(
        (name, moments[p]) for name, p in generator.named_parameters()).items()}
    got.update({k: moments[v].numpy() for k, v in variables.items()})
    _check_leaves(got, want)


def test_fine_tune_on_img_matches_jax(models):
    jmodel, model = models
    img = _photo(3)
    ema_before = {k: v.clone() for k, v in model.generator_smoothed.state_dict().items()}
    lat_before, _ = model.encode_images(img)
    try:
        embeddings, rotations = model.fine_tune_on_img(img, n_iters=2)
        jembeddings, jrotations = jmodel.fine_tune_on_img(img, n_iters=2)
        assert embeddings.shape == (1, model.config["latent_dim"]) and rotations.shape == (1, 3)
        assert embeddings.dtype == rotations.dtype == np.float32
        assert len(model.fine_tune_losses) == 2
        bound = 2 * 2 * LR
        assert np.abs(embeddings - jembeddings).max() <= bound
        assert np.abs(rotations - jrotations).max() <= bound
        assert not np.array_equal(embeddings, lat_before)

        # the fine-tuned generator: near JAX's, apart from the EMA, which is unchanged
        tuned = model._fine_tuned_generator_params
        jtuned = _flat(jax.device_get(jmodel._fine_tuned_generator_params))
        generator = model._generator("gather")
        generator.load_state_dict(tuned)
        got = export_jax_params(generator)
        assert set(got) == set(jtuned)
        for key, value in jtuned.items():
            np.testing.assert_allclose(got[key], value, atol=bound, err_msg=key)
        for key, value in model.generator_smoothed.state_dict().items():
            assert torch.equal(value, ema_before[key]), key
        assert any(not torch.equal(tuned[k], ema_before[k]) for k in tuned)

        # generate_images renders with the fine-tuned weights
        rendered = model.generate_images(embeddings, rotations)
        with torch.no_grad():
            args = torch.from_numpy(embeddings), torch.from_numpy(rotations)
            want = unit_range_to_uint8(generator(*args).numpy())
            ema = unit_range_to_uint8(model.generator_smoothed(*args).numpy())
        assert rendered.shape == (1, 128, 128, 3)
        assert np.abs(rendered.astype(int) - want.astype(int)).max() <= 1
        assert not np.array_equal(rendered, ema)
    finally:
        model._fine_tuned_generator_params = None


def test_generate_images_builds_no_generator_after_a_fine_tune(models, monkeypatch):
    """The fine-tuned inference generator is built once, when the weights
    are set; each generate_images call reuses it."""
    _, model = models
    calls = []
    deepcopy, load_state_dict = copy.deepcopy, torch.nn.Module.load_state_dict

    def counting_deepcopy(*args, **kwargs):
        calls.append("deepcopy")
        return deepcopy(*args, **kwargs)

    def counting_load_state_dict(self, *args, **kwargs):
        calls.append("load_state_dict")
        return load_state_dict(self, *args, **kwargs)

    try:
        embeddings, rotations = model.fine_tune_on_img(_photo(5), n_iters=1)
        built = model._inference_generator()
        assert built is not model.generator_smoothed
        monkeypatch.setattr(copy, "deepcopy", counting_deepcopy)
        monkeypatch.setattr(torch.nn.Module, "load_state_dict", counting_load_state_dict)
        first = model.generate_images(embeddings, rotations)
        second = model.generate_images(embeddings, rotations)
        assert calls == []
        np.testing.assert_array_equal(first, second)
        assert model._inference_generator() is built
        # assigning weights builds the generator once more
        model._fine_tuned_generator_params = model._fine_tuned_generator_params
        assert "deepcopy" in calls and calls.count("load_state_dict") == 1
        assert model._inference_generator() is not built
    finally:
        model._fine_tuned_generator_params = None
    assert model._inference_generator() is model.generator_smoothed


def test_force_neutral_expression_keeps_the_neutral_encoding(models):
    _, model = models
    try:
        embeddings, _ = model.fine_tune_on_img(_photo(2), n_iters=1, force_neutral_expression=True)
    finally:
        model._fine_tuned_generator_params = None
    n_blend = model.config["facemodel_inputs"]["blendshape_values"][0]
    neutral = model.set_facemodel_param_in_latents(
        np.zeros((1, model.config["latent_dim"]), np.float32), "blendshape_values",
        np.zeros((1, n_blend), np.float32))
    idxs = list(model.get_facemodel_param_idxs_in_latent("blendshape_values"))
    np.testing.assert_allclose(embeddings[:, idxs], neutral[:, idxs], atol=1e-5)


def test_fine_tune_writes_its_images_and_refuses_a_mesh(models, tmp_path):
    _, model = models
    img = _photo(4)
    try:
        model.fine_tune_on_img(img, n_iters=2, img_output_dir=str(tmp_path))
        # three images do not shard over two ranks: JAX's ValueError, raised
        # before any collective (so a mesh without a process group will do)
        with pytest.raises(ValueError, match="fine-tune batch 3 must divide over 2 devices"):
            model.fine_tune_on_img(_photo(4, n=3), n_iters=1, mesh=Mesh(None, 2, 0, "cpu"))
    finally:
        model._fine_tuned_generator_params = None
    assert sorted(p.name for p in tmp_path.iterdir()) == ["gt_img.png", "output_00.png",
                                                          "output_01.png"]
    # files hold BGR images (cv2's order), so the decoded RGB is reversed
    gt = unit_range_to_uint8((img / 127.5 - 1.0).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "gt_img.png")), gt[..., ::-1])
    assert np.asarray(Image.open(tmp_path / "output_01.png")).shape == (128, 128, 3)


@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 300, 3)])
def test_png_writer_round_trips(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img[..., ::-1])
    for bad in (img.astype(np.float32), img[..., 0]):
        with pytest.raises(ValueError):
            write_png(str(path), bad)


def test_unit_range_to_uint8_matches_jax():
    values = np.random.default_rng(0).uniform(-1.2, 1.2, (3, 4, 5, 3)).astype(np.float32)
    values[0, 0, 0] = [-1.0, 1.0, 0.0]
    np.testing.assert_array_equal(unit_range_to_uint8(values), jax_unit_range_to_uint8(values))
