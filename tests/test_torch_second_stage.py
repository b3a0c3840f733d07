"""One fused stage-2 training step of the port against the JAX package's, on
TINY_FIRST_STAGE_CONFIG on the CPU, plus the stage-2 host batch and the
stage-1 -> stage-2 weight transfer.

Both steps get the same seven parameter trees, the same ``real_encoder``
(its zero-initialised heads given seeded weights on both sides, so the
trunk's gradients are compared rather than zeros), the same VGG19 and
VGGFace weights, the host batch drawn with ``_batch_rng = RandomState(0)``
and the same four flip masks (D reals, synth-D reals, latent-D reals, G
reals): patched into ``batched_hflip`` of the JAX second-stage module for
the trace, fed through ``_flip_mask`` on the port.  The stage-2 step draws
no latents and no rotations.  ``pixel_loss_weight`` and
``encoder_inversion_weight`` are on, so every branch of the G losses is
compared in one JAX compile.

Here the port trains with the gather rotation (``rotation_resample_train=
"gather"``), the full gradient, as the JAX step does on the CPU;
``tests/test_torch_second_stage_kernel_path.py`` compares the kernel path
(transform gradient zero) with the JAX step whose transform gradient is
stopped, the semantics of its TPU kernel.

Tolerances are those of ``tests/test_torch_train.py``: every loss rtol
1e-4; every player's gradient, read as its Adam first moment (beta_1 = 0),
per player a relative L2 distance below 1e-3 and per leaf rtol 1e-3 with
atol 1e-4 of the leaf's largest value; the EMA atol 1e-6.  The ResNet50
trunk's leaves (``real_encoder/resnet/...``) are the exception: each is
held to a relative L2 distance below 1e-3.  Their float32 gradient is not
accurate to 1e-4 of a leaf's largest value in any implementation: the
random trunk's activations reach ~6e4 and the ReLU and max-pool decisions
of elements near a tie flip with the rounding, so the port's own float32
trunk gradient is up to 2e-3 of a leaf's largest value, and 3.5e-4 in
relative L2, from its float64 gradient (:func:`test_trunk_gradient_float32_accuracy`).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import confignet_tpu.training.second_stage as jax_second_stage
from confignet_tpu.training.first_stage import ConfigNetFirstStage as JaxConfigNetFirstStage
from helpers import FakeDataset, TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.core.model_io import export_jax_params, load_jax_params
from confignet_tpu_torch.models.backbones.resnet import resnet50_preprocess
from confignet_tpu_torch.training.first_stage import PLAYER_TREES, ConfigNetFirstStage
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)

BATCH = TINY_FIRST_STAGE_CONFIG["batch_size"]
STAGE2_CONFIG = dict(TINY_FIRST_STAGE_CONFIG, pixel_loss_weight=2.0, encoder_inversion_weight=3.0)
# D reals, synth-D reals, latent-D reals (BATCH each), G reals (BATCH // 2)
FLIPS = [np.array([True, False, True, False]), np.array([False, True, True, False]),
         np.array([True, True, False, False]), np.array([False, True])]


def _flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


def _unflat(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def give_heads_weights(weights):
    """Seeded weights for the encoder's zero-initialised heads, scaled to the
    random trunk's features (as tests/test_torch_serving.py does)."""
    enc = _flat(weights["real_encoder"])
    rng = np.random.default_rng(0)
    for head, std in (("feature_to_latent", 1e-6), ("rotation_regressor", 3e-7)):
        enc[f"{head}/kernel"] = (rng.normal(size=enc[f"{head}/kernel"].shape) * std).astype(np.float32)
    return {**weights, "real_encoder": _unflat(enc)}


def _feeder(arrays, convert):
    queue = list(arrays)

    def draw(n):
        value = queue.pop(0)
        assert value.shape[0] == n, (value.shape, n)
        return convert(value)

    draw.remaining = queue
    return draw


def _losses(groups):
    return {g: {k: float(v) for k, v in d.items()} for g, d in groups.items()}


def stage2_step_results(port_overrides, jax_rotation=None, size=128, *more_port_overrides):
    """(JAX result, port result) of one stage-2 step from the same weights,
    batch and flips: {"losses", "moments", "ema"}.  ``jax_rotation``, where
    given, replaces the JAX generator's rotation resample for the trace;
    ``size`` is the images' side (the config's ``output_shape``).  Each of
    ``more_port_overrides`` adds the result of one more port step."""
    dataset = FakeDataset(n_images=8, img_size=size)
    config = dict(STAGE2_CONFIG, output_shape=(size, size, 3))
    jmodel = jax_second_stage.ConfigNet(dict(config))
    jmodel.set_weights(give_heads_weights(jmodel.get_weights()))
    weights = {name: _flat(tree) for name, tree in jmodel.get_weights().items()}
    vgg = jmodel.perceptual_loss.variables["params"]
    vggface = jmodel.perceptual_loss_face_reco.variables["params"]
    jmodel._batch_rng = np.random.RandomState(0)
    batch = jmodel._sample_host_batch(dataset, dataset)

    flip_queue = list(FLIPS)
    hflip = jax_second_stage.batched_hflip
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_second_stage, "batched_hflip",
                      lambda images, mask: hflip(images, jnp.asarray(flip_queue.pop(0))))
        if jax_rotation is not None:
            import confignet_tpu.models.generator as jax_generator
            patch.setattr(jax_generator, "_resolve_rotation_impl", lambda name: jax_rotation)
        step_fn = jmodel._build_train_step()
        state, jlosses = step_fn(jmodel.state, jmodel.keychain.next(), batch, vgg, vggface)
    assert not flip_queue
    jax_moments = {}
    for player, trees in ConfigNet.PLAYER_TREES.items():
        mu = getattr(state, player).opt_state[0].mu  # optax adam: (ScaleByAdamState, ...)
        jax_moments[player] = ({tree: _flat(mu[tree]) for tree in trees}
                               if player == "generator" else {player: _flat(mu)})
    jax_result = dict(losses=_losses(jlosses), moments=jax_moments,
                      ema=_flat(state.generator_smoothed))

    port_results = []
    for overrides in (port_overrides,) + more_port_overrides:
        model = ConfigNet(dict(config, **overrides), device="cpu")
        model.set_weights(weights)
        load_jax_params(model.perceptual_loss.vgg, _flat(vgg))
        load_jax_params(model.perceptual_loss_face_reco.vgg, _flat(vggface))
        model._flip_mask = _feeder(FLIPS, torch.from_numpy)
        losses = model._build_train_step()(batch)
        assert not model._flip_mask.remaining
        port_results.append(dict(losses=_losses(losses), moments=model.first_moments(),
                                 ema=model.get_weights()["generator_smoothed"]))
    return (jax_result, *port_results)


def check_losses(jax_result, port_result):
    assert set(port_result["losses"]) == set(jax_result["losses"]) == {"g", "d", "synth_d", "latent_d"}
    for group, want in jax_result["losses"].items():
        got = port_result["losses"][group]
        assert set(got) == set(want), group
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=f"{group}/{key}")
    assert {"pixel_loss_synth", "encoder_inversion_loss", "latent_regression_loss",
            "image_loss_real"} <= set(port_result["losses"]["g"])


def check_gradients(jax_result, port_result, player):
    want_trees, got_trees = jax_result["moments"][player], port_result["moments"][player]
    assert set(got_trees) == set(want_trees)
    for tree, want in want_trees.items():
        got = got_trees[tree]
        assert set(got) == set(want), tree
        for key, value in want.items():
            assert np.abs(value).max() > 0, f"{tree}/{key} has no gradient"
            if tree == "real_encoder" and key.startswith("resnet/"):
                assert np.linalg.norm(got[key] - value) < 1e-3 * np.linalg.norm(value), key
                continue
            np.testing.assert_allclose(got[key], value, rtol=1e-3, atol=1e-4 * np.abs(value).max(),
                                       err_msg=f"{player}: {tree}/{key}")
    keys = [(tree, key) for tree in sorted(want_trees) for key in sorted(want_trees[tree])]
    want_all = np.concatenate([want_trees[t][k].ravel() for t, k in keys])
    got_all = np.concatenate([got_trees[t][k].ravel() for t, k in keys])
    assert np.linalg.norm(got_all - want_all) < 1e-3 * np.linalg.norm(want_all)


def check_ema(jax_result, port_result):
    assert set(port_result["ema"]) == set(jax_result["ema"])
    for key, value in jax_result["ema"].items():
        np.testing.assert_allclose(port_result["ema"][key], value, atol=1e-6, err_msg=key)


@pytest.fixture(scope="module")
def stepped():
    return stage2_step_results(dict(rotation_resample_train="gather"))


def test_step_losses_match_jax(stepped):
    check_losses(*stepped)


@pytest.mark.parametrize("player", list(ConfigNet.PLAYER_TREES))
def test_step_gradients_match_jax(stepped, player):
    check_gradients(*stepped, player)


def test_step_ema_matches_jax(stepped):
    check_ema(*stepped)


def test_generator_player_holds_the_encoder():
    assert ConfigNet.PLAYER_TREES["generator"] == PLAYER_TREES["generator"] + ("real_encoder",)
    assert ConfigNetFirstStage.PLAYER_TREES == PLAYER_TREES
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    held = {id(p) for p in model.optimizers["generator"].param_groups[0]["params"]}
    encoder = dict(model.real_encoder.named_parameters())
    # FrozenBatchNorm statistics are parameters of the player, as in JAX's tree
    assert any(name.endswith("moving_mean") for name in encoder)
    assert all(id(p) in held and p.requires_grad for p in encoder.values())
    assert set(model.first_moments()["generator"]) == set(ConfigNet.PLAYER_TREES["generator"])


@pytest.mark.parametrize("n_updates", [(1, 1), (2, 1)])
def test_host_batch_matches_jax(n_updates):
    """The same fields, bytes and order of ``_batch_rng`` draws as the JAX
    package's stage-2 host batch, also when D sub-updates stack draws."""
    dataset = FakeDataset(n_images=8, img_size=128)
    config = dict(TINY_FIRST_STAGE_CONFIG, n_discriminator_updates=n_updates[0],
                  n_generator_updates=n_updates[1])
    jmodel = jax_second_stage.ConfigNet(dict(config), initialize=False)
    model = ConfigNet(dict(config), device="cpu", initialize=False)
    jmodel._batch_rng, model._batch_rng = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(2):
        want = jmodel._sample_host_batch(dataset, dataset)
        got = model._sample_host_batch(dataset, dataset)
        assert list(got) == list(want)
        assert {"d_input_imgs", "latent_d_real_imgs", "g_real_imgs"} <= set(got)
        for key, value in want.items():
            for a, b in zip(jax.tree_util.tree_leaves(got[key]), jax.tree_util.tree_leaves(value)):
                assert a.dtype == b.dtype and a.shape == b.shape, key
                np.testing.assert_array_equal(a, b, err_msg=key)


def _generator_equal(model, weights):
    got = export_jax_params(model.generator)
    assert set(got) == set(weights["generator"])
    for key, value in weights["generator"].items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("encoder_norm", ["frozen", "group"])
def test_stage1_weights_keep_the_encoder(encoder_norm):
    """Stage-1 weights (no ``real_encoder`` tree), from a port
    ConfigNetFirstStage and from the JAX package, load into a port ConfigNet:
    the generator is theirs, the encoder is kept, the optimizers reset."""
    config = dict(TINY_FIRST_STAGE_CONFIG, encoder_norm=encoder_norm)
    model = ConfigNet(dict(config, seed=3), device="cpu")
    encoder_before = export_jax_params(model.real_encoder)
    assert any("stem_bn" in k for k in encoder_before)
    assert any("moving_mean" in k for k in encoder_before) == (encoder_norm == "frozen")

    jax_weights = {name: _flat(tree)
                   for name, tree in JaxConfigNetFirstStage(dict(config)).get_weights().items()}
    port_weights = ConfigNetFirstStage(dict(config), device="cpu").get_weights()
    for weights in (port_weights, jax_weights):
        assert "real_encoder" not in weights
        model.set_weights(weights)
        _generator_equal(model, weights)
        encoder = export_jax_params(model.real_encoder)
        for key, value in encoder_before.items():
            np.testing.assert_array_equal(encoder[key], value, err_msg=key)
        assert not any(opt.state for opt in model.optimizers.values())


def test_trunk_gradient_float32_accuracy():
    """The port's float32 gradient of the random ResNet50 trunk against its
    float64 gradient, for a fixed cotangent on the features of two images:
    within 1e-3 relative L2 per leaf, the bound the parity tests hold the
    trunk's leaves to."""
    encoder = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu").real_encoder
    images = torch.from_numpy(FakeDataset(n_images=2, img_size=128).imgs).float() / 127.5 - 1.0
    cotangent = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 2048)))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        trunk = copy.deepcopy(encoder.resnet).to(dtype)
        features = trunk(resnet50_preprocess(images.to(dtype)))
        params = dict(trunk.named_parameters())
        grads[dtype] = dict(zip(params, torch.autograd.grad(
            (features * cotangent.to(dtype)).sum(), list(params.values()))))
    assert features.abs().max() > 1e4  # the random trunk's scale
    for name, want in grads[torch.float64].items():
        got = grads[torch.float32][name].double()
        assert torch.linalg.norm(got - want) < 1e-3 * torch.linalg.norm(want), name


def test_set_weights_still_needs_every_stage1_tree():
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    weights = model.get_weights()
    del weights["latent_discriminator"]
    with pytest.raises(KeyError, match="latent_discriminator"):
        model.set_weights(weights)
