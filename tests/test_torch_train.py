"""One fused stage-1 training step of the port against the JAX package's, on
TINY_FIRST_STAGE_CONFIG on the CPU.

Both get the same seven parameter trees and VGG weights, the same host batch
and the same random draws: the JAX step's draws are pinned by patching its
draw functions (on the instance) and ``batched_hflip`` (in its module) for
the trace, in the order the step calls them; the port gets the same arrays
through its three draw methods.  The port runs with
``rotation_resample_train="kernel_train"`` and ``adain_impl="kernel"``, so
the kernels' autograd Functions, with their plain bodies, are on its path.

Compared: every loss (rtol 1e-4); every player's gradient, read as the
optimizers' first moments, which equal the gradient exactly when
beta_1 = 0; the EMA generator (atol 1e-6).  Gradients: per player, the
relative L2 difference of all leaves together below 1e-3, and per leaf rtol
1e-3 with atol 1e-4 of the leaf's largest value.  That atol is set by float32
noise, measured on this config: the port against itself with 1 and 4 CPU
threads differs by up to 3e-5 of a leaf's scale, and leaves whose gradient
is a small residual of cancelling terms (conv and MLP biases feeding an
instance norm) sit 4e-2 (port) and 2e-1 (JAX) of their scale away from a
float64 reference on some host batches.  The host batch is therefore
pinned (batch RNG seeded 0); on it JAX and the port agree to 4e-5.

Parameters after the step are not compared tightly: Adam's first step is
lr * g / (|g| + eps), sign-like, so a leaf with |g| ~ 1e-7 may move by
anything up to 2 * lr on either side.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import confignet_tpu.training.first_stage as jax_first_stage
from helpers import FakeDataset, TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.core.model_io import load_jax_params
from confignet_tpu_torch.training.first_stage import PLAYER_TREES, ConfigNetFirstStage

torch.set_num_threads(1)

BATCH = TINY_FIRST_STAGE_CONFIG["batch_size"]


def _flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


def _draws(latent_dim, seed=0):
    """The step's draws in call order: latents (D fakes, latent-D reals, G
    reals), rotations (D fakes, G reals), flip masks (D reals, synth-D reals)."""
    rng = np.random.default_rng(seed)
    n_real = BATCH - BATCH // 2
    latents = [rng.normal(size=(n, latent_dim)).astype(np.float32) for n in (BATCH, BATCH, n_real)]
    scale = np.array([np.pi / 6, np.pi / 18, 0.0], np.float32)
    rotations = [(rng.uniform(-1, 1, size=(n, 3)) * scale).astype(np.float32) for n in (BATCH, n_real)]
    flips = [np.array([True, False, True, False]), np.array([False, True, True, False])]
    return latents, rotations, flips


def _feeder(arrays, convert):
    """A draw function returning the pinned arrays in order, checking sizes."""
    queue = list(arrays)

    def draw(n):
        value = queue.pop(0)
        assert value.shape[0] == n, (value.shape, n)
        return convert(value)

    draw.remaining = queue
    return draw


@pytest.fixture(scope="module")
def stepped():
    dataset = FakeDataset(n_images=8, img_size=128)
    jmodel = jax_first_stage.ConfigNetFirstStage(dict(TINY_FIRST_STAGE_CONFIG))
    latents, rotations, flips = _draws(jmodel.config["latent_dim"])
    weights = {name: _flat(tree) for name, tree in jmodel.get_weights().items()}
    vgg_params = jmodel.perceptual_loss.variables["params"]
    jmodel._batch_rng = np.random.RandomState(0)
    batch = jmodel._sample_host_batch(dataset, dataset)

    # JAX: pin the draws for the trace of the jitted step
    j_latent, j_rot = _feeder(latents, jnp.asarray), _feeder(rotations, jnp.asarray)
    jmodel._sample_latent_on_device = lambda key, n: j_latent(n)
    jmodel._sample_rotations_on_device = lambda key, n: j_rot(n)
    flip_queue = list(flips)
    hflip = jax_first_stage.batched_hflip
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_first_stage, "batched_hflip",
                      lambda images, mask: hflip(images, jnp.asarray(flip_queue.pop(0))))
        step_fn = jmodel._build_train_step()
        state, jlosses = step_fn(jmodel.state, jmodel.keychain.next(), batch, vgg_params)
    assert not (j_latent.remaining or j_rot.remaining or flip_queue)
    jax_moments = {}
    for player, trees in PLAYER_TREES.items():
        mu = getattr(state, player).opt_state[0].mu  # optax adam: (ScaleByAdamState, ...)
        jax_moments[player] = ({tree: _flat(mu[tree]) for tree in trees}
                               if player == "generator" else {player: _flat(mu)})
    jax_result = dict(losses={k: {kk: float(vv) for kk, vv in v.items()} for k, v in jlosses.items()},
                      moments=jax_moments, ema=_flat(state.generator_smoothed))

    # the port, on the same weights, batch and draws
    model = ConfigNetFirstStage(dict(TINY_FIRST_STAGE_CONFIG, rotation_resample_train="kernel_train",
                                     adain_impl="kernel"), device="cpu")
    model.set_weights(weights)
    load_jax_params(model.perceptual_loss.vgg, _flat(vgg_params))
    model._sample_latent = _feeder(latents, torch.from_numpy)
    model._sample_rotations = _feeder(rotations, torch.from_numpy)
    model._flip_mask = _feeder(flips, torch.from_numpy)
    losses = model._build_train_step()(batch)
    assert not (model._sample_latent.remaining or model._sample_rotations.remaining
                or model._flip_mask.remaining)
    port_result = dict(losses={k: {kk: float(vv) for kk, vv in v.items()} for k, v in losses.items()},
                       moments=model.first_moments(),
                       ema=model.get_weights()["generator_smoothed"])
    return jax_result, port_result


def test_step_losses_match_jax(stepped):
    jax_result, port_result = stepped
    assert set(port_result["losses"]) == set(jax_result["losses"]) == {"g", "d", "synth_d", "latent_d"}
    for group, want in jax_result["losses"].items():
        got = port_result["losses"][group]
        assert set(got) == set(want), group  # jit returns JAX's dicts with sorted keys
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=f"{group}/{key}")
    assert len([k for k in port_result["losses"]["d"] if k.startswith("gp_loss_")]) == 4


@pytest.mark.parametrize("player", list(PLAYER_TREES))
def test_step_gradients_match_jax(stepped, player):
    jax_result, port_result = stepped
    want_trees, got_trees = jax_result["moments"][player], port_result["moments"][player]
    assert set(got_trees) == set(want_trees)
    for tree, want in want_trees.items():
        got = got_trees[tree]
        assert set(got) == set(want), tree
        for key, value in want.items():
            assert np.abs(value).max() > 0, f"{tree}/{key} has no gradient"
            np.testing.assert_allclose(got[key], value, rtol=1e-3, atol=1e-4 * np.abs(value).max(),
                                       err_msg=f"{player}: {tree}/{key}")
    keys = [(tree, key) for tree in sorted(want_trees) for key in sorted(want_trees[tree])]
    want_all = np.concatenate([want_trees[t][k].ravel() for t, k in keys])
    got_all = np.concatenate([got_trees[t][k].ravel() for t, k in keys])
    assert np.linalg.norm(got_all - want_all) < 1e-3 * np.linalg.norm(want_all)


def test_step_ema_matches_jax(stepped):
    jax_result, port_result = stepped
    assert set(port_result["ema"]) == set(jax_result["ema"])
    for key, value in jax_result["ema"].items():
        np.testing.assert_allclose(port_result["ema"][key], value, atol=1e-6, err_msg=key)


def test_two_discriminator_updates_per_step():
    """n_discriminator_updates=2: the host batch stacks two D draws (one G
    draw) and the step takes two steps of each D optimizer, one of G's."""
    config = dict(TINY_FIRST_STAGE_CONFIG, n_discriminator_updates=2)
    model = ConfigNetFirstStage(config, device="cpu")
    dataset = FakeDataset(n_images=8, img_size=128)
    batch = model._sample_host_batch(dataset, dataset)
    assert batch["d_real_imgs"].shape == (2, BATCH, 128, 128, 3)
    assert batch["g_gt_imgs"].shape == (1, BATCH // 2, 128, 128, 3)
    assert all(a.shape[:2] == (2, BATCH) for a in batch["synth_d_facemodel"])
    losses = model._build_train_step()(batch)
    assert all(np.isfinite(float(v)) for group in losses.values() for v in group.values())
    steps = {player: {int(s["step"]) for s in opt.state.values()}
             for player, opt in model.optimizers.items()}
    assert steps == {"generator": {1}, "discriminator": {2}, "synth_discriminator": {2},
                     "latent_discriminator": {2}}
