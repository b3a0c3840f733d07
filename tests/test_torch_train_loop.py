"""The port's stage-1 ``train()`` loop against the JAX package's, on
TINY_FIRST_STAGE_CONFIG on the CPU.

Both loops get the same seven parameter trees and VGG weights, the same
batch stream (``_batch_rng = RandomState(0)``), the same global numpy seed
before ``train()`` (so ``setup_training`` draws the same metric sample,
metric latents and panel inputs), and the same step draws: the JAX step
bakes its pinned draws in when it is traced (as ``tests/test_torch_train.py``
pins them), so the port's draw methods return the same arrays every step.
Both run 3 steps with every checkpoint period 1, FID/KID on 2 samples, and
checkpoints inline; an ``aml_run`` recorder takes the latest values in place
of the loss plots.

Compared: the relative file sets under ``output_dir``; the loss tables'
headers and row counts; row 0 of each table at the single-step test's rtol
(1e-4) -- later rows drift once Adam's sign-like first step has moved tiny
leaves, so they are only checked finite; ``metrics["training_step_number"]``
and the metric keys; the sink's call names.  Then: the port's async and sync
loops write identical files (bit-equal on the CPU); a resumed port loop
keeps checkpointing (as JAX's ``test_resumed_train_keeps_checkpointing``);
and a checkpoint of either package's loop continues in the other's loop at
``get_resume_step()``.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import confignet_tpu.training.first_stage as jax_first_stage
from confignet_tpu.core.model_io import load_confignet as jax_load_confignet
from helpers import FakeDataset, TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.core.model_io import load_jax_params
from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage

torch.set_num_threads(1)

BATCH = TINY_FIRST_STAGE_CONFIG["batch_size"]
CONFIG = dict(TINY_FIRST_STAGE_CONFIG, image_checkpoint_period=1, metrics_checkpoint_period=1,
              loss_print_period=2, async_checkpointing=False)
STEPS = 3
TABLES = ("generator", "discriminator", "synth_discriminator", "latent_discriminator")


def _flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


def _dataset():
    dataset = FakeDataset(n_images=8, img_size=128)
    # ground-truth Inception features of the extractor's width: no extraction
    dataset.inception_features = np.random.default_rng(2).normal(size=(8, 2048)).astype(np.float32)
    return dataset


def _draws(latent_dim, seed=0):
    """One step's draws in call order: latents (D fakes, latent-D reals, G
    reals), rotations (D fakes, G reals), flip masks (D reals, synth-D reals)."""
    rng = np.random.default_rng(seed)
    n_real = BATCH - BATCH // 2
    latents = [rng.normal(size=(n, latent_dim)).astype(np.float32) for n in (BATCH, BATCH, n_real)]
    scale = np.array([np.pi / 6, np.pi / 18, 0.0], np.float32)
    rotations = [(rng.uniform(-1, 1, size=(n, 3)) * scale).astype(np.float32) for n in (BATCH, n_real)]
    flips = [np.array([True, False, True, False]), np.array([False, True, True, False])]
    return latents, rotations, flips


def _feeder(arrays):
    """The JAX side: pops the pinned arrays in order while the step is traced."""
    queue = list(arrays)

    def draw(key, n):
        value = queue.pop(0)
        assert value.shape[0] == n, (value.shape, n)
        return jnp.asarray(value)

    return draw


def _cycler(arrays):
    """The port side: the same arrays, in the same order, every step."""
    calls = [0]

    def draw(n):
        value = arrays[calls[0] % len(arrays)]
        calls[0] += 1
        assert value.shape[0] == n, (value.shape, n)
        return torch.from_numpy(value)

    return draw


class Recorder:
    """An ``aml_run`` stand-in: records ``log(name, value)``."""

    def __init__(self):
        self.calls = []

    def log(self, name, value):
        self.calls.append((name, value))


def _files(directory):
    return sorted(os.path.relpath(os.path.join(root, name), directory)
                  for root, _, names in os.walk(directory) for name in names)


def _table(path):
    with open(path) as fp:
        header = fp.readline()
    return header, np.atleast_2d(np.loadtxt(path))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("loops")
    dataset = _dataset()
    # the first import of TensorFlow draws from the global numpy RNG; the
    # JAX writer imports it inside setup_training, so import it first
    import tensorflow  # noqa: F401
    np.random.seed(0)
    jmodel = jax_first_stage.ConfigNetFirstStage(dict(CONFIG))
    latents, rotations, flips = _draws(jmodel.config["latent_dim"])
    weights = {name: _flat(tree) for name, tree in jmodel.get_weights().items()}
    vgg = _flat(jmodel.perceptual_loss.variables["params"])

    jmodel._batch_rng = np.random.RandomState(0)
    jmodel._sample_latent_on_device = _feeder(latents)
    jmodel._sample_rotations_on_device = _feeder(rotations)
    flip_queue = list(flips)
    hflip = jax_first_stage.batched_hflip
    jax_rec = Recorder()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_first_stage, "batched_hflip",
                      lambda images, mask: hflip(images, jnp.asarray(flip_queue.pop(0))))
        np.random.seed(5)
        jax_result = jmodel.train(dataset, dataset, str(root / "jax"), str(root / "jax_logs"),
                                  n_steps=STEPS, n_samples_for_metrics=2, aml_run=jax_rec)
    assert not flip_queue

    def port_run(name, async_checkpointing):
        model = ConfigNetFirstStage(dict(CONFIG, async_checkpointing=async_checkpointing),
                                    device="cpu")
        model.set_weights(weights)
        load_jax_params(model.perceptual_loss.vgg, vgg)
        model._batch_rng = np.random.RandomState(0)
        model._sample_latent = _cycler(latents)
        model._sample_rotations = _cycler(rotations)
        model._flip_mask = _cycler(flips)
        rec = Recorder()
        np.random.seed(5)
        result = model.train(dataset, dataset, str(root / name), str(root / (name + "_logs")),
                             n_steps=STEPS, n_samples_for_metrics=2, aml_run=rec)
        return dict(model=model, result=result, calls=rec.calls, out=root / name)

    return dict(root=root, dataset=dataset,
                jax=dict(model=jmodel, result=jax_result, calls=jax_rec.calls, out=root / "jax"),
                sync=port_run("port_sync", False), async_=port_run("port_async", True))


def test_loop_writes_the_jax_files(runs):
    port, jax = runs["sync"], runs["jax"]
    assert _files(port["out"]) == _files(jax["out"])
    assert {"checkpoints/000002.npz", "output_imgs/000002_synth.jpg", "generator_losses.txt",
            "inception_metrics.txt"} <= set(_files(port["out"]))
    assert port["result"]["steps_run"] == jax["result"]["steps_run"] == STEPS
    assert port["model"].checkpoint_events_run == jax["model"].checkpoint_events_run == STEPS
    assert [name for name, _ in port["calls"]] == [name for name, _ in jax["calls"]]


def test_loss_tables_match_jax(runs):
    port, jax = runs["sync"], runs["jax"]
    for table in TABLES:
        got_header, got = _table(port["out"] / f"{table}_losses.txt")
        want_header, want = _table(jax["out"] / f"{table}_losses.txt")
        assert got_header == want_header, table
        assert got.shape == want.shape == (STEPS, len(want_header.split("\t"))), table
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4, err_msg=table)
        assert np.isfinite(got).all(), table


def test_setup_draws_match_jax(runs):
    """setup_training draws the metric sample, the metric latents and
    rotations and the panel inputs in JAX's order from the global seed."""
    port, jax = runs["sync"]["model"], runs["jax"]["model"]
    np.testing.assert_array_equal(port._inception_metric_object.gt_inception_features,
                                  jax._inception_metric_object.gt_inception_features)
    for name in ("_generator_input_for_metrics", "_checkpoint_visualization_input"):
        got, want = getattr(port, name), getattr(jax, name)
        assert set(got) == set(want), name
        for key, value in want.items():
            if key == "facemodel_params":
                for a, b in zip(got[key], value):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(got[key], value, err_msg=f"{name}/{key}")


def test_metrics_match_jax(runs):
    port, jax = runs["sync"]["model"], runs["jax"]["model"]
    assert port.metrics["training_step_number"] == jax.metrics["training_step_number"] == [0, 1, 2]
    assert set(port.metrics) == set(jax.metrics) == {"training_step_number", "kid", "fid"}
    assert all(np.isfinite(port.metrics[k]).all() for k in ("kid", "fid"))


def test_async_and_sync_loops_write_identical_files(runs):
    sync, async_ = runs["sync"]["out"], runs["async_"]["out"]
    assert _files(sync) == _files(async_)
    for name in _files(sync):
        if name.endswith(".npz"):  # (the zip members carry their write times)
            a, b = np.load(sync / name), np.load(async_ / name)
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name}: {key}")
        elif name.endswith(".json") and not name.endswith("_log.json"):  # the configs differ
            a, b = (json.loads((d / name).read_text()) for d in (sync, async_))
            assert (a.pop("async_checkpointing"), b.pop("async_checkpointing")) == (False, True)
            assert a == b, name
        else:
            assert (sync / name).read_bytes() == (async_ / name).read_bytes(), name
    assert runs["async_"]["model"].metrics == runs["sync"]["model"].metrics


def test_resumed_train_keeps_checkpointing(tmp_path):
    """The port's counterpart of JAX's ``test_resumed_train_keeps_checkpointing``
    (tests/test_first_stage.py:292-322): a resumed loop starts at the count
    of completed steps, so its checkpoint gates stay in step."""
    dataset = _dataset()
    model = ConfigNetFirstStage(dict(TINY_FIRST_STAGE_CONFIG, loss_print_period=1,
                                     async_checkpointing=False), device="cpu")
    model.train(dataset, dataset, str(tmp_path), str(tmp_path / "logs"), n_steps=3,
                n_samples_for_metrics=2)
    assert model.get_resume_step() == 3
    assert model.checkpoint_events_run == 1  # step 0 only

    model.config["image_checkpoint_period"] = 2
    model.config["metrics_checkpoint_period"] = 2
    result = model.train(dataset, dataset, str(tmp_path), str(tmp_path / "logs"), n_steps=7,
                         n_samples_for_metrics=2)
    assert result["steps_run"] == 4 and model.get_resume_step() == 7
    assert model.checkpoint_events_run == 3  # steps 4 and 6
    assert model.metrics["training_step_number"] == [0, 4, 6]
    imgs = os.listdir(tmp_path / "output_imgs")
    assert {"000004.png", "000006.png", "000006_synth.jpg"} <= set(imgs)
    assert model.train(dataset, dataset, str(tmp_path), str(tmp_path / "logs"), n_steps=5,
                       n_samples_for_metrics=2)["steps_run"] == 0


def _history(out, step):
    with open(out / "checkpoints" / f"{step:06d}_log.json") as fp:
        return json.load(fp)


def test_jax_checkpoint_continues_in_the_port_loop(runs, tmp_path):
    jax_out = runs["jax"]["out"]
    model = ConfigNetFirstStage.load(str(jax_out / "checkpoints" / "000002.json"), device="cpu")
    assert model.get_resume_step() == runs["jax"]["model"].get_resume_step() == STEPS
    result = model.train(runs["dataset"], runs["dataset"], str(tmp_path), str(tmp_path / "logs"),
                         n_steps=STEPS + 2, n_samples_for_metrics=2)
    assert result["steps_run"] == 2 and model.get_resume_step() == STEPS + 2
    assert {"checkpoints/000003.npz", "checkpoints/000004.npz"} <= set(_files(tmp_path))
    got, want = _history(tmp_path, 4), _history(jax_out, 2)
    assert got["g_losses"]["loss_sum"][:STEPS] == want["g_losses"]["loss_sum"]
    assert len(got["g_losses"]["loss_sum"]) == STEPS + 2
    assert np.isfinite(got["g_losses"]["loss_sum"]).all()


def test_port_checkpoint_continues_in_the_jax_loop(runs, tmp_path):
    port_out = runs["sync"]["out"]
    jmodel = jax_load_confignet(str(port_out / "checkpoints" / "000002.json"))
    assert jmodel.get_resume_step() == runs["sync"]["model"].get_resume_step() == STEPS
    result = jmodel.train(runs["dataset"], runs["dataset"], str(tmp_path), str(tmp_path / "logs"),
                          n_steps=STEPS + 1, n_samples_for_metrics=2)
    assert result["steps_run"] == 1 and jmodel.get_resume_step() == STEPS + 1
    got, want = _history(tmp_path, 3), _history(port_out, 2)
    assert got["g_losses"]["loss_sum"][:STEPS] == want["g_losses"]["loss_sum"]
    assert np.isfinite(got["g_losses"]["loss_sum"]).all()
