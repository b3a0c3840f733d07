"""The port's stage-2 ``ConfigNet.train()`` loop and ``LatentGAN.train()``
against the JAX package's, on a tiny ConfigNet on the CPU (the face-model
inputs of ``tests/test_torch_controllability.py``, which the
controllability configs need).

Each package trains its own model from the same global numpy seed on the
same data with every checkpoint period 1: stage 2 for 2 steps with a
validation set and an attribute judge saved by the port to a json path
(which either package loads), the LatentGAN for 4 steps with a verbose log
every 2, each on its own package's stage-2 model.  Compared: the relative
file sets under ``output_dir``, the tables' row counts, the metric keys and
the steps the metrics were taken at; the values are checked finite.
"""
import os

import numpy as np
import pytest
import torch

from confignet_tpu.training.latent_gan import LatentGAN as JaxLatentGAN
from confignet_tpu.training.second_stage import ConfigNet as JaxConfigNet
from helpers import FakeDataset, TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.metrics.celeba_attribute_prediction import CelebaAttributeClassifier
from confignet_tpu_torch.training.latent_gan import LatentGAN
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)

ATTRS = sorted(["Black_Hair", "Blond_Hair", "Brown_Hair", "Gray_Hair", "Mouth_Slightly_Open",
                "Narrow_Eyes", "Smiling", "Mustache", "No_Beard", "Goatee", "Sideburns"])
FACEMODEL_INPUTS = {"blendshape_values": (62, 6), "head_hair_color": (3, 4),
                    "beard_style_embedding": (9, 4)}
CONFIG = dict(TINY_FIRST_STAGE_CONFIG, facemodel_inputs=FACEMODEL_INPUTS, image_checkpoint_period=1,
              metrics_checkpoint_period=1, loss_print_period=2)
STEPS = 2
GAN_CONFIG = {"batch_size": 4, "verbose_log_period": 2, "n_samples_for_metrics": 2,
              "logging_img_square_size": 2, "loss_print_period": 3}
GAN_STEPS = 4


def _dataset(seed):
    dataset = FakeDataset(n_images=8, img_size=128, seed=seed,
                          facemodel_dims={name: dims[0] for name, dims in FACEMODEL_INPUTS.items()})
    # ground-truth Inception features of the extractor's width: no extraction
    dataset.inception_features = np.random.default_rng(seed).normal(size=(8, 2048)).astype(np.float32)
    return dataset


def _files(directory):
    return sorted(os.path.relpath(os.path.join(root, name), directory)
                  for root, _, names in os.walk(directory) for name in names)


class Recorder:
    """An ``aml_run`` stand-in: records ``log(name, value)``."""

    def __init__(self):
        self.calls = []

    def log(self, name, value):
        self.calls.append((name, value))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage2_loops")
    dataset, validation = _dataset(0), _dataset(1)
    judge = CelebaAttributeClassifier({"input_shape": (64, 64, 3), "predicted_attributes": ATTRS},
                                      device="cpu")
    judge.save(str(root / "judge"), "judge")
    judge_path = str(root / "judge" / "judge.json")

    results = {}
    for name, make in (("jax", lambda: JaxConfigNet(dict(CONFIG))),
                       ("port", lambda: ConfigNet(dict(CONFIG), device="cpu"))):
        np.random.seed(0)
        model = make()
        rec = Recorder()
        np.random.seed(3)
        result = model.train(dataset, dataset, validation, judge_path, str(root / name),
                             str(root / (name + "_logs")), n_steps=STEPS, n_samples_for_metrics=2,
                             aml_run=rec)
        results[name] = dict(model=model, result=result, out=root / name, calls=rec.calls)

    for name, make in (("jax", lambda d: JaxLatentGAN(dict(GAN_CONFIG, latent_dim=d))),
                       ("port", lambda d: LatentGAN(dict(GAN_CONFIG, latent_dim=d), device="cpu"))):
        confignet = results[name]["model"]
        np.random.seed(4)
        gan = make(confignet.config["latent_dim"])
        out = root / (name + "_gan")
        gan.train(validation, confignet, str(out), str(root / (name + "_gan_logs")), n_iters=GAN_STEPS)
        results[name + "_gan"] = dict(model=gan, out=out)
    return results


def test_stage2_loop_writes_the_jax_files(runs):
    port, jax = runs["port"], runs["jax"]
    assert _files(port["out"]) == _files(jax["out"])
    assert {"checkpoints/000001.npz", "output_imgs/000001.png", "output_imgs/000001_synth.jpg",
            "image_metrics.txt", "controllability_metrics.json"} <= set(_files(port["out"]))
    assert port["result"]["steps_run"] == jax["result"]["steps_run"] == STEPS
    assert [n for n, _ in port["calls"]] == [n for n, _ in jax["calls"]]
    for table in ("generator_losses.txt", "discriminator_losses.txt", "image_metrics.txt"):
        got, want = (np.atleast_2d(np.loadtxt(run["out"] / table)) for run in (port, jax))
        assert got.shape == want.shape, table
        assert np.isfinite(got).all(), table
    assert np.loadtxt(port["out"] / "image_metrics.txt").shape == (STEPS,)
    metrics, want = port["model"].metrics, jax["model"].metrics
    assert set(metrics) == set(want)
    assert {"kid", "fid", "perceptual_loss", "controllability"} <= set(metrics)
    assert metrics["training_step_number"] == want["training_step_number"] == [0, 1]
    for key in ("kid", "fid", "perceptual_loss", "controllability"):
        assert len(metrics[key]) == STEPS and np.isfinite(metrics[key]).all(), key


def test_latent_gan_loop_writes_the_jax_files(runs):
    port, jax = runs["port_gan"], runs["jax_gan"]
    assert _files(port["out"]) == _files(jax["out"])
    assert {"checkpoints/000000.npz", "checkpoints/000002.json"} <= set(_files(port["out"]))
    metrics, want = port["model"].metrics, jax["model"].metrics
    assert set(metrics) == set(want) == {"training_step_number", "kid", "fid"}
    assert metrics["training_step_number"] == want["training_step_number"] == [0, 2]
    assert np.isfinite(metrics["kid"]).all() and np.isfinite(metrics["fid"]).all()
