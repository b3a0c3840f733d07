"""The port's controllability metric (the paper's Table 2) and its CLI
against the JAX package's, on a tiny ``ConfigNet`` on the CPU with the face
model inputs of ``tests/test_metrics.py`` (62 blendshapes, hair colour, a
9-dim beard embedding), the same weights (ConfigNet trees, VGG19, VGGFace,
the attribute judge) and the same face-model distributions on both sides.

- The 8 configs equal JAX's, in JAX's (sorted) order.
- ``get_metrics_from_attribute_images`` on identical images equals JAX's
  within atol 1e-5 (a check of the judge, not of the renders), except the
  correlation coefficients: at random judge weights a driven attribute's
  probabilities over the 6 renders spread by about 1e-3 only, which the
  coefficient divides the judges' ~1e-6 rounding differences by, so they are
  held to 1e-4 (measured up to 1.2e-5).  On identical probabilities
  ``get_metrics_for_attribute_pairs`` equals JAX's within rtol 1e-12.
- ``generate_images_for_metric`` after the same ``np.random`` seed renders
  within a mean abs uint8 difference of 1.0 of JAX's (the serving bound of
  tests/test_serving.py), without and with ``per_image_tuning_iters=1``.
- The port's CLI (``--device cpu``) writes the JAX CLI's file set (JSON,
  CSV, plot and images), and its JSON equals a direct ``get_metrics`` call
  after the same seed.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from flax import traverse_util

from confignet_tpu.apps import evaluate_confignet_controllability as jax_cli
from confignet_tpu.metrics.celeba_attribute_prediction import (
    CelebaAttributeClassifier as JaxClassifier)
from confignet_tpu.metrics.controllability import ControllabilityMetrics as JaxMetrics
from confignet_tpu.metrics.controllability_metric_configs import (
    ControllabilityMetricConfigs as JaxConfigs)
from confignet_tpu.training.second_stage import ConfigNet as JaxConfigNet
from helpers import FakeDistribution, TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.apps import evaluate_confignet_controllability as cli
from confignet_tpu_torch.core.model_io import load_jax_params
from confignet_tpu_torch.data.dataset import NeuralRendererDataset
from confignet_tpu_torch.metrics.celeba_attribute_prediction import CelebaAttributeClassifier
from confignet_tpu_torch.metrics.controllability import ControllabilityMetrics
from confignet_tpu_torch.metrics.controllability_metric_configs import ControllabilityMetricConfigs
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)

ATTRS = sorted(["Black_Hair", "Blond_Hair", "Brown_Hair", "Gray_Hair", "Mouth_Slightly_Open",
                "Narrow_Eyes", "Smiling", "Mustache", "No_Beard", "Goatee", "Sideburns"])
FACEMODEL_INPUTS = {"blendshape_values": (62, 6), "head_hair_color": (3, 4),
                    "beard_style_embedding": (9, 4)}


def _flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


def _distributions():
    rng = np.random.default_rng(0)
    return {"blendshape_values": FakeDistribution(rng.random((4, 62)).astype(np.float32)),
            "head_hair_color": FakeDistribution(rng.random((4, 3)).astype(np.float32)),
            "beard_style_embedding": FakeDistribution(rng.normal(size=(4, 9)).astype(np.float32))}


@pytest.fixture(scope="module")
def pairs():
    """(JAX ConfigNet, port ConfigNet), (JAX judge, port judge) with the same
    weights."""
    config = dict(TINY_FIRST_STAGE_CONFIG, facemodel_inputs=FACEMODEL_INPUTS)
    jmodel = JaxConfigNet(dict(config))
    model = ConfigNet(dict(config), device="cpu")
    model.set_weights({name: _flat(tree) for name, tree in jmodel.get_weights().items()})
    load_jax_params(model.perceptual_loss.vgg, _flat(jmodel.perceptual_loss.variables["params"]))
    load_jax_params(model.perceptual_loss_face_reco.vgg,
                    _flat(jmodel.perceptual_loss_face_reco.variables["params"]))
    jmodel.facemodel_param_distributions = _distributions()
    model.facemodel_param_distributions = _distributions()

    judge_config = {"input_shape": (64, 64, 3), "predicted_attributes": ATTRS}
    jjudge = JaxClassifier(judge_config)
    judge = CelebaAttributeClassifier(judge_config, device="cpu")
    judge.set_weights({tree: _flat(jjudge.variables[tree]) for tree in ("params", "batch_stats")})
    return (jmodel, model), (jjudge, judge)


def _inputs(n=2, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, 128, 128, 3), dtype=np.uint8)


def _mean_abs(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return float(np.mean(np.abs(a.astype(int) - b.astype(int))))


def test_configs_match_jax():
    got, want = ControllabilityMetricConfigs.all_configs(), JaxConfigs.all_configs()
    assert [name for name, _ in got] == [name for name, _ in want] == sorted(n for n, _ in want)
    for (_, a), (_, b) in zip(got, want):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_metrics_from_identical_images_match_jax(pairs):
    _, (jjudge, judge) = pairs
    rng = np.random.default_rng(2)
    names = [name for name, _ in JaxConfigs.all_configs()]
    with_attr = {name: rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8) for name in names}
    without_attr = {name: rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8) for name in names}
    want = JaxMetrics(None, jjudge).get_metrics_from_attribute_images(with_attr, without_attr)
    got = ControllabilityMetrics(None, judge).get_metrics_from_attribute_images(with_attr,
                                                                                without_attr)
    assert list(got) == list(want)
    for key, value in want.items():
        np.testing.assert_allclose(np.ravel(got[key])[:3], np.ravel(value)[:3], atol=1e-5,
                                   err_msg=key)
        if isinstance(value, tuple):  # the correlation coefficient
            np.testing.assert_allclose(got[key][3], value[3], atol=1e-4, err_msg=key)
    assert len([k for k in got if k.endswith("_config")]) == 8

    probs_set, probs_unset = rng.random((2, 6, len(ATTRS)))
    for name, config in JaxConfigs.all_configs():
        np.testing.assert_allclose(
            ControllabilityMetrics(None, judge).get_metrics_for_attribute_pairs(
                probs_set, probs_unset, config),
            JaxMetrics(None, jjudge).get_metrics_for_attribute_pairs(probs_set, probs_unset, config),
            rtol=1e-12)


@pytest.mark.parametrize("tuning_iters", [0, 1])
def test_metric_renders_match_jax(pairs, tuning_iters):
    (jmodel, model), (jjudge, judge) = pairs
    imgs = _inputs()
    np.random.seed(3)
    want = JaxMetrics(jmodel, jjudge, tuning_iters).generate_images_for_metric(imgs)
    np.random.seed(3)
    got = ControllabilityMetrics(model, judge, tuning_iters).generate_images_for_metric(imgs)
    assert _mean_abs(got[0], want[0]) < 1.0
    for side in (1, 2):
        assert list(got[side]) == list(want[side])
        for name in want[side]:
            assert got[side][name].shape == (2, 128, 128, 3)
            assert _mean_abs(got[side][name], want[side][name]) < 1.0, (side, name)
    model._fine_tuned_generator_params = None
    jmodel._fine_tuned_generator_params = None


def test_cli_writes_the_jax_file_set(pairs, tmp_path):
    (_, model), (_, judge) = pairs
    model.save(str(tmp_path), "model")
    judge.save(str(tmp_path), "judge")
    test_set = NeuralRendererDataset((128, 128, 3), is_synthetic=False)
    test_set._initialize_imgs_memmap(3, str(tmp_path / "test_set.pck"))
    test_set.imgs[:] = _inputs(3, seed=4)
    test_set.save(str(tmp_path / "test_set.pck"))

    args = ["--model_path", str(tmp_path / "model.json"),
            "--test_set_path", str(tmp_path / "test_set.pck"),
            "--attribute_classifier_path", str(tmp_path / "judge.json"),
            "--n_samples", "2", "--write_images"]
    np.random.seed(5)
    jax_cli.parse_args(args + ["--output_dir", str(tmp_path / "jax")])
    np.random.seed(5)
    metrics = cli.parse_args(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, names in os.walk(root) for f in names)

    stem = "contr_metrics_tuning_iters_0_model"
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert {stem + ext for ext in (".json", ".csv", ".png")} <= set(files(tmp_path / "port"))
    assert np.loadtxt(tmp_path / "port" / (stem + ".csv"), delimiter=",").shape == (4, 9)  # 8 configs and their means

    np.random.seed(5)
    direct = ControllabilityMetrics(model, judge).get_metrics(test_set.imgs[:2])
    with open(tmp_path / "port" / (stem + ".json")) as fp:
        written = json.load(fp)
    assert written == json.loads(json.dumps(direct)) == json.loads(json.dumps(metrics))
    assert np.isfinite(written["controllability"])
