"""The port's three training CLIs end to end on the CPU (``--device cpu``),
as ``tests/test_apps.py`` drives JAX's, over tiny datasets written by the
port's ``NeuralRendererDataset`` (fake landmark backend): the attribute
classifier for one step, both ConfigNet stages for one step each, then a
``--resume`` rerun that continues stage 2, and the LatentGAN for two steps on
the stage-2 checkpoint.  Without ``--device`` and without a GPU, each CLI
raises at its first model.
"""
import json
import os

import numpy as np
import pytest
import torch

from helpers import TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.apps import train_attribute_classifier, train_confignet, train_latent_gan
from confignet_tpu_torch.data.dataset import NeuralRendererDataset
from confignet_tpu_torch.metrics.blendshape_names import blendshape_names

torch.set_num_threads(1)

ATTRS = ["Black_Hair", "Blond_Hair", "Brown_Hair", "Gray_Hair", "Mouth_Slightly_Open",
         "Narrow_Eyes", "Smiling", "Mustache", "No_Beard", "Goatee", "Sideburns"]
TINY_CLI_CONFIG = dict(TINY_FIRST_STAGE_CONFIG, facemodel_inputs={
    "blendshape_values": [None, 6], "head_hair_color": [None, 4],
    "beard_style_embedding": [None, 4], "bone_rotations:left_eye": [None, 2],
    "hdri_embedding": [None, 3]})


def _write_face_image(path, size=128, seed=0):
    import cv2

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 100, (size, size, 3), dtype=np.uint8)
    cv2.ellipse(img, (size // 2, size // 2), (size // 3, size // 2 - 10), 0, 0, 360,
                (180, 150, 120), -1)
    cv2.imwrite(path, img)


def _metadata(seed):
    rng = np.random.default_rng(seed)
    return {
        "blendshape_values": {n: float(rng.random() * 0.3) for n in blendshape_names[:-1]},
        "bone_rotations": {"neck": [0.0, 0.0, 0.0],
                           "head": [float(rng.uniform(-0.1, 0.1)), 0.0, float(rng.uniform(-0.1, 0.1))],
                           "jaw": [float(rng.random() * 0.1), 0.0, 0.0],
                           "left_eye": [0.0, 0.0, 0.0], "right_eye": [0.0, 0.0, 0.0]},
        "head_hair_color": {"melanin": float(rng.random()), "redness": float(rng.random()),
                            "greyness": 0.0},
        "beard_style_embedding": [float(x) for x in rng.normal(size=9)],
        "hdri_embedding": [float(x) for x in rng.normal(size=5)],
    }


def _dataset(root, name, synthetic):
    image_dir = os.path.join(root, name)
    os.makedirs(image_dir)
    rng = np.random.default_rng(0)
    labels = os.path.join(image_dir, "list_attr_celeba.txt")
    with open(labels, "w") as fp:
        fp.write(f"4\n{' '.join(ATTRS)}\n")
        for i in range(4):
            _write_face_image(os.path.join(image_dir, f"img_{i:03d}.png"), seed=i + 10 * synthetic)
            fp.write(f"img_{i:03d}.png " + " ".join(str(int(rng.random() > 0.5) * 2 - 1)
                                                    for _ in ATTRS) + "\n")
            if synthetic:
                with open(os.path.join(image_dir, f"meta_{i:03d}.json"), "w") as meta:
                    json.dump(_metadata(i), meta)
    path = os.path.join(root, f"{name}.pck")
    NeuralRendererDataset((128, 128, 3), is_synthetic=synthetic).generate_face_dataset(
        image_dir, path, attribute_label_file_path=None if synthetic else labels,
        pre_normalize=False, landmark_backend="fake", compute_inception_features=False)
    return path


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_data"))
    real, synth = _dataset(root, "real", False), _dataset(root, "synth", True)
    judge_dir = os.path.join(root, "judge")
    classifier = train_attribute_classifier.parse_args([
        "--training_set_path", real, "--validation_set_path", real, "--output_dir", judge_dir,
        "--n_epochs", "1", "--steps_per_epoch", "1", "--batch_size", "2", "--device", "cpu"])
    return dict(root=root, real=real, synth=synth, classifier=classifier,
                judge=os.path.join(judge_dir, "checkpoints", "0000.json"))


def _confignet_args(paths, out, *extra):
    return ["--output_dir", out, "--real_training_set_path", paths["real"],
            "--synth_training_set_path", paths["synth"], "--validation_set_path", paths["real"],
            "--attribute_classifier_path", paths["judge"], "--batch_size", "4",
            "--n_samples_for_metrics", "2", "--config_override", json.dumps(TINY_CLI_CONFIG),
            "--device", "cpu", *extra]


def _checkpoints(directory):
    return sorted(f for f in os.listdir(os.path.join(directory, "checkpoints"))
                  if f.endswith(".json") and not f.endswith("_log.json"))


def test_train_attribute_classifier_cli(paths):
    assert os.path.exists(paths["judge"])
    assert paths["classifier"].device == torch.device("cpu")
    assert paths["classifier"].config["predicted_attributes"] == sorted(ATTRS)


def test_train_confignet_cli_and_resume(paths, tmp_path):
    out = str(tmp_path / "confignet")
    model = train_confignet.parse_args(_confignet_args(
        paths, out, "--stage_1_training_steps", "1", "--stage_2_training_steps", "1"))
    assert model.MODEL_TYPE == "ConfigNet" and model.get_resume_step() == 1
    assert _checkpoints(os.path.join(out, "first_stage")) == ["000000.json"]
    assert _checkpoints(out) == ["000000.json"]
    # stage 2 runs with the image-loss weight x10, as in the JAX CLI
    assert model.config["image_loss_weight"] == pytest.approx(10 * 0.00005)
    assert {"kid", "fid", "controllability", "perceptual_loss"} <= set(model.metrics)

    # --resume continues stage 2 from its checkpoint and leaves stage 1 alone
    stage1_files = sorted(os.listdir(os.path.join(out, "first_stage", "checkpoints")))
    resumed = train_confignet.parse_args(_confignet_args(
        paths, out, "--stage_1_training_steps", "1", "--stage_2_training_steps", "3", "--resume"))
    assert resumed.get_resume_step() == 3
    assert sorted(os.listdir(os.path.join(out, "first_stage", "checkpoints"))) == stage1_files
    test_train_confignet_cli_and_resume.model_path = os.path.join(out, "checkpoints", "000000.json")


def test_train_latent_gan_cli(paths, tmp_path):
    model_path = getattr(test_train_confignet_cli_and_resume, "model_path", None)
    if model_path is None:
        pytest.fail("needs the stage-2 checkpoint of test_train_confignet_cli_and_resume")
    out = str(tmp_path / "gan")
    gan = train_latent_gan.parse_args([
        "--confignet_path", model_path, "--training_set_path", paths["real"], "--output_dir", out,
        "--batch_size", "4", "--n_training_steps", "2", "--n_samples_for_metrics", "2",
        "--device", "cpu"])
    assert _checkpoints(out) == ["000000.json"]
    assert gan.metrics["training_step_number"] == [0] and np.isfinite(gan.metrics["fid"]).all()


def test_clis_raise_without_a_gpu(paths, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path)
    confignet_args = _confignet_args(paths, out)[:-2]  # without --device
    with pytest.raises(RuntimeError, match="CUDA"):
        train_confignet.parse_args(confignet_args)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_attribute_classifier.parse_args(["--training_set_path", paths["real"],
                                               "--validation_set_path", paths["real"],
                                               "--output_dir", out])
    model_path = getattr(test_train_confignet_cli_and_resume, "model_path", None)
    if model_path is not None:
        with pytest.raises(RuntimeError, match="CUDA"):
            train_latent_gan.parse_args(["--confignet_path", model_path, "--training_set_path",
                                         paths["real"], "--output_dir", out])
