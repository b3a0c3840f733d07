"""The port's demo, its UI state, the dataset-generation CLI and the model
path helper against the JAX package's, on the CPU at tiny sizes.

- ``BasicUI``, ``LatentInterpolator`` and ``HdriTurntable`` under one key
  sequence: the pose and gaze offsets, the controlled attribute, the exit
  flag, the glided latents and the turntable's splices and wrap equal
  JAX's (the model is a numpy stand-in shared by both).
- ``confignet_demo.run --test_mode --device cpu`` in its three input modes
  (no input: LatentGAN samples; one photo, with one fine-tune iteration; a
  photo directory) on a tiny ConfigNet and LatentGAN that the JAX package
  built and saved, and on the same ConfigNet as a reference release: after
  the same ``np.random`` seed the frame equals JAX's within a mean abs uint8
  difference below 1.0 (the bound of tests/test_torch_serving.py).  The
  model's ``hdri_embedding`` input takes the repo's turntable, so the
  attribute resample splices its first frame.
- ``generate_dataset`` with ``--landmark_backend fake
  --skip_inception_features`` writes the payload and the aligned images
  JAX's CLI writes, for CelebA-labelled photos and synthetic renders.
- ``get_model_paths`` returns JAX's paths; the demo raises without a GPU
  unless given ``--device cpu``.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

import confignet_tpu.core.images as jax_images
from confignet_tpu.apps import basic_ui as jax_basic_ui
from confignet_tpu.apps import confignet_demo as jax_demo
from confignet_tpu.apps import evaluation_utils as jax_evaluation_utils
from confignet_tpu.apps import generate_dataset as jax_generate_dataset
from confignet_tpu.data import distributions as jax_distributions
from confignet_tpu.training.latent_gan import LatentGAN as JaxLatentGAN
from confignet_tpu.training.second_stage import ConfigNet as JaxConfigNet
from helpers import TINY_FIRST_STAGE_CONFIG, write_reference_checkpoint
from confignet_tpu_torch.apps import basic_ui, confignet_demo, evaluation_utils, generate_dataset
from confignet_tpu_torch.core import model_io
from confignet_tpu_torch.core.pickles import read_pickle

torch.set_num_threads(1)

cv2 = pytest.importorskip("cv2")

# the gaze input (three Euler angles, as the demo's gaze offset) and an
# hdri_embedding as wide as the repo's turntable frames
DEMO_INPUTS = {"blendshape_values": (8, 6), "head_hair_color": (3, 4),
               "bone_rotations:left_eye": (3, 2), "hdri_embedding": (50, 3)}
ATTRIBUTES = ("Smiling", "Mustache", "Black_Hair")


class _StandInModel:
    """The model surface BasicUI uses: a config and a latent splice."""

    config = {"facemodel_inputs": {"blendshape_values": (8, 6), "bone_rotations:left_eye": (2, 2),
                                   "head_hair_color": (3, 4), "hdri_embedding": (5, 3)}}

    def set_facemodel_param_in_latents(self, latents, name, value):
        out = np.array(latents, dtype=np.float64, copy=True)
        column = list(self.config["facemodel_inputs"]).index(name)
        out[:, column] = np.sum(value) + 0.5 * column
        return out


def test_basic_ui_matches_jax(tmp_path):
    frames = np.arange(4 * 5, dtype=np.float32).reshape(4, 5)
    np.save(tmp_path / "turntable.npy", frames)
    model = _StandInModel()
    uis = [module.BasicUI(model, str(tmp_path / "turntable.npy"))
           for module in (basic_ui, jax_basic_ui)]
    rng = np.random.default_rng(0)
    targets = [rng.normal(size=(2, 8)) for _ in range(3)]
    keys = "adwsqeIKujlo" + "zzcZ" + "n" + "x" + "n" + "\x1b"
    history = [[], []]
    for step, key in enumerate(keys):
        for ui, record in zip(uis, history):
            if step % 4 == 0:
                ui.retarget(targets[(step // 4) % len(targets)])
            returned = ui.handle_key(ord(key))
            latent = ui.frame_latent()
            ui.advance()
            record.append((returned, ui.rotation_offset.copy(), ui.eye_rotation_offset.copy(),
                           ui.current_attribute, ui.exit, np.array(latent)))
    for got, want in zip(*history):
        assert got[0] == want[0] and got[3:5] == want[3:5]
        for a, b in zip(got[1:3] + got[5:], want[1:3] + want[5:]):
            np.testing.assert_array_equal(a, b)
    assert history[0][-1][4] is True  # Esc exits

    # the turntable: active after one "n", it splices frames 0, 1, ... and wraps
    tables = [module.HdriTurntable(model, str(tmp_path / "turntable.npy"))
              for module in (basic_ui, jax_basic_ui)]
    latent = rng.normal(size=(1, 8))
    for table in tables:
        table.toggle()
    spliced = [[table.apply(latent) for _ in range(6)] for table in tables]
    for a, b in zip(*spliced):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(spliced[0][0], spliced[0][4])
    # a turntable of another width is disabled, as JAX's
    wide = type("Wide", (_StandInModel,), {"config": {"facemodel_inputs": {"hdri_embedding": (7, 3)}}})()
    for module in (basic_ui, jax_basic_ui):
        table = module.HdriTurntable(wide, str(tmp_path / "turntable.npy"))
        table.toggle()
        np.testing.assert_array_equal(table.apply(latent), latent)

    # the glide itself
    interps = [basic_ui.LatentInterpolator(4), jax_basic_ui.LatentInterpolator(4)]
    for interp in interps:
        interp.retarget(targets[0])
        interp.advance()
        interp.retarget(targets[1])
    for _ in range(5):
        np.testing.assert_array_equal(interps[0].value(), interps[1].value())
        for interp in interps:
            interp.advance()


def _write_face_image(path, size=160, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 100, (size, size, 3), dtype=np.uint8)
    cv2.ellipse(img, (size // 2, size // 2), (size // 3, size // 2 - 10), 0, 0, 360,
                (180, 150, 120), -1)
    cv2.imwrite(path, img)


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A tiny ConfigNet (with exemplar distributions) and LatentGAN saved by
    the JAX package, and the ConfigNet again as a reference release."""
    root = tmp_path_factory.mktemp("demo_models")
    model = JaxConfigNet(dict(TINY_FIRST_STAGE_CONFIG, facemodel_inputs=DEMO_INPUTS))
    rng = np.random.default_rng(0)
    model.facemodel_param_distributions = {
        name: jax_distributions.fit_distribution(rng.normal(size=(6, dims[0])).astype(np.float32),
                                                 "exemplar")
        for name, dims in model.config["facemodel_inputs"].items()}
    model.save(str(root), "confignet")
    gan = JaxLatentGAN({"latent_dim": model.config["latent_dim"]})
    gan.save(str(root), "latent_gan")
    reference = write_reference_checkpoint(model, str(root / "reference"))
    return {"confignet": str(root / "confignet.json"), "gan": str(root / "latent_gan.json"),
            "reference": reference}


def _frames(argv, monkeypatch):
    """(the port's frame, JAX's frame, the port's ConfigNet) of one
    --test_mode run each, after the same np.random seed."""
    shown, loaded = [], []
    build = jax_images.build_image_matrix
    load = model_io.load_confignet
    monkeypatch.setattr(jax_images, "build_image_matrix",
                        lambda *a: shown.append(build(*a)) or shown[-1])
    monkeypatch.setattr(model_io, "load_confignet",
                        lambda *a, **k: loaded.append(load(*a, **k)) or loaded[-1])
    np.random.seed(0)
    got = confignet_demo.run(["--test_mode", "--device", "cpu"] + argv)
    np.random.seed(0)
    jax_demo.run(["--test_mode"] + argv)
    return got, shown[-1], loaded[-1]


def _assert_close_frames(got, want, shape):
    assert got.shape == want.shape == shape and got.dtype == want.dtype == np.uint8
    assert got.std() > 0
    assert np.mean(np.abs(got.astype(int) - want.astype(int))) < 1.0


@pytest.mark.parametrize("which", ["confignet", "reference"])
def test_demo_without_input_matches_jax(which, release, monkeypatch):
    got, want, model = _frames(["--confignet_model_path", release[which],
                                "--latent_gan_model_path", release["gan"], "--resolution", "128",
                                "--n_rows", "1", "--n_cols", "2"], monkeypatch)
    _assert_close_frames(got, want, (128, 2 * (2 * 128 + 20), 3))
    assert model._fine_tuned_generator_params is None


def test_demo_single_photo_matches_jax(release, monkeypatch, tmp_path):
    photo = str(tmp_path / "photo.png")
    _write_face_image(photo, seed=77)
    got, want, model = _frames(["--image_path", photo, "--confignet_model_path",
                                release["confignet"], "--latent_gan_model_path", release["gan"],
                                "--resolution", "128", "--landmark_backend", "fake"], monkeypatch)
    _assert_close_frames(got, want, (128, 2 * 128 + 20, 3))
    # the B key's one-shot fine-tune ran one iteration
    assert model._fine_tuned_generator_params is not None and len(model.fine_tune_losses) == 1


def test_demo_photo_directory_matches_jax(release, monkeypatch, tmp_path):
    photos = tmp_path / "photos"
    photos.mkdir()
    for i in range(3):
        _write_face_image(str(photos / f"img_{i}.png"), seed=80 + i)
    got, want, model = _frames(["--image_path", str(photos), "--confignet_model_path",
                                release["confignet"], "--latent_gan_model_path", release["gan"],
                                "--resolution", "128", "--n_rows", "2", "--n_cols", "2",
                                "--landmark_backend", "fake"], monkeypatch)
    _assert_close_frames(got, want, (2 * 128, 2 * (2 * 128 + 20), 3))
    assert model._fine_tuned_generator_params is None


def _dataset_dir(root, synthetic):
    os.makedirs(root)
    for i in range(3):
        _write_face_image(os.path.join(root, f"img_{i:03d}.png"), seed=i)
        if synthetic:
            with open(os.path.join(root, f"meta_{i:03d}.json"), "w") as fp:
                json.dump({"blendshape_values": {"jaw_open": 0.1 * i},
                           "bone_rotations": {"head": [0.02 * i, 0.0, 0.0],
                                              "left_eye": [0.0, 0.0, 0.0]}}, fp)
    with open(os.path.join(root, "list_attr_celeba.txt"), "w") as fp:
        fp.write(f"3\n{' '.join(ATTRIBUTES)}\n")
        for i in range(3):
            fp.write(f"img_{i:03d}.png " + " ".join("1" if (i + k) % 2 else "-1"
                                                  for k in range(len(ATTRIBUTES))) + "\n")


@pytest.mark.parametrize("synthetic", [False, True], ids=["celeba", "synthetic"])
def test_generate_dataset_matches_jax(synthetic, tmp_path):
    payloads, images = {}, {}
    for name, module in (("port", generate_dataset), ("jax", jax_generate_dataset)):
        root = tmp_path / name
        _dataset_dir(str(root / "data"), synthetic)
        argv = ["--dataset_dir", str(root / "data"), "--dataset_name", "set",
                "--output_dir", str(root / "out"), "--img_size", "64", "--landmark_backend", "fake",
                "--skip_inception_features", "--img_output_dir", str(root / "aligned")]
        argv += ["--synthetic_data", "--pre_normalize", "0"] if synthetic else ["--load_attributes"]
        module.parse_args(argv + (["--device", "cpu"] if module is generate_dataset else []))
        path = root / "out" / "set_res_64.pck"
        if name == "port":
            payloads[name] = read_pickle(str(path))
        else:
            with open(path, "rb") as fp:
                payloads[name] = pickle.load(fp)
        images[name] = {os.path.relpath(os.path.join(d, f), root / "aligned"):
                        open(os.path.join(d, f), "rb").read()
                        for d, _, files in os.walk(root / "aligned") for f in files}
        images[name]["imgs"] = open(root / "out" / payloads[name]["imgs_memmap_filename"], "rb").read()
    got, want = payloads["port"], payloads["jax"]
    assert set(got) == set(want) and tuple(got["imgs_memmap_shape"]) == (3, 64, 64, 3)
    for key in ("img_shape", "is_synthetic", "imgs_memmap_filename", "imgs_memmap_shape",
                "imgs_memmap_dtype", "inception_features", "render_metadata", "attributes"):
        assert got[key] == want[key], key
    if synthetic:
        np.testing.assert_array_equal(got["eye_masks"], want["eye_masks"])
    assert images["port"] == images["jax"] and len(images["port"]) > 1


def test_get_model_paths_matches_jax(tmp_path):
    for rel in ("a/model_10.json", "a/model.json", "b/c/checkpoint_7.json", "b/notes.txt"):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("{}")
    for digits_only in (True, False):
        assert (sorted(evaluation_utils.get_model_paths(str(tmp_path), digits_only))
                == sorted(jax_evaluation_utils.get_model_paths(str(tmp_path), digits_only)))
    single = str(tmp_path / "a" / "model.json")
    assert evaluation_utils.get_model_paths(single) == jax_evaluation_utils.get_model_paths(single)
    assert len(evaluation_utils.get_model_paths(str(tmp_path))) == 2


def test_demo_defaults_to_cuda_and_raises_without_it(release, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        confignet_demo.run(["--test_mode", "--confignet_model_path", release["confignet"],
                            "--latent_gan_model_path", release["gan"]])
