"""The port's HDRI PCA model and its CLIs against the JAX package's (host
numpy and cv2, as in the JAX package), on the CPU.

- ``WhitenedPCA`` (a component count and a variance fraction) and
  ``HDRIModelPCA.fit`` under the same ``np.random`` seed give JAX's arrays
  bit for bit, and the same embeddings and reconstructions.
- The shipped ``assets/hdri_model.pck``, pickled under the JAX package's
  class names, loads as the port's classes with JAX's arrays and embeds as
  JAX's does, bit for bit; a model the port saves loads in the JAX package.
- ``build_model`` (with ``--write_hdris``), ``generate_turntable`` (with
  ``--hdri_output_dir``) and ``process_metadata`` write the same files as
  JAX's commands.
"""
import json
import os
import pickle

import cv2
import numpy as np
import pytest

from confignet_tpu.hdri import cli as jax_cli
from confignet_tpu.hdri import pca as jax_pca
from confignet_tpu_torch.hdri import cli, pca

REPO = os.path.join(os.path.dirname(__file__), "..")


def _fake_hdris(n=4, h=32, w=64, seed=0):
    return (np.random.default_rng(seed).random((n, h, w, 3)) * 3).astype(np.float32)


def _assert_same_pca(got, want):
    for name in ("mean_", "components_", "explained_variance_", "explained_variance_ratio_"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("n_components", [4, 0.9, None])
def test_whitened_pca_matches_jax(n_components):
    X = np.random.default_rng(1).normal(size=(30, 10)) * np.linspace(3, 0.1, 10)
    got, want = pca.WhitenedPCA(n_components).fit(X), jax_pca.WhitenedPCA(n_components).fit(X)
    _assert_same_pca(got, want)
    np.testing.assert_array_equal(got.transform(X), want.transform(X))
    z = got.transform(X)
    np.testing.assert_array_equal(got.inverse_transform(z), want.inverse_transform(z))


def test_hdri_model_fit_matches_jax():
    hdris = _fake_hdris(6)
    models = []
    for module in (pca, jax_pca):
        np.random.seed(0)
        model = module.HDRIModelPCA((16, 32), n_rotations_per_image=3)
        model.fit(hdris, n_components=10)
        models.append(model)
    got, want = models
    _assert_same_pca(got.pca_model, want.pca_model)
    rotations = np.linspace(-180, 180, 6)
    np.testing.assert_array_equal(got.transform(hdris, rotations), want.transform(hdris, rotations))
    z = got.transform(hdris)
    np.testing.assert_array_equal(got.inverse_transform(z), want.inverse_transform(z))


def test_shipped_asset_loads_and_pickles_cross_packages(tmp_path):
    path = os.path.join(REPO, "assets", "hdri_model.pck")
    got, want = pca.HDRIModelPCA.load(path), jax_pca.HDRIModelPCA.load(path)
    assert type(got) is pca.HDRIModelPCA and type(got.pca_model) is pca.WhitenedPCA
    assert got.output_shape == want.output_shape and got.pca_model.components_.shape[0] == 50
    _assert_same_pca(got.pca_model, want.pca_model)
    hdris = np.random.default_rng(3).uniform(0, 4, size=(2, 64, 128, 3)).astype(np.float32)
    np.testing.assert_array_equal(got.transform(hdris), want.transform(hdris))

    saved = str(tmp_path / "hdri_model.pck")
    got.save(saved)
    assert b"confignet_tpu.hdri.pca" in open(saved, "rb").read()
    with open(saved, "rb") as fp:
        back = pickle.load(fp)  # the JAX package's classes, by the names written
    assert type(back) is jax_pca.HDRIModelPCA and type(back.pca_model) is jax_pca.WhitenedPCA
    _assert_same_pca(back.pca_model, want.pca_model)
    assert back.output_shape == want.output_shape
    assert back.n_rotations_per_image == want.n_rotations_per_image


def _files(directory):
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(root, name)
            out[os.path.relpath(path, directory)] = path
    return out


def test_cli_commands_write_jax_outputs(tmp_path):
    hdri_dir = tmp_path / "hdris"
    hdri_dir.mkdir()
    for i, img in enumerate(_fake_hdris(3, 32, 64)):
        cv2.imwrite(str(hdri_dir / f"env_{i}.hdr"), img)
    # render metadata naming the HDRIs, for process_metadata
    render_assets = tmp_path / "render_assets"
    render_assets.mkdir()
    os.symlink(hdri_dir, render_assets / "HDRI")

    outputs = {}
    for name, module in (("port", cli), ("jax", jax_cli)):
        out = tmp_path / name
        module.build_model(["--hdri_dir", str(hdri_dir), "--output_dir", str(out / "model"),
                            "--n_components", "5", "--output_shape", "16", "32",
                            "--n_rotations_per_image", "2", "--write_hdris"])
        module.generate_turntable([
            "--hdri_file_path", str(hdri_dir / "env_0.hdr"),
            "--hdri_model_path", str(out / "model" / "hdri_model.pck"),
            "--output_file_path", str(out / "turntable.npy"), "--n_hdri_rotations", "12",
            "--hdri_output_dir", str(out / "turntable_frames")])
        meta_dir = out / "meta"
        meta_dir.mkdir()
        for i in range(4):
            with open(meta_dir / f"meta_{i}.json", "w") as fp:
                json.dump({"illumination": {"HDRI_filename": f"env_{i % 3}.hdr",
                                            "HDRI_rotation": [0.0, 0.0, 0.7 * i]}}, fp)
        module.process_metadata(["--input_dir", str(meta_dir), "--render_asset_dir",
                                 str(render_assets), "--model_path",
                                 str(out / "model" / "hdri_model.pck")])
        outputs[name] = _files(out)

    assert set(outputs["port"]) == set(outputs["jax"])
    assert {"model/hdri_model.pck", "model/pca_basis/000.png", "model/hdris/000_original.hdr",
            "turntable.npy", "turntable_frames/0000.jpg", "meta/meta_3.json"} <= set(outputs["port"])
    for rel, path in outputs["jax"].items():
        if rel.endswith(".pck"):  # the same model, written by each package's pickler
            _assert_same_pca(pca.HDRIModelPCA.load(outputs["port"][rel]).pca_model,
                             pca.HDRIModelPCA.load(path).pca_model)
        else:
            assert open(outputs["port"][rel], "rb").read() == open(path, "rb").read(), rel
    embeddings = np.load(outputs["port"]["turntable.npy"])
    assert embeddings.shape == (12, 5) and embeddings.std(axis=0).mean() > 1e-3
