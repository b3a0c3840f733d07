"""The port's data layer against the JAX package's (numpy and cv2 on the CPU;
the port keeps its own copies of these modules).

- CelebA attribute files, the similarity transform, the rxyz Euler matrix,
  the fake landmark backend's files and the CSV / details readers give the
  JAX package's values exactly.
- ``generate_face_dataset`` on the same image directory (real photos with
  CelebA labels; synthetic renders with metadata, eye masks and pose
  filtering) writes the same image bytes, eye masks and attributes, and
  ``process_metadata`` gives equal inputs, labels and distributions (equal
  draws after the same seed).
- A dataset saved by either package loads in the other (the payload pickle
  and the images memmap).
- ``ProceduralFaceDataset(seed)`` is byte-equal to JAX's.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from confignet_tpu.data import celeba as jax_celeba
from confignet_tpu.data import dataset as jax_dataset
from confignet_tpu.data import landmarks as jax_landmarks
from confignet_tpu.data import normalizer as jax_normalizer
from confignet_tpu.data import procedural as jax_procedural
from confignet_tpu_torch.data import celeba, dataset, landmarks, normalizer, procedural

torch.set_num_threads(1)

ATTRIBUTES = ("Smiling", "Mustache", "Black_Hair")


def _write_face_image(path, size=160, seed=0):
    import cv2

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 100, (size, size, 3), dtype=np.uint8)
    cv2.ellipse(img, (size // 2, size // 2), (size // 3, size // 2 - 10), 0, 0, 360,
                (180, 150, 120), -1)
    cv2.imwrite(path, img)


def _metadata(seed, head_pose):
    rng = np.random.default_rng(seed)
    return {
        "blendshape_values": {f"shape_{i}": float(rng.random()) for i in range(5)},
        "bone_rotations": {"head": list(head_pose), "jaw": [float(rng.random() * 0.1), 0.0, 0.0],
                           "left_eye": [0.0, 0.0, 0.0]},
        "texture_embedding": [float(x) for x in rng.normal(size=4)],
        "head_hair_style": ["spiky", "bald", None][seed % 3],
    }


def _image_dir(root, n, synthetic):
    os.makedirs(root)
    for i in range(n):
        _write_face_image(os.path.join(root, f"img_{i:03d}.png"), seed=i)
        if synthetic:
            # the last pose is outside the head range and gets filtered
            pose = (0.02 * i, 0.0, -0.01 * i) if i < n - 1 else (2.0, 0.0, 0.0)
            with open(os.path.join(root, f"meta_{i:03d}.json"), "w") as fp:
                json.dump(_metadata(i, pose), fp)
    with open(os.path.join(root, "list_attr_celeba.txt"), "w") as fp:
        fp.write(f"{n}\n{' '.join(ATTRIBUTES)}\n")
        for i in range(n):
            fp.write(f"img_{i:03d}.png " + " ".join("1" if (i + k) % 2 else "-1"
                                                  for k in range(len(ATTRIBUTES))) + "\n")


def _same_draws(got, want, seed=5):
    assert set(got) == set(want)
    for name in want:
        np.random.seed(seed)
        a = want[name].sample(7)[0]
        np.random.seed(seed)
        b = got[name].sample(7)[0]
        np.testing.assert_array_equal(a, b)


def test_celeba_parse_matches_jax(tmp_path):
    _image_dir(str(tmp_path / "d"), 4, synthetic=False)
    path = str(tmp_path / "d" / "list_attr_celeba.txt")
    assert celeba.parse_celeba_attribute_file(path) == jax_celeba.parse_celeba_attribute_file(path)


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(0)
    src, dst = rng.normal(size=(5, 2)), rng.normal(size=(5, 2))
    for got, want in zip(normalizer.get_similarity_transform(dst, src),
                         jax_normalizer.get_similarity_transform(dst, src)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(normalizer.euler_matrix_rxyz(0.3, -0.2, 0.5),
                                  jax_normalizer.euler_matrix_rxyz(0.3, -0.2, 0.5))
    np.testing.assert_array_equal(landmarks._canonical_landmarks(),
                                  jax_landmarks._canonical_landmarks())


def test_fake_landmark_backend_files_match_jax(tmp_path):
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        _write_face_image(str(tmp_path / sub / "img_000.png"))
    landmarks.get_backend("fake").detect_dir(str(tmp_path / "port"))
    jax_landmarks.get_backend("fake").detect_dir(str(tmp_path / "jax"))
    for name in ("img_000.csv", "img_000_of_details.txt"):
        assert (tmp_path / "port" / "processed" / name).read_bytes() == \
            (tmp_path / "jax" / "processed" / name).read_bytes()
    assert (tmp_path / "port" / "landmarks_detected").exists()

    csv_path = str(tmp_path / "port" / "processed" / "img_000.csv")
    for got, want in zip(landmarks.read_landmarks_and_pose_from_csv(csv_path),
                         jax_landmarks.read_landmarks_and_pose_from_csv(csv_path)):
        np.testing.assert_array_equal(got, want)
    details = str(tmp_path / "port" / "processed" / "img_000_of_details.txt")
    np.testing.assert_array_equal(landmarks.read_estimated_intrinsics(details),
                                  jax_landmarks.read_estimated_intrinsics(details))
    with pytest.raises(ValueError):
        landmarks.get_backend("nonexistent")


def test_normalize_individual_image_matches_jax(tmp_path):
    import cv2

    _write_face_image(str(tmp_path / "src.png"), seed=3)
    img = cv2.imread(str(tmp_path / "src.png"))
    got = normalizer.FaceImageNormalizer.normalize_individual_image(img, (64, 64), "fake")
    want = jax_normalizer.FaceImageNormalizer.normalize_individual_image(img, (64, 64), "fake")
    assert got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("synthetic", [False, True], ids=["real", "synthetic"])
def test_generate_face_dataset_matches_jax(tmp_path, synthetic):
    built = {}
    for name, module in (("port", dataset), ("jax", jax_dataset)):
        root = str(tmp_path / name)
        _image_dir(os.path.join(root, "data"), 4, synthetic)
        ds = module.NeuralRendererDataset((64, 64, 3), is_synthetic=synthetic)
        ds.generate_face_dataset(
            os.path.join(root, "data"), os.path.join(root, "ds.pck"),
            attribute_label_file_path=os.path.join(root, "data", "list_attr_celeba.txt"),
            pre_normalize=not synthetic, landmark_backend="fake", compute_inception_features=False)
        built[name] = ds
    port, jax = built["port"], built["jax"]
    assert port.imgs.shape == jax.imgs.shape == ((3 if synthetic else 4), 64, 64, 3)
    assert port.imgs.tobytes() == jax.imgs.tobytes()
    assert port.attributes == jax.attributes
    assert port.imgs_memmap_filename == jax.imgs_memmap_filename == "ds_imgs.dat"
    np.testing.assert_array_equal(port.get_attribute_values([0, 2], ATTRIBUTES),
                                  jax.get_attribute_values([0, 2], ATTRIBUTES))
    if not synthetic:
        return
    # no uv_*.exr maps (this cv2 build has no EXR codec): empty masks on both sides
    assert port.eye_masks.shape == (3, 64, 64)
    np.testing.assert_array_equal(port.eye_masks, jax.eye_masks)
    assert port.render_metadata == jax.render_metadata

    configs = {}
    for name, ds in built.items():
        configs[name] = {"facemodel_inputs": {"blendshape_values": (None, 6),
                                              "head_hair_style": (None, 2),
                                              "texture_embedding": (None, 4),
                                              "bone_rotations:left_eye": (None, 2)}}
        ds.process_metadata(configs[name], update_config=True)
    assert configs["port"] == configs["jax"]
    assert set(port.metadata_inputs) == set(jax.metadata_inputs)
    for key, value in jax.metadata_inputs.items():
        np.testing.assert_array_equal(port.metadata_inputs[key], value)
    assert port.metadata_input_labels == jax.metadata_input_labels
    assert port.metadata_input_labels["blendshape_values"][-1] == "jaw_opening"
    _same_draws(port.metadata_input_distributions, jax.metadata_input_distributions)


def test_dataset_files_load_across_packages(tmp_path):
    """A processed synthetic dataset saved by JAX loads in the port, and the
    port's re-save loads in JAX: every field equal, the same memmap."""
    root = str(tmp_path / "jax")
    _image_dir(os.path.join(root, "data"), 4, synthetic=True)
    jax_ds = jax_dataset.NeuralRendererDataset((64, 64, 3), is_synthetic=True)
    jax_ds.generate_face_dataset(
        os.path.join(root, "data"), os.path.join(root, "ds.pck"),
        attribute_label_file_path=os.path.join(root, "data", "list_attr_celeba.txt"),
        pre_normalize=False, landmark_backend="fake", compute_inception_features=False)
    jax_ds.process_metadata({"facemodel_inputs": {"blendshape_values": (None, 6),
                                                  "head_hair_style": (None, 2)}})
    jax_ds.inception_features = np.random.default_rng(0).normal(size=(3, 2048)).astype(np.float32)
    jax_ds.save(os.path.join(root, "ds.pck"))

    def check(got, want):
        assert got.img_shape == want.img_shape and got.is_synthetic == want.is_synthetic
        np.testing.assert_array_equal(got.head_rotation_range, want.head_rotation_range)
        np.testing.assert_array_equal(got.imgs, want.imgs)
        np.testing.assert_array_equal(got.eye_masks, want.eye_masks)
        np.testing.assert_array_equal(got.inception_features, want.inception_features)
        assert got.attributes == want.attributes and got.render_metadata == want.render_metadata
        assert got.metadata_input_labels == want.metadata_input_labels
        for key, value in want.metadata_inputs.items():
            np.testing.assert_array_equal(got.metadata_inputs[key], value)
        _same_draws(got.metadata_input_distributions, want.metadata_input_distributions)

    port_ds = dataset.NeuralRendererDataset.load(os.path.join(root, "ds.pck"))
    check(port_ds, jax_ds)
    port_dir = str(tmp_path / "port")
    os.makedirs(port_dir)
    shutil.copy(os.path.join(root, "ds_imgs.dat"), port_dir)
    port_ds.save(os.path.join(port_dir, "ds.pck"))
    back = jax_dataset.NeuralRendererDataset.load(os.path.join(port_dir, "ds.pck"))
    check(back, jax_ds)
    assert type(back.metadata_input_distributions["blendshape_values"]).__module__ == \
        "confignet_tpu.data.distributions"


def test_procedural_dataset_matches_jax():
    port = procedural.ProceduralFaceDataset(n_images=6, img_size=64, seed=3)
    jax = jax_procedural.ProceduralFaceDataset(n_images=6, img_size=64, seed=3)
    assert port.imgs.tobytes() == jax.imgs.tobytes()
    assert port.eye_masks.tobytes() == jax.eye_masks.tobytes()
    assert port.attributes == jax.attributes
    for key, value in jax.metadata_inputs.items():
        np.testing.assert_array_equal(port.metadata_inputs[key], value)
    _same_draws(port.metadata_input_distributions, jax.metadata_input_distributions)
    np.testing.assert_array_equal(port.get_attribute_values([1, 4], procedural.ATTRIBUTE_NAMES),
                                  jax.get_attribute_values([1, 4], jax_procedural.ATTRIBUTE_NAMES))
    assert port.facemodel_inputs_config() == jax.facemodel_inputs_config()
