"""Dataset container for ConfigNet training (counterpart of
``confignet_tpu/data/dataset.py``).

The payload file moves between the packages both ways: the port writes it
with ``core/pickles.write_pickle``, which names the distribution classes as
the JAX package names them, and reads it with ``core/pickles.read_pickle``;
the images memmap is the same file.  The dataset's Inception features come
from the port's ``InceptionFeatureExtractor`` on ``device`` (the GPU unless
given).

Reference: confignet/neural_renderer_dataset.py.  Same capabilities — build
from an image directory (normalize, read metadata/eye masks/attributes,
pose-range filtering, precompute inception features), process render
metadata into per-parameter training inputs + fitted sampling
distributions, memmap-backed image storage — with one deliberate format
change: instead of pickling the class instance (fragile across refactors,
reference: neural_renderer_dataset.py:327-350), the ``.pck`` file holds a
plain dict payload with a schema version.  Images stay in a ``uint8``
memmap ``<name>_imgs.dat`` next to it.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from confignet_tpu_torch.core.pickles import read_pickle, write_pickle
from confignet_tpu_torch.data import celeba
from confignet_tpu_torch.data.distributions import fit_distribution
from confignet_tpu_torch.data.normalizer import FaceImageNormalizer

_SCHEMA_VERSION = 1


class EyeRegionSpec:
    """Eye region bounds in the UV space of the synthetic 3D face model
    (reference: neural_renderer_dataset.py:61-69)."""

    eye_region_max_y = 0.15
    eye_region_min_y = 0.07
    l_eye_region_max_x = 0.16
    l_eye_region_min_x = 0.09
    r_eye_region_max_x = 0.91
    r_eye_region_min_x = 0.84


class NeuralRendererDataset:
    def __init__(self, img_shape: Tuple[int, int, int], is_synthetic: bool,
                 head_rotation_range=((-30, 30), (-10, 10), (0, 0)),
                 eye_rotation_range=((-25, 25), (-15, 15), (0, 0))):
        self.img_shape = tuple(img_shape)
        self.is_synthetic = is_synthetic
        self.head_rotation_range = np.array(head_rotation_range)
        self.eye_rotation_range = np.array(eye_rotation_range)

        # populated at dataset creation
        self.imgs: Optional[np.memmap] = None
        self.imgs_memmap_filename: Optional[str] = None
        self.imgs_memmap_shape = None
        self.imgs_memmap_dtype = None
        self.inception_features = None
        self.render_metadata = None
        self.eye_masks = None
        self.attributes = None

        # populated at training time by process_metadata
        self.metadata_inputs = None
        self.metadata_input_distributions = None
        self.metadata_input_labels = None

    # ------------------------------------------------------------------
    # Dataset generation
    # ------------------------------------------------------------------

    def generate_face_dataset(self, input_dir: str, output_path: str,
                              attribute_label_file_path: Optional[str] = None,
                              pre_normalize: bool = True,
                              landmark_backend: Optional[str] = None,
                              compute_inception_features: bool = True,
                              device: Optional[Union[str, torch.device]] = None) -> None:
        import cv2

        FaceImageNormalizer.normalize_dataset_dir(
            input_dir, pre_normalize, self.img_shape, landmark_backend=landmark_backend
        )
        image_paths = sorted(glob.glob(os.path.join(input_dir, "normalized", "*.png")))

        if self.is_synthetic:
            metadata = self._load_metadata(image_paths)
            image_paths, metadata = self._remove_samples_with_out_of_range_pose(
                image_paths, metadata
            )
            self.render_metadata = metadata
            self.eye_masks = []

        image_attributes = None
        if attribute_label_file_path is not None:
            image_attributes = celeba.parse_celeba_attribute_file(attribute_label_file_path)
            self.attributes = []

        self._initialize_imgs_memmap(len(image_paths), output_path)

        for i, image_path in enumerate(image_paths):
            if i % max(1, len(image_paths) // 100) == 0:
                print("Image reading %d%% complete" % (100 * i / max(len(image_paths), 1)))
            name = os.path.splitext(os.path.basename(image_path))[0]
            if self.attributes is not None:
                self.attributes.append(image_attributes[name])
            self.imgs[i] = cv2.imread(image_path)
            if self.is_synthetic:
                self.eye_masks.append(self._get_eye_mask_for_image_path(image_path))

        if self.is_synthetic:
            self.eye_masks = np.array(self.eye_masks)

        if compute_inception_features:
            self._compute_inception_features(device)
        self.save(output_path)

    def _initialize_imgs_memmap(self, n_images: int, output_path: str) -> None:
        self.imgs_memmap_shape = (n_images, *self.img_shape)
        self.imgs_memmap_dtype = np.uint8
        self.imgs_memmap_filename = (
            os.path.splitext(os.path.basename(output_path))[0] + "_imgs.dat"
        )
        basedir = os.path.dirname(output_path)
        self.imgs = np.memmap(
            os.path.join(basedir, self.imgs_memmap_filename),
            self.imgs_memmap_dtype, "w+", shape=self.imgs_memmap_shape,
        )

    def _load_metadata(self, image_paths: List[str]) -> List[Dict[str, Any]]:
        """Each normalized image img_<id>.png has ../meta_<id>.json
        (reference: neural_renderer_dataset.py:230-239)."""
        metadata = []
        for path in image_paths:
            head, tail = os.path.split(os.path.splitext(path)[0])
            meta_path = os.path.join(head, "..", "meta" + tail[3:] + ".json")
            with open(meta_path, "r") as fp:
                metadata.append(json.load(fp))
        return metadata

    def _get_eye_mask_for_image_path(self, image_path: str) -> np.ndarray:
        import cv2

        head, tail = os.path.split(os.path.splitext(image_path)[0])
        uv_path = os.path.join(head, "uv" + tail[3:] + ".exr")
        uv_img = cv2.imread(uv_path, -1)
        if uv_img is None:
            return np.zeros(self.img_shape[:2], np.uint8)

        spec = EyeRegionSpec
        in_y = (uv_img[:, :, 1] > spec.eye_region_min_y) & (
            uv_img[:, :, 1] < spec.eye_region_max_y
        )
        left = (uv_img[:, :, 0] > spec.l_eye_region_min_x) & (
            uv_img[:, :, 0] < spec.l_eye_region_max_x
        )
        right = (uv_img[:, :, 0] > spec.r_eye_region_min_x) & (
            uv_img[:, :, 0] < spec.r_eye_region_max_x
        )
        mask = ((left | right) & in_y).astype(np.uint8)
        return mask

    def _remove_samples_with_out_of_range_pose(self, image_paths, metadata):
        """Reject samples whose head/eye pose falls outside the configured
        ranges; synthetic metadata uses axis order (y, x, z) relative to
        ConfigNet's, hence the [1, 2, 0] reordering
        (reference: neural_renderer_dataset.py:257-279)."""
        head_range = np.pi * self.head_rotation_range[[1, 2, 0]] / 180
        eye_range = np.pi * self.eye_rotation_range[[1, 2, 0]] / 180

        kept_paths, kept_metadata = [], []
        for path, meta in zip(image_paths, metadata):
            head_pose = np.asarray(meta["bone_rotations"]["head"])
            eye_pose = np.asarray(meta["bone_rotations"]["left_eye"])
            ok = (
                np.all(head_pose >= head_range[:, 0])
                and np.all(head_pose <= head_range[:, 1])
                and np.all(eye_pose >= eye_range[:, 0])
                and np.all(eye_pose <= eye_range[:, 1])
            )
            if ok:
                kept_paths.append(path)
                kept_metadata.append(meta)
        return kept_paths, kept_metadata

    # ------------------------------------------------------------------
    # Metadata processing (training-time)
    # ------------------------------------------------------------------

    def process_metadata(self, config: Dict[str, Any], update_config: bool = False) -> None:
        """Convert raw render metadata into per-input training vectors and
        fit a sampling distribution per input.  String values become one-hot
        over unique values; lists become float vectors; dicts become
        sorted-key vectors (blendshapes get jaw_opening appended from the jaw
        bone rotation).  Optionally fills the input dims into the config
        (reference: neural_renderer_dataset.py:150-228)."""
        self.metadata_inputs = {}
        self.metadata_input_distributions = {}
        self.metadata_input_labels = {}

        for input_name in config["facemodel_inputs"].keys():
            values: Any = self.render_metadata
            for key in input_name.split(":"):
                values = [metadata[key] for metadata in values]
            values = ["none" if v is None else v for v in values]

            first = values[0]
            if not all(isinstance(v, type(first)) for v in values):
                raise ValueError(f"inconsistent metadata types for {input_name}")

            if isinstance(first, str):
                unique_vals, inverse = np.unique(values, return_inverse=True)
                one_hot = np.zeros((len(values), unique_vals.shape[0]), np.float32)
                one_hot[np.arange(len(values)), inverse] = 1
                self.metadata_inputs[input_name] = one_hot
                self.metadata_input_distributions[input_name] = fit_distribution(
                    one_hot, "one_hot"
                )
                self.metadata_input_labels[input_name] = unique_vals.tolist()
            elif isinstance(first, list):
                if not all(len(v) == len(first) for v in values):
                    raise ValueError(f"ragged list metadata for {input_name}")
                array = np.array(values, np.float32)
                self.metadata_inputs[input_name] = array
                self.metadata_input_distributions[input_name] = fit_distribution(
                    array, "exemplar"
                )
                self.metadata_input_labels[input_name] = None
            elif isinstance(first, dict):
                keys = sorted(first.keys())
                if not all(sorted(v.keys()) == keys for v in values):
                    raise ValueError(f"inconsistent dict keys for {input_name}")
                self.metadata_input_labels[input_name] = list(keys)
                array = np.array(
                    [[v[k] for k in keys] for v in values], np.float32
                )
                if input_name == "blendshape_values":
                    jaw = np.array(
                        [m["bone_rotations"]["jaw"][0] for m in self.render_metadata],
                        np.float32,
                    )
                    array = np.hstack((array, jaw[:, np.newaxis]))
                    self.metadata_input_labels[input_name].append("jaw_opening")
                self.metadata_inputs[input_name] = array
                self.metadata_input_distributions[input_name] = fit_distribution(
                    array, "exemplar"
                )
            else:
                raise ValueError(
                    f"unsupported metadata type {type(first).__name__} for {input_name}"
                )

            if update_config:
                config["facemodel_inputs"][input_name] = (
                    int(self.metadata_inputs[input_name].shape[1]),
                    config["facemodel_inputs"][input_name][1],
                )

        # head rotations, reordered from synthetic (y, x, z) to ConfigNet order
        rotations = [m["bone_rotations"]["head"] for m in self.render_metadata]
        self.metadata_inputs["rotations"] = np.array(rotations, np.float32)[:, [2, 0, 1]]
        self.metadata_input_labels["rotations"] = None

    # ------------------------------------------------------------------
    # Misc utilities
    # ------------------------------------------------------------------

    def get_attribute_values(self, sample_idxs, attribute_names) -> np.ndarray:
        assert self.attributes is not None
        return np.array(
            [
                [self.attributes[i][name] for name in attribute_names]
                for i in sample_idxs
            ]
        )

    def write_images(self, directory: str) -> None:
        import cv2

        os.makedirs(directory, exist_ok=True)
        for i in range(len(self.imgs)):
            cv2.imwrite(os.path.join(directory, str(i).zfill(5) + ".jpg"), self.imgs[i])
        mean_img = np.mean(self.imgs, axis=0).astype(np.uint8)
        cv2.imwrite(os.path.join(directory, "mean_img.jpg"), mean_img)

    def write_images_by_attribute(self, directory: str) -> None:
        import cv2

        assert self.attributes is not None
        attribute_names = self.attributes[0].keys()
        for attribute_name in attribute_names:
            with_attr = [
                i for i, attrs in enumerate(self.attributes) if attrs[attribute_name]
            ]
            attr_dir = os.path.join(directory, attribute_name)
            os.makedirs(attr_dir, exist_ok=True)
            for idx in with_attr:
                cv2.imwrite(
                    os.path.join(attr_dir, str(idx).zfill(6) + ".jpg"), self.imgs[idx]
                )

    def _compute_inception_features(self, device: Optional[Union[str, torch.device]] = None) -> None:
        from confignet_tpu_torch.metrics.inception import InceptionFeatureExtractor

        extractor = InceptionFeatureExtractor(self.imgs.shape[1:], device=device)
        self.inception_features = extractor.get_features(self.imgs)

    # ------------------------------------------------------------------
    # Save / load
    # ------------------------------------------------------------------

    def save(self, filename: str) -> None:
        payload = {
            "schema_version": _SCHEMA_VERSION,
            "img_shape": self.img_shape,
            "is_synthetic": self.is_synthetic,
            "head_rotation_range": self.head_rotation_range,
            "eye_rotation_range": self.eye_rotation_range,
            "imgs_memmap_filename": self.imgs_memmap_filename,
            "imgs_memmap_shape": self.imgs_memmap_shape,
            "imgs_memmap_dtype": np.dtype(self.imgs_memmap_dtype).str
            if self.imgs_memmap_dtype
            else None,
            "inception_features": self.inception_features,
            "render_metadata": self.render_metadata,
            "eye_masks": self.eye_masks,
            "attributes": self.attributes,
            "metadata_inputs": self.metadata_inputs,
            "metadata_input_distributions": self.metadata_input_distributions,
            "metadata_input_labels": self.metadata_input_labels,
        }
        write_pickle(payload, filename)

    @staticmethod
    def load(filename: str) -> "NeuralRendererDataset":
        payload = read_pickle(filename)

        dataset = NeuralRendererDataset(
            tuple(payload["img_shape"]),
            payload["is_synthetic"],
            payload["head_rotation_range"],
            payload["eye_rotation_range"],
        )
        for key in (
            "imgs_memmap_filename", "imgs_memmap_shape", "inception_features",
            "render_metadata", "eye_masks", "attributes", "metadata_inputs",
            "metadata_input_distributions", "metadata_input_labels",
        ):
            setattr(dataset, key, payload[key])
        dataset.imgs_memmap_dtype = (
            np.dtype(payload["imgs_memmap_dtype"]) if payload["imgs_memmap_dtype"] else None
        )

        basedir = os.path.dirname(filename)
        dataset.imgs = np.memmap(
            os.path.join(basedir, dataset.imgs_memmap_filename),
            dataset.imgs_memmap_dtype, "r", shape=tuple(dataset.imgs_memmap_shape),
        )
        return dataset
