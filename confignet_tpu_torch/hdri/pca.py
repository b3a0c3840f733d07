"""PCA model of 360-degree HDRI environment maps (counterpart of
``confignet_tpu/hdri/pca.py``; reference: hdri_encoding/hdri_pca_model.py).

log2(1 + hdri) -> random longitude rotations (np.roll) -> resize to
(64, 128) -> whitened full-SVD PCA.  ``transform`` / ``inverse_transform``
map to and from the ``hdri_embedding`` face-model input.  The JAX package
fits with numpy's SVD in float64 on the host, so this module keeps the same
numpy arithmetic and gives the same bytes; nothing here runs on the card.
cv2 is imported inside the functions that read, resize or write images.

The pickles are written under the JAX package's class names
(``core/pickles.py``), so the shipped ``assets/hdri_model.pck`` loads here
and a model saved here loads in the JAX package.
"""
from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from confignet_tpu_torch.core.pickles import read_pickle, write_pickle


class WhitenedPCA:
    """sklearn's PCA (svd_solver='full', whiten=True), its core only.

    transform:  z = (x - mean) @ components.T / sqrt(explained_variance)
    inverse:    x = z * sqrt(explained_variance) @ components + mean
    """

    def __init__(self, n_components):
        self.n_components = n_components
        self.mean_ = None
        self.components_ = None
        self.explained_variance_ = None
        self.explained_variance_ratio_ = None

    def fit(self, X: np.ndarray) -> "WhitenedPCA":
        X = np.asarray(X, np.float32)
        n_samples = X.shape[0]
        self.mean_ = X.mean(axis=0)
        centered = X - self.mean_

        _, s, vt = np.linalg.svd(np.asarray(centered, np.float64), full_matrices=False)
        explained_variance = (s ** 2) / (n_samples - 1)
        ratio = explained_variance / explained_variance.sum()

        if self.n_components is None:
            k = len(s)
        elif 0 < self.n_components < 1:
            k = int(np.searchsorted(np.cumsum(ratio), self.n_components) + 1)
        else:
            k = int(self.n_components)
        k = min(k, len(s))

        self.components_ = vt[:k].astype(np.float32)
        self.explained_variance_ = explained_variance[:k].astype(np.float32)
        self.explained_variance_ratio_ = ratio[:k].astype(np.float32)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        z = (np.asarray(X, np.float32) - self.mean_) @ self.components_.T
        return z / np.sqrt(self.explained_variance_)

    def inverse_transform(self, Z: np.ndarray) -> np.ndarray:
        scaled = np.asarray(Z, np.float32) * np.sqrt(self.explained_variance_)
        return scaled @ self.components_ + self.mean_


class HDRIModelPCA:
    def __init__(self, output_shape: Tuple[int, int], n_rotations_per_image: int):
        self.n_rotations_per_image = n_rotations_per_image
        self.output_shape = tuple(output_shape)
        self.pca_model: Optional[WhitenedPCA] = None

    def fit(self, hdri_images: np.ndarray, n_components=0.9) -> None:
        """Rotations from the global ``np.random``, as the JAX package draws them."""
        hdri_images = np.log2(hdri_images + 1)
        rotated = apply_random_rotations(hdri_images, self.n_rotations_per_image)
        rotated = resize_hdris(rotated, self.output_shape)
        flat = rotated.reshape(rotated.shape[0], -1)

        if n_components > 1:
            n_components = int(n_components)
        self.pca_model = WhitenedPCA(n_components).fit(flat)

        explained = float(np.sum(self.pca_model.explained_variance_ratio_))
        print("PCA model fitted, %0.2f%% of variance explained by %d components"
              % (100 * explained, self.pca_model.components_.shape[0]))

    def transform(self, hdri_images: np.ndarray, rotations=None) -> np.ndarray:
        hdri_images = np.log2(hdri_images + 1)
        if rotations is not None:
            assert len(rotations) == len(hdri_images)
            hdri_images = np.array([rotate_hdri(img, rot) for img, rot in zip(hdri_images, rotations)])
        hdri_images = resize_hdris(hdri_images, self.output_shape)
        return self.pca_model.transform(hdri_images.reshape(hdri_images.shape[0], -1))

    def inverse_transform(self, X: np.ndarray) -> np.ndarray:
        images = self.pca_model.inverse_transform(X)
        images = images.reshape(len(images), *self.output_shape, 3)
        return np.power(2, images) - 1

    def write_basis_images(self, output_dir: str) -> None:
        import cv2

        os.makedirs(output_dir, exist_ok=True)
        for i, basis in enumerate(self.pca_model.components_):
            img = basis.reshape(*self.output_shape, 3)
            img = 255 * (img - img.min()) / max(img.max() - img.min(), 1e-12)
            cv2.imwrite(os.path.join(output_dir, str(i).zfill(3) + ".png"), img.astype(np.uint8))

    def save(self, output_path: str) -> None:
        write_pickle(self, output_path)

    @staticmethod
    def load(input_path: str) -> "HDRIModelPCA":
        return read_pickle(input_path)


def load_hdris(hdri_dir: str):
    import cv2

    hdri_paths = sorted(glob.glob(os.path.join(hdri_dir, "*.hdr")))
    images = [cv2.imread(p, -1) for p in hdri_paths]
    return np.array(images), hdri_paths


def apply_random_rotations(hdri_images: np.ndarray, rotations_per_image: int) -> np.ndarray:
    out = np.zeros((hdri_images.shape[0] * rotations_per_image, *hdri_images.shape[1:]),
                   dtype=hdri_images.dtype)
    i = 0
    for image in hdri_images:
        for _ in range(rotations_per_image):
            out[i] = rotate_hdri(image, np.random.uniform(0, 360))
            i += 1
    return out


def resize_hdris(hdri_images: np.ndarray, output_shape: Tuple[int, int]) -> np.ndarray:
    import cv2

    resized = [cv2.resize(img, output_shape[::-1], interpolation=cv2.INTER_AREA)
               for img in hdri_images]
    return np.array(resized, dtype=hdri_images.dtype)


def rotate_hdri(hdri_image: np.ndarray, rotation_deg: float) -> np.ndarray:
    """Rotate an equirectangular HDRI about the vertical axis: a roll along
    the longitude."""
    n_cols = hdri_image.shape[1]
    shift = int(round(rotation_deg * n_cols / 360))
    return np.roll(hdri_image, shift, axis=1)
