"""FID and KID (counterpart of ``confignet_tpu/metrics/inception.py``;
reference: confignet/metrics/inception_distance.py and the
``InceptionMetrics`` harness in confignet/metrics/metrics.py:201-265).

Features come from the port's InceptionV3 on the model's device, in
fixed-size chunks (the tail padded by repeating its last image, as the JAX
package pads it); the FID/KID arithmetic is host numpy and scipy, as in the
JAX package.  The fused generator->Inception path that training scores with
is ``ConfigNetFirstStage._metric_features_for_latents``.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from confignet_tpu_torch.core import initializers
from confignet_tpu_torch.core.device import resolve_device
from confignet_tpu_torch.core.pretrained import maybe_load
from confignet_tpu_torch.models.backbones.inception import (
    InceptionV3, inception_conv_bn_order, inception_preprocess)
from confignet_tpu_torch.models.backbones.loader import load_into, load_keras_h5_ordered


class InceptionFeatureExtractor:
    """2048-dim pooled InceptionV3 features, chunked.  The convolutions run
    in ``dtype`` (bf16 by default, as the JAX package's)."""

    feature_dim = 2048

    def __init__(self, input_shape, dtype: Optional[torch.dtype] = torch.bfloat16,
                 device: Optional[Union[str, torch.device]] = None):
        self.input_shape = tuple(input_shape)
        self.device = resolve_device(device)
        self.module = InceptionV3(dtype=dtype)
        initializers.initialize(self.module, torch.Generator().manual_seed(1946))
        self.module.to(self.device).eval().requires_grad_(False)

    def load_keras_weights(self, h5_path: str) -> None:
        """Import the standard Keras InceptionV3 ``.h5`` (ImageNet, notop) by
        creation order: keras.applications' global-counter layer names
        (``conv2d_42``) cannot be matched by name."""
        names = inception_conv_bn_order()
        load_into(self.module, lambda flat: load_keras_h5_ordered(
            flat, h5_path, conv_paths=[f"{n}/conv" for n in names],
            bn_paths=[f"{n}/bn" for n in names]))

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """[0, 255] images (B, H, W, 3) on the device -> float32 (B, 2048)."""
        return self.module(inception_preprocess(images)).float()

    @torch.inference_mode()
    def get_features(self, images: np.ndarray, max_chunk_size: int = 256) -> np.ndarray:
        images = np.asarray(images)
        n = images.shape[0]
        chunk = min(max_chunk_size, max(n, 1))
        out = np.zeros((n, self.feature_dim), np.float32)
        for start in range(0, n, chunk):
            batch = np.array(images[start:start + chunk])  # a writable copy (memmaps are read-only)
            pad = chunk - batch.shape[0]
            if pad:
                batch = np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)])
            feats = self.features(torch.from_numpy(batch).to(self.device)).cpu().numpy()
            out[start:start + chunk] = feats[:chunk - pad]
        return out


def _trace_sqrt_product(cov_g: np.ndarray, cov_r: np.ndarray) -> float:
    """tr(sqrtm(cov_g @ cov_r)) for symmetric PSD covariances, as
    ``tr(sqrtm(S^{1/2} cov_r S^{1/2}))`` with S = cov_g: two symmetric
    eigendecompositions instead of a general sqrtm."""
    import scipy.linalg

    vals_g, vecs_g = scipy.linalg.eigh(cov_g)
    sqrt_g = (vecs_g * np.sqrt(np.clip(vals_g, 0.0, None))) @ vecs_g.T
    inner = sqrt_g @ cov_r @ sqrt_g
    vals = scipy.linalg.eigvalsh(inner)
    return float(np.sum(np.sqrt(np.clip(vals, 0.0, None))))


def compute_FID(features_g: np.ndarray, features_r: np.ndarray) -> float:
    """Frechet inception distance.  With fewer samples than feature dims on
    either side, the trace-sqrt term is the sum of the singular values of the
    small cross-Gram matrix X_g X_r^T of the centred, 1/sqrt(n-1)-scaled
    features (exact: its squared singular values are the nonzero eigenvalues
    of cov_g @ cov_r); otherwise two 2048x2048 eigendecompositions."""
    features_g = np.asarray(features_g, np.float64)
    features_r = np.asarray(features_r, np.float64)
    mean_g = np.mean(features_g, axis=0)
    mean_r = np.mean(features_r, axis=0)
    centroid_distance = float(np.linalg.norm(mean_g - mean_r) ** 2)

    (n_g, dim), n_r = features_g.shape, features_r.shape[0]
    if 2 <= min(n_g, n_r) and min(n_g, n_r) < dim:
        x_g = (features_g - mean_g) / np.sqrt(n_g - 1.0)
        x_r = (features_r - mean_r) / np.sqrt(n_r - 1.0)
        trace_g = float(np.sum(x_g * x_g))
        trace_r = float(np.sum(x_r * x_r))
        trace_sqrt = float(np.sum(np.linalg.svd(x_g @ x_r.T, compute_uv=False)))
        return centroid_distance + trace_g + trace_r - 2.0 * trace_sqrt

    cov_g = np.cov(features_g, rowvar=False)
    cov_r = np.cov(features_r, rowvar=False)
    trace_sqrt = _trace_sqrt_product(cov_g, cov_r)
    covariance_distance = float(np.trace(cov_g + cov_r)) - 2.0 * trace_sqrt
    return centroid_distance + covariance_distance


def _poly_kernel(a: np.ndarray, b: np.ndarray, degree: int = 3, coef0: float = 1.0) -> np.ndarray:
    """Polynomial kernel with sklearn's default gamma = 1/n_features."""
    gamma = 1.0 / a.shape[1]
    return (gamma * (a @ b.T) + coef0) ** degree


def compute_KID(features_g: np.ndarray, features_r: np.ndarray) -> float:
    """Kernel inception distance, Eq. 4 of arXiv:1801.01401."""
    k_gg = _poly_kernel(features_g, features_g)
    k_rr = _poly_kernel(features_r, features_r)
    k_gr = _poly_kernel(features_g, features_r)

    m = features_g.shape[0]
    n = features_r.shape[0]
    term1 = (np.sum(k_gg) - np.sum(np.diagonal(k_gg))) / (m * (m - 1))
    term2 = (np.sum(k_rr) - np.sum(np.diagonal(k_rr))) / (n * (n - 1))
    term3 = np.sum(k_gr) / (m * n)
    return float(term1 + term2 - 2 * term3)


class InceptionMetrics:
    """Training-time KID/FID harness: caches the ground-truth features of a
    metric sample (drawn from the global ``np.random``, as the JAX package
    draws it) at construction, then scores generated images or features."""

    def __init__(self, confignet_config, dataset, n_samples_for_metrics: int = 1000,
                 device: Optional[Union[str, torch.device]] = None):
        self.n_samples_for_metrics = n_samples_for_metrics
        self.inception_feature_extractor = InceptionFeatureExtractor(
            confignet_config["output_shape"], device=device)
        maybe_load(self.inception_feature_extractor.load_keras_weights,
                   confignet_config.get("backbones_dir"), "inception_v3")
        idx = np.random.randint(0, dataset.imgs.shape[0], n_samples_for_metrics)
        cached = getattr(dataset, "inception_features", None)
        feature_dim = self.inception_feature_extractor.feature_dim
        if cached is not None and np.asarray(cached).shape[-1] != feature_dim:
            print("WARNING: dataset inception features have dim "
                  f"{np.asarray(cached).shape[-1]} but the live extractor yields "
                  f"{feature_dim}; recomputing ground-truth features")
            cached = None
        if cached is not None:
            self.gt_inception_features = np.asarray(cached)[idx]
        else:
            self.gt_inception_features = self.inception_feature_extractor.get_features(
                dataset.imgs[idx])

    def get_metrics(self, generated_images: np.ndarray = None, features=None):
        """(KID, FID) of generated images, or of features extracted already
        (the fused path)."""
        if features is None:
            features = self.inception_feature_extractor.get_features(generated_images)
        kid = compute_KID(features, self.gt_inception_features)
        fid = compute_FID(features, self.gt_inception_features)
        return kid, fid

    def update_and_log_metrics(self, images, metrics_dict, output_dir,
                               aml_sink=None, tb_log_writer=None, features=None) -> None:
        """KID and FID appended to ``metrics_dict``, sent to the sinks and,
        unless ``output_dir`` is None, plotted and tabled there."""
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
        kid, fid = self.get_metrics(images, features=features)
        metrics_dict.setdefault("kid", []).append(kid)
        metrics_dict.setdefault("fid", []).append(fid)

        if "training_step_number" in metrics_dict:
            steps = metrics_dict["training_step_number"]
        else:
            steps = list(range(len(metrics_dict["kid"])))

        if aml_sink is not None:
            aml_sink("Kernel Inception Distance", kid)
            aml_sink("Frechet Inception Distance", fid)
        elif output_dir is not None:
            from confignet_tpu_torch.core.logging_utils import agg_pyplot

            plt = agg_pyplot()
            ax = plt.gca()
            ax.set_ylabel("KID", color="tab:blue")
            ax.semilogy(steps, metrics_dict["kid"], color="tab:blue")
            ax = ax.twinx()
            ax.set_ylabel("FID", color="tab:red")
            ax.semilogy(steps, metrics_dict["fid"], color="tab:red")
            plt.savefig(os.path.join(output_dir, "inception_metrics.png"))
            plt.clf()

        if tb_log_writer is not None:
            tb_log_writer.scalar("metrics/kid", kid, steps[-1])
            tb_log_writer.scalar("metrics/fid", fid, steps[-1])

        if output_dir is None:
            return
        table = np.stack((steps, metrics_dict["kid"], metrics_dict["fid"]), axis=1)
        np.savetxt(os.path.join(output_dir, "inception_metrics.txt"), table,
                   header="\t".join(["step_number", "kid", "fid"]))
