"""Samplable distributions fitted per face-model input (counterpart of
``confignet_tpu/data/distributions.py``; reference:
confignet/neural_renderer_dataset.py:22-59 and the GMM fit in
process_metadata, :162-173).

The classes keep the JAX package's names and attribute names, so a
``*_facemodel_distr.pck`` written by either package restores into either
package's classes (``core/pickles.py`` maps the module paths).  Sampling
draws from the global ``np.random``, as the JAX package does, so the same
seed gives the same bytes.
"""
from __future__ import annotations

import numpy as np


class OneHotDistribution:
    """Uniform discrete distribution over one-hot categories."""

    def __init__(self):
        self.n_features = None

    def fit(self, X: np.ndarray) -> None:
        self.n_features = X.shape[1]

    def sample(self, n_samples: int = 1):
        idx = np.random.randint(0, self.n_features, size=n_samples)
        one_hot = np.zeros((n_samples, self.n_features), np.float32)
        one_hot[np.arange(n_samples), idx] = 1
        return one_hot, idx


class ExemplarDistribution:
    """Uniform sampling over the training exemplars themselves."""

    def __init__(self):
        self.exemplars = None
        self.n_exemplars = None

    def fit(self, X: np.ndarray) -> None:
        self.exemplars = np.asarray(X)
        self.n_exemplars = self.exemplars.shape[0]

    def sample(self, n_samples: int = 1):
        idx = np.random.randint(0, self.n_exemplars, size=n_samples)
        return self.exemplars[idx], None


class GaussianDistribution:
    """Single-component Gaussian fit (the reference's GaussianMixture with
    one component), or sklearn's GaussianMixture when ``n_components > 1``."""

    def __init__(self, n_components: int = 1):
        self.n_components = n_components
        self._sk_model = None
        self.mean = None
        self.chol = None

    def fit(self, X: np.ndarray) -> None:
        X = np.asarray(X, np.float64)
        if self.n_components > 1:
            from sklearn.mixture import GaussianMixture

            self._sk_model = GaussianMixture(self.n_components)
            self._sk_model.fit(X)
            return
        self.mean = X.mean(axis=0)
        cov = np.cov(X, rowvar=False)
        cov = np.atleast_2d(cov) + 1e-6 * np.eye(X.shape[1])
        self.chol = np.linalg.cholesky(cov)

    def sample(self, n_samples: int = 1):
        if self._sk_model is not None:
            return self._sk_model.sample(n_samples)
        normal = np.random.normal(size=(n_samples, self.mean.shape[0]))
        values = self.mean + normal @ self.chol.T
        return values.astype(np.float32), None


def fit_distribution(data: np.ndarray, distr_type: str):
    """"GMM" | "one_hot" | "exemplar", fitted to ``data``
    (neural_renderer_dataset.py:162-173)."""
    if distr_type == "GMM":
        distr = GaussianDistribution()
    elif distr_type == "one_hot":
        distr = OneHotDistribution()
    elif distr_type == "exemplar":
        distr = ExemplarDistribution()
    else:
        raise ValueError(f"unknown distribution type {distr_type!r}")
    distr.fit(data)
    return distr
