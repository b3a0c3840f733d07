"""PyTorch/CUDA port of ConfigNet (the JAX package ``confignet_tpu`` is the
reference it is held against).

The package layout mirrors ``confignet_tpu`` module for module.  It imports
torch, numpy and the standard library only; the hand-written CUDA kernels in
``csrc/`` are compiled and loaded the first time a CUDA tensor reaches their
wrapper, so importing the package needs neither ``nvcc`` nor a GPU.

The package root re-exports the JAX package's public names (those of the
reference's ``confignet/__init__.py``), each loaded from the port's module
on first access.
"""

__version__ = "0.1.0"

_LAZY_EXPORTS = {
    "ConfigNetFirstStage": "confignet_tpu_torch.training.first_stage",
    "ConfigNet": "confignet_tpu_torch.training.second_stage",
    "LatentGAN": "confignet_tpu_torch.training.latent_gan",
    "CelebaAttributeClassifier": "confignet_tpu_torch.metrics.celeba_attribute_prediction",
    "NeuralRendererDataset": "confignet_tpu_torch.data.dataset",
    "FaceImageNormalizer": "confignet_tpu_torch.data.normalizer",
    "ControllabilityMetrics": "confignet_tpu_torch.metrics.controllability",
    "InceptionMetrics": "confignet_tpu_torch.metrics.controllability",
    "ControllabilityMetricConfigs": "confignet_tpu_torch.metrics.controllability_metric_configs",
    "load_confignet": "confignet_tpu_torch.core.model_io",
    "ConfigNetServer": "confignet_tpu_torch.serving",
}


def __getattr__(name):
    if name in _LAZY_EXPORTS:
        import importlib

        module = importlib.import_module(_LAZY_EXPORTS[name])
        return getattr(module, name)
    raise AttributeError(f"module 'confignet_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + list(_LAZY_EXPORTS.keys()))
