"""The pickles that move between the reference release, the JAX package and
the port: the face-model distributions (``*_facemodel_distr.pck``) and the
HDRI PCA model (``assets/hdri_model.pck``).  The port's copy of
``_ReferenceUnpickler``, ``confignet_tpu/core/reference_import.py:223-255``.

- Reading maps the classes of the reference
  (``confignet.neural_renderer_dataset``) and of the JAX package
  (``confignet_tpu.data.distributions``, ``confignet_tpu.hdri.pca``) onto
  the port's classes of the same names, which carry the same attribute
  names.  Any other name under either package raises: importing it would
  load the JAX package.  Every other class (sklearn's ``GaussianMixture``, a
  test's stand-in) is imported by its own name.
- Writing records the port's classes under the JAX package's names, so the
  JAX package reads the file unchanged.  Only the names are written;
  nothing of the JAX package is imported, which is why the writer is the
  pure-Python pickler with its ``save_global`` overridden: the C pickler
  imports every class's module to check the name it writes.
  tests/test_torch_checkpoint.py and tests/test_torch_hdri.py hold the
  files against the JAX package's readers.
"""
from __future__ import annotations

import importlib
import pickle
from typing import Any, Dict, Tuple

_DISTRIBUTIONS = ("OneHotDistribution", "ExemplarDistribution", "GaussianDistribution")
_HDRI = ("HDRIModelPCA", "WhitenedPCA")
# (module, class name) in a file -> the port's module holding the class
_READ: Dict[Tuple[str, str], str] = {
    **{("confignet.neural_renderer_dataset", n): "confignet_tpu_torch.data.distributions"
       for n in _DISTRIBUTIONS},
    **{("confignet_tpu.data.distributions", n): "confignet_tpu_torch.data.distributions"
       for n in _DISTRIBUTIONS},
    **{("confignet_tpu.hdri.pca", n): "confignet_tpu_torch.hdri.pca" for n in _HDRI},
}
# the packages whose other names are refused
_REFUSED_ROOTS = ("confignet", "confignet_tpu")
# the port's modules -> the JAX package's, whose names the port writes
_JAX_MODULES = {"confignet_tpu_torch.data.distributions": "confignet_tpu.data.distributions",
                "confignet_tpu_torch.hdri.pca": "confignet_tpu.hdri.pca"}
_PROTOCOL = 4


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _READ:
            return getattr(importlib.import_module(_READ[module, name]), name)
        if module.split(".")[0] in _REFUSED_ROOTS:
            raise pickle.UnpicklingError(f"{module}.{name} has no counterpart in the port")
        return super().find_class(module, name)


class _Pickler(pickle._Pickler):
    """Writes the port's mapped classes under ``write_modules[their module]``."""

    write_modules = _JAX_MODULES

    def save_global(self, obj, name=None):
        module = self.write_modules.get(getattr(obj, "__module__", None))
        if module is None or (module, obj.__name__) not in _READ:
            return super().save_global(obj, name)
        self.save(module)
        self.save(obj.__name__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def read_pickle(path: str) -> Any:
    with open(path, "rb") as fp:
        return _Unpickler(fp).load()


def write_pickle(obj: Any, path: str) -> None:
    with open(path, "wb") as fp:
        _Pickler(fp, protocol=_PROTOCOL).dump(obj)
