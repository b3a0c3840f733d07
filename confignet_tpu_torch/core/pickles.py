"""The face-model distribution pickles (``*_facemodel_distr.pck``), read and
written so that they move between the reference release, the JAX package
and the port (the port's copy of ``_ReferenceUnpickler``,
``confignet_tpu/core/reference_import.py:223-255``).

- Reading maps the distribution classes of the reference
  (``confignet.neural_renderer_dataset``) and of the JAX package
  (``confignet_tpu.data.distributions``) onto the port's classes, which
  carry the same attribute names.  Any other name under either package
  raises: importing it would load the JAX package.  Every other class
  (sklearn's ``GaussianMixture``, a test's stand-in) is imported by its own
  name.
- Writing records the port's distribution classes under their JAX package
  names, so the JAX package's ``load_reference_pickle`` reads the file
  unchanged.  Only the names are written; nothing of the JAX package is
  imported, which is why the writer is the pure-Python pickler with its
  ``save_global`` overridden: the C pickler imports every class's module to
  check the name it writes.  tests/test_torch_checkpoint.py holds the files
  against the JAX package's reader.
"""
from __future__ import annotations

import pickle
from typing import Any

from confignet_tpu_torch.data import distributions

_CLASS_NAMES = ("OneHotDistribution", "ExemplarDistribution", "GaussianDistribution")
# module paths whose distribution classes are read as the port's
_READ_MODULES = ("confignet.neural_renderer_dataset", "confignet_tpu.data.distributions")
# the packages whose other names are refused
_REFUSED_ROOTS = ("confignet", "confignet_tpu")
# the module path the port's classes are written under
_WRITE_MODULE = "confignet_tpu.data.distributions"
_PROTOCOL = 4


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module in _READ_MODULES and name in _CLASS_NAMES:
            return getattr(distributions, name)
        if module.split(".")[0] in _REFUSED_ROOTS:
            raise pickle.UnpicklingError(f"{module}.{name} has no counterpart in the port")
        return super().find_class(module, name)


class _Pickler(pickle._Pickler):
    """Writes the port's distribution classes under ``_WRITE_MODULE``."""

    def save_global(self, obj, name=None):
        if getattr(obj, "__module__", None) != distributions.__name__ or obj.__name__ not in _CLASS_NAMES:
            return super().save_global(obj, name)
        self.save(_WRITE_MODULE)
        self.save(obj.__name__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def read_pickle(path: str) -> Any:
    with open(path, "rb") as fp:
        return _Unpickler(fp).load()


def write_pickle(obj: Any, path: str) -> None:
    with open(path, "wb") as fp:
        _Pickler(fp, protocol=_PROTOCOL).dump(obj)
