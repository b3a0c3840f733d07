"""ctypes bindings for the C++ batch sampler (counterpart of
``confignet_tpu/runtime/native.py``), with the same numpy path where no
compiler is available.

The shared library is built with ``g++`` on first use into
``confignet_tpu_torch/_build/``, named by a hash of the source and the
flags, so an edit rebuilds; where ``g++`` is missing or fails, the numpy path
is taken.  This is host code: it assembles the trainers' uint8 batches
before they are copied to the device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "batch_sampler.cpp"
_BUILD_DIR = _SRC.parent.parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libbatch_sampler_{digest.hexdigest()[:16]}.so"


def _build_library(target: Path) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"]
    try:
        result = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if result.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, target)  # atomic: a concurrent build never sees half a library
    return True


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        target = library_path()
        if not target.exists() and not _build_library(target):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError:
            _load_failed = True
            return None

        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gather_rows.argtypes = [u8p, ctypes.c_int64, i64p, ctypes.c_int64, u8p, ctypes.c_int]
        lib.gather_rows.restype = None
        lib.gather_images_with_flip.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, u8p, ctypes.c_int64, u8p, ctypes.c_int,
        ]
        lib.gather_images_with_flip.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


def _n_threads() -> int:
    return max(1, (os.cpu_count() or 1) - 1)


def _checked_indices(indices, n_rows: int) -> np.ndarray:
    """int64 indices into ``n_rows`` rows, negative ones wrapped as numpy
    wraps them; out-of-range ones raise IndexError, as numpy indexing does."""
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if indices.size and (indices.min() < -n_rows or indices.max() >= n_rows):
        raise IndexError(f"index out of range for {n_rows} rows")
    return np.ascontiguousarray(np.where(indices < 0, indices + n_rows, indices))


def _u8_pointer(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def gather_rows(array: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """array[indices] for a C-contiguous uint8 array of any row shape."""
    lib = _get_lib()
    if lib is None or array.dtype != np.uint8 or not array.flags["C_CONTIGUOUS"]:
        return np.ascontiguousarray(array[np.asarray(indices, np.int64)])

    indices = _checked_indices(indices, array.shape[0])
    row_shape = array.shape[1:]
    out = np.empty((len(indices),) + row_shape, np.uint8)
    lib.gather_rows(_u8_pointer(array), int(np.prod(row_shape)),
                    indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(indices),
                    _u8_pointer(out), _n_threads())
    return out


def gather_images(images: np.ndarray, indices: np.ndarray,
                  flip_flags: Optional[np.ndarray] = None) -> np.ndarray:
    """images[indices] (N, H, W, C) with an optional horizontal flip per
    gathered image (``flip_flags[i]`` nonzero), fused."""
    lib = _get_lib()
    if lib is None or images.dtype != np.uint8 or not images.flags["C_CONTIGUOUS"]:
        out = np.ascontiguousarray(images[np.asarray(indices, np.int64)])
        if flip_flags is not None:
            for i, flip in enumerate(flip_flags):
                if flip:
                    out[i] = out[i][:, ::-1]
        return out

    indices = _checked_indices(indices, images.shape[0])
    h, w, c = images.shape[1:]
    out = np.empty((len(indices), h, w, c), np.uint8)
    flags_ptr = None
    if flip_flags is not None:
        flip_flags = np.ascontiguousarray(flip_flags, dtype=np.uint8)
        if flip_flags.shape != indices.shape:
            raise ValueError(f"{flip_flags.size} flip flags for {len(indices)} indices")
        flags_ptr = _u8_pointer(flip_flags)
    lib.gather_images_with_flip(_u8_pointer(images), h, w, c,
                                indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), flags_ptr,
                                len(indices), _u8_pointer(out), _n_threads())
    return out
