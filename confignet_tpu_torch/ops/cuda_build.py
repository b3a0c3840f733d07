"""Build and load the hand-written CUDA kernels in ``confignet_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own,
with ``nvcc -gencode arch=compute_90a,code=sm_90a``, into
``_build/lib<name>_<hash>.so``, loaded through ``ctypes``.  The hash covers
the source, the shared headers and the flags, so an edit rebuilds.  Nothing
is compiled or loaded when this module is imported: the first CUDA tensor
that reaches a kernel wrapper triggers the build, and :func:`build` lets a
script compile every kernel up front, one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNELS = ("rotate", "adain")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# kernels launch from the training thread and the checkpoint worker at once
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the CUDA kernels are compiled at first use")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel library that is not built yet, one ``nvcc``
    process per source, all started together.  Returns the compiler's
    output (ptxas register and spill report) per library it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, tmp, proc, time.perf_counter()))
    reports = {}
    for name, target, tmp, proc, start in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{output}")
        os.replace(tmp, target)  # atomic: a concurrent build never sees half a library
        reports[name] = f"built in {time.perf_counter() - start:.1f} s\n{output}"
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
    return lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of its kernel's launches
    (atomic across threads)."""
    with _lock:
        wrapper.launches += 1
