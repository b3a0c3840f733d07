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

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNELS = ("rotate", "adain", "epilogue")
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


# while a graph captures (core/graphs.py): the capture stream's handle and
# the launches made into it, which are the graph's, not the counters'
_recording = None


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of its kernel's launches
    (atomic across threads).  A launch into a stream that
    :func:`recording_launches` watches is captured, not run: it goes to
    that record instead, and each replay of the graph adds it."""
    with _lock:
        if _recording is not None and torch.cuda.current_stream().cuda_stream == _recording[0]:
            _recording[1][wrapper] = _recording[1].get(wrapper, 0) + 1
        else:
            wrapper.launches += 1


def add_launches(wrapper, n: int) -> None:
    """Add ``n`` to ``wrapper.launches``: a replayed graph's launches of its
    kernel."""
    with _lock:
        wrapper.launches += n


@contextlib.contextmanager
def recording_launches(stream: int):
    """While open, the wrappers' launches into the CUDA stream ``stream``
    (``torch.cuda.Stream.cuda_stream``) are counted in the yielded dict,
    by wrapper, and not in their counters; launches into other streams, from
    other threads, count as ever.  One capture at a time."""
    global _recording
    counts: Dict = {}
    with _lock:
        if _recording is not None:
            raise RuntimeError("a graph capture is already recording launches")
        _recording = (stream, counts)
    try:
        yield counts
    finally:
        with _lock:
            _recording = None
