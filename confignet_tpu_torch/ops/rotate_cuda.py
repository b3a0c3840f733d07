"""The rotation resample as a hand-written CUDA kernel (counterpart of
``confignet_tpu/ops/rotate_pallas.py``, forward only).

:func:`rotate_3d_grid_kernel` is the wrapper: on a CUDA tensor it launches
``csrc/rotate.cu`` (see the note there for the design and its bound); on a
CPU tensor it takes the plain version, :func:`rotate_3d_grid_plain`.  The
contract is the gather form's interpolation (clamped borders, trilinear),
with float32 accumulation and one cast to the grid's dtype.  The kernel
computes the source coordinates itself, with the float32 formula of
``core.transforms._source_coords``.
"""
from __future__ import annotations

import ctypes

import torch

from confignet_tpu_torch.core.transforms import rotate_3d_grid
from confignet_tpu_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rotate_3d_grid_plain(grid: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: the gather form in float32, cast
    once to the grid's dtype."""
    return rotate_3d_grid(grid.float(), transform).to(grid.dtype)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("rotate")
    fn = lib.rotate3d_forward
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def rotate_3d_grid_kernel(grid: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Rotate a (B, S, S, S, C) grid by (B, 3, 3) transforms about its
    center.  CUDA tensors go through the kernel (or raise); CPU tensors
    through :func:`rotate_3d_grid_plain`."""
    if grid.device.type == "cpu":
        return rotate_3d_grid_plain(grid, transform)
    if grid.device.type != "cuda" or transform.device != grid.device:
        raise ValueError(f"grid on {grid.device} and transform on {transform.device}: "
                         "the kernel needs both on the same CUDA device")
    if grid.dtype not in _DTYPE_CODES:
        raise TypeError(f"rotate kernel takes float32 or bfloat16 grids, got {grid.dtype}")
    if grid.ndim != 5 or not grid.shape[1] == grid.shape[2] == grid.shape[3]:
        raise ValueError(f"grid must be (B, S, S, S, C), got {tuple(grid.shape)}")
    batch, size, channels = grid.shape[0], grid.shape[1], grid.shape[4]
    if transform.shape != (batch, 3, 3):
        raise ValueError(f"transform must be ({batch}, 3, 3), got {tuple(transform.shape)}")
    if not grid.is_contiguous():
        raise ValueError("rotate kernel needs a contiguous (channels-last) grid")
    if batch == 0 or channels == 0:
        return torch.empty_like(grid)

    transform = transform.to(torch.float32).contiguous()
    out = torch.empty_like(grid)
    with torch.cuda.device(grid.device):
        err = _library().rotate3d_forward(
            grid.data_ptr(), transform.data_ptr(), out.data_ptr(),
            batch, size, channels, _DTYPE_CODES[grid.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rotate3d_forward launch failed: cudaError {err}")
    rotate_3d_grid_kernel.launches += 1
    return out


rotate_3d_grid_kernel.launches = 0
