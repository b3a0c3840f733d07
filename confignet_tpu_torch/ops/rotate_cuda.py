"""The rotation resample and its transpose as hand-written CUDA kernels
(counterpart of ``confignet_tpu/ops/rotate_pallas.py``).

- :func:`rotate_3d_grid_kernel` and :func:`rotate_3d_grid_kernel_train`
  resample a (B, S, S, S, C) grid and carry autograd: the forward kernel in
  ``forward``, the transpose kernel in ``backward`` for the grid.  For the
  transform, the ``_train`` form defines the gradient as ZERO (the contract
  of the JAX ``rotate_3d_grid_fused``: train steps never optimise
  rotations), and the plain form raises if the transform requires grad, so a
  run that optimises rotations through the kernel fails instead of getting
  zeros.  Paths that optimise rotations use the gather form
  (``core.transforms.rotate_3d_grid``).
- :func:`rotate_3d_grid_forward` and :func:`rotate_3d_grid_transpose` are the
  kernels' wrappers: on a CUDA tensor they launch ``csrc/rotate.cu`` (see the
  note there for the design and its bound) or raise; on a CPU tensor they
  take the plain versions, :func:`rotate_3d_grid_plain` and
  :func:`rotate_3d_grid_transpose_plain`.

The contract is the gather form's interpolation (clamped borders,
trilinear) and its autodiff, with float32 accumulation and one cast to the
grid's dtype.  The kernels compute the source coordinates themselves, with
the float32 formula of ``core.transforms._source_coords``.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from confignet_tpu_torch.core.transforms import _source_coords, rotate_3d_grid
from confignet_tpu_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rotate_3d_grid_plain(grid: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """The forward kernel's plain PyTorch version: the gather form in
    float32, cast once to the grid's dtype."""
    return rotate_3d_grid(grid.float(), transform).to(grid.dtype)


def rotate_3d_grid_transpose_plain(ct: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """The transpose kernel's plain PyTorch version: the gradient of the
    resample with respect to the grid, for the output cotangent ``ct``
    (B, S, S, S, C).  Each point's cotangent is scatter-added (``index_add_``)
    in float32 into its 8 source corners, each weight formed in the order the
    gather form's autodiff forms it (z, then y, then x); cast once to ct's
    dtype."""
    batch, size, channels = ct.shape[0], ct.shape[1], ct.shape[4]
    points = size ** 3
    f, c, d = _source_coords(ct, transform)
    dx, dy, dz = (d[:, i].reshape(-1, 1) for i in range(3))
    g = ct.float().reshape(-1, channels)
    g0, g1 = g * (1 - dz), g * dz  # cotangents of the gather form's c0, c1
    by_yz = {(0, 0): g0 * (1 - dy), (1, 0): g0 * dy, (0, 1): g1 * (1 - dy), (1, 1): g1 * dy}
    base = (torch.arange(batch, device=ct.device) * points)[:, None]
    acc = torch.zeros((batch * points, channels), dtype=torch.float32, device=ct.device)
    for (yi, zi), gyz in by_yz.items():
        for xi in (0, 1):
            xs, ys, zs = (c[:, i] if bit else f[:, i] for i, bit in enumerate((xi, yi, zi)))
            idx = (base + (xs.long() * size + ys.long()) * size + zs.long()).reshape(-1)
            acc.index_add_(0, idx, gyz * (dx if xi else 1 - dx))
    return acc.reshape(ct.shape).to(ct.dtype)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("rotate")
    if lib.rotate3d_forward.argtypes is None:
        lib.rotate3d_forward.restype = ctypes.c_int
        lib.rotate3d_forward.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.rotate3d_transpose.restype = ctypes.c_int
        lib.rotate3d_transpose.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                           + [ctypes.c_void_p])
    return lib


def _check(name: str, grid: torch.Tensor, transform: torch.Tensor) -> None:
    """What both kernels take: a contiguous float32/bf16 (B, S, S, S, C)
    tensor and (B, 3, 3) transforms, on one CUDA device."""
    if grid.device.type != "cuda" or transform.device != grid.device:
        raise ValueError(f"{name} on {grid.device} and transform on {transform.device}: "
                         "the kernel needs both on the same CUDA device")
    if grid.dtype not in _DTYPE_CODES:
        raise TypeError(f"rotate kernel takes float32 or bfloat16 tensors, got {grid.dtype}")
    if grid.ndim != 5 or not grid.shape[1] == grid.shape[2] == grid.shape[3]:
        raise ValueError(f"{name} must be (B, S, S, S, C), got {tuple(grid.shape)}")
    if transform.shape != (grid.shape[0], 3, 3):
        raise ValueError(f"transform must be ({grid.shape[0]}, 3, 3), got {tuple(transform.shape)}")
    if not grid.is_contiguous():
        raise ValueError(f"rotate kernel needs a contiguous (channels-last) {name}")


def rotate_3d_grid_forward(grid: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """The forward kernel's wrapper (no autograd): rotate a (B, S, S, S, C)
    grid by (B, 3, 3) transforms about its center.  CUDA tensors go through
    the kernel (or raise); CPU tensors through :func:`rotate_3d_grid_plain`."""
    if grid.device.type == "cpu":
        return rotate_3d_grid_plain(grid, transform)
    _check("grid", grid, transform)
    batch, size, channels = grid.shape[0], grid.shape[1], grid.shape[4]
    out = torch.empty_like(grid)
    if batch == 0 or channels == 0:
        return out
    transform = transform.to(torch.float32).contiguous()
    with torch.cuda.device(grid.device):
        err = _library().rotate3d_forward(
            grid.data_ptr(), transform.data_ptr(), out.data_ptr(),
            batch, size, channels, _DTYPE_CODES[grid.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rotate3d_forward launch failed: cudaError {err}")
    rotate_3d_grid_forward.launches += 1
    return out


def rotate_3d_grid_transpose(ct: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """The transpose kernel's wrapper: the gradient with respect to the grid
    for the output cotangent ``ct``.  CUDA tensors go through the kernel (or
    raise); CPU tensors through :func:`rotate_3d_grid_transpose_plain`."""
    if ct.device.type == "cpu":
        return rotate_3d_grid_transpose_plain(ct, transform)
    _check("ct", ct, transform)
    batch, size, channels = ct.shape[0], ct.shape[1], ct.shape[4]
    grad = torch.empty_like(ct)
    if batch == 0 or channels == 0:
        return grad
    transform = transform.to(torch.float32).contiguous()
    scratch = (torch.empty(ct.shape, dtype=torch.float32, device=ct.device)
               if ct.dtype == torch.bfloat16 else None)
    with torch.cuda.device(ct.device):
        err = _library().rotate3d_transpose(
            ct.data_ptr(), transform.data_ptr(), grad.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            batch, size, channels, _DTYPE_CODES[ct.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rotate3d_transpose launch failed: cudaError {err}")
    rotate_3d_grid_transpose.launches += 1
    return grad


rotate_3d_grid_forward.launches = 0
rotate_3d_grid_transpose.launches = 0


class _RotateResample(torch.autograd.Function):
    """Forward kernel in ``forward``, transpose kernel in ``backward`` for the
    grid; the transform's gradient is zero (see the module docstring for
    the wrapper that refuses a transform requiring grad)."""

    @staticmethod
    def forward(ctx, grid, transform):
        ctx.save_for_backward(transform)
        return rotate_3d_grid_forward(grid, transform)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        (transform,) = ctx.saved_tensors
        grad_grid = grad_transform = None
        if ctx.needs_input_grad[0]:
            grad_grid = rotate_3d_grid_transpose(grad_out.contiguous(), transform)
        if ctx.needs_input_grad[1]:
            grad_transform = torch.zeros_like(transform)
        return grad_grid, grad_transform


def rotate_3d_grid_kernel(grid: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """The resample through the kernels, differentiable in the grid.
    Raises if the transform requires grad (use the gather form to optimise
    rotations)."""
    if transform.requires_grad and torch.is_grad_enabled():
        raise ValueError("rotate_3d_grid_kernel cannot differentiate the transform; use "
                         "rotate_3d_grid (gather) to optimise rotations, or "
                         "rotate_3d_grid_kernel_train for a zero transform gradient")
    return _RotateResample.apply(grid, transform)


def rotate_3d_grid_kernel_train(grid: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """The resample through the kernels for train steps: the grid gets its
    gradient, the transform a gradient defined as zero."""
    return _RotateResample.apply(grid, transform)
