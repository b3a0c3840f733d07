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
  kernels' wrappers: on a CUDA tensor they launch ``csrc/rotate.cu`` or
  raise; on a CPU tensor they take the plain versions,
  :func:`rotate_3d_grid_plain` and :func:`rotate_3d_grid_transpose_plain`.
- :func:`rotate_plan` picks each launch's route and tiles from the shape and
  the card.  The forward's "slab" route (replacing ``_rotate_kernel_full``,
  ``rotate_pallas.py:65``) stages the source x-slabs that a window of output
  planes reads in shared memory, so the volume passes through L2 a few times
  instead of once per corner.  The transpose's "owner" route (replacing
  ``_rotate_kernel_grad_grid``, ``rotate_pallas.py:95``) gives each block
  one source x-slab of the gradient to sum in a fixed order and write once:
  one launch, no float atomics, no scratch, and two launches agree bit for
  bit.  The bound of both is bytes: the volume (ct) read once and the
  output (gradient) written once.  ``csrc/rotate.cu`` has the design.
  Route "v1" keeps the first kernels (corners read from global memory; an
  atomic transpose) for measurements and tests:
  :func:`launch_rotate_forward` / :func:`launch_rotate_transpose` take any
  plan, and :func:`rotate_v1_plan` makes one.  No wrapper falls back to it.
- :func:`rotate_3d_grid_tiled_plain` and
  :func:`rotate_3d_grid_transpose_tiled_plain` follow the slab kernels'
  tiles, buckets and summation order in torch, for the CPU tests; nothing on
  the main path calls them.

The contract is the gather form's interpolation (clamped borders,
trilinear) and its autodiff, with float32 accumulation and one cast to the
grid's dtype.  The kernels compute the source coordinates themselves, with
the float32 formula of ``core.transforms._source_coords``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch
from torch.autograd.function import once_differentiable

from confignet_tpu_torch.core.transforms import _source_coords, rotate_3d_grid
from confignet_tpu_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODES = {"slab": 0, "owner": 0, "v1": 1}
_THREADS = 256  # kThreads in csrc/rotate.cu: forward block
_OWNER_WARPS = 16  # kOwnerWarps: transpose block
_RING = 3  # kRing: forward slab buffers
_CHUNK = 512  # kChunk: transpose points per chunk
_MAX_SIZE = 32  # kMaxSize: the slab forward takes S <= 32
_MAX_OWNER_SIZE = 16  # kMaxOwnerSize: the owner-computes transpose takes S <= 16
_POINTS_PER_BLOCK_V1 = 32
# forward tiles, first that fits: (output-x planes per block, bytes of a slab
# row); the order comes from ``chip_smoke.py --rotate-sweep`` at S=16, C=128
_FORWARD_TILES = ((2, 128), (4, 64), (2, 64), (1, 64), (1, 32))
# transpose channels per block (at most 4 a lane); the sweep's fastest at C=128
_TRANSPOSE_GROUP = 128
# the card the CPU tests plan for: an H100's opt-in shared memory per block and SMs
H100_LIMITS = (232448, 132)


class RotatePlan(NamedTuple):
    """How one call is launched.  ``route`` "slab" (forward), "owner"
    (transpose) or "v1"; ``window`` output-x planes per forward block (1 for
    the transpose: one source slab); ``group`` channels per block; ``vec``
    channels per 16-byte access (1: scalar); ``blocks`` in the launch;
    ``shared_bytes`` of dynamic shared memory per block."""
    route: str
    window: int
    group: int
    vec: int
    blocks: int
    shared_bytes: int


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def forward_shared_bytes(size: int, window: int, group: int, elem: int) -> int:
    """forward_smem in csrc/rotate.cu: the slab ring and the point table."""
    plane = size * size
    points = window * plane
    return (_RING * _align16(plane * group * elem) + 4 * _align16(points * 4)
            + _align16(points * 2) + _align16(points) + _align16((3 * size + 4) * 4))


def transpose_shared_bytes(size: int, group: int) -> int:
    """transpose_smem in csrc/rotate.cu: the float32 slab sums, the
    contributing points and one chunk's packed cells and column lists."""
    return (_align16(size * size * group * 4) + _align16(size ** 3 * 2) + _align16(_CHUNK * 4)
            + _align16(_CHUNK * 16)
            + _align16(2 * _CHUNK * 2)
            + 2 * _align16(_OWNER_WARPS * size * 4) + _align16((size + 1) * 4)
            + _align16((_OWNER_WARPS + 1) * 4))


def rotate_v1_plan(batch: int, size: int, channels: int) -> RotatePlan:
    """The first kernels' launch (route "v1"): one block per 32 points."""
    return RotatePlan("v1", 1, channels, 1, batch * math.ceil(size ** 3 / _POINTS_PER_BLOCK_V1), 0)


@functools.lru_cache(maxsize=1024)
def rotate_plan(batch: int, size: int, channels: int, dtype: torch.dtype, shared_per_block: int,
                sms: int, transpose: bool = False) -> RotatePlan:
    """The launch of one forward (or ``transpose``) call on a card with
    ``shared_per_block`` bytes of opt-in shared memory per block and ``sms``
    SMs: a pure function of the shape and the card, the same for every call.

    Forward: the first tile of ``_FORWARD_TILES`` whose shared memory fits
    two blocks per SM, else the first that fits one; a window is cut to
    fewer planes while the launch has fewer blocks than SMs.  Transpose:
    ``_TRANSPOSE_GROUP`` channels per block (or all, if fewer).  16-byte
    accesses where the channel count allows.  Route "v1" only where the slab
    kernels cannot take the shape: S > 32 (forward) or S > 16 (transpose),
    or no tile fits in shared memory.  Cached: the wrappers call it on every
    launch."""
    elem = torch.empty((), dtype=dtype).element_size()
    wide = 16 // elem
    vec = wide if channels % wide == 0 else 1
    if transpose:
        group = min(channels, _TRANSPOSE_GROUP)
        shared = transpose_shared_bytes(size, group)
        if not 1 <= size <= _MAX_OWNER_SIZE or shared > shared_per_block:
            return rotate_v1_plan(batch, size, channels)
        return RotatePlan("owner", 1, group, vec, batch * size * math.ceil(channels / group),
                          shared)
    if not 1 <= size <= _MAX_SIZE:
        return rotate_v1_plan(batch, size, channels)
    fitting = []
    for window, row_bytes in _FORWARD_TILES:
        window = min(window, size)
        group = min(channels, max(vec, row_bytes // elem))
        if group % vec or group // vec > _THREADS or window * size * size > 65535:
            continue
        shared = forward_shared_bytes(size, window, group, elem)
        if shared <= shared_per_block:
            blocks = batch * math.ceil(size / window) * math.ceil(channels / group)
            fitting.append(RotatePlan("slab", window, group, vec, blocks, shared))
    if not fitting:
        return rotate_v1_plan(batch, size, channels)
    two_per_sm = [p for p in fitting if 2 * (p.shared_bytes + 1024) <= shared_per_block]
    plan = (two_per_sm or fitting)[0]
    while plan.blocks < sms and plan.window > 1:
        window = plan.window // 2
        blocks = batch * math.ceil(size / window) * math.ceil(channels / plan.group)
        plan = plan._replace(window=window, blocks=blocks,
                             shared_bytes=forward_shared_bytes(size, window, plan.group, elem))
    return plan


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


def rotate_3d_grid_tiled_plain(grid: torch.Tensor, transform: torch.Tensor,
                               plan: RotatePlan = None) -> torch.Tensor:
    """The slab forward's tiling in torch (CPU tests only): per (sample,
    window of ``plan.window`` output-x planes, group of ``plan.group``
    channels), the window's points bucketed by floor_x, and each bucket s in
    [smin, smax] interpolated from source slabs s and min(s + 1, S - 1) in
    float32 (x, then y, then z), cast once.  ``plan`` defaults to the
    forward plan for an H100."""
    batch, size, channels = grid.shape[0], grid.shape[1], grid.shape[4]
    plan = plan or rotate_plan(batch, size, channels, grid.dtype, *H100_LIMITS)
    plane, points = size * size, size ** 3
    f, c, d = (t.long() if t.dtype == torch.int32 else t.float()
               for t in _source_coords(grid, transform))
    volume = grid.float().reshape(batch, size, plane, channels)
    out = torch.empty((batch, points, channels), dtype=torch.float32, device=grid.device)
    span = plan.window * plane
    for b in range(batch):
        for p0 in range(0, points, span):
            fx = f[b, 0, p0:p0 + span]
            for g0 in range(0, channels, plan.group):
                chans = slice(g0, g0 + plan.group)
                for s in range(int(fx.min()), int(fx.max()) + 1):
                    bucket = torch.nonzero(fx == s).flatten() + p0
                    floor_slab = volume[b, s, :, chans]
                    ceil_slab = volume[b, min(s + 1, size - 1), :, chans]
                    fy, cy = f[b, 1, bucket] * size, c[b, 1, bucket] * size
                    fz, cz = f[b, 2, bucket], c[b, 2, bucket]
                    r00, r01, r10, r11 = fy + fz, fy + cz, cy + fz, cy + cz
                    dx, dy, dz = (d[b, i, bucket][:, None] for i in range(3))
                    c00 = floor_slab[r00] * (1 - dx) + ceil_slab[r00] * dx
                    c01 = floor_slab[r01] * (1 - dx) + ceil_slab[r01] * dx
                    c10 = floor_slab[r10] * (1 - dx) + ceil_slab[r10] * dx
                    c11 = floor_slab[r11] * (1 - dx) + ceil_slab[r11] * dx
                    c0 = c00 * (1 - dy) + c10 * dy
                    c1 = c01 * (1 - dy) + c11 * dy
                    out[b, bucket, chans] = c0 * (1 - dz) + c1 * dz
    return out.to(grid.dtype).reshape(grid.shape)


def rotate_3d_grid_transpose_tiled_plain(ct: torch.Tensor, transform: torch.Tensor,
                                         plan: RotatePlan = None) -> torch.Tensor:
    """The owner-computes transpose in torch (CPU tests only): per (sample,
    source slab s, group of ``plan.group`` channels), the points with
    floor_x in {s-1, s} in point order, in chunks of 512.  A point adds
    ct * W to each cell of the slab it reaches, W being the sum, in the plain
    version's corner order (y bit, z bit, x bit), of the weights (wz * wy) *
    wx of its corners in that cell; every cell sums its points in point
    order, in float32, cast once.  ``plan`` defaults to the transpose plan
    for an H100."""
    batch, size, channels = ct.shape[0], ct.shape[1], ct.shape[4]
    plan = plan or rotate_plan(batch, size, channels, ct.dtype, *H100_LIMITS, transpose=True)
    plane, points = size * size, size ** 3
    f, c, d = (t.long() if t.dtype == torch.int32 else t.float()
               for t in _source_coords(ct, transform))
    values = ct.float().reshape(batch, points, channels)
    grad = torch.zeros((batch, size, plane, channels), dtype=torch.float32, device=ct.device)
    for b in range(batch):
        for s in range(size):
            reach = torch.nonzero((f[b, 0] == s) | (f[b, 0] == s - 1)).flatten()
            for base in range(0, len(reach), _CHUNK):
                pts = reach[base:base + _CHUNK]
                xs, ys, zs = ((f[b, i, pts], c[b, i, pts]) for i in range(3))
                wx, wy, wz = ((1 - d[b, i, pts], d[b, i, pts]) for i in range(3))
                corners = [(yi, zi, xi) for yi in (0, 1) for zi in (0, 1) for xi in (0, 1)]
                cells = torch.stack([ys[yi] * size + zs[zi] for yi, zi, _ in corners], 1)
                weights = torch.stack([wz[zi] * wy[yi] * wx[xi] for yi, zi, xi in corners], 1)
                valid = torch.stack([xs[xi] == s for _, _, xi in corners], 1)
                # each corner's weight goes to the first corner of the point in its cell
                first = torch.arange(8).expand(len(pts), 8).clone()
                for k in range(8):
                    for j in range(k - 1, -1, -1):
                        same = valid[:, j] & valid[:, k] & (cells[:, j] == cells[:, k])
                        first[:, k] = torch.where(same, j, first[:, k])
                summed = torch.zeros_like(weights)
                for k in range(8):
                    summed.scatter_add_(1, first[:, k:k + 1],
                                        (weights[:, k] * valid[:, k])[:, None])
                keep = (valid & (first == torch.arange(8))).reshape(-1)
                rows = cells.reshape(-1)[keep]
                for g0 in range(0, channels, plan.group):
                    chans = slice(g0, g0 + plan.group)
                    adds = values[b, pts, chans][:, None, :] * summed[:, :, None]
                    grad[b, s, :, chans].index_add_(0, rows, adds.reshape(-1, adds.shape[2])[keep])
    return grad.reshape(ct.shape).to(ct.dtype)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("rotate")
    if lib.rotate3d_forward.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rotate3d_device_limits.restype = i32
        lib.rotate3d_device_limits.argtypes = [i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
        lib.rotate3d_forward.restype = i32
        lib.rotate3d_forward.argtypes = [ptr] * 3 + [i32] * 8 + [ptr]
        lib.rotate3d_transpose.restype = i32
        lib.rotate3d_transpose.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    return lib


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> Tuple[int, int]:
    """(opt-in shared memory per block in bytes, SM count) of a CUDA device,
    read once."""
    sms, smem = ctypes.c_int(), ctypes.c_int()
    err = _library().rotate3d_device_limits(index, ctypes.byref(sms), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"rotate3d_device_limits failed: cudaError {err}")
    return smem.value, sms.value


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


def _aligned(plan: RotatePlan, *tensors: torch.Tensor) -> RotatePlan:
    """16-byte accesses need 16-byte aligned data (a view may start anywhere)."""
    if plan.vec > 1 and any(t.data_ptr() % 16 for t in tensors):
        return plan._replace(vec=1)
    return plan


def rotate_3d_grid_forward(grid: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """The forward kernel's wrapper (no autograd): rotate a (B, S, S, S, C)
    grid by (B, 3, 3) transforms about its center.  CUDA tensors go through
    the kernel on the route :func:`rotate_plan` picks (or raise); CPU tensors
    through :func:`rotate_3d_grid_plain`."""
    if grid.device.type == "cpu":
        return rotate_3d_grid_plain(grid, transform)
    _check("grid", grid, transform)
    batch, size, channels = grid.shape[0], grid.shape[1], grid.shape[4]
    plan = rotate_plan(batch, size, channels, grid.dtype, *device_limits(grid.device.index))
    return launch_rotate_forward(grid, transform, plan)


def launch_rotate_forward(grid: torch.Tensor, transform: torch.Tensor,
                          plan: RotatePlan) -> torch.Tensor:
    """Launch the forward kernel of ``plan`` on a checked CUDA grid.
    :func:`rotate_3d_grid_forward` passes :func:`rotate_plan`'s plan; a
    measurement or test may pass another, e.g. :func:`rotate_v1_plan`."""
    batch, size, channels = grid.shape[0], grid.shape[1], grid.shape[4]
    out = torch.empty_like(grid)
    if batch == 0 or channels == 0:
        return out
    transform = transform.to(torch.float32).contiguous()
    plan = _aligned(plan, grid, out)
    with torch.cuda.device(grid.device):
        err = _library().rotate3d_forward(
            grid.data_ptr(), transform.data_ptr(), out.data_ptr(), batch, size, channels,
            _DTYPE_CODES[grid.dtype], _ROUTE_CODES[plan.route], plan.window, plan.group, plan.vec,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rotate3d_forward launch failed ({plan}): cudaError {err}")
    rotate_3d_grid_forward.launches += 1
    return out


def rotate_3d_grid_transpose(ct: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """The transpose kernel's wrapper: the gradient with respect to the grid
    for the output cotangent ``ct``.  CUDA tensors go through the kernel on
    the route :func:`rotate_plan` picks (or raise); CPU tensors through
    :func:`rotate_3d_grid_transpose_plain`."""
    if ct.device.type == "cpu":
        return rotate_3d_grid_transpose_plain(ct, transform)
    _check("ct", ct, transform)
    batch, size, channels = ct.shape[0], ct.shape[1], ct.shape[4]
    plan = rotate_plan(batch, size, channels, ct.dtype, *device_limits(ct.device.index),
                       transpose=True)
    return launch_rotate_transpose(ct, transform, plan)


def launch_rotate_transpose(ct: torch.Tensor, transform: torch.Tensor,
                            plan: RotatePlan) -> torch.Tensor:
    """Launch the transpose kernel(s) of ``plan`` on a checked CUDA ct (see
    :func:`launch_rotate_forward`).  Route "v1" takes a float32 scratch for
    a bf16 ct; the owner route takes none."""
    batch, size, channels = ct.shape[0], ct.shape[1], ct.shape[4]
    grad = torch.empty_like(ct)
    if batch == 0 or channels == 0:
        return grad
    transform = transform.to(torch.float32).contiguous()
    plan = _aligned(plan, ct, grad)
    scratch = (torch.empty(ct.shape, dtype=torch.float32, device=ct.device)
               if plan.route == "v1" and ct.dtype == torch.bfloat16 else None)
    with torch.cuda.device(ct.device):
        err = _library().rotate3d_transpose(
            ct.data_ptr(), transform.data_ptr(), grad.data_ptr(),
            None if scratch is None else scratch.data_ptr(), batch, size, channels,
            _DTYPE_CODES[ct.dtype], _ROUTE_CODES[plan.route], plan.group, plan.vec,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rotate3d_transpose launch failed ({plan}): cudaError {err}")
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
