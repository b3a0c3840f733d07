"""Fused AdaIN (instance norm + latent modulation) and its backward as
hand-written CUDA kernels (counterpart of ``confignet_tpu/ops/adain_pallas.py``).

The contract is the Pallas kernel's: statistics over ALL non-batch,
non-channel axes in float32 (biased variance, eps inside the rsqrt), output
``xhat * (scale + 1) + bias`` in x's dtype, ``scale``/``bias`` (B, C) in
any float dtype; the backward is the JAX package's ``_fused_adain_bwd``,
each cotangent in its own primal's dtype.

- :func:`fused_adain` carries autograd.  Its forward is
  :func:`fused_adain_forward`, which also returns the float32 statistics
  ``stats`` (B, 2, C) = (mean, rstd); its backward is
  :func:`fused_adain_backward`, which reads them.
- Both wrappers launch ``csrc/adain.cu`` on CUDA tensors (see the note there
  for the design and its bound) or raise; on CPU tensors they take the plain
  versions, :func:`fused_adain_plain_with_stats` and
  :func:`fused_adain_backward_plain`.
- :func:`adain_route` decides, from the shape, the dtype and the card, whether
  a call takes the one-pass cluster route or the one-pass route over
  co-resident blocks (:func:`adain_resident_plan`), and raises
  ``ValueError`` for a slab that neither holds.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from confignet_tpu_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODES = {"one_pass": 0, "resident": 1}
_THREADS = 256  # kThreads in csrc/adain.cu
_MAX_CLUSTER = 16  # non-portable cluster size, opted into by the kernel
_PORTABLE_CLUSTER = 8
_BLOCKS_PER_SM_ONE_PASS = 3  # shared memory per block is aimed at a third of the limit
_MIN_ROW_BYTES = 32  # one DRAM sector: narrower channel groups waste bandwidth
_MAX_ROW_BYTES = 128  # one cache line


class AdainPlan(NamedTuple):
    """How one call is launched.  ``route`` "one_pass": clusters of
    ``parts`` blocks hold each (positions, group) slab in shared memory;
    "resident": ``parts`` co-resident ordinary blocks hold each slab, and
    ``wave`` (sample, group) slabs are in flight at once (a cooperative grid
    of ``wave * parts`` blocks).  ``group`` channels per block, ``vec``
    channels per 16-byte access (1: scalar), ``shared_bytes`` dynamic
    shared memory per block."""
    route: str
    group: int
    vec: int
    parts: int
    shared_bytes: int
    wave: int = 0


def _lanes(group: int, vec: int) -> int:
    """Rows a block covers at once (lanes_for in csrc/adain.cu)."""
    cols, lanes = group // vec, 1
    while lanes * 2 * cols <= _THREADS:
        lanes *= 2
    return lanes


def _shared_bytes(route: str, tensors: int, positions: int, group: int, vec: int, parts: int,
                  elem: int) -> int:
    """shared_bytes in csrc/adain.cu."""
    red = _lanes(group, vec) * group * 4
    per = math.ceil(positions / parts)
    tiles = tensors * (-(-per * group * elem // 16) * 16) + red
    if route == "resident":  # merged (3 x group) and every part's partials (parts x 2 x group)
        return tiles + (3 + 2 * parts) * group * 4
    return tiles + 5 * group * 4


def _group_widths(channels: int, vec: int, elem: int):
    """Channel-group widths to try, widest first: multiples of ``vec``,
    rows of 32 to 128 bytes (or all the channels, if fewer)."""
    width = min(channels, max(vec, _MAX_ROW_BYTES // elem))
    while width >= vec:
        if width % vec == 0 and (width * elem >= _MIN_ROW_BYTES or width == channels):
            yield width
        width //= 2


def adain_resident_plan(batch: int, positions: int, channels: int, dtype: torch.dtype,
                        shared_per_block: int, sms: int,
                        backward: bool = False) -> Optional[AdainPlan]:
    """The co-resident route's launch, or None where one (positions, group)
    slab of x (and g, ``backward``) does not fit the card's SMs at one block
    of at most ``shared_per_block`` bytes each.

    One block per SM: a block that fits the opt-in shared memory is always
    resident alone (``__launch_bounds__(256, 1)``), whatever its registers.
    The fewest parts whose rows fit a block set the most slabs in flight at
    once (SMs over parts); the work items (sample, group) go in the fewest
    waves of that many, the waves as even as whole items allow, and the
    parts then grow until the wave covers every SM (smaller blocks, the
    same waves)."""
    elem = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elem if channels % (16 // elem) == 0 else 1
    group = next(_group_widths(channels, vec, elem))
    tensors = 2 if backward else 1

    def shared(parts):
        return _shared_bytes("resident", tensors, positions, group, vec, parts, elem)

    parts = max(1, math.ceil(tensors * positions * group * elem / shared_per_block))
    while parts <= min(sms, positions) and shared(parts) > shared_per_block:
        parts += 1
    if parts > sms or shared(parts) > shared_per_block:
        return None
    most = sms // parts
    items = batch * math.ceil(channels / group)
    wave = math.ceil(items / math.ceil(items / most))
    parts = min(max(parts, sms // wave), positions)
    return AdainPlan("resident", group, vec, parts, shared(parts), wave)


@functools.lru_cache(maxsize=1024)
def adain_route(batch: int, positions: int, channels: int, dtype: torch.dtype,
                shared_per_block: int, sms: int, backward: bool = False) -> AdainPlan:
    """The launch of one AdaIN call on a card with ``shared_per_block``
    bytes of opt-in shared memory per block and ``sms`` SMs
    (``device_limits``): a pure function of the shape and the card, the same
    for every call.

    One pass where a cluster of at most 16 blocks can hold the (positions,
    group) slab of x (and g, ``backward``) in shared memory: the widest
    channel group whose slab fits, cut into the fewest blocks that each take
    at most a third of the limit (three blocks per SM), or, where no group
    allows that, the fewest blocks that fit at all.  A 16-block cluster must
    leave room for two blocks per SM (it has to fit the SMs of one GPC).
    Otherwise one pass over co-resident blocks (:func:`adain_resident_plan`)
    where the card's SMs hold at least one slab at a block each;
    ``ValueError`` where they do not (no site of the 128, 256 or 512px
    generator is such a slab).  Fewer blocks per cluster beat more, smaller
    ones: each cluster waits for its slowest block before it writes.
    Cached: the wrappers call it on every launch."""
    elem = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elem if channels % (16 // elem) == 0 else 1
    tensors = 2 if backward else 1
    target = shared_per_block // _BLOCKS_PER_SM_ONE_PASS
    fallback = None
    for group in _group_widths(channels, vec, elem):

        def shared(parts):
            return _shared_bytes("one_pass", tensors, positions, group, vec, parts, elem)

        def fits(parts):
            limit = shared_per_block // 2 if parts > _PORTABLE_CLUSTER else shared_per_block
            return shared(parts) <= limit

        parts = 1
        while parts <= _MAX_CLUSTER and not fits(parts):
            parts *= 2
        if parts > _MAX_CLUSTER:
            continue
        while parts < _MAX_CLUSTER and shared(parts) > target and fits(parts * 2):
            parts *= 2
        plan = AdainPlan("one_pass", group, vec, parts, shared(parts))
        if plan.shared_bytes <= target:
            return plan
        fallback = fallback or plan
    plan = fallback or adain_resident_plan(batch, positions, channels, dtype, shared_per_block,
                                           sms, backward)
    if plan is None:
        raise ValueError(f"AdaIN's (positions, channels) = ({positions}, {channels}) {dtype} slab "
                         f"{'(x and g) ' if backward else ''}fits neither a 16-block cluster nor "
                         f"{sms} SMs at {shared_per_block} bytes of shared memory a block")
    return plan


def fused_adain_plain_with_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                 eps: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's plain PyTorch version: (out, stats) with stats
    (B, 2, C) float32 = (mean, rstd)."""
    x3 = x.reshape(x.shape[0], -1, x.shape[-1]).float()
    mean = x3.mean(dim=1, keepdim=True)
    var = (x3 - mean).square().mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (x3 - mean) * rstd * (scale.float()[:, None, :] + 1.0) + bias.float()[:, None, :]
    return out.to(x.dtype).reshape(x.shape), torch.cat([mean, rstd], dim=1)


def fused_adain_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-3) -> torch.Tensor:
    """The forward kernel's plain PyTorch version, output only."""
    return fused_adain_plain_with_stats(x, scale, bias, eps)[0]


def fused_adain_backward_plain(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                               scale: torch.Tensor, bias_dtype: torch.dtype):
    """The backward kernel's plain PyTorch version, from the forward's saved
    ``stats``: (dx, dscale, dbias) with dbias = sum g, dscale = sum g*xhat,
    dx = rstd*(dxhat - mean(dxhat) - xhat*mean(dxhat*xhat)), dxhat =
    g*(scale+1); each cotangent in its own primal's dtype."""
    shape = x.shape
    x3 = x.reshape(shape[0], -1, shape[-1]).float()
    g3 = g.reshape(shape[0], -1, shape[-1]).float()
    mean, rstd = stats[:, :1].float(), stats[:, 1:].float()
    xhat = (x3 - mean) * rstd
    dbias = g3.sum(dim=1)
    dscale = (g3 * xhat).sum(dim=1)
    dxhat = g3 * (scale.float() + 1.0)[:, None, :]
    m_dxhat = dxhat.mean(dim=1, keepdim=True)
    m_dxhat_xhat = (dxhat * xhat).mean(dim=1, keepdim=True)
    dx3 = rstd * (dxhat - m_dxhat - xhat * m_dxhat_xhat)
    return dx3.reshape(shape).to(x.dtype), dscale.to(scale.dtype), dbias.to(bias_dtype)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("adain")
    if lib.adain_forward.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.adain_device_limits.restype = i32
        lib.adain_device_limits.argtypes = [i32] + [ctypes.POINTER(i32)] * 2
        lib.adain_forward.restype = i32
        lib.adain_forward.argtypes = ([ptr] * 7 + [i32] * 8 + [i64] * 2 + [i32] * 3
                                      + [ctypes.c_float, ptr])
        lib.adain_backward.restype = i32
        lib.adain_backward.argtypes = [ptr] * 9 + [i32] * 8 + [i64] + [i32] * 4 + [ptr]
    return lib


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> Tuple[int, int]:
    """(opt-in shared memory per block in bytes, SM count) of a CUDA device,
    read once: :func:`adain_route`'s card arguments."""
    sms, smem = ctypes.c_int(), ctypes.c_int()
    err = _library().adain_device_limits(index, ctypes.byref(sms), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"adain_device_limits failed: cudaError {err}")
    return smem.value, sms.value


def _current(device: torch.device):
    """Enter ``device`` only if it is not the current device already."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _param(t: torch.Tensor) -> torch.Tensor:
    """scale/bias as the kernels read them: float32 or bf16, unit channel
    stride (row views such as ``params[:, 0]`` pass without a copy)."""
    if t.dtype not in _DTYPE_CODES:
        t = t.float()
    return t if t.stride(1) == 1 else t.contiguous()


def _check(x: torch.Tensor, *params: Tuple[str, torch.Tensor]) -> None:
    if x.device.type != "cuda" or any(t.device != x.device for _, t in params):
        where = ", ".join(f"{name} on {t.device}" for name, t in params)
        raise ValueError(f"x on {x.device}, {where}: the kernel needs all of them on the same "
                         "CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"AdaIN kernel takes float32 or bfloat16 x, got {x.dtype}")
    if x.ndim < 3:
        raise ValueError(f"x must be (B, *spatial, C), got {tuple(x.shape)}")
    batch, channels = x.shape[0], x.shape[-1]
    for name, t in params:
        if name in ("scale", "bias") and (t.shape != (batch, channels)
                                          or not t.is_floating_point()):
            raise ValueError(f"{name} must be a float ({batch}, {channels}) tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not x.is_contiguous():
        raise ValueError("AdaIN kernel needs a contiguous (channels-last) x")


def _aligned(plan: AdainPlan, *tensors: torch.Tensor) -> AdainPlan:
    """16-byte accesses need 16-byte aligned data (a view may start anywhere).
    Scalar accesses take no more shared memory (fewer lanes to reduce)."""
    if plan.vec > 1 and any(t.data_ptr() % 16 for t in tensors):
        return plan._replace(vec=1)
    return plan


def _scratch(plan: AdainPlan, batch: int, channels: int, device: torch.device):
    """(partials, arrival counters) of one launch, None for the cluster
    route: for the co-resident route float32 (B, parts, 2, C) and an int32
    counter per (sample, group), zeroed on every call (a replayed CUDA
    graph replays the zeroing too)."""
    if plan.route == "one_pass":
        return None, None
    partial = torch.empty((batch, plan.parts, 2, channels), dtype=torch.float32, device=device)
    arrived = torch.zeros(batch * math.ceil(channels / plan.group), dtype=torch.int32,
                          device=device)
    return partial, arrived


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_adain_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's wrapper (no autograd): AdaIN over all spatial
    axes of x (B, *spatial, C) with (B, C) scale/bias; returns (out, stats).
    CUDA tensors go through the kernel on the route :func:`adain_route`
    picks (or raise); CPU tensors through :func:`fused_adain_plain_with_stats`."""
    if x.device.type == "cpu":
        return fused_adain_plain_with_stats(x, scale, bias, eps)
    _check(x, ("scale", scale), ("bias", bias))
    batch, channels = x.shape[0], x.shape[-1]
    positions = x.numel() // max(1, batch * channels)
    plan = adain_route(batch, positions, channels, x.dtype, *device_limits(x.device.index))
    return launch_forward(x, scale, bias, eps, plan)


def launch_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                   plan: AdainPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel of ``plan`` on checked CUDA tensors;
    :func:`fused_adain_forward` passes :func:`adain_route`'s plan.  The
    co-resident route takes a float32 scratch of partials and zeroed
    arrival counters, one per (sample, group)."""
    batch, channels = x.shape[0], x.shape[-1]
    out = torch.empty_like(x)
    stats = torch.empty((batch, 2, channels), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out, stats
    positions = x.numel() // (batch * channels)
    scale, bias = _param(scale), _param(bias)
    plan = _aligned(plan, x)
    partial, arrived = _scratch(plan, batch, channels, x.device)
    with _current(x.device):
        err = _library().adain_forward(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
            _ptr(partial), _ptr(arrived), batch, positions, channels, _ROUTE_CODES[plan.route],
            plan.group, plan.vec, plan.parts, plan.wave, scale.stride(0), bias.stride(0),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], _DTYPE_CODES[bias.dtype],
            float(eps), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"adain_forward launch failed ({plan}): cudaError {err}")
    cuda_build.count_launch(fused_adain_forward)
    return out, stats


fused_adain_forward.launches = 0


def fused_adain_backward(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                         scale: torch.Tensor, bias_dtype: torch.dtype):
    """The backward kernel's wrapper: (dx, dscale, dbias) of AdaIN for the
    output cotangent ``g``, from the forward's ``stats``; each cotangent in
    its own primal's dtype.  CUDA tensors go through the kernel (or raise);
    CPU tensors through :func:`fused_adain_backward_plain`."""
    if x.device.type == "cpu":
        return fused_adain_backward_plain(x, g, stats, scale, bias_dtype)
    _check(x, ("g", g), ("stats", stats), ("scale", scale))
    batch, channels = x.shape[0], x.shape[-1]
    if g.shape != x.shape or stats.shape != (batch, 2, channels):
        raise ValueError(f"g {tuple(g.shape)} and stats {tuple(stats.shape)} do not match x "
                         f"{tuple(x.shape)}")
    positions = x.numel() // max(1, batch * channels)
    plan = adain_route(batch, positions, channels, x.dtype, *device_limits(x.device.index),
                       backward=True)
    return launch_backward(x, g, stats, scale, bias_dtype, plan)


def launch_backward(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                    bias_dtype: torch.dtype, plan: AdainPlan):
    """Launch the backward kernel of ``plan`` on checked CUDA tensors (see
    :func:`launch_forward`)."""
    batch, channels = x.shape[0], x.shape[-1]
    out_dtypes = [t if t in _DTYPE_CODES else torch.float32 for t in (scale.dtype, bias_dtype)]
    dx = torch.empty_like(x)
    dscale, dbias = (torch.empty((batch, channels), dtype=t, device=x.device) for t in out_dtypes)
    if x.numel() > 0:
        positions = x.numel() // (batch * channels)
        g = g.to(x.dtype).contiguous()
        stats = stats.float().contiguous()
        params = _param(scale)
        plan = _aligned(plan, x, g)
        partial, arrived = _scratch(plan, batch, channels, x.device)
        with _current(x.device):
            err = _library().adain_backward(
                x.data_ptr(), g.data_ptr(), stats.data_ptr(), params.data_ptr(), dx.data_ptr(),
                dscale.data_ptr(), dbias.data_ptr(), _ptr(partial), _ptr(arrived), batch,
                positions, channels, _ROUTE_CODES[plan.route], plan.group, plan.vec, plan.parts,
                plan.wave, params.stride(0), _DTYPE_CODES[x.dtype], _DTYPE_CODES[params.dtype],
                _DTYPE_CODES[out_dtypes[0]], _DTYPE_CODES[out_dtypes[1]],
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"adain_backward launch failed ({plan}): cudaError {err}")
        cuda_build.count_launch(fused_adain_backward)
    return dx, dscale.to(scale.dtype), dbias.to(bias_dtype)


fused_adain_backward.launches = 0


class _FusedAdaIN(torch.autograd.Function):
    """:func:`fused_adain_forward` in ``forward``, :func:`fused_adain_backward`
    on the saved statistics in ``backward``."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        out, stats = fused_adain_forward(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, stats)
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, scale, stats = ctx.saved_tensors
        dx, dscale, dbias = fused_adain_backward(x, g, stats, scale, ctx.bias_dtype)
        return dx, dscale, dbias, None


def fused_adain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-3) -> torch.Tensor:
    """AdaIN over all spatial axes of x (B, *spatial, C) with (B, C)
    scale/bias, differentiable in all three (see the module docstring)."""
    return _FusedAdaIN.apply(x, scale, bias, eps)


def resolve_adain_impl(name: str, x: torch.Tensor) -> str:
    """"kernel" | "plain" | "auto".  "auto" takes the kernel for CUDA
    tensors and the plain version for CPU tensors."""
    if name == "auto":
        return "kernel" if x.is_cuda else "plain"
    if name not in ("kernel", "plain"):
        raise ValueError(f"unknown adain impl {name!r} (auto|kernel|plain)")
    return name
