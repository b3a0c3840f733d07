"""Fused AdaIN (instance norm + latent modulation) as a hand-written CUDA
kernel (counterpart of ``confignet_tpu/ops/adain_pallas.py``, forward only).

The contract is the Pallas kernel's: statistics over ALL non-batch,
non-channel axes in float32 (biased variance, eps inside the rsqrt), output
``xhat * (scale + 1) + bias`` in x's dtype, ``scale``/``bias`` (B, C) in
any float dtype.  :func:`fused_adain` is the wrapper: CUDA tensors go
through ``csrc/adain.cu`` (see the note there), CPU tensors through the
plain version :func:`fused_adain_plain`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from confignet_tpu_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # kThreads in csrc/adain.cu
_BLOCKS_PER_SM = 16  # enough chunks to fill every SM several times over


def fused_adain_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-3) -> torch.Tensor:
    """The kernel's plain PyTorch version."""
    x3 = x.reshape(x.shape[0], -1, x.shape[-1]).float()
    mean = x3.mean(dim=1, keepdim=True)
    var = (x3 - mean).square().mean(dim=1, keepdim=True)
    xhat = (x3 - mean) * torch.rsqrt(var + eps)
    out = xhat * (scale.float()[:, None, :] + 1.0) + bias.float()[:, None, :]
    return out.to(x.dtype).reshape(x.shape)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("adain")
    fn = lib.adain_forward
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _chunks(x: torch.Tensor, batch: int, positions: int, channels: int) -> int:
    """How many chunks the positions are cut into (csrc/adain.cu): enough
    blocks to fill the card, at least 4 rows per thread per chunk."""
    lanes = min(channels, 32)
    rows = 1
    while rows * 2 * lanes <= _THREADS:
        rows *= 2
    groups = math.ceil(channels / lanes)
    target = _BLOCKS_PER_SM * torch.cuda.get_device_properties(x.device).multi_processor_count
    return max(1, min(math.ceil(target / (batch * groups)), math.ceil(positions / (4 * rows)), 65535))


def _param(t: torch.Tensor) -> torch.Tensor:
    """scale/bias as the kernel reads them: float32 or bf16, unit channel
    stride (row views such as ``params[:, 0]`` pass without a copy)."""
    if t.dtype not in _DTYPE_CODES:
        t = t.float()
    return t if t.stride(1) == 1 else t.contiguous()


def fused_adain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-3) -> torch.Tensor:
    """AdaIN over all spatial axes of x (B, *spatial, C) with (B, C)
    scale/bias.  CUDA tensors go through the kernel (or raise); CPU tensors
    through :func:`fused_adain_plain`."""
    if x.device.type == "cpu":
        return fused_adain_plain(x, scale, bias, eps)
    if x.device.type != "cuda" or scale.device != x.device or bias.device != x.device:
        raise ValueError(f"x on {x.device}, scale on {scale.device}, bias on {bias.device}: "
                         "the kernel needs all three on the same CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"AdaIN kernel takes float32 or bfloat16 x, got {x.dtype}")
    if x.ndim < 3:
        raise ValueError(f"x must be (B, *spatial, C), got {tuple(x.shape)}")
    batch, channels = x.shape[0], x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (batch, channels) or not t.is_floating_point():
            raise ValueError(f"{name} must be a float ({batch}, {channels}) tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not x.is_contiguous():
        raise ValueError("AdaIN kernel needs a contiguous (channels-last) x")
    if x.numel() == 0:
        return torch.empty_like(x)

    positions = x.numel() // (batch * channels)
    scale, bias = _param(scale), _param(bias)
    chunks = _chunks(x, batch, positions, channels)
    partial = torch.empty((batch, chunks, 2, channels), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().adain_forward(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), partial.data_ptr(),
            batch, positions, channels, chunks, scale.stride(0), bias.stride(0),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], _DTYPE_CODES[bias.dtype],
            float(eps), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"adain_forward launch failed: cudaError {err}")
    fused_adain.launches += 1
    return out


fused_adain.launches = 0


def resolve_adain_impl(name: str, x: torch.Tensor) -> str:
    """"kernel" | "plain" | "auto".  "auto" takes the kernel for CUDA
    tensors and the plain version for CPU tensors."""
    if name == "auto":
        return "kernel" if x.is_cuda else "plain"
    if name not in ("kernel", "plain"):
        raise ValueError(f"unknown adain impl {name!r} (auto|kernel|plain)")
    return name
