"""A convolution's bias add, residual add and ReLU as one hand-written CUDA
pass (``csrc/epilogue.cu``), for the folded ResNet50 trunk's channels-first
route (``models/backbones/resnet.py``).  It replaces no TPU kernel: on the
TPU XLA fuses these elementwise ops with the convolutions, and PyTorch ran
them as three separate passes over device memory.

- :func:`conv_epilogue` is the kernel's wrapper.  It takes ``y``, the raw
  (B, C, H, W) output of a convolution called without its bias, and returns
  ``relu(y + bias)``; with ``residual`` (the identity shortcut, y's shape)
  ``relu((y + bias) + residual)``; with ``shortcut`` and ``shortcut_bias``
  (a projection shortcut's raw output and its bias)
  ``relu((y + bias) + (shortcut + shortcut_bias))``.  On a CUDA tensor it
  launches the kernel, which writes the result into ``y`` and returns it,
  or raises; on a CPU tensor it takes :func:`conv_epilogue_plain`.
- :func:`conv_epilogue_plain` is the same formula in torch ops: the
  float32 additions in the kernel's order, which is the order of the
  separate passes it replaces (the convolution's bias added to its output,
  then the shortcut, then ReLU), so kernel and plain version agree to the
  bit.

The bound is bytes: ``y`` read and written once, the shortcut read once.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from confignet_tpu_torch.ops import cuda_build


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None,
                        shortcut: Optional[torch.Tensor] = None,
                        shortcut_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`conv_epilogue`'s formula in torch ops, on a new tensor."""
    out = y + bias[:, None, None]
    if residual is not None:
        out = out + residual
    elif shortcut is not None:
        out = out + (shortcut + shortcut_bias[:, None, None])
    return torch.relu(out)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("epilogue")
    if lib.conv_epilogue.argtypes is None:
        ptr = ctypes.c_void_p
        lib.conv_epilogue.restype = ctypes.c_int
        lib.conv_epilogue.argtypes = [ptr] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                                  ctypes.c_longlong, ptr]
    return lib


def _check(y: torch.Tensor, bias: torch.Tensor, residual, shortcut, shortcut_bias) -> None:
    """What the kernel takes: float32 tensors on y's CUDA device, y and the
    shortcut (B, C, H, W) and contiguous, the biases (C,)."""
    if residual is not None and shortcut is not None:
        raise ValueError("conv_epilogue takes a residual or a shortcut, not both")
    if (shortcut is None) != (shortcut_bias is None):
        raise ValueError("conv_epilogue takes a shortcut with its bias")
    tensors = [t for t in (y, bias, residual, shortcut, shortcut_bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("conv_epilogue has no backward: call it with autograd off")
    if y.ndim != 4:
        raise ValueError(f"y must be (B, C, H, W), got {tuple(y.shape)}")
    planes = [("y", y)] + [(n, t) for n, t in (("residual", residual), ("shortcut", shortcut))
                           if t is not None]
    biases = [("bias", bias)] + ([("shortcut_bias", shortcut_bias)] if shortcut is not None else [])
    for name, t in planes + biases:
        if t.device != y.device or t.dtype != torch.float32:
            raise TypeError(f"conv_epilogue takes float32 tensors on {y.device}, got {name} "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"conv_epilogue needs a contiguous (NCHW) {name}")
    for name, t in planes[1:]:
        if t.shape != y.shape:
            raise ValueError(f"{name} must have y's shape {tuple(y.shape)}, got {tuple(t.shape)}")
    for name, t in biases:
        if t.shape != (y.shape[1],):
            raise ValueError(f"{name} must be ({y.shape[1]},), got {tuple(t.shape)}")


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                  shortcut: Optional[torch.Tensor] = None,
                  shortcut_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's wrapper (no autograd; see the module's docstring).  A
    CUDA ``y`` is updated in place and returned; a CPU one is left as it is
    and the plain version's new tensor returned."""
    if y.device.type == "cpu":
        return conv_epilogue_plain(y, bias, residual, shortcut, shortcut_bias)
    _check(y, bias, residual, shortcut, shortcut_bias)
    if y.numel() == 0:
        return y
    batch, channels, height, width = y.shape
    pointer = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(y.device):
        err = _library().conv_epilogue(
            y.data_ptr(), bias.data_ptr(), pointer(residual), pointer(shortcut),
            pointer(shortcut_bias), batch * channels, channels, height * width,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue launch failed for {tuple(y.shape)}: cudaError {err}")
    cuda_build.count_launch(conv_epilogue)
    return y


conv_epilogue.launches = 0
