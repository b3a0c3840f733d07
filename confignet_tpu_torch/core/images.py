"""Image helpers (counterpart of ``confignet_tpu/core/images.py``): the
train step's device-side flip, the uint8 conversion and a PNG writer that
needs only the standard library (the JAX package writes with cv2 or PIL)."""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def batched_hflip(images: torch.Tensor, flip_mask: torch.Tensor) -> torch.Tensor:
    """Horizontal flip (axis 2, W of NHWC) of the images where ``flip_mask``
    (B,) is true, as the JAX ``batched_hflip`` blends it."""
    mask = flip_mask.to(images.dtype).reshape(-1, 1, 1, 1)
    return images * (1 - mask) + images.flip(2) * mask


def unit_range_to_uint8(images) -> np.ndarray:
    """float [-1, 1] -> uint8 [0, 255]: clipped, (x + 1) * 127.5, truncated."""
    images = np.clip(np.asarray(images), -1.0, 1.0)
    return ((images + 1.0) * 127.5).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img_bgr: np.ndarray) -> None:
    """Write a uint8 (H, W, 3) image in BGR order (as cv2.imwrite takes it)
    as an 8-bit RGB PNG: unfiltered rows, zlib level 1."""
    img = np.asarray(img_bgr)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes a uint8 (H, W, 3) image, got {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    rows = img[..., ::-1].reshape(height, -1)  # BGR -> the file's RGB
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()  # filter 0
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)  # 8-bit truecolour
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                 + _png_chunk(b"IDAT", zlib.compress(raw, 1)) + _png_chunk(b"IEND", b""))
