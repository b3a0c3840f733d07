"""Image helpers (counterpart of ``confignet_tpu/core/images.py``): the
train step's device-side flip, the uint8 conversions, the checkpoint panel
layout, and PNG and baseline JPEG writers that need only numpy and the
standard library (the JAX package writes with cv2 or PIL)."""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np
import torch


def batched_hflip(images: torch.Tensor, flip_mask: torch.Tensor) -> torch.Tensor:
    """Horizontal flip (axis 2, W of NHWC) of the images where ``flip_mask``
    (B,) is true, as the JAX ``batched_hflip`` blends it."""
    mask = flip_mask.to(images.dtype).reshape(-1, 1, 1, 1)
    return images * (1 - mask) + images.flip(2) * mask


def uint8_to_unit_range(images: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return images.astype(np.float32) / 127.5 - 1.0


def unit_range_to_uint8(images) -> np.ndarray:
    """float [-1, 1] -> uint8 [0, 255]: clipped, (x + 1) * 127.5, truncated."""
    images = np.clip(np.asarray(images), -1.0, 1.0)
    return ((images + 1.0) * 127.5).astype(np.uint8)


def build_image_matrix(images: np.ndarray, n_rows: int, n_cols: int) -> np.ndarray:
    """Tile a stack of (H, W, 3) images into an (n_rows, n_cols) grid: image
    ``j * n_cols + i`` lands at row ``j``, column ``i`` (reference:
    confignet/confignet_utils.py:182-190)."""
    height, width = images.shape[1:3]
    matrix = np.zeros((n_rows * height, n_cols * width, 3), dtype=np.uint8)
    for i in range(n_cols):
        for j in range(n_rows):
            matrix[j * height:(j + 1) * height, i * width:(i + 1) * width] = images[j * n_cols + i]
    return matrix


def flip_random_subset_of_images(images: np.ndarray, rng: Optional[np.random.Generator] = None
                                 ) -> np.ndarray:
    """Horizontally flip a random ~50% subset of a batch in place, drawing
    from ``rng`` or else the global ``np.random`` (reference:
    confignet/confignet_utils.py:198-204)."""
    if rng is None:
        flip_or_not = np.random.randint(0, 2, size=images.shape[0])
    else:
        flip_or_not = rng.integers(0, 2, size=images.shape[0])
    for i, flip in enumerate(flip_or_not):
        if flip == 1:
            images[i] = np.fliplr(images[i])
    return images


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


# The baseline JPEG writer: 8x8 DCT, the quantisation tables of the JPEG
# standard's Annex K scaled as libjpeg scales them for a quality, no chroma
# subsampling, one interleaved scan.  The Huffman tables are canonical codes
# of one length per class (4 bits for the 12 DC size categories, 8 bits for
# the 162 AC run/size symbols): valid baseline tables that any decoder reads,
# which keep the encoder a few vectorised numpy passes.
_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.float64).reshape(8, 8)
_CHROMA_QUANT = np.full((8, 8), 99.0)
_CHROMA_QUANT[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]
# (row, col) of each zig-zag position
_ZIGZAG = sorted(((r, c) for r in range(8) for c in range(8)),
                 key=lambda rc: (rc[0] + rc[1], rc[0] if (rc[0] + rc[1]) % 2 else -rc[0]))
_ZIGZAG_FLAT = np.array([r * 8 + c for r, c in _ZIGZAG])
_DCT = np.array([[(np.sqrt(0.125) if k == 0 else 0.5) * np.cos((2 * n + 1) * k * np.pi / 16)
                  for n in range(8)] for k in range(8)])
_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(run << 4) | size for run in range(16) for size in range(1, 11)]
_DC_BITS, _AC_BITS = 4, 8
_AC_CODE = np.zeros(256, np.int64)
_AC_CODE[_AC_SYMBOLS] = np.arange(len(_AC_SYMBOLS))


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    return np.clip(np.floor((base * scale + 50) / 100), 1, 255)


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _huffman_table(table_class: int, table_id: int, symbols, code_bits: int) -> bytes:
    counts = [0] * 16
    counts[code_bits - 1] = len(symbols)
    return bytes([(table_class << 4) | table_id] + counts + list(symbols))


def _bit_size(values: np.ndarray) -> np.ndarray:
    """The JPEG size category of each value: the bit length of |value| (0
    for 0), frexp's exponent."""
    return np.frexp(np.abs(values).astype(np.float32))[1].astype(np.int64)


def _amplitude(values: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The value's ``size`` low bits: itself if positive, else value - 1."""
    return np.where(values >= 0, values, values + (1 << size) - 1)


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """The tokens' bits, most significant first, back to back, the last
    byte padded with 1-bits.  Each token (at most 32 bits) lands in at most
    two 32-bit words: its bits are shifted into place in a 64-bit window and
    the windows' halves summed per word (tokens never overlap)."""
    starts = np.cumsum(lengths) - lengths
    total = int(starts[-1] + lengths[-1]) if lengths.size else 0
    word = starts >> 5
    window = values.astype(np.uint64) << (64 - (starts & 31) - lengths).astype(np.uint64)
    n_words = (total >> 5) + 2
    words = (np.bincount(word, (window >> np.uint64(32)).astype(np.float64), n_words)
             + np.bincount(word + 1, (window & np.uint64(0xFFFFFFFF)).astype(np.float64), n_words))
    data = words.astype(np.uint64).astype(">u4").view(np.uint8)
    n_bytes = -(-total // 8)
    data = data[:n_bytes].copy()
    if total % 8:
        data[-1] |= (1 << (8 - total % 8)) - 1
    return data


def _entropy_coded(coefficients: np.ndarray) -> bytes:
    """The scan's bytes for quantised zig-zag coefficients (blocks, 64) in
    scan order, each component's DC coded as the difference to its previous
    block (``coefficients`` holds the components interleaved, 3 per MCU).
    Each block's tokens are its DC code with amplitude bits, then for each
    nonzero AC coefficient a ZRL code per 16 zeros before it and its
    run/size code with amplitude bits, then an end-of-block code unless its
    last coefficient is nonzero; every token's slot is computed, not sorted."""
    n_blocks = coefficients.shape[0]
    dc_diff = np.diff(coefficients[:, 0].reshape(-1, 3), axis=0, prepend=0).reshape(-1)
    dc_size = _bit_size(dc_diff)

    ac = coefficients[:, 1:]
    nonzero = ac != 0
    block, pos = np.nonzero(nonzero)
    coef = ac[nonzero]
    pos = pos + 1  # zig-zag index 1..63
    first_in_block = np.ones(block.shape, bool)
    first_in_block[1:] = block[1:] != block[:-1]
    previous = np.where(first_in_block, 0, np.concatenate([[0], pos[:-1]]))
    run = pos - previous - 1
    size = _bit_size(coef)
    n_zrl = run // 16
    last = np.zeros(n_blocks, np.int64)
    last[block] = pos  # the last nonzero position of each block (ascending within it)
    has_eob = last < 63

    # slots: a block's tokens start after the previous blocks'
    per_coef = 1 + n_zrl
    coef_tokens = np.bincount(block, per_coef, n_blocks).astype(np.int64)
    block_start = np.cumsum(1 + coef_tokens + has_eob) - (1 + coef_tokens + has_eob)
    before_in_block = np.cumsum(per_coef) - per_coef
    block_first = np.cumsum(coef_tokens) - coef_tokens  # tokens of earlier blocks' coefficients
    coef_slot = block_start[block] + 1 + (before_in_block - block_first[block]) + n_zrl
    n_tokens = int(block_start[-1] + 1 + coef_tokens[-1] + has_eob[-1])

    values = np.zeros(n_tokens, np.int64)
    lengths = np.zeros(n_tokens, np.int64)
    values[block_start] = (dc_size << dc_size) | _amplitude(dc_diff, dc_size)
    lengths[block_start] = _DC_BITS + dc_size
    values[coef_slot] = (_AC_CODE[((run % 16) << 4) | size] << size) | _amplitude(coef, size)
    lengths[coef_slot] = _AC_BITS + size
    zrl_owner = np.repeat(np.arange(block.size), n_zrl)
    zrl_slot = coef_slot[zrl_owner] - n_zrl[zrl_owner] + (
        np.arange(zrl_owner.size) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl))
    values[zrl_slot] = _AC_CODE[0xF0]
    lengths[zrl_slot] = _AC_BITS
    eob_slot = (block_start + 1 + coef_tokens)[has_eob]
    values[eob_slot] = _AC_CODE[0x00]
    lengths[eob_slot] = _AC_BITS

    data = _pack_bits(values, lengths)
    return np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).tobytes()  # byte stuffing


def write_jpeg(path: str, img_bgr: np.ndarray, quality: int = 95) -> None:
    """Write a uint8 (H, W, 3) image in BGR order (as cv2.imwrite takes it)
    as a baseline JFIF JPEG: YCbCr without subsampling, the standard's
    quantisation tables at ``quality`` (libjpeg's scaling)."""
    img = np.asarray(img_bgr)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_jpeg takes a uint8 (H, W, 3) image, got {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    b, g, r = (img[..., i].astype(np.float32) for i in range(3))
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    pad = ((0, -height % 8), (0, -width % 8))
    tables = [_quant_table(_LUMA_QUANT, quality), _quant_table(_CHROMA_QUANT, quality)]
    blocks = []
    for index, plane in enumerate(planes):
        plane = np.pad(plane, pad, mode="edge") - 128.0
        rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
        tiles = plane.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        dct = _DCT @ tiles @ _DCT.T
        quantised = np.round(dct / tables[min(index, 1)]).astype(np.int64)
        blocks.append(quantised.reshape(-1, 64)[:, _ZIGZAG_FLAT])
    coefficients = np.stack(blocks, axis=1).reshape(-1, 64)  # MCU order: Y, Cb, Cr

    quant = b"".join(bytes([i]) + bytes(t.reshape(-1)[_ZIGZAG_FLAT].astype(np.uint8))
                     for i, t in enumerate(tables))
    huffman = (_huffman_table(0, 0, _DC_SYMBOLS, _DC_BITS)
               + _huffman_table(1, 0, _AC_SYMBOLS, _AC_BITS))
    frame = struct.pack(">BHHB", 8, height, width, 3) + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])
    scan = bytes([3, 1, 0x00, 2, 0x00, 3, 0x00, 0, 63, 0])
    with open(path, "wb") as fp:
        fp.write(b"\xff\xd8"
                 + _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
                 + _segment(0xFFDB, quant) + _segment(0xFFC0, frame)
                 + _segment(0xFFC4, huffman) + _segment(0xFFDA, scan)
                 + _entropy_coded(coefficients) + b"\xff\xd9")
