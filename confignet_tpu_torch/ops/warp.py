"""Batched affine image warping on the caller's device (counterpart of
``confignet_tpu/ops/warp.py``).

The host normalisation pipeline warps with OpenCV (``data/normalizer.py``);
this is the batched equivalent for on-device preprocessing at serving time:
``M`` maps source to destination pixel coordinates, as for
``cv2.warpAffine``, and each output pixel samples the source at ``M``'s
inverse, bilinear, with zero outside the source.  The JAX function is plain
``jnp`` arithmetic, not a Pallas kernel, so this is plain torch: invert the
affines, gather the four corners, blend.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _invert_affine(M: torch.Tensor) -> torch.Tensor:
    """(B, 2, 3) -> (B, 2, 3) float32 inverse affines, computed in float64 as
    cv2.invertAffineTransform computes them.  Elementwise ops only, so the
    card and the CPU give the same bits."""
    a, b, tx = M[:, 0, 0].double(), M[:, 0, 1].double(), M[:, 0, 2].double()
    c, d, ty = M[:, 1, 0].double(), M[:, 1, 1].double(), M[:, 1, 2].double()
    inv_det = 1.0 / (a * d - b * c)
    i00, i01, i10, i11 = d * inv_det, -b * inv_det, -c * inv_det, a * inv_det
    rows = [torch.stack([i00, i01, -i00 * tx - i01 * ty], dim=1),
            torch.stack([i10, i11, -i10 * tx - i11 * ty], dim=1)]
    return torch.stack(rows, dim=1).float()


def affine_warp(images: torch.Tensor, M: torch.Tensor, output_shape: Sequence[int]) -> torch.Tensor:
    """Warp a batch of images with per-image 2x3 affines.

    ``images``: (B, H, W, C) float; ``M``: (B, 2, 3) source -> destination
    affines in (x, y) convention; ``output_shape``: (out_h, out_w).
    Bilinear sampling, zero outside the source; matches
    ``cv2.warpAffine(img, M, (out_w, out_h))``."""
    out_h, out_w = output_shape[:2]
    batch, h, w, channels = images.shape
    device = images.device
    M_inv = _invert_affine(M.to(device, torch.float32))

    ys, xs = torch.meshgrid(torch.arange(out_h, device=device, dtype=torch.float32),
                            torch.arange(out_w, device=device, dtype=torch.float32), indexing="ij")
    xs, ys = xs.reshape(1, -1), ys.reshape(1, -1)
    # (B, P): the source (x, y) of each output pixel
    x = M_inv[:, 0, 0:1] * xs + M_inv[:, 0, 1:2] * ys + M_inv[:, 0, 2:3]
    y = M_inv[:, 1, 0:1] * xs + M_inv[:, 1, 1:2] * ys + M_inv[:, 1, 2:3]

    x0f, y0f = torch.floor(x), torch.floor(y)
    dx, dy = (x - x0f)[..., None], (y - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = x0 + 1, y0 + 1
    flat = images.reshape(batch, h * w, channels)

    def fetch(yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
        # zero border (cv2 BORDER_CONSTANT 0): an outside corner adds nothing
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        values = torch.gather(flat, 1, idx[..., None].expand(-1, -1, channels))
        return values * inside[..., None].to(values.dtype)

    top = fetch(y0, x0) * (1 - dx) + fetch(y0, x1) * dx
    bottom = fetch(y1, x0) * (1 - dx) + fetch(y1, x1) * dx
    sampled = top * (1 - dy) + bottom * dy
    return sampled.reshape(batch, out_h, out_w, channels)
