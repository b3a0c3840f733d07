"""3D transforms used by the volumetric generator (counterpart of
``confignet_tpu/core/transforms.py``).

- :func:`euler_angles_to_matrix` mirrors the reference's rotation
  composition (reference: confignet/confignet_utils.py:122-145).
- :func:`rotate_3d_grid` is the gather form of the trilinear resample of a
  cubic feature grid about its center (reference:
  confignet/confignet_utils.py:63-120).  It is fully differentiable,
  including with respect to the transform.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.constants import device_constant


def euler_angles_to_matrix(angle_vector: torch.Tensor) -> torch.Tensor:
    """(B, 3) Euler angles -> (B, 3, 3) rotation matrices (closed form of the
    reference's composition)."""
    angles = angle_vector.reshape(-1, 3)
    sins = torch.sin(angles)
    coss = torch.cos(angles)

    s0, s1, s2 = sins[:, 0], sins[:, 1], sins[:, 2]
    c0, c1, c2 = coss[:, 0], coss[:, 1], coss[:, 2]

    a11 = c2 * c1
    a12 = -s2
    a13 = c2 * s1
    a21 = s0 * s1 + c0 * c1 * s2
    a22 = c0 * c2
    a23 = c0 * s2 * s1 - c1 * s0
    a31 = c1 * s0 * s2 - c0 * s1
    a32 = c2 * s0
    a33 = c0 * c1 + s0 * s1 * s2

    mat = torch.stack([a11, a12, a13, a21, a22, a23, a31, a32, a33], dim=-1)
    return mat.reshape(-1, 3, 3)


def _grid_coords(grid_size: int) -> np.ndarray:
    """Static (3, S^3) integer lattice coordinates in 'ij' order (grid axis 1
    is "x", the slowest; z is the fastest)."""
    r = np.arange(grid_size)
    xs, ys, zs = np.meshgrid(r, r, r, indexing="ij")
    return np.vstack((xs.flatten(), ys.flatten(), zs.flatten())).astype(np.float32)


def _source_coords(grid: torch.Tensor, transform: torch.Tensor):
    """Clamped source coordinates of every lattice point: (floor, ceil, frac),
    each (B, 3, S^3); floor/ceil int32, frac float32.

    Always computed in (at least) float32: the coordinate precision decides
    which interpolation cell a point lands in, whatever the feature dtype.
    The 3-term dot products are written out so that no matrix unit (TF32)
    can round them.
    """
    size = grid.shape[1]
    center = (size - 1) / 2.0
    coord_dtype = torch.float64 if grid.dtype == torch.float64 else torch.float32
    rel = device_constant(("grid_coords", size), lambda: _grid_coords(size) - center, coord_dtype,
                          grid.device)
    t = transform.to(coord_dtype)
    src = (t[:, :, 0:1] * rel[0] + t[:, :, 1:2] * rel[1] + t[:, :, 2:3] * rel[2]) + center
    src = torch.clamp(src, 0.0, size - 1)
    floor = torch.clamp(torch.floor(src), 0.0, size - 1)
    ceil = torch.clamp(floor + 1.0, 0.0, size - 1)
    return floor.to(torch.int32), ceil.to(torch.int32), src - floor


def rotate_3d_grid(grid: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Trilinearly resample a (B, S, S, S, C) grid under per-sample 3x3
    transforms applied about the grid center.  Out-of-range source
    coordinates clamp to the border.  The arithmetic runs in the grid's
    dtype, as in the JAX gather form."""
    if not grid.shape[1] == grid.shape[2] == grid.shape[3]:
        raise ValueError(f"grid must be cubic, got {tuple(grid.shape)}")
    batch, size, channels = grid.shape[0], grid.shape[1], grid.shape[4]
    num_points = size ** 3

    f, c, diffs = _source_coords(grid, transform)
    f, c = f.long(), c.long()
    diffs = diffs.to(grid.dtype)

    flat_grid = grid.reshape(batch, num_points, channels)

    def fetch(x_idx, y_idx, z_idx):
        idx = (x_idx * size + y_idx) * size + z_idx  # (B, P)
        return torch.gather(flat_grid, 1, idx[:, :, None].expand(-1, -1, channels))

    c000 = fetch(f[:, 0], f[:, 1], f[:, 2])
    c100 = fetch(c[:, 0], f[:, 1], f[:, 2])
    c001 = fetch(f[:, 0], f[:, 1], c[:, 2])
    c101 = fetch(c[:, 0], f[:, 1], c[:, 2])
    c010 = fetch(f[:, 0], c[:, 1], f[:, 2])
    c110 = fetch(c[:, 0], c[:, 1], f[:, 2])
    c011 = fetch(f[:, 0], c[:, 1], c[:, 2])
    c111 = fetch(c[:, 0], c[:, 1], c[:, 2])

    dx = diffs[:, 0][:, :, None]
    dy = diffs[:, 1][:, :, None]
    dz = diffs[:, 2][:, :, None]

    c00 = c000 * (1 - dx) + c100 * dx
    c01 = c001 * (1 - dx) + c101 * dx
    c10 = c010 * (1 - dx) + c110 * dx
    c11 = c011 * (1 - dx) + c111 * dx

    c0 = c00 * (1 - dy) + c10 * dy
    c1 = c01 * (1 - dy) + c11 * dy

    out = c0 * (1 - dz) + c1 * dz
    return out.reshape(grid.shape)
