"""
World-anchored grids and their samplers (counterpart of
``torchdrivesim_tpu/ops/grids.py``).

The reference repacks its grids into 128-lane rows because a scattered
gather is slow on a TPU; on a GPU each sample is a plain indexed load, so
the grids stay 2D here. The values sampled are bit-identical: the bilinear
distance grid keeps the reference's bfloat16 2x2 quad packing, and the
``fill_value`` rules are the reference's.

Grids are row-major with ``data[iy, ix]`` covering the world-space cell
``origin + (ix, iy) * cell_size``.
"""
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Grid2D:
    """A world-anchored 2D grid of C channels."""
    data: torch.Tensor         #: (H, W, C)
    origin: torch.Tensor       #: (2,) float32, world coordinates of cell (0, 0)
    cell_size: float = 1.0


def bilinear_sample(grid: Grid2D, points: torch.Tensor,
                    fill_value: float = 0.0) -> torch.Tensor:
    """
    Bilinear interpolation of the grid's channels at world points,
    differentiable in the points (the floor indices carry no gradient).
    Each of the four taps outside the grid reads ``fill_value``.

    Args:
        points: (..., 2) world coordinates.
    Returns:
        (..., C) interpolated channel values.
    """
    data = torch.as_tensor(grid.data, device=points.device)
    origin = torch.as_tensor(grid.origin, dtype=points.dtype, device=points.device)
    uv = (points - origin) / grid.cell_size
    x, y = uv[..., 0], uv[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = (x - x0)[..., None]
    ty = (y - y0)[..., None]
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    h, w = data.shape[0], data.shape[1]

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = data[yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return torch.where(valid[..., None], vals, torch.full_like(vals, fill_value))

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    return top * (1 - ty) + bot * ty


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round float32 to bfloat16 (nearest even) and return its 16 bits."""
    b = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return b.to(torch.bfloat16).view(torch.int16).numpy().astype(np.int32) & 0xFFFF


def pack_bilinear_quad(data: np.ndarray) -> np.ndarray:
    """
    (H, W, 1) float grid -> (H, W, 2) int32: at cell (y, x) the 2x2 quad
    {(y, x), (y, x+1), (y+1, x), (y+1, x+1)} as four bfloat16s, channel 0
    = row y (v00 high half, v01 low), channel 1 = row y+1 (host numpy).
    """
    v = np.asarray(data)[..., 0].astype(np.float32)
    vpad = np.pad(v, ((0, 1), (0, 1)), constant_values=0.0)
    h, w = v.shape

    def pack_row(r):
        return (_bf16_bits(r[:h, :w]) << 16) | _bf16_bits(r[:h, 1:w + 1])

    return np.stack([pack_row(vpad), pack_row(vpad[1:])], axis=-1).astype(np.int32)


def _unbf(bits: torch.Tensor) -> torch.Tensor:
    return ((bits & 0xFFFF) << 16).view(torch.float32)


def bilinear_sample_quad(packed: Grid2D, points: torch.Tensor,
                         fill_value: float = 0.0) -> torch.Tensor:
    """
    Bilinear interpolation through a quad grid from
    :func:`pack_bilinear_quad`: one int32x2 load per point. Quads straddling
    the grid boundary read ``fill_value`` whole, as in the reference.

    Returns:
        (...) interpolated values.
    """
    uv = (points - packed.origin) / packed.cell_size
    x, y = uv[..., 0], uv[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    h, w = packed.data.shape[0], packed.data.shape[1]
    valid = (x0i >= 0) & (x0i < w - 1) & (y0i >= 0) & (y0i < h - 1)
    xi = torch.clamp(x0i, 0, w - 1).long()
    yi = torch.clamp(y0i, 0, h - 1).long()
    g = packed.data[yi, xi]                                # (..., 2) int32
    v00, v01 = _unbf(g[..., 0] >> 16), _unbf(g[..., 0])
    v10, v11 = _unbf(g[..., 1] >> 16), _unbf(g[..., 1])
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    out = top * (1 - ty) + bot * ty
    return torch.where(valid, out, torch.full_like(out, fill_value))


def nearest_sample(grid: Grid2D, points: torch.Tensor,
                   fill_value: int) -> torch.Tensor:
    """Nearest-cell sample of a single-channel int32 grid (round half to
    even, as the reference); out-of-bounds points get ``fill_value``."""
    uv = (points - grid.origin) / grid.cell_size
    xi = torch.round(uv[..., 0]).to(torch.int32)
    yi = torch.round(uv[..., 1]).to(torch.int32)
    h, w = grid.data.shape[0], grid.data.shape[1]
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    xi = torch.clamp(xi, 0, w - 1).long()
    yi = torch.clamp(yi, 0, h - 1).long()
    val = grid.data[yi, xi, 0]
    return torch.where(valid, val, torch.full_like(val, fill_value))
