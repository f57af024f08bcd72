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

Also the offline bakers: the distance field (:func:`bake_distance_field`,
plain PyTorch on the device over the exact point-to-triangle distance) and
the reference's host triangle rasterizer (:func:`rasterize_triangles_np`).
"""
from dataclasses import dataclass
from typing import Tuple

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


# --- baking (offline, once per map) -------------------------------------------

def grid_coordinates(origin: np.ndarray, cell_size: float, height: int,
                     width: int) -> np.ndarray:
    """(H, W, 2) world coordinates of all cell centers."""
    xs = origin[0] + np.arange(width) * cell_size
    ys = origin[1] + np.arange(height) * cell_size
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx, gy], axis=-1)


def mesh_extent(verts: np.ndarray, margin: float = 10.0) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned bounds of mesh vertices with a margin."""
    lo = np.asarray(verts).reshape(-1, 2).min(axis=0) - margin
    hi = np.asarray(verts).reshape(-1, 2).max(axis=0) + margin
    return lo, hi


def bake_distance_field(verts: np.ndarray, faces: np.ndarray, cell_size: float = 0.5,
                        margin: float = 10.0, chunk_cells: int = 8192,
                        face_chunk: int = 4096, *, device='cuda') -> Grid2D:
    """
    Bake an unsigned distance-to-mesh field (in meters, 0 on the mesh),
    exactly, by the point-to-triangle distance over chunks of
    ``chunk_cells`` cells and ``face_chunk`` faces on ``device``, as the
    reference does. One-time cost per map; cache the result.

    Args:
        verts: (V, 2) mesh vertices; faces: (F, 3) triangle indices.
    Returns:
        Grid2D of (H, W, 1) float32 distances on ``device``.
    """
    from torchdrivesim_tpu_torch.ops.point_mesh import point_to_triangles_distance_sq_chunked
    dev = torch.device(device)
    verts = np.asarray(verts, dtype=np.float32).reshape(-1, 2)
    faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    lo, hi = mesh_extent(verts, margin)
    width = int(np.ceil((hi[0] - lo[0]) / cell_size)) + 1
    height = int(np.ceil((hi[1] - lo[1]) / cell_size)) + 1
    coords = grid_coordinates(lo, cell_size, height, width).reshape(-1, 2).astype(np.float32)
    tris = torch.as_tensor(verts[faces], device=dev)               # (F, 3, 2)
    out = torch.empty((coords.shape[0],), dtype=torch.float32, device=dev)
    for start in range(0, coords.shape[0], chunk_cells):
        pts = torch.as_tensor(coords[start:start + chunk_cells], device=dev)
        out[start:start + pts.shape[0]] = torch.sqrt(
            point_to_triangles_distance_sq_chunked(pts, tris, chunk=face_chunk))
    return Grid2D(data=out.reshape(height, width, 1),
                  origin=torch.as_tensor(lo, dtype=torch.float32, device=dev),
                  cell_size=float(cell_size))


def rasterize_triangles_np(verts: np.ndarray, faces: np.ndarray, values: np.ndarray,
                           origin: np.ndarray, cell_size: float, height: int, width: int,
                           layers: int = 4, tolerance: float = 0.0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """
    Host-side triangle rasterization collecting up to ``layers`` distinct
    per-cell values (overlapping triangles each contribute a candidate,
    values within 0.1 rad of one already there are skipped).

    Args:
        verts: (V, 2); faces: (F, 3); values: (F,) value per face.
        tolerance: dilate each triangle's coverage by this many meters.
    Returns:
        (data (H, W, layers), count (H, W)) arrays; unused slots are 0.
    """
    data = np.zeros((height, width, layers), dtype=np.float32)
    count = np.zeros((height, width), dtype=np.int32)
    tol_cells = int(np.ceil(tolerance / cell_size))
    tri = verts[faces]                                             # (F, 3, 2)
    for f in range(tri.shape[0]):
        t = tri[f]
        v = values[f]
        lo = np.floor((t.min(axis=0) - origin) / cell_size).astype(int) - tol_cells
        hi = np.ceil((t.max(axis=0) - origin) / cell_size).astype(int) + tol_cells + 1
        x0, y0 = max(lo[0], 0), max(lo[1], 0)
        x1, y1 = min(hi[0], width), min(hi[1], height)
        if x0 >= x1 or y0 >= y1:
            continue
        xs = origin[0] + np.arange(x0, x1) * cell_size
        ys = origin[1] + np.arange(y0, y1) * cell_size
        gx, gy = np.meshgrid(xs, ys)
        p = np.stack([gx, gy], axis=-1)
        inside = _points_near_triangle_np(p.reshape(-1, 2), t, tolerance).reshape(p.shape[:2])
        iy, ix = np.nonzero(inside)
        for k in range(len(iy)):
            cy, cx = iy[k] + y0, ix[k] + x0
            c = count[cy, cx]
            existing = data[cy, cx, :c]
            if c > 0 and np.any(np.abs(np.angle(np.exp(1j * (existing - v)))) < 0.1):
                continue
            if c < layers:
                data[cy, cx, c] = v
                count[cy, cx] = c + 1
    return data, count


def _points_near_triangle_np(p: np.ndarray, tri: np.ndarray, tolerance: float) -> np.ndarray:
    """Which points lie inside a triangle (either winding) or within
    ``tolerance`` of its edges."""
    v0, v1, v2 = tri[0], tri[1], tri[2]
    d = np.stack([_seg_dist_np(p, v0, v1), _seg_dist_np(p, v1, v2),
                  _seg_dist_np(p, v2, v0)], axis=0).min(axis=0)

    def cross(a, b, pts):
        return (b[0] - a[0]) * (pts[:, 1] - a[1]) - (b[1] - a[1]) * (pts[:, 0] - a[0])
    c0, c1, c2 = cross(v0, v1, p), cross(v1, v2, p), cross(v2, v0, p)
    inside = ((c0 >= 0) & (c1 >= 0) & (c2 >= 0)) | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0))
    return inside | (d <= tolerance)


def _seg_dist_np(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distances of points (N, 2) to the segment a-b."""
    ab = b - a
    l2 = float(ab @ ab)
    if l2 < 1e-12:
        return np.linalg.norm(p - a, axis=-1)
    t = np.clip(((p - a) @ ab) / l2, 0.0, 1.0)
    proj = a[None] + t[:, None] * ab[None]
    return np.linalg.norm(p - proj, axis=-1)
