"""
Per-map baked grids: distance-to-road and lane-direction fields, the
offroad and wrong-way losses read from them, and their bakers (counterpart
of ``torchdrivesim_tpu/map_grids.py``). The distance field is baked on the
device (``ops.grids.bake_distance_field``); the direction field on the host
by the native baker (``native/mapbake.cpp``) or, without ``g++`` or with
``TDS_NO_NATIVE`` set, by the Python baker here. :data:`DIRECTION_BAKES`
counts which one ran.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from torchdrivesim_tpu_torch.ops.box import box2corners
from torchdrivesim_tpu_torch.ops.grids import (
    Grid2D, bilinear_sample_quad, nearest_sample, pack_bilinear_quad,
)

if TYPE_CHECKING:
    from torchdrivesim_tpu_torch.map import MapConfig

DIRECTION_LAYERS = 4
#: sentinel byte marking an empty direction layer in the packed grid
DIRECTION_INVALID = 255
#: packed direction value with every layer invalid (int32 bits 0xFFFFFFFF)
_ALL_INVALID = int(np.uint32(sum(DIRECTION_INVALID << (8 * k)
                                 for k in range(DIRECTION_LAYERS))).astype(np.int32))

#: direction fields baked since import, by path ('native' or 'python')
DIRECTION_BAKES = {'native': 0, 'python': 0}


def _host(x) -> np.ndarray:
    """A tensor or array as host numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@dataclass
class MapGrids:
    """Baked fields for one map, on one device."""
    distance_quad: Grid2D         #: (H, W, 2) int32 bfloat16 bilinear quads
    direction: Optional[Grid2D]   #: (H, W, 1) int32: 4 packed 8-bit angles
        # (byte k = layer k; 0..254 quantize [-pi, pi); 255 = invalid)
    #: (H, W, 1) float32 distance to the road surface in meters, which the
    #: quads pack and :meth:`save` writes
    distance: Optional[Grid2D] = None

    def save(self, path: str):
        """Write the reference's cache: the distance field as float16, the
        packed direction field as int32, each with its origin (float64) and
        cell size."""
        arrays = {
            'distance': _host(self.distance.data).astype(np.float16),
            'distance_origin': _host(self.distance.origin).astype(np.float64),
            'distance_cell': np.asarray(self.distance.cell_size),
        }
        if self.direction is not None:
            arrays.update({
                'direction': _host(self.direction.data).astype(np.int32),
                'direction_origin': _host(self.direction.origin).astype(np.float64),
                'direction_cell': np.asarray(self.direction.cell_size),
            })
        np.savez_compressed(path, **arrays)


def map_grids_from_arrays(distance: np.ndarray, distance_origin: np.ndarray,
                          distance_cell: float,
                          direction: Optional[np.ndarray] = None,
                          direction_origin: Optional[np.ndarray] = None,
                          direction_cell: Optional[float] = None,
                          *, device) -> MapGrids:
    """MapGrids from the cache's arrays: the (H, W, 1) distance field in
    meters and the packed (H, W, 1) int32 direction field."""
    dev = torch.device(device)
    as_origin = lambda o: torch.as_tensor(np.asarray(o, np.float32), device=dev)
    distance = np.asarray(distance, np.float32)
    quad = Grid2D(
        data=torch.as_tensor(pack_bilinear_quad(distance), device=dev),
        origin=as_origin(distance_origin), cell_size=float(distance_cell))
    dist = Grid2D(data=torch.as_tensor(distance, device=dev),
                  origin=as_origin(distance_origin), cell_size=float(distance_cell))
    dirs = None
    if direction is not None:
        dirs = Grid2D(
            data=torch.as_tensor(np.asarray(direction, np.int32), device=dev),
            origin=as_origin(direction_origin), cell_size=float(direction_cell))
    return MapGrids(distance_quad=quad, direction=dirs, distance=dist)


def load_map_grids(path: str, *, device) -> MapGrids:
    """Read a ``*_tpu_grids_v2.npz`` cache."""
    with np.load(path) as data:
        kw = dict(distance=data['distance'].astype(np.float32),
                  distance_origin=data['distance_origin'],
                  distance_cell=float(data['distance_cell']))
        if 'direction' in data:
            kw.update(direction=data['direction'],
                      direction_origin=data['direction_origin'],
                      direction_cell=float(data['direction_cell']))
    return map_grids_from_arrays(device=device, **kw)


def sample_offroad_distance(grids: MapGrids, points: torch.Tensor) -> torch.Tensor:
    """Distance (meters) from world points (..., 2) to the road surface;
    out-of-bounds points read as far away (100 m)."""
    return bilinear_sample_quad(grids.distance_quad, points, fill_value=100.0)


def sample_lane_directions(grids: MapGrids, points: torch.Tensor):
    """
    Candidate lane directions at world points.

    Returns:
        (cos (..., K), sin (..., K), valid (..., K) bool).
    """
    if grids.direction is None:
        shape = points.shape[:-1] + (DIRECTION_LAYERS,)
        z = points.new_zeros(shape)
        return z, z, torch.zeros(shape, dtype=torch.bool, device=points.device)
    packed = nearest_sample(grids.direction, points, fill_value=_ALL_INVALID)
    shifts = torch.arange(DIRECTION_LAYERS, dtype=torch.int32,
                          device=points.device) * 8
    q = (packed[..., None] >> shifts) & 0xFF
    valid = q != DIRECTION_INVALID
    angle = q.to(torch.float32) / 254.0 * (2 * math.pi) - math.pi
    return torch.cos(angle), torch.sin(angle), valid


def wrong_way_loss_from_grid(grids: MapGrids, agent_states: torch.Tensor,
                             angle_threshold: float = math.pi / 2) -> torch.Tensor:
    """
    Wrong-way loss per agent: ``-cos(delta)`` against the best-matching
    candidate lane direction, zero within ``angle_threshold`` or when no
    lanelet contains the agent.

    Args:
        agent_states: (..., >=3) with (x, y, psi, ...).
    Returns:
        (...) losses in [0, 1].
    """
    cos_l, sin_l, valid = sample_lane_directions(grids, agent_states[..., :2])
    psi = agent_states[..., 2:3]
    cos_delta = cos_l * torch.cos(psi) + sin_l * torch.sin(psi)
    cos_delta = torch.clamp(cos_delta, -1.0, 1.0)
    delta = torch.arccos(cos_delta)
    loss = -cos_delta * (delta > angle_threshold).to(cos_delta.dtype)
    loss = torch.where(valid, loss, torch.full_like(loss, math.inf))
    best = loss.amin(dim=-1)
    return torch.where(torch.isfinite(best), best, torch.zeros_like(best))


def offroad_loss_from_grid(grids: MapGrids, agent_states: torch.Tensor,
                           lenwid: torch.Tensor, threshold: float = 0.0
                           ) -> torch.Tensor:
    """
    Offroad loss per agent: sum over the 4 box corners of the thresholded
    squared distance to the road.

    Args:
        agent_states: (..., A, >=3); lenwid: (..., A, 2).
    Returns:
        (..., A) losses.
    """
    boxes = torch.cat([agent_states[..., :2], lenwid, agent_states[..., 2:3]],
                      dim=-1)
    d = sample_offroad_distance(grids, box2corners(boxes))   # (..., A, 4)
    d2 = d * d
    d2 = torch.where(d2 > threshold, d2, torch.zeros_like(d2))
    return d2.sum(dim=-1)


# --- baking (offline, once per map) -------------------------------------------

def bake_map_grids(cfg: "MapConfig", cell_size: float = 0.4, margin: float = 15.0,
                   tolerance: float = 1.0, *, device='cuda') -> Optional[MapGrids]:
    """
    Bake both fields for a map, as the reference does: the distance field
    over the road mesh's 'road' faces (all faces when untagged) on
    ``device``, the direction field from the Lanelet2 map (skipped without
    one). None without a road mesh.
    """
    mesh = cfg.road_mesh
    if mesh is None:
        return None
    try:
        road = mesh.separate_by_category().get('road', mesh) \
            if hasattr(mesh, 'separate_by_category') else mesh
    except Exception:
        road = mesh
    distance = _bake_distance(_host(road.verts)[0], _host(road.faces)[0], cell_size, margin,
                              device=device)
    direction = None
    lanelet_map = cfg.lanelet_map
    if lanelet_map is not None:
        direction = _bake_direction(lanelet_map, distance, cell_size, tolerance)
    kw = {}
    if direction is not None:
        kw = dict(direction=direction.data, direction_origin=direction.origin,
                  direction_cell=direction.cell_size)
    return map_grids_from_arrays(_host(distance.data), _host(distance.origin),
                                 distance.cell_size, device=device, **kw)


def _bake_distance(verts: np.ndarray, faces: np.ndarray, cell_size: float,
                   margin: float, *, device='cuda') -> Grid2D:
    from torchdrivesim_tpu_torch.ops.grids import bake_distance_field
    return bake_distance_field(verts, faces, cell_size=cell_size, margin=margin,
                               device=device)


def _bake_direction(lanelet_map, distance: Grid2D, cell_size: float,
                    tolerance: float) -> Grid2D:
    """
    Rasterize each lanelet's footprint (dilated by ``tolerance``) and write
    its centerline direction into the first free layer of every covered
    cell, on the host: the native baker, else the reference's numpy loop.

    Returns:
        Grid2D of (H, W, 1) int32 packed directions (host numpy) on
        ``distance``'s cells.
    """
    origin = _host(distance.origin).astype(np.float64)
    h, w = distance.data.shape[0], distance.data.shape[1]
    k = DIRECTION_LAYERS
    from torchdrivesim_tpu_torch.native import bake_direction_native
    packed_native = bake_direction_native(lanelet_map, origin, cell_size, h, w,
                                          tolerance, k)
    if packed_native is not None:
        DIRECTION_BAKES['native'] += 1
        return Grid2D(data=packed_native[..., None],
                      origin=np.asarray(origin, dtype=np.float32),
                      cell_size=float(cell_size))
    DIRECTION_BAKES['python'] += 1
    cos_arr = np.zeros((h, w, k), dtype=np.float32)
    sin_arr = np.zeros((h, w, k), dtype=np.float32)
    valid = np.zeros((h, w, k), dtype=np.float32)
    count = np.zeros((h, w), dtype=np.int32)
    for ll in lanelet_map.laneletLayer:
        poly = ll.polygon()
        lo = np.floor((poly.min(axis=0) - origin - tolerance) / cell_size).astype(int)
        hi = np.ceil((poly.max(axis=0) - origin + tolerance) / cell_size).astype(int) + 1
        x0, y0 = max(lo[0], 0), max(lo[1], 0)
        x1, y1 = min(hi[0], w), min(hi[1], h)
        if x0 >= x1 or y0 >= y1:
            continue
        xs = origin[0] + np.arange(x0, x1) * cell_size
        ys = origin[1] + np.arange(y0, y1) * cell_size
        gx, gy = np.meshgrid(xs, ys)
        cells = np.stack([gx, gy], axis=-1).reshape(-1, 2)
        covered = _points_near_polygon(cells, poly, tolerance)
        if not covered.any():
            continue
        dirs = _polyline_directions_at(ll.centerline.coords(), cells[covered])
        iy, ix = np.nonzero(covered.reshape(y1 - y0, x1 - x0))
        iy, ix = iy + y0, ix + x0
        slot = count[iy, ix]
        ok = slot < k
        iy, ix, slot, dirs = iy[ok], ix[ok], slot[ok], dirs[ok]
        cos_arr[iy, ix, slot] = np.cos(dirs)
        sin_arr[iy, ix, slot] = np.sin(dirs)
        valid[iy, ix, slot] = 1.0
        count[iy, ix] += 1
    # the K layers packed into one int32 per cell (byte k = layer k)
    angles = np.arctan2(sin_arr, cos_arr)
    q = np.round((angles + np.pi) / (2 * np.pi) * 254.0).astype(np.int64)
    q = np.clip(q, 0, 254)
    q = np.where(valid > 0.5, q, DIRECTION_INVALID)
    packed = np.zeros(q.shape[:2], dtype=np.int64)
    for layer in range(k):
        packed |= q[..., layer] << (8 * layer)
    return Grid2D(data=packed.astype(np.int32)[..., None],
                  origin=np.asarray(origin, dtype=np.float32), cell_size=float(cell_size))


def _points_near_polygon(points: np.ndarray, poly: np.ndarray, tolerance: float,
                         chunk: int = 2048) -> np.ndarray:
    """Inside the polygon (even-odd) or within ``tolerance`` of its
    boundary, in float64, over chunks of ``chunk`` points: the (points x
    edges) temporaries of a long rural lanelet unchunked reach gigabytes."""
    if len(points) > chunk:
        return np.concatenate([
            _points_near_polygon(points[s:s + chunk], poly, tolerance, chunk)
            for s in range(0, len(points), chunk)])
    points = np.asarray(points, np.float64)
    x = points[:, 0][:, None]
    y = points[:, 1][:, None]
    x1 = poly[:, 0][None]
    y1 = poly[:, 1][None]
    x2 = np.roll(poly[:, 0], -1)[None]
    y2 = np.roll(poly[:, 1], -1)[None]
    cond = (y1 > y) != (y2 > y)
    with np.errstate(divide='ignore', invalid='ignore'):
        x_cross = (x2 - x1) * (y - y1) / (y2 - y1) + x1
    inside = np.sum(cond & (x < x_cross), axis=1) % 2 == 1
    a = np.stack([x1, y1], axis=-1)
    b = np.stack([x2, y2], axis=-1)
    ab = b - a
    l2 = np.sum(ab * ab, axis=-1)
    p = points[:, None, :]
    t = np.clip(np.sum((p - a) * ab, axis=-1) / np.maximum(l2, 1e-12), 0, 1)
    proj = a + t[..., None] * ab
    d = np.min(np.linalg.norm(p - proj, axis=-1), axis=1)
    return inside | (d <= tolerance)


def _polyline_directions_at(polyline: np.ndarray, points: np.ndarray,
                            chunk: int = 2048) -> np.ndarray:
    """Direction of the polyline segment nearest each query point (the
    first on ties), over chunks of ``chunk`` points."""
    if len(points) > chunk:
        return np.concatenate([
            _polyline_directions_at(polyline, points[s:s + chunk], chunk)
            for s in range(0, len(points), chunk)])
    a = polyline[:-1][None]
    b = polyline[1:][None]
    ab = b - a
    l2 = np.sum(ab * ab, axis=-1)
    p = points[:, None, :]
    t = np.clip(np.sum((p - a) * ab, axis=-1) / np.maximum(l2, 1e-12), 0, 1)
    proj = a + t[..., None] * ab
    seg = np.argmin(np.linalg.norm(p - proj, axis=-1), axis=1)
    d = polyline[seg + 1] - polyline[seg]
    return np.arctan2(d[:, 1], d[:, 0])
