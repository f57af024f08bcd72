"""
Per-map baked grids: distance-to-road and lane-direction fields, and the
offroad and wrong-way losses read from them (counterpart of
``torchdrivesim_tpu/map_grids.py``; reading the cache only, baking is not
ported).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from torchdrivesim_tpu_torch.ops.box import box2corners
from torchdrivesim_tpu_torch.ops.grids import (
    Grid2D, bilinear_sample_quad, nearest_sample, pack_bilinear_quad,
)

DIRECTION_LAYERS = 4
#: sentinel byte marking an empty direction layer in the packed grid
DIRECTION_INVALID = 255
#: packed direction value with every layer invalid (int32 bits 0xFFFFFFFF)
_ALL_INVALID = int(np.uint32(sum(DIRECTION_INVALID << (8 * k)
                                 for k in range(DIRECTION_LAYERS))).astype(np.int32))


@dataclass
class MapGrids:
    """Baked fields for one map, on one device."""
    distance_quad: Grid2D         #: (H, W, 2) int32 bfloat16 bilinear quads
    direction: Optional[Grid2D]   #: (H, W, 1) int32: 4 packed 8-bit angles
        # (byte k = layer k; 0..254 quantize [-pi, pi); 255 = invalid)


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
    dist = Grid2D(
        data=torch.as_tensor(pack_bilinear_quad(distance), device=dev),
        origin=as_origin(distance_origin), cell_size=float(distance_cell))
    dirs = None
    if direction is not None:
        dirs = Grid2D(
            data=torch.as_tensor(np.asarray(direction, np.int32), device=dev),
            origin=as_origin(direction_origin), cell_size=float(direction_cell))
    return MapGrids(distance_quad=dist, direction=dirs)


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
