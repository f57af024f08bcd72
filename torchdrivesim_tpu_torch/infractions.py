"""
Infraction metrics (counterpart of ``torchdrivesim_tpu/infractions.py``):
offroad by the exact point-to-mesh distance, wrong-way by host lanelet
queries, and the per-agent collision metrics (discs, IoU, and the exact
non-differentiable counts) in batched ops. The grid paths of offroad and
wrong-way are in ``map_grids``.
"""
from typing import List, Optional

import numpy as np
import torch

from torchdrivesim_tpu_torch.mesh import BaseMesh
from torchdrivesim_tpu_torch.ops.box import (
    box2corners, iou_differentiable as _iou_pairwise, iou_non_differentiable,
)
from torchdrivesim_tpu_torch.ops.collision import collision_matrix_with_discs
from torchdrivesim_tpu_torch.ops.point_mesh import (
    point_to_triangles_distance_sq_chunked,
)
from torchdrivesim_tpu_torch.utils import normalize_angle

LANELET_TAGS_TO_EXCLUDE = ['parking']


def rectangle_vertices(cx, cy, w, h, angle):
    """
    Corners of rotated rectangles from center, size and yaw, each (B, 1);
    returns (B, 4, 2) in the reference's corner order.
    """
    dx, dy = w / 2, h / 2
    c, s = torch.cos(angle), torch.sin(angle)
    dxcos, dxsin, dycos, dysin = dx * c, dx * s, dy * c, dy * s
    center = torch.cat([cx, cy], dim=-1)
    return torch.stack([
        center + torch.cat([-dxcos + dysin, -dxsin - dycos], dim=-1),
        center + torch.cat([dxcos + dysin, dxsin - dycos], dim=-1),
        center + torch.cat([dxcos - dysin, dxsin + dycos], dim=-1),
        center + torch.cat([-dxcos - dysin, -dxsin + dycos], dim=-1),
    ], dim=1)


def offroad_infraction_loss(agent_states: torch.Tensor, lenwid: torch.Tensor,
                            driving_surface_mesh: BaseMesh,
                            threshold: float = 0) -> torch.Tensor:
    """
    Exact offroad loss: per agent, the sum over its 4 box corners of the
    squared distance to the driving-surface mesh, where above ``threshold``.

    Args:
        agent_states: BxAx4 (x, y, psi, v).
        lenwid: BxAx2 or Bx2 agent sizes.
        driving_surface_mesh: a mesh of batch B, or of batch 1 shared by
            every environment (host numpy; its triangles are copied to the
            states' device at each call).
    Returns:
        BxA losses.
    """
    b, a = agent_states.shape[:2]
    faces = np.asarray(driving_surface_mesh.faces)
    if a == 0 or faces.shape[-2] == 0:
        return torch.zeros_like(agent_states[..., 0])
    if lenwid.dim() == 2:
        lenwid = lenwid[:, None].expand(b, a, 2)
    boxes = torch.cat([agent_states[..., :2], lenwid, agent_states[..., 2:3]], dim=-1)
    corners = box2corners(boxes).reshape(b, a * 4, 2)
    verts = np.asarray(driving_surface_mesh.verts)[..., :2]
    tris = np.take_along_axis(verts[:, :, None, :], faces[..., None].astype(np.int64),
                              axis=1)                          # (Bm, F, 3, 2)
    tris = torch.as_tensor(tris, dtype=corners.dtype, device=corners.device)
    d2 = point_to_triangles_distance_sq_chunked(corners, tris)
    d2 = torch.where(d2 > threshold, d2, torch.zeros_like(d2))
    return d2.reshape(b, a, 4).sum(dim=-1)


def lanelet_orientation_loss(lanelet_maps: List, agents_state: torch.Tensor,
                             recenter_offset: Optional[torch.Tensor] = None,
                             direction_angle_threshold: float = np.pi / 2,
                             lanelet_dist_tolerance: float = 1.0) -> torch.Tensor:
    """
    Wrong-way loss by lanelet queries on the host, one agent at a time (the
    reference's semantics; ``map_grids.wrong_way_loss_from_grid`` is the
    device path). Reads the states back from the device.

    Returns:
        BxA float32 losses on the states' device.
    """
    from torchdrivesim_tpu_torch.lanelet2 import LaneletError, find_lanelet_directions
    assert direction_angle_threshold >= np.pi / 2, \
        'direction_angle_threshold smaller than pi / 2 will produce false positives'
    states = agents_state.detach().cpu().numpy()
    offsets = recenter_offset.detach().cpu().numpy() \
        if recenter_offset is not None else None
    batch, agents = states.shape[:2]
    out = np.zeros((batch, agents), dtype=np.float32)
    for b in range(batch):
        lanelet_map = lanelet_maps[b]
        if lanelet_map is None:
            continue
        for a in range(agents):
            x, y, psi = states[b, a, 0], states[b, a, 1], states[b, a, 2]
            if offsets is not None:
                x, y = x + offsets[b, 0], y + offsets[b, 1]
            try:
                directions = find_lanelet_directions(
                    lanelet_map, float(x), float(y),
                    tags_to_exclude=LANELET_TAGS_TO_EXCLUDE,
                    lanelet_dist_tolerance=lanelet_dist_tolerance)
            except LaneletError:
                continue
            if not directions:
                continue
            deltas = normalize_angle(np.asarray(directions) - psi)
            losses = -np.cos(deltas) * (np.abs(deltas) > direction_angle_threshold)
            out[b, a] = losses.min()
    return torch.as_tensor(out, device=agents_state.device)


def iou_differentiable(box1: torch.Tensor, box2: torch.Tensor,
                       fast: bool = True) -> torch.Tensor:
    """Differentiable oriented-box IoU; ``fast`` is accepted and ignored,
    as in the reference."""
    del fast
    return _iou_pairwise(box1, box2)


def _pair_hits(boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, N) bool: the exact IoU in (0, 1], NaN taken as 0."""
    iou = torch.nan_to_num(iou_non_differentiable(boxes), nan=0.0)
    return (iou > 0.0) & (iou <= 1.0)


def compute_agent_collisions_metric(all_rects: torch.Tensor,
                                    collision_masks: torch.Tensor,
                                    present_masks: torch.Tensor) -> torch.Tensor:
    """
    Exact (non-differentiable) collision counts per agent.

    Args:
        all_rects: BxAx5 boxes; collision_masks, present_masks: BxA bool.
    Returns:
        BxA counts.
    """
    a = all_rects.shape[-2]
    eye = torch.eye(a, dtype=torch.bool, device=all_rects.device)
    pair_mask = (present_masks[..., None, :] & present_masks[..., :, None]
                 & collision_masks[..., None] & ~eye)
    counts = (_pair_hits(all_rects) & pair_mask).sum(dim=-1).to(all_rects.dtype)
    return counts * present_masks


def compute_agent_collisions_metric_pytorch3d(all_rects: torch.Tensor,
                                              masks: torch.Tensor) -> torch.Tensor:
    """Collision counts as the reference's pytorch3d metric: pairs with an
    exact IoU above 0, summed over the transposed mask without the
    diagonal."""
    hits = _pair_hits(all_rects).to(all_rects.dtype)
    a = all_rects.shape[-2]
    eye = torch.eye(a, dtype=all_rects.dtype, device=all_rects.device)
    masks_t = (masks[..., None, :].to(all_rects.dtype).expand(hits.shape)
               * (1 - eye)).transpose(-1, -2)
    return (hits * masks_t).sum(dim=-1)


def compute_collision_matrix(all_boxes: torch.Tensor, mask: torch.Tensor,
                             metric: str = 'discs') -> torch.Tensor:
    """
    Per-agent collision values against all other agents in one batched op;
    self-overlap is excluded via the diagonal.

    Args:
        all_boxes: Bx(A+Npc)x5; mask: Bx(A+Npc) presence flags.
        metric: 'discs' or 'iou'.
    Returns:
        Bx(A+Npc) summed collision values per agent.
    """
    boxes = torch.nan_to_num(all_boxes, nan=0.0)
    n = boxes.shape[-2]
    if metric == 'discs':
        overlap = collision_matrix_with_discs(boxes)
    elif metric == 'iou':
        shape = boxes.shape[:-2] + (n, n, 5)
        overlap = _iou_pairwise(boxes[..., :, None, :].expand(shape),
                                boxes[..., None, :, :].expand(shape))
    else:
        raise ValueError(f"Unrecognized collision metric: {metric}")
    overlap = torch.nan_to_num(overlap, nan=0.0)
    eye = torch.eye(n, dtype=torch.bool, device=boxes.device)
    overlap = torch.where(eye, 0.0, overlap)
    overlap = overlap * mask[..., None, :].to(overlap.dtype)
    return overlap.sum(dim=-1)
