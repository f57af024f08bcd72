"""
Infraction metrics (counterpart of ``torchdrivesim_tpu/infractions.py``):
offroad by the exact point-to-mesh distance, wrong-way by host lanelet
queries, and the per-agent collision metrics (discs, IoU, and the exact
non-differentiable counts) in batched ops, and the reference-shaped
helpers ``point_mesh_face_distance``, ``point_to_mesh_distance_pt`` and
``get_all_intersections``. The grid paths of offroad and wrong-way are in
``map_grids``.
"""
from typing import List, Optional

import numpy as np
import torch

from torchdrivesim_tpu_torch.mesh import BaseMesh
from torchdrivesim_tpu_torch.ops.box import (
    box2corners, iou_differentiable as _iou_pairwise, iou_non_differentiable,
    oriented_box_intersection_area,
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


def point_mesh_face_distance(mesh: BaseMesh, points: torch.Tensor,
                             reduction: str = 'sum', weighted: bool = False,
                             threshold: float = 0.0) -> torch.Tensor:
    """
    Squared distance from each point to the closest face of its batch
    element's mesh, reduced over the points.

    Args:
        mesh: B meshes (2D or 3D vertices, host or tensors).
        points: (B, P, 2) or (B, P, 3) points.
        reduction: 'none', 'sum', 'mean', 'min' or 'max'.
        weighted: divide each point's distance by P.
        threshold: distances at most this become 0 (after weighting).
    Returns:
        (B, P) with reduction 'none', else (B, 1).
    """
    batch_size, num_points, dim = points.shape
    if num_points == 0 or mesh.faces_count == 0:
        d2 = points.new_zeros((batch_size, num_points))
    else:
        verts = torch.as_tensor(mesh.verts, dtype=points.dtype,
                                device=points.device)[..., :dim]
        faces = torch.as_tensor(mesh.faces, device=points.device).long()
        faces = faces.expand(verts.shape[0], -1, 3)
        tris = torch.gather(verts[:, :, None, :].expand(-1, -1, 3, -1), 1,
                            faces[..., None].expand(-1, -1, -1, dim))
        if dim == 2:
            d2 = point_to_triangles_distance_sq_chunked(points, tris)
        else:
            d2 = torch.vmap(point_to_mesh_distance_pt, in_dims=(1, None),
                            out_dims=1)(points, tris)[..., 0]
    if weighted:
        d2 = d2 / max(num_points, 1)
    d2 = torch.nan_to_num(d2, nan=0.0)
    d2 = torch.where(d2 > threshold, d2, torch.zeros_like(d2))
    if reduction == 'none':
        return d2
    reducers = {'sum': torch.sum, 'mean': torch.mean, 'min': torch.amin,
                'max': torch.amax}
    if reduction not in reducers:
        raise ValueError(f"unknown reduction: {reduction!r}")
    return reducers[reduction](d2, dim=-1, keepdim=True)


def point_to_mesh_distance_pt(points: torch.Tensor, tris: torch.Tensor,
                              threshold: float = 0.0) -> torch.Tensor:
    """
    3D squared point-to-mesh distance: the squared distance to the face's
    plane where the projection falls inside a face of area at least 5e-3,
    else the least squared distance to an edge; the least over the faces,
    values at most ``threshold`` made 0.

    Args:
        points: (B, 3); tris: (B, F, 3, 3).
    Returns:
        (B, 1) squared distances.
    """
    p = points[:, None, :]
    v0, v1, v2 = tris[..., 0, :], tris[..., 1, :], tris[..., 2, :]
    cross = torch.linalg.cross(v2 - v0, v1 - v0, dim=-1)
    norm_normal = torch.linalg.vector_norm(cross, dim=-1, keepdim=True)
    normal = cross / (norm_normal + 1e-8)
    t = torch.sum((v0 - p) * normal, dim=-1, keepdim=True)
    p_proj = p + t * normal

    def dot(x, y):
        return torch.sum(x * y, dim=-1, keepdim=True)

    e0, e1, q = v1 - v0, v2 - v0, p_proj - v0
    d00, d01, d11 = dot(e0, e0), dot(e0, e1), dot(e1, e1)
    d20, d21 = dot(q, e0), dot(q, e1)
    denom = d00 * d11 - d01 * d01 + 1e-8
    w1 = (d11 * d20 - d01 * d21) / denom
    w2 = (d00 * d21 - d01 * d20) / denom
    w0 = 1.0 - w1 - w2
    inside = ((0.0 <= w0) & (w0 <= 1.0) & (0.0 <= w1) & (w1 <= 1.0)
              & (0.0 <= w2) & (w2 <= 1.0))
    inside = inside & (norm_normal / 2.0 >= 5e-3)

    def edge_d2(a, b):
        ab = b - a
        l2 = dot(ab, ab)
        tt = torch.clamp(dot(ab, p - a) / (l2 + 1e-8), 0.0, 1.0)
        d2 = dot(p - (a + tt * ab), p - (a + tt * ab))
        return torch.where(l2 <= 1e-8, dot(p - b, p - b), d2)

    dist = torch.minimum(torch.minimum(edge_d2(v0, v1), edge_d2(v0, v2)),
                         edge_d2(v1, v2))
    dist = torch.where(inside & (norm_normal > 1e-8), t * t, dist)
    dist = torch.nan_to_num(torch.amin(dist, dim=-2), nan=0.0)
    return torch.where(dist > threshold, dist, torch.zeros_like(dist))


def get_all_intersections(rects, ego_idx: Optional[int] = None) -> np.ndarray:
    """
    0/1 matrix of rotated rectangles that overlap with positive area, on
    the host.

    Args:
        rects: (M, 5) x, y, length, width, yaw.
        ego_idx: only the overlaps with this rectangle.
    Returns:
        (M, M) float64 upper-triangular matrix, or (M - 1,) with ``ego_idx``.
    """
    corners = box2corners(torch.as_tensor(np.asarray(rects, np.float32)))   # (M, 4, 2)
    m = corners.shape[0]
    if ego_idx is None:
        area = oriented_box_intersection_area(
            corners[:, None].expand(m, m, 4, 2), corners[None, :].expand(m, m, 4, 2))
        return np.triu((area > 1e-9).numpy().astype(np.float64), k=1)
    others = torch.cat([corners[:ego_idx], corners[ego_idx + 1:]])
    area = oriented_box_intersection_area(corners[ego_idx].expand_as(others), others)
    return (area > 1e-9).numpy().astype(np.float64)
