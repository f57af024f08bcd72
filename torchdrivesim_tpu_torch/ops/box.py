"""
Oriented-box geometry (counterpart of ``torchdrivesim_tpu/ops/box.py``):
corners, the separating-axis overlap tests, and the differentiable
intersection area and IoU.

The intersection area is the reference's fixed-shape masked shoelace: the
8 corners (masked by mutual containment) and the 16 edge-pair
intersections (masked by their segment parameters) sorted by angle around
their masked centroid, invalid ones last, summed cyclically. Every function
takes any leading batch dimensions.
"""
from typing import Tuple

import torch

EPSILON = 1e-8


def _signed_halves(v: torch.Tensor, signs) -> torch.Tensor:
    """(..., 1) -> (..., 4): ``0.5 * sign * v`` per corner, built on
    ``v``'s device (no host constant copied per call)."""
    return torch.cat([v * (0.5 * s) for s in signs], dim=-1)


def box2corners(box: torch.Tensor) -> torch.Tensor:
    """
    Oriented boxes (x, y, length, width, angle) to 4 corners.

    Args:
        box: (..., 5) boxes.
    Returns:
        (..., 4, 2) corners in the order (+l+w, -l+w, -l-w, +l-w)/2 rotated.
    """
    x, y = box[..., 0:1], box[..., 1:2]
    w, h = box[..., 2:3], box[..., 3:4]
    alpha = box[..., 4:5]
    x4 = _signed_halves(w, (1, -1, -1, 1))
    y4 = _signed_halves(h, (1, 1, -1, -1))
    c, s = torch.cos(alpha), torch.sin(alpha)
    cx = x4 * c - y4 * s + x
    cy = x4 * s + y4 * c + y
    return torch.stack([cx, cy], dim=-1)


def box2corners_with_rear_factor(box: torch.Tensor,
                                 rear_factor: float = 1.0) -> torch.Tensor:
    """Corners of the rear portion of the box up to ``rear_factor`` of its
    length; used for red-light violations."""
    x, y = box[..., 0:1], box[..., 1:2]
    w, h = box[..., 2:3], box[..., 3:4]
    alpha = box[..., 4:5]
    x4 = _signed_halves(w, (1, -1, -1, 1)) * rear_factor
    y4 = _signed_halves(h, (1, 1, -1, -1))
    c, s = torch.cos(alpha), torch.sin(alpha)
    corr_x = (w * (1 - rear_factor)) / 2 * c
    corr_y = (w * (1 - rear_factor)) / 2 * s
    cx = x4 * c - y4 * s + x - corr_x
    cy = x4 * s + y4 * c + y - corr_y
    return torch.stack([cx, cy], dim=-1)


def boxes_overlap_sat_cross(corners1: torch.Tensor,
                            corners2: torch.Tensor) -> torch.Tensor:
    """
    All-pairs positive-area overlap of convex quads by the separating-axis
    theorem: (B, A, 4, 2) x (B, N, 4, 2) -> (B, A, N) bool. Touching edges
    (zero-area contact) count as no overlap.
    """
    c1x, c1y = corners1[..., 0], corners1[..., 1]        # (B, A, 4)
    c2x, c2y = corners2[..., 0], corners2[..., 1]        # (B, N, 4)

    def separated_on(ax, ay, own_x, own_y, other_x, other_y, own_first):
        # ax/ay: (B, M); own corners (B, M, 4); other corners (B, K, 4)
        po = [ax * own_x[..., i] + ay * own_y[..., i] for i in range(4)]
        own_lo = torch.minimum(torch.minimum(po[0], po[1]),
                               torch.minimum(po[2], po[3]))[..., None]
        own_hi = torch.maximum(torch.maximum(po[0], po[1]),
                               torch.maximum(po[2], po[3]))[..., None]
        a2, y2 = ax[..., None], ay[..., None]            # (B, M, 1)
        pt = [a2 * other_x[:, None, :, i] + y2 * other_y[:, None, :, i]
              for i in range(4)]                         # 4 x (B, M, K)
        oth_lo = torch.minimum(torch.minimum(pt[0], pt[1]),
                               torch.minimum(pt[2], pt[3]))
        oth_hi = torch.maximum(torch.maximum(pt[0], pt[1]),
                               torch.maximum(pt[2], pt[3]))
        sep = (own_hi <= oth_lo) | (oth_hi <= own_lo)    # (B, M, K)
        return sep if own_first else sep.transpose(-1, -2)

    sep = None
    for k in range(2):                                   # 2 unique normals
        e_x = c1x[..., k + 1] - c1x[..., k]
        e_y = c1y[..., k + 1] - c1y[..., k]
        s = separated_on(-e_y, e_x, c1x, c1y, c2x, c2y, True)
        sep = s if sep is None else sep | s
    for k in range(2):
        e_x = c2x[..., k + 1] - c2x[..., k]
        e_y = c2y[..., k + 1] - c2y[..., k]
        sep = sep | separated_on(-e_y, e_x, c2x, c2y, c1x, c1y, False)
    return ~sep


def boxes_overlap_sat(corners1: torch.Tensor, corners2: torch.Tensor) -> torch.Tensor:
    """
    Positive-area overlap of convex quads by the separating-axis theorem:
    (..., 4, 2) x (..., 4, 2) -> (...) bool; touching edges count as no
    overlap (intersection area 0).
    """
    def axes(corners):
        e = corners[..., [1, 2], :] - corners[..., [0, 1], :]
        return torch.stack([-e[..., 1], e[..., 0]], dim=-1)   # (..., 2, 2)

    def separated_along(axis_set, c1, c2):
        p1 = (axis_set[..., :, None, :] * c1[..., None, :, :]).sum(dim=-1)
        p2 = (axis_set[..., :, None, :] * c2[..., None, :, :]).sum(dim=-1)
        min1, max1 = p1.amin(dim=-1), p1.amax(dim=-1)
        min2, max2 = p2.amin(dim=-1), p2.amax(dim=-1)
        return ((max1 <= min2) | (max2 <= min1)).any(dim=-1)

    sep = separated_along(axes(corners1), corners1, corners2) \
        | separated_along(axes(corners2), corners1, corners2)
    return ~sep


def _box_edge_intersections(corners1: torch.Tensor, corners2: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Intersection points of every edge pair of two quads: edge i of a quad
    runs from corner i to corner i + 1 mod 4.

    Returns:
        (points (..., 4, 4, 2), zero where masked off; mask (..., 4, 4)).
    """
    nxt = [1, 2, 3, 0]
    e1s, e1e = corners1, corners1[..., nxt, :]
    e2s, e2e = corners2, corners2[..., nxt, :]
    x1, y1 = e1s[..., :, None, 0], e1s[..., :, None, 1]
    x2, y2 = e1e[..., :, None, 0], e1e[..., :, None, 1]
    x3, y3 = e2s[..., None, :, 0], e2s[..., None, :, 1]
    x4, y4 = e2e[..., None, :, 0], e2e[..., None, :, 1]
    num = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    den_t = (x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)
    parallel = torch.abs(num) < 1e-4
    safe = torch.where(parallel, torch.ones_like(num), num)
    t_mask = torch.where(parallel, -torch.ones_like(num), den_t / safe)
    den_u = (x1 - x2) * (y1 - y3) - (y1 - y2) * (x1 - x3)
    u_mask = torch.where(parallel, -torch.ones_like(num), -den_u / safe)
    mask = (t_mask > 0) & (t_mask < 1) & (u_mask > 0) & (u_mask < 1)
    t = den_t / (num + EPSILON)
    inter = torch.stack([x1 + t * (x2 - x1), y1 + t * (y2 - y1)], dim=-1)
    return inter * mask[..., None].to(inter.dtype), mask


def _corners_in_box(corners1: torch.Tensor, corners2: torch.Tensor,
                    tol: float = 1e-5) -> torch.Tensor:
    """(..., 4) which corners of box 1 lie inside box 2, within ``tol`` of
    the edge length (float32 corners at world scale carry noise above the
    reference upstream's 1e-6)."""
    a = corners2[..., 0:1, :]
    ab = corners2[..., 1:2, :] - a
    ad = corners2[..., 3:4, :] - a
    am = corners1 - a
    cond1 = (ab * am).sum(dim=-1) / (ab * ab).sum(dim=-1)
    cond2 = (ad * am).sum(dim=-1) / (ad * ad).sum(dim=-1)
    return ((cond1 > -tol) & (cond1 < 1 + tol)
            & (cond2 > -tol) & (cond2 < 1 + tol))


def oriented_box_intersection_area(corners1: torch.Tensor,
                                   corners2: torch.Tensor) -> torch.Tensor:
    """
    Differentiable intersection area of two oriented quads (..., 4, 2):
    the masked shoelace over the 24 candidate vertices (module docstring).

    Returns:
        (...) areas; 0 where fewer than 3 vertices are valid.
    """
    # recenter on the joint corner mean first: the area does not move, and
    # the containment tests keep their float32 precision at map scale
    center = ((corners1.mean(dim=-2, keepdim=True)
               + corners2.mean(dim=-2, keepdim=True)) / 2).detach()
    corners1 = corners1 - center
    corners2 = corners2 - center
    inter, mask_inter = _box_edge_intersections(corners1, corners2)
    batch = corners1.shape[:-2]
    verts = torch.cat([corners1, corners2, inter.reshape(batch + (16, 2))], dim=-2)
    mask = torch.cat([_corners_in_box(corners1, corners2),
                      _corners_in_box(corners2, corners1),
                      mask_inter.reshape(batch + (16,))], dim=-1)   # (..., 24)

    maskf = mask.to(verts.dtype)
    num_valid = maskf.sum(dim=-1, keepdim=True)
    mid = (verts * maskf[..., None]).sum(dim=-2, keepdim=True) \
        / torch.clamp(num_valid, min=1.0)[..., None]
    dx = torch.where(mask, verts[..., 0] - mid[..., 0], torch.ones_like(maskf))
    dy = torch.where(mask, verts[..., 1] - mid[..., 1], torch.zeros_like(maskf))
    angles = torch.where(mask, torch.atan2(dy, dx),
                         torch.full_like(maskf, float('inf')))
    order = torch.sort(angles, dim=-1, stable=True).indices   # valid first
    sorted_verts = torch.gather(verts, -2, order[..., None].expand(verts.shape))
    sorted_mask = torch.gather(mask, -1, order)

    # cyclic shoelace: the next vertex of entry i is entry i + 1 if valid,
    # else the first
    next_verts = torch.roll(sorted_verts, -1, dims=-2)
    next_mask = torch.roll(sorted_mask, -1, dims=-1)
    next_verts = torch.where(next_mask[..., None], next_verts,
                             sorted_verts[..., 0:1, :])
    cross = (sorted_verts[..., 0] * next_verts[..., 1]
             - sorted_verts[..., 1] * next_verts[..., 0])
    cross = cross * sorted_mask.to(cross.dtype)
    area = torch.abs(cross.sum(dim=-1)) / 2
    return torch.where(num_valid[..., 0] >= 3, area, torch.zeros_like(area))


def iou_differentiable(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """
    Differentiable IoU of oriented boxes (..., 5) (x, y, length, width,
    angle); 0/0 (NaN) for two zero-size boxes, as the reference.
    """
    # shift both boxes by their mean center before taking corners: corners
    # at x ~ 400 m carry float32 noise that no later recentering removes
    center = ((box1[..., :2] + box2[..., :2]) / 2).detach()
    shift = torch.cat([center, torch.zeros_like(box1[..., 2:])], dim=-1)
    inter = oriented_box_intersection_area(box2corners(box1 - shift),
                                           box2corners(box2 - shift))
    union = box1[..., 2] * box1[..., 3] + box2[..., 2] * box2[..., 3] - inter
    return inter / union


def iou_non_differentiable(boxes: torch.Tensor) -> torch.Tensor:
    """The (..., N, N) IoU matrix of (..., N, 5) boxes, without gradient."""
    n = boxes.shape[-2]
    shape = boxes.shape[:-2] + (n, n, 5)
    with torch.no_grad():
        return iou_differentiable(boxes[..., :, None, :].expand(shape),
                                  boxes[..., None, :, :].expand(shape))
