"""
The reference-shaped oriented-box IoU surface (counterpart of
``torchdrivesim_tpu/iou_utils.py``): the functions of the upstream
``_iou_utils.py`` by name, shape and return convention, in plain PyTorch.
``ops/box.py`` holds the pipeline the port itself uses.

``sort_indices`` drops near-coincident vertices as the upstream loop does,
one per round, in a fixed 16 rounds (24 candidates, at most 8 distinct).
"""
from typing import Tuple

import numpy as np
import torch

from torchdrivesim_tpu_torch.ops.box import (  # noqa: F401  (re-exported)
    box2corners, box2corners_with_rear_factor, iou_non_differentiable,
)

EPSILON = 1e-8


def precision_rounding(x: torch.Tensor, n_digits: int = 6) -> torch.Tensor:
    """Round to ``n_digits`` decimals (half to even)."""
    scale = 10.0 ** n_digits
    return torch.round(x * scale) / scale


def box2corners_th(box: torch.Tensor) -> torch.Tensor:
    """(B, N, 5) x, y, w, h, alpha -> (B, N, 4, 2) corners."""
    return box2corners(box)


def box_intersection_th(corners1: torch.Tensor, corners2: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Edge-edge intersection points of two rectangles; (near-)parallel edges
    have none.

    Args:
        corners1, corners2: (B, N, 4, 2).
    Returns:
        (intersections (B, N, 4, 4, 2) zero where masked out, mask
        (B, N, 4, 4) bool).
    """
    nxt = [1, 2, 3, 0]
    line1 = torch.cat([corners1, corners1[:, :, nxt, :]], dim=3)
    line2 = torch.cat([corners2, corners2[:, :, nxt, :]], dim=3)
    l1 = line1[:, :, :, None, :]
    l2 = line2[:, :, None, :, :]
    x1, y1, x2, y2 = l1[..., 0], l1[..., 1], l1[..., 2], l1[..., 3]
    x3, y3, x4, y4 = l2[..., 0], l2[..., 1], l2[..., 2], l2[..., 3]
    num = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    near_parallel = torch.abs(num) < 1e-4
    safe = torch.where(near_parallel, torch.ones_like(num), num)
    minus_one = torch.full_like(num, -1.0)
    den_t = (x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)
    t_mask = torch.where(near_parallel, minus_one, den_t / safe)
    den_u = (x1 - x2) * (y1 - y3) - (y1 - y2) * (x1 - x3)
    u = torch.where(near_parallel, minus_one, -den_u / safe)
    mask = (t_mask > 0) & (t_mask < 1) & (u > 0) & (u < 1)
    t = den_t / (num + EPSILON)
    inter = torch.stack([x1 + t * (x2 - x1), y1 + t * (y2 - y1)], dim=-1)
    return inter * mask[..., None].to(inter.dtype), mask


def box1_in_box2(corners1: torch.Tensor, corners2: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) whether each corner of box 1 lies in box 2 (on an edge
    counts as inside)."""
    a = corners2[:, :, 0:1, :]
    b = corners2[:, :, 1:2, :]
    d = corners2[:, :, 3:4, :]
    ab, am, ad = b - a, corners1 - a, d - a
    p_ab = torch.sum(ab * am, dim=-1)
    norm_ab = torch.sum(ab * ab, dim=-1)
    p_ad = torch.sum(ad * am, dim=-1)
    norm_ad = torch.sum(ad * ad, dim=-1)
    cond1 = precision_rounding(p_ab / norm_ab)
    cond2 = precision_rounding(p_ad / norm_ad)
    return ((cond1 > -1e-6) & (cond1 < 1 + 1e-6)
            & (cond2 > -1e-6) & (cond2 < 1 + 1e-6))


def box_in_box_th(corners1: torch.Tensor, corners2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each box's corners in the other."""
    return box1_in_box2(corners1, corners2), box1_in_box2(corners2, corners1)


def build_vertices(corners1: torch.Tensor, corners2: torch.Tensor,
                   c1_in_2: torch.Tensor, c2_in_1: torch.Tensor,
                   inters: torch.Tensor, mask_inter: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 24 candidate vertices of the intersection polygon (4 + 4
    corners, 16 edge intersections): ((B, N, 24, 2), (B, N, 24) bool)."""
    b, n = corners1.shape[:2]
    vertices = torch.cat([corners1, corners2, inters.reshape(b, n, -1, 2)], dim=2)
    mask = torch.cat([c1_in_2, c2_in_1, mask_inter.reshape(b, n, -1)], dim=2)
    return vertices, mask


def _remove_one_duplicate(vertices, angles, mask):
    """One dedup round: in rows with more than 8 valid vertices, drop the
    vertex whose successor by angle is nearest."""
    num_valid = mask.sum(dim=1)
    order = torch.argsort(torch.where(mask, angles, torch.full_like(angles, np.inf)),
                          dim=1, stable=True)
    ordered = torch.gather(vertices, 1, order[..., None].expand(-1, -1, 2))
    dist = torch.linalg.vector_norm(ordered[:, :-1] - ordered[:, 1:], dim=-1)
    pos = torch.arange(dist.shape[1], device=dist.device)[None, :]
    dist = torch.where(pos >= (num_valid - 1)[:, None], torch.full_like(dist, np.inf), dist)
    j = torch.gather(order, 1, dist.argmin(dim=-1)[:, None])[:, 0]
    drop = (torch.arange(mask.shape[1], device=mask.device)[None, :] == j[:, None]) \
        & (num_valid > 8)[:, None]
    return mask & ~drop


def sort_indices(vertices: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """
    Counter-clockwise order of the valid candidates as 9 indices into the
    24: the first repeated after the last valid one, the rest pointing at
    the first invalid intersection slot (a zero vertex).

    Args: vertices (B, N, 24, 2), mask (B, N, 24) bool.
    Returns: (B, N, 9) int32.
    """
    b, n = vertices.shape[:2]
    verts = vertices.reshape(-1, 24, 2)
    msk = mask.reshape(-1, 24)
    num_valid0 = msk.sum(dim=1)
    center = (torch.sum(verts * msk[..., None], dim=1, keepdim=True)
              / num_valid0[:, None, None])
    rel = verts - center
    r = torch.sqrt(torch.sum(rel ** 2, dim=-1))
    cosang = torch.arccos(torch.clamp(rel[..., 0] / r, -1.0, 1.0))
    angles = torch.where(rel[..., 1] > 0, cosang, 2 * np.pi - cosang)
    for _ in range(16):
        msk = _remove_one_duplicate(verts, angles, msk)
    num_valid = msk.sum(dim=1)[:, None]
    index = torch.argsort(torch.where(msk, angles, torch.full_like(angles, np.inf)),
                          dim=1, stable=True)[:, :9]
    pad = (torch.argmin(msk[:, 8:].to(torch.float32), dim=-1) + 8)[:, None].expand(-1, 9)
    pos = torch.arange(9, device=index.device)[None, :]
    index = torch.where(num_valid < 3, pad, index)
    index = torch.where((pos >= num_valid) & (num_valid >= 3), pad, index)
    close_ring = (pos == num_valid) & (num_valid >= 3)
    index = torch.where(close_ring, index[:, :1].expand(-1, 9), index)
    return index.reshape(b, n, 9).to(torch.int32)


def calculate_area(idx_sorted: torch.Tensor, vertices: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shoelace area over the selected ring: ((B, N), (B, N, 9, 2))."""
    selected = torch.gather(vertices, 2, idx_sorted.long()[..., None].expand(-1, -1, -1, 2))
    total = (selected[:, :, :-1, 0] * selected[:, :, 1:, 1]
             - selected[:, :, :-1, 1] * selected[:, :, 1:, 0])
    return torch.abs(torch.sum(total, dim=2)) / 2, selected


def oriented_box_intersection_2d(corners1: torch.Tensor, corners2: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intersection area of rectangles (B, N, 4, 2) and the polygon's
    vertices: ((B, N), (B, N, 9, 2))."""
    inters, mask_inter = box_intersection_th(corners1, corners2)
    c12, c21 = box_in_box_th(corners1, corners2)
    vertices, mask = build_vertices(corners1, corners2, c12, c21, inters, mask_inter)
    return calculate_area(sort_indices(vertices, mask), vertices)


def iou_differentiable_fast(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Differentiable IoU of (B, N, 5) x, y, w, h, alpha boxes."""
    inter_area, _ = oriented_box_intersection_2d(box2corners_th(box1),
                                                 box2corners_th(box2))
    area1 = box1[:, :, 2] * box1[:, :, 3]
    area2 = box2[:, :, 2] * box2[:, :, 3]
    return inter_area / (area1 + area2 - inter_area)
