"""
Disc-based collision values: boxes as discs and the all-pairs collision
matrix (counterpart of ``torchdrivesim_tpu/ops/collision.py``).
"""
from typing import Tuple

import numpy as np
import torch


def bbox2discs(box: torch.Tensor, num_discs: int = 5
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Oriented boxes as ``num_discs`` equally spaced discs of radius
    min(length, width)/2.

    Args:
        box: (..., 5) boxes (x, y, length, width, angle).
    Returns:
        (centers (..., num_discs, 2), radius (..., 1)).
    """
    assert isinstance(num_discs, int) and num_discs > 1 and num_discs % 2 != 0
    half = (num_discs - 1) // 2
    xy = box[..., 0:2]
    length = box[..., 2:3]
    width = box[..., 3:4]
    yaw = box[..., 4:5]
    r = torch.minimum(length, width) / 2
    span = torch.maximum(length, width) / 2 - r
    disc_x = torch.cat([span * (i / half) for i in range(-half, half + 1)],
                       dim=-1)
    # if the box is wider than long, the major axis is rotated by pi/2
    yaw_eff = yaw + (np.pi / 2) * (width > length).to(box.dtype)
    c = torch.cos(yaw_eff)
    s = torch.sin(yaw_eff)
    cx = disc_x * c + xy[..., 0:1]
    cy = disc_x * s + xy[..., 1:2]
    return torch.stack([cx, cy], dim=-1), r


def collision_detection_with_discs(box1: torch.Tensor, box2: torch.Tensor,
                                   num_discs: int = 5) -> torch.Tensor:
    """
    Collision loss between corresponding boxes (..., 5): ``relu(1 - d /
    (r1 + r2))``, with d the minimum distance between their disc centers.

    Returns:
        (...) values in [0, 1].
    """
    c1, r1 = bbox2discs(box1, num_discs)
    c2, r2 = bbox2discs(box2, num_discs)
    diff = c1[..., :, None, :] - c2[..., None, :, :]             # (..., D, D, 2)
    d2 = (diff * diff).sum(dim=-1)
    d = torch.sqrt(d2.reshape(d2.shape[:-2] + (num_discs * num_discs,)).amin(dim=-1)
                   + 1e-12)
    return torch.clamp(1.0 - d / (r1[..., 0] + r2[..., 0]), min=0.0)


def collision_matrix_with_discs(boxes: torch.Tensor,
                                num_discs: int = 5) -> torch.Tensor:
    """
    All-pairs disc collision values ``relu(1 - d / (r_i + r_j))``, with d
    the minimum distance between the two agents' disc centers.

    Args:
        boxes: (..., A, 5).
    Returns:
        (..., A, A) symmetric matrix (diagonal = 1, the self-overlap).
    """
    centers, r = bbox2discs(boxes, num_discs)  # (..., A, D, 2), (..., A, 1)
    batch = boxes.shape[:-2]
    a = boxes.shape[-2]
    flat = centers.reshape(batch + (a * num_discs, 2))
    fx, fy = flat[..., 0], flat[..., 1]
    dx = fx[..., :, None] - fx[..., None, :]
    dy = fy[..., :, None] - fy[..., None, :]
    d2 = dx * dx + dy * dy
    d2 = d2.reshape(batch + (a, num_discs, a, num_discs))
    d2 = d2.amin(dim=-1).amin(dim=-2)             # (..., A, A)
    d = torch.sqrt(torch.clamp(d2, min=0.0) + 1e-12)
    rsum = r[..., :, 0:1] + r[..., None, :, 0]
    return torch.clamp(1.0 - d / rsum, min=0.0)
