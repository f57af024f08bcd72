"""
Oriented-box corners and the all-pairs separating-axis overlap test
(counterpart of ``torchdrivesim_tpu/ops/box.py``; the subset the red-light
check uses).
"""
import torch


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
