"""The per-agent metrics of a step, plainly: disc collision values, the
offroad loss over the distance field, the wrong-way loss over the lane
direction field, and red-light violations."""
import math

import numpy as np
import torch

OFFROAD_THRESHOLD = 0.5
OFFROAD_FILL = 100.0
REAR_FACTOR = 0.1
WRONG_WAY_ANGLE = math.pi / 2


def corners(box: torch.Tensor, rear_factor: float = 1.0) -> torch.Tensor:
    """(..., 5) boxes (x, y, length, width, angle) -> (..., 4, 2) corners
    (+l+w, -l+w, -l-w, +l-w)/2 rotated; with ``rear_factor`` the rear part
    of that share of the length."""
    x, y, l, w, a = box.unbind(-1)
    sx = torch.tensor([1.0, -1.0, -1.0, 1.0], device=box.device)
    sy = torch.tensor([1.0, 1.0, -1.0, -1.0], device=box.device)
    lx = l[..., None] / 2 * sx * rear_factor
    wy = w[..., None] / 2 * sy
    shift = (l * (1 - rear_factor) / 2)[..., None]
    c, s = torch.cos(a)[..., None], torch.sin(a)[..., None]
    cx = x[..., None] + lx * c - wy * s - shift * c
    cy = y[..., None] + lx * s + wy * c - shift * s
    return torch.stack([cx, cy], dim=-1)


def collision(boxes: torch.Tensor, present: torch.Tensor, discs: int = 5) -> torch.Tensor:
    """(B, N, 5) boxes -> (B, N): the sum over the other present agents of
    relu(1 - d / (r_i + r_j)), d the least distance between the two boxes'
    disc centres (``discs`` discs of radius min(l, w) / 2 along the long
    axis)."""
    x, y, l, w, a = boxes.unbind(-1)
    r = torch.minimum(l, w) / 2
    span = torch.maximum(l, w) / 2 - r
    half = (discs - 1) // 2
    offs = torch.arange(-half, half + 1, device=boxes.device, dtype=boxes.dtype) / half
    yaw = a + (math.pi / 2) * (w > l).to(boxes.dtype)
    cx = x[..., None] + offs * span[..., None] * torch.cos(yaw)[..., None]
    cy = y[..., None] + offs * span[..., None] * torch.sin(yaw)[..., None]
    dx = cx[:, :, None, :, None] - cx[:, None, :, None, :]
    dy = cy[:, :, None, :, None] - cy[:, None, :, None, :]
    d = torch.sqrt((dx * dx + dy * dy).amin(dim=(-1, -2)) + 1e-12)
    v = torch.clamp(1.0 - d / (r[:, :, None] + r[:, None, :]), min=0.0)
    n = boxes.shape[1]
    v = torch.where(torch.eye(n, dtype=torch.bool, device=boxes.device), 0.0, v)
    return (v * present[:, None, :].to(v.dtype)).sum(-1)


def bilinear(grid: np.ndarray, origin, cell: float, points: torch.Tensor,
             fill: float) -> torch.Tensor:
    """Bilinear sample of an (H, W) float grid at world points (..., 2);
    points whose 2 x 2 cell block leaves the grid read ``fill``."""
    g = torch.as_tensor(grid, dtype=torch.float32, device=points.device)
    u = (points[..., 0] - float(origin[0])) / cell
    v = (points[..., 1] - float(origin[1])) / cell
    x0, y0 = torch.floor(u), torch.floor(v)
    tx, ty = u - x0, v - y0
    h, w = g.shape
    ok = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    xi = x0.clamp(0, w - 2).long()
    yi = y0.clamp(0, h - 2).long()
    top = g[yi, xi] * (1 - tx) + g[yi, xi + 1] * tx
    bot = g[yi + 1, xi] * (1 - tx) + g[yi + 1, xi + 1] * tx
    return torch.where(ok, top * (1 - ty) + bot * ty, torch.full_like(tx, fill))


def offroad(grids, state: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """(B, A): the sum over the box corners of the squared distance to the
    road where it exceeds the threshold."""
    box = torch.cat([state[..., :2], size, state[..., 2:3]], dim=-1)
    d = bilinear(grids['distance'][..., 0].astype(np.float32), grids['distance_origin'],
                 float(grids['distance_cell']), corners(box), OFFROAD_FILL)
    d2 = d * d
    return torch.where(d2 > OFFROAD_THRESHOLD, d2, 0.0).sum(-1)


def wrong_way(grids, state: torch.Tensor) -> torch.Tensor:
    """(B, A): -cos of the angle to the best-matching lane direction of the
    nearest grid cell where that angle exceeds 90 degrees, else 0 (0 where
    the cell has no lane)."""
    g = torch.as_tensor(grids['direction'][..., 0].astype(np.int64), device=state.device)
    cell = float(grids['direction_cell'])
    origin = grids['direction_origin']
    xi = torch.round((state[..., 0] - float(origin[0])) / cell).long()
    yi = torch.round((state[..., 1] - float(origin[1])) / cell).long()
    h, w = g.shape
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    packed = torch.where(ok, g[yi.clamp(0, h - 1), xi.clamp(0, w - 1)], -1)
    q = (packed[..., None] >> (8 * torch.arange(4, device=state.device))) & 0xFF
    valid = q != 255
    angle = q.to(torch.float32) / 254.0 * (2 * math.pi) - math.pi
    cos_d = torch.clamp(torch.cos(angle) * torch.cos(state[..., 2:3])
                        + torch.sin(angle) * torch.sin(state[..., 2:3]), -1.0, 1.0)
    loss = torch.where(torch.arccos(cos_d) > WRONG_WAY_ANGLE, -cos_d, 0.0)
    loss = torch.where(valid, loss, torch.inf).amin(-1)
    return torch.where(torch.isfinite(loss), loss, 0.0)


def _separated(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) x (..., 4, 2) quads: some edge normal of ``p`` separates
    them (touching counts as separated)."""
    out = torch.zeros(p.shape[:-2], dtype=torch.bool, device=p.device)
    for k in range(2):
        e = p[..., k + 1, :] - p[..., k, :]
        axis = torch.stack([-e[..., 1], e[..., 0]], dim=-1)[..., None, :]
        pp = (axis * p).sum(-1)
        qq = (axis * q).sum(-1)
        out |= (pp.amax(-1) <= qq.amin(-1)) | (qq.amax(-1) <= pp.amin(-1))
    return out


def red_light(boxes: torch.Tensor, light_corners: torch.Tensor,
              light_state) -> torch.Tensor:
    """(B, A) agents whose rear tenth overlaps (positive area) the stopline
    of a red light. ``light_corners`` (N, 4, 2); ``light_state`` (N,)."""
    a = corners(boxes, REAR_FACTOR)[:, :, None]                # (B, A, 1, 4, 2)
    l = light_corners[None, None]                             # (1, 1, N, 4, 2)
    a, l = torch.broadcast_tensors(a, l)
    overlap = ~(_separated(a, l) | _separated(l, a))
    red = torch.as_tensor(light_state, device=boxes.device) == 0
    return (overlap & red).any(-1)
