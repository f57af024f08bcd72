"""
Geometric tensor helpers shared by the port (counterpart of
``torchdrivesim_tpu/utils.py``).
"""
import collections

import numpy as np
import torch

Resolution = collections.namedtuple('Resolution', ['width', 'height'])


def host_repeat(x: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
    """Every element along ``dim`` repeated ``n`` times contiguously (the
    batch ``extend`` of every class), on the tensor's own device."""
    return torch.repeat_interleave(x, n, dim=dim)


def as_batch_index(idx, device=None) -> torch.Tensor:
    """A batch selection (int, list, numpy array or tensor) as an int64
    index tensor on ``device``; a scalar keeps its batch dimension."""
    if torch.is_tensor(idx):
        out = idx.to(dtype=torch.int64, device=device)
    else:
        out = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)
    return out.reshape(-1) if out.dim() == 0 else out


def normalize_angle(angle):
    """Normalize angle(s) to the <-pi, pi) range. Works on floats and tensors."""
    return (angle + np.pi) % (2 * np.pi) - np.pi


def rotate(v: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """
    Rotate 2D vectors counterclockwise.

    Args:
        v: (..., 2) points.
        angle: (..., 1) angles in radians, broadcastable against ``v``.
    Returns:
        (..., 2) rotated points.
    """
    c = torch.cos(angle[..., 0])
    s = torch.sin(angle[..., 0])
    x = c * v[..., 0] - s * v[..., 1]
    y = s * v[..., 0] + c * v[..., 1]
    return torch.stack([x, y], dim=-1)


def relative(origin_xy: torch.Tensor, origin_psi: torch.Tensor,
             target_xy: torch.Tensor, target_psi: torch.Tensor):
    """
    Position and orientation of ``target`` in the frame of ``origin``:
    ``*_xy`` are (..., 2), ``*_psi`` (..., 1).

    Returns:
        (rel_xy (..., 2), rel_psi (..., 1)).
    """
    rel_xy = rotate(target_xy - origin_xy, -origin_psi)
    rel_psi = normalize_angle(target_psi - origin_psi)
    return rel_xy, rel_psi


def transform(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """
    Points given relative to a pose, in absolute coordinates.

    Args:
        points: (..., N, 2) relative points.
        pose: (..., 3) pose (x, y, yaw).
    Returns:
        (..., N, 2) absolute points.
    """
    return rotate(points, pose[..., None, 2:3]) + pose[..., None, :2]


def isin(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Whether each element of ``x`` is in the 1-D ``y``."""
    return torch.isin(x, y)


def is_inside_polygon(point: torch.Tensor, polygon: torch.Tensor) -> torch.Tensor:
    """
    Whether points lie inside a convex polygon winding either way (points on
    the boundary count as inside in one of the two orientations).

    Args:
        point: (B..., P..., 2) points (zero or more batch dims, zero or more
            point dims).
        polygon: (B..., N, 2) polygon vertices.
    Returns:
        (B..., P...) bool.
    """
    batch_dims = polygon.dim() - 2
    assert batch_dims >= 0
    assert polygon.shape[:batch_dims] == point.shape[:batch_dims]
    for _ in point.shape[batch_dims:-1]:
        polygon = polygon.unsqueeze(-3)
    start = polygon
    end = torch.roll(polygon, -1, dims=-2)
    a = end[..., 1] - start[..., 1]
    b = start[..., 0] - end[..., 0]
    c = -a * start[..., 0] - b * start[..., 1]
    is_right = a * point[..., None, 0] + b * point[..., None, 1] + c >= 0
    return is_right.all(dim=-1) | (~is_right).all(dim=-1)


def time_slice(arr: torch.Tensor, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Index a (replay) time axis by a scalar tensor, clamped to range."""
    t = torch.clamp(t.long(), 0, arr.shape[dim] - 1).reshape(1)
    return torch.index_select(arr, dim, t).squeeze(dim)


def assert_equal(x, y):
    assert x == y, f"{x} != {y}"


def rotation_matrix(theta: torch.Tensor) -> torch.Tensor:
    """Counterclockwise 2D rotation matrices (..., 2, 2) of angles
    (..., 1) in radians."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.cat([c, -s], dim=-1), torch.cat([s, c], dim=-1)], dim=-2)


def line_circle_intersection(p1: torch.Tensor, p2: torch.Tensor,
                             circle_center: torch.Tensor, radius: torch.Tensor
                             ) -> torch.Tensor:
    """
    Batched segment-circle intersection test: :func:`line_circle_intersection_xy`
    on (..., 2) endpoints and centers and (..., 1) radii.

    Returns:
        (..., 1) bool.
    """
    return line_circle_intersection_xy(
        p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1], circle_center[..., 0],
        circle_center[..., 1], radius[..., 0])[..., None]


def merge_dicts(ds) -> dict:
    """Merge a sequence of dicts; later entries overwrite earlier ones."""
    out = {}
    for d in ds:
        out.update(d)
    return out


def line_circle_intersection_xy(p1x, p1y, p2x, p2y, cx, cy, radius) -> torch.Tensor:
    """
    Whether the segment p1 -> p2 meets the circle of ``radius`` about c,
    on separate x and y planes that broadcast together (no trailing
    coordinate dimension): the quadratic in the segment parameter has a real
    root interval that overlaps [0, 1]. Returns a bool tensor.
    """
    dx, dy = p2x - p1x, p2y - p1y
    fx, fy = p1x - cx, p1y - cy
    a = dx * dx + dy * dy
    b = 2 * (fx * dx + fy * dy)
    c = fx * fx + fy * fy - radius * radius
    discriminant = b * b - 4 * a * c
    has_intersection = discriminant >= 0
    sqrt_disc = torch.sqrt(torch.clamp(discriminant, min=0))
    a_safe = torch.where(torch.abs(a) < 1e-8, torch.full_like(a, 1e-8), a)
    t1 = (-b - sqrt_disc) / (2 * a_safe)
    t2 = (-b + sqrt_disc) / (2 * a_safe)
    t_min = torch.minimum(t1, t2)
    t_max = torch.maximum(t1, t2)
    seg_hit = (t_min <= 1) & (t_max >= 0)
    return has_intersection & seg_hit
