"""
Point-to-triangle-mesh squared distance, the exact op behind the offroad
metric (counterpart of ``torchdrivesim_tpu/ops/point_mesh.py``): 0 inside
a non-degenerate triangle, else the smallest squared distance to its three
edges, minimized over the triangles; in 2D, chunked over the faces so the
(P, F) pair buffer stays bounded on maps of ~17,000-30,000 faces.
"""
import torch

MIN_TRIANGLE_AREA = 5e-3


def _point_segment_distance_sq(p: torch.Tensor, a: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """Squared distance from points to segments, (..., 2) broadcast."""
    ab = b - a
    l2 = (ab * ab).sum(dim=-1)
    t = torch.clamp((ab * (p - a)).sum(dim=-1) / (l2 + 1e-8), 0.0, 1.0)
    d2 = ((p - (a + t[..., None] * ab)) ** 2).sum(dim=-1)
    # a degenerate segment: the distance to its end
    return torch.where(l2 <= 1e-8, ((p - b) ** 2).sum(dim=-1), d2)


def point_to_triangles_distance_sq(points: torch.Tensor,
                                   tris: torch.Tensor) -> torch.Tensor:
    """
    Smallest squared distance from each point to a set of triangles.

    Args:
        points: (..., P, 2); tris: (..., F, 3, 2), batch dims broadcast.
    Returns:
        (..., P), NaN as 0.
    """
    p = points[..., :, None, :]
    v0 = tris[..., None, :, 0, :]
    v1 = tris[..., None, :, 1, :]
    v2 = tris[..., None, :, 2, :]
    # inside by barycentric coordinates
    p0, p1, p2 = v1 - v0, v2 - v0, p - v0
    d00 = (p0 * p0).sum(dim=-1)
    d01 = (p0 * p1).sum(dim=-1)
    d11 = (p1 * p1).sum(dim=-1)
    d20 = (p2 * p0).sum(dim=-1)
    d21 = (p2 * p1).sum(dim=-1)
    denom = d00 * d11 - d01 * d01 + 1e-8
    w1 = (d11 * d20 - d01 * d21) / denom
    w2 = (d00 * d21 - d01 * d20) / denom
    w0 = 1.0 - w1 - w2
    inside = ((0.0 <= w0) & (w0 <= 1.0) & (0.0 <= w1) & (w1 <= 1.0)
              & (0.0 <= w2) & (w2 <= 1.0))
    area = torch.abs(p0[..., 0] * p1[..., 1] - p0[..., 1] * p1[..., 0]) / 2
    inside = inside & (area >= MIN_TRIANGLE_AREA)
    edge = torch.minimum(torch.minimum(_point_segment_distance_sq(p, v0, v1),
                                       _point_segment_distance_sq(p, v0, v2)),
                         _point_segment_distance_sq(p, v1, v2))
    d2 = torch.where(inside, torch.zeros_like(edge), edge).amin(dim=-1)
    return torch.nan_to_num(d2, nan=0.0)


def point_to_triangles_distance_sq_chunked(points: torch.Tensor, tris: torch.Tensor,
                                           chunk: int = 2048) -> torch.Tensor:
    """:func:`point_to_triangles_distance_sq` over chunks of ``chunk``
    faces, the minimum carried across chunks as the reference's scan
    carries it (the last chunk padded with far-away degenerate faces)."""
    f = tris.shape[-3]
    if f <= chunk:
        return point_to_triangles_distance_sq(points, tris)
    pad = (-f) % chunk
    if pad:
        filler = tris.new_full(tris.shape[:-3] + (pad, 3, 2), 1e9)
        tris = torch.cat([tris, filler], dim=-3)
    out = torch.full(points.shape[:-1], float('inf'), dtype=points.dtype,
                     device=points.device)
    for start in range(0, tris.shape[-3], chunk):
        out = torch.minimum(out, point_to_triangles_distance_sq(
            points, tris[..., start:start + chunk, :, :]))
    return out
