"""
Screen-space primitive preparation for the fused render, the row-major
sort and band masks of the banded primitive raster, the view culls of the
hard mesh render and of the differentiable primitive render, the
full-resolution backgrounds (the
nearest sample of views no mip level covers; the bilinear samples of the
differentiable render, ``sample_background`` and ``sample_background_quad``),
the plain softmax-blend soft raster, the painter's blend
``rasterize_soft`` and the map texture baker ``bake_background_texture``
(counterpart of the parts of ``torchdrivesim_tpu/ops/rasterize.py`` and
``ops/pallas_rasterize.py`` that the primitive paths, the hard mesh path,
the differentiable path and the map bake run).

Screen convention: the camera's forward axis points up in the image, its
left axis points left; ``left_handed`` mirrors columns. Pixel (r, c) has its
center at (r + 0.5, c + 0.5).
"""
from typing import Tuple

import numpy as np
import torch

from torchdrivesim_tpu_torch.ops.grids import Grid2D, bilinear_sample
from torchdrivesim_tpu_torch.ops import hard_faces as _hard_faces

DEGENERATE_AREA_EPS = 1e-9
#: pixels per band tile; a band is the unit the occupancy masks cull by
PIXELS_PER_TILE = 4096
#: primitives per occupancy-mask chunk
CHUNK = 8
#: packed-pack sentinel: loses every min, never covers a pixel
SENTINEL = 0x7FFFFFFF
#: float32(1 / 255), the reference's per-channel scale (its compiled
#: ``x / 255.0`` is this product)
_INV255 = 1.0 / 255.0


def band_rows(res: int) -> int:
    """
    Rows per band at resolution ``res``: the largest divisor of ``res``
    whose band (``rows * res`` pixels) fits in :data:`PIXELS_PER_TILE` and is
    a whole number of 128-pixel rows of the reference's layout (any multiple
    of 16 has one).
    """
    best = 0
    for rpb in range(1, res + 1):
        if res % rpb or (rpb * res) % 128:
            continue
        if rpb * res > PIXELS_PER_TILE:
            break
        best = rpb
    if not best:
        raise ValueError(f"no band tiling for res={res}")
    return best


def n_bands_for(res: int) -> int:
    """Bands per camera at ``res``."""
    return res // band_rows(res)


def camera_rows_cols(points_xy: torch.Tensor, cam_xy: torch.Tensor,
                     cam_sc: torch.Tensor, scale: float, res: int,
                     left_handed: bool = False) -> torch.Tensor:
    """
    World points -> continuous pixel coordinates (row, col) for orthographic
    egocentric cameras.

    Args:
        points_xy: (B, N, 2) world points.
        cam_xy: (B, 2); cam_sc: (B, 2) as (sin psi, cos psi).
        scale: 2 / fov.
    Returns:
        (B, N, 2) float (row, col).
    """
    d = points_xy - cam_xy[:, None]
    s = cam_sc[:, None, 0]
    c = cam_sc[:, None, 1]
    forward = c * d[..., 0] + s * d[..., 1]
    left = -s * d[..., 0] + c * d[..., 1]
    half = res / 2.0
    px_per_m = scale * half
    row = half - forward * px_per_m
    col = half + left * px_per_m if left_handed else half - left * px_per_m
    return torch.stack([row, col], dim=-1)


def face_arrays(verts: torch.Tensor, faces: torch.Tensor, attrs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """
    Per-face screen corners, priority z (of the first vertex) and flat color
    (of the first vertex).

    Args:
        verts: (B, V, 3) screen-space (row, col, z); faces: (B, F, 3) int;
        attrs: (B, V, 3).
    Returns:
        (corners (B, F, 3, 2), z (B, F), color (B, F, 3)).
    """
    b, n_faces = faces.shape[0], faces.shape[1]
    idx = faces.long().reshape(b, n_faces * 3, 1)
    tri = torch.gather(verts, 1, idx.expand(b, n_faces * 3, verts.shape[-1])
                       ).reshape(b, n_faces, 3, verts.shape[-1])
    color = torch.gather(attrs, 1, faces[..., 0].long()[..., None].expand(
        b, n_faces, attrs.shape[-1]))
    return tri[..., :2], tri[..., 0, 2], color


def cull_faces_to_view(corners: torch.Tensor, z: torch.Tensor, color: torch.Tensor,
                       res: int, max_faces: int):
    """
    Keep the ``max_faces`` faces whose screen centroid is nearest each
    camera's image center; degenerate faces sort last. Equal distances keep
    index order (a stable sort), as the reference's ``lax.top_k`` does.

    Args:
        corners: (B, F, 3, 2) screen-space corners; z: (B, F); color: (B, F, 3).
    Returns:
        (corners (B, K, 3, 2), z (B, K), color (B, K, 3)), K = ``max_faces``,
        or the inputs when F <= ``max_faces``.
    """
    f = corners.shape[1]
    if f <= max_faces:
        return corners, z, color
    # the mean as the reference's compiled code evaluates it, the sum in
    # order times float32(1/3), on every device (a rounding can move a tie)
    center = (corners[:, :, 0] + corners[:, :, 1] + corners[:, :, 2]) * (1.0 / 3.0)
    d2 = ((center - res / 2.0) ** 2).sum(dim=-1)
    e = torch.roll(corners, -1, dims=-2) - corners
    area = torch.abs(e[..., 0, 0] * (corners[..., 2, 1] - corners[..., 0, 1])
                     - e[..., 0, 1] * (corners[..., 2, 0] - corners[..., 0, 0]))
    d2 = torch.where(area > DEGENERATE_AREA_EPS, d2, torch.inf)
    idx = torch.sort(d2, dim=1, stable=True).indices[:, :max_faces]   # (B, K)
    corners = torch.gather(corners, 1, idx[..., None, None].expand(-1, -1, 3, 2))
    z = torch.gather(z, 1, idx)
    color = torch.gather(color, 1, idx[..., None].expand(-1, -1, color.shape[-1]))
    return corners, z, color


def cull_prims_to_view(corners: torch.Tensor, z: torch.Tensor, color: torch.Tensor,
                       res: int, keep: int):
    """
    :func:`cull_faces_to_view` for K-corner primitives (quads, triangles),
    as the reference's ``cull_prims_to_view``: keep the ``keep`` prims whose
    centroid (:func:`_mean_corners`) is nearest the image center, prims of
    area ``|e1 x e2|`` (corners 0 -> 1 and 0 -> K-1) at most
    ``DEGENERATE_AREA_EPS`` last, equal distances in index order.

    Args:
        corners: (B, N, K, 2) screen-space corners; z: (B, N); color (B, N, 3).
    Returns:
        (corners (B, keep, K, 2), z, color), or the inputs when N <= keep.
    """
    n, k = corners.shape[1], corners.shape[2]
    if n <= keep:
        return corners, z, color
    d2 = ((_mean_corners(corners) - res / 2.0) ** 2).sum(dim=-1)
    e1 = corners[:, :, 1] - corners[:, :, 0]
    e2 = corners[:, :, -1] - corners[:, :, 0]
    area = torch.abs(e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0])
    d2 = torch.where(area > DEGENERATE_AREA_EPS, d2, torch.inf)
    idx = torch.sort(d2, dim=1, stable=True).indices[:, :keep]        # (B, keep)
    corners = torch.gather(corners, 1, idx[..., None, None].expand(-1, -1, k, 2))
    z = torch.gather(z, 1, idx)
    color = torch.gather(color, 1, idx[..., None].expand(-1, -1, color.shape[-1]))
    return corners, z, color


def edge_functions(corners: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """
    Signed edge functions ``e_k(p) = cross(b - a, p - a)`` of each face on
    the pixel grid.

    Args:
        corners: (B, F, 3, 2) screen corners (row, col).
        px, py: (H, W) pixel center coordinates (row, col).
    Returns:
        (e (B, F, 3, H, W), area (B, F)).
    """
    a = corners
    b = corners[..., [1, 2, 0], :]
    ex = b[..., 0] - a[..., 0]
    ey = b[..., 1] - a[..., 1]
    e = (ex[..., None, None] * (py - a[..., 1][..., None, None])
         - ey[..., None, None] * (px - a[..., 0][..., None, None]))
    area = (ex[..., 0] * (a[..., 2, 1] - a[..., 0, 1])
            - ey[..., 0] * (a[..., 2, 0] - a[..., 0, 0]))
    return e, area


def rasterize_softmax(verts: torch.Tensor, faces: torch.Tensor,
                      attrs: torch.Tensor, res: int, background: torch.Tensor,
                      sigma: float = 0.5, gamma: float = 0.5,
                      face_chunk: int = 16) -> torch.Tensor:
    """
    Plain differentiable softmax-blend soft raster, channels last (the
    reference's ``rasterize_softmax``, the twin of the kernel path in
    ``ops/soft.py``): per pixel, ``alpha_f = prod_e sigmoid(d_e / sigma) *
    clip(min_e d_e / sigma + 4, 0, 1)``, faces resolve by softmax over
    ``alpha_f * exp((20 - z_f) / gamma)``, and the coverage
    ``1 - prod_f (1 - alpha_f)`` lerps against the background. Autograd
    gives the gradients.

    Args:
        verts: (B, V, 3) screen (row, col, z); faces: (B, F, 3);
        attrs: (B, V, 3); background: (B, res, res, 3).
    Returns:
        (B, res, res, 3) image in [0, 1].
    """
    b = verts.shape[0]
    if faces.shape[1] == 0:
        return background
    corners, z, color = face_arrays(verts, faces, attrs)
    zw = torch.exp((20.0 - z) / gamma)
    coords = torch.arange(res, dtype=verts.dtype, device=verts.device) + 0.5
    px = coords[:, None].expand(res, res)
    py = coords[None, :].expand(res, res)
    num = torch.zeros_like(background)
    den = torch.zeros((b, res, res), dtype=verts.dtype, device=verts.device)
    transparent = torch.ones_like(den)
    for s in range(0, corners.shape[1], face_chunk):
        cc, czw, ccol = (corners[:, s:s + face_chunk], zw[:, s:s + face_chunk],
                         color[:, s:s + face_chunk])
        e, area = edge_functions(cc, px, py)               # B,Fc,3,H,W
        sign = torch.sign(area)[..., None, None, None]
        ed = cc[..., [1, 2, 0], :] - cc
        # clamped sqrt: norm'(0) = inf would turn masked degenerate faces'
        # zero gradient into 0 * inf = NaN
        elen = torch.sqrt(torch.clamp((ed * ed).sum(-1), min=1e-12))
        d = e * sign / (elen[..., None, None] + 1e-8)
        alpha = torch.prod(torch.sigmoid(d / sigma), dim=2)  # B,Fc,H,W
        window = torch.clamp(torch.amin(d, dim=2) / sigma + 4.0, 0.0, 1.0)
        ok = (torch.abs(area) > DEGENERATE_AREA_EPS)[..., None, None]
        alpha = torch.where(ok, alpha * window, torch.zeros_like(alpha))
        w = alpha * czw[..., None, None]
        num = num + torch.einsum('bfhw,bfc->bhwc', w, ccol)
        den = den + w.sum(dim=1)
        transparent = transparent * torch.prod(1.0 - alpha, dim=1)
    c_faces = num / torch.clamp(den[..., None], min=1e-8)
    coverage = (1.0 - transparent)[..., None]
    return coverage * c_faces + (1.0 - coverage) * background


def _prim_screen_stats(corners: torch.Tensor, res: int):
    """Per-prim screen bbox + liveness. corners: (B, N, K, 2) ->
    (rmin, rmax (B, N), alive (B, N)): alive == non-degenerate AND its bbox
    intersects the image."""
    rmin = corners[..., 0].amin(dim=-1)
    rmax = corners[..., 0].amax(dim=-1)
    cmin = corners[..., 1].amin(dim=-1)
    cmax = corners[..., 1].amax(dim=-1)
    e1 = corners[:, :, 1] - corners[:, :, 0]
    e2 = corners[:, :, -1] - corners[:, :, 0]
    area = torch.abs(e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0])
    alive = ((area > DEGENERATE_AREA_EPS)
             & (cmax >= 0.0) & (cmin < float(res))
             & (rmax >= 0.0) & (rmin < float(res)))
    return rmin, rmax, alive


def prim_band_chunk_masks(rmin: torch.Tensor, rmax: torch.Tensor,
                          alive: torch.Tensor, rank: torch.Tensor, res: int,
                          n_bands: int, n_chunks: int,
                          chunk: int = CHUNK) -> torch.Tensor:
    """
    Per-(band, chunk) occupancy: entry ``[b, j, 0, c]`` is 1 iff some alive
    prim whose SORTED position ``rank`` falls in chunk ``c`` has a row
    interval intersecting band ``j``.

    Returns:
        (B, n_bands, 1, n_chunks) int32.
    """
    band_h = res / n_bands
    bands_lo = (torch.arange(n_bands, dtype=torch.float32, device=rmin.device)
                * band_h)[None, :, None]                        # (1, J, 1)
    lo = torch.where(alive, rmin, 1e9)[:, None, :]
    hi = torch.where(alive, rmax, -1e9)[:, None, :]
    hits = (hi >= bands_lo) & (lo < bands_lo + band_h)          # (B, J, N)
    chunk_of = (rank // chunk)[:, None, :, None] == torch.arange(
        n_chunks, device=rank.device)                          # (B, 1, N, C)
    mask = (hits[..., None] & chunk_of).any(dim=2)             # (B, J, C)
    return mask.to(torch.int32)[:, :, None, :]


def _edge_coefficients_edge_major(corners: torch.Tensor):
    """
    Edge-major affine coefficients: for edge k of every triangle,
    e_k(p) = a*px + b*py + c.

    Args:
        corners: (B, F, 3, 2) screen-space (row, col) corners.
    Returns:
        (coef (B, 3, F, 3) [edge, face, (a, b, c)], area (B, F)).
    """
    a_pt = corners
    b_pt = torch.roll(corners, -1, dims=-2)              # corners 1, 2, 0
    ex = b_pt[..., 0] - a_pt[..., 0]
    ey = b_pt[..., 1] - a_pt[..., 1]
    coef = torch.stack([-ey, ex, ey * a_pt[..., 0] - ex * a_pt[..., 1]], dim=-1)
    area = (ex[..., 0] * (a_pt[..., 2, 1] - a_pt[..., 0, 1])
            - ey[..., 0] * (a_pt[..., 2, 0] - a_pt[..., 0, 0]))
    return coef.transpose(1, 2), area


def _pad_prims(a: torch.Tensor, n: int, target: int, fill=0) -> torch.Tensor:
    """Pad dim 1 of ``a`` from ``n`` to ``target`` entries with ``fill``."""
    if n == target:
        return a
    pad = a.new_full((a.shape[0], target - n) + tuple(a.shape[2:]), fill)
    return torch.cat([a, pad], dim=1)


def _stable_order(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort of (B, N) keys: (order, rank), where
    ``order[b, r]`` is the element at sorted position r and ``rank`` its
    inverse -- the permutation a stable sort with index tie-break applies."""
    order = torch.sort(key, dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(key.shape[1], device=key.device)
                  .expand_as(order).contiguous())
    return order, rank


def _gather_rows(vals: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``out[b, r] = vals[b, order[b, r]]`` for (B, N, ...) ``vals``."""
    idx = order.reshape(order.shape + (1,) * (vals.dim() - 2))
    return torch.gather(vals, 1, idx.expand(order.shape + vals.shape[2:]))


def prep_sorted_prim_coefs(quads: torch.Tensor, qz: torch.Tensor,
                           qcolors: torch.Tensor, tris: torch.Tensor,
                           tz: torch.Tensor, tcolors: torch.Tensor,
                           res: int, cap: int, n_bands: int,
                           chunk: int = CHUNK):
    """
    Row-major-sorted operands of the fused render: prims ordered visible
    first, ascending by top screen row (a stable sort, so ties keep index
    order), with the 7-bit z-rank | RGB8 packs and band x chunk occupancy
    masks. Same outputs as the reference's ``prep_sorted_prim_coefs``.

    The z tie-break epsilon is applied at each prim's SORTED position, and
    padded, degenerate, off-screen and absent prims carry the sentinel pack.

    Args:
        quads: (B, Q, 4, 2) / tris: (B, T, 3, 2) screen-space corners.
        qz / tz: (B, Q) / (B, T) priorities (lower on top).
        qcolors / tcolors: (B, Q, 3) / (B, T, 3) colors in [0, 1].
    Returns:
        (qcoef (B, 2, QP, 3), qpk (B, QP, 1), qmask (B, J, 1, QP/chunk),
         tcoef (B, 3, TP, 3), tpk (B, TP, 1), tmask (B, J, 1, TP/chunk)),
        or ``None`` when a prim type exceeds ``cap`` or the total exceeds
        127 (the cap of the 7-bit rank).
    """
    b, q = qz.shape
    t = tz.shape[1]
    n = q + t
    if q > cap or t > cap or n > 127:
        return None
    dev = qz.device

    if q:
        q_rmin, q_rmax, q_alive = _prim_screen_stats(quads, res)
        q_order, q_rank = _stable_order(torch.where(q_alive, q_rmin, 3e38))
    if t:
        t_rmin, t_rmax, t_alive = _prim_screen_stats(tris, res)
        t_order, t_rank = _stable_order(torch.where(t_alive, t_rmin, 3e38))

    # joint z -> 7-bit rank, with the tie-break epsilon indexed by each
    # prim's SORTED position
    pos = torch.cat(([q_rank] if q else []) + ([q + t_rank] if t else []),
                    dim=1).to(qz.dtype)
    z = torch.cat([qz, tz], dim=1) + pos * min(1e-4, 0.09 / max(n, 1))
    zpos = (z - z.amin(dim=1, keepdim=True) + 1.0).to(torch.float32)
    zrank = (zpos[:, None, :] < zpos[:, :, None]).sum(dim=-1, dtype=torch.int32)
    colors = torch.cat([qcolors, tcolors], dim=1)
    c8 = torch.clamp(torch.round(colors * 255.0), 0, 255).to(torch.int32)
    packed = (zrank << 24) | (c8[..., 0] << 16) | (c8[..., 1] << 8) | c8[..., 2]

    if q:
        c0 = quads[:, :, 0]
        e1 = quads[:, :, 1] - c0
        e2 = quads[:, :, 3] - c0
        cross = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
        q_valid = torch.abs(cross) > 1e-9
        d = torch.where(q_valid, cross, torch.ones_like(cross))[..., None]

        def affine_coords(nrm):
            a = nrm / d
            c = -(a * c0).sum(dim=-1, keepdim=True) - 0.5
            return torch.cat([a, c], dim=-1)                  # (B, Q, 3)

        perp = lambda e: torch.stack([e[..., 1], -e[..., 0]], dim=-1)
        qcoef_u = torch.stack([affine_coords(perp(e2)),
                               affine_coords(-perp(e1))], dim=2)  # (B, Q, 2, 3)
        qpk_u = torch.where(q_valid & q_alive, packed[:, :q], SENTINEL)
        qp = max(8, -(-q // 8) * 8)
        qcoef = _pad_prims(_gather_rows(qcoef_u, q_order), q, qp).transpose(1, 2)
        qpk = _pad_prims(_gather_rows(qpk_u, q_order), q, qp, SENTINEL)[..., None]
        qmask = prim_band_chunk_masks(q_rmin, q_rmax, q_alive, q_rank, res,
                                      n_bands, max(1, -(-qp // chunk)), chunk)
    else:
        qp = 8
        qcoef = torch.zeros((b, 2, qp, 3), dtype=torch.float32, device=dev)
        qpk = torch.full((b, qp, 1), SENTINEL, dtype=torch.int32, device=dev)
        qmask = torch.zeros((b, n_bands, 1, max(1, -(-qp // chunk))),
                            dtype=torch.int32, device=dev)

    if t:
        tcoef_u, area = _edge_coefficients_edge_major(tris)
        tcoef_u = tcoef_u * torch.sign(area)[:, None, :, None]
        t_valid = torch.abs(area) > 1e-9
        tpk_u = torch.where(t_valid & t_alive, packed[:, q:], SENTINEL)
        tp = max(8, -(-t // 8) * 8)
        tcoef = _pad_prims(_gather_rows(tcoef_u.transpose(1, 2), t_order), t, tp
                           ).transpose(1, 2)
        tpk = _pad_prims(_gather_rows(tpk_u, t_order), t, tp, SENTINEL)[..., None]
        tmask = prim_band_chunk_masks(t_rmin, t_rmax, t_alive, t_rank, res,
                                      n_bands, max(1, -(-tp // chunk)), chunk)
    else:
        tp = 8
        tcoef = torch.zeros((b, 3, tp, 3), dtype=torch.float32, device=dev)
        tpk = torch.full((b, tp, 1), SENTINEL, dtype=torch.int32, device=dev)
        tmask = torch.zeros((b, n_bands, 1, max(1, -(-tp // chunk))),
                            dtype=torch.int32, device=dev)

    return (qcoef.contiguous(), qpk.contiguous(), qmask, tcoef.contiguous(),
            tpk.contiguous(), tmask)


def supports_res(res: int) -> bool:
    """Whether the banded kernels tile ``res`` directly (any multiple of 16
    up to 4096 has a band tiling)."""
    try:
        band_rows(res)
        return True
    except ValueError:
        return False


def _mean_corners(corners: torch.Tensor) -> torch.Tensor:
    """(B, N, K, 2) -> (B, N, 2): the corners summed in order times
    float32(1 / K), as the reference's compiled mean evaluates it."""
    k = corners.shape[2]
    total = corners[:, :, 0]
    for i in range(1, k):
        total = total + corners[:, :, i]
    return total * (1.0 / k)


def _sort_rowmajor(corners: torch.Tensor, z: torch.Tensor, color: torch.Tensor,
                   res: int, cap: int):
    """:func:`sort_prims_rowmajor` with the sorted prims' screen stats:
    (corners, z, color, (rmin, rmax, alive)), N >= 1."""
    n = z.shape[1]
    rmin, rmax, alive = _prim_screen_stats(corners, res)
    arrays = (corners, z, color, rmin, rmax, alive)
    if n > cap:
        d2 = ((_mean_corners(corners) - res / 2.0) ** 2).sum(dim=-1)
        order = torch.sort(torch.where(alive, d2, 3e38), dim=1, stable=True).indices
        arrays = [_gather_rows(a, order[:, :cap]) for a in arrays]
        rmin, alive = arrays[3], arrays[5]
    order = torch.sort(torch.where(alive, rmin, 3e38), dim=1, stable=True).indices
    corners, z, color, rmin, rmax, alive = [_gather_rows(a, order) for a in arrays]
    # dropped and invisible prims go last and are zeroed: degenerate, they
    # never cover a pixel
    live = torch.arange(corners.shape[1], device=z.device)[None] \
        < alive.sum(dim=1, keepdim=True)
    corners = torch.where(live[..., None, None], corners, 0.0)
    return corners, z, color, (rmin, rmax, alive)


def sort_prims_rowmajor(corners: torch.Tensor, z: torch.Tensor,
                        color: torch.Tensor, res: int, cap: int):
    """
    Order primitives for the banded raster: visible prims first, ascending
    by top screen row (a stable sort, so ties keep index order), capped at
    ``cap``; over the cap the prims nearest the view center are kept.
    Same outputs as the reference's ``sort_prims_rowmajor``.

    Args:
        corners: (B, N, K, 2) screen-space corners; z: (B, N); color (B, N, 3).
    Returns:
        (corners (B, min(N, cap), K, 2), z, color), invisible prims zeroed.
    """
    if z.shape[1] == 0:
        return corners, z, color
    return _sort_rowmajor(corners, z, color, res, cap)[:3]


def sort_prims_rowmajor_with_masks(corners: torch.Tensor, z: torch.Tensor,
                                   color: torch.Tensor, res: int, cap: int,
                                   n_bands: int, chunk: int = CHUNK):
    """
    :func:`sort_prims_rowmajor` and the band x chunk occupancy of the sorted
    prims (:func:`prim_band_chunk_masks`), as the reference's
    ``sort_prims_rowmajor_with_masks``.

    Returns:
        (corners (B, min(N, cap), K, 2), z, color,
         mask (B, n_bands, 1, max(1, ceil(min(N, cap) / chunk))) int32).
    """
    b, n = z.shape
    n_chunks = max(1, -(-min(n, cap) // chunk))
    if n == 0:
        return corners, z, color, torch.zeros((b, n_bands, 1, n_chunks),
                                              dtype=torch.int32, device=z.device)
    corners, z, color, (rmin, rmax, alive) = _sort_rowmajor(corners, z, color,
                                                            res, cap)
    rank = torch.arange(corners.shape[1], device=z.device).expand(b, -1)
    mask = prim_band_chunk_masks(rmin, rmax, alive, rank, res, n_bands, n_chunks,
                                 chunk)
    return corners, z, color, mask


def pack_texture_rgb8(data: np.ndarray) -> np.ndarray:
    """(H, W, 3) float RGB texture in [0, 1] -> (H, W) int32 texels
    0x00BBGGRR (host numpy), one gather per sampled pixel."""
    q = np.round(np.clip(np.asarray(data, np.float32), 0.0, 1.0) * np.float32(255.0)
                 ).astype(np.uint32)
    return (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)).astype(np.int32)


def _pixel_world_coords(cam_xy: torch.Tensor, cam_sc: torch.Tensor, scale: float,
                       res: int, left_handed: bool) -> torch.Tensor:
    """World coordinates of every output pixel center, (B, res, res, 2): the
    inverse of :func:`camera_rows_cols`."""
    coords = torch.arange(res, dtype=torch.float32, device=cam_xy.device) + 0.5
    half = res / 2.0
    px_per_m = scale * half
    forward = ((half - coords[:, None]) / px_per_m).expand(res, res)
    left = (((coords[None, :] - half) if left_handed else (half - coords[None, :]))
            / px_per_m).expand(res, res)
    s = cam_sc[:, 0, None, None]
    c = cam_sc[:, 1, None, None]
    dx = c * forward - s * left
    dy = s * forward + c * left
    return torch.stack([dx + cam_xy[:, 0, None, None],
                        dy + cam_xy[:, 1, None, None]], dim=-1)


def _resize_taps(n_in: int, n_out: int, device):
    """
    The reference's bilinear resize weights along one dimension
    (``jax.image.resize(..., 'bilinear')`` upsampling: half-pixel centers,
    a triangle kernel, each output's weights divided by their sum, which
    amounts to clamping at the border), computed in float32 as it computes
    them. Returns each output's first and last input index and their
    weights (the last weight 0 where a single input serves the output).
    """
    f32 = dict(dtype=torch.float32, device=device)
    inv = torch.tensor(1.0, **f32) / torch.tensor(n_out / n_in, **f32)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv - 0.5
    weights = torch.clamp(1 - torch.abs(sample[None, :]
                                        - torch.arange(n_in, **f32)[:, None]), min=0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    nonzero = weights > 0
    rows = torch.arange(n_in, device=device)[:, None]
    lo = torch.where(nonzero, rows, n_in).amin(dim=0)
    hi = torch.where(nonzero, rows, -1).amax(dim=0)
    cols = torch.arange(n_out, device=device)
    w_hi = torch.where(hi > lo, weights[hi, cols], 0.0)
    return lo, hi, weights[lo, cols], w_hi


def _resize_dim(img: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """One dimension of the bilinear resize, summed as the reference's
    compiled contraction sums it: the first tap's product rounded, then the
    second tap's product added with a single rounding (a fused multiply-add,
    exact here in float64 before the one rounding to float32)."""
    lo, hi, w_lo, w_hi = _resize_taps(img.shape[dim], n_out, img.device)
    shape = [1] * img.dim()
    shape[dim] = n_out
    first = img.index_select(dim, lo) * w_lo.reshape(shape)
    second = img.index_select(dim, hi).double() * w_hi.reshape(shape).double()
    return (first.double() + second).to(img.dtype)


def sample_background_packed(texture: torch.Tensor, origin, cell_size: float,
                             cam_xy: torch.Tensor, cam_sc: torch.Tensor,
                             scale: float, res: int,
                             background_color: torch.Tensor,
                             left_handed: bool = False,
                             downsample: int = 1) -> torch.Tensor:
    """
    Nearest-texel view of the full-resolution packed texture, one gather
    per pixel (the reference's ``sample_background_packed`` with
    ``chw=True``): pixel centers map to world coordinates, to texel
    coordinates rounded half to even; a texel outside the texture takes the
    background color. With ``downsample`` k > 1 the view is sampled at
    ``res // k`` and resized to ``res`` bilinearly, rows then columns, as the
    reference's ``jax.image.resize`` does.

    Args:
        texture: (H, W) int32 0x00BBGGRR from :func:`pack_texture_rgb8`,
            unpadded: its shape is the texture's extent.
        origin: (2,) world coordinates of texel (0, 0); cell_size in meters.
        background_color: (3,) float in [0, 1].
    Returns:
        (B, 3, res, res) float32 in [0, 1].
    """
    sample_res = res // downsample
    world = _pixel_world_coords(cam_xy, cam_sc, scale, sample_res, left_handed)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=world.device)
    uv = (world - origin) / cell_size
    xi = torch.round(uv[..., 0]).to(torch.int32)
    yi = torch.round(uv[..., 1]).to(torch.int32)
    h, w = texture.shape
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
    packed = texture.reshape(-1)[idx]
    img = torch.stack([(packed >> s) & 0xFF for s in (0, 8, 16)], dim=1
                      ).to(torch.float32) * _INV255
    img = torch.where(valid[:, None], img,
                      background_color.to(torch.float32)[None, :, None, None])
    if downsample > 1:
        img = _resize_dim(_resize_dim(img, 2, res), 3, res)
    return img


def sample_background(texture, cam_xy: torch.Tensor, cam_sc: torch.Tensor, scale: float,
                      res: int, background_color: torch.Tensor,
                      left_handed: bool = False) -> torch.Tensor:
    """
    Bilinear view of a float RGB texture (the reference's
    ``sample_background``), differentiable in the camera pose: each pixel
    center's world position is sampled with ``ops.grids.bilinear_sample``,
    the taps outside the texture reading -1, and every channel that comes
    out negative takes the background color's.

    Args:
        texture: ``ops.grids.Grid2D`` of (H, W, 3) float data in [0, 1]
            (host numpy or a tensor).
        background_color: (3,) float in [0, 1].
    Returns:
        (B, 3, res, res) float32.
    """
    world = _pixel_world_coords(cam_xy, cam_sc, scale, res, left_handed)
    img = bilinear_sample(texture, world, fill_value=-1.0).permute(0, 3, 1, 2)
    bg = background_color.to(img.dtype)[None, :, None, None].expand_as(img)
    return torch.where(img < 0, bg, img)


def pack_texture_rgb8_quad(data: np.ndarray) -> np.ndarray:
    """
    (H, W, 3) float RGB texture in [0, 1] -> (H, W, 4) int32 (host numpy):
    cell (y, x) holds the 2 x 2 bilinear quad {(y, x), (y, x+1), (y+1, x),
    (y+1, x+1)}, each texel as 0x00BBGGRR (:func:`pack_texture_rgb8`), the
    texels past the last row and column 0; one 16-byte load per sampled
    pixel.
    """
    packed = pack_texture_rgb8(data)
    h, w = packed.shape
    ppad = np.pad(packed, ((0, 1), (0, 1)))
    return np.stack([ppad[:h, :w], ppad[:h, 1:w + 1], ppad[1:h + 1, :w],
                     ppad[1:h + 1, 1:w + 1]], axis=-1).astype(np.int32)


def sample_background_quad(quad_texture: torch.Tensor, origin, cell_size: float,
                           cam_xy: torch.Tensor, cam_sc: torch.Tensor, scale: float,
                           res: int, background_color: torch.Tensor,
                           left_handed: bool = False) -> torch.Tensor:
    """
    Bilinear view of a :func:`pack_texture_rgb8_quad` texture (the
    reference's ``sample_background_quad``): one int32 x 4 gather per pixel.
    A pixel whose quad lies inside the texture (``0 <= x0 < w - 1`` and
    ``0 <= y0 < h - 1``) interpolates its four texels, any other takes the
    background color. The floor indices carry no gradient: pose gradients
    flow through the bilinear weights ``tx``, ``ty`` only.

    Args:
        quad_texture: (H, W, 4) int32 on the device; origin: (2,) world
            coordinates of texel (0, 0); cell_size in meters.
        background_color: (3,) float in [0, 1].
    Returns:
        (B, 3, res, res) float32.
    """
    world = _pixel_world_coords(cam_xy, cam_sc, scale, res, left_handed)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=world.device)
    uv = (world - origin) / cell_size
    x, y = uv[..., 0], uv[..., 1]
    x0 = torch.floor(x).detach()
    y0 = torch.floor(y).detach()
    tx = (x - x0)[:, None]
    ty = (y - y0)[:, None]
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    h, w = quad_texture.shape[0], quad_texture.shape[1]
    valid = (x0i >= 0) & (x0i < w - 1) & (y0i >= 0) & (y0i < h - 1)
    g = quad_texture[y0i.clamp(0, h - 1).long(), x0i.clamp(0, w - 1).long()]

    def unpack(p):
        return torch.stack([(p >> s) & 0xFF for s in (0, 8, 16)], dim=1
                           ).to(torch.float32) * _INV255

    v00, v01, v10, v11 = (unpack(g[..., k]) for k in range(4))
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    img = top * (1 - ty) + bot * ty
    bg = background_color.to(img.dtype)[None, :, None, None].expand_as(img)
    return torch.where(valid[:, None], img, bg)


def rasterize_soft(verts: torch.Tensor, faces: torch.Tensor, attrs: torch.Tensor,
                   res: int, background: torch.Tensor, sigma: float = 0.5,
                   face_chunk: int = 16) -> torch.Tensor:
    """
    The painter's blend (the reference's ``rasterize_soft``), plain
    PyTorch with autograd: faces are ordered back to front by a stable
    argsort of ``-z`` (no gradient through the order) and blended one after
    another, ``canvas = canvas * (1 - w) + color * w``, where ``w`` is the
    product of the sigmoids of the three edge distances over ``sigma``,
    each edge value divided by ``sqrt(max(|e|^2, 1e-12)) + 1e-8``; faces of
    area at most ``DEGENERATE_AREA_EPS`` weigh 0. The weights of
    ``face_chunk`` faces are evaluated together; the blend is a loop over
    the faces, so autograd keeps one canvas per face (B x res x res x 3
    floats) and the chunks' weights.

    Args:
        verts: (B, V, 3) screen (row, col, z); faces: (B, F, 3);
        attrs: (B, V, 3); background: (B, res, res, 3).
    Returns:
        (B, res, res, 3) image in [0, 1].
    """
    if faces.shape[1] == 0:
        return background
    corners, z, color = face_arrays(verts, faces, attrs)
    order = torch.argsort(-z.detach(), dim=1, stable=True)
    corners = torch.gather(corners, 1, order[..., None, None].expand(-1, -1, 3, 2))
    color = torch.gather(color, 1, order[..., None].expand(-1, -1, color.shape[-1]))
    coords = torch.arange(res, dtype=verts.dtype, device=verts.device) + 0.5
    px = coords[:, None].expand(res, res)
    py = coords[None, :].expand(res, res)
    canvas = background
    for s in range(0, corners.shape[1], face_chunk):
        cc, ccol = corners[:, s:s + face_chunk], color[:, s:s + face_chunk]
        e, area = edge_functions(cc, px, py)               # B,Fc,3,H,W
        sign = torch.sign(area)[..., None, None, None]
        ed = cc[..., [1, 2, 0], :] - cc
        elen = torch.sqrt(torch.clamp((ed * ed).sum(-1), min=1e-12))
        d = e * sign / (elen[..., None, None] + 1e-8)
        w = torch.prod(torch.sigmoid(d / sigma), dim=2)     # B,Fc,H,W
        ok = (torch.abs(area) > DEGENERATE_AREA_EPS)[..., None, None]
        w = torch.where(ok, w, torch.zeros_like(w))[..., None]
        for f in range(cc.shape[1]):
            canvas = canvas * (1 - w[:, f]) + ccol[:, f, None, None, :] * w[:, f]
    return canvas


def bake_background_texture(verts: torch.Tensor, faces: torch.Tensor,
                            attrs: torch.Tensor, background_color,
                            pixels_per_meter: float = 4.0, margin: float = 20.0,
                            face_chunk: int = 32, row_chunk: int = 512) -> Grid2D:
    """
    Rasterize a static mesh once into a world-anchored RGB texture, as the
    reference bakes it: texture space is screen space (row ~ y, col ~ x, z
    the priority), rasterized in strips of ``row_chunk`` rows, each shifted
    to start at row 0 by the reference's float32 ``row - h0`` (so a texel's
    bits depend on its strip) and drawn by one hard face raster (HF on the
    card) of every face over the background color. Runs on the device of
    ``verts``.

    Args:
        verts: (V, 3) world (x, y, priority z); faces: (F, 3); attrs: (V, 3)
            colors in [0, 1]; background_color: (3,) color outside all faces.
        face_chunk: unused (the reference's scan chunk).
    Returns:
        Grid2D whose data (H, W, 3) float32 [iy, ix] covers world point
        origin + (ix, iy) / ppm, on the device of ``verts``.
    """
    verts = torch.as_tensor(verts, dtype=torch.float32)
    device = verts.device
    faces = torch.as_tensor(faces, device=device)
    attrs = torch.as_tensor(attrs, dtype=torch.float32, device=device)
    v = verts.detach().cpu().numpy()
    lo = v[:, :2].min(axis=0) - margin                # float32, as the reference's
    hi = v[:, :2].max(axis=0) + margin
    w = int(np.ceil((hi[0] - lo[0]) * pixels_per_meter)) + 1
    h = int(np.ceil((hi[1] - lo[1]) * pixels_per_meter)) + 1
    origin = torch.as_tensor(lo, dtype=torch.float32, device=device)
    sv = torch.stack([(verts[:, 1] - origin[1]) * pixels_per_meter,
                      (verts[:, 0] - origin[0]) * pixels_per_meter,
                      verts[:, 2]], dim=-1)[None]
    bg = torch.as_tensor(background_color, dtype=torch.float32, device=device)
    data = torch.empty((h, w, 3), dtype=torch.float32, device=device)
    for r0 in range(0, h, row_chunk):
        strip_h = min(row_chunk, h - r0)
        data[r0:r0 + strip_h] = _bake_strip(
            sv, faces[None], attrs[None], bg.expand(1, strip_h, w, 3),
            h0=r0, strip_h=strip_h, w=w, face_chunk=face_chunk)[0]
    return Grid2D(data=data, origin=origin, cell_size=1.0 / pixels_per_meter)


def _bake_strip(sv, faces, attrs, background, *, h0, strip_h, w, face_chunk):
    """One strip of :func:`bake_background_texture`: the rows shifted so the
    strip starts at row 0 (a float32 subtraction, as the reference's)."""
    sv = torch.cat([sv[..., :1] - h0, sv[..., 1:]], dim=-1)
    return _rasterize_hard_rect(sv, faces, attrs, strip_h, w, background,
                                face_chunk=face_chunk)


def _rasterize_hard_rect(verts, faces, attrs, height, width, background, face_chunk=16):
    """
    The hard raster of a mesh on a ``height`` x ``width`` frame (one HF
    launch on the card), channels last as the reference's.

    Args:
        verts: (B, V, 3) screen (row, col, z); faces: (B, F, 3); attrs: (B, V,
            3); background: (B, height, width, 3). ``face_chunk`` is unused.
    Returns:
        (B, height, width, 3).
    """
    corners, z, color = face_arrays(verts, faces, attrs)
    image, _ = _hard_faces.hard_faces(corners.contiguous(), z.contiguous(),
                                      color.contiguous(), background.permute(0, 3, 1, 2))
    return image.permute(0, 2, 3, 1)
