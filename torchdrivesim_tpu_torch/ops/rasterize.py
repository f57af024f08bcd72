"""
Screen-space primitive preparation for the fused render, and the plain
softmax-blend soft raster (counterpart of the parts of
``torchdrivesim_tpu/ops/rasterize.py`` and ``ops/pallas_rasterize.py`` that
the textured primitive path and the differentiable path run).

Screen convention: the camera's forward axis points up in the image, its
left axis points left; ``left_handed`` mirrors columns. Pixel (r, c) has its
center at (r + 0.5, c + 0.5).
"""
from typing import Tuple

import torch

DEGENERATE_AREA_EPS = 1e-9
#: pixels per band tile; a band is the unit the occupancy masks cull by
PIXELS_PER_TILE = 4096
#: primitives per occupancy-mask chunk
CHUNK = 8
#: packed-pack sentinel: loses every min, never covers a pixel
SENTINEL = 0x7FFFFFFF


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

    def gather_rows(vals, order):
        # out[b, r] = vals[b, order[b, r]]
        idx = order.reshape(order.shape + (1,) * (vals.dim() - 2))
        return torch.gather(vals, 1, idx.expand(order.shape + vals.shape[2:]))

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
        qcoef = _pad_prims(gather_rows(qcoef_u, q_order), q, qp).transpose(1, 2)
        qpk = _pad_prims(gather_rows(qpk_u, q_order), q, qp, SENTINEL)[..., None]
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
        tcoef = _pad_prims(gather_rows(tcoef_u.transpose(1, 2), t_order), t, tp
                           ).transpose(1, 2)
        tpk = _pad_prims(gather_rows(tpk_u, t_order), t, tp, SENTINEL)[..., None]
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
