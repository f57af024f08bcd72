"""
Hard z-priority rasterization of typed primitives (quads and triangles)
over a given background (counterpart of the primitive half of
``torchdrivesim_tpu/ops/pallas_rasterize.py``):

* :func:`prep_prims`: the kernel operands, packs ``rank << 24 | RGB8`` and
  affine coefficients;
* :func:`rasterize_hard_prims_banded` (B7): row-major-sorted prims and their
  band x chunk occupancy masks (``ops.rasterize
  .sort_prims_rowmajor_with_masks``); each band visits only its live
  8-primitive chunks;
* :func:`rasterize_hard_prims` (B8): any prims, every chunk in every band.

Both run one kernel, :func:`raster_prims`: the hand-written CUDA kernel
(``csrc/prim_raster.cu``, masked for B7 and unmasked for B8) for CUDA
tensors, its plain PyTorch version :func:`raster_prims_reference` for CPU
tensors. The per-pixel winner is the fused render's (``ops/fused.py``,
``csrc/prim_winner.cuh``): each 16 x 16 pixel tile tests only the
primitives that can reach it, an exact cull whose plain version is
:func:`prim_tile_keep_reference`. The background is read through its
strides, so a per-camera color expanded to (B, 3, res, res) is never
written out.
"""
import ctypes
from typing import Optional

import numpy as np
import torch

from torchdrivesim_tpu_torch import tracing
from torchdrivesim_tpu_torch.ops import build, warp
from torchdrivesim_tpu_torch.ops.build import KernelLibrary, check_launch
from torchdrivesim_tpu_torch.ops.rasterize import (
    CHUNK, SENTINEL, _edge_coefficients_edge_major, _pad_prims, band_rows,
)

#: most primitives of one camera (7-bit rank)
MAX_PRIMS = 127
#: pixels per side of the primitive winner's cull tiles
PRIM_TILE = 16
#: the cull's slack per unit of |a| x_max + |b| y_max + |c|, and per
#: nonzero product a*px, b*py (which may underflow)
_CULL_SLACK = 2.0 ** -20
_CULL_UNDERFLOW = 2.0 ** -149
_INV255 = 1.0 / 255.0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature (see ``csrc/prim_raster.cu``):
    qcoef, qpk, tcoef, tpk, qmask, tmask (null for every chunk) and
    background pointers; batch, res, rpb, qp, tp; the background's batch,
    channel and pixel strides; the output pointer and the stream."""
    fn = lib.tds_prim_raster
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


LIBRARY = KernelLibrary('prim_raster.cu', _bind)


def occupancy(qp: int, tp: int):
    """(registers per thread, resident blocks per SM, spill bytes per
    thread) of the kernel at ``qp`` quads and ``tp`` triangles."""
    return build.occupancy(LIBRARY.load().tds_prim_raster_occupancy, qp, tp)


def prep_prims(quads: torch.Tensor, qz: torch.Tensor, qcolors: torch.Tensor,
               tris: torch.Tensor, tz: torch.Tensor, tcolors: torch.Tensor):
    """
    Kernel operands of typed primitives, as the reference's ``_prep_prims``:
    the joint z rank (ties broken by the index bump ``arange(n) * min(1e-4,
    0.09 / n)``, quads before triangles) packed with RGB8; each quad's two
    affine coordinates centered so that inside is ``|f| <= 1/2``; each
    triangle's edge coefficients scaled by ``sign(area)``. Degenerate prims
    (``|cross| <= 1e-9``) carry the sentinel; each type is padded to a
    multiple of 8 (at least 8) with zero coefficients and the sentinel.

    Args:
        quads: (B, Q, 4, 2) screen corners in cycle order; tris: (B, T, 3, 2).
        qz / tz: (B, Q) / (B, T) priorities (lower on top).
        qcolors / tcolors: (B, Q, 3) / (B, T, 3) in [0, 1].
    Returns:
        (qcoef (B, 2, QP, 3) float32, qpk (B, QP, 1) int32,
         tcoef (B, 3, TP, 3) float32, tpk (B, TP, 1) int32).
    """
    b, q = qz.shape
    t = tz.shape[1]
    n = q + t
    if n > MAX_PRIMS:
        raise ValueError(f'the prim raster takes at most {MAX_PRIMS} primitives '
                         f'per camera, got {n}')
    z = torch.cat([qz, tz], dim=1)
    z = z + torch.arange(n, dtype=z.dtype, device=z.device)[None] * min(1e-4, 0.09 / max(n, 1))
    zmin = z.amin(dim=1, keepdim=True) if n else z.new_zeros((b, 1))
    zpos = (z - zmin + 1.0).to(torch.float32)
    rank = (zpos[:, None, :] < zpos[:, :, None]).sum(dim=-1, dtype=torch.int32)
    c8 = torch.clamp(torch.round(torch.cat([qcolors, tcolors], dim=1) * 255.0),
                     0, 255).to(torch.int32)
    packed = (rank << 24) | (c8[..., 0] << 16) | (c8[..., 1] << 8) | c8[..., 2]

    # quad affine coordinates: p = c0 + f1*e1 + f2*e2, f1(p) = cross(p - c0,
    # e2) / cross(e1, e2), affine in p
    c0 = quads[:, :, 0]
    e1 = quads[:, :, 1] - c0
    e2 = quads[:, :, 3] - c0
    cross = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    q_valid = torch.abs(cross) > 1e-9
    d = torch.where(q_valid, cross, torch.ones_like(cross))[..., None]

    def affine_coords(nrm):
        a = nrm / d
        c = -(a * c0).sum(dim=-1, keepdim=True) - 0.5
        return torch.cat([a, c], dim=-1)                      # (B, Q, 3)

    perp = lambda e: torch.stack([e[..., 1], -e[..., 0]], dim=-1)
    qcoef = torch.stack([affine_coords(perp(e2)), affine_coords(-perp(e1))],
                        dim=2)                                # (B, Q, 2, 3)
    tcoef, area = _edge_coefficients_edge_major(tris)
    tcoef = (tcoef * torch.sign(area)[:, None, :, None]).transpose(1, 2)
    qpk = torch.where(q_valid, packed[:, :q], SENTINEL)
    tpk = torch.where(torch.abs(area) > 1e-9, packed[:, q:], SENTINEL)

    qp, tp = max(8, -(-q // 8) * 8), max(8, -(-t // 8) * 8)
    return (_pad_prims(qcoef, q, qp).transpose(1, 2).to(torch.float32).contiguous(),
            _pad_prims(qpk, q, qp, SENTINEL)[..., None].contiguous(),
            _pad_prims(tcoef, t, tp).transpose(1, 2).to(torch.float32).contiguous(),
            _pad_prims(tpk, t, tp, SENTINEL)[..., None].contiguous())


def prim_winner_reference(qcoef: torch.Tensor, qpk: torch.Tensor,
                          tcoef: torch.Tensor, tpk: torch.Tensor,
                          qmask: Optional[torch.Tensor],
                          tmask: Optional[torch.Tensor], res: int) -> torch.Tensor:
    """
    Per pixel, the minimum pack of the quads with ``max(|f1|, |f2|) <= 0.5``
    and the triangles whose three edge values are ``>= 0`` (the sentinel
    where none is), vectorised over (B, res, res) and looping over chunks of
    8 primitives. With masks, a chunk counts in a band only where its
    occupancy bit is set, as the kernels honour them.

    Returns:
        (B, res, res) int32.
    """
    dev = qpk.device
    b = qpk.shape[0]
    px = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5)[:, None]
    py = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5)[None, :]
    row_band = torch.arange(res, device=dev) // band_rows(res)

    def edge(coef, e, s):
        k = lambda j: coef[:, e, s:s + CHUNK, j][:, :, None, None]
        return warp.affine(k(0), px, k(1), py, k(2))     # (B, CHUNK, res, res)

    best = torch.full((b, res, res), SENTINEL, dtype=torch.int32, device=dev)
    for coef, pk, mask, n_edges in ((qcoef, qpk, qmask, 2),
                                    (tcoef, tpk, tmask, 3)):
        for s in range(0, pk.shape[1], CHUNK):
            e = [edge(coef, k, s) for k in range(n_edges)]
            if n_edges == 2:
                inside = torch.maximum(e[0].abs(), e[1].abs()) <= 0.5
            else:
                inside = torch.minimum(torch.minimum(e[0], e[1]), e[2]) >= 0
            vals = torch.minimum(best, torch.where(
                inside, pk[:, s:s + CHUNK, 0][:, :, None, None], SENTINEL).amin(dim=1))
            if mask is None:
                best = vals
            else:
                live = mask[:, :, 0, s // CHUNK][:, row_band] != 0     # (B, res)
                best = torch.where(live[:, :, None], vals, best)
    return best


def prim_tiles(res: int) -> int:
    """The primitive winner's 16 x 16 pixel tiles per camera, ``(res /
    16)^2``."""
    return (res // PRIM_TILE) ** 2


def edge_tile_range(coef: torch.Tensor, x_lo: torch.Tensor, x_hi: torch.Tensor,
                    y_lo: torch.Tensor, y_hi: torch.Tensor):
    """
    Plain version of ``csrc/prim_winner.cuh: edge_range``, the float64
    extremes of an affine value ``e = a*px + b*py + c`` over each tile's
    pixel centres and the cull's slack ``delta = 2^-20 (|a| x_hi + |b| y_hi
    + |c|) + 2^-149 [a != 0] + 2^-149 [b != 0]``, in the kernel's order of
    operations (so the same bits).

    Args:
        coef: (..., 3) float32 (a, b, c).
        x_lo, x_hi: (TX,) float64, each tile row's first and last pixel
            centre; y_lo, y_hi: (TY,) the same for each tile column.
    Returns:
        (top, bottom, delta), each (..., TX, TY) float64.
    """
    a, b, c = (coef[..., j].double()[..., None] for j in range(3))
    ax0, ax1, by0, by1 = a * x_lo, a * x_hi, b * y_lo, b * y_hi
    top = (torch.maximum(ax0, ax1)[..., :, None]
           + torch.maximum(by0, by1)[..., None, :]) + c[..., None]
    bottom = (torch.minimum(ax0, ax1)[..., :, None]
              + torch.minimum(by0, by1)[..., None, :]) + c[..., None]
    underflow = ((a != 0).double() + (b != 0).double()) * _CULL_UNDERFLOW
    delta = ((a.abs() * x_hi)[..., :, None] + (b.abs() * y_hi)[..., None, :]
             + c.abs()[..., None]) * _CULL_SLACK + underflow[..., None]
    return top, bottom, delta


def tri_edge_out_reference(coef: torch.Tensor, x_lo: torch.Tensor, x_hi: torch.Tensor,
                           y_lo: torch.Tensor, y_hi: torch.Tensor) -> torch.Tensor:
    """Plain version of ``csrc/prim_winner.cuh: tri_edge_out``: (..., TX,
    TY) whether the triangle edge ``coef`` (..., 3) is negative at every
    pixel of each tile, ``max e < -delta`` (arguments as
    :func:`edge_tile_range`). The primitive winner's cull and the hard
    raster's (``ops/hard.py: hard_tile_keep_reference``) both call it."""
    top, _, delta = edge_tile_range(coef, x_lo, x_hi, y_lo, y_hi)
    return top < -delta


def prim_tile_keep_reference(qcoef: torch.Tensor, qpk: torch.Tensor,
                             tcoef: torch.Tensor, tpk: torch.Tensor,
                             qmask: Optional[torch.Tensor],
                             tmask: Optional[torch.Tensor], res: int) -> torch.Tensor:
    """
    Plain version of the primitive winner's per-tile cull
    (``csrc/prim_winner.cuh``, whose header argues why it is exact): which
    primitives each 16 x 16 pixel tile tests. A primitive is dropped from a
    tile iff its pack is the sentinel, or its chunk's occupancy bit is 0 in
    every band the tile's rows meet, or one of its affine values ``e = a*px
    + b*py + c``, in float64 at the tile's four extreme pixel centres, has
    ``max e < -0.5 - delta`` or ``min e > 0.5 + delta`` (quads) or ``max e
    < -delta`` (triangles), ``delta = 2^-20 (|a| x_max + |b| y_max + |c|)
    + 2^-149 [a != 0] + 2^-149 [b != 0]``; the kernel's operations in its
    order, so the same bits. Not on any main path: the tests and
    ``chip_smoke.py`` use it.

    Args:
        qcoef / qpk / tcoef / tpk: as :func:`prep_prims` gives them.
        qmask / tmask: (B, J, 1, QP/8) / (B, J, 1, TP/8) occupancy, or None.
        res: a multiple of 16.
    Returns:
        (B, tiles, QP + TP) bool, tiles row-major (``prim_tiles(res)``),
        the quads first.
    """
    dev = qpk.device
    per = res // PRIM_TILE
    start = torch.arange(per, device=dev) * PRIM_TILE
    lo = start.double() + 0.5
    hi = lo + (PRIM_TILE - 1)
    rpb = band_rows(res)
    bands = torch.arange(res // rpb, device=dev)
    meets = (bands >= (start // rpb)[:, None]) \
        & (bands <= ((start + PRIM_TILE - 1) // rpb)[:, None])   # (per, J)

    def edge_out(coef, quad):            # (B, P, 3) -> (B, P, per, per)
        if not quad:
            return tri_edge_out_reference(coef, lo, hi, lo, hi)
        top, bottom, delta = edge_tile_range(coef, lo, hi, lo, hi)
        return (top < -0.5 - delta) | (bottom > 0.5 + delta)

    keeps = []
    for coef, pk, mask, n_edges in ((qcoef, qpk, qmask, 2), (tcoef, tpk, tmask, 3)):
        out = torch.zeros(pk.shape[:2] + (per, per), dtype=torch.bool, device=dev)
        for e in range(n_edges):
            out |= edge_out(coef[:, e], n_edges == 2)
        keep = ~out & (pk[..., 0] != SENTINEL)[..., None, None]
        if mask is not None:
            live = mask[:, :, 0].repeat_interleave(CHUNK, dim=2) != 0    # (B, J, P)
            tile_live = (live[:, None] & meets[None, :, :, None]).any(dim=2)
            keep &= tile_live.transpose(1, 2)[..., None]                  # (B, P, per, 1)
        keeps.append(keep.flatten(2).transpose(1, 2))
    return torch.cat(keeps, dim=2)


def raster_prims_reference(qcoef: torch.Tensor, qpk: torch.Tensor,
                           tcoef: torch.Tensor, tpk: torch.Tensor,
                           background: torch.Tensor, res: int,
                           qmask: Optional[torch.Tensor] = None,
                           tmask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: where the winner is below
    ``127 << 24`` its RGB8 times float32(1/255), else the background. Same
    contract and same bits as :func:`raster_prims`."""
    best = prim_winner_reference(qcoef, qpk, tcoef, tpk, qmask, tmask, res)
    rgb = torch.stack([(best >> 16) & 255, (best >> 8) & 255, best & 255], dim=1)
    return torch.where((best < (127 << 24))[:, None],
                       rgb.to(torch.float32) * _INV255, background)


def _check(qcoef, qpk, tcoef, tpk, background, res, qmask, tmask) -> None:
    b = qpk.shape[0]
    qp, tp = qpk.shape[1], tpk.shape[1]
    if res < 16 or res % 16:
        raise ValueError(f'res must be a positive multiple of 16, got {res}')
    band_rows(res)
    if qp % CHUNK or tp % CHUNK or not qp or not tp:
        raise ValueError(f'prim counts must be positive multiples of {CHUNK}: '
                         f'{qp}, {tp}')
    if (qmask is None) != (tmask is None):
        raise ValueError('give both occupancy masks or neither')
    want = {
        'qcoef': (qcoef, torch.float32, (b, 2, qp, 3)),
        'qpk': (qpk, torch.int32, (b, qp, 1)),
        'tcoef': (tcoef, torch.float32, (b, 3, tp, 3)),
        'tpk': (tpk, torch.int32, (b, tp, 1)),
        'background': (background, torch.float32, (b, 3, res, res)),
    }
    if qmask is not None:
        n_bands = res // band_rows(res)
        want['qmask'] = (qmask, torch.int32, (b, n_bands, 1, qp // CHUNK))
        want['tmask'] = (tmask, torch.int32, (b, n_bands, 1, tp // CHUNK))
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f'{name}: expected {dtype} {shape}, got '
                             f'{t.dtype} {tuple(t.shape)}')
        if t.device != qpk.device:
            raise ValueError(f'{name} is on {t.device}, qpk on {qpk.device}')
    if qpk.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no prim raster for device {qpk.device}')
    if b > 65535:
        raise ValueError(f'at most 65535 cameras per launch, got {b}')


def _background_strides(background: torch.Tensor, res: int):
    """(tensor, batch, channel and pixel strides) through which the kernel
    reads ``background``: a contiguous pixel plane (pixel stride 1) or one
    value per camera and channel broadcast over the plane (pixel stride 0);
    any other layout is made contiguous."""
    s = background.stride()
    if s[2:] == (res, 1):
        return background, s[0], s[1], 1
    if s[2:] == (0, 0):
        return background, s[0], s[1], 0
    background = background.contiguous()
    return background, *background.stride()[:2], 1


def _launch(lib: ctypes.CDLL, ptrs, batch: int, res: int, qp: int, tp: int,
            bg_strides, out_ptr: int, stream: int) -> int:
    """Call the entry point; returns its CUDA error code."""
    return lib.tds_prim_raster(*ptrs, batch, res, band_rows(res), qp, tp,
                               *bg_strides, out_ptr, stream)


def raster_prims(qcoef: torch.Tensor, qpk: torch.Tensor, tcoef: torch.Tensor,
                 tpk: torch.Tensor, background: torch.Tensor, res: int,
                 qmask: Optional[torch.Tensor] = None,
                 tmask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """
    The prim raster on prepared operands: B7 with occupancy masks, B8
    without (every chunk in every band).

    Args:
        qcoef / qpk / tcoef / tpk: as :func:`prep_prims` gives them.
        background: (B, 3, res, res) float32 in [0, 1]; may be an expanded
            view (pixel strides 0).
        res: a multiple of 16 (any size with a band tiling).
        qmask / tmask: (B, J, 1, QP/8) / (B, J, 1, TP/8) int32 occupancy,
            J = res / band_rows(res), or None.
    Returns:
        (B, 3, res, res) float32 in [0, 1].
    """
    _check(qcoef, qpk, tcoef, tpk, background, res, qmask, tmask)
    if qpk.device.type == 'cpu':
        return raster_prims_reference(qcoef, qpk, tcoef, tpk, background, res,
                                      qmask, tmask)
    b = qpk.shape[0]
    background, *bg_strides = _background_strides(background, res)
    out = torch.empty((b, 3, res, res), dtype=torch.float32, device=qpk.device)
    operands = [t.contiguous() for t in (qcoef, qpk, tcoef, tpk)]
    masks = [m.contiguous() for m in (qmask, tmask)] if qmask is not None else None
    ptrs = [t.data_ptr() for t in operands] \
        + ([m.data_ptr() for m in masks] if masks else [None, None]) \
        + [background.data_ptr()]
    with torch.cuda.device(qpk.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launch(LIBRARY.load(), ptrs, b, res, qpk.shape[1], tpk.shape[1],
                      bg_strides, out.data_ptr(), stream)
    check_launch(err, 'prim raster')
    tracing.count('launch.B7' if masks else 'launch.B8')
    return out


def _pad_masks(mask: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Pad the chunk axis to the padded prim count's chunks (padded prims
    are dead)."""
    pad = n_chunks - mask.shape[3]
    if pad == 0:
        return mask
    return torch.cat([mask, mask.new_zeros(mask.shape[:3] + (pad,))], dim=3)


def _banded(raster, quads, qz, qcolors, tris, tz, tcolors, res, background,
            qmask, tmask):
    qcoef, qpk, tcoef, tpk = prep_prims(quads, qz, qcolors, tris, tz, tcolors)
    return raster(qcoef, qpk, tcoef, tpk, background, res,
                  _pad_masks(qmask, qpk.shape[1] // CHUNK),
                  _pad_masks(tmask, tpk.shape[1] // CHUNK))


def rasterize_hard_prims_banded(quads: torch.Tensor, qz: torch.Tensor,
                                qcolors: torch.Tensor, tris: torch.Tensor,
                                tz: torch.Tensor, tcolors: torch.Tensor,
                                res: int, background: torch.Tensor,
                                qmask: torch.Tensor, tmask: torch.Tensor
                                ) -> torch.Tensor:
    """
    Hard z-priority raster of row-major-sorted prims with band x chunk
    occupancy masks (B7), as the reference's
    ``rasterize_hard_pallas_prims_banded``.

    Args:
        quads: (B, Q, 4, 2) screen corners in cycle order, sorted by
            ``sort_prims_rowmajor_with_masks``; qz: (B, Q); qcolors:
            (B, Q, 3); tris / tz / tcolors likewise.
        background: (B, 3, res, res) channels-first, possibly expanded.
        qmask / tmask: (B, J, 1, ceil(Q/8)) / (B, J, 1, ceil(T/8)) int32.
    Returns:
        (B, 3, res, res) image in [0, 1].
    """
    return _banded(raster_prims, quads, qz, qcolors, tris, tz, tcolors, res,
                   background, qmask, tmask)


def rasterize_hard_prims_banded_reference(quads, qz, qcolors, tris, tz, tcolors,
                                          res, background, qmask, tmask):
    """:func:`rasterize_hard_prims_banded` on the plain version."""
    return _banded(raster_prims_reference, quads, qz, qcolors, tris, tz, tcolors,
                   res, background, qmask, tmask)


def rasterize_hard_prims(quads: torch.Tensor, qz: torch.Tensor,
                         qcolors: torch.Tensor, tris: torch.Tensor,
                         tz: torch.Tensor, tcolors: torch.Tensor, res: int,
                         background: torch.Tensor) -> torch.Tensor:
    """
    Hard z-priority raster of any typed prims over ``background`` (B8), as
    the reference's ``rasterize_hard_pallas_prims``: every prim is tested
    at every pixel. Arguments as :func:`rasterize_hard_prims_banded`
    without the masks; the prims need no order.
    """
    return raster_prims(*prep_prims(quads, qz, qcolors, tris, tz, tcolors),
                        background, res)


def rasterize_hard_prims_reference(quads, qz, qcolors, tris, tz, tcolors, res,
                                   background):
    """:func:`rasterize_hard_prims` on the plain version."""
    return raster_prims_reference(*prep_prims(quads, qz, qcolors, tris, tz, tcolors),
                                  background, res)


def random_prims(seed: int, b: int, q: int, t: int, res: int, device,
                 z_levels: int = 4, rows=None):
    """
    A random screen-space scene for holding the kernels against their plain
    versions: parallelograms and triangles over the view and a little
    beyond, z on ``z_levels`` levels (ties), two quads sharing a top row,
    every seventh quad and fifth triangle degenerate, some prims wholly off
    screen, the last quad absent (all zero); a random background.
    ``rows = (lo, hi)`` squeezes the quads' rows into that range (a dense
    band).

    Returns:
        (quads (B, Q, 4, 2), qz (B, Q), qcolors (B, Q, 3), tris (B, T, 3, 2),
         tz (B, T), tcolors (B, T, 3), background (B, 3, res, res)), float32
        on ``device``.
    """
    rng = np.random.RandomState(seed)
    c0 = rng.uniform(-0.1 * res, 1.05 * res, (b, q, 2))
    e1 = rng.uniform(-0.2, 0.2, (b, q, 2)) * res
    e2 = rng.uniform(-0.2, 0.2, (b, q, 2)) * res
    quads = np.stack([c0, c0 + e1, c0 + e1 + e2, c0 + e2], axis=2)
    if rows is not None:
        lo, hi = rows
        r = quads[..., 0]
        rmin, rmax = r.min(-1, keepdims=True), r.max(-1, keepdims=True)
        quads[..., 0] = lo + (r - rmin) / (rmax - rmin + 1e-3) * min(4.0, hi - lo) \
            + rng.uniform(0, max(hi - lo - 4.0, 0.0), (b, q, 1))
    tris = rng.uniform(-0.1 * res, 1.1 * res, (b, t, 3, 2))
    if q > 4:
        quads[:, 3, :, 0] += quads[:, 4, :, 0].min(-1, keepdims=True) \
            - quads[:, 3, :, 0].min(-1, keepdims=True)
    quads[:, 1::7] = quads[:, 1::7, :1]
    tris[:, 2::5, 2] = tris[:, 2::5, 0]
    quads[:, 2::9] += 3.0 * res
    tris[:, 1::6] -= 2.0 * res
    if q > 6:
        quads[:, -1] = 0.0
    z = lambda n: rng.randint(0, z_levels, (b, n)) * 2.0 + 3.0
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return (f(quads), f(z(q)), f(rng.rand(b, q, 3)), f(tris), f(z(t)),
            f(rng.rand(b, t, 3)), f(rng.rand(b, 3, res, res)))
