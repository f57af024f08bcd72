"""
The plain hard raster of per-face arrays with float colors, exactly as the
reference computes it (``torchdrivesim_tpu/ops/rasterize.py:
rasterize_hard_faces`` and its rectangular ``_rasterize_hard_rect``), over
an H x W frame.

The reference runs it as XLA code; here it is a hand-written CUDA kernel
(HF, ``csrc/hard_faces.cu``) on CUDA tensors and its plain PyTorch version
:func:`hard_faces_reference` on CPU tensors. It serves the differentiable
primitive render, the differentiable face soup and the map texture bake.
The packed and chunked hard rasters (``ops/hard.py``) have other semantics
(RGB8 colors, one winding, z ties to the least RGB8) and cannot stand in.

A face covers a pixel centre ``(row + 0.5, col + 0.5)`` where its three edge
values (:func:`edge_value`) are all >= 0 or all <= 0 and ``|area| > 1e-9``;
the pixel takes the color of the covering face of least z, the first in
face order among equal z (a strict ``<`` against a minimum that starts at
:data:`BIG_Z`: a NaN z or one >= :data:`BIG_Z` never wins), else the
background.

:func:`rasterize_hard_faces` is the differentiable function: gradients reach
the background where no face wins and each face's color summed over the
pixels it wins, as autograd through the plain ``torch.where`` chain gives
them; corners and z get none.

The kernel sets each face up once, bins it into the 16 x 16 tiles of a
conservative box (:func:`face_tile_ranges`) that pass a float64 edge test,
and folds each tile's list in ascending face order; its plain mirror is
:func:`hard_faces_tile_lists_reference`, and :func:`hard_faces_cover_reference`
gives the (tile, face) pairs in which a face covers a pixel centre, the work
these inputs need.
"""
import ctypes

import torch

from torchdrivesim_tpu_torch import tracing
from torchdrivesim_tpu_torch.ops.build import KernelLibrary, check_launch

BIG_Z = 1e9
DEGENERATE_AREA_EPS = 1e-9
#: faces whose edge values the plain version evaluates together
FACE_CHUNK = 16
#: pixels per side of the kernel's tiles
TILE = 16
#: 3.1 x 2^-24 and 2^-140, the float64 cull's error terms (``csrc/hard_faces.cu``)
_CULL_ERR, _CULL_TINY = 3.1 * 2.0 ** -24, 2.0 ** -140
#: the box margin's terms (``csrc/hard_faces.cu`` derives them): 4.1 u per
#: unit of |P| + |Q|, twice that per unit of distance, 2^-140; the float64
#: area's relative error 2^-48; the margin's relative and absolute pads
_BOX_ERR, _BOX_SLOPE, _BOX_TINY = 4.1 * 2.0 ** -24, 8.2 * 2.0 ** -24, 2.0 ** -140
_AREA_REL, _PAD_REL, _PAD_ABS = 2.0 ** -48, 1.0 + 2.0 ** -40, 2.0 ** -48
#: the most faces a tile's list holds (``kListCap`` in ``csrc/hard_faces.cu``);
#: a tile with more takes the kernel's ordered scan of all faces
LIST_CAP = 512


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures (``csrc/hard_faces.cu``): the
    raster (corners, z, color and background pointers; batch, faces,
    height, width, list capacity; the records, counts, lists, image and
    winner pointers and the stream) and its binning alone (corners and z;
    the five ints; records, counts, lists and the stream)."""
    fn = lib.tds_hard_faces
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    fn = lib.tds_hard_faces_bin
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return lib


LIBRARY = KernelLibrary('hard_faces.cu', _bind)


def edge_value(ex: torch.Tensor, dy: torch.Tensor, ey: torch.Tensor,
               dx: torch.Tensor) -> torch.Tensor:
    """``ex * dy - ey * dx`` in float32, each operation rounded on its own,
    as the kernel spells it with round-to-nearest intrinsics. (The
    reference's compiled CPU code may fuse one product into the difference;
    the parity tests render under those roundings too.)"""
    return ex * dy - ey * dx


def _face_edges(corners: torch.Tensor):
    """Each face's edges as (a0, a1, ex, ey) (B, F, 3) each and its area
    (B, F), rounded as the reference rounds them."""
    a = corners
    b = corners[..., [1, 2, 0], :]
    ex = b[..., 0] - a[..., 0]
    ey = b[..., 1] - a[..., 1]
    area = edge_value(ex[..., 0], a[..., 2, 1] - a[..., 0, 1],
                      ey[..., 0], a[..., 2, 0] - a[..., 0, 0])
    return a[..., 0], a[..., 1], ex, ey, area


def _usable(area: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(B, F) whether a face can win anywhere: its area test passes and its
    z is below :data:`BIG_Z` (float32 thresholds, as the reference compares)."""
    eps = torch.tensor(DEGENERATE_AREA_EPS, dtype=area.dtype, device=area.device)
    big = torch.tensor(BIG_Z, dtype=z.dtype, device=z.device)
    return (torch.abs(area) > eps) & (z < big)


def hard_faces_reference(corners: torch.Tensor, z: torch.Tensor, color: torch.Tensor,
                         background: torch.Tensor):
    """
    Plain PyTorch version of the kernel: the reference's chain of
    ``torch.where`` over the faces in order, :data:`FACE_CHUNK` at a time.

    Args:
        corners: (B, F, 3, 2) screen corners (row, col); z: (B, F);
        color: (B, F, 3); background: (B, 3, H, W).
    Returns:
        (image (B, 3, H, W), winner (B, H, W) int32, -1 for the background).
    """
    b, f = z.shape
    h, w = background.shape[-2:]
    dev, dt = corners.device, corners.dtype
    px = (torch.arange(h, dtype=dt, device=dev) + 0.5)[:, None].expand(h, w)
    py = (torch.arange(w, dtype=dt, device=dev) + 0.5)[None, :].expand(h, w)
    a0, a1, ex, ey, area = _face_edges(corners)
    ok = _usable(area, z)
    best_z = corners.new_full((b, h, w), BIG_Z)
    best = background
    winner = torch.full((b, h, w), -1, dtype=torch.int32, device=dev)
    sl = lambda t, lo: t[:, lo:lo + FACE_CHUNK, :, None, None]
    for lo in range(0, f, FACE_CHUNK):
        e = edge_value(sl(ex, lo), py - sl(a1, lo), sl(ey, lo), px - sl(a0, lo))
        cover = ((e >= 0).all(dim=2) | (e <= 0).all(dim=2)) \
            & ok[:, lo:lo + FACE_CHUNK, None, None]
        for i in range(cover.shape[1]):
            zval = torch.where(cover[:, i], z[:, lo + i, None, None], BIG_Z)
            better = zval < best_z
            best_z = torch.where(better, zval, best_z)
            best = torch.where(better[:, None], color[:, lo + i, :, None, None], best)
            winner = torch.where(better, lo + i, winner)
    return best, winner


def hard_faces_tile_keep_reference(corners: torch.Tensor, z: torch.Tensor,
                                   height: int, width: int) -> torch.Tensor:
    """
    Plain version of the kernel's float64 per-tile edge test
    (``csrc/hard_faces.cu``) over every tile, without the box: a face stays
    in a 16 x 16 tile unless its area test fails, its z is not below
    :data:`BIG_Z`, or one of its edges is negative and one positive at
    every pixel centre of the tile by the float64 test over the tile's four
    extreme centres (the last tile row and column clamped to the frame). Not
    on any path: the tests show with it that a dropped face wins no pixel of
    its tile, and that the kernel's lists keep a subset of its pairs.

    Returns:
        (B, tiles, F) bool, tiles row-major (``ceil(H / 16) x ceil(W / 16)``).
    """
    edges = _face_edges(corners)
    ok = _usable(edges[4], z)
    a0, a1, ex, ey = (t.double()[..., None, None, :] for t in edges[:4])  # (B, F, 1, 1, 3)
    r0 = torch.arange(0, height, TILE, device=corners.device).double()
    c0 = torch.arange(0, width, TILE, device=corners.device).double()
    rows = (r0 + 0.5, torch.clamp(r0 + TILE, max=height) - 0.5)     # (th,) each
    cols = (c0 + 0.5, torch.clamp(c0 + TILE, max=width) - 0.5)      # (tw,) each
    keep = _edge_test_keeps(a0, a1, ex, ey, [r[:, None, None] for r in rows],
                            [c[:, None] for c in cols])             # (B, F, th, tw)
    keep = keep & ok[..., None, None]
    return keep.flatten(2).transpose(1, 2)


def _edge_test_keeps(a0, a1, ex, ey, rows, cols) -> torch.Tensor:
    """The float64 per-tile edge test (``csrc/hard_faces.cu``): false where
    one edge is certainly negative and one certainly positive at every
    pixel centre between the first and last centre rows ``rows`` and
    columns ``cols`` of the tile, padded by the float32 edge's error bound.
    The edges (a0, a1, ex, ey) run along the last dimension; every operand
    float64 and broadcastable."""
    neg = pos = None
    for px in rows:
        for py in cols:
            p = ex * (py - a1)
            q = ey * (px - a0)
            v = p - q
            err = _CULL_ERR * (p.abs() + q.abs()) + _CULL_TINY
            n, s = v + err < 0, v - err > 0
            neg = n if neg is None else neg & n
            pos = s if pos is None else pos & s
    return ~(neg.any(dim=-1) & pos.any(dim=-1))


def face_tile_ranges(corners: torch.Tensor, z: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """
    Each face's conservative range of 16 x 16 tiles, as the kernel's set-up
    computes it (float64, operation by operation): the corners' box widened
    on every side by the margin that ``csrc/hard_faces.cu`` derives from the
    edges' rounding error, outside which no pixel centre passes HF's rounded
    edge test; the whole frame for a face with a non-finite corner or too
    thin for a finite margin; empty for one whose area or z test fails.

    Returns:
        (B, F, 4) int64: first and last tile row, first and last tile column
        (an empty range has first > last).
    """
    c = corners.double()
    r, q = c[..., 0], c[..., 1]                                       # (B, F, 3)
    rmin, rmax = r.amin(-1), r.amax(-1)
    cmin, cmax = q.amin(-1), q.amax(-1)
    sr, sc = rmax - rmin, cmax - cmin
    x, y = r[..., [1, 2, 0]] - r, q[..., [1, 2, 0]] - q
    m = torch.maximum(x.abs().amax(-1), y.abs().amax(-1))
    p = x[..., 0] * (q[..., 2] - q[..., 0])
    s = y[..., 0] * (r[..., 2] - r[..., 0])
    a_lo = 0.5 * ((p - s).abs() - _AREA_REL * (p.abs() + s.abs()))
    den = a_lo / torch.maximum(sr, sc) - _BOX_SLOPE * m
    num = _BOX_ERR * m * (sr + sc) + _BOX_TINY
    reach = torch.maximum(torch.maximum(rmin.abs(), rmax.abs()),
                          torch.maximum(cmin.abs(), cmax.abs())) + 1.0
    d = num / den * _PAD_REL + reach * _PAD_ABS
    whole = ~torch.isfinite(c).flatten(-2).all(-1) | ~(den > 0)
    lo_r = torch.ceil(rmin - d - 0.5).clamp(min=0.0)
    hi_r = torch.floor(rmax + d - 0.5).clamp(max=height - 1.0)
    lo_c = torch.ceil(cmin - d - 0.5).clamp(min=0.0)
    hi_c = torch.floor(cmax + d - 0.5).clamp(max=width - 1.0)
    full = torch.tensor([0.0, height - 1.0, 0.0, width - 1.0], dtype=c.dtype,
                        device=c.device)
    px = torch.where(whole[..., None], full, torch.stack([lo_r, hi_r, lo_c, hi_c], -1))
    empty = ~_usable(_face_edges(corners)[4], z) | (px[..., 0] > px[..., 1]) \
        | (px[..., 2] > px[..., 3])
    tiles = torch.div(px.long(), TILE, rounding_mode='floor')
    return torch.where(empty[..., None], torch.tensor([1, 0, 1, 0], device=c.device), tiles)


def _listed_pairs(corners: torch.Tensor, z: torch.Tensor, height: int, width: int):
    """(camera, face, tile) index vectors of the pairs the kernel lists:
    the tile in the face's :func:`face_tile_ranges` and not dropped by the
    float64 edge test of :func:`hard_faces_tile_keep_reference`."""
    b, f = z.shape
    dev = corners.device
    tiles_w = -(-width // TILE)
    rng = face_tile_ranges(corners, z, height, width).reshape(-1, 4)
    nr = (rng[:, 1] - rng[:, 0] + 1).clamp(min=0)
    nc = (rng[:, 3] - rng[:, 2] + 1).clamp(min=0)
    n = nr * nc
    owner = torch.repeat_interleave(torch.arange(b * f, device=dev), n)
    k = torch.arange(owner.numel(), device=dev) - (torch.cumsum(n, 0) - n)[owner]
    tr = rng[owner, 0] + torch.div(k, nc[owner], rounding_mode='floor')
    tc = rng[owner, 2] + k % nc[owner].clamp(min=1)
    r0, c0 = (tr * TILE).double(), (tc * TILE).double()
    rows = (r0 + 0.5, torch.clamp(r0 + TILE, max=height) - 0.5)       # (pairs,) each
    cols = (c0 + 0.5, torch.clamp(c0 + TILE, max=width) - 0.5)
    a0, a1, ex, ey = (t.reshape(b * f, 3)[owner].double() for t in _face_edges(corners)[:4])
    keep = _edge_test_keeps(a0, a1, ex, ey, [r[:, None] for r in rows],
                            [c[:, None] for c in cols])
    owner = owner[keep]
    return (torch.div(owner, f, rounding_mode='floor'), owner % f,
            (tr * tiles_w + tc)[keep])


def hard_faces_tile_lists_reference(corners: torch.Tensor, z: torch.Tensor,
                                    height: int, width: int):
    """
    Plain version of the kernel's binning (``csrc/hard_faces.cu``): each 16 x
    16 tile's list of the faces whose :func:`face_tile_ranges` holds the tile
    and that the float64 edge test of :func:`hard_faces_tile_keep_reference`
    keeps there, in ascending face order. Not on any path: the tests hold
    the kernel's lists to it (as sets) and show that no face covering a
    pixel centre of a tile is missing from the tile's list.

    Returns:
        (lists (B, tiles, L) int32 ascending, padded with -1, L the longest
        list; counts (B, tiles) int32), tiles row-major.
    """
    b, f = z.shape
    tiles = -(-height // TILE) * -(-width // TILE)
    cam, face, tile = _listed_pairs(corners, z, height, width)
    cell = cam * tiles + tile
    order = torch.argsort(cell * max(f, 1) + face)
    cell, face = cell[order], face[order]
    counts = torch.bincount(cell, minlength=b * tiles)
    slot = torch.arange(cell.numel(), device=cell.device) - (torch.cumsum(counts, 0)
                                                             - counts)[cell]
    width_l = int(counts.max()) if counts.numel() else 0
    lists = torch.full((b * tiles, width_l), -1, dtype=torch.int32, device=corners.device)
    lists[cell, slot] = face.to(torch.int32)
    return lists.reshape(b, tiles, width_l), counts.reshape(b, tiles).to(torch.int32)


def hard_faces_cover_reference(corners: torch.Tensor, z: torch.Tensor, height: int,
                               width: int, chunk: int = 8192):
    """
    The (camera, face, tile) pairs in which the face covers at least one
    pixel centre of the 16 x 16 tile under HF's rounding (:func:`edge_value`)
    and passes its area and z tests: the pairs whose fold the inputs need,
    whatever implements it. Evaluated over the listed pairs
    (:func:`hard_faces_tile_lists_reference`'s, which hold every covering
    pair), ``chunk`` pairs at a time.

    Returns:
        (camera, face, tile) int64 index vectors.
    """
    b, f = z.shape
    tiles_w = -(-width // TILE)
    cam, face, tile = _listed_pairs(corners, z, height, width)
    edges = [t.reshape(b * f, 3) for t in _face_edges(corners)[:4]]
    offs = torch.arange(TILE, device=corners.device)
    kept = []
    for lo in range(0, cam.numel(), chunk):
        sl = slice(lo, lo + chunk)
        g = cam[sl] * f + face[sl]
        rows = torch.div(tile[sl], tiles_w, rounding_mode='floor')[:, None] * TILE + offs
        cols = (tile[sl] % tiles_w)[:, None] * TILE + offs                  # (n, 16) each
        px = (rows.to(corners.dtype) + 0.5)[:, None, :, None]
        py = (cols.to(corners.dtype) + 0.5)[:, None, None, :]
        a0, a1, ex, ey = (t[g][..., None, None] for t in edges)             # (n, 3, 1, 1)
        e = edge_value(ex, py - a1, ey, px - a0)                            # (n, 3, 16, 16)
        inside = (rows < height)[:, :, None] & (cols < width)[:, None, :]
        cover = (((e >= 0).all(dim=1) | (e <= 0).all(dim=1)) & inside).flatten(1).any(-1)
        kept.append(cover)
    keep = torch.cat(kept) if kept else torch.zeros(0, dtype=torch.bool,
                                                   device=corners.device)
    return cam[keep], face[keep], tile[keep]


def list_capacity(n_faces: int) -> int:
    """The kernel's per-tile list length for ``n_faces`` faces."""
    return min(n_faces, LIST_CAP)


def scratch_bytes(b: int, n_faces: int, height: int, width: int) -> int:
    """The kernel's scratch on these shapes: a 64-byte record per face, a
    count and :func:`list_capacity` face indices per tile."""
    tiles = -(-height // TILE) * -(-width // TILE)
    return b * n_faces * 64 + b * tiles * 4 * (1 + list_capacity(n_faces))


def _check(corners, z, color, background) -> None:
    b, f = z.shape
    h, w = background.shape[-2:]
    want = [('corners', corners, (b, f, 3, 2)), ('z', z, (b, f)),
            ('color', color, (b, f, 3)), ('background', background, (b, 3, h, w))]
    for name, t, shape in want:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f'{name}: expected float32 {shape}, got {t.dtype} '
                             f'{tuple(t.shape)}')
        if t.device != corners.device:
            raise ValueError(f'{name} is on {t.device}, corners on {corners.device}')
    if corners.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no hard face raster for device {corners.device}')
    if b > 65535:
        raise ValueError(f'at most 65535 cameras per launch, got {b}')
    if max(h, w) > 65535 * TILE:
        raise ValueError(f'at most {65535 * TILE} pixels a side, got {h} x {w}')


def hard_faces(corners: torch.Tensor, z: torch.Tensor, color: torch.Tensor,
               background: torch.Tensor):
    """The kernel (HF) on CUDA tensors, :func:`hard_faces_reference` on CPU
    tensors; float32 operands as there. Returns (image (B, 3, H, W),
    winner (B, H, W) int32). Reads nothing back from the card: its scratch
    (:func:`scratch_bytes`) is sized from the shapes alone."""
    _check(corners, z, color, background)
    if corners.device.type == 'cpu':
        return hard_faces_reference(corners, z, color, background)
    b, f = z.shape
    h, w = background.shape[-2:]
    dev = corners.device
    tiles = -(-h // TILE) * -(-w // TILE)
    cap = list_capacity(f)
    out = torch.empty((b, 3, h, w), dtype=torch.float32, device=dev)
    winner = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    records = torch.empty((b, f, 16), dtype=torch.float32, device=dev)
    counts = torch.empty((b, tiles), dtype=torch.int32, device=dev)
    lists = torch.empty((b, tiles, cap), dtype=torch.int32, device=dev)
    operands = [t.contiguous() for t in (corners, z, color, background)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = LIBRARY.load().tds_hard_faces(
            *[t.data_ptr() for t in operands], b, f, h, w, cap,
            *[t.data_ptr() for t in (records, counts, lists, out, winner)], stream)
    check_launch(err, 'tds_hard_faces')
    tracing.count('launch.HF')
    return out, winner


class HardFaces(torch.autograd.Function):
    """:func:`hard_faces` with the gradients of the plain ``torch.where``
    chain: the background's where no face wins, each face color's summed
    over the pixels it wins (a scatter-add, so the card's sums may round in
    another order); none to the corners and z."""

    @staticmethod
    def forward(ctx, corners, z, color, background):
        image, winner = hard_faces(corners, z, color, background)
        ctx.save_for_backward(winner)
        ctx.n_faces = z.shape[1]
        ctx.mark_non_differentiable(winner)
        return image, winner

    @staticmethod
    def backward(ctx, g, _):
        with tracing.span('render.backward'):
            (winner,) = ctx.saved_tensors
            won = (winner >= 0)[:, None]
            g_bg = torch.where(won, torch.zeros_like(g), g) \
                if ctx.needs_input_grad[3] else None
            g_color = None
            if ctx.needs_input_grad[2]:
                b = g.shape[0]
                idx = winner.clamp(min=0).reshape(b, -1, 1).long().expand(-1, -1, 3)
                src = torch.where(won, g, torch.zeros_like(g))
                src = src.reshape(b, 3, -1).transpose(1, 2)
                g_color = g.new_zeros((b, ctx.n_faces, 3)).scatter_add_(1, idx, src)
            return None, None, g_color, g_bg


def rasterize_hard_faces(corners: torch.Tensor, z: torch.Tensor, color: torch.Tensor,
                         background: torch.Tensor) -> torch.Tensor:
    """
    The reference's plain hard raster of per-face arrays, channels first,
    differentiable in the colors and the background.

    Args:
        corners: (B, F, 3, 2) screen corners (row, col); z: (B, F) priority
            (lower on top); color: (B, F, 3); background: (B, 3, H, W).
    Returns:
        (B, 3, H, W).
    """
    return HardFaces.apply(corners, z, color, background)[0]
