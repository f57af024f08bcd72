"""
Differentiable softmax-blend soft rasterization of any number of faces per
camera (counterpart of ``torchdrivesim_tpu/ops/pallas_soft.py``): up to
``MAX_FACES`` faces at up to 128 pixels through one kernel pair that also
composites (the reference's single-group path), more faces or larger views
through the grouped accumulators (its grouped path).

Per pixel each face contributes soft coverage ``alpha = prod_e sigmoid(t_e)
* ramp(min_e t_e)``, with ``t_e`` the signed pixel distance to edge ``e``
over ``sigma``; faces resolve by softmax over ``alpha * exp(-z / gamma)``
and the total coverage ``1 - prod_f (1 - alpha_f)`` lerps against the
background.

The autograd boundary is the reference's custom VJP: (edge coefficients,
z weights, colors, background). Everything upstream (vertex gather, edge
normalisation, degenerate-face masking: :func:`soft_coefficients`) is plain
differentiable PyTorch, so gradients flow to vertices and camera pose.
:func:`soft_raster_fwd` and :func:`soft_raster_bwd` launch the hand-written
CUDA kernels (``csrc/soft_raster.cu``), :func:`soft_accum_fwd` and
:func:`soft_accum_bwd` those of the grouped path (``csrc/soft_accum.cu``),
for CUDA tensors, and run the plain PyTorch versions for CPU tensors.
Each block of either pair covers one 16 x 16 pixel tile and first lists the
faces that can reach it, skipping the rest, which add exactly 0 there
(:func:`soft_tile_lists_reference`).

The grouped path pads the faces to whole ``MAX_FACES`` groups (padding rows:
coefficients 0 except C = -1e9, z weight 0, color 0, so alpha is exactly 0)
and maps them to the totals (num, den, transp): each group's partials start
from 0, 0, 1 and take its faces in ascending order, and the groups combine
as the reference's XLA does, ``num + n_g``, ``den + d_g``, ``transp * t_g``
for g = 0, 1, ... One kernel launch covers every group. The composite is
plain differentiable PyTorch, as in the reference. The grouped pair's plain
versions fold, per 16 x 16 tile and group, only the faces the plain cull
lists, bit for bit the fold of every face over every pixel
(``soft_accum_*_facewise``).
"""
import ctypes
from typing import Tuple

import torch

from torchdrivesim_tpu_torch import tracing
from torchdrivesim_tpu_torch.ops.build import KernelLibrary, check_launch
from torchdrivesim_tpu_torch.ops.rasterize import DEGENERATE_AREA_EPS, face_arrays
from torchdrivesim_tpu_torch.ops.warp import affine

#: faces per camera the single-group kernels take, and the group size of
#: the grouped path (the reference's constant)
MAX_FACES = 128

#: pixels per side of the block tiles of both kernel pairs
#: (csrc/soft_face.cuh: kTile)
ACCUM_TILE = 16
#: the cull's slack: an edge is dropped only below -4 - 2^-20 x its terms
_CULL_SLACK = 2.0 ** -20


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures (see ``csrc/soft_raster.cu``):
    forward: coef, zw, color, bg pointers; batch, faces, res; out, stream;
    backward: coef, zw, color, bg, g pointers; batch, faces, res; partial,
    gbg, counters, gcoef, gzw, gcolor, stream; occupancy: faces, int out[8]."""
    fwd = lib.tds_soft_raster_fwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.tds_soft_raster_bwd
    bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 7
    bwd.restype = ctypes.c_int
    occ = lib.tds_soft_raster_occupancy
    occ.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    return lib


LIBRARY = KernelLibrary('soft_raster.cu', _bind)


def occupancy(n_faces: int):
    """((registers per thread, resident blocks per SM, spill bytes per
    thread, shared bytes per block) of the forward kernel, the same of the
    backward) at ``n_faces`` faces per camera."""
    out = (ctypes.c_int * 8)()
    check_launch(LIBRARY.load().tds_soft_raster_occupancy(n_faces, out),
                 'soft raster occupancy query')
    return tuple(out[:4]), tuple(out[4:])


def _bind_accum(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the grouped entry points' signatures (see
    ``csrc/soft_accum.cu``): forward: coef, zw, color pointers; batch,
    faces, group, res; list, counts, num, den, transp, stream; backward:
    coef, zw, color, gnum, gden, gtransp pointers; batch, faces, group, res;
    list, counts, scratch, partial, stream."""
    fwd = lib.tds_soft_accum_fwd
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 6
    fwd.restype = ctypes.c_int
    bwd = lib.tds_soft_accum_bwd
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 5
    bwd.restype = ctypes.c_int
    return lib


ACCUM_LIBRARY = KernelLibrary('soft_accum.cu', _bind_accum)


def soft_coefficients(verts: torch.Tensor, faces: torch.Tensor,
                      attrs: torch.Tensor, sigma: float, gamma: float):
    """
    Per-face normalised edge coefficients ``t_e(p) = A*px + B*py + C`` (the
    sigmoid argument: signed pixel distance over ``sigma``), z weights and
    colors, as differentiable PyTorch (the reference's
    ``_soft_coefficients``). Degenerate faces get C = -1e9 so their coverage
    and gradients vanish in the kernel.

    Args:
        verts: (B, V, 3) screen (row, col, priority z); faces: (B, F, 3);
        attrs: (B, V, 3) colors.
    Returns:
        (coef (B, F, 3, 3) [face, edge, (A, B, C)], zw (B, F), color (B, F, 3)).
    """
    corners, z, color = face_arrays(verts, faces, attrs)
    a = corners
    b = corners[..., [1, 2, 0], :]
    ex = b[..., 0] - a[..., 0]
    ey = b[..., 1] - a[..., 1]
    area = (ex[..., 0] * (a[..., 2, 1] - a[..., 0, 1])
            - ey[..., 0] * (a[..., 2, 0] - a[..., 0, 0]))
    sign = torch.sign(area)[..., None]
    # the clamp keeps sqrt'(0) finite: degenerate (masked) faces would
    # otherwise poison the vertex gradient with 0 * inf = NaN
    elen = torch.sqrt(torch.clamp(ex * ex + ey * ey, min=1e-12))
    norm = sign / ((elen + 1e-8) * sigma)
    ok = (torch.abs(area) > DEGENERATE_AREA_EPS)[..., None]
    zero = torch.zeros((), dtype=verts.dtype, device=verts.device)
    ca = torch.where(ok, (-ey) * norm, zero)
    cb = torch.where(ok, ex * norm, zero)
    cc = torch.where(ok, (ey * a[..., 0] - ex * a[..., 1]) * norm,
                     torch.full((), -1e9, dtype=verts.dtype, device=verts.device))
    coef = torch.stack([ca, cb, cc], dim=-1)
    z_bg = 20.0
    zw = torch.exp((z_bg - z) / gamma)
    return coef, zw, color


def _pixel_grids(res: int, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    coords = torch.arange(res, dtype=like.dtype, device=like.device) + 0.5
    return coords[:, None], coords[None, :]


def _face_terms(coef: torch.Tensor, f: int, px, py):
    """Per-face forward quantities over (B, res, res): edge values t,
    logistics s, their product, the minimum edge value and alpha."""
    k = lambda e, j: coef[:, f, e, j][:, None, None]
    t = [affine(k(e, 0), px, k(e, 1), py, k(e, 2)) for e in range(3)]
    # clamped to +-30, where the float32 logistic saturates, as the
    # reference does
    s = [torch.reciprocal(1.0 + torch.exp(-torch.clamp(te, -30.0, 30.0)))
         for te in t]
    big_s = s[0] * s[1] * s[2]
    tmin = torch.minimum(torch.minimum(t[0], t[1]), t[2])
    window = torch.clamp(tmin + 4.0, 0.0, 1.0)
    return t, s, big_s, tmin, big_s * window


def _accumulate(coef, zw, color, px, py, keep=None):
    """Pass 1 over the faces in ascending order: num (3 planes), den and
    transp; with ``keep`` (a list) also each face's alpha and exclusive
    prefix product."""
    b, n_faces = coef.shape[:2]
    shape = (b,) + torch.broadcast_shapes(px.shape[-2:], py.shape[-2:])
    num = [coef.new_zeros(shape) for _ in range(3)]
    den = coef.new_zeros(shape)
    transp = coef.new_ones(shape)
    for f in range(n_faces):
        alpha = _face_terms(coef, f, px, py)[-1]
        if keep is not None:
            keep.append((alpha, transp))
        w = alpha * zw[:, 0, f][:, None, None]
        for ch in range(3):
            num[ch] = num[ch] + w * color[:, f, ch][:, None, None]
        den = den + w
        transp = transp * (1.0 - alpha)
    return num, den, transp


def soft_raster_fwd_reference(coef: torch.Tensor, zw: torch.Tensor,
                              color: torch.Tensor,
                              background: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (the reference's
    ``_soft_fwd_kernel``): faces accumulate in ascending order, then
    ``cover * num / max(den, 1e-8) + transp * background``."""
    px, py = _pixel_grids(background.shape[-1], coef)
    num, den, transp = _accumulate(coef, zw, color, px, py)
    inv_den = torch.reciprocal(torch.clamp(den, min=1e-8))
    cover = 1.0 - transp
    return torch.stack([cover * (num[ch] * inv_den) + transp * background[:, ch]
                        for ch in range(3)], dim=1)


def soft_raster_bwd_reference(coef: torch.Tensor, zw: torch.Tensor,
                              color: torch.Tensor, background: torch.Tensor,
                              g: torch.Tensor):
    """
    Plain PyTorch version of the backward kernel (the reference's
    ``_soft_bwd_kernel``): pass 1 keeps each face's alpha and exclusive
    prefix product, pass 2 walks the faces in descending order with a
    running suffix product.

    Returns:
        (gcoef (B, F, 3, 3), gzw (B, 1, F), gcolor (B, F, 3),
         gbg (B, 3, R, R)).
    """
    b, n_faces = coef.shape[:2]
    px, py = _pixel_grids(background.shape[-1], coef)
    kept = []
    num, den, transp = _accumulate(coef, zw, color, px, py, keep=kept)
    # the num-gradient always flows through 1/D, the den-gradient only
    # where den > eps (the derivative of max(den, eps))
    dmask = (den > 1e-8).to(den.dtype)
    inv_den = torch.reciprocal(torch.clamp(den, min=1e-8))
    cover = 1.0 - transp
    cface = [num[ch] * inv_den for ch in range(3)]
    gch = [g[:, ch] for ch in range(3)]
    dl_da = torch.zeros_like(den)
    q = torch.zeros_like(den)
    p = []
    for ch in range(3):
        dl_da = dl_da + gch[ch] * (cface[ch] - background[:, ch])
        p.append(gch[ch] * cover * inv_den)
        q = q - p[ch] * cface[ch] * dmask
    gbg = torch.stack([gch[ch] * transp for ch in range(3)], dim=1)

    sums = _face_rows(coef, zw, color, kept, p, q, dl_da, px, py)
    return (sums[..., :9].reshape(b, n_faces, 3, 3), sums[..., 9][:, None, :],
            sums[..., 10:13], gbg)


def _face_rows(coef, zw, color, kept, chan, offset, k, px, py,
               total=None) -> torch.Tensor:
    """
    Pass 2 of the backward over one run of faces, in descending order with a
    running suffix product: per face ``dl/dw = sum_c chan_c * color_c +
    offset`` and ``dl/dalpha = zw * dl/dw + k * prod_{f' != f} (1 -
    alpha_f')``, then the 13 gradient terms summed over the pixels.

    Args:
        kept: each face's (alpha, exclusive prefix product) from pass 1.
        chan: the three per-channel cotangents of the weighted color.
        total: each term's sum over the pixels (``x.sum(dim=(-2, -1))``
            by default).
    Returns:
        (B, F, 13): [gA gB gC] per edge, gzw, gcolor.
    """
    n_faces = coef.shape[1]
    sums = [None] * n_faces
    suffix = torch.ones_like(offset)
    if total is None:
        total = lambda x: x.sum(dim=(-2, -1))
    for f in range(n_faces - 1, -1, -1):
        alpha, prefix = kept[f]
        except_f = prefix * suffix
        suffix = suffix * (1.0 - alpha)
        col = lambda ch: color[:, f, ch][:, None, None]
        zwf = zw[:, 0, f][:, None, None]
        dl_dw = chan[0] * col(0) + chan[1] * col(1) + chan[2] * col(2) + offset
        dl_dalpha = zwf * dl_dw + k * except_f
        t, s, big_s, tmin, _ = _face_terms(coef, f, px, py)
        wmask = ((tmin > -4.0) & (tmin < -3.0)).to(offset.dtype)
        sw = dl_dalpha * big_s * wmask
        row = []
        for e in range(3):
            gt = dl_dalpha * (alpha * (1.0 - s[e])) \
                + sw * (t[e] == tmin).to(offset.dtype)
            row += [total(gt * px), total(gt * py), total(gt)]
        row.append(total(dl_dw * alpha))
        w = alpha * zwf
        row += [total(chan[ch] * w) for ch in range(3)]
        sums[f] = torch.stack(row, dim=-1)                   # (B, 13)
    return torch.stack(sums, dim=1)


def _check_operands(coef: torch.Tensor, want) -> None:
    """Raise unless every ``name: (tensor, shape)`` of ``want`` has coef's
    dtype (float32; float64 too for the plain versions on the CPU), the
    shape and coef's device, and the batch fits one launch."""
    dtypes = (torch.float32, torch.float64) if coef.device.type == 'cpu' \
        else (torch.float32,)
    if coef.dtype not in dtypes:
        raise ValueError(f'coef: expected one of {dtypes}, got {coef.dtype}')
    for name, (t, shape) in want.items():
        if t.dtype != coef.dtype or tuple(t.shape) != shape:
            raise ValueError(f'{name}: expected {coef.dtype} {shape}, got '
                             f'{t.dtype} {tuple(t.shape)}')
        if t.device != coef.device:
            raise ValueError(f'{name} is on {t.device}, coef on {coef.device}')
    if coef.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no soft raster for device {coef.device}')
    if coef.shape[0] > 65535:
        raise ValueError(f'at most 65535 cameras per launch, got {coef.shape[0]}')


def _check(coef, zw, color, background, g=None):
    b, n_faces = coef.shape[0], coef.shape[1]
    res = background.shape[-1]
    if not 1 <= n_faces <= MAX_FACES:
        raise ValueError(f'1 to {MAX_FACES} faces per camera, got {n_faces}')
    want = {'coef': (coef, (b, n_faces, 3, 3)), 'zw': (zw, (b, 1, n_faces)),
            'color': (color, (b, n_faces, 3)),
            'background': (background, (b, 3, res, res))}
    if g is not None:
        want['g'] = (g, (b, 3, res, res))
    _check_operands(coef, want)


def soft_raster_fwd(coef: torch.Tensor, zw: torch.Tensor, color: torch.Tensor,
                    background: torch.Tensor) -> torch.Tensor:
    """
    The soft raster's forward: (B, 3, R, R) image in [0, 1] from
    coef (B, F, 3, 3), zw (B, 1, F), color (B, F, 3) and the background
    (B, 3, R, R), F <= 128. CUDA kernel for CUDA tensors, plain version for
    CPU tensors.
    """
    _check(coef, zw, color, background)
    if coef.device.type == 'cpu':
        return soft_raster_fwd_reference(coef, zw, color, background)
    coef, zw, color, background = (t.contiguous() for t in
                                   (coef, zw, color, background))
    b, n_faces, res = coef.shape[0], coef.shape[1], background.shape[-1]
    out = torch.empty_like(background)
    with torch.cuda.device(coef.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = LIBRARY.load().tds_soft_raster_fwd(
            coef.data_ptr(), zw.data_ptr(), color.data_ptr(),
            background.data_ptr(), b, n_faces, res, out.data_ptr(), stream)
    check_launch(err, 'soft raster forward')
    tracing.count('launch.B4a')
    return out


#: per device, the backward's per-camera counters (int32 zeros, which each
#: launch leaves at zero), so that a launch needs no memset
_COUNTERS = {}


def _counters(b: int, device) -> torch.Tensor:
    have = _COUNTERS.get(device)
    if have is None or have.numel() < b:
        have = _COUNTERS[device] = torch.zeros(b, dtype=torch.int32, device=device)
    return have


def soft_raster_bwd(coef: torch.Tensor, zw: torch.Tensor, color: torch.Tensor,
                    background: torch.Tensor, g: torch.Tensor):
    """
    The soft raster's backward for the output cotangent ``g`` (B, 3, R, R):
    (gcoef, gzw, gcolor, gbg) shaped like (coef, zw, color, background).
    CUDA kernel for CUDA tensors (one launch: the last block of each camera
    sums its per-tile partial sums), plain version for CPU tensors.
    """
    _check(coef, zw, color, background, g)
    if coef.device.type == 'cpu':
        return soft_raster_bwd_reference(coef, zw, color, background, g)
    coef, zw, color, background, g = (t.contiguous() for t in
                                      (coef, zw, color, background, g))
    b, n_faces, res = coef.shape[0], coef.shape[1], background.shape[-1]
    partial = coef.new_empty((b, accum_tiles(res), n_faces, 13))
    gbg = torch.empty_like(background)
    gcoef, gzw, gcolor = (torch.empty_like(t) for t in (coef, zw, color))
    with torch.cuda.device(coef.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = LIBRARY.load().tds_soft_raster_bwd(
            coef.data_ptr(), zw.data_ptr(), color.data_ptr(),
            background.data_ptr(), g.data_ptr(), b, n_faces, res,
            partial.data_ptr(), gbg.data_ptr(),
            _counters(b, coef.device).data_ptr(), gcoef.data_ptr(),
            gzw.data_ptr(), gcolor.data_ptr(), stream)
    check_launch(err, 'soft raster backward')
    tracing.count('launch.B4b')
    return gcoef, gzw, gcolor, gbg


class SoftRaster(torch.autograd.Function):
    """The soft raster with the reference's custom-VJP boundary:
    (coef, zw, color, background) -> image; the backward is
    :func:`soft_raster_bwd`, which recomputes everything from the inputs."""

    @staticmethod
    def forward(ctx, coef, zw, color, background):
        ctx.save_for_backward(coef, zw, color, background)
        return soft_raster_fwd(coef, zw, color, background)

    @staticmethod
    def backward(ctx, g):
        with tracing.span('render.backward'):
            return soft_raster_bwd(*ctx.saved_tensors, g.contiguous())


def pad_to_groups(coef: torch.Tensor, zw: torch.Tensor, color: torch.Tensor):
    """
    The grouped path's operands: the faces padded to whole ``MAX_FACES``
    groups with the reference's sentinel (coefficients 0 except C = -1e9, z
    weight 0, color 0), so padding rows have alpha exactly 0.

    Args:
        coef (B, F, 3, 3), zw (B, 1, F), color (B, F, 3).
    Returns:
        (coef, zw, color) with F rounded up to a multiple of ``MAX_FACES``.
    """
    b, n_faces = coef.shape[:2]
    pad = (-n_faces) % MAX_FACES
    if not pad:
        return coef, zw, color
    pcoef = coef.new_zeros((b, pad, 3, 3))
    pcoef[..., 2] = -1e9
    return (torch.cat([coef, pcoef], dim=1),
            torch.cat([zw, zw.new_zeros((b, 1, pad))], dim=2),
            torch.cat([color, color.new_zeros((b, pad, 3))], dim=1))


def _groups(n_faces: int):
    return [slice(lo, lo + MAX_FACES) for lo in range(0, n_faces, MAX_FACES)]


def soft_accum_fwd_facewise(coef: torch.Tensor, zw: torch.Tensor,
                            color: torch.Tensor, res: int):
    """
    The grouped forward folded face by face over every pixel (the
    reference's ``_accum_fwd_kernel`` per group and its XLA combination):
    each group's partials from its faces in ascending order, combined as
    ``num + n_g``, ``den + d_g``, ``transp * t_g`` for g = 0, 1, ...
    :func:`soft_accum_fwd_reference` equals it bit for bit.

    Returns:
        (num (B, 3, R, R), den (B, R, R), transp (B, R, R)).
    """
    b = coef.shape[0]
    px, py = _pixel_grids(res, coef)
    num = coef.new_zeros((b, 3, res, res))
    den = coef.new_zeros((b, res, res))
    transp = coef.new_ones((b, res, res))
    for s in _groups(coef.shape[1]):
        n_g, d_g, t_g = _accumulate(coef[:, s], zw[:, :, s], color[:, s], px, py)
        num = num + torch.stack(n_g, dim=1)
        den = den + d_g
        transp = transp * t_g
    return num, den, transp


def soft_accum_bwd_facewise(coef: torch.Tensor, zw: torch.Tensor,
                            color: torch.Tensor, gnum: torch.Tensor,
                            gden: torch.Tensor, gtransp: torch.Tensor):
    """
    The grouped backward folded face by face over every pixel (the
    reference's ``_accum_bwd_kernel`` per group, with the cotangents its
    autodiff routes to each group): every group receives ``gnum`` and
    ``gden``, and its ``t_g`` receives ``P_g * S_g``, where ``P_g`` is the
    running transp before g and ``S_{G-1} = gtransp``, ``S_g = S_{g+1} *
    t_{g+1}``. Each gradient term is summed over the pixels by
    :func:`_pixel_total`. :func:`soft_accum_bwd_reference` equals it.

    Returns:
        (gcoef (B, F, 3, 3), gzw (B, 1, F), gcolor (B, F, 3)).
    """
    b, n_faces = coef.shape[:2]
    res = gden.shape[-1]
    px, py = _pixel_grids(res, coef)
    groups = _groups(n_faces)
    ops = lambda s: (coef[:, s], zw[:, :, s], color[:, s])
    t_g = [_accumulate(*ops(s), px, py)[2] for s in groups]
    carried = [None] * len(groups)
    s_g = gtransp
    for g in range(len(groups) - 1, -1, -1):
        carried[g] = s_g
        s_g = s_g * t_g[g]
    gch = [gnum[:, ch] for ch in range(3)]
    running = torch.ones_like(gden)
    rows = []
    total = lambda x: _pixel_total(x, res)
    for g, s in enumerate(groups):
        kept = []
        t = _accumulate(*ops(s), px, py, keep=kept)[2]
        gtr = running * carried[g]
        rows.append(_face_rows(*ops(s), kept, gch, gden, -gtr, px, py, total))
        running = running * t
    sums = torch.cat(rows, dim=1)                            # (B, F, 13)
    return (sums[..., :9].reshape(b, n_faces, 3, 3), sums[..., 9][:, None, :],
            sums[..., 10:13])


def _halving_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (a power of 2) by halves: element i plus
    element i + n/2, until one is left. One order, whatever the layout."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _tile_count(tiles: int) -> int:
    """``tiles`` rounded up to a power of 2."""
    return 1 << max(tiles - 1, 0).bit_length()


def _to_tiles(x: torch.Tensor, res: int) -> torch.Tensor:
    """(..., R, R) -> (..., tiles, 256): the 16 x 16 pixel tiles, row-major,
    each row-major inside; pixels past a ragged edge are 0."""
    per = -(-res // ACCUM_TILE)
    pad = per * ACCUM_TILE - res
    x = torch.nn.functional.pad(x, (0, pad, 0, pad))
    lead = x.shape[:-2]
    x = x.reshape(lead + (per, ACCUM_TILE, per, ACCUM_TILE)).transpose(-3, -2)
    return x.reshape(lead + (per * per, ACCUM_TILE * ACCUM_TILE))


def _from_tiles(x: torch.Tensor, res: int) -> torch.Tensor:
    """The inverse of :func:`_to_tiles`: (..., tiles, 16, 16) -> (..., R, R)."""
    per = -(-res // ACCUM_TILE)
    lead = x.shape[:-3]
    x = x.reshape(lead + (per, per, ACCUM_TILE, ACCUM_TILE)).transpose(-3, -2)
    return x.reshape(lead + (per * ACCUM_TILE, per * ACCUM_TILE))[..., :res, :res]


def _pixel_total(x: torch.Tensor, res: int) -> torch.Tensor:
    """(..., R, R) -> (...): each 16 x 16 tile summed by halves, then the
    tiles (padded to a power of 2) by halves."""
    tiles = _halving_sum(_to_tiles(x, res))
    pad = _tile_count(tiles.shape[-1]) - tiles.shape[-1]
    return _halving_sum(torch.nn.functional.pad(tiles, (0, pad)))


class _Slots:
    """
    The runs of the listed folds: one slot per (camera, tile, group) whose
    group has a face that the plain cull lists in the tile, ordered by
    camera, tile, group; each slot's listed faces ascending, padded to the
    longest run with faces of alpha exactly 0.

    Attributes:
        cam, tile: (N,) the slot's camera and tile.
        faces: (N, L) face indices (0 where padded); valid: (N, L).
        coef (N, L, 3, 3), zw (N, 1, L), color (N, L, 3): the operands.
        px (N, 16, 1), py (N, 1, 16): the tile's pixel centres;
        inside (N, 16, 16): pixels within the image.
        by_tile: (B * tiles, K) each (camera, tile)'s slots in group order,
            -1 past its last.
    """
    def __init__(self, coef, zw, color, res: int):
        b, n_faces = coef.shape[:2]
        dev = coef.device
        keep = soft_tile_lists_reference(coef, res)              # (B, T, F)
        tiles = keep.shape[1]
        group = torch.empty(n_faces, dtype=torch.int64, device=dev)
        for g, s in enumerate(_groups(n_faces)):
            group[s] = g
        cam, tile, face = keep.nonzero(as_tuple=True)           # ascending
        n_groups = max(len(_groups(n_faces)), 1)
        key = (cam * tiles + tile) * n_groups + group[face]
        keys, slot, counts = torch.unique_consecutive(
            key, return_inverse=True, return_counts=True)
        n = keys.shape[0]
        width = int(counts.max()) if n else 0
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(face.shape[0], device=dev) - starts[slot]
        self.faces = torch.zeros((n, width), dtype=torch.int64, device=dev)
        self.valid = torch.zeros((n, width), dtype=torch.bool, device=dev)
        self.faces[slot, pos] = face
        self.valid[slot, pos] = True
        bt = keys // n_groups
        self.cam, self.tile = bt // tiles, bt % tiles
        pick = lambda x: x[self.cam[:, None], self.faces]
        pad = torch.zeros((3, 3), dtype=coef.dtype, device=dev)
        pad[:, 2] = -1e9
        self.coef = torch.where(self.valid[..., None, None], pick(coef), pad)
        self.zw = torch.where(self.valid, pick(zw[:, 0]), 0.0)[:, None, :]
        self.color = torch.where(self.valid[..., None], pick(color), 0.0)
        per = -(-res // ACCUM_TILE)
        coords = torch.arange(per * ACCUM_TILE, dtype=coef.dtype, device=dev) + 0.5
        span = torch.arange(ACCUM_TILE, device=dev)
        rows = (self.tile // per * ACCUM_TILE)[:, None] + span
        cols = (self.tile % per * ACCUM_TILE)[:, None] + span
        self.px, self.py = coords[rows][:, :, None], coords[cols][:, None, :]
        self.inside = (rows < res)[:, :, None] & (cols < res)[:, None, :]
        # each (camera, tile)'s slots, in group order
        order = torch.arange(n, device=dev) - torch.searchsorted(bt, bt)
        k = int(order.max()) + 1 if n else 0
        self.by_tile = torch.full((b * tiles, k), -1, dtype=torch.int64, device=dev)
        self.by_tile[bt, order] = torch.arange(n, device=dev)
        self.n_tiles, self.res = tiles, res

    def fold(self, keep=None):
        """Pass 1 over each slot's faces in ascending order: (num, den,
        transp) per slot, (N, 16, 16) each; with ``keep`` also each face's
        alpha and exclusive prefix product."""
        return _accumulate(self.coef, self.zw, self.color, self.px, self.py, keep)

    def combine(self, per_slot, identity: float, op):
        """Per (camera, tile), ``op`` over its slots' values in group order
        from ``identity`` (+0 or 1, which ``op`` leaves unchanged)."""
        shape = (self.by_tile.shape[0],) + per_slot.shape[1:]
        acc = per_slot.new_full(shape, identity)
        for k in range(self.by_tile.shape[1]):
            s = self.by_tile[:, k]
            here = (s >= 0).reshape((-1,) + (1,) * (per_slot.dim() - 1))
            acc = op(acc, torch.where(here, per_slot[s.clamp(min=0)], identity))
        return acc

    def image(self, per_tile, batch: int) -> torch.Tensor:
        """(B * tiles, ..., 16, 16) -> (B, ..., R, R)."""
        x = per_tile.reshape((batch, self.n_tiles) + per_tile.shape[1:])
        return _from_tiles(x.movedim(1, -3), self.res)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(B, ..., R, R) image -> (N, ..., 16, 16): each slot's tile."""
        t = _to_tiles(x, self.res)                               # (B, ..., T, 256)
        t = t.movedim(-2, 1)[self.cam, self.tile]                # (N, ..., 256)
        return t.reshape(t.shape[:-1] + (ACCUM_TILE, ACCUM_TILE))


def soft_accum_fwd_reference(coef: torch.Tensor, zw: torch.Tensor,
                             color: torch.Tensor, res: int):
    """
    Plain PyTorch version of the grouped forward kernel: per 16 x 16 tile
    and group, only the faces the plain cull lists (the rest have alpha
    exactly 0 there, so they change neither num, den nor transp), in
    ascending order from 0, 0, 1, the groups combined as ``num + n_g``,
    ``den + d_g``, ``transp * t_g`` for g = 0, 1, ...: bit for bit
    :func:`soft_accum_fwd_facewise`.

    Returns:
        (num (B, 3, R, R), den (B, R, R), transp (B, R, R)).
    """
    b = coef.shape[0]
    slots = _Slots(coef, zw, color, res)
    num, den, transp = slots.fold()
    add = lambda x, y: x + y
    num = slots.combine(torch.stack(num, dim=1), 0.0, add)
    den = slots.combine(den, 0.0, add)
    transp = slots.combine(transp, 1.0, lambda x, y: x * y)
    return slots.image(num, b), slots.image(den, b), slots.image(transp, b)


def soft_accum_bwd_reference(coef: torch.Tensor, zw: torch.Tensor,
                             color: torch.Tensor, gnum: torch.Tensor,
                             gden: torch.Tensor, gtransp: torch.Tensor):
    """
    Plain PyTorch version of the grouped backward kernel: the cotangents of
    :func:`soft_accum_bwd_facewise` (``P_g * S_g`` to each group's
    transp), with each (tile, group) run over only the faces the plain cull
    lists there, each term summed over its tile's pixels by halves and over
    the tiles by halves: bit for bit the face-by-face fold (a dropped face
    adds exactly 0 to every term in the tile).

    Returns:
        (gcoef (B, F, 3, 3), gzw (B, 1, F), gcolor (B, F, 3)).
    """
    b, n_faces = coef.shape[:2]
    res = gden.shape[-1]
    slots = _Slots(coef, zw, color, res)
    if slots.faces.shape[0] == 0:       # no face reaches any tile
        return coef.new_zeros(coef.shape), zw.new_zeros(zw.shape), color.new_zeros(color.shape)
    kept = []
    t_slot = slots.fold(kept)[2]
    n_slots, width = slots.faces.shape
    # P_g * S_g per slot, from each (camera, tile)'s slots in group order
    s_g = _to_tiles(gtransp, res).reshape(-1, ACCUM_TILE, ACCUM_TILE)
    carried = torch.zeros_like(t_slot)
    for k in range(slots.by_tile.shape[1] - 1, -1, -1):
        s = slots.by_tile[:, k]
        here = s >= 0
        carried[s[here]] = s_g[here]
        s_g = torch.where(here[:, None, None], s_g * t_slot[s.clamp(min=0)], s_g)
    running = torch.ones_like(s_g)
    gtr = torch.zeros_like(t_slot)
    for k in range(slots.by_tile.shape[1]):
        s = slots.by_tile[:, k]
        here = s >= 0
        gtr[s[here]] = running[here] * carried[s[here]]
        running = torch.where(here[:, None, None], running * t_slot[s.clamp(min=0)],
                              running)
    chan = slots.gather(gnum)
    inside = slots.inside
    total = lambda x: _halving_sum(torch.where(inside, x, 0.0).reshape(n_slots, -1))
    rows = _face_rows(slots.coef, slots.zw, slots.color, kept,
                      [chan[:, ch] for ch in range(3)], slots.gather(gden), -gtr,
                      slots.px, slots.py, total)                  # (N, L, 13)
    tiles = _tile_count(slots.n_tiles)
    out = coef.new_zeros((b, n_faces, 13, tiles))
    cam = slots.cam[:, None].expand(n_slots, width)[slots.valid]
    tile = slots.tile[:, None].expand(n_slots, width)[slots.valid]
    out[cam, slots.faces[slots.valid], :, tile] = rows[slots.valid]
    sums = _halving_sum(out)                                  # (B, F, 13)
    return (sums[..., :9].reshape(b, n_faces, 3, 3), sums[..., 9][:, None, :],
            sums[..., 10:13])


def accum_tiles(res: int) -> int:
    """The kernels' pixel tiles (blocks) per camera, ``ceil(res / 16)^2``."""
    return (-(-res // ACCUM_TILE)) ** 2


def soft_tile_lists_reference(coef: torch.Tensor, res: int) -> torch.Tensor:
    """
    Plain version of the per-tile face cull that every block of both kernel
    pairs runs first (``csrc/soft_face.cuh``: ``list_tile_faces``): which
    faces each block keeps. Tiles are 16 x
    16 pixels, row-major; a face is dropped from a tile iff one edge's value
    ``t_e = A*px + B*py + C`` is at most ``-4 - 2^-20 (|A| x_max + |B| y_max
    + |C|)`` at the tile's four extreme pixel centres (clipped to the
    image), in float64 with the kernel's operations in its order. There its
    float32 value is <= -4 at every pixel of the tile, so the face's window
    ramp, alpha and gradient terms are exactly 0.

    Args:
        coef: (B, F, 3, 3) edge coefficients.
    Returns:
        (B, tiles, F) bool keep mask, tiles = ``accum_tiles(res)``.
    """
    c = coef.double()
    first = torch.arange(0, res, ACCUM_TILE, dtype=torch.float64,
                         device=coef.device) + 0.5
    last = torch.clamp(first + (ACCUM_TILE - 1), max=res - 0.5)
    a, b, k = (c[..., j, None] for j in range(3))            # (B, F, 3, 1)
    rows = torch.maximum(a * first, a * last)                # (B, F, 3, T)
    cols = torch.maximum(b * first, b * last)
    top = (rows[..., :, None] + cols[..., None, :]) + k[..., None]
    slack = ((a.abs() * last)[..., :, None] + (b.abs() * last)[..., None, :]
             + k.abs()[..., None]) * _CULL_SLACK
    dropped = (top <= -4.0 - slack).any(dim=2)               # (B, F, T, T)
    return ~dropped.flatten(2).transpose(1, 2)


def _check_accum(coef, zw, color, res, grads=None):
    b, n_faces = coef.shape[0], coef.shape[1]
    if n_faces < 1 or n_faces % MAX_FACES:
        raise ValueError(f'a positive multiple of {MAX_FACES} faces per camera '
                         f'(pad_to_groups), got {n_faces}')
    want = {'coef': (coef, (b, n_faces, 3, 3)), 'zw': (zw, (b, 1, n_faces)),
            'color': (color, (b, n_faces, 3))}
    if grads is not None:
        for name, t, shape in zip(('gnum', 'gden', 'gtransp'), grads,
                                  ((b, 3, res, res), (b, res, res), (b, res, res))):
            want[name] = (t, shape)
    _check_operands(coef, want)


def _tile_lists(b: int, n_faces: int, res: int, device):
    """The grouped kernels' scratch for their per-tile face lists: (B,
    tiles, F) face indices and (B, tiles) counts, int32."""
    tiles = accum_tiles(res)
    return (torch.empty((b, tiles, n_faces), dtype=torch.int32, device=device),
            torch.empty((b, tiles), dtype=torch.int32, device=device))


def soft_accum_fwd(coef: torch.Tensor, zw: torch.Tensor, color: torch.Tensor,
                   res: int):
    """
    The grouped forward: the totals (num (B, 3, R, R), den (B, R, R),
    transp (B, R, R)) of coef (B, F, 3, 3), zw (B, 1, F), color (B, F, 3),
    F a multiple of ``MAX_FACES`` (:func:`pad_to_groups`). One CUDA launch
    over every group for CUDA tensors (each block over the faces that reach
    its tile), plain version for CPU tensors.
    """
    _check_accum(coef, zw, color, res)
    if coef.device.type == 'cpu':
        return soft_accum_fwd_reference(coef, zw, color, res)
    coef, zw, color = (t.contiguous() for t in (coef, zw, color))
    b, n_faces = coef.shape[:2]
    lists, counts = _tile_lists(b, n_faces, res, coef.device)
    num = coef.new_empty((b, 3, res, res))
    den = coef.new_empty((b, res, res))
    transp = coef.new_empty((b, res, res))
    with torch.cuda.device(coef.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = ACCUM_LIBRARY.load().tds_soft_accum_fwd(
            coef.data_ptr(), zw.data_ptr(), color.data_ptr(), b, n_faces,
            MAX_FACES, res, lists.data_ptr(), counts.data_ptr(), num.data_ptr(),
            den.data_ptr(), transp.data_ptr(), stream)
    check_launch(err, 'grouped soft raster forward')
    tracing.count('launch.B5a')
    return num, den, transp


def soft_accum_bwd(coef: torch.Tensor, zw: torch.Tensor, color: torch.Tensor,
                   gnum: torch.Tensor, gden: torch.Tensor, gtransp: torch.Tensor):
    """
    The grouped backward for the totals' cotangents: (gcoef, gzw, gcolor)
    shaped like (coef, zw, color). One CUDA launch over every group for CUDA
    tensors (its per-block partial sums finished here by one sum over the
    pixel tiles), plain version for CPU tensors.
    """
    res = gden.shape[-1]
    _check_accum(coef, zw, color, res, (gnum, gden, gtransp))
    if coef.device.type == 'cpu':
        return soft_accum_bwd_reference(coef, zw, color, gnum, gden, gtransp)
    coef, zw, color, gnum, gden, gtransp = (
        t.contiguous() for t in (coef, zw, color, gnum, gden, gtransp))
    b, n_faces = coef.shape[:2]
    lists, counts = _tile_lists(b, n_faces, res, coef.device)
    scratch = coef.new_empty((b, n_faces // MAX_FACES, res, res))
    # the kernel writes only the rows of the faces each tile lists
    partial = coef.new_zeros((b, accum_tiles(res), n_faces, 13))
    with torch.cuda.device(coef.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = ACCUM_LIBRARY.load().tds_soft_accum_bwd(
            coef.data_ptr(), zw.data_ptr(), color.data_ptr(), gnum.data_ptr(),
            gden.data_ptr(), gtransp.data_ptr(), b, n_faces, MAX_FACES, res,
            lists.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
            partial.data_ptr(), stream)
    check_launch(err, 'grouped soft raster backward')
    tracing.count('launch.B5b')
    sums = partial.sum(dim=1)                                # (B, F, 13)
    return (sums[..., :9].reshape(b, n_faces, 3, 3), sums[..., 9][:, None, :],
            sums[..., 10:13].contiguous())


class SoftAccum(torch.autograd.Function):
    """The grouped accumulators with the reference's custom-VJP boundary:
    (coef, zw, color) over every group -> (num, den, transp); the backward
    is :func:`soft_accum_bwd`, which recomputes everything from the inputs."""

    @staticmethod
    def forward(ctx, coef, zw, color, res):
        ctx.save_for_backward(coef, zw, color)
        return soft_accum_fwd(coef, zw, color, res)

    @staticmethod
    def backward(ctx, gnum, gden, gtransp):
        with tracing.span('render.backward'):
            return (*soft_accum_bwd(*ctx.saved_tensors, gnum.contiguous(),
                                    gden.contiguous(), gtransp.contiguous()), None)


def rasterize_softmax_coefs(coef: torch.Tensor, zw: torch.Tensor,
                            color: torch.Tensor,
                            background: torch.Tensor) -> torch.Tensor:
    """
    The soft raster of per-face operands (:func:`soft_coefficients`) over
    ``background`` (B, 3, R, R): up to ``MAX_FACES`` faces at up to 128
    pixels by the single-group kernels, which composite; else the faces
    padded to whole groups, the grouped accumulators (:class:`SoftAccum`)
    and the reference's composite in plain PyTorch,
    ``(1 - transp) * num / max(den, 1e-8) + transp' * background`` with
    ``transp' = 1 - (1 - transp)``.

    Args:
        coef (B, F, 3, 3), zw (B, 1, F), color (B, F, 3), F >= 1.
    Returns:
        (B, 3, R, R) image in [0, 1].
    """
    res = background.shape[-1]
    if coef.shape[1] <= MAX_FACES and res <= 128:
        return SoftRaster.apply(coef, zw, color, background)
    num, den, transp = SoftAccum.apply(*pad_to_groups(coef, zw, color), res)
    return composite(num, den, transp, background)


def composite(num: torch.Tensor, den: torch.Tensor, transp: torch.Tensor,
              background: torch.Tensor) -> torch.Tensor:
    """The grouped path's composite of the totals over ``background``
    (B, 3, R, R), plain differentiable PyTorch as in the reference:
    ``cover * num / max(den, 1e-8) + (1 - cover) * background`` with
    ``cover = 1 - transp``."""
    c_faces = num / torch.clamp(den[:, None], min=1e-8)
    cover = (1.0 - transp)[:, None]
    return cover * c_faces + (1.0 - cover) * background


def rasterize_softmax_chw(verts: torch.Tensor, faces: torch.Tensor,
                          attrs: torch.Tensor, res: int,
                          background: torch.Tensor, sigma: float = 0.5,
                          gamma: float = 0.5) -> torch.Tensor:
    """
    Softmax-blend soft raster of screen-space faces over ``background``
    (the reference's ``rasterize_softmax_pallas``, channels first), any face
    count and any ``res``; differentiable w.r.t. verts, attrs and
    background.

    Args:
        verts: (B, V, 3) screen (row, col, priority z); faces: (B, F, 3);
            attrs: (B, V, 3) colors; background: (B, 3, res, res).
    Returns:
        (B, 3, res, res) image in [0, 1].
    """
    if faces.shape[1] == 0:
        return background
    coef, zw, color = soft_coefficients(verts, faces, attrs, sigma, gamma)
    return rasterize_softmax_coefs(coef, zw[:, None, :], color,
                                   background.expand(verts.shape[0], 3, res, res))
