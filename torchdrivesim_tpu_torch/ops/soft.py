"""
Differentiable softmax-blend soft rasterization of up to 128 faces per camera
(counterpart of the single-group path of
``torchdrivesim_tpu/ops/pallas_soft.py``).

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
CUDA kernels (``csrc/soft_raster.cu``) for CUDA tensors and run the plain
PyTorch versions for CPU tensors.
"""
import ctypes
from typing import Tuple

import torch

from torchdrivesim_tpu_torch.ops.build import KernelLibrary, check_launch
from torchdrivesim_tpu_torch.ops.rasterize import DEGENERATE_AREA_EPS, face_arrays
from torchdrivesim_tpu_torch.ops.warp import affine

#: faces per camera the kernels take; more faces need the grouped path
MAX_FACES = 128

#: kernel launches since import (or the last reset by the caller): a run can
#: show that its main path went through the kernels
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_THREADS = 128      #: pixels per block in csrc/soft_raster.cu


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures (see ``csrc/soft_raster.cu``):
    forward: coef, zw, color, bg pointers; batch, faces, res; out, stream;
    backward: coef, zw, color, bg, g pointers; batch, faces, res; partial,
    gbg, stream."""
    fwd = lib.tds_soft_raster_fwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.tds_soft_raster_bwd
    bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 3
    bwd.restype = ctypes.c_int
    return lib


LIBRARY = KernelLibrary('soft_raster.cu', _bind)


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
    res = px.shape[0]
    num = [coef.new_zeros((b, res, res)) for _ in range(3)]
    den = coef.new_zeros((b, res, res))
    transp = coef.new_ones((b, res, res))
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

    sums = [None] * n_faces
    suffix = torch.ones_like(den)
    total = lambda x: x.sum(dim=(-2, -1))
    for f in range(n_faces - 1, -1, -1):
        alpha, prefix = kept[f]
        except_f = prefix * suffix
        suffix = suffix * (1.0 - alpha)
        col = lambda ch: color[:, f, ch][:, None, None]
        zwf = zw[:, 0, f][:, None, None]
        dl_dw = p[0] * col(0) + p[1] * col(1) + p[2] * col(2) + q
        dl_dalpha = zwf * dl_dw + dl_da * except_f
        t, s, big_s, tmin, _ = _face_terms(coef, f, px, py)
        wmask = ((tmin > -4.0) & (tmin < -3.0)).to(den.dtype)
        sw = dl_dalpha * big_s * wmask
        row = []
        for e in range(3):
            gt = dl_dalpha * (alpha * (1.0 - s[e])) \
                + sw * (t[e] == tmin).to(den.dtype)
            row += [total(gt * px), total(gt * py), total(gt)]
        row.append(total(dl_dw * alpha))
        w = alpha * zwf
        row += [total(p[ch] * w) for ch in range(3)]
        sums[f] = torch.stack(row, dim=-1)                   # (B, 13)
    sums = torch.stack(sums, dim=1)                          # (B, F, 13)
    return (sums[..., :9].reshape(b, n_faces, 3, 3), sums[..., 9][:, None, :],
            sums[..., 10:13], gbg)


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
    # float64 only for the plain version (gradient checks on the CPU)
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
    if b > 65535:
        raise ValueError(f'at most 65535 cameras per launch, got {b}')


def soft_raster_fwd(coef: torch.Tensor, zw: torch.Tensor, color: torch.Tensor,
                    background: torch.Tensor) -> torch.Tensor:
    """
    The soft raster's forward: (B, 3, R, R) image in [0, 1] from
    coef (B, F, 3, 3), zw (B, 1, F), color (B, F, 3) and the background
    (B, 3, R, R), F <= 128. CUDA kernel for CUDA tensors, plain version for
    CPU tensors.
    """
    global FWD_LAUNCHES
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
    FWD_LAUNCHES += 1
    return out


def soft_raster_bwd(coef: torch.Tensor, zw: torch.Tensor, color: torch.Tensor,
                    background: torch.Tensor, g: torch.Tensor):
    """
    The soft raster's backward for the output cotangent ``g`` (B, 3, R, R):
    (gcoef, gzw, gcolor, gbg) shaped like (coef, zw, color, background).
    CUDA kernel for CUDA tensors (per-block partial sums finished here by one
    sum over the pixel tiles), plain version for CPU tensors.
    """
    global BWD_LAUNCHES
    _check(coef, zw, color, background, g)
    if coef.device.type == 'cpu':
        return soft_raster_bwd_reference(coef, zw, color, background, g)
    coef, zw, color, background, g = (t.contiguous() for t in
                                      (coef, zw, color, background, g))
    b, n_faces, res = coef.shape[0], coef.shape[1], background.shape[-1]
    tiles = -(-res * res // _THREADS)
    partial = torch.empty((b, tiles, n_faces, 13), dtype=torch.float32,
                          device=coef.device)
    gbg = torch.empty_like(background)
    with torch.cuda.device(coef.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = LIBRARY.load().tds_soft_raster_bwd(
            coef.data_ptr(), zw.data_ptr(), color.data_ptr(),
            background.data_ptr(), g.data_ptr(), b, n_faces, res,
            partial.data_ptr(), gbg.data_ptr(), stream)
    check_launch(err, 'soft raster backward')
    BWD_LAUNCHES += 1
    sums = partial.sum(dim=1)                                # (B, F, 13)
    return (sums[..., :9].reshape(b, n_faces, 3, 3), sums[..., 9][:, None, :],
            sums[..., 10:13].contiguous(), gbg)


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
        return soft_raster_bwd(*ctx.saved_tensors, g.contiguous())


def rasterize_softmax_chw(verts: torch.Tensor, faces: torch.Tensor,
                          attrs: torch.Tensor, res: int,
                          background: torch.Tensor, sigma: float = 0.5,
                          gamma: float = 0.5) -> torch.Tensor:
    """
    Softmax-blend soft raster of screen-space faces over ``background``
    (the reference's ``rasterize_softmax_pallas`` on its single-group path,
    channels first); differentiable w.r.t. verts, attrs and background.

    Args:
        verts: (B, V, 3) screen (row, col, priority z); faces: (B, F, 3)
            with F <= 128; attrs: (B, V, 3) colors; background:
            (B, 3, res, res).
    Returns:
        (B, 3, res, res) image in [0, 1].
    """
    n_faces = faces.shape[1]
    if n_faces == 0:
        return background
    if n_faces > MAX_FACES or res > 128:
        raise NotImplementedError(
            f'{n_faces} faces at res {res}: more than {MAX_FACES} faces or '
            'res above 128 need the grouped soft path (kernels B5a/b), not '
            'ported yet (ROADMAP A12)')
    coef, zw, color = soft_coefficients(verts, faces, attrs, sigma, gamma)
    return SoftRaster.apply(coef, zw[:, None, :], color,
                            background.expand(verts.shape[0], 3, res, res))
