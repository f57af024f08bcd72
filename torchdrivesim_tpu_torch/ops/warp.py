"""
Background warp of the baked map texture (counterpart of
``torchdrivesim_tpu/ops/pallas_warp.py``): mip pyramid, level selection,
per-camera affine coefficients, the plain PyTorch version of the
nearest-texel lookup that the fused render kernel inlines, and the bilinear
warp with its differentiable wrapper :func:`warp_background_diff`.

An orthographic camera view is an affine warp of the texture. The reference
resamples a 128 x 256 texel window in two axis-aligned passes (row index
first, then the column index evaluated at the ROUNDED row); this module
reproduces that index arithmetic in one pass, per pixel, so the texel
chosen is the reference's exactly.

:func:`warp_view_bilinear` launches the hand-written CUDA kernel
(``csrc/warp_bilinear.cu``) for CUDA tensors and runs the plain PyTorch
version :func:`warp_view_bilinear_reference` for CPU tensors.
"""
import ctypes
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from torchdrivesim_tpu_torch.ops.build import KernelLibrary, check_launch

RES = 128        #: largest view the 256-texel window covers
WINDOW = 256     #: texture window column count (origins align to 128)
WIN_ROWS = 128   #: texture window row count (origins align to 8)
#: mip-selection safety factor: the chosen level's cell must be at least
#: ``fov * MIP_FACTOR / res`` so the rotated view fits the 128-row window
MIP_FACTOR = 1.55
_INV255 = 1.0 / 255.0

#: bilinear-warp kernel launches since import (or the last reset by the
#: caller): a run can show that its main path went through the kernel
LAUNCHES = 0


@dataclass
class MipLevel:
    """One packed mip level: (Hp, Wp) int32 texels 0x00BBGGRR, padded so any
    128-aligned window origin has a full window of addressable texels."""
    data: torch.Tensor
    origin: np.ndarray              #: (2,) float32 world coordinates of texel (0, 0)
    cell_size: float
    valid_shape: Tuple[int, int]    #: unpadded (H, W)

    def to(self, device) -> "MipLevel":
        return MipLevel(self.data.to(device), self.origin, self.cell_size,
                        self.valid_shape)


def build_mip_pyramid(data: np.ndarray, origin: np.ndarray, cell_size: float,
                      max_levels: int = 6) -> List[MipLevel]:
    """
    Box-filtered mip pyramid of a float RGB texture (H, W, 3) in [0, 1],
    each level packed to int32 and padded (host numpy, on the CPU).

    Returns:
        levels from fine to coarse.
    """
    data = np.asarray(data, dtype=np.float32)
    origin = np.asarray(origin, dtype=np.float64)
    cell = float(cell_size)
    levels = []
    for _ in range(max_levels):
        h, w = data.shape[0], data.shape[1]
        q = np.clip(np.round(data * 255.0), 0, 255).astype(np.uint32)
        packed = (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)).astype(np.int32)
        pad_h = int(np.ceil(h / 128)) * 128 + (WINDOW - 128) - h
        pad_w = int(np.ceil(w / 128)) * 128 + (WINDOW - 128) - w
        packed = np.pad(packed, ((0, max(pad_h, 0)), (0, max(pad_w, 0))))
        levels.append(MipLevel(data=torch.from_numpy(packed),
                               origin=origin.astype(np.float32),
                               cell_size=cell, valid_shape=(h, w)))
        if h // 2 < 8 or w // 2 < 8:
            break
        h2, w2 = (h // 2) * 2, (w // 2) * 2
        data = data[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, 3).mean(axis=(1, 3))
        # cell centers of the coarser grid sit midway between fine centers
        origin = origin + cell / 2
        cell *= 2
    return levels


def select_mip(levels: List[MipLevel], fov: float, res: int = RES) -> MipLevel:
    """Finest level whose ``res``-texel square covers the rotated view."""
    needed = fov * MIP_FACTOR / res
    for level in levels:
        if level.cell_size >= needed:
            return level
    return levels[-1]


def warp_coefficients(mip: MipLevel, cam_xy: torch.Tensor, cam_sc: torch.Tensor,
                      scale: float, background_color: torch.Tensor,
                      left_handed: bool = False, res: int = RES):
    """
    Per-camera affine coefficients of the warp, in float32 as the reference
    computes them.

    Returns:
        (fcoef (B, 1, 14) float32, icoef (B, 1, 4) int32): fcoef holds the
        row-index (v), column-index (h) and validity (ty, tx) affine
        coefficients and the true texture bounds; icoef the window origin
        (oy, ox), the transpose flag and the packed background color.
    """
    assert res <= RES, "the 256-texel window only covers views up to 128 px"
    b = cam_xy.shape[0]
    dev = cam_xy.device
    half = res / 2.0
    ppm = scale * half                      # output pixels per meter
    cell = float(mip.cell_size)
    h_pad, w_pad = mip.data.shape[0], mip.data.shape[1]
    sin = cam_sc[:, 0]
    cos = cam_sc[:, 1]
    lh = -1.0 if left_handed else 1.0

    # texture coordinates of output pixel (r, c):
    #   forward = (half - (r+.5))/ppm ; left = lh*(half - (c+.5))/ppm
    #   world = cam + R(psi) @ (forward, left)
    #   ty/tx = (world_y/x - origin_y/x) / cell   (ty ~ texture row)
    m = 1.0 / (ppm * cell)
    h0 = half - 0.5
    a_y = -sin * m
    b_y = -lh * cos * m
    a_x = -cos * m
    b_x = lh * sin * m
    # origin entries are float32 values, exact as Python floats
    cy = (cam_xy[:, 1] - float(mip.origin[1])) / cell
    cx = (cam_xy[:, 0] - float(mip.origin[0])) / cell
    e_y = cy + (m * h0) * (sin + lh * cos)
    e_x = cx + (m * h0) * (cos - lh * sin)

    # window origins: columns align to 128, rows to 8, rounding half to even
    oy = 8 * torch.round((cy - (WIN_ROWS - 1) / 2.0) / 8.0).to(torch.int32)
    ox = 128 * torch.round((cx - 128.0) / 128.0).to(torch.int32)
    oy = torch.clamp(oy, 0, max(h_pad - WIN_ROWS, 0))
    ox = torch.clamp(ox, 0, max(w_pad - WINDOW, 0))

    a1, b1 = a_y, b_y
    e1 = e_y - oy.to(torch.float32)
    a2, b2 = a_x, b_x
    e2 = e_x - ox.to(torch.float32)

    # two-pass decomposition out[r,c] = W[v(r,c), h(v(r,c), c)]; the
    # transposed branch (|a1| < |a2|, rotations near +-90 deg) swaps roles
    use_flip = torch.abs(a1) < torch.abs(a2)
    pa1 = torch.where(use_flip, a2, a1)
    pb1 = torch.where(use_flip, b2, b1)
    pe1 = torch.where(use_flip, e2, e1)
    pa2 = torch.where(use_flip, a1, a2)
    pb2 = torch.where(use_flip, b1, b2)
    pe2 = torch.where(use_flip, e1, e2)
    safe = torch.where(torch.abs(pa1) < 1e-9, 1e-9, pa1)
    h_a = pa2 / safe
    h_b = pb2 - pa2 * pb1 / safe
    h_c = pe2 - pa2 * pe1 / safe

    bg = torch.clamp(background_color.to(torch.float32) * 255.0, 0, 255
                     ).to(torch.int32)
    bg_packed = (bg[0] | (bg[1] << 8) | (bg[2] << 16)).to(dev).expand(b)

    valid = mip.valid_shape
    full = lambda v: torch.full((b,), float(v), dtype=torch.float32, device=dev)
    fcoef = torch.stack([
        pa1, pb1, pe1, h_a, h_b, h_c,
        a_y, b_y, e_y, a_x, b_x, e_x,
        full(valid[0]), full(valid[1]),
    ], dim=-1).to(torch.float32)[:, None, :]               # (B, 1, 14)
    icoef = torch.stack([
        oy, ox, use_flip.to(torch.int32),
        bg_packed,
    ], dim=-1).to(torch.int32)[:, None, :]                 # (B, 1, 4)
    return fcoef, icoef


def affine(a, x, b, y, c):
    """``(a*x + b*y) + c`` in float32, every operation rounded on its own:
    the arithmetic of the plain versions and of the CUDA kernel (which
    spells it with round-to-nearest intrinsics so nvcc cannot fuse it).

    The reference's compiled CPU code contracts some of these expressions
    into fused multiply-adds, differently from one fusion to the next, so a
    pixel whose outcome hangs on the last bit of one of them can differ
    from the reference (the parity tests count and allow exactly those)."""
    return a * x + b * y + c


def warp_view_packed_reference(tex: torch.Tensor, fcoef: torch.Tensor,
                               icoef: torch.Tensor, res: int) -> torch.Tensor:
    """
    Plain PyTorch version of the nearest-texel warp: the packed 0x00BBGGRR
    background of each camera's (res, res) view.

    Per pixel (r, c), with the window origin (oy, ox) = icoef[b, 0, 0:2]:
      standard branch: v = clip(floor(va*r + vb*c + vc + 0.5), 0, WIN_ROWS-1),
        h = clip(floor(ha*v + hb*c + hc + 0.5), 0, WINDOW-1) at the INTEGER
        v, texel tex[oy + v, ox + h];
      flipped branch: v clips to WINDOW-1 and indexes window columns, h clips
        to WIN_ROWS-1 and indexes rows, texel tex[oy + h, ox + v].
    Off-texture pixels (ty, tx outside the valid shape) take the packed
    background color icoef[b, 0, 3]. Each ``a*x + b*y + c`` is evaluated by
    :func:`affine`.

    Args:
        tex: (Hp, Wp) int32 packed mip level; fcoef (B, 1, 14); icoef (B, 1, 4).
    Returns:
        (B, res, res) int32.
    """
    dev = tex.device
    f = lambda k: fcoef[:, 0, k][:, None, None]
    i = lambda k: icoef[:, 0, k][:, None, None]
    rows = torch.arange(res, dtype=torch.float32, device=dev)[None, :, None]
    cols = torch.arange(res, dtype=torch.float32, device=dev)[None, None, :]
    flip = i(2) == 1
    v = torch.floor(affine(f(0), rows, f(1), cols, f(2)) + 0.5)
    v = torch.where(flip, torch.clamp(v, 0, WINDOW - 1),
                    torch.clamp(v, 0, WIN_ROWS - 1))
    h = torch.floor(affine(f(3), v, f(4), cols, f(5)) + 0.5)
    h = torch.where(flip, torch.clamp(h, 0, WIN_ROWS - 1),
                    torch.clamp(h, 0, WINDOW - 1))
    v, h = v.long(), h.long()
    # window origins are in range by construction; the clamp only keeps a
    # malformed icoef from reading outside the texture
    ty_idx = torch.clamp(i(0).long() + torch.where(flip, h, v), 0, tex.shape[0] - 1)
    tx_idx = torch.clamp(i(1).long() + torch.where(flip, v, h), 0, tex.shape[1] - 1)
    texel = tex[ty_idx, tx_idx]

    ty = affine(f(6), rows, f(7), cols, f(8))
    tx = affine(f(9), rows, f(10), cols, f(11))
    valid = (ty >= 0) & (ty < f(12)) & (tx >= 0) & (tx < f(13))
    return torch.where(valid, texel, i(3))


def _bind_bilinear(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature (see ``csrc/warp_bilinear.cu``):
    fcoef, icoef and texture pointers; tex_h, tex_w, batch, res; the output
    pointer and the stream."""
    fn = lib.tds_warp_bilinear
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


LIBRARY = KernelLibrary('warp_bilinear.cu', _bind_bilinear)


def _channel(packed: torch.Tensor, ch: int) -> torch.Tensor:
    """Channel ``ch`` (0 = R) of 0x00BBGGRR texels as float in [0, 1]."""
    return ((packed >> (8 * ch)) & 255).to(torch.float32) * _INV255


def _lerp(g0: torch.Tensor, g1: torch.Tensor, fr: torch.Tensor) -> torch.Tensor:
    return g0 + fr * (g1 - g0)


def warp_view_bilinear_reference(tex: torch.Tensor, fcoef: torch.Tensor,
                                 icoef: torch.Tensor, res: int) -> torch.Tensor:
    """
    Plain PyTorch version of the two-pass bilinear warp (the reference's
    ``warp_view_bilinear``): each camera's (3, res, res) float view.

    Per pixel (r, c): the pass-2 position v = va*r + vb*c + vc has taps
    k0 = clip(floor(v), 0, K-2) and k0+1 and weight clip(v - k0, 0, 1); at
    each tap k, pass 1 lerps at h = ha*k + hb*c + hc (taps clip(floor(h), 0,
    J-2) and the next, same weight rule) along the other window axis. K is
    the window's 128 rows and J its 256 columns on the standard branch, and
    the other way round on the transposed one (icoef[..., 2] == 1), where
    the pass-2 index runs over columns. Off-texture pixels take the packed
    background color icoef[..., 3]. Each ``a*x + b*y + c`` is evaluated by
    :func:`affine`.

    Args:
        tex: (Hp, Wp) int32 packed mip level; fcoef (B, 1, 14) (float64
            evaluates in float64); icoef (B, 1, 4).
    Returns:
        (B, 3, res, res) in [0, 1], float32 for float32 coefficients.
    """
    dev, dtype = tex.device, fcoef.dtype
    f = lambda k: fcoef[:, 0, k][:, None, None]
    i = lambda k: icoef[:, 0, k][:, None, None]
    rows = torch.arange(res, dtype=dtype, device=dev)[None, :, None]
    cols = torch.arange(res, dtype=dtype, device=dev)[None, None, :]
    flip = i(2) == 1
    k_hi = torch.where(flip, float(WINDOW - 2), float(WIN_ROWS - 2))
    j_hi = torch.where(flip, float(WIN_ROWS - 2), float(WINDOW - 2))
    zero = torch.zeros((), dtype=dtype, device=dev)

    v = affine(f(0), rows, f(1), cols, f(2))
    k0 = torch.minimum(torch.maximum(torch.floor(v), zero), k_hi)
    fv = torch.clamp(v - k0, 0.0, 1.0)

    def texel(row, col):
        # window origins are in range by construction; the clamp only keeps
        # malformed coefficients from reading outside the texture
        ty_i = torch.clamp(i(0).long() + row, 0, tex.shape[0] - 1)
        tx_i = torch.clamp(i(1).long() + col, 0, tex.shape[1] - 1)
        return tex[ty_i, tx_i]

    def pass1(k):
        h = affine(f(3), k, f(4), cols, f(5))
        j0 = torch.minimum(torch.maximum(torch.floor(h), zero), j_hi)
        fh = torch.clamp(h - j0, 0.0, 1.0)
        ki, ji = k.long(), j0.long()
        t0 = texel(torch.where(flip, ji, ki), torch.where(flip, ki, ji))
        t1 = texel(torch.where(flip, ji + 1, ki), torch.where(flip, ki, ji + 1))
        return [_lerp(_channel(t0, ch), _channel(t1, ch), fh) for ch in range(3)]

    near, far = pass1(k0), pass1(k0 + 1.0)
    ty = affine(f(6), rows, f(7), cols, f(8))
    tx = affine(f(9), rows, f(10), cols, f(11))
    valid = (ty >= 0) & (ty < f(12)) & (tx >= 0) & (tx < f(13))
    return torch.stack([
        torch.where(valid, _lerp(near[ch], far[ch], fv), _channel(i(3), ch))
        for ch in range(3)], dim=1)


def warp_view_bilinear(tex: torch.Tensor, fcoef: torch.Tensor,
                       icoef: torch.Tensor, res: int) -> torch.Tensor:
    """
    Each camera's bilinear (3, res, res) view of the packed mip level ``tex``
    by the coefficients of :func:`warp_coefficients`: the CUDA kernel for
    CUDA tensors, :func:`warp_view_bilinear_reference` for CPU tensors.
    """
    global LAUNCHES
    b = fcoef.shape[0]
    if res > RES or res < 1:
        raise ValueError(f'res must be in [1, {RES}], got {res}')
    for name, t, dtype, shape in (('fcoef', fcoef, torch.float32, (b, 1, 14)),
                                  ('icoef', icoef, torch.int32, (b, 1, 4))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f'{name}: expected {dtype} {shape}, got '
                             f'{t.dtype} {tuple(t.shape)}')
        if t.device != tex.device:
            raise ValueError(f'{name} is on {t.device}, the texture on {tex.device}')
    if tex.dtype != torch.int32 or tex.dim() != 2:
        raise ValueError('texture must be a 2D int32 tensor')
    if tex.shape[0] < WIN_ROWS or tex.shape[1] < WINDOW:
        raise ValueError(f'texture must be at least {WIN_ROWS}x{WINDOW} '
                         f'(padded mip level), got {tuple(tex.shape)}')
    if tex.device.type == 'cpu':
        return warp_view_bilinear_reference(tex, fcoef, icoef, res)
    if tex.device.type != 'cuda':
        raise ValueError(f'no bilinear warp for device {tex.device}')
    if b > 65535:
        raise ValueError(f'at most 65535 cameras per launch, got {b}')
    fcoef, icoef, tex = fcoef.contiguous(), icoef.contiguous(), tex.contiguous()
    out = torch.empty((b, 3, res, res), dtype=torch.float32, device=tex.device)
    with torch.cuda.device(tex.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = LIBRARY.load().tds_warp_bilinear(
            fcoef.data_ptr(), icoef.data_ptr(), tex.data_ptr(), tex.shape[0],
            tex.shape[1], b, res, out.data_ptr(), stream)
    check_launch(err, 'bilinear warp')
    LAUNCHES += 1
    return out


def warp_background_bilinear(mip: MipLevel, cam_xy: torch.Tensor,
                             cam_sc: torch.Tensor, scale: float,
                             background_color: torch.Tensor,
                             left_handed: bool = False,
                             res: int = RES) -> torch.Tensor:
    """Per-camera (B, 3, res, res) bilinear background views of ``mip``
    (the reference's ``warp_background_bilinear``)."""
    fcoef, icoef = warp_coefficients(mip, cam_xy, cam_sc, scale,
                                     background_color, left_handed, res=res)
    return warp_view_bilinear(mip.data, fcoef, icoef, res)


def sample_positions(mip: MipLevel, cam_xy: torch.Tensor, cam_sc: torch.Tensor,
                     scale: float, res: int = RES, left_handed: bool = False):
    """
    The warp's texel sampling map as plain differentiable PyTorch: output
    pixel (r, c) of camera ``i`` reads the texture at
    ``(ty[i, r, c], tx[i, r, c])`` (the affine of :func:`warp_coefficients`).

    Returns:
        ty, tx: (B, res, res) float32 texel coordinates.
    """
    half = res / 2.0
    ppm = scale * half
    cell = float(mip.cell_size)
    sin = cam_sc[:, 0:1, None]
    cos = cam_sc[:, 1:2, None]
    lh = -1.0 if left_handed else 1.0
    m = 1.0 / (ppm * cell)
    h0 = half - 0.5
    dev = cam_xy.device
    r = torch.arange(res, dtype=torch.float32, device=dev)[None, :, None]
    c = torch.arange(res, dtype=torch.float32, device=dev)[None, None, :]
    e_y = (cam_xy[:, 1:2, None] - float(mip.origin[1])) / cell \
        + m * h0 * (sin + lh * cos)
    e_x = (cam_xy[:, 0:1, None] - float(mip.origin[0])) / cell \
        + m * h0 * (cos - lh * sin)
    ty = (-sin * m) * r + (-lh * cos * m) * c + e_y
    tx = (-cos * m) * r + (lh * sin * m) * c + e_x
    return ty, tx


def _central_differences(img: torch.Tensor, dim: int) -> torch.Tensor:
    """Central differences along ``dim``, one-sided at the edges."""
    n = img.shape[dim]
    first = img.narrow(dim, 1, 1) - img.narrow(dim, 0, 1)
    last = img.narrow(dim, n - 1, 1) - img.narrow(dim, n - 2, 1)
    mid = (img.narrow(dim, 2, n - 2) - img.narrow(dim, 0, n - 2)) * 0.5
    return torch.cat([first, mid, last], dim=dim)


class _WarpBackgroundDiff(torch.autograd.Function):
    """Forward: the bilinear warp. Backward: the image-space central
    differences of the saved output, mapped to texel space through the
    inverse affine Jacobian and chained to the pose by autograd of
    :func:`sample_positions` (no kernel, as in the reference)."""

    @staticmethod
    def forward(ctx, cam_xy, cam_sc, mip, scale, background_color,
                left_handed, res):
        out = warp_background_bilinear(mip, cam_xy, cam_sc, scale,
                                       background_color, left_handed, res)
        ctx.save_for_backward(out, cam_xy, cam_sc)
        ctx.mip, ctx.scale, ctx.left_handed, ctx.res = mip, scale, left_handed, res
        return out

    @staticmethod
    def backward(ctx, g):
        out, cxy, csc = ctx.saved_tensors
        mip, scale, lh_flag, res = ctx.mip, ctx.scale, ctx.left_handed, ctx.res
        lh = -1.0 if lh_flag else 1.0
        m = 1.0 / (scale * (res / 2.0) * float(mip.cell_size))
        h_tex, w_tex = float(mip.valid_shape[0]), float(mip.valid_shape[1])
        d_dr = _central_differences(out, 2)
        d_dc = _central_differences(out, 3)
        sin = csc[:, 0, None, None, None]
        cos = csc[:, 1, None, None, None]
        # invert [dI/dr dI/dc] = [dI/dty dI/dtx] @ [[a_y, b_y], [a_x, b_x]]
        a_y, b_y = -sin * m, -lh * cos * m
        a_x, b_x = -cos * m, lh * sin * m
        det = a_y * b_x - a_x * b_y                 # = -lh * m**2, never 0
        d_dty = (d_dr * b_x - d_dc * a_x) / det
        d_dtx = (d_dc * a_y - d_dr * b_y) / det
        with torch.enable_grad():
            cxy_ = cxy.detach().requires_grad_(True)
            csc_ = csc.detach().requires_grad_(True)
            ty, tx = sample_positions(mip, cxy_, csc_, scale, res=res,
                                      left_handed=lh_flag)
            ok = ((ty >= 0) & (ty < h_tex) & (tx >= 0) & (tx < w_tex)
                  ).to(torch.float32)
            cot_ty = torch.sum(g * d_dty, dim=1) * ok
            cot_tx = torch.sum(g * d_dtx, dim=1) * ok
            gxy, gsc = torch.autograd.grad((ty, tx), (cxy_, csc_),
                                           (cot_ty, cot_tx))
        # the texture and the background color are map data, constants here
        return gxy, gsc, None, None, None, None, None


def warp_background_diff(mip: MipLevel, cam_xy: torch.Tensor,
                         cam_sc: torch.Tensor, scale: float,
                         background_color: torch.Tensor,
                         left_handed: bool = False,
                         res: int = RES) -> torch.Tensor:
    """
    Differentiable background (the reference's ``warp_background_diff``):
    the bilinear warp forward, with pose gradients from image-space central
    differences of the rendered view through the inverse affine Jacobian.
    The gradient is that of the mip-level image actually rendered; the
    texture and the background color are constants.

    Returns:
        (B, 3, res, res) float image in [0, 1], differentiable w.r.t.
        ``cam_xy`` and ``cam_sc``.
    """
    return _WarpBackgroundDiff.apply(cam_xy, cam_sc, mip, scale,
                                     background_color, left_handed, res)
