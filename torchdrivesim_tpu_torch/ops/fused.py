"""
Fused warp + rasterize + composite render (counterpart of
``torchdrivesim_tpu/ops/pallas_fused.py``): one bird's-eye-view frame per
camera from the prepared primitive operands (``ops.rasterize
.prep_sorted_prim_coefs``) and the warp coefficients
(``ops.warp.warp_coefficients``).

:func:`render_coefs_fused` launches the hand-written CUDA kernel
(``csrc/fused_render.cu``) for CUDA tensors and runs the plain PyTorch
version :func:`render_coefs_fused_reference` for CPU tensors. The kernel is
built by ``ops/build.py`` at first use and bound with ``ctypes``.
"""
import ctypes

import torch

from torchdrivesim_tpu_torch.ops.build import KernelLibrary, check_launch
from torchdrivesim_tpu_torch.ops.rasterize import CHUNK, SENTINEL, band_rows
from torchdrivesim_tpu_torch.ops import warp
from torchdrivesim_tpu_torch.ops.warp import RES, WINDOW, WIN_ROWS, MipLevel

#: kernel launches since import (or the last reset by the caller): a run can
#: show that its main path went through the kernel
LAUNCHES = 0

_INV255 = 1.0 / 255.0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature (see ``csrc/fused_render.cu``):
    9 operand pointers; tex_h, tex_w, batch, res, rpb, qp, tp, packed; the
    output pointer and the stream."""
    fn = lib.tds_fused_render
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


LIBRARY = KernelLibrary('fused_render.cu', _bind)


def _launch(lib: ctypes.CDLL, ptrs, tex_h: int, tex_w: int, batch: int,
            res: int, qp: int, tp: int, packed: bool, out_ptr: int,
            stream: int) -> int:
    """Call the entry point; returns its CUDA error code."""
    return lib.tds_fused_render(*ptrs, tex_h, tex_w, batch, res,
                                band_rows(res), qp, tp, int(packed), out_ptr,
                                stream)


def _check_operands(tex, fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask,
                    res):
    b = fcoef.shape[0]
    qp, tp = qpk.shape[1], tpk.shape[1]
    if res > RES or res % 16:
        raise ValueError(f'res must be a multiple of 16 up to {RES}, got {res}')
    n_bands = res // band_rows(res)
    if qp % CHUNK or tp % CHUNK:
        raise ValueError(f'prim counts must be multiples of {CHUNK}: {qp}, {tp}')
    want = {
        'fcoef': (fcoef, torch.float32, (b, 1, 14)),
        'icoef': (icoef, torch.int32, (b, 1, 4)),
        'qcoef': (qcoef, torch.float32, (b, 2, qp, 3)),
        'qpk': (qpk, torch.int32, (b, qp, 1)),
        'tcoef': (tcoef, torch.float32, (b, 3, tp, 3)),
        'tpk': (tpk, torch.int32, (b, tp, 1)),
        'qmask': (qmask, torch.int32, (b, n_bands, 1, qp // CHUNK)),
        'tmask': (tmask, torch.int32, (b, n_bands, 1, tp // CHUNK)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f'{name}: expected {dtype} {shape}, got '
                             f'{t.dtype} {tuple(t.shape)}')
        if t.device != fcoef.device:
            raise ValueError(f'{name} is on {t.device}, fcoef on {fcoef.device}')
    if tex.dtype != torch.int32 or tex.dim() != 2 or tex.device != fcoef.device:
        raise ValueError(f'texture must be a 2D int32 tensor on {fcoef.device}')
    if tex.shape[0] < WIN_ROWS or tex.shape[1] < WINDOW:
        raise ValueError(f'texture must be at least {WIN_ROWS}x{WINDOW} '
                         f'(padded mip level), got {tuple(tex.shape)}')


def render_coefs_fused(mip: MipLevel, fcoef: torch.Tensor, icoef: torch.Tensor,
                       qcoef: torch.Tensor, qpk: torch.Tensor,
                       tcoef: torch.Tensor, tpk: torch.Tensor,
                       qmask: torch.Tensor, tmask: torch.Tensor, res: int,
                       packed: bool = False) -> torch.Tensor:
    """
    Render each camera's frame from prepared operands.

    Args:
        mip: packed mip level (its ``data`` on the operands' device).
        fcoef / icoef: (B, 1, 14) float32 / (B, 1, 4) int32 warp coefficients.
        qcoef / qpk: (B, 2, QP, 3) float32 / (B, QP, 1) int32 quads.
        tcoef / tpk: (B, 3, TP, 3) float32 / (B, TP, 1) int32 triangles.
        qmask / tmask: (B, J, 1, QP/8) / (B, J, 1, TP/8) int32 occupancy.
        res: view resolution, a multiple of 16 up to 128.
        packed: return (B, res, res) int32 0x00BBGGRR instead of
            (B, 3, res, res) float32 channels in [0, 1].
    """
    global LAUNCHES
    tex = mip.data
    _check_operands(tex, fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask,
                    res)
    if fcoef.device.type == 'cpu':
        return render_coefs_fused_reference(mip, fcoef, icoef, qcoef, qpk,
                                            tcoef, tpk, qmask, tmask, res,
                                            packed)
    if fcoef.device.type != 'cuda':
        raise ValueError(f'no fused render for device {fcoef.device}')
    operands = [t.contiguous() for t in
                (fcoef, icoef, qmask, tmask, qcoef, qpk, tcoef, tpk, tex)]
    b = fcoef.shape[0]
    if b > 65535:
        raise ValueError(f'at most 65535 cameras per launch, got {b}')
    if packed:
        out = torch.empty((b, res, res), dtype=torch.int32, device=fcoef.device)
    else:
        out = torch.empty((b, 3, res, res), dtype=torch.float32,
                          device=fcoef.device)
    with torch.cuda.device(fcoef.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launch(LIBRARY.load(), [t.data_ptr() for t in operands],
                      tex.shape[0], tex.shape[1], b, res, qpk.shape[1],
                      tpk.shape[1], packed, out.data_ptr(), stream)
    check_launch(err, 'fused render')
    LAUNCHES += 1
    return out


def render_coefs_fused_reference(mip: MipLevel, fcoef: torch.Tensor,
                                 icoef: torch.Tensor, qcoef: torch.Tensor,
                                 qpk: torch.Tensor, tcoef: torch.Tensor,
                                 tpk: torch.Tensor, qmask: torch.Tensor,
                                 tmask: torch.Tensor, res: int,
                                 packed: bool = False) -> torch.Tensor:
    """
    Plain PyTorch version of the kernel, vectorised over (B, res, res) and
    looping over primitives in chunks of 8 (a full (B, P, res, res)
    broadcast would be a gigabyte at B = 256). Same contract and same bits
    as :func:`render_coefs_fused`; the occupancy masks are honoured exactly
    as the kernel honours them.
    """
    dev = fcoef.device
    b = fcoef.shape[0]
    rpb = band_rows(res)
    px = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5)[:, None]
    py = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5)[None, :]
    row_band = torch.arange(res, device=dev) // rpb

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
            vals = torch.where(inside, pk[:, s:s + CHUNK, 0][:, :, None, None],
                               SENTINEL).amin(dim=1)
            live = mask[:, :, 0, s // CHUNK][:, row_band] != 0     # (B, res)
            best = torch.where(live[:, :, None], torch.minimum(best, vals), best)

    bg = warp.warp_view_packed_reference(mip.data, fcoef, icoef, res)
    covered = best < (127 << 24)
    if packed:
        prim = ((best >> 16) & 255) | (best & 0xFF00) | ((best & 255) << 16)
        return torch.where(covered, prim, bg)
    rgb = torch.stack([
        torch.where(covered, (best >> 16) & 255, bg & 255),
        torch.where(covered, (best >> 8) & 255, (bg >> 8) & 255),
        torch.where(covered, best & 255, (bg >> 16) & 255),
    ], dim=1)
    return rgb.to(torch.float32) * _INV255
