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
"""
import ctypes

import torch

from torchdrivesim_tpu_torch.ops.build import KernelLibrary, check_launch

BIG_Z = 1e9
DEGENERATE_AREA_EPS = 1e-9
#: faces whose edge values the plain version evaluates together
FACE_CHUNK = 16
#: pixels per side of the kernel's tiles
TILE = 16
#: 3.1 x 2^-24 and 2^-140, the float64 cull's error terms (``csrc/hard_faces.cu``)
_CULL_ERR, _CULL_TINY = 3.1 * 2.0 ** -24, 2.0 ** -140

#: kernel launches since import (or the last reset by the caller): a run can
#: show that its main path went through the kernel
LAUNCHES = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature (``csrc/hard_faces.cu``):
    corners, z, color and background pointers; batch, faces, height, width;
    the image and winner pointers and the stream."""
    fn = lib.tds_hard_faces
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
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
    Plain version of the kernel's per-tile cull (``csrc/hard_faces.cu``): a
    face stays in a 16 x 16 tile unless its area test fails, its z is not
    below :data:`BIG_Z`, or one of its edges is negative and one positive at
    every pixel centre of the tile by the float64 test over the tile's four
    extreme centres (the last tile row and column clamped to the frame). Not
    on any path: the tests show with it that a dropped face wins no pixel of
    its tile.

    Returns:
        (B, tiles, F) bool, tiles row-major (``ceil(H / 16) x ceil(W / 16)``).
    """
    edges = _face_edges(corners)
    ok = _usable(edges[4], z)
    a0, a1, ex, ey = (t.double() for t in edges[:4])
    r0 = torch.arange(0, height, TILE, device=corners.device).double()
    c0 = torch.arange(0, width, TILE, device=corners.device).double()
    rows = (r0 + 0.5, torch.clamp(r0 + TILE, max=height) - 0.5)     # (th,) each
    cols = (c0 + 0.5, torch.clamp(c0 + TILE, max=width) - 0.5)      # (tw,) each
    neg = pos = None
    for px in rows:
        for py in cols:
            p = ex[..., None, None] * (py[None, :] - a1[..., None, None])
            q = ey[..., None, None] * (px[:, None] - a0[..., None, None])
            v = p - q                                                 # (B, F, 3, th, tw)
            err = _CULL_ERR * (p.abs() + q.abs()) + _CULL_TINY
            n, s = v + err < 0, v - err > 0
            neg = n if neg is None else neg & n
            pos = s if pos is None else pos & s
    drop = neg.any(dim=2) & pos.any(dim=2)                            # (B, F, th, tw)
    keep = ~drop & ok[..., None, None]
    return keep.flatten(2).transpose(1, 2)


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


def hard_faces(corners: torch.Tensor, z: torch.Tensor, color: torch.Tensor,
               background: torch.Tensor):
    """The kernel (HF) on CUDA tensors, :func:`hard_faces_reference` on CPU
    tensors; float32 operands as there. Returns (image (B, 3, H, W),
    winner (B, H, W) int32)."""
    global LAUNCHES
    _check(corners, z, color, background)
    if corners.device.type == 'cpu':
        return hard_faces_reference(corners, z, color, background)
    b, f = z.shape
    h, w = background.shape[-2:]
    out = torch.empty((b, 3, h, w), dtype=torch.float32, device=corners.device)
    winner = torch.empty((b, h, w), dtype=torch.int32, device=corners.device)
    operands = [t.contiguous() for t in (corners, z, color, background)]
    with torch.cuda.device(corners.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = LIBRARY.load().tds_hard_faces(
            *[t.data_ptr() for t in operands], b, f, h, w, out.data_ptr(),
            winner.data_ptr(), stream)
    check_launch(err, 'tds_hard_faces')
    LAUNCHES += 1
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
        (winner,) = ctx.saved_tensors
        won = (winner >= 0)[:, None]
        g_bg = torch.where(won, torch.zeros_like(g), g) \
            if ctx.needs_input_grad[3] else None
        g_color = None
        if ctx.needs_input_grad[2]:
            b = g.shape[0]
            idx = winner.clamp(min=0).reshape(b, -1, 1).long().expand(-1, -1, 3)
            src = torch.where(won, g, torch.zeros_like(g)).reshape(b, 3, -1).transpose(1, 2)
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
