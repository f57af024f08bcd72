"""
Hard z-priority rasterization of per-camera face sets over a background
(counterpart of ``torchdrivesim_tpu/ops/pallas_rasterize.py:
rasterize_hard_pallas``): the operand preparation, and the two kernels it
dispatches to, by face count F, exactly as the reference does:

* F <= 127 (B6a): each face's z-rank (a count of strictly nearer faces, so
  equal z share a rank) and its RGB8 color share one int32, and a pixel's
  winner is one minimum;
* F > 127 (B6b): z as order-preserving float bits and the RGB8 color in
  two int32s, folded over chunks of :data:`FACE_CHUNK` faces.

:func:`raster_packed` and :func:`raster_chunked` launch the hand-written
CUDA kernels (``csrc/hard_raster.cu``) for CUDA tensors and run their plain
PyTorch versions for CPU tensors; :func:`rasterize_hard` is the whole
function and :func:`rasterize_hard_reference` the whole function on the
plain versions. Each 16 x 16 pixel tile of the kernels folds only the faces
that can reach it, an exact cull whose plain version is
:func:`hard_tile_keep_reference`; :func:`raster_chunked_listed_reference`
folds each tile's kept faces as the chunked kernel does.

Face colors are quantized to RGB8 (R in bits 16-23). Windings are
canonicalized by ``sign(area)``, so inside means three edge values >= 0;
faces with ``|area| <= 1e-9`` carry the sentinel and never win.
"""
import ctypes
import functools

import numpy as np
import torch

from torchdrivesim_tpu_torch import tracing
from torchdrivesim_tpu_torch.ops import warp
from torchdrivesim_tpu_torch.ops.build import KernelLibrary, check_launch
from torchdrivesim_tpu_torch.ops.prims import PRIM_TILE, tri_edge_out_reference
from torchdrivesim_tpu_torch.ops.rasterize import _edge_coefficients_edge_major

#: faces per chunk of the chunked kernel's fold
FACE_CHUNK = 128
#: most faces the packed kernel takes (7-bit rank)
MAX_PACKED_FACES = 127
#: packed-kernel sentinel: loses every minimum, never covers a pixel
PACKED_SENTINEL = 0x7FFFFFFF
#: chunked-kernel sentinel: the bits of +inf, above every finite z
Z_SENTINEL = 0x7F800000
_NO_COLOR = 1 << 24
_AREA_EPS = 1e-9
_INV255 = 1.0 / 255.0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures (see ``csrc/hard_raster.cu``):
    packed -- coef, packed and background pointers; batch, faces, res; the
    output pointer and the stream; chunked -- coef, zbits, rgb and
    background pointers, then the same."""
    for name, n_ptrs in (('tds_hard_raster_packed', 3),
                         ('tds_hard_raster_chunked', 4)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [
            ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


LIBRARY = KernelLibrary('hard_raster.cu', _bind)


def hard_operands(corners: torch.Tensor, z: torch.Tensor, colors: torch.Tensor):
    """
    The reference's operand preparation: z made unique by an index bump
    (``arange(F) * min(1e-4, 0.09 / F)``), edge coefficients scaled by
    ``sign(area)``, z shifted positive, colors packed to RGB8.

    Args:
        corners: (B, F, 3, 2) screen corners (row, col); z: (B, F) priority
            (lower on top); colors: (B, F, 3) in [0, 1].
    Returns:
        ``(coef, packed)`` for F <= 127: coef (B, 3, F, 3) float32 [edge,
        face, (a, b, c)], packed (B, F) int32 ``rank << 24 | RGB8``;
        ``(coef, zbits, rgb)`` otherwise: zbits and rgb (B, F) int32.
    """
    f = z.shape[1]
    z = z + torch.arange(f, dtype=z.dtype, device=z.device) * min(1e-4, 0.09 / max(f, 1))
    coef, area = _edge_coefficients_edge_major(corners)
    coef = (coef * torch.sign(area)[:, None, :, None]).to(torch.float32).contiguous()
    zpos = (z - z.amin(dim=1, keepdim=True) + 1.0).to(torch.float32).contiguous()
    valid = torch.abs(area) > _AREA_EPS
    c8 = torch.clamp(torch.round(colors * 255.0), 0, 255).to(torch.int32)
    rgb = (c8[..., 0] << 16) | (c8[..., 1] << 8) | c8[..., 2]
    if f <= MAX_PACKED_FACES:
        # a count, not a sort: faces with equal zpos share a rank
        rank = (zpos[:, None, :] < zpos[:, :, None]).sum(dim=-1, dtype=torch.int32)
        packed = torch.where(valid, (rank << 24) | rgb, PACKED_SENTINEL)
        return coef, packed.contiguous()
    zbits = torch.where(valid, zpos.view(torch.int32), Z_SENTINEL)
    return coef, zbits.contiguous(), rgb.contiguous()


def _pixel_centers(res: int, device):
    """(1, 1, res * res) row and column centers of the flat pixel index."""
    idx = torch.arange(res * res, device=device)
    px = (idx // res).to(torch.float32) + 0.5
    py = (idx % res).to(torch.float32) + 0.5
    return px[None, None], py[None, None]


def _inside(coef: torch.Tensor, s: int, e: int, px, py) -> torch.Tensor:
    """(B, e - s, P) whether each pixel lies inside faces s .. e-1."""
    def edge(k):
        c = lambda j: coef[:, k, s:e, j][..., None]
        return warp.affine(c(0), px, c(1), py, c(2))
    emin = torch.minimum(torch.minimum(edge(0), edge(1)), edge(2))
    return emin >= 0


def _composite(covered: torch.Tensor, w: torch.Tensor, bg_flat: torch.Tensor,
               res: int) -> torch.Tensor:
    rgb = torch.stack([(w >> 16) & 255, (w >> 8) & 255, w & 255], dim=1)
    img = torch.where(covered[:, None], rgb.to(torch.float32) * _INV255, bg_flat)
    return img.reshape(bg_flat.shape[0], 3, res, res)


def raster_packed_reference(coef: torch.Tensor, packed: torch.Tensor,
                            background: torch.Tensor, res: int,
                            face_chunk: int = 16) -> torch.Tensor:
    """Plain PyTorch version of the packed kernel: (B, 3, res, res) in
    [0, 1], the minimum pack of the inside faces where it is below
    ``127 << 24``, else the background. Faces are visited ``face_chunk`` at
    a time to bound memory; the minimum does not depend on the order."""
    b, f = packed.shape
    px, py = _pixel_centers(res, coef.device)
    best = torch.full((b, res * res), PACKED_SENTINEL, dtype=torch.int32,
                      device=coef.device)
    for s in range(0, f, face_chunk):
        e = min(f, s + face_chunk)
        vals = torch.where(_inside(coef, s, e, px, py), packed[:, s:e, None],
                           PACKED_SENTINEL)
        best = torch.minimum(best, vals.amin(dim=1))
    return _composite(best < (127 << 24), best,
                      background.reshape(b, 3, res * res), res)


def raster_chunked_reference(coef: torch.Tensor, zbits: torch.Tensor,
                             rgb: torch.Tensor, background: torch.Tensor,
                             res: int) -> torch.Tensor:
    """Plain PyTorch version of the chunked kernel: per chunk of
    :data:`FACE_CHUNK` faces, the minimum z-bits of the inside faces and the
    minimum RGB8 among the faces with exactly those bits; a later chunk
    replaces the running winner only if strictly less. Covered iff the
    winner is below :data:`Z_SENTINEL`."""
    b, f = zbits.shape
    px, py = _pixel_centers(res, coef.device)
    bz = torch.full((b, res * res), Z_SENTINEL, dtype=torch.int32, device=coef.device)
    br = torch.full_like(bz, _NO_COLOR)
    for s in range(0, f, FACE_CHUNK):
        e = min(f, s + FACE_CHUNK)
        zv = torch.where(_inside(coef, s, e, px, py), zbits[:, s:e, None], Z_SENTINEL)
        cz = zv.amin(dim=1)
        cr = torch.where(zv == cz[:, None], rgb[:, s:e, None], _NO_COLOR).amin(dim=1)
        br = torch.where(cz < bz, cr, br)
        bz = torch.minimum(bz, cz)
    return _composite(bz < Z_SENTINEL, br, background.reshape(b, 3, res * res), res)


def hard_tiles(res: int) -> int:
    """The kernels' 16 x 16 pixel tiles per camera, ``ceil(res / 16)^2``
    (a ragged last row and column of tiles where 16 does not divide
    ``res``)."""
    return (-(-res // PRIM_TILE)) ** 2


def _tile_centres(res: int, device):
    """Each tile row's (column's) first and last pixel centre in float64,
    the last clamped to the frame."""
    start = torch.arange(0, res, PRIM_TILE, device=device)
    return start.double() + 0.5, torch.clamp(start + PRIM_TILE, max=res).double() - 0.5


def hard_tile_keep_reference(coef: torch.Tensor, key: torch.Tensor, sentinel: int,
                             res: int) -> torch.Tensor:
    """
    Plain version of the kernels' per-tile face cull
    (``csrc/hard_raster.cu``): a face is dropped from a 16 x 16 pixel tile
    iff its key is ``sentinel`` or one of its three edges is negative at
    every pixel centre of the tile by the primitive winner's float64 test
    (``prims.tri_edge_out_reference``, ``csrc/prim_winner.cuh:
    tri_edge_out``, whose header argues why it is exact), the last tile row
    and column clamped to the frame. Not on any main path: the tests and
    ``chip_smoke.py`` use it.

    Args:
        coef: (B, 3, F, 3) as :func:`hard_operands` gives it; key: (B, F)
            packs or z-bits; sentinel: :data:`PACKED_SENTINEL` or
            :data:`Z_SENTINEL`.
    Returns:
        (B, tiles, F) bool, tiles row-major (:func:`hard_tiles`).
    """
    lo, hi = _tile_centres(res, coef.device)
    out = tri_edge_out_reference(coef[:, 0], lo, hi, lo, hi)
    for k in (1, 2):
        out |= tri_edge_out_reference(coef[:, k], lo, hi, lo, hi)
    keep = ~out & (key != sentinel)[..., None, None]
    return keep.flatten(2).transpose(1, 2)


def raster_chunked_listed_reference(coef: torch.Tensor, zbits: torch.Tensor,
                                    rgb: torch.Tensor, background: torch.Tensor,
                                    res: int) -> torch.Tensor:
    """The chunked kernel's function as it computes it: each tile folds the
    faces :func:`hard_tile_keep_reference` keeps, in ascending order, one run
    per chunk of :data:`FACE_CHUNK` faces (the run's minimum z-bits and the
    minimum RGB8 among the inside faces with exactly those bits), each run
    replacing the running winner only if strictly less. Equals
    :func:`raster_chunked_reference` bit for bit; the tests hold the two
    together. (The packed kernel's minimum is order-free, so its fold over
    the kept faces equals the unculled one as soon as no dropped face is
    inside at any pixel of its tile.)"""
    keep = hard_tile_keep_reference(coef, zbits, Z_SENTINEL, res)
    b = zbits.shape[0]
    bz = torch.full((b, res, res), Z_SENTINEL, dtype=torch.int32, device=coef.device)
    br = torch.full_like(bz, _NO_COLOR)
    per = -(-res // PRIM_TILE)
    for cam in range(b):
        for t in range(per * per):
            r0, c0 = (t // per) * PRIM_TILE, (t % per) * PRIM_TILE
            rows = slice(r0, min(r0 + PRIM_TILE, res))
            cols = slice(c0, min(c0 + PRIM_TILE, res))
            px = (torch.arange(r0, rows.stop, device=coef.device).float() + 0.5)[:, None]
            py = (torch.arange(c0, cols.stop, device=coef.device).float() + 0.5)[None, :]
            tz, tr = bz[cam, rows, cols], br[cam, rows, cols]
            faces = keep[cam, t].nonzero()[:, 0]               # ascending
            for chunk in torch.unique(faces // FACE_CHUNK).tolist():
                run = faces[faces // FACE_CHUNK == chunk]
                k = lambda e, j: coef[cam, e, run, j][:, None, None]
                inside = functools.reduce(torch.logical_and, [
                    warp.affine(k(e, 0), px, k(e, 1), py, k(e, 2)) >= 0 for e in range(3)])
                zv = torch.where(inside, zbits[cam, run][:, None, None], Z_SENTINEL)
                cz = zv.amin(dim=0)
                cr = torch.where(zv == cz, rgb[cam, run][:, None, None],
                                 _NO_COLOR).amin(dim=0)
                tr.copy_(torch.where(cz < tz, cr, tr))
                tz.copy_(torch.minimum(tz, cz))
    return _composite(bz.reshape(b, -1) < Z_SENTINEL, br.reshape(b, -1),
                      background.reshape(b, 3, res * res), res)


def _check(coef: torch.Tensor, ints, background: torch.Tensor, res: int) -> None:
    b = coef.shape[0]
    f = ints[0].shape[1]
    if res < 1:
        raise ValueError(f'res must be positive, got {res}')
    want = [('coef', coef, torch.float32, (b, 3, f, 3)),
            ('background', background, torch.float32, (b, 3, res, res))]
    want += [(f'int operand {i}', t, torch.int32, (b, f)) for i, t in enumerate(ints)]
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f'{name}: expected {dtype} {shape}, got '
                             f'{t.dtype} {tuple(t.shape)}')
        if t.device != coef.device:
            raise ValueError(f'{name} is on {t.device}, coef on {coef.device}')
    if coef.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no hard raster for device {coef.device}')
    if b > 65535:
        raise ValueError(f'at most 65535 cameras per launch, got {b}')


def _launch(entry: str, coef, ints, background, res):
    b, f = ints[0].shape
    out = torch.empty((b, 3, res, res), dtype=torch.float32, device=coef.device)
    operands = [coef.contiguous()] + [t.contiguous() for t in ints] \
        + [background.contiguous()]
    with torch.cuda.device(coef.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(LIBRARY.load(), entry)(
            *[t.data_ptr() for t in operands], b, f, res, out.data_ptr(), stream)
    check_launch(err, entry)
    return out


def raster_packed(coef: torch.Tensor, packed: torch.Tensor,
                  background: torch.Tensor, res: int) -> torch.Tensor:
    """The packed kernel (B6a) on CUDA tensors, its plain version on CPU
    tensors; operands as :func:`hard_operands` gives them, background
    (B, 3, res, res). Returns (B, 3, res, res) in [0, 1]."""
    _check(coef, [packed], background, res)
    if packed.shape[1] > MAX_PACKED_FACES:
        raise ValueError(f'the packed kernel takes at most {MAX_PACKED_FACES} '
                         f'faces, got {packed.shape[1]}')
    if coef.device.type == 'cpu':
        return raster_packed_reference(coef, packed, background, res)
    out = _launch('tds_hard_raster_packed', coef, [packed], background, res)
    tracing.count('launch.B6a')
    return out


def raster_chunked(coef: torch.Tensor, zbits: torch.Tensor, rgb: torch.Tensor,
                   background: torch.Tensor, res: int) -> torch.Tensor:
    """The chunked kernel (B6b) on CUDA tensors, its plain version on CPU
    tensors; operands as :func:`hard_operands` gives them."""
    _check(coef, [zbits, rgb], background, res)
    if coef.device.type == 'cpu':
        return raster_chunked_reference(coef, zbits, rgb, background, res)
    out = _launch('tds_hard_raster_chunked', coef, [zbits, rgb], background, res)
    tracing.count('launch.B6b')
    return out


def raster(ops, background: torch.Tensor, res: int) -> torch.Tensor:
    """The kernel for :func:`hard_operands`' ``ops``: :func:`raster_packed`
    for two operands, :func:`raster_chunked` for three."""
    if len(ops) == 2:
        return raster_packed(*ops, background, res)
    return raster_chunked(*ops, background, res)


def raster_reference(ops, background: torch.Tensor, res: int) -> torch.Tensor:
    """:func:`raster` on the plain versions of both kernels."""
    if len(ops) == 2:
        return raster_packed_reference(*ops, background, res)
    return raster_chunked_reference(*ops, background, res)


def rasterize_hard(corners: torch.Tensor, z: torch.Tensor, colors: torch.Tensor,
                   res: int, background: torch.Tensor) -> torch.Tensor:
    """
    Hard z-priority rasterization of per-camera faces over ``background``.

    Args:
        corners: (B, F, 3, 2) screen corners (row, col); z: (B, F) priority
            (lower on top); colors: (B, F, 3) in [0, 1].
        background: (B, 3, res, res) channels-first image.
    Returns:
        (B, 3, res, res) image in [0, 1].
    """
    return raster(hard_operands(corners, z, colors), background, res)


def rasterize_hard_reference(corners: torch.Tensor, z: torch.Tensor,
                             colors: torch.Tensor, res: int,
                             background: torch.Tensor) -> torch.Tensor:
    """:func:`rasterize_hard` on the plain versions of both kernels."""
    return raster_reference(hard_operands(corners, z, colors), background, res)


def random_faces(seed: int, b: int, n_faces: int, res: int, device):
    """
    A random scene for holding the kernels against their plain versions:
    faces over the view and beyond, both windings, every fifth degenerate,
    z on four levels (so ties), and a random background.

    Returns:
        (corners (B, F, 3, 2), z (B, F), colors (B, F, 3), background
        (B, 3, res, res)), float32 on ``device``.
    """
    rng = np.random.RandomState(seed)
    corners = rng.uniform(-8, res + 8, (b, n_faces, 3, 2))
    corners[:, 4::5, 2] = corners[:, 4::5, 0]
    z = rng.randint(0, 4, (b, n_faces)) * 2.0 + 3.0
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return (t(corners), t(z), t(rng.rand(b, n_faces, 3)),
            t(rng.rand(b, 3, res, res)))
