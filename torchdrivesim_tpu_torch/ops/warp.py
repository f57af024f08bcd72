"""
Background warp of the baked map texture (counterpart of
``torchdrivesim_tpu/ops/pallas_warp.py``): mip pyramid, level selection,
per-camera affine coefficients, and the plain PyTorch version of the
nearest-texel lookup that the fused render kernel inlines.

An orthographic camera view is an affine warp of the texture. The reference
resamples a 128 x 256 texel window in two axis-aligned passes (row index
first, then the column index evaluated at the ROUNDED row); this module
reproduces that index arithmetic in one pass, per pixel, so the texel
chosen is the reference's exactly.
"""
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

RES = 128        #: largest view the 256-texel window covers
WINDOW = 256     #: texture window column count (origins align to 128)
WIN_ROWS = 128   #: texture window row count (origins align to 8)
#: mip-selection safety factor: the chosen level's cell must be at least
#: ``fov * MIP_FACTOR / res`` so the rotated view fits the 128-row window
MIP_FACTOR = 1.55


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
