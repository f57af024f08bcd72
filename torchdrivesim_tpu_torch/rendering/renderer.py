"""
The port's bird's-eye-view renderer (counterpart of
``torchdrivesim_tpu/rendering/jax_renderer.py``):

* typed primitives (``render_prims_chw``): composited over the baked map
  texture by the fused render where a mip level covers the view (up to
  128 pixels; a larger view as n x n sub-camera views of at most 128
  pixels in one launch; past the per-type cap of 56 or the 127-primitive
  rank space each type sorted and capped first); over the background
  color without a texture, or over the
  full-resolution nearest sample of the texture where no mip level covers
  the view, by the banded primitive raster (any multiple of 16); in
  differentiable mode by the reference's plain fallback (the prims culled
  to the view, quads split into triangle pairs, the float-color hard raster
  ``ops.hard_faces``, kernel HF, over the full-resolution sample or the
  color);
* the hard mesh render: the z-priority raster over the nearest mip warp of
  the texture, or its full-resolution nearest sample where no mip level
  covers the view (faces culled to the view), or over the constant
  background color (every face);
* the differentiable mesh render: the soft raster, any face count at any
  multiple of 16, over the bilinear mip warp of the texture where a mip
  level covers the view, else over its full-resolution bilinear sample
  (``sample_background_quad``, also with ``diff_fast_background=False``),
  or over the constant background color; with ``soft_blend`` other than
  'softmax' the painter's blend (``rasterize_soft``) over the same
  backgrounds;
* an explicit ``background_texture=`` of the mesh renders: its bilinear
  sample (``sample_background``) under the hard raster (faces culled) or
  the soft raster;
* the face-soup render (``render_faces_chw``, the faces of
  ``BirdviewRGBMeshGenerator.generate_faces``): culled to
  ``cfg.cull_max_faces``, the hard raster over the nearest mip warp, the
  full-resolution nearest sample or the color; in differentiable mode the
  float-color hard raster (HF) over the full-resolution nearest sample.

A square resolution that is not a multiple of 16 renders at the next
multiple of 16, at the same pixels per meter, and returns the top-left crop.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torchdrivesim_tpu_torch.mesh import RGBMesh
from torchdrivesim_tpu_torch.ops.fused import MAX_CAMERAS, render_coefs_fused
from torchdrivesim_tpu_torch.ops.grids import Grid2D
from torchdrivesim_tpu_torch.ops.hard import hard_operands, raster
from torchdrivesim_tpu_torch.ops.hard_faces import rasterize_hard_faces
from torchdrivesim_tpu_torch.ops.prims import prep_prims, rasterize_hard_prims_banded
from torchdrivesim_tpu_torch.ops.rasterize import (
    camera_rows_cols, cull_faces_to_view, cull_prims_to_view, face_arrays,
    n_bands_for, pack_texture_rgb8, pack_texture_rgb8_quad, prep_sorted_prim_coefs,
    rasterize_soft, sample_background, sample_background_packed,
    sample_background_quad, sort_prims_rowmajor_with_masks, supports_res,
)
from torchdrivesim_tpu_torch.ops.soft import rasterize_softmax_coefs, soft_coefficients
from torchdrivesim_tpu_torch.ops.warp import (
    MIP_FACTOR, MipLevel, RES, build_mip_pyramid, select_mip, warp_background_diff,
    warp_coefficients, warp_view_nearest,
)
from torchdrivesim_tpu_torch.rendering.base import (
    BirdviewRenderer, Cameras, RendererConfig,
)
from torchdrivesim_tpu_torch.utils import Resolution

logger = logging.getLogger(__name__)


def pack_rgb8_chw(image: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) float [0, 255] -> (B, H, W) int32 0x00BBGGRR."""
    q = torch.clamp(torch.round(image), 0, 255).to(torch.int32)
    return q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)


def _subcamera_offsets(size: int, sub: int, scale: float, left_handed: bool,
                       n: int):
    """Host constants of the n x n sub-camera decomposition of a ``size``
    view into ``sub``-pixel tiles, row-major (tile (i, j) is n * i + j):
    (nt, 2) float32 pixel offsets of the tiles' top-left corners, and
    (nt, 2) float32 (forward, left) offsets in meters of the tiles' centers
    from the view's center, spelled as the reference spells them so that
    the sub-camera centers equal its float32 values."""
    ppm = scale * size / 2.0                 # output pixels per meter
    offs = np.asarray([[i * sub, j * sub] for i in range(n)
                       for j in range(n)], np.float32)
    lh = -1.0 if left_handed else 1.0
    off_f = (size / 2.0 - offs[:, 0] - sub / 2.0) / ppm
    off_l = lh * (size / 2.0 - offs[:, 1] - sub / 2.0) / ppm
    return offs, np.stack([off_f, off_l], axis=-1)


def _expand_subcameras(sq, st, qz, qcol, tz, tcol, cam_xy, cam_sc, offs, off_fl):
    """
    The n x n sub-camera views of each camera: tile (i, j) of a view is a
    view of its own at the same pixels per meter, centered on the tile's
    world center. Screen-space prims shift by the tile's pixel offset
    ``offs``; camera centers by its (forward, left) offset ``off_fl``
    rotated into the world (the inverse of the screen transform: pixel
    (r, c) lies at ``cam + R(psi) @ (forward, left)``).

    Returns:
        the per-sub-view tensors, the tile index fastest in the leading
        dim, so consecutive sub-views assemble into whole images.
    """
    bl, nt = qz.shape[0], offs.shape[0]
    shift = lambda p: (p[:, None] - offs[None, :, None, None, :]).reshape(
        (bl * nt,) + p.shape[1:])
    rep = lambda x: torch.repeat_interleave(x, nt, dim=0)
    off_f, off_l = off_fl[None, :, 0], off_fl[None, :, 1]
    sin, cos = cam_sc[:, 0:1], cam_sc[:, 1:2]
    cx = cam_xy[:, 0:1] + cos * off_f - sin * off_l
    cy = cam_xy[:, 1:2] + sin * off_f + cos * off_l
    cam_xy_sub = torch.stack([cx, cy], dim=-1).reshape(bl * nt, 2)
    return (shift(sq), shift(st), rep(qz), rep(qcol), rep(tz), rep(tcol),
            cam_xy_sub, rep(cam_sc))


def _assemble_tiles(image: torch.Tensor, size: int, n: int) -> torch.Tensor:
    """Stitch n x n tile renders (tile fastest in the leading dim,
    row-major) into whole frames: float (B n^2, 3, s, s) or packed
    (B n^2, s, s) int32 input."""
    s = size // n
    bl = image.shape[0] // (n * n)
    if image.dim() == 3:
        return image.reshape(bl, n, n, s, s).permute(0, 1, 3, 2, 4).reshape(
            bl, size, size)
    return image.reshape(bl, n, n, 3, s, s).permute(0, 3, 1, 4, 2, 5).reshape(
        bl, 3, size, size)


def _pad_camera_shift(cam_xy: torch.Tensor, cam_sc: torch.Tensor, size: int,
                      size_pad: int, ppm: float, left_handed: bool) -> torch.Tensor:
    """Camera centers for pad-and-crop: the TOP-LEFT ``size`` x ``size``
    crop of a ``size_pad``-pixel render at the same pixels per meter shows
    exactly the requested view."""
    lh = -1.0 if left_handed else 1.0
    d = (size_pad - size) / 2.0 / ppm
    sin, cos = cam_sc[:, 0], cam_sc[:, 1]
    cx = cam_xy[:, 0] - (cos * d - sin * lh * d)
    cy = cam_xy[:, 1] - (sin * d + cos * lh * d)
    return torch.stack([cx, cy], dim=-1)


def fused_prim_operands(sq, qz, qcolors, st, tz, tcolors, size: int, cap: int,
                        force_sort: bool = False):
    """
    The fused render's primitive operands of screen-space prims: those of
    ``prep_sorted_prim_coefs`` where both types fit the per-type ``cap``
    and the 127-primitive rank space; else, as the reference's sort branch,
    each type row-major sorted and capped to the ``cap`` prims nearest the
    view's center (``sort_prims_rowmajor_with_masks``), then packed by
    ``prims.prep_prims``. Where both apply the two give the same image bit
    for bit; ``force_sort`` takes the second.

    Returns:
        ((qcoef, qpk, qmask, tcoef, tpk, tmask), whether the sort route ran).
    """
    n_bands = n_bands_for(size)
    if not force_sort:
        prep = prep_sorted_prim_coefs(sq, qz, qcolors, st, tz, tcolors, size,
                                      cap, n_bands)
        if prep is not None:
            return prep, False
    sq, qz, qcolors, qmask = sort_prims_rowmajor_with_masks(sq, qz, qcolors, size,
                                                            cap, n_bands)
    st, tz, tcolors, tmask = sort_prims_rowmajor_with_masks(st, tz, tcolors, size,
                                                            cap, n_bands)
    qcoef, qpk, tcoef, tpk = prep_prims(sq, qz, qcolors, st, tz, tcolors)
    return (qcoef, qpk, qmask, tcoef, tpk, tmask), True


class Renderer(BirdviewRenderer):
    """
    Renders typed primitives, per-camera meshes and face soups over
    :attr:`background_texture` on ``device``.

    Args:
        cfg: renderer switches.
        device: where the frames are made.
        res / fov: default view size and field of view (meters).
    """
    def __init__(self, cfg: RendererConfig, device,
                 color_map: Optional[Dict[str, Tuple[int, int, int]]] = None,
                 rendering_levels: Optional[Dict[str, float]] = None,
                 res: Resolution = Resolution(64, 64), fov: float = 35):
        super().__init__(cfg, device, color_map, rendering_levels, res, fov)
        #: background color in [0, 1] for off-texture pixels, on the device
        self._background_color = torch.tensor(
            self.get_color('background'), dtype=torch.float32,
            device=self.device) / 255.0
        self._background_texture: Optional[Grid2D] = None
        self._mip_pyramid: Optional[List[MipLevel]] = None
        self._packed_texture: Optional[Grid2D] = None
        #: the quad-packed texture of the full-resolution bilinear
        #: background, built at first use (:meth:`_quad_texture`)
        self._quad: Optional[Grid2D] = None
        #: device copies of :func:`_subcamera_offsets`, by its arguments
        self._tile_offsets: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        #: (quads, triangles) per camera whose sort route has been logged
        self._warned_sort = set()

    def copy(self) -> "Renderer":
        """:meth:`BirdviewRenderer.copy` sharing this renderer's texture and
        the device tables built from it."""
        other = super().copy()
        other._background_texture = self._background_texture
        other._mip_pyramid = self._mip_pyramid
        other._packed_texture = self._packed_texture
        other._quad = self._quad
        return other

    @property
    def background_texture(self) -> Optional[Grid2D]:
        return self._background_texture

    @background_texture.setter
    def background_texture(self, texture: Optional[Grid2D]):
        """Set the (H, W, 3) float texture (host numpy data); builds the
        packed mip pyramid and the packed full-resolution texture (the
        background of views no mip level covers) on the host and moves them
        to the device."""
        self._background_texture = texture
        self._mip_pyramid = None
        self._packed_texture = None
        self._quad = None
        if texture is not None:
            self._mip_pyramid = [
                level.to(self.device) for level in build_mip_pyramid(
                    np.asarray(texture.data), np.asarray(texture.origin),
                    texture.cell_size)]
            self._packed_texture = Grid2D(
                data=torch.from_numpy(pack_texture_rgb8(texture.data)[..., None]
                                      ).to(self.device),
                origin=torch.as_tensor(np.asarray(texture.origin, np.float32),
                                       device=self.device),
                cell_size=float(texture.cell_size))

    def _quad_texture(self) -> Grid2D:
        """The texture packed for the full-resolution bilinear background
        (``pack_texture_rgb8_quad``, (H, W, 4) int32 on the device), built
        on the host the first time a view needs it."""
        if self._quad is None:
            tex = self._background_texture
            self._quad = Grid2D(
                data=torch.from_numpy(pack_texture_rgb8_quad(tex.data)).to(self.device),
                origin=self._packed_texture.origin, cell_size=float(tex.cell_size))
        return self._quad

    def _warp_mip(self, scale: float, size: int) -> Optional[MipLevel]:
        """The mip level for the fused render and the nearest warp, or None
        when they cannot serve this camera (no texture, a resolution above
        128 or not a multiple of 16, or a view too wide for the coarsest
        mip)."""
        if self._mip_pyramid is None or size > RES or not supports_res(size):
            return None
        fov = 2.0 / scale
        mip = select_mip(self._mip_pyramid, fov=fov, res=size)
        if mip.cell_size < fov * MIP_FACTOR / size:
            return None
        return mip

    @property
    def _prim_cap(self) -> int:
        """Per-type primitive cap of the primitive render: at most 56, as
        both types share the 7-bit rank."""
        return min(max(8, self.cfg.band_budget), 56)

    def _tiled_mip(self, scale: float, size: int):
        """The n x n sub-camera decomposition of a textured view above 128
        pixels: ``(mip, sub, n)``, each tile a ``sub = size / n``-pixel view
        at the same texels per pixel (the mip level is chosen at the full
        size), n the smallest divisor of ``size`` whose tiles fit the
        fused render's window and the banded tiling (2 at 192 and 256, 3 at
        144 and 384, 4 at 512); None when the view is not above 128, has
        no such divisor or no mip level covers it."""
        if self._mip_pyramid is None or size <= RES:
            return None
        n = next((k for k in range(2, size // 16 + 1)
                  if size % k == 0 and size // k <= RES and supports_res(size // k)),
                 None)
        if n is None:
            return None
        fov = 2.0 / scale
        mip = select_mip(self._mip_pyramid, fov=fov, res=size)
        if mip.cell_size < fov * MIP_FACTOR / size:
            return None
        return mip, size // n, n

    def subcamera_offsets(self, size: int, sub: int, scale: float, n: int):
        """:func:`_subcamera_offsets` as tensors on the device, copied there
        once per view size and scale, so a frame copies nothing."""
        key = (size, sub, float(scale), self.cfg.left_handed_coordinates, n)
        if key not in self._tile_offsets:
            self._tile_offsets[key] = tuple(
                torch.from_numpy(x).to(self.device) for x in _subcamera_offsets(
                    size, sub, scale, self.cfg.left_handed_coordinates, n))
        return self._tile_offsets[key]

    @staticmethod
    def _pad_res_target(size: int) -> Optional[int]:
        """The resolution a square ``size`` that the banded kernels cannot
        tile (not a multiple of 16, e.g. 100) renders at: the next multiple
        of 16, or None when ``size`` is served as it is."""
        if size < 4 or supports_res(size):
            return None
        pad = -(-size // 16) * 16
        return pad if supports_res(pad) else None

    def _pad_cameras(self, cameras: Cameras, size: int, pad_to: int) -> Cameras:
        """``cameras`` moved and rescaled so that the top-left ``size``
        pixels of a ``pad_to`` render show their ``size`` view."""
        ppm = cameras.scale * size / 2.0
        cam_xy = _pad_camera_shift(cameras.xy, cameras.sc, size, pad_to, ppm,
                                   self.cfg.left_handed_coordinates)
        return Cameras(cam_xy, cameras.sc, cameras.scale * size / pad_to)

    def _full_background(self, cameras: Cameras, size: int) -> torch.Tensor:
        """(B, 3, size, size) background in [0, 1] for views no mip level
        serves: the nearest full-resolution sample of the texture, or the
        background color, expanded (never written out), without one."""
        if self._packed_texture is not None:
            tex = self._packed_texture
            return sample_background_packed(
                tex.data[..., 0], tex.origin, tex.cell_size, cameras.xy, cameras.sc,
                cameras.scale, size, self._background_color,
                left_handed=self.cfg.left_handed_coordinates,
                downsample=self.cfg.background_downsample)
        return self._background_color[None, :, None, None].expand(
            cameras.xy.shape[0], 3, size, size)

    def render_prims_chw(self, quads: torch.Tensor, qz: torch.Tensor,
                         qcolors: torch.Tensor, tris: torch.Tensor,
                         tz: torch.Tensor, tcolors: torch.Tensor,
                         res: Resolution, cameras: Cameras,
                         packed: bool = False) -> torch.Tensor:
        """
        Render world-space quads (cycle order) and triangles from
        ``BirdviewRGBMeshGenerator.generate_prims`` over the baked texture
        (the fused render where a mip level covers the view, else the
        banded raster over its full-resolution nearest sample), or over the
        background color without a texture (the banded raster); in
        differentiable mode by :meth:`_render_prims_plain`.

        Returns:
            (B, 3, H, W) float image in [0, 255], or (B, H, W) int32 packed
            0x00BBGGRR when ``packed``.
        """
        assert res.width == res.height, "only square resolutions are supported"
        size = res.width
        pad_to = self._pad_res_target(size)
        if pad_to is not None:
            image = self.render_prims_chw(
                quads, qz, qcolors, tris, tz, tcolors, Resolution(pad_to, pad_to),
                self._pad_cameras(cameras, size, pad_to), packed=packed)
            return image[..., :size, :size]
        if not supports_res(size):
            raise NotImplementedError(
                f"res {size}: the primitive render serves sizes the banded "
                "kernels tile (multiples of 16) and pads others from 4 up")
        if self.cfg.differentiable:
            image = self._render_prims_plain(quads, qz, qcolors, tris, tz, tcolors,
                                             size, cameras) * 255.0
            return pack_rgb8_chw(image) if packed else image
        fused = self.fused_frame_operands(quads, qz, qcolors, tris, tz, tcolors,
                                          size, cameras)
        if fused is not None:
            mip, ops, size_k, n, _ = fused
            image = render_coefs_fused(mip, *ops, size_k, packed)
            if n > 1:
                image = _assemble_tiles(image, size, n)
            return image if packed else image * 255.0
        scene, background, qmask, tmask = self.banded_frame_operands(
            quads, qz, qcolors, tris, tz, tcolors, size, cameras)
        image = rasterize_hard_prims_banded(*scene, size, background, qmask,
                                            tmask) * 255.0
        return pack_rgb8_chw(image) if packed else image

    def fused_frame_operands(self, quads, qz, qcolors, tris, tz, tcolors,
                             size: int, cameras: Cameras, force_sort: bool = False):
        """
        The fused render's operands for a frame a mip level serves, as
        :meth:`render_prims_chw` passes them to
        ``ops.fused.render_coefs_fused``; above 128 pixels those of the
        n x n sub-camera views (:meth:`_tiled_mip`), every sub-view with
        its own sort, cap and band masks, all in one launch. The primitive
        operands are :func:`fused_prim_operands`' (``force_sort`` takes its
        sort route under the cap too).

        Returns:
            ``(mip, (fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask),
            size_k, n, (sq, st))``, the frame rendered as B n^2 views of
            ``size_k`` pixels (n = 1 up to 128), with the views' unsorted
            screen-space quads and triangles; or None when no mip level
            serves the view.
        """
        mip, size_k, n = self._warp_mip(cameras.scale, size), size, 1
        if mip is None:
            tiled = self._tiled_mip(cameras.scale, size)
            if tiled is None:
                return None
            mip, size_k, n = tiled
        b = qz.shape[0]
        if b * n * n > MAX_CAMERAS:
            raise ValueError(
                f"{b} cameras at res {size} render as {b * n * n} sub-views of "
                f"{size_k} pixels, above the fused render's {MAX_CAMERAS} "
                "cameras per launch; render the batch in parts")
        sq, st = self.screen_prims(quads, tris, size, cameras)
        cam_xy, cam_sc, scale_k = cameras.xy, cameras.sc, cameras.scale
        if n > 1:
            offs, off_fl = self.subcamera_offsets(size, size_k, cameras.scale, n)
            sq, st, qz, qcolors, tz, tcolors, cam_xy, cam_sc = _expand_subcameras(
                sq, st, qz, qcolors, tz, tcolors, cam_xy, cam_sc, offs, off_fl)
            scale_k = cameras.scale * size / size_k
        (qcoef, qpk, qmask, tcoef, tpk, tmask), sorted_ = fused_prim_operands(
            sq, qz, qcolors, st, tz, tcolors, size_k, self._prim_cap, force_sort)
        key = (qz.shape[1], tz.shape[1])
        if sorted_ and not force_sort and key not in self._warned_sort:
            self._warned_sort.add(key)
            logger.warning(
                '%d quads / %d triangles per camera exceed the per-type cap %d or '
                'the 127-primitive rank space: the fused render sorts and caps '
                'each type first, keeping the prims nearest the view center',
                key[0], key[1], self._prim_cap)
        fcoef, icoef = warp_coefficients(
            mip, cam_xy, cam_sc, scale_k, self._background_color,
            left_handed=self.cfg.left_handed_coordinates, res=size_k)
        return (mip, (fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask), size_k, n,
                (sq, st))

    def _render_prims_plain(self, quads, qz, qcolors, tris, tz, tcolors, size: int,
                            cameras: Cameras) -> torch.Tensor:
        """
        The reference's plain fallback of the primitive render, which its
        differentiable mode takes: each type culled to the
        ``min(max(8, (cull_max_faces or 64) // 2), 56)`` prims nearest the
        view's center, each quad split into the triangles (0, 1, 2) and
        (0, 2, 3), the second at z + 1e-5, then the reference's float-color
        hard raster (``ops.hard_faces.rasterize_hard_faces``: HF on the card)
        over the full-resolution sample of the texture or the background
        color.

        Returns:
            (B, 3, size, size) in [0, 1].
        """
        return rasterize_hard_faces(*self.prims_plain_operands(
            quads, qz, qcolors, tris, tz, tcolors, size, cameras))

    def prims_plain_operands(self, quads, qz, qcolors, tris, tz, tcolors, size: int,
                             cameras: Cameras):
        """
        The operands :meth:`_render_prims_plain` hands the hard face raster:
        (corners (B, F, 3, 2), z (B, F), colors (B, F, 3), background (B, 3,
        size, size)), F the kept quads twice (their two triangles) and the
        kept triangles.
        """
        sq, st = self.screen_prims(quads, tris, size, cameras)
        keep = min(max(8, (self.cfg.cull_max_faces or 64) // 2), 56)
        sq, qz, qcolors = cull_prims_to_view(sq, qz, qcolors, size, keep)
        st, tz, tcolors = cull_prims_to_view(st, tz, tcolors, size, keep)
        corners = torch.cat([sq[:, :, [0, 1, 2]], sq[:, :, [0, 2, 3]], st], dim=1)
        z = torch.cat([qz, qz + 1e-5, tz], dim=1)
        colors = torch.cat([qcolors, qcolors, tcolors], dim=1)
        return corners, z, colors, self._full_background(cameras, size)

    def screen_prims(self, quads: torch.Tensor, tris: torch.Tensor, size: int,
                     cameras: Cameras):
        """World-space quads (B, Q, 4, 2) and triangles (B, T, 3, 2) ->
        their (row, col) screen corners in a ``size`` view."""
        def rows_cols(p):
            b, n, k = p.shape[:3]
            return camera_rows_cols(
                p.reshape(b, n * k, 2), cameras.xy, cameras.sc, cameras.scale, size,
                left_handed=self.cfg.left_handed_coordinates).reshape(b, n, k, 2)
        return rows_cols(quads), rows_cols(tris)

    def banded_frame_operands(self, quads, qz, qcolors, tris, tz, tcolors,
                              size: int, cameras: Cameras):
        """
        The banded raster's operands for a frame that no mip level serves,
        as :meth:`render_prims_chw` passes them to
        ``ops.prims.rasterize_hard_prims_banded``: each type's screen-space
        prims row-major sorted and capped (``cfg.band_budget``, at most 56)
        with their band x chunk masks, over the background.

        Returns:
            ``((quads, qz, qcolors, tris, tz, tcolors), background, qmask,
            tmask)``: the background (B, 3, size, size) in [0, 1], the
            full-resolution nearest sample of the texture or the background
            color expanded.
        """
        n_bands = n_bands_for(size)
        sq, st = self.screen_prims(quads, tris, size, cameras)
        sq, qz, qcolors, qmask = sort_prims_rowmajor_with_masks(
            sq, qz, qcolors, size, self._prim_cap, n_bands)
        st, tz, tcolors, tmask = sort_prims_rowmajor_with_masks(
            st, tz, tcolors, size, self._prim_cap, n_bands)
        return ((sq, qz, qcolors, st, tz, tcolors),
                self._full_background(cameras, size), qmask, tmask)

    def render_rgb_mesh_chw(self, mesh: RGBMesh, res: Resolution, cameras: Cameras,
                            background_texture: Optional[Grid2D] = None) -> torch.Tensor:
        """
        Render a per-camera RGB mesh (world-space (x, y, priority z)
        vertices, as from ``BirdviewRGBMeshGenerator.generate``).

        Hard mode (the default): the z-priority raster (``ops/hard.py``) over
        the nearest mip warp of the background texture (its full-resolution
        nearest sample where no mip level covers the view), the faces culled
        to the ``cfg.cull_max_faces`` nearest the view's center, or, with no
        texture, over the background color with every face.

        Differentiable mode (``cfg.differentiable``): the soft raster, any
        number of faces (the grouped path above 128 faces or above 128
        pixels), over the bilinear mip warp of the texture (pose gradients
        by ``warp_background_diff``) where a mip level covers the view and
        ``cfg.diff_fast_background``, else over its full-resolution
        bilinear sample (``sample_background_quad``, exact bilinear pose
        gradients), or over the background color without a texture. With
        ``cfg.soft_blend`` other than 'softmax', the painter's blend
        (``ops.rasterize.rasterize_soft``) over the same backgrounds.

        An explicit ``background_texture`` (an ``ops.grids.Grid2D`` of (H,
        W, 3) float RGB in [0, 1]) replaces the renderer's in both modes by
        its bilinear sample (``sample_background``); the hard raster culls
        the faces over it. A size that is not a multiple of 16 renders
        padded and cropped.

        Returns:
            (B, 3, H, W) float image in [0, 255]; in differentiable mode
            differentiable w.r.t. the mesh vertices and colors and the
            camera pose.
        """
        assert res.width == res.height, "only square resolutions are supported"
        size = res.width
        pad_to = self._pad_res_target(size)
        if pad_to is not None:
            return self.render_rgb_mesh_chw(
                mesh, Resolution(pad_to, pad_to), self._pad_cameras(cameras, size, pad_to),
                background_texture)[..., :size, :size]
        if not self.cfg.differentiable:
            background, ops, _ = self.hard_frame_operands(mesh, size, cameras,
                                                          background_texture)
            return raster(ops, background, size) * 255.0
        if self.cfg.soft_blend != 'softmax':
            background = self.soft_background(cameras, size, background_texture)
            image = rasterize_soft(self._screen_verts(mesh, size, cameras), mesh.faces,
                                   mesh.attrs, size, background.permute(0, 2, 3, 1),
                                   sigma=self.cfg.soft_sigma)
            return image.permute(0, 3, 1, 2) * 255.0
        background, (coef, zw, color) = self.soft_frame_operands(
            mesh, size, cameras, background_texture)
        if coef.shape[1] == 0:
            return background * 255.0
        return rasterize_softmax_coefs(coef, zw, color, background) * 255.0

    def _screen_verts(self, mesh: RGBMesh, size: int, cameras: Cameras) -> torch.Tensor:
        """The mesh's vertices as screen (row, col, priority z)."""
        rc = camera_rows_cols(mesh.verts[..., :2], cameras.xy, cameras.sc, cameras.scale,
                              size, left_handed=self.cfg.left_handed_coordinates)
        return torch.cat([rc, mesh.verts[..., 2:3]], dim=-1)

    def soft_background(self, cameras: Cameras, size: int,
                        background_texture: Optional[Grid2D] = None) -> torch.Tensor:
        """
        The differentiable render's (B, 3, size, size) background in [0, 1]:
        the bilinear sample of an explicit ``background_texture``; else,
        over the renderer's texture, the bilinear mip warp
        (``warp_background_diff``: B3, its VJP for the pose gradient) where
        a mip level covers the view and ``cfg.diff_fast_background``, or
        the full-resolution bilinear sample (``sample_background_quad``);
        else the background color expanded.
        """
        lh = self.cfg.left_handed_coordinates
        if background_texture is not None:
            return sample_background(background_texture, cameras.xy, cameras.sc,
                                     cameras.scale, size, self._background_color,
                                     left_handed=lh)
        if self._mip_pyramid is None:
            return self._background_color[None, :, None, None].expand(
                cameras.xy.shape[0], 3, size, size)
        mip = self._warp_mip(cameras.scale, size) if self.cfg.diff_fast_background \
            else None
        if mip is not None:
            return warp_background_diff(mip, cameras.xy, cameras.sc, cameras.scale,
                                        self._background_color, left_handed=lh, res=size)
        quad = self._quad_texture()
        return sample_background_quad(quad.data, quad.origin, quad.cell_size,
                                      cameras.xy, cameras.sc, cameras.scale, size,
                                      self._background_color, left_handed=lh)

    def soft_frame_operands(self, mesh: RGBMesh, size: int, cameras: Cameras,
                            background_texture: Optional[Grid2D] = None):
        """
        The softmax-blend render's operands for one frame, as
        :meth:`render_rgb_mesh_chw` passes them to the soft raster
        (``ops.soft.rasterize_softmax_coefs``).

        Returns:
            ``(background, (coef, zw, color))``: the background of
            :meth:`soft_background` and the per-face edge coefficients (B,
            F, 3, 3), z weights (B, 1, F) and colors (B, F, 3) of
            ``ops.soft.soft_coefficients``.
        """
        if not supports_res(size):
            raise NotImplementedError(
                f"res {size}: the soft render's operands are for multiples of 16 "
                "(render_rgb_mesh_chw pads other sizes)")
        background = self.soft_background(cameras, size, background_texture)
        coef, zw, color = soft_coefficients(self._screen_verts(mesh, size, cameras),
                                            mesh.faces, mesh.attrs, self.cfg.soft_sigma,
                                            0.5)
        return background, (coef, zw[:, None, :], color)

    def hard_frame_operands(self, mesh: RGBMesh, size: int, cameras: Cameras,
                            background_texture: Optional[Grid2D] = None):
        """
        The hard render's operands for one frame: the background and the
        z-priority raster's operands, as :meth:`render_rgb_mesh_chw` passes
        them to the kernels.

        Returns:
            ``(background, ops, warp)``: the (B, 3, size, size) background
            in [0, 1] (the bilinear sample of an explicit
            ``background_texture``; else the nearest mip warp of the
            renderer's texture, or its full-resolution nearest sample where
            no mip level covers the view, or the background color without a
            texture); the operands of ``ops.hard.hard_operands`` for the
            faces culled to the ``cfg.cull_max_faces`` nearest the view's
            center (every face without a texture); ``(mip, fcoef, icoef)``,
            the nearest warp's operands, or None without one.
        """
        if not supports_res(size):
            raise NotImplementedError(
                f"res {size}: the hard render's operands are for multiples of "
                "16 (render_rgb_mesh_chw pads other sizes)")
        lh = self.cfg.left_handed_coordinates
        warp = None
        mip = self._warp_mip(cameras.scale, size) if background_texture is None else None
        if background_texture is not None:
            background = sample_background(background_texture, cameras.xy, cameras.sc,
                                           cameras.scale, size, self._background_color,
                                           left_handed=lh)
        elif mip is not None:
            fcoef, icoef = warp_coefficients(mip, cameras.xy, cameras.sc,
                                             cameras.scale, self._background_color,
                                             left_handed=lh, res=size)
            warp = (mip, fcoef, icoef)
            background = warp_view_nearest(mip.data, fcoef, icoef, size)
        else:
            background = self._full_background(cameras, size)
        textured = self._background_texture is not None or background_texture is not None
        cull = self.cfg.cull_max_faces if textured else 0
        corners, z, color = face_arrays(self._screen_verts(mesh, size, cameras),
                                        mesh.faces, mesh.attrs)
        if cull:
            corners, z, color = cull_faces_to_view(corners, z, color, size, cull)
        return background, hard_operands(corners, z, color), warp

    def render_faces_chw(self, corners: torch.Tensor, z: torch.Tensor,
                         colors: torch.Tensor, res: Resolution,
                         cameras: Cameras) -> torch.Tensor:
        """
        Render a face soup (world-space corners (B, F, 3, 2), priorities z
        (B, F), flat colors (B, F, 3) in [0, 1], as from
        ``BirdviewRGBMeshGenerator.generate_faces``) over the background:
        the faces culled to the ``cfg.cull_max_faces`` nearest the view's
        center whenever that is non-zero, textured or not, then the hard
        raster (``ops.hard.raster``: B6a up to 127 faces) over
        :meth:`face_frame_operands`' background; a differentiable renderer,
        as the reference's, takes the full-resolution nearest sample of the
        texture for the background and its plain float-color raster
        (``ops.hard_faces.rasterize_hard_faces``: HF on the card), which
        gives gradients to the colors. A size that is not a multiple of 16
        renders padded and cropped.

        Returns:
            (B, 3, H, W) float image in [0, 255].
        """
        assert res.width == res.height, "only square resolutions are supported"
        size = res.width
        pad_to = self._pad_res_target(size)
        if pad_to is not None:
            return self.render_faces_chw(
                corners, z, colors, Resolution(pad_to, pad_to),
                self._pad_cameras(cameras, size, pad_to))[..., :size, :size]
        background, faces, _ = self.face_frame_operands(corners, z, colors, size, cameras)
        if self.cfg.differentiable:
            return rasterize_hard_faces(*faces, background) * 255.0
        return raster(hard_operands(*faces), background, size) * 255.0

    def face_frame_operands(self, corners: torch.Tensor, z: torch.Tensor,
                            colors: torch.Tensor, size: int, cameras: Cameras):
        """
        The face-soup render's operands for one frame, as
        :meth:`render_faces_chw` takes them.

        Returns:
            ``(background, (corners, z, colors), warp)``: the (B, 3, size,
            size) background in [0, 1] (the nearest mip warp of the texture
            where a mip level covers the view and the render is hard, else
            its full-resolution nearest sample, sampled at ``res /
            cfg.background_downsample``, or the color without a texture);
            the screen-space faces culled to ``cfg.cull_max_faces`` (all of
            them when it is 0); ``(mip, fcoef, icoef)``, the nearest warp's
            operands, or None without one.
        """
        if not supports_res(size):
            raise NotImplementedError(
                f"res {size}: the face-soup render's operands are for multiples of "
                "16 (render_faces_chw pads other sizes)")
        lh = self.cfg.left_handed_coordinates
        warp = None
        mip = None if self.cfg.differentiable else self._warp_mip(cameras.scale, size)
        if mip is not None:
            fcoef, icoef = warp_coefficients(mip, cameras.xy, cameras.sc, cameras.scale,
                                             self._background_color, left_handed=lh,
                                             res=size)
            warp = (mip, fcoef, icoef)
            background = warp_view_nearest(mip.data, fcoef, icoef, size)
        else:
            background = self._full_background(cameras, size)
        b, f = z.shape
        sc = camera_rows_cols(corners.reshape(b, f * 3, 2), cameras.xy, cameras.sc,
                              cameras.scale, size, left_handed=lh).reshape(b, f, 3, 2)
        if self.cfg.cull_max_faces:
            sc, z, colors = cull_faces_to_view(sc, z, colors, size,
                                               self.cfg.cull_max_faces)
        return background, (sc, z, colors), warp

    def render_rgb_mesh(self, mesh: RGBMesh, res: Resolution, cameras: Cameras,
                        background_texture: Optional[Grid2D] = None) -> torch.Tensor:
        """(B, H, W, 3) float image in [0, 255] (the channels-last layout)."""
        return self.render_rgb_mesh_chw(mesh, res, cameras,
                                        background_texture).permute(0, 2, 3, 1)
