"""
The port's bird's-eye-view renderer (counterpart of
``torchdrivesim_tpu/rendering/jax_renderer.py``), at resolutions that are
multiples of 16 up to 128: typed primitives composited over the baked map
texture by the fused render; the hard mesh render, the z-priority raster
over the nearest mip warp of the texture (faces culled to the view) or over
the constant background color (every face); and the differentiable mesh
render, soft-rasterized over the bilinear mip warp of the texture or over
the constant background color.

Not ported yet: pad-and-crop for other resolutions and the sub-camera tiling
above 128 (ROADMAP A10), the untextured primitive path, the face-soup render
``render_faces_chw``, the painter's soft blend and the full-resolution
bilinear background of the differentiable render.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torchdrivesim_tpu_torch.mesh import RGBMesh
from torchdrivesim_tpu_torch.ops.fused import render_coefs_fused
from torchdrivesim_tpu_torch.ops.grids import Grid2D
from torchdrivesim_tpu_torch.ops.hard import hard_operands, raster
from torchdrivesim_tpu_torch.ops.rasterize import (
    camera_rows_cols, cull_faces_to_view, face_arrays, n_bands_for,
    prep_sorted_prim_coefs,
)
from torchdrivesim_tpu_torch.ops.soft import rasterize_softmax_chw
from torchdrivesim_tpu_torch.ops.warp import (
    MIP_FACTOR, MipLevel, RES, build_mip_pyramid, select_mip, warp_background_diff,
    warp_coefficients, warp_view_nearest,
)
from torchdrivesim_tpu_torch.rendering.base import (
    Cameras, RendererConfig, get_default_color_map, get_default_rendering_levels,
)
from torchdrivesim_tpu_torch.utils import Resolution


class Renderer:
    """
    Renders typed primitives over :attr:`background_texture` on ``device``.

    Args:
        cfg: renderer switches.
        res / fov: default view size and field of view (meters).
    """
    def __init__(self, cfg: RendererConfig, device,
                 color_map: Optional[Dict[str, Tuple[int, int, int]]] = None,
                 rendering_levels: Optional[Dict[str, float]] = None,
                 res: Resolution = Resolution(64, 64), fov: float = 35):
        self.cfg = cfg
        self.device = torch.device(device)
        self.res = res
        self.scale = 2.0 / fov
        self.color_map = color_map if color_map is not None \
            else get_default_color_map()
        self.rendering_levels = rendering_levels if rendering_levels is not None \
            else get_default_rendering_levels()
        #: background color in [0, 1] for off-texture pixels, on the device
        self._background_color = torch.tensor(
            self.get_color('background'), dtype=torch.float32,
            device=self.device) / 255.0
        self._background_texture: Optional[Grid2D] = None
        self._mip_pyramid: Optional[List[MipLevel]] = None

    def get_color(self, element_type: str) -> Tuple[int, int, int]:
        return self.color_map[element_type]

    @property
    def background_texture(self) -> Optional[Grid2D]:
        return self._background_texture

    @background_texture.setter
    def background_texture(self, texture: Optional[Grid2D]):
        """Set the (H, W, 3) float texture (host numpy data); builds the
        packed mip pyramid on the host and moves it to the device."""
        self._background_texture = texture
        self._mip_pyramid = None
        if texture is not None:
            self._mip_pyramid = [
                level.to(self.device) for level in build_mip_pyramid(
                    np.asarray(texture.data), np.asarray(texture.origin),
                    texture.cell_size)]

    def _warp_mip(self, scale: float, size: int) -> Optional[MipLevel]:
        """The mip level for the fused render, or None when the fused path
        cannot serve this camera (resolution above 128 or not a multiple of
        16, or a view too wide for the coarsest mip)."""
        if self._mip_pyramid is None or size > RES or size % 16:
            return None
        fov = 2.0 / scale
        mip = select_mip(self._mip_pyramid, fov=fov, res=size)
        if mip.cell_size < fov * MIP_FACTOR / size:
            return None
        return mip

    def render_prims_chw(self, quads: torch.Tensor, qz: torch.Tensor,
                         qcolors: torch.Tensor, tris: torch.Tensor,
                         tz: torch.Tensor, tcolors: torch.Tensor,
                         res: Resolution, cameras: Cameras,
                         packed: bool = False) -> torch.Tensor:
        """
        Render world-space quads (cycle order) and triangles from
        ``BirdviewRGBMeshGenerator.generate_prims`` over the baked texture.

        Returns:
            (B, 3, H, W) float image in [0, 255], or (B, H, W) int32 packed
            0x00BBGGRR when ``packed``.
        """
        assert res.width == res.height, "only square resolutions are supported"
        size = res.width
        mip = self._warp_mip(cameras.scale, size)
        if mip is None:
            raise NotImplementedError(
                f"only the textured fused path is ported (res {size} must be a "
                f"multiple of 16 up to {RES}, with a background texture set)")
        b, q = qz.shape
        t = tz.shape[1]
        lh = self.cfg.left_handed_coordinates
        sq = camera_rows_cols(quads.reshape(b, q * 4, 2), cameras.xy, cameras.sc,
                              cameras.scale, size, left_handed=lh
                              ).reshape(b, q, 4, 2)
        st = camera_rows_cols(tris.reshape(b, t * 3, 2), cameras.xy, cameras.sc,
                              cameras.scale, size, left_handed=lh
                              ).reshape(b, t, 3, 2)
        cap = min(max(8, self.cfg.band_budget), 56)
        prep = prep_sorted_prim_coefs(sq, qz, qcolors, st, tz, tcolors, size,
                                      cap, n_bands_for(size))
        if prep is None:
            raise NotImplementedError(
                f"{q} quads / {t} triangles exceed the per-type cap {cap} or "
                "the 127-primitive rank space; trimming is not ported")
        qcoef, qpk, qmask, tcoef, tpk, tmask = prep
        fcoef, icoef = warp_coefficients(mip, cameras.xy, cameras.sc,
                                         cameras.scale, self._background_color,
                                         left_handed=lh, res=size)
        image = render_coefs_fused(mip, fcoef, icoef, qcoef, qpk, tcoef, tpk,
                                   qmask, tmask, size, packed)
        return image if packed else image * 255.0

    def render_rgb_mesh_chw(self, mesh: RGBMesh, res: Resolution,
                            cameras: Cameras) -> torch.Tensor:
        """
        Render a per-camera RGB mesh (world-space (x, y, priority z)
        vertices, as from ``BirdviewRGBMeshGenerator.generate``).

        Hard mode (the default): the z-priority raster (``ops/hard.py``) over
        the nearest mip warp of the background texture, the faces culled to
        the ``cfg.cull_max_faces`` nearest the view's center, or, with no
        texture, over the background color with every face.

        Differentiable mode (``cfg.differentiable``): the soft raster over
        the bilinear mip warp of the background texture when one is set
        (pose gradients by ``warp_background_diff``), else over the
        background color.

        Returns:
            (B, 3, H, W) float image in [0, 255]; in differentiable mode
            differentiable w.r.t. the mesh vertices and colors and the
            camera pose.
        """
        assert res.width == res.height, "only square resolutions are supported"
        size = res.width
        if not self.cfg.differentiable:
            return self._render_hard(mesh, size, cameras)
        if self.cfg.soft_blend != 'softmax':
            raise NotImplementedError(
                f"soft_blend={self.cfg.soft_blend!r}: only the softmax blend is "
                "ported (the painter's blend rasterize_soft is not, ROADMAP A12)")
        if size % 16 or size > RES:
            raise NotImplementedError(
                f"res {size}: the soft render serves multiples of 16 up to {RES}; "
                "pad-and-crop and tiling are not ported (ROADMAP A10)")
        lh = self.cfg.left_handed_coordinates
        b = cameras.xy.shape[0]
        if self._mip_pyramid is not None:
            if not self.cfg.diff_fast_background:
                raise NotImplementedError(
                    "diff_fast_background=False (the full-resolution bilinear "
                    "background, sample_background_quad) is not ported (ROADMAP A12)")
            mip = self._warp_mip(cameras.scale, size)
            if mip is None:
                raise NotImplementedError(
                    f"no mip level covers a view of fov {2.0 / cameras.scale} at "
                    f"res {size}; tiling is not ported (ROADMAP A10)")
            background = warp_background_diff(
                mip, cameras.xy, cameras.sc, cameras.scale,
                self._background_color, left_handed=lh, res=size)
        else:
            background = self._background_color[None, :, None, None].expand(
                b, 3, size, size)
        rc = camera_rows_cols(mesh.verts[..., :2], cameras.xy, cameras.sc,
                              cameras.scale, size, left_handed=lh)
        sv = torch.cat([rc, mesh.verts[..., 2:3]], dim=-1)
        image = rasterize_softmax_chw(sv, mesh.faces, mesh.attrs, size,
                                      background, sigma=self.cfg.soft_sigma)
        return image * 255.0

    def _render_hard(self, mesh: RGBMesh, size: int, cameras: Cameras
                     ) -> torch.Tensor:
        """The hard branch of :meth:`render_rgb_mesh_chw`."""
        background, ops, _ = self.hard_frame_operands(mesh, size, cameras)
        return raster(ops, background, size) * 255.0

    def hard_frame_operands(self, mesh: RGBMesh, size: int, cameras: Cameras):
        """
        The hard render's operands for one frame: the background and the
        z-priority raster's operands, as :meth:`render_rgb_mesh_chw` passes
        them to the kernels.

        Returns:
            ``(background, ops, warp)``: the (B, 3, size, size) background
            in [0, 1] (the nearest mip warp of the texture, or the
            background color without one); the operands of
            ``ops.hard.hard_operands`` for the faces culled to the
            ``cfg.cull_max_faces`` nearest the view's center (every face
            without a texture); ``(mip, fcoef, icoef)``, the nearest warp's
            operands, or None without a texture.
        """
        if size % 16 or size > RES:
            raise NotImplementedError(
                f"res {size}: the hard render serves multiples of 16 up to {RES}; "
                "pad-and-crop and tiling are not ported (ROADMAP A10)")
        lh = self.cfg.left_handed_coordinates
        b = cameras.xy.shape[0]
        warp = None
        if self._mip_pyramid is not None:
            mip = self._warp_mip(cameras.scale, size)
            if mip is None:
                raise NotImplementedError(
                    f"no mip level covers a view of fov {2.0 / cameras.scale} at "
                    f"res {size}; tiling is not ported (ROADMAP A10)")
            fcoef, icoef = warp_coefficients(mip, cameras.xy, cameras.sc,
                                             cameras.scale, self._background_color,
                                             left_handed=lh, res=size)
            warp = (mip, fcoef, icoef)
            background = warp_view_nearest(mip.data, fcoef, icoef, size)
            cull = self.cfg.cull_max_faces
        else:
            background = self._background_color[None, :, None, None].expand(
                b, 3, size, size)
            cull = 0
        rc = camera_rows_cols(mesh.verts[..., :2], cameras.xy, cameras.sc,
                              cameras.scale, size, left_handed=lh)
        sv = torch.cat([rc, mesh.verts[..., 2:3]], dim=-1)
        corners, z, color = face_arrays(sv, mesh.faces, mesh.attrs)
        if cull:
            corners, z, color = cull_faces_to_view(corners, z, color, size, cull)
        return background, hard_operands(corners, z, color), warp

    def render_rgb_mesh(self, mesh: RGBMesh, res: Resolution,
                        cameras: Cameras) -> torch.Tensor:
        """(B, H, W, 3) float image in [0, 255] (the channels-last layout)."""
        return self.render_rgb_mesh_chw(mesh, res, cameras).permute(0, 2, 3, 1)

    def render_frame(self, rgb_mesh: RGBMesh, camera_xy: torch.Tensor,
                     camera_sc: torch.Tensor, res: Optional[Resolution] = None,
                     fov: Optional[float] = None) -> torch.Tensor:
        """(B*Nc, 3, H, W) image of cameras given as (..., 2) centers and
        (..., 2) (sin, cos) headings, at ``res`` and ``fov`` or the
        renderer's defaults."""
        scale = (2.0 / fov) if fov is not None else self.scale
        return self.render_rgb_mesh_chw(
            rgb_mesh, res if res is not None else self.res,
            Cameras(camera_xy.reshape(-1, 2), camera_sc.reshape(-1, 2), scale))
