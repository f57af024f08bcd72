"""
Renderer configurations, orthographic cameras, the renderer base class, the
black-frame :class:`DummyRenderer`, and the default color map and rendering
levels (counterpart of ``torchdrivesim_tpu/rendering/base.py``). Rendered
images are (B, 3, H, W) float RGB in [0, 255], or packed RGB8.

The reference's backend zoo (OpenCV, pytorch3d, nvdiffrast) keeps its
configuration classes as migration shims: ``renderer_from_config`` builds
the port's :class:`~torchdrivesim_tpu_torch.rendering.renderer.Renderer`
from any of them.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from torchdrivesim_tpu_torch.mesh import RGBMesh
from torchdrivesim_tpu_torch.utils import Resolution


@dataclass
class BirdviewRendererConfig:
    """The switches every backend shares (the reference's base
    ``RendererConfig``); the subclass, or ``backend``, selects the
    renderer."""
    backend: str = 'default'
    render_agent_direction: bool = True
    left_handed_coordinates: bool = False
    #: accepted for the reference's configs; no renderer reads it
    highlight_ego_vehicle: bool = False
    #: accepted for the reference's configs; no renderer reads it
    shift_mesh_by_camera_before_rendering: bool = True
    #: the device ``renderer_from_config`` builds on when it is given none
    device: Optional[str] = None


@dataclass
class RendererConfig(BirdviewRendererConfig):
    """Switches of the port's renderer (the reference's
    ``JaxRendererConfig``, which names this class too)."""
    backend: str = 'jax'
    #: mesh renders: soft (differentiable) coverage instead of the hard
    #: z-priority raster
    differentiable: bool = False
    #: edge softness in pixels of the soft raster
    soft_sigma: float = 0.5
    #: soft blend: 'softmax' (z-weighted, order-independent, the soft
    #: raster kernels); any other value, by name 'painter', selects the
    #: painter's blend (faces blended back to front, ``rasterize_soft``)
    soft_blend: str = 'softmax'
    #: accepted for the reference's configs: the hard raster kernels fold
    #: every face of a tile, so there is no face chunk to choose
    face_chunk: int = 16
    #: hard mesh renders over the texture, and every face-soup render:
    #: per-camera face budget, the faces nearest the view's center (0 keeps
    #: every face)
    cull_max_faces: int = 64
    #: the full-resolution nearest background (views no mip level covers)
    #: sampled at res / background_downsample and upsampled bilinearly
    background_downsample: int = 1
    #: accepted and without effect: on the card every render runs its
    #: kernels, which compute the same image as the reference's plain
    #: rasterizer paths would on its TPU path, and on the CPU their plain
    #: versions
    use_pallas: bool = True
    #: textured differentiable renders: the bilinear mip warp with
    #: finite-difference pose gradients where a mip level covers the view;
    #: False takes the full-resolution bilinear gather
    #: (``sample_background_quad``) with exact bilinear pose gradients, as
    #: do views no mip level covers
    diff_fast_background: bool = True
    #: per-camera primitive cap PER TYPE (quads / triangles); 56 is the
    #: packed-rank maximum (2 x 56 < 127)
    band_budget: int = 56


#: the reference's name of :class:`RendererConfig`
JaxRendererConfig = RendererConfig


@dataclass
class DummyRendererConfig(BirdviewRendererConfig):
    """Selects :class:`DummyRenderer` (black frames)."""
    backend: str = 'dummy'


@dataclass
class CV2RendererConfig(BirdviewRendererConfig):
    """Migration shim for the reference's OpenCV backend: renders through
    the port's renderer. ``trim_mesh_before_rendering`` is accepted and
    ignored (the renderer culls per camera instead)."""
    backend: str = 'cv2'
    trim_mesh_before_rendering: bool = True


@dataclass
class Pytorch3DRendererConfig(BirdviewRendererConfig):
    """Migration shim for the reference's pytorch3d backend: the port's
    renderer, differentiable when ``differentiable_rendering`` is 'soft'
    (the default) or 'sigmoid'."""
    backend: str = 'pytorch3d'
    differentiable_rendering: str = 'soft'     #: 'soft', 'sigmoid' or 'hard'


@dataclass
class NvdiffrastRendererConfig(BirdviewRendererConfig):
    """Migration shim for the reference's nvdiffrast backend: the port's
    renderer; ``antialias``, ``opengl`` and ``max_minibatch_size`` are
    accepted and ignored."""
    backend: str = 'nvdiffrast'
    antialias: bool = False
    opengl: bool = False
    max_minibatch_size: Optional[int] = None


@dataclass
class Cameras:
    """Orthographic cameras: centers (B, 2), heading (sin, cos) (B, 2), and
    ``scale`` = 2 / fov in meters."""
    xy: torch.Tensor
    sc: torch.Tensor
    scale: float


class BirdviewRenderer(abc.ABC):
    """
    What every renderer shares: its configuration and device, the default
    view (``res``, ``scale`` = 2 / fov), the color map and rendering levels,
    and :meth:`render_frame` over the subclass's :meth:`render_rgb_mesh`.
    A failing render raises: the reference's ``render_frame`` logs the
    error and returns black frames instead, which would hide a kernel that
    failed.

    Args:
        cfg: renderer switches.
        device: where the frames are made (``renderer_from_config`` builds
            on the card unless told otherwise).
        res / fov: default view size and field of view (meters).
    """
    #: the baked map texture; :class:`Renderer` samples it
    background_texture = None

    def __init__(self, cfg: BirdviewRendererConfig, device,
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

    def get_color(self, element_type: str) -> Tuple[int, int, int]:
        return self.color_map[element_type]

    @abc.abstractmethod
    def render_rgb_mesh(self, mesh: RGBMesh, res: Resolution,
                        cameras: Cameras) -> torch.Tensor:
        """(B, H, W, 3) float image in [0, 255]."""

    def render_frame(self, rgb_mesh: RGBMesh, camera_xy: torch.Tensor,
                     camera_sc: torch.Tensor, res: Optional[Resolution] = None,
                     fov: Optional[float] = None) -> torch.Tensor:
        """(B*Nc, 3, H, W) image of cameras given as (..., 2) centers and
        (..., 2) (sin, cos) headings, at ``res`` and ``fov`` or the
        renderer's defaults."""
        scale = (2.0 / fov) if fov is not None else self.scale
        res = res if res is not None else self.res
        image = self.render_rgb_mesh(
            rgb_mesh, res, Cameras(camera_xy.reshape(-1, 2), camera_sc.reshape(-1, 2),
                                   scale))
        return image.reshape(-1, res.height, res.width, 3).permute(0, 3, 1, 2)


class DummyRenderer(BirdviewRenderer):
    """Black frames, for debugging and benchmarking: launches nothing but
    the fill of its output."""
    def render_rgb_mesh(self, mesh: RGBMesh, res: Resolution,
                        cameras: Cameras) -> torch.Tensor:
        return torch.zeros((cameras.xy.shape[0], res.height, res.width, 3),
                           dtype=torch.float32, device=cameras.xy.device)


def get_default_rendering_levels() -> Dict[str, float]:
    """Category -> rendering level; lower renders on top."""
    return dict(
        direction=2, ego=3, vehicle=4, bicycle=5, pedestrian=6,
        map_boundary=7, goal_waypoint=8, ground_truth=9, prediction=10,
        traffic_light=11, traffic_light_green=11, traffic_light_yellow=11,
        traffic_light_red=11, stop_sign=11, yield_sign=11,
        left_lane=12, joint_lane=13, right_lane=14, road=15,
    )


def get_default_color_map() -> Dict[str, Tuple[int, int, int]]:
    """Category -> RGB in [0, 255]."""
    return dict(
        background=(0, 0, 0), road=(155, 155, 155), corridor=(0, 155, 0),
        ego=(255, 0, 0), vehicle=(32, 74, 135), bicycle=(24, 104, 225),
        pedestrian=(173, 127, 168), ground_truth=(196, 188, 165),
        prediction=(255, 155, 0), left_lane=(80, 127, 86),
        right_lane=(128, 0, 128), joint_lane=(255, 255, 255),
        direction=(100, 255, 255), rear_lights=(255, 255, 0),
        map_boundary=(255, 255, 0), traffic_light_green=(81, 179, 100),
        traffic_light_yellow=(240, 189, 39), traffic_light_red=(224, 53, 49),
        yield_sign=(210, 125, 45), stop_sign=(72, 60, 50),
        goal_waypoint=(139, 64, 0),
    )
