"""
Renderer configuration, orthographic cameras, and the default color map and
rendering levels (counterpart of ``torchdrivesim_tpu/rendering/base.py``).
Rendered images are (B, 3, H, W) float RGB in [0, 255], or packed RGB8.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass
class RendererConfig:
    """Switches of the port's renderer (the reference's ``JaxRendererConfig``
    fields that the primitive path and the hard and differentiable mesh
    paths read)."""
    render_agent_direction: bool = True
    left_handed_coordinates: bool = False
    #: per-camera primitive cap PER TYPE (quads / triangles); 56 is the
    #: packed-rank maximum (2 x 56 < 127)
    band_budget: int = 56
    #: mesh renders: soft (differentiable) coverage instead of the hard
    #: z-priority raster
    differentiable: bool = False
    #: hard mesh renders over the texture: per-camera face budget, the faces
    #: nearest the view's center (0 keeps every face)
    cull_max_faces: int = 64
    #: edge softness in pixels of the soft raster
    soft_sigma: float = 0.5
    #: soft blend: 'softmax' (z-weighted, order-independent); the painter's
    #: blend ('soft') is not ported
    soft_blend: str = 'softmax'
    #: textured differentiable renders: the bilinear mip warp with
    #: finite-difference pose gradients; the full-resolution bilinear
    #: gather (False) is not ported
    diff_fast_background: bool = True
    #: the full-resolution nearest background (views no mip level covers)
    #: sampled at res / background_downsample and upsampled bilinearly
    background_downsample: int = 1


@dataclass
class Cameras:
    """Orthographic cameras: centers (B, 2), heading (sin, cos) (B, 2), and
    ``scale`` = 2 / fov in meters."""
    xy: torch.Tensor
    sc: torch.Tensor
    scale: float


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
