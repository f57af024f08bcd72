"""
What a frame shows, from the states: each agent a box (length x width,
centred on its position, along its heading) with a direction triangle over
its front (tip at the front bumper, base 0.3 lengths behind it, the box's
width), each traffic light its stopline box in the light's color, and the
map's road mesh under them. Colors and priorities are TorchDriveSim's
defaults (lower priority z on top).
"""
import numpy as np
import torch

COLORS = dict(background=(0, 0, 0), road=(155, 155, 155), vehicle=(32, 74, 135),
              left_lane=(80, 127, 86), right_lane=(128, 0, 128),
              joint_lane=(255, 255, 255), direction=(100, 255, 255),
              map_boundary=(255, 255, 0), traffic_light_green=(81, 179, 100),
              traffic_light_yellow=(240, 189, 39), traffic_light_red=(224, 53, 49))
LEVELS = dict(direction=2, vehicle=4, map_boundary=7, traffic_light=11,
              left_lane=12, joint_lane=13, right_lane=14, road=15)
LIGHT_COLORS = ('traffic_light_red', 'traffic_light_yellow', 'traffic_light_green')
DIRECTION_SIZE = 0.3


def _rgb(names, device):
    return torch.tensor([COLORS[n] for n in names], dtype=torch.uint8, device=device)


def actor_shapes(state: torch.Tensor, size: torch.Tensor):
    """(B, A, 4, 2) box corners in cycle order and (B, A, 3, 2) direction
    triangles, in the world."""
    l, w = size[..., 0:1], size[..., 1:2]
    hl, hw = l / 2, w / 2
    box_x = torch.cat([hl, hl, -hl, -hl], dim=-1)
    box_y = torch.cat([hw, -hw, -hw, hw], dim=-1)
    base = l * (0.5 - DIRECTION_SIZE)
    tri_x = torch.cat([hl, base, base], dim=-1)
    tri_y = torch.cat([torch.zeros_like(hw), hw, -hw], dim=-1)

    def place(lx, ly):
        c, s = torch.cos(state[..., 2:3]), torch.sin(state[..., 2:3])
        return torch.stack([c * lx - s * ly + state[..., 0:1],
                            s * lx + c * ly + state[..., 1:2]], dim=-1)

    return place(box_x, box_y), place(tri_x, tri_y)


def prims(state: torch.Tensor, size: torch.Tensor, light_corners: torch.Tensor,
          light_state):
    """The frame's primitives in the world: boxes (agents, then stoplines)
    as (quads (B, Q, 4, 2), z (B, Q), rgb8 (B, Q, 3)) and the direction
    triangles as (tris (B, T, 3, 2), z, rgb8)."""
    b, a = state.shape[:2]
    dev = state.device
    boxes, tris = actor_shapes(state, size)
    n = light_corners.shape[0]
    lights = light_corners[None].expand(b, n, 4, 2).to(state.dtype)
    quads = torch.cat([boxes, lights], dim=1)
    qz = torch.cat([torch.full((b, a), float(LEVELS['vehicle']), device=dev),
                    torch.full((b, n), float(LEVELS['traffic_light']), device=dev)], 1)
    light_rgb = _rgb(LIGHT_COLORS, dev)[torch.as_tensor(light_state, device=dev).long()]
    qrgb = torch.cat([_rgb(['vehicle'], dev).expand(b, a, 3),
                      light_rgb[None].expand(b, n, 3)], dim=1)
    tz = torch.full((b, a), float(LEVELS['direction']), device=dev)
    trgb = _rgb(['direction'], dev).expand(b, a, 3)
    return (quads, qz, qrgb), (tris, tz, trgb)


class RoadMesh:
    """The map's road mesh: (F, 3, 2) world triangles, each with the
    priority and color of its first vertex's category."""

    def __init__(self, verts, faces, categories, vert_category, device):
        tri = np.asarray(verts, np.float32)[np.asarray(faces)]
        first = np.asarray(vert_category)[np.asarray(faces)[:, 0]]
        names = [categories[k] for k in first]
        self.tris = torch.as_tensor(tri, device=device)
        self.z = torch.tensor([float(LEVELS[n]) for n in names], device=device)
        self.rgb = _rgb(names, device)
