"""
Per-frame scene primitives from precomputed templates (counterpart of
``torchdrivesim_tpu/scene_mesh.py``; the typed-primitive generator of the
env step). Actor boxes and stoplines become quads, direction markers
triangles; absent agents' primitives are degenerate (all-zero corners).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torchdrivesim_tpu_torch.mesh import tensor_color
from torchdrivesim_tpu_torch.utils import rotate

#: verts per actor: 4 box corners + 3 direction-triangle verts
ACTOR_BOX_VERTS = 4
ACTOR_DIR_VERTS = 3
DIRECTION_SIZE = 0.3


def make_actor_templates(lenwid: torch.Tensor, render_direction: bool = True
                         ) -> Tuple[torch.Tensor, np.ndarray]:
    """
    Local-frame actor template vertices, contiguous per agent.

    Args:
        lenwid: (B, A, 2) agent length and width.
    Returns:
        (verts (B, A, 7, 2), faces (A*3, 3) numpy) when the direction is
        rendered, else ((B, A, 4, 2), (A*2, 3)).
    """
    length = lenwid[..., 0:1]
    width = lenwid[..., 1:2]
    half_l = length / 2
    half_w = width / 2
    zeros = torch.zeros_like(half_l)
    box = torch.stack([
        torch.cat([half_l, half_w], dim=-1),
        torch.cat([half_l, -half_w], dim=-1),
        torch.cat([-half_l, -half_w], dim=-1),
        torch.cat([-half_l, half_w], dim=-1),
    ], dim=-2)  # B, A, 4, 2
    n_actors = lenwid.shape[-2]
    if render_direction:
        # triangle: tip at the front bumper, base behind it spanning the width
        base_x = length * (0.5 - DIRECTION_SIZE)
        tip = torch.cat([half_l, zeros], dim=-1)
        base_top = torch.cat([base_x, half_w], dim=-1)
        base_bot = torch.cat([base_x, -half_w], dim=-1)
        tri = torch.stack([tip, base_top, base_bot], dim=-2)
        verts = torch.cat([box, tri], dim=-2)  # B, A, 7, 2
        per_agent = np.asarray([[0, 1, 3], [1, 3, 2], [4, 5, 6]], dtype=np.int32)
        stride = ACTOR_BOX_VERTS + ACTOR_DIR_VERTS
    else:
        verts = box
        per_agent = np.asarray([[0, 1, 3], [1, 3, 2]], dtype=np.int32)
        stride = ACTOR_BOX_VERTS
    faces = (per_agent[None] + stride * np.arange(n_actors, dtype=np.int32)
             [:, None, None]).reshape(-1, 3)
    return verts, faces


class BirdviewRGBMeshGenerator:
    """
    Holds the actor and traffic-light templates and produces the per-frame
    typed primitives.

    Args:
        color_map / rendering_levels: category -> color / priority tables.
    """
    def __init__(self, color_map: Dict[str, Tuple[int, int, int]],
                 rendering_levels: Dict[str, float],
                 render_agent_direction: bool = True):
        self.color_map = color_map
        self.rendering_levels = rendering_levels
        self.render_agent_direction = render_agent_direction
        self.actor_verts = None      # (B, A, S, 2) local template
        self.actor_attrs = None      # (B, A, S, 3) colors
        self.actor_z = None          # (B, A, S) priority
        self.light_quads = None      # (B, Nl, 4, 2) cycle order
        self.light_z = None
        self.light_color_table = None  # (num_states, 3)

    def initialize_actors_mesh(self, lenwid: torch.Tensor,
                               agent_types: torch.Tensor,
                               agent_type_names: List[str]) -> None:
        """Templates, colors and priorities of the (B, A) actors."""
        self.actor_verts, _ = make_actor_templates(
            lenwid, self.render_agent_direction)
        b, a = lenwid.shape[0], lenwid.shape[1]
        dev = lenwid.device
        type_colors = torch.as_tensor(np.stack(
            [tensor_color(self.color_map[n]) for n in agent_type_names]),
            device=dev)
        type_z = torch.tensor([float(self.rendering_levels[n])
                               for n in agent_type_names], device=dev)
        types = agent_types.long()
        box_color = type_colors[types]                  # (B, A, 3)
        box_z = type_z[types]                           # (B, A)
        if self.render_agent_direction:
            dir_color = torch.as_tensor(
                tensor_color(self.color_map['direction']), device=dev)
            dir_z = float(self.rendering_levels['direction'])
            self.actor_attrs = torch.cat([
                box_color[:, :, None].expand(b, a, ACTOR_BOX_VERTS, 3),
                dir_color.expand(b, a, ACTOR_DIR_VERTS, 3),
            ], dim=-2)
            self.actor_z = torch.cat([
                box_z[:, :, None].expand(b, a, ACTOR_BOX_VERTS),
                torch.full((b, a, ACTOR_DIR_VERTS), dir_z, device=dev),
            ], dim=-1)
        else:
            s = self.actor_verts.shape[-2]
            self.actor_attrs = box_color[:, :, None].expand(b, a, s, 3)
            self.actor_z = box_z[:, :, None].expand(b, a, s)

    def initialize_traffic_controls_mesh(self, traffic_controls) -> None:
        """Traffic lights keep per-frame state; static signs are not ported."""
        light = traffic_controls.get('traffic_light')
        if light is not None and light.corners.shape[1] > 0:
            # stoplines as quads in cycle order (corners 0, 1, 3, 2)
            c = light.corners                             # (B, Nl, 4, 2)
            self.light_quads = torch.stack([c[:, :, 0], c[:, :, 1], c[:, :, 3],
                                            c[:, :, 2]], dim=2)
            self.light_z = float(self.rendering_levels['traffic_light'])
            self.light_color_table = torch.as_tensor(np.stack([
                tensor_color(self.color_map[f'traffic_light_{s}'])
                for s in light.allowed_states]), device=light.corners.device)
        else:
            self.light_quads = None

    def _light_colors(self, traffic_light_state: torch.Tensor) -> torch.Tensor:
        """(B, Nl) light states -> (B, Nl, 3) colors."""
        return self.light_color_table[traffic_light_state.long()]

    def generate_prims(self, agent_state: torch.Tensor,
                       present_mask: Optional[torch.Tensor] = None,
                       traffic_light_state: Optional[torch.Tensor] = None):
        """
        Typed primitives of the frame: actor boxes and stoplines as quads in
        cycle order, direction markers as triangles.

        Args:
            agent_state: (B, All, 4); present_mask: (B, All).
            traffic_light_state: (B, Nl) indices into the light states.
        Returns:
            (quads (B, Q, 4, 2), qz (B, Q), qcolors (B, Q, 3),
             tris (B, T, 3, 2), tz (B, T), tcolors (B, T, 3)).
        """
        b, n_all = agent_state.shape[0], agent_state.shape[1]
        local, actor_z, actor_attrs = self.actor_verts, self.actor_z, self.actor_attrs
        light_quads = self.light_quads
        if local.shape[0] != b:
            # multi-camera flattening: each template batch element repeats
            # contiguously for its cameras (layout index = b * Nc + cam)
            reps = b // local.shape[0]
            local = torch.repeat_interleave(local, reps, dim=0)
            actor_z = torch.repeat_interleave(actor_z, reps, dim=0)
            actor_attrs = torch.repeat_interleave(actor_attrs, reps, dim=0)
            if light_quads is not None:
                light_quads = torch.repeat_interleave(light_quads, reps, dim=0)
        psi = agent_state[..., 2:3][..., None]
        xy = agent_state[..., :2][..., None, :]
        world = rotate(local, psi) + xy                     # (B, All, S, 2)

        # template verts 0,1,3,2 cycle the bbox (faces [0,1,3] + [1,3,2])
        quads = [torch.stack([world[:, :, 0], world[:, :, 1], world[:, :, 3],
                              world[:, :, 2]], dim=2)]     # (B, All, 4, 2)
        qz = [actor_z[:, :, 0].expand(b, n_all)]
        qcol = [actor_attrs[:, :, 0].expand(b, n_all, 3)]
        tris, tz, tcol = [], [], []
        zero = world.new_zeros(())
        if self.render_agent_direction:
            tri = world[:, :, 4:7]
            if present_mask is not None:
                tri = torch.where(present_mask[..., None, None], tri, zero)
            tris.append(tri)
            tz.append(actor_z[:, :, 4].expand(b, n_all))
            tcol.append(actor_attrs[:, :, 4].expand(b, n_all, 3))
        if present_mask is not None:
            quads[0] = torch.where(present_mask[..., None, None], quads[0], zero)

        if light_quads is not None and traffic_light_state is not None:
            nl = light_quads.shape[1]
            quads.append(light_quads)
            qz.append(torch.full((b, nl), self.light_z, device=world.device))
            qcol.append(self._light_colors(traffic_light_state))

        quads = torch.cat(quads, dim=1)
        qz = torch.cat(qz, dim=1)
        qcol = torch.cat(qcol, dim=1)
        if tris:
            tris, tz, tcol = (torch.cat(tris, dim=1), torch.cat(tz, dim=1),
                              torch.cat(tcol, dim=1))
        else:
            tris = world.new_zeros((b, 0, 3, 2))
            tz = world.new_zeros((b, 0))
            tcol = world.new_zeros((b, 0, 3))
        return quads, qz, qcol, tris, tz, tcol
