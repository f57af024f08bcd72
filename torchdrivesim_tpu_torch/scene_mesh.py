"""
Per-frame scene primitives and meshes from precomputed templates
(counterpart of ``torchdrivesim_tpu/scene_mesh.py``): the typed-primitive
generator of the env step (actor boxes and stoplines as quads, direction
markers as triangles; absent agents' primitives are degenerate, all-zero
corners) and the per-camera RGB mesh of the differentiable render
(background mesh, actors, traffic lights, waypoints; absent agents' faces
collapse onto vertex 0).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torchdrivesim_tpu_torch.mesh import (
    BirdviewMesh, RGBMesh, generate_disc_mesh, set_colors_with_defaults,
    tensor_color,
)
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
        background_mesh: the static map mesh (category-annotated, host
            numpy) that :meth:`generate` puts under every frame, or None.
    """
    def __init__(self, color_map: Dict[str, Tuple[int, int, int]],
                 rendering_levels: Dict[str, float],
                 render_agent_direction: bool = True,
                 background_mesh: Optional[BirdviewMesh] = None):
        self.color_map = color_map
        self.rendering_levels = rendering_levels
        self.render_agent_direction = render_agent_direction
        self.background_mesh = background_mesh
        self._constants = {}         # (name, device) -> tensors, see _on
        self.waypoint_template_verts, self.waypoint_template_faces = \
            generate_disc_mesh()
        self.waypoint_color = tensor_color(color_map['goal_waypoint'])
        self.waypoint_z = float(rendering_levels['goal_waypoint'])
        self.actor_verts = None      # (B, A, S, 2) local template
        self.actor_faces = None      # (A*fpa, 3) host per-batch layout
        self.actor_attrs = None      # (B, A, S, 3) colors
        self.actor_z = None          # (B, A, S) priority
        self.light_quads = None      # (B, Nl, 4, 2) cycle order
        self.light_z = None
        self.light_color_table = None  # (num_states, 3)

    def initialize_actors_mesh(self, lenwid: torch.Tensor,
                               agent_types: torch.Tensor,
                               agent_type_names: List[str]) -> None:
        """Templates, colors and priorities of the (B, A) actors."""
        self.actor_verts, self.actor_faces = make_actor_templates(
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

    @property
    def background_rgb(self) -> Optional[RGBMesh]:
        """The map mesh resolved to host RGB, (x, y, priority z) vertices;
        resolved at first use (the textured path never needs it)."""
        if self.background_mesh is None:
            return None
        return self._on('background_rgb', 'host', lambda _: set_colors_with_defaults(
            self.background_mesh, self.color_map, self.rendering_levels))

    def _on(self, name: str, device, make):
        """Host constant ``name`` as built by ``make(device)``, moved to
        ``device`` once: a per-step copy from host memory would wait for the
        device to drain."""
        key = (name, str(device))
        if key not in self._constants:
            self._constants[key] = make(device)
        return self._constants[key]

    def generate(self, num_cameras: int,
                 agent_state: Optional[torch.Tensor] = None,
                 present_mask: Optional[torch.Tensor] = None,
                 traffic_light_state: Optional[torch.Tensor] = None,
                 waypoints: Optional[torch.Tensor] = None,
                 waypoints_rendering_mask: Optional[torch.Tensor] = None,
                 include_background: bool = True) -> RGBMesh:
        """
        The per-camera RGB mesh of the frame, as tensors: the background
        mesh (with ``include_background``), the actors transformed by their
        states, the traffic-light stoplines colored by state and the
        waypoint discs, concatenated in that order.

        Args:
            agent_state: (B, Nc, All, 4) states shared or per camera.
            present_mask: (B, Nc, All) which agents each camera renders.
            traffic_light_state: (B, Nl) light state indices.
            waypoints: (B, Nc, M, 2); waypoints_rendering_mask: (B, Nc, M).
        Returns:
            RGBMesh with batch size B * Nc, verts (x, y, priority z).
        """
        meshes = []
        device = next(t.device for t in (agent_state, traffic_light_state, waypoints)
                      if t is not None)
        if include_background and self.background_rgb is not None:
            meshes.append(self._on('background', device,
                                   self.background_rgb.to).expand(num_cameras))

        if agent_state is not None and self.actor_verts is not None:
            b, nc, n_all = agent_state.shape[:3]
            s = self.actor_verts.shape[-2]
            local = self.actor_verts[:, None].expand(b, nc, n_all, s, 2)
            psi = agent_state[..., 2:3][..., None, :]          # B,Nc,All,1,1
            xy = agent_state[..., :2][..., None, :]            # B,Nc,All,1,2
            world = rotate(local, psi) + xy                    # B,Nc,All,S,2
            z = self.actor_z[:, None, :, :, None].expand(b, nc, n_all, s, 1)
            verts = torch.cat([world, z], dim=-1).reshape(b * nc, n_all * s, 3)
            attrs = self.actor_attrs[:, None].expand(b, nc, n_all, s, 3).reshape(
                b * nc, n_all * s, 3)
            faces = self._on('actor_faces', device, lambda d: torch.as_tensor(
                self.actor_faces, dtype=torch.int64, device=d)).expand(b * nc, -1, 3)
            if present_mask is not None:
                fpa = self.actor_faces.shape[0] // n_all
                fm = present_mask.reshape(b * nc, n_all, 1, 1).expand(
                    b * nc, n_all, fpa, 3).reshape(faces.shape)
                faces = faces * fm
            meshes.append(RGBMesh(verts=verts, faces=faces, attrs=attrs))

        if self.light_quads is not None and traffic_light_state is not None:
            b, nl = self.light_quads.shape[:2]
            # cycle order (0, 1, 3, 2) back to the corner order of the faces
            corners = self.light_quads[:, :, [0, 1, 3, 2]].reshape(b, nl * 4, 2)
            z = torch.full((b, nl * 4, 1), self.light_z, device=device)
            colors = self._light_colors(traffic_light_state)    # (B, Nl, 3)
            lattrs = colors[:, :, None, :].expand(b, nl, 4, 3).reshape(b, nl * 4, 3)
            base = np.asarray([[0, 1, 3], [1, 3, 2]], dtype=np.int64)
            offs = (4 * np.arange(nl, dtype=np.int64))[:, None, None]
            lfaces = self._on(f'light_faces_{nl}', device, lambda d: torch.as_tensor(
                (base[None] + offs).reshape(-1, 3), device=d)).expand(b, nl * 2, 3)
            meshes.append(RGBMesh(verts=torch.cat([corners, z], dim=-1),
                                  faces=lfaces, attrs=lattrs).expand(num_cameras))

        if waypoints is not None:
            b, nc, m = waypoints.shape[:3]
            vd = self.waypoint_template_verts.shape[0]
            fd = self.waypoint_template_faces.shape[0]
            disc = self._on('disc', device, lambda d: torch.as_tensor(
                self.waypoint_template_verts, device=d))
            world = disc[None, None, None] + waypoints[..., None, :]   # B,Nc,M,Vd,2
            z = torch.full((b, nc, m, vd, 1), self.waypoint_z, device=device)
            wverts = torch.cat([world, z], dim=-1).reshape(b * nc, m * vd, 3)
            wattrs = self._on('waypoint_color', device, lambda d: torch.as_tensor(
                self.waypoint_color, device=d)).expand(b * nc, m * vd, 3)
            offs = (vd * np.arange(m, dtype=np.int64))[:, None, None]
            wf = (self.waypoint_template_faces[None].astype(np.int64) + offs
                  ).reshape(-1, 3)
            wfaces = self._on(f'waypoint_faces_{m}', device, lambda d: torch.as_tensor(
                wf, device=d)).expand(b * nc, m * fd, 3)
            if waypoints_rendering_mask is not None:
                wm = waypoints_rendering_mask.reshape(b * nc, m, 1, 1).expand(
                    b * nc, m, fd, 3).reshape(wfaces.shape)
                wfaces = wfaces * wm
            meshes.append(RGBMesh(verts=wverts, faces=wfaces, attrs=wattrs))

        return RGBMesh.concat(meshes)
