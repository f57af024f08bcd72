"""
Per-frame scene primitives and meshes from precomputed templates
(counterpart of ``torchdrivesim_tpu/scene_mesh.py``): the typed-primitive
generator of the env step and the simulator's render (actor boxes and
stoplines as quads, direction markers and waypoint discs as triangles;
absent agents' primitives are degenerate, all-zero corners; no stop or
yield sign, as in the reference), the face soup of the face-soup render
(the same content as triangles), and the per-camera RGB mesh of the mesh
renders (background mesh and the static meshes added to it, actors, stop
and yield signs, traffic lights, waypoints; absent agents' faces collapse
onto vertex 0). The primitives and the mesh open the span ``scene``
(``tracing``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torchdrivesim_tpu_torch import tracing
from torchdrivesim_tpu_torch.mesh import (
    BaseMesh, BirdviewMesh, RGBMesh, build_verts_faces_from_bounding_box,
    generate_disc_mesh, rendering_mesh, set_colors_with_defaults, tensor_color,
)
from torchdrivesim_tpu_torch.utils import as_batch_index, rotate

#: verts per actor: 4 box corners + 3 direction-triangle verts
ACTOR_BOX_VERTS = 4
ACTOR_DIR_VERTS = 3
DIRECTION_SIZE = 0.3


def _map_rgb(mesh: Optional[RGBMesh], f) -> Optional[RGBMesh]:
    """``f`` applied to each array of a batched RGB mesh (as tensors); a
    batch-1 mesh, shared by every environment, as it is."""
    if mesh is None or mesh.verts.shape[0] == 1:
        return mesh
    return RGBMesh(*(f(torch.as_tensor(x)) for x in (mesh.verts, mesh.faces, mesh.attrs)))


def _to_batch(mesh: RGBMesh, batch: int) -> RGBMesh:
    """A batch-1 mesh as a batch of ``batch`` (views); others as they are."""
    return mesh.broadcast_to(batch) if mesh.verts.shape[0] == 1 and batch > 1 else mesh


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
    Holds the actor, traffic-light and sign templates and the static
    meshes, and produces the per-frame typed primitives and RGB meshes.

    Args:
        color_map / rendering_levels: category -> color / priority tables.
        background_mesh: the static map mesh (category-annotated, host
            numpy) that :meth:`generate` puts under every frame, or None.
    """
    #: the static sign controls drawn by :meth:`generate`, in this order
    SIGN_KINDS = ('stop_sign', 'yield_sign')

    def __init__(self, color_map: Dict[str, Tuple[int, int, int]],
                 rendering_levels: Dict[str, float],
                 render_agent_direction: bool = True,
                 background_mesh: Optional[BirdviewMesh] = None):
        self.color_map = color_map
        self.rendering_levels = rendering_levels
        self.render_agent_direction = render_agent_direction
        self.background_mesh = background_mesh
        self._constants = {}         # (name, device) -> tensors, see _on
        self.initialize_waypoint_mesh()
        self.actor_verts = None      # (B, A, S, 2) local template
        self.actor_faces = None      # (A*fpa, 3) host per-batch layout
        self.actor_attrs = None      # (B, A, S, 3) colors
        self.actor_z = None          # (B, A, S) priority
        self.light_quads = None      # (B, Nl, 4, 2) cycle order
        self.light_z = None
        self.light_color_table = None  # (num_states, 3)
        self.static_controls_rgb = None  # stop and yield sign boxes, tensors
        self.static_rgb = []         # RGB meshes added to the background
        self._controls = None        # the controls the meshes were built from

    def initialize_background_mesh(self, background_mesh: Optional[BirdviewMesh]
                                   ) -> None:
        """Put ``background_mesh`` under every frame, without the static
        meshes added to the previous one."""
        if background_mesh is not self.background_mesh:
            self.background_mesh = background_mesh
            self._forget('background')
        self.static_rgb = []
        self._forget('static')

    def add_static_meshes(self, meshes: List[BirdviewMesh]) -> None:
        """Append static elements to the background, colored by their
        categories' colors and priorities (the defaults where unset); host
        numpy meshes or meshes of tensors on the device."""
        self.static_rgb = self.static_rgb + [
            set_colors_with_defaults(m, self.color_map, self.rendering_levels)
            for m in meshes]

    def add_static_rgb_meshes(self, meshes: List[RGBMesh], z: float = 0.0) -> None:
        """Append colored static elements to the background; vertices
        without a third column get the rendering priority ``z``."""
        def lift(m: RGBMesh) -> RGBMesh:
            if m.verts.shape[-1] != 2:
                return m
            if torch.is_tensor(m.verts):
                col = torch.full(m.verts.shape[:-1] + (1,), float(z),
                                 dtype=m.verts.dtype, device=m.verts.device)
                return RGBMesh(torch.cat([m.verts, col], dim=-1), m.faces, m.attrs)
            col = np.full(m.verts.shape[:-1] + (1,), z, m.verts.dtype)
            return RGBMesh(np.concatenate([m.verts, col], axis=-1), m.faces, m.attrs)
        self.static_rgb = self.static_rgb + [lift(m) for m in meshes]

    def initialize_waypoint_mesh(self, waypoint_radius: float = 2.0,
                                 waypoint_num_triangles: int = 10) -> None:
        """The waypoint disc: a fan of ``waypoint_num_triangles`` triangles
        of radius ``waypoint_radius`` meters, in the waypoint color and
        rendering level."""
        self.waypoint_radius = waypoint_radius
        self.waypoint_num_triangles = waypoint_num_triangles
        self.waypoint_template_verts, self.waypoint_template_faces = \
            generate_disc_mesh(radius=waypoint_radius, num_triangles=waypoint_num_triangles)
        self.waypoint_color = tensor_color(self.color_map['goal_waypoint'])
        self.waypoint_z = float(self.rendering_levels['goal_waypoint'])
        self._forget('disc')
        self._forget('waypoint')

    def _forget(self, prefix: str) -> None:
        """Drop the cached constants whose name starts with ``prefix``
        (a new dict: copies sharing the old one keep theirs)."""
        self._constants = {k: v for k, v in self._constants.items()
                           if not k[0].startswith(prefix)}

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
        """Stop and yield signs become static boxes colored by kind
        (tensors on the controls' device); traffic lights keep per-frame
        state. The same controls again change nothing."""
        if traffic_controls is self._controls:
            return
        self._controls = traffic_controls
        signs = []
        for kind in self.SIGN_KINDS:
            control = traffic_controls.get(kind)
            if control is None or control.corners.shape[1] == 0:
                continue
            verts, faces = build_verts_faces_from_bounding_box(control.corners)
            signs.append(set_colors_with_defaults(
                rendering_mesh(BaseMesh(verts=verts, faces=faces), kind),
                self.color_map, self.rendering_levels))
        self.static_controls_rgb = RGBMesh.concat(signs) if signs else None
        light = traffic_controls.get('traffic_light')
        if light is not None and light.corners.shape[1] > 0:
            # stoplines as quads in cycle order (corners 0, 1, 3, 2)
            c = light.corners                             # (B, Nl, 4, 2)
            self.light_quads = torch.stack([c[:, :, 0], c[:, :, 1], c[:, :, 3],
                                            c[:, :, 2]], dim=2)
            self.light_z = float(self.rendering_levels['traffic_light'])
            states = tuple(light.allowed_states)
            self.light_color_table = self._on(
                f'light_colors_{states}', c.device, lambda d: torch.as_tensor(np.stack([
                    tensor_color(self.color_map[f'traffic_light_{s}'])
                    for s in states]), device=d))
        else:
            self.light_quads = None

    def extend(self, n: int) -> "BirdviewRGBMeshGenerator":
        """A copy with every batch element's templates repeated ``n`` times
        contiguously. A background mesh of batch 1 is shared by every
        environment as it is (:meth:`generate` broadcasts it)."""
        other = self.__class__.__new__(self.__class__)
        other.__dict__.update(self.__dict__)
        rep = lambda x: None if x is None else torch.repeat_interleave(x, n, dim=0)
        other.actor_verts = rep(self.actor_verts)
        other.actor_attrs = rep(self.actor_attrs)
        other.actor_z = rep(self.actor_z)
        other.light_quads = rep(self.light_quads)
        other.static_controls_rgb = _map_rgb(self.static_controls_rgb, rep)
        other.static_rgb = [_map_rgb(m, rep) for m in self.static_rgb]
        other._forget('static')
        other._controls = None
        mesh = self.background_mesh
        if mesh is not None and mesh.batch_size > 1:
            other.background_mesh = mesh.expand(n)
            other._constants = {}
        return other

    def expand(self, n: int) -> "BirdviewRGBMeshGenerator":
        """The reference's name of :meth:`extend`: every batch element's
        templates repeated ``n`` times contiguously."""
        return self.extend(n)

    def to(self, device=None) -> "BirdviewRGBMeshGenerator":
        """This generator: its templates stay on the device they were
        built on, and its host constants move to a device at first use."""
        return self

    def _light_colors(self, traffic_light_state: torch.Tensor) -> torch.Tensor:
        """(B, Nl) light states -> (B, Nl, 3) colors."""
        return self.light_color_table[traffic_light_state.long()]

    def copy(self) -> "BirdviewRGBMeshGenerator":
        """A copy sharing the (never written) templates."""
        other = self.__class__.__new__(self.__class__)
        other.__dict__.update(self.__dict__)
        other._constants = dict(self._constants)
        return other

    def select_batch_elements(self, idx) -> "BirdviewRGBMeshGenerator":
        """A copy holding the batch elements ``idx`` of the templates (and
        of a batched background mesh)."""
        other = self.copy()
        dev = next(t.device for t in (self.actor_verts, self.light_quads)
                   if t is not None)
        idx = as_batch_index(idx, dev)
        pick = lambda x: None if x is None else x[idx.to(x.device)]
        other.actor_verts = pick(self.actor_verts)
        other.actor_attrs = pick(self.actor_attrs)
        other.actor_z = pick(self.actor_z)
        other.light_quads = pick(self.light_quads)
        other.static_controls_rgb = _map_rgb(self.static_controls_rgb, pick)
        other.static_rgb = [_map_rgb(m, pick) for m in self.static_rgb]
        other._forget('static')
        other._controls = None
        mesh = self.background_mesh
        if mesh is not None and mesh.batch_size > 1:
            other.background_mesh = mesh.select_batch_elements(idx)
            other._constants = {}
        return other

    def generate_faces(self, agent_state: torch.Tensor,
                       present_mask: Optional[torch.Tensor] = None,
                       traffic_light_state: Optional[torch.Tensor] = None,
                       waypoints: Optional[torch.Tensor] = None,
                       waypoints_rendering_mask: Optional[torch.Tensor] = None):
        """
        The frame's dynamic scene as a face soup, for the renderer's
        ``render_faces_chw``: each agent's box as the triangles (0, 1, 3)
        and (1, 3, 2) of its template and its direction marker (4, 5, 6),
        then each stopline's two triangles colored by its light state, then
        each waypoint disc's triangles, in that order.

        Args:
            agent_state: (B, All, 4); present_mask: (B, All), absent agents'
                faces degenerate (all-zero corners).
            traffic_light_state: (B, Nl) indices into the light states.
            waypoints: (B, M, 2) disc centers; waypoints_rendering_mask:
                (B, M), the discs drawn (the others all-zero).
        Returns:
            (corners (B, F, 3, 2) world space, z (B, F), colors (B, F, 3)).
            With B a multiple of the templates' batch, each template batch
            element serves its B / Bt cameras contiguously (index
            b * Nc + cam).
        """
        b, n_all = agent_state.shape[0], agent_state.shape[1]
        local, actor_z, actor_attrs = self.actor_verts, self.actor_z, self.actor_attrs
        light_quads = self.light_quads
        if local.shape[0] != b:
            reps = b // local.shape[0]
            local = torch.repeat_interleave(local, reps, dim=0)
            actor_z = torch.repeat_interleave(actor_z, reps, dim=0)
            actor_attrs = torch.repeat_interleave(actor_attrs, reps, dim=0)
            if light_quads is not None:
                light_quads = torch.repeat_interleave(light_quads, reps, dim=0)
        psi = agent_state[..., 2:3][..., None]
        xy = agent_state[..., :2][..., None, :]
        world = rotate(local, psi) + xy                     # (B, All, S, 2)
        face_idx = [[0, 1, 3], [1, 3, 2]] + ([[4, 5, 6]] if self.render_agent_direction
                                             else [])
        fpa = len(face_idx)
        corners = world[:, :, face_idx]                     # (B, All, fpa, 3, 2)
        first = [f[0] for f in face_idx]
        if present_mask is not None:
            corners = torch.where(present_mask[..., None, None, None], corners,
                                  world.new_zeros(()))
        parts = [(corners.reshape(b, n_all * fpa, 3, 2),
                  actor_z[:, :, first].expand(b, n_all, fpa).reshape(b, n_all * fpa),
                  actor_attrs[:, :, first].expand(b, n_all, fpa, 3).reshape(
                      b, n_all * fpa, 3))]

        if light_quads is not None and traffic_light_state is not None:
            nl = light_quads.shape[1]
            # cycle order (0, 1, 3, 2) back to corners: faces (0, 1, 3), (1, 3, 2)
            lcorners = light_quads[:, :, [[0, 1, 2], [1, 2, 3]]]   # (B, Nl, 2, 3, 2)
            lcol = self._light_colors(traffic_light_state)[:, :, None].expand(b, nl, 2, 3)
            parts.append((lcorners.reshape(b, nl * 2, 3, 2),
                          torch.full((b, nl * 2), self.light_z, device=world.device),
                          lcol.reshape(b, nl * 2, 3)))

        if waypoints is not None:
            m = waypoints.shape[1]
            fd = self.waypoint_template_faces.shape[0]
            disc = self._on('disc_tris', world.device, lambda d: torch.as_tensor(
                self.waypoint_template_verts[self.waypoint_template_faces], device=d))
            wcorners = disc[None, None] + waypoints[:, :, None, None, :]  # B,M,Fd,3,2
            if waypoints_rendering_mask is not None:
                wcorners = torch.where(waypoints_rendering_mask[..., None, None, None],
                                       wcorners, world.new_zeros(()))
            parts.append((wcorners.reshape(b, m * fd, 3, 2),
                          torch.full((b, m * fd), self.waypoint_z, device=world.device),
                          self._on('waypoint_color', world.device, lambda d: torch.as_tensor(
                              self.waypoint_color, device=d)).expand(b, m * fd, 3)))

        return tuple(torch.cat([p[k] for p in parts], dim=1) for k in range(3))

    def worst_case_prim_counts(self, waypoint_count: int = 0) -> Tuple[int, int]:
        """
        Per-camera primitive counts of :meth:`generate_prims` with all
        content visible at once: (quads, triangles), the agent boxes and
        stoplines, and the direction markers and ``waypoint_count``
        waypoint discs' triangles.
        """
        n_all = self.actor_verts.shape[1] if self.actor_verts is not None else 0
        nl = self.light_quads.shape[1] if self.light_quads is not None else 0
        tris = n_all if self.render_agent_direction else 0
        tris += int(waypoint_count) * int(self.waypoint_template_faces.shape[0])
        return n_all + nl, tris

    def generate_prims(self, agent_state: torch.Tensor,
                       present_mask: Optional[torch.Tensor] = None,
                       traffic_light_state: Optional[torch.Tensor] = None,
                       waypoints: Optional[torch.Tensor] = None,
                       waypoints_rendering_mask: Optional[torch.Tensor] = None):
        """
        Typed primitives of the frame: actor boxes and stoplines as quads in
        cycle order, direction markers and waypoint discs (each a fan of
        the disc template's triangles) as triangles.

        Args:
            agent_state: (B, All, 4); present_mask: (B, All).
            traffic_light_state: (B, Nl) indices into the light states.
            waypoints: (B, M, 2) disc centers; waypoints_rendering_mask:
                (B, M), the discs drawn (the others are degenerate).
        Returns:
            (quads (B, Q, 4, 2), qz (B, Q), qcolors (B, Q, 3),
             tris (B, T, 3, 2), tz (B, T), tcolors (B, T, 3)).
        """
        with tracing.span('scene'):
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

            if waypoints is not None:
                m = waypoints.shape[1]
                fd = self.waypoint_template_faces.shape[0]
                disc = self._on('disc_tris', world.device, lambda d: torch.as_tensor(
                    self.waypoint_template_verts[self.waypoint_template_faces], device=d))
                wcorners = disc[None, None] + waypoints[:, :, None, None, :]  # B,M,Fd,3,2
                if waypoints_rendering_mask is not None:
                    wcorners = torch.where(
                        waypoints_rendering_mask[..., None, None, None], wcorners, zero)
                tris.append(wcorners.reshape(b, m * fd, 3, 2))
                tz.append(torch.full((b, m * fd), self.waypoint_z, device=world.device))
                tcol.append(self._on('waypoint_color', world.device,
                                     lambda d: torch.as_tensor(self.waypoint_color, device=d)
                                     ).expand(b, m * fd, 3))

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
                 custom_agent_colors: Optional[torch.Tensor] = None,
                 include_background: bool = True) -> RGBMesh:
        """
        The per-camera RGB mesh of the frame, as tensors: the background
        mesh and the static meshes added to it (with
        ``include_background``), the actors transformed by their states,
        the stop and yield signs, the traffic-light stoplines colored by
        state and the waypoint discs, concatenated in that order.

        Args:
            agent_state: (B, Nc, All, 4) states shared or per camera.
            present_mask: (B, Nc, All) which agents each camera renders.
            traffic_light_state: (B, Nl) light state indices.
            waypoints: (B, Nc, M, 2); waypoints_rendering_mask: (B, Nc, M).
            custom_agent_colors: (B, Nc, All, 3) colors in [0, 1] of each
                camera's agent boxes (the direction markers keep theirs).
        Returns:
            RGBMesh with batch size B * Nc, verts (x, y, priority z).
        """
        with tracing.span('scene'):
            meshes = []
            device = next(t.device for t in (agent_state, traffic_light_state, waypoints)
                          if t is not None)
            batch = next(t.shape[0] for t in (agent_state, traffic_light_state, waypoints)
                         if t is not None)
            if include_background:
                parts = [] if self.background_rgb is None else [
                    self._on('background', device, self.background_rgb.to)]
                parts += [m.to(device) if torch.is_tensor(m.verts)
                          else self._on(f'static_{i}', device, m.to)
                          for i, m in enumerate(self.static_rgb)]
                # a batch-1 map mesh is shared by every environment
                parts = [_to_batch(m, batch) for m in parts]
                if parts:
                    background = parts[0] if len(parts) == 1 else RGBMesh.concat(parts)
                    meshes.append(background.expand(num_cameras))

            if agent_state is not None and self.actor_verts is not None:
                b, nc, n_all = agent_state.shape[:3]
                s = self.actor_verts.shape[-2]
                local = self.actor_verts[:, None].expand(b, nc, n_all, s, 2)
                psi = agent_state[..., 2:3][..., None, :]          # B,Nc,All,1,1
                xy = agent_state[..., :2][..., None, :]            # B,Nc,All,1,2
                world = rotate(local, psi) + xy                    # B,Nc,All,S,2
                z = self.actor_z[:, None, :, :, None].expand(b, nc, n_all, s, 1)
                verts = torch.cat([world, z], dim=-1).reshape(b * nc, n_all * s, 3)
                attrs = self.actor_attrs[:, None].expand(b, nc, n_all, s, 3)
                if custom_agent_colors is not None:
                    # recolor the box vertices only, keep the direction triangles
                    boxes = custom_agent_colors[..., None, :].to(attrs.dtype).expand(
                        b, nc, n_all, ACTOR_BOX_VERTS, 3)
                    attrs = torch.cat([boxes, attrs[..., ACTOR_BOX_VERTS:, :]], dim=-2) \
                        if s > ACTOR_BOX_VERTS else boxes
                attrs = attrs.reshape(b * nc, n_all * s, 3)
                faces = self._on('actor_faces', device, lambda d: torch.as_tensor(
                    self.actor_faces, dtype=torch.int64, device=d)).expand(b * nc, -1, 3)
                if present_mask is not None:
                    fpa = self.actor_faces.shape[0] // n_all
                    fm = present_mask.reshape(b * nc, n_all, 1, 1).expand(
                        b * nc, n_all, fpa, 3).reshape(faces.shape)
                    faces = faces * fm
                meshes.append(RGBMesh(verts=verts, faces=faces, attrs=attrs))

            if self.static_controls_rgb is not None:
                meshes.append(_to_batch(self.static_controls_rgb, batch).expand(
                    num_cameras))

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
                wfaces = self._on(f'waypoint_faces_{m}', device,
                                  lambda d: torch.as_tensor(wf, device=d)
                                  ).expand(b * nc, m * fd, 3)
                if waypoints_rendering_mask is not None:
                    wm = waypoints_rendering_mask.reshape(b * nc, m, 1, 1).expand(
                        b * nc, m, fd, 3).reshape(wfaces.shape)
                    wfaces = wfaces * wm
                meshes.append(RGBMesh(verts=wverts, faces=wfaces, attrs=wattrs))

            return RGBMesh.concat(meshes)
