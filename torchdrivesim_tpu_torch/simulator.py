"""
Simulator state and the pure env step (counterpart of
``torchdrivesim_tpu/simulator.py``; the state, ``functional_step`` with
the per-agent kinematic dispatch, ``fit_action``, the static NPC
controller, the batch ``extend``, ``render`` and the facade subset the
benchmark uses).

:class:`SimulatorState` is a dataclass of tensors on one device, time
included, so a step launches device work without waiting on the host.
PyTorch runs eagerly: a rollout is a Python loop over
:meth:`Simulator.functional_step`.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from torchdrivesim_tpu_torch import kinematic as K
from torchdrivesim_tpu_torch.goals import WaypointGoalState, step_waypoints
from torchdrivesim_tpu_torch.map_grids import MapGrids
from torchdrivesim_tpu_torch.rendering.base import Cameras, RendererConfig
from torchdrivesim_tpu_torch.rendering.renderer import Renderer
from torchdrivesim_tpu_torch.scene_mesh import BirdviewRGBMeshGenerator
from torchdrivesim_tpu_torch.traffic_controls import BaseTrafficControl
from torchdrivesim_tpu_torch.utils import Resolution


@dataclass
class TorchDriveConfig:
    """Top-level simulator configuration (the fields the env step reads)."""
    renderer: RendererConfig = field(default_factory=RendererConfig)
    offroad_threshold: float = 0.5
    left_handed_coordinates: bool = False
    waypoint_removal_threshold: float = 2.0


@dataclass
class SimulatorState:
    """Everything that changes during simulation, as tensors on one device."""
    agent_state: torch.Tensor                 #: BxAx4 (x, y, psi, v)
    present_mask: torch.Tensor                #: BxA bool
    npc_state: torch.Tensor                   #: BxNpcx4
    npc_present_mask: torch.Tensor            #: BxNpc bool
    traffic_control_state: Dict[str, torch.Tensor]  #: per control type, BxN int
    waypoint_state: Optional[WaypointGoalState]
    time: torch.Tensor                        #: 0-dim int32 step counter
    npc_time: torch.Tensor                    #: 0-dim int32 controller clock

    @property
    def batch_size(self) -> int:
        return self.agent_state.shape[0]


class NPCController:
    """NPCs that keep their states (no spawning); static attributes only,
    the dynamic NPC state lives in :class:`SimulatorState`."""
    def __init__(self, npc_size: torch.Tensor, npc_state: torch.Tensor,
                 npc_present_mask: Optional[torch.Tensor] = None):
        self.npc_size = npc_size
        self.initial_npc_state = npc_state
        self.initial_npc_present_mask = (
            npc_present_mask if npc_present_mask is not None
            else torch.ones(npc_state.shape[:-1], dtype=torch.bool,
                            device=npc_state.device))

    def advance(self, npc_state: torch.Tensor, npc_present_mask: torch.Tensor,
                time: torch.Tensor):
        """(state, mask, time) -> (state, mask); static NPCs hold."""
        return npc_state, npc_present_mask

    def extend(self, n: int) -> "NPCController":
        """A copy with every batch element repeated ``n`` times."""
        rep = lambda x: torch.repeat_interleave(x, n, dim=0)
        return NPCController(rep(self.npc_size), rep(self.initial_npc_state),
                             rep(self.initial_npc_present_mask))

    @classmethod
    def empty(cls, batch_size: int, *, device) -> "NPCController":
        return cls(npc_size=torch.zeros((batch_size, 0, 2), device=device),
                   npc_state=torch.zeros((batch_size, 0, 4), device=device),
                   npc_present_mask=torch.zeros((batch_size, 0), dtype=torch.bool,
                                                device=device))


class Simulator:
    """
    Facade holding the static parameters (sizes, kinematic parameters,
    controls, grids, renderer) and the current :attr:`state`.

    Everything lives on the device of the kinematic model's state.

    Args:
        road_mesh: the map's drivable-area mesh (host BirdviewMesh, or
            None): the background of the per-camera meshes
            (``birdview_mesh_generator.generate``); the textured render does
            not read it.
        kinematic_model: holds the initial agent states and parameters.
        agent_size: BxAx2 (length, width).
        initial_present_mask: BxA bool.
        waypoints: optional BxAxNxMx2 waypoint goals, all active at first.
    """
    def __init__(self, road_mesh, kinematic_model: K.KinematicModel,
                 agent_size, initial_present_mask, cfg: TorchDriveConfig,
                 traffic_controls: Optional[Dict[str, BaseTrafficControl]] = None,
                 map_grids: Optional[MapGrids] = None,
                 npc_controller: Optional[NPCController] = None,
                 waypoints: Optional[torch.Tensor] = None,
                 internal_time: int = 0):
        self.device = kinematic_model.get_state().device
        self.road_mesh = road_mesh
        self.kinematic_model = kinematic_model
        self.agent_size = torch.as_tensor(agent_size, dtype=torch.float32,
                                          device=self.device)
        self._batch_size = self.agent_size.shape[0]
        self.cfg = cfg
        self.map_grids = map_grids
        self.traffic_controls = traffic_controls
        self.waypoints = waypoints
        self.npc_controller = npc_controller or NPCController.empty(
            self._batch_size, device=self.device)
        cfg.renderer.left_handed_coordinates = cfg.left_handed_coordinates
        self.renderer = Renderer(cfg.renderer, self.device)
        self.birdview_mesh_generator = BirdviewRGBMeshGenerator(
            self.renderer.color_map, self.renderer.rendering_levels,
            render_agent_direction=cfg.renderer.render_agent_direction,
            background_mesh=road_mesh)
        all_size = self.get_all_agent_size()
        self.birdview_mesh_generator.initialize_actors_mesh(
            all_size, torch.zeros(all_size.shape[:2], dtype=torch.int64,
                                  device=self.device), ['vehicle'])
        if traffic_controls is not None:
            self.birdview_mesh_generator.initialize_traffic_controls_mesh(
                traffic_controls)

        as_time = lambda t: torch.tensor(t, dtype=torch.int32, device=self.device)
        waypoint_state = None
        if waypoints is not None:
            waypoint_state = WaypointGoalState(
                state=torch.zeros(waypoints.shape[:2] + (1,), dtype=torch.int32,
                                  device=self.device),
                mask=torch.ones(waypoints.shape[:-1], dtype=torch.bool,
                                device=self.device))
        self.state = SimulatorState(
            agent_state=kinematic_model.get_state(),
            present_mask=torch.as_tensor(initial_present_mask, dtype=torch.bool,
                                         device=self.device),
            npc_state=self.npc_controller.initial_npc_state,
            npc_present_mask=self.npc_controller.initial_npc_present_mask,
            traffic_control_state={k: v.state for k, v in
                                   (traffic_controls or {}).items()},
            waypoint_state=waypoint_state,
            time=as_time(internal_time), npc_time=as_time(0))

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @property
    def agent_count(self) -> int:
        return self.agent_size.shape[-2]

    @property
    def action_size(self) -> int:
        """Width of the actions :meth:`functional_step` takes."""
        return self.kinematic_model.action_size

    def fit_action(self, future_state: torch.Tensor,
                   current_state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The kinematic model's inverse dynamics from ``current_state``
        (the current agent states by default) to ``future_state``."""
        return self.kinematic_model.fit_action(
            future_state, self.state.agent_state if current_state is None
            else current_state)

    def get_all_agent_size(self) -> torch.Tensor:
        return torch.cat([self.agent_size, self.npc_controller.npc_size], dim=-2)

    def extend(self, n: int, in_place: bool = True) -> "Simulator":
        """
        Multiply the batch dimension: every environment repeated ``n`` times
        contiguously (sizes, kinematic state and parameters, controls, mesh
        generator, NPC controller, waypoints and the state). A road mesh of
        batch 1 is shared by every environment as it is.

        Returns:
            this simulator, or with ``in_place=False`` an extended copy (the
            renderer, the configuration and the map grids, which hold no
            batch, are shared).
        """
        target = self if in_place else copy.copy(self)
        rep = lambda x: None if x is None else torch.repeat_interleave(x, n, dim=0)
        if self.road_mesh is not None and self.road_mesh.batch_size > 1:
            target.road_mesh = self.road_mesh.expand(n)
        target.agent_size = rep(self.agent_size)
        target._batch_size = self._batch_size * n
        target.kinematic_model = copy.copy(self.kinematic_model)
        target.kinematic_model.extend(n)
        if self.traffic_controls is not None:
            target.traffic_controls = {k: v.extend(n)
                                       for k, v in self.traffic_controls.items()}
        target.waypoints = rep(self.waypoints)
        target.npc_controller = self.npc_controller.extend(n)
        target.birdview_mesh_generator = self.birdview_mesh_generator.extend(n)
        st = self.state
        wp = st.waypoint_state
        target.state = SimulatorState(
            agent_state=rep(st.agent_state), present_mask=rep(st.present_mask),
            npc_state=rep(st.npc_state), npc_present_mask=rep(st.npc_present_mask),
            traffic_control_state={k: rep(v) for k, v in
                                   st.traffic_control_state.items()},
            waypoint_state=None if wp is None else WaypointGoalState(
                state=rep(wp.state), mask=rep(wp.mask)),
            time=st.time, npc_time=st.npc_time)
        return target

    def functional_step(self, state: SimulatorState, agent_action: torch.Tensor
                        ) -> SimulatorState:
        """
        One pure simulation step: NPC advance, kinematic step,
        traffic-control advance, waypoint advance.
        """
        time = state.time + 1
        npc_time = state.npc_time + 1
        npc_state, npc_mask = self.npc_controller.advance(
            state.npc_state, state.npc_present_mask, npc_time)
        km = self.kinematic_model
        # a compound model dispatches per agent over the ids it holds, with
        # the set in use known on the host
        agent_state = K.step(state.agent_state, agent_action, km.params,
                             single_model=km.model_id,
                             model_ids=getattr(km, 'model_assignments', None),
                             models=getattr(km, 'models_in_use', None))
        tc_state = {kind: control.advance(state.traffic_control_state[kind], time)
                    for kind, control in (self.traffic_controls or {}).items()}
        wp_state = state.waypoint_state
        if self.waypoints is not None and wp_state is not None:
            wp_state = step_waypoints(self.waypoints, wp_state, agent_state,
                                      threshold=self.cfg.waypoint_removal_threshold)
        return SimulatorState(
            agent_state=agent_state, present_mask=state.present_mask,
            npc_state=npc_state, npc_present_mask=npc_mask,
            traffic_control_state=tc_state, waypoint_state=wp_state,
            time=time, npc_time=npc_time)

    def render(self, camera_xy: torch.Tensor, camera_psi: torch.Tensor,
               res: Optional[Resolution] = None,
               rendering_mask: Optional[torch.Tensor] = None,
               fov: Optional[float] = None,
               waypoints: Optional[torch.Tensor] = None,
               waypoints_rendering_mask: Optional[torch.Tensor] = None,
               custom_agent_colors: Optional[torch.Tensor] = None,
               noisy_perception: bool = False) -> torch.Tensor:
        """
        Bird's-eye views of the current state from arbitrary cameras: with a
        background texture, the typed primitives by the fused render; else
        the frame's mesh (the map mesh, the actors and the lights) by the
        renderer's mesh render (hard by default).

        Args:
            camera_xy: (B, Nc, 2) or (B, 2) centers; camera_psi: (B, Nc, 1)
                or (B, 1) headings.
            rendering_mask: (B, Nc, All) which agents each camera shows.
            waypoints: (B, Nc, M, 2) discs to draw (mesh render only);
                waypoints_rendering_mask: (B, Nc, M).
        Returns:
            (B, Nc, 3, H, W) float images in [0, 255].
        """
        if custom_agent_colors is not None or noisy_perception:
            raise NotImplementedError(
                "custom agent colors and noisy perception are not ported")
        camera_sc = torch.cat([torch.sin(camera_psi), torch.cos(camera_psi)], dim=-1)
        if camera_xy.dim() == 2:
            camera_xy, camera_sc = camera_xy[:, None], camera_sc[:, None]
        b, n_cameras = camera_xy.shape[0], camera_xy.shape[1]
        state = self.state
        all_state = torch.cat([state.agent_state, state.npc_state], dim=-2)
        present = torch.cat([state.present_mask, state.npc_present_mask], dim=-1)
        n_all = present.shape[-1]
        present = present[:, None].expand(b, n_cameras, n_all)
        rendering_mask = present if rendering_mask is None \
            else present & rendering_mask
        light_state = state.traffic_control_state.get('traffic_light')
        res_used = res or self.renderer.res
        generator = self.birdview_mesh_generator
        if self.renderer.background_texture is not None:
            if waypoints is not None:
                raise NotImplementedError(
                    "waypoint discs are not ported to the primitive render")
            flat = lambda x: torch.repeat_interleave(x, n_cameras, dim=0)
            prims = generator.generate_prims(
                flat(all_state), present_mask=rendering_mask.reshape(b * n_cameras, n_all),
                traffic_light_state=None if light_state is None else flat(light_state))
            scale = (2.0 / fov) if fov is not None else self.renderer.scale
            image = self.renderer.render_prims_chw(
                *prims, res_used, Cameras(camera_xy.reshape(-1, 2),
                                          camera_sc.reshape(-1, 2), scale))
        else:
            mesh = generator.generate(
                n_cameras, agent_state=all_state[:, None].expand(b, n_cameras, n_all, 4),
                present_mask=rendering_mask, traffic_light_state=light_state,
                waypoints=waypoints, waypoints_rendering_mask=waypoints_rendering_mask,
                include_background=True)
            image = self.renderer.render_frame(mesh, camera_xy, camera_sc,
                                               res=res, fov=fov)
        return image.reshape(b, n_cameras, 3, res_used.height, res_used.width)

    def set_light_schedule(self, schedule) -> None:
        """
        Drive the 'traffic_light' control from a baked FSM schedule; the
        schedule applies at the current time too, so a render before the
        first step already sees FSM-driven lights.
        """
        control = (self.traffic_controls or {}).get('traffic_light')
        assert control is not None, "no 'traffic_light' control to schedule"
        control.set_schedule(schedule, dt=float(self.kinematic_model.dt))
        current = self.state.traffic_control_state.get('traffic_light')
        if current is not None and schedule is not None:
            now = control.advance(current, self.state.time)
            self.state = dataclasses.replace(
                self.state, traffic_control_state={
                    **self.state.traffic_control_state, 'traffic_light': now})
            control.state = now
