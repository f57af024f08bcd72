"""
The simulator (counterpart of ``torchdrivesim_tpu/simulator.py``): the
state, the pure env step ``functional_step`` with the per-agent kinematic
dispatch, the NPC controllers (static, replayed, compound, with spawning
and despawning), and the stateful :class:`Simulator`
facade with the reference's method surface (``step``, ``set_state``,
``copy``, ``extend``, ``select_batch_elements``, the getters and the
``get_noisy_*`` observations of its observation noise model, ``render``
and ``render_egocentric`` with noisy perception and custom agent colors,
the four ``compute_*`` metrics and ``check_prim_budget``).

:class:`SimulatorState` is a dataclass of tensors on one device, time
included, so a step launches device work without waiting on the host.
PyTorch runs eagerly: a rollout is a Python loop over
:meth:`Simulator.step` or :meth:`Simulator.functional_step`.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from torchdrivesim_tpu_torch import kinematic as K, tracing
from torchdrivesim_tpu_torch.goals import (
    WaypointGoal, WaypointGoalState, gather_current, step_waypoints,
)
from torchdrivesim_tpu_torch.infractions import (
    compute_agent_collisions_metric, compute_agent_collisions_metric_pytorch3d,
    compute_collision_matrix, lanelet_orientation_loss, offroad_infraction_loss,
)
from torchdrivesim_tpu_torch.lanelet2 import LaneFeatures
from torchdrivesim_tpu_torch.map_grids import (
    MapGrids, offroad_loss_from_grid, wrong_way_loss_from_grid,
)
from torchdrivesim_tpu_torch.mesh import BaseMesh, BirdviewMesh
from torchdrivesim_tpu_torch.observation_noise import (
    ObservationNoise, ObservationNoiseConfig,
)
from torchdrivesim_tpu_torch.rendering import renderer_from_config
from torchdrivesim_tpu_torch.rendering.base import (
    BirdviewRenderer, BirdviewRendererConfig, Cameras, RendererConfig,
)
from torchdrivesim_tpu_torch.scene_mesh import BirdviewRGBMeshGenerator
from torchdrivesim_tpu_torch.traffic_controls import (
    BaseTrafficControl, red_light_violations,
)
from torchdrivesim_tpu_torch.utils import (
    Resolution, as_batch_index, assert_equal, host_repeat, is_inside_polygon,
    relative, rotate, time_slice,
)

logger = logging.getLogger(__name__)


class CollisionMetric(Enum):
    """How :meth:`Simulator.compute_collision` measures overlap."""
    iou = 'iou'
    discs = 'discs'
    nograd = 'nograd'
    nograd_pytorch3d = 'nograd-pytorch3d'


@dataclass
class TorchDriveConfig:
    """Top-level simulator configuration."""
    #: a renderer configuration (the port's, the reference's shims or a
    #: ``DummyRendererConfig``) or a dict with a ``backend`` key, as
    #: ``rendering.renderer_from_config`` takes it
    renderer: BirdviewRendererConfig = field(default_factory=RendererConfig)
    #: render_egocentric: each agent's camera shows itself and the NPCs only
    single_agent_rendering: bool = False
    collision_metric: CollisionMetric = field(
        default_factory=lambda: CollisionMetric.discs)
    offroad_threshold: float = 0.5
    left_handed_coordinates: bool = False
    wrong_way_angle_threshold: float = float(np.pi / 2)
    #: the host wrong-way path's distance tolerance to a lanelet
    lanelet_inclusion_tolerance: float = 1.0
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


class SpawnController:
    """
    Despawns NPCs that leave ``exit_boundary`` and spawns NPCs from timed
    tables: at controller time t an absent NPC whose ``spawn_masks`` entry
    at t holds appears at ``spawn_states``' entry at t (the time axis is
    clamped to its range).

    Args:
        exit_boundary: (B, N, 2) convex polygon vertices.
        spawn_states: (B, Npc, T, 4); spawn_masks: (B, Npc, T) bool.
        device: where the tables live (their own device by default).
    """
    _BATCHED = ('exit_boundary', 'spawn_states', 'spawn_masks')

    def __init__(self, exit_boundary=None, spawn_states=None, spawn_masks=None,
                 device=None):
        f = lambda x, dtype: None if x is None else torch.as_tensor(
            x, dtype=dtype, device=device)
        self.exit_boundary = f(exit_boundary, torch.float32)
        self.spawn_states = f(spawn_states, torch.float32)
        self.spawn_masks = f(spawn_masks, torch.bool)

    def apply(self, npc_state: torch.Tensor, npc_present_mask: torch.Tensor, time):
        """(state, mask) after despawning and spawning at ``time`` (an int
        or a 0-dim tensor on the device: no host sync)."""
        if self.exit_boundary is not None:
            inside = is_inside_polygon(npc_state[..., :2], self.exit_boundary)
            npc_present_mask = npc_present_mask & inside
        if self.spawn_states is not None and self.spawn_masks is not None:
            time = torch.as_tensor(time, device=npc_state.device)
            mask_t = time_slice(self.spawn_masks, time, dim=-1)
            state_t = time_slice(self.spawn_states, time, dim=-2)
            to_spawn = mask_t & ~npc_present_mask
            npc_present_mask = npc_present_mask | to_spawn
            npc_state = torch.where(to_spawn[..., None], state_t, npc_state)
        return npc_state, npc_present_mask

    def to(self, device=None) -> "SpawnController":
        """The controller with its tables on ``device``."""
        return self._map(lambda x: x.to(device), in_place=False)

    def copy(self) -> "SpawnController":
        return copy.copy(self)

    def _map(self, f, in_place: bool) -> "SpawnController":
        target = self if in_place else self.copy()
        for name in self._BATCHED:
            value = getattr(self, name)
            setattr(target, name, None if value is None else f(value))
        return target

    def extend(self, n: int, in_place: bool = True) -> "SpawnController":
        return self._map(lambda x: host_repeat(x, n), in_place)

    def select_batch_elements(self, idx, in_place: bool = True) -> "SpawnController":
        return self._map(lambda x: x[as_batch_index(idx, x.device)], in_place)


class NPCController:
    """
    NPCs that keep their states, apart from what their
    :class:`SpawnController` spawns and despawns: static attributes only,
    the dynamic NPC state lives in :class:`SimulatorState`. Tensors are on
    the device of ``npc_state``; every change rebinds an attribute, so a
    :meth:`copy` is independent.
    """
    def __init__(self, npc_size, npc_state, npc_present_mask=None,
                 npc_types=None, agent_type_names: Optional[List[str]] = None,
                 spawn_controller: Optional[SpawnController] = None):
        self.initial_npc_state = torch.as_tensor(npc_state, dtype=torch.float32)
        dev = self.initial_npc_state.device
        self.npc_size = torch.as_tensor(npc_size, dtype=torch.float32, device=dev)
        shape = self.initial_npc_state.shape[:-1]
        self.initial_npc_present_mask = (
            torch.as_tensor(npc_present_mask, dtype=torch.bool, device=dev)
            if npc_present_mask is not None
            else torch.ones(shape, dtype=torch.bool, device=dev))
        self.npc_types = (torch.as_tensor(npc_types, dtype=torch.int32, device=dev)
                          if npc_types is not None
                          else torch.zeros(shape, dtype=torch.int32, device=dev))
        self.agent_type_names = agent_type_names or ['vehicle']
        self.spawn_controller = (spawn_controller or SpawnController()).to(dev)

    def advance(self, npc_state: torch.Tensor, npc_present_mask: torch.Tensor,
                time: torch.Tensor, simulator: Optional["Simulator"] = None):
        """(state, mask, controller time[, simulator]) -> (state, mask):
        static NPCs hold, the spawn controller applies."""
        return self.spawn_controller.apply(npc_state, npc_present_mask, time)

    def advance_npcs(self, simulator: "Simulator") -> None:
        """Advance the simulator's NPCs and controller clock one step."""
        s = simulator.state
        npc_time = s.npc_time + 1
        npc_state, npc_mask = self.advance(s.npc_state, s.npc_present_mask,
                                           npc_time, simulator)
        simulator.state = dataclasses.replace(
            simulator.state, npc_state=npc_state, npc_present_mask=npc_mask,
            npc_time=npc_time)

    def spawn_despawn_npcs(self, simulator: "Simulator") -> None:
        """Apply only the spawn controller to the simulator's NPCs at the
        current controller time."""
        s = simulator.state
        npc_state, npc_mask = self.spawn_controller.apply(
            s.npc_state, s.npc_present_mask, s.npc_time)
        simulator.state = dataclasses.replace(s, npc_state=npc_state,
                                              npc_present_mask=npc_mask)

    def get_npc_state(self) -> torch.Tensor:
        """The initial NPC states; the live ones are ``SimulatorState.npc_state``."""
        return self.initial_npc_state

    def get_npc_present_mask(self) -> torch.Tensor:
        return self.initial_npc_present_mask

    def get_npc_size(self) -> torch.Tensor:
        return self.npc_size

    def get_npc_types(self) -> torch.Tensor:
        return self.npc_types

    def to(self, device=None) -> "NPCController":
        return self

    def copy(self) -> "NPCController":
        other = copy.copy(self)
        other.spawn_controller = self.spawn_controller.copy()
        return other

    _BATCHED = ('npc_size', 'initial_npc_state', 'initial_npc_present_mask',
                'npc_types')

    def _map(self, f, in_place: bool) -> "NPCController":
        """``f`` applied to every batched tensor, and to the batched tensors
        of the spawn controller."""
        target = self if in_place else self.copy()
        for name in self._BATCHED:
            setattr(target, name, f(getattr(self, name)))
        target.spawn_controller = self.spawn_controller._map(f, in_place=False)
        return target

    def extend(self, n: int, in_place: bool = True) -> "NPCController":
        """Every batch element repeated ``n`` times contiguously."""
        return self._map(lambda x: host_repeat(x, n), in_place)

    def select_batch_elements(self, idx, in_place: bool = True) -> "NPCController":
        idx = as_batch_index(idx, self.initial_npc_state.device)
        return self._map(lambda x: x[idx], in_place)

    @classmethod
    def empty(cls, batch_size: int, agent_type_names: Optional[List[str]] = None,
              *, device) -> "NPCController":
        return cls(npc_size=torch.zeros((batch_size, 0, 2), device=device),
                   npc_state=torch.zeros((batch_size, 0, 4), device=device),
                   npc_present_mask=torch.zeros((batch_size, 0), dtype=torch.bool,
                                                device=device),
                   agent_type_names=agent_type_names)


class ReplayController(NPCController):
    """
    NPCs replayed from recorded trajectories: at controller time t every
    NPC takes entry ``(t + time) mod T`` of its (B, Npc, T, 4) table (and
    of its (B, Npc, T) presence), then the spawn controller applies. The
    index stays on the device (``torch.remainder`` and a gather), so the
    advance makes no host sync.

    Args:
        npc_states: (B, Npc, T, 4) recorded states.
        npc_present_masks: (B, Npc, T) bool, all present by default.
        time: the table entry of controller time 0.
    """
    _BATCHED = NPCController._BATCHED + ('npc_states', 'npc_present_masks')

    def __init__(self, npc_size, npc_states, npc_present_masks=None, time: int = 0,
                 npc_types=None, agent_type_names: Optional[List[str]] = None,
                 spawn_controller: Optional[SpawnController] = None):
        self.npc_states = torch.as_tensor(npc_states, dtype=torch.float32)
        dev = self.npc_states.device
        self.npc_present_masks = (
            torch.as_tensor(npc_present_masks, dtype=torch.bool, device=dev)
            if npc_present_masks is not None
            else torch.ones(self.npc_states.shape[:-1], dtype=torch.bool, device=dev))
        self.start_time = int(time)
        super().__init__(npc_size, self.npc_states[..., self.start_time, :],
                         self.npc_present_masks[..., self.start_time], npc_types,
                         agent_type_names, spawn_controller)

    def advance(self, npc_state, npc_present_mask, time, simulator=None):
        time = torch.as_tensor(time, device=self.npc_states.device)
        t = torch.remainder(time + self.start_time, self.npc_states.shape[-2])
        state = time_slice(self.npc_states, t, dim=-2)
        mask = time_slice(self.npc_present_masks, t, dim=-1)
        return self.spawn_controller.apply(state, mask, time)


class CompoundNPCController(NPCController):
    """
    Each NPC slot driven by one of several controllers over the same slots:
    slot j of batch element b follows ``controllers[controller_indices[b,
    j]]``, merged by ``torch.where``.

    Args:
        controllers: controllers of the same (B, Npc) slots.
        controller_indices: (B, Npc) index of each slot's controller.
    """
    def __init__(self, controllers: List[NPCController], controller_indices):
        self.controllers = controllers
        base = controllers[0]
        dev = base.initial_npc_state.device
        self.controller_indices = torch.as_tensor(controller_indices, dtype=torch.int64,
                                                  device=dev)
        fields = {name: getattr(base, name) for name in NPCController._BATCHED}
        for i, c in enumerate(controllers):
            sel = self.controller_indices == i
            for name, value in fields.items():
                other = getattr(c, name)
                fields[name] = torch.where(
                    sel.reshape(sel.shape + (1,) * (other.dim() - sel.dim())),
                    other, value)
        super().__init__(fields['npc_size'], fields['initial_npc_state'],
                         fields['initial_npc_present_mask'], fields['npc_types'],
                         base.agent_type_names)

    def advance(self, npc_state, npc_present_mask, time, simulator=None):
        out_state, out_mask = npc_state, npc_present_mask
        for i, c in enumerate(self.controllers):
            s, m = c.advance(npc_state, npc_present_mask, time, simulator)
            sel = self.controller_indices == i
            out_state = torch.where(sel[..., None], s, out_state)
            out_mask = torch.where(sel, m, out_mask)
        return out_state, out_mask

    def gather_npc_states(self):
        """Kept for the reference's API: :meth:`advance` merges the
        sub-controllers' outputs itself, so there is nothing to gather."""
        return None

    def copy(self) -> "CompoundNPCController":
        other = super().copy()
        other.controllers = [c.copy() for c in self.controllers]
        return other

    def _map(self, f, in_place: bool) -> "CompoundNPCController":
        target = super()._map(f, in_place)
        target.controller_indices = f(self.controller_indices)
        target.controllers = [c._map(f, in_place=False) for c in self.controllers]
        return target


class Simulator:
    """
    Stateful facade holding the static parameters (sizes, kinematic
    parameters, controls, grids, renderer) and the current :attr:`state`,
    with the reference's constructor keywords and method surface.

    Everything lives on the device of the kinematic model's state.

    Args:
        road_mesh: the map's drivable-area mesh (host ``BirdviewMesh``, of
            batch B or of batch 1 shared by every environment, or None):
            the background of the per-camera meshes and the exact offroad
            metric's surface; the textured render does not read it.
        kinematic_model: holds the initial agent states and parameters.
        agent_size: BxAx2 (length, width).
        initial_present_mask: BxA bool.
        cfg: configuration.
        renderer: a renderer to use instead of the one
            ``rendering.renderer_from_config`` builds from ``cfg.renderer``
            on the simulator's device.
        lanelet_map: B lanelet maps (or None) for the host wrong-way path.
        recenter_offset: Bx2 offset added to states for map lookups.
        waypoint_goals: a :class:`WaypointGoal` (BxAxNxMx2 waypoints).
        agent_types / agent_type_names: BxA indices into the names
            (default all 'vehicle').
        agent_lr: BxA rear-axle distances reported by :meth:`get_agent_lr`.
        action_model_extras: passed through :meth:`get_action_model_extras`.
        lane_features: a :class:`LaneFeatures` of batch B on the device (or None).
        observation_noise_model: what the ``get_noisy_*`` getters and the
            noisy render observe; ``ObservationNoise`` (the exact world)
            by default.
    """
    def __init__(self, road_mesh, kinematic_model: K.KinematicModel,
                 agent_size, initial_present_mask, cfg: TorchDriveConfig,
                 renderer: Optional[BirdviewRenderer] = None,
                 lanelet_map: Optional[List] = None,
                 recenter_offset=None,
                 birdview_mesh_generator: Optional[BirdviewRGBMeshGenerator] = None,
                 internal_time: int = 0,
                 traffic_controls: Optional[Dict[str, BaseTrafficControl]] = None,
                 waypoint_goals: Optional[WaypointGoal] = None,
                 agent_types=None, agent_type_names: Optional[List[str]] = None,
                 npc_controller: Optional[NPCController] = None,
                 agent_lr=None, lane_features=None, observation_noise_model=None,
                 action_model_extras: Optional[Dict[str, Any]] = None,
                 map_grids: Optional[MapGrids] = None):
        self.device = kinematic_model.get_state().device
        dev = self.device
        self.road_mesh = road_mesh
        self.lanelet_map = lanelet_map
        self.recenter_offset = None if recenter_offset is None else \
            torch.as_tensor(recenter_offset, dtype=torch.float32, device=dev)
        self.kinematic_model = kinematic_model
        self.agent_size = torch.as_tensor(agent_size, dtype=torch.float32, device=dev)
        self._batch_size = self.agent_size.shape[0]
        present = torch.as_tensor(initial_present_mask, dtype=torch.bool, device=dev)
        shape = present.shape
        self._agent_types = agent_type_names or ['vehicle']
        self.agent_type = (torch.zeros(shape, dtype=torch.int32, device=dev)
                           if agent_types is None else torch.as_tensor(
                               agent_types, dtype=torch.int32, device=dev).expand(shape))
        self.agent_lr = (torch.zeros(shape, dtype=torch.float32, device=dev)
                         if agent_lr is None else torch.as_tensor(
                             agent_lr, dtype=torch.float32, device=dev).expand(shape))
        self.action_model_extras = action_model_extras
        self.map_grids = map_grids
        self.lane_features = lane_features
        self.observation_noise_model = observation_noise_model or \
            ObservationNoise(ObservationNoiseConfig())
        self.cfg = cfg
        self.traffic_controls = traffic_controls
        self.waypoint_goals = waypoint_goals
        self.npc_controller = npc_controller or NPCController.empty(
            self._batch_size, self._agent_types, device=dev)
        if renderer is None:
            renderer_cfg = cfg.renderer
            if isinstance(renderer_cfg, dict):
                renderer_cfg = {**renderer_cfg,
                                'left_handed_coordinates': cfg.left_handed_coordinates}
            else:
                renderer_cfg.left_handed_coordinates = cfg.left_handed_coordinates
            renderer = renderer_from_config(renderer_cfg, device=dev)
        self.renderer = renderer
        if birdview_mesh_generator is None:
            birdview_mesh_generator = BirdviewRGBMeshGenerator(
                self.renderer.color_map, self.renderer.rendering_levels,
                render_agent_direction=self.renderer.cfg.render_agent_direction,
                background_mesh=road_mesh)
            birdview_mesh_generator.initialize_actors_mesh(
                self.get_all_agent_size(), self.get_all_agent_type(),
                self._agent_types)
            if traffic_controls is not None:
                birdview_mesh_generator.initialize_traffic_controls_mesh(
                    traffic_controls)
        self.birdview_mesh_generator = birdview_mesh_generator
        self._warned_host_wrong_way = False
        self.check_prim_budget()

        as_time = lambda t: torch.tensor(t, dtype=torch.int32, device=dev)
        self.state = SimulatorState(
            agent_state=kinematic_model.get_state(), present_mask=present,
            npc_state=self.npc_controller.initial_npc_state,
            npc_present_mask=self.npc_controller.initial_npc_present_mask,
            traffic_control_state={k: v.state for k, v in
                                   (traffic_controls or {}).items()},
            waypoint_state=None if waypoint_goals is None else waypoint_goals._state,
            time=as_time(internal_time), npc_time=as_time(0))
        self.validate_tensor_shapes()

    # --- properties ---------------------------------------------------------

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @property
    def agent_count(self) -> int:
        return self.agent_size.shape[-2]

    @property
    def npc_count(self) -> int:
        return self.npc_controller.npc_size.shape[-2]

    @property
    def agent_types(self) -> List[str]:
        return self._agent_types

    @property
    def action_size(self) -> int:
        """Width of the actions :meth:`step` takes."""
        return self.kinematic_model.action_size

    @property
    def internal_time(self) -> int:
        """The step counter, read from the device (a host sync: the step,
        render and grid-metric paths never read it)."""
        return int(self.state.time)

    @property
    def present_mask(self) -> torch.Tensor:
        return self.state.present_mask

    def validate_agent_types(self) -> None:
        """Kept for the reference's API, which checks nothing here either."""
        return

    def validate_tensor_shapes(self) -> None:
        b, a = self.batch_size, self.agent_count
        assert_equal(tuple(self.state.agent_state.shape[:2]), (b, a))
        assert_equal(tuple(self.agent_size.shape), (b, a, 2))
        assert_equal(tuple(self.agent_type.shape), (b, a))
        assert_equal(tuple(self.agent_lr.shape), (b, a))
        assert_equal(tuple(self.state.present_mask.shape), (b, a))
        if self.road_mesh is not None and self.road_mesh.batch_size != 1:
            assert_equal(self.road_mesh.batch_size, b)

    # --- the pure step ------------------------------------------------------

    def functional_step(self, state: SimulatorState, agent_action: torch.Tensor
                        ) -> SimulatorState:
        """
        One pure simulation step: NPC advance, kinematic step,
        traffic-control advance, waypoint advance (the span ``dynamics``).
        """
        with tracing.span('dynamics'):
            time = state.time + 1
            npc_time = state.npc_time + 1
            npc_state, npc_mask = self.npc_controller.advance(
                state.npc_state, state.npc_present_mask, npc_time, self)
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
            if self.waypoint_goals is not None and wp_state is not None:
                wp_state = step_waypoints(self.waypoint_goals.waypoints, wp_state,
                                          agent_state,
                                          threshold=self.cfg.waypoint_removal_threshold)
            return SimulatorState(
                agent_state=agent_state, present_mask=state.present_mask,
                npc_state=npc_state, npc_present_mask=npc_mask,
                traffic_control_state=tc_state, waypoint_state=wp_state,
                time=time, npc_time=npc_time)

    # --- the mutating facade ------------------------------------------------

    def step(self, agent_action: torch.Tensor) -> None:
        """Advance :attr:`state` one step under BxAxaction_size actions."""
        agent_action = torch.as_tensor(agent_action, device=self.device)
        assert_equal(agent_action.dim(), 3)
        assert_equal(agent_action.shape[0], self.batch_size)
        assert_equal(agent_action.shape[-2], self.agent_count)
        self.state = self.functional_step(self.state, agent_action)
        self._sync_legacy_state()

    def _sync_legacy_state(self) -> None:
        """Keep the objects' own state attributes equal to :attr:`state`."""
        self.kinematic_model.set_state(self.state.agent_state)
        for kind, control in (self.traffic_controls or {}).items():
            control.state = self.state.traffic_control_state[kind]
        if self.waypoint_goals is not None and self.state.waypoint_state is not None:
            self.waypoint_goals._state = self.state.waypoint_state

    def set_state(self, agent_state: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> None:
        """Overwrite the agent states (their leading channels when
        ``agent_state`` is narrower than 4) where ``mask`` (BxA) holds."""
        agent_state = torch.as_tensor(agent_state, dtype=torch.float32,
                                      device=self.device)
        assert_equal(agent_state.dim(), 3)
        assert_equal(agent_state.shape[0], self.batch_size)
        assert_equal(agent_state.shape[-2], self.agent_count)
        current = self.state.agent_state
        if agent_state.shape[-1] < current.shape[-1]:
            agent_state = torch.cat([agent_state, current[..., agent_state.shape[-1]:]],
                                    dim=-1)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
            agent_state = torch.where(mask[..., None], agent_state, current)
        self.state = dataclasses.replace(self.state, agent_state=agent_state)
        self.kinematic_model.set_state(agent_state)

    def update_present_mask(self, present_mask: torch.Tensor) -> None:
        present_mask = torch.as_tensor(present_mask, dtype=torch.bool,
                                       device=self.device)
        assert_equal(tuple(present_mask.shape), tuple(self.state.present_mask.shape))
        self.state = dataclasses.replace(self.state, present_mask=present_mask)

    def fit_action(self, future_state: torch.Tensor,
                   current_state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The kinematic model's inverse dynamics from ``current_state``
        (the current agent states by default) to ``future_state``."""
        return self.kinematic_model.fit_action(
            future_state, self.state.agent_state if current_state is None
            else current_state)

    # --- copies and batch operations ---------------------------------------

    def to(self, device=None) -> "Simulator":
        """This simulator, for any ``device``: its state stays where it is
        (placing the state is ``parallel.shard_simulator``'s work)."""
        return self

    def copy(self) -> "Simulator":
        """An independent copy: stepping, setting the state of or changing
        the batch of either leaves the other as it was. The tensors, which
        are never written in place, are shared, and so are the map grids
        and the lanelet maps."""
        other = copy.copy(self)
        other.kinematic_model = self.kinematic_model.copy()
        other.renderer = copy.copy(self.renderer)
        other.birdview_mesh_generator = self.birdview_mesh_generator.copy()
        if self.traffic_controls is not None:
            other.traffic_controls = {k: v.copy()
                                      for k, v in self.traffic_controls.items()}
        if self.waypoint_goals is not None:
            other.waypoint_goals = self.waypoint_goals.copy()
        other.npc_controller = self.npc_controller.copy()
        other._sync_legacy_state()
        return other

    def _map_batch(self, f, n_batch: int, mesh_f, lanelets_f) -> None:
        """Apply the batch map ``f`` to every batched tensor and object."""
        self.agent_size = f(self.agent_size)
        self.agent_type = f(self.agent_type)
        self.agent_lr = f(self.agent_lr)
        if self.recenter_offset is not None:
            self.recenter_offset = f(self.recenter_offset)
        if self.lane_features is not None:
            self.lane_features = self.lane_features._map(f)
        if self.road_mesh is not None and self.road_mesh.batch_size > 1:
            self.road_mesh = mesh_f(self.road_mesh)
        if self.lanelet_map is not None:
            self.lanelet_map = lanelets_f(self.lanelet_map)
        self._batch_size = n_batch
        st = self.state
        wp = st.waypoint_state
        self.state = SimulatorState(
            agent_state=f(st.agent_state), present_mask=f(st.present_mask),
            npc_state=f(st.npc_state), npc_present_mask=f(st.npc_present_mask),
            traffic_control_state={k: f(v) for k, v in
                                   st.traffic_control_state.items()},
            waypoint_state=None if wp is None else WaypointGoalState(
                state=f(wp.state), mask=f(wp.mask)),
            time=st.time, npc_time=st.npc_time)

    def extend(self, n: int, in_place: bool = True) -> "Simulator":
        """
        Multiply the batch dimension: every environment repeated ``n``
        times contiguously. A road mesh of batch 1 stays shared by every
        environment.

        Returns:
            this simulator, or with ``in_place=False`` an extended copy.
        """
        if not in_place:
            return self.copy().extend(n, in_place=True)
        self.kinematic_model.extend(n)
        if self.traffic_controls is not None:
            self.traffic_controls = {k: v.extend(n, in_place=False)
                                     for k, v in self.traffic_controls.items()}
        if self.waypoint_goals is not None:
            self.waypoint_goals = self.waypoint_goals.extend(n, in_place=False)
        self.npc_controller = self.npc_controller.extend(n, in_place=False)
        self.birdview_mesh_generator = self.birdview_mesh_generator.extend(n)
        self._map_batch(lambda x: host_repeat(x, n), self._batch_size * n,
                        lambda m: m.expand(n),
                        lambda maps: [m for m in maps for _ in range(n)])
        return self

    def select_batch_elements(self, idx, in_place: bool = True) -> "Simulator":
        """
        Keep the environments ``idx`` (an int, list, array or tensor of
        indices, repeats allowed).

        Returns:
            this simulator, or with ``in_place=False`` a copy.
        """
        if not in_place:
            return self.copy().select_batch_elements(idx, in_place=True)
        idx = as_batch_index(idx, self.device)
        host_idx = idx.cpu().numpy()
        self.kinematic_model.select_batch_elements(idx)
        if self.traffic_controls is not None:
            self.traffic_controls = {k: v.select_batch_elements(idx, in_place=False)
                                     for k, v in self.traffic_controls.items()}
        if self.waypoint_goals is not None:
            self.waypoint_goals = self.waypoint_goals.select_batch_elements(
                idx, in_place=False)
        self.npc_controller = self.npc_controller.select_batch_elements(
            idx, in_place=False)
        self.birdview_mesh_generator = \
            self.birdview_mesh_generator.select_batch_elements(idx)
        self._map_batch(lambda x: x[idx], len(host_idx),
                        lambda m: m.select_batch_elements(host_idx),
                        lambda maps: [maps[int(i)] for i in host_idx])
        return self

    def __getitem__(self, item) -> "Simulator":
        return self.select_batch_elements(item, in_place=False)

    # --- getters --------------------------------------------------------------

    def get_world_center(self) -> Optional[torch.Tensor]:
        """Bx2 midpoint of the bounding box of the road mesh's 'road'
        faces' vertices (of every vertex without that category), or None
        without a road mesh."""
        mesh = self.road_mesh
        if mesh is None:
            return None
        verts = np.asarray(mesh.verts)[..., :2]
        faces = np.asarray(mesh.faces).astype(np.int64)
        categories = list(getattr(mesh, 'categories', []))
        if 'road' in categories and mesh.vert_category is not None:
            keep = np.asarray(mesh.vert_category) == categories.index('road')
            parts = []
            for i in range(mesh.batch_size):
                used = np.unique(faces[i][keep[i][faces[i]].any(axis=-1)])
                parts.append(verts[i][used])
            n = max(len(p) for p in parts)
            # the reference pads the shorter batch elements with zeros
            parts = [np.concatenate([p, np.zeros((n - len(p), 2), p.dtype)])
                     for p in parts]
            verts = np.stack(parts)
        if verts.shape[-2] == 0:
            center = np.zeros((verts.shape[0], 2), np.float32)
        else:
            center = (verts.max(axis=-2) + verts.min(axis=-2)) / 2
        center = torch.as_tensor(center, dtype=torch.float32, device=self.device)
        # a batch-1 road mesh is every environment's
        return center.expand(self.batch_size, 2)

    def get_state(self) -> torch.Tensor:
        return self.state.agent_state

    def get_waypoints(self, count: int = 1) -> Optional[torch.Tensor]:
        """BxAx(count*M)x2 of the current and next ``count - 1`` waypoint
        collections, or None without waypoint goals."""
        if self.waypoint_goals is None:
            return None
        return gather_current(self.waypoint_goals.waypoints,
                              self.state.waypoint_state, count)[0]

    def get_waypoints_state(self) -> Optional[torch.Tensor]:
        wp = self.state.waypoint_state
        return None if wp is None else wp.state

    def get_waypoints_mask(self, count: int = 1) -> Optional[torch.Tensor]:
        if self.waypoint_goals is None:
            return None
        return gather_current(self.waypoint_goals.waypoints,
                              self.state.waypoint_state, count)[1]

    def get_agent_size(self) -> torch.Tensor:
        return self.agent_size

    def get_agent_type(self) -> torch.Tensor:
        return self.agent_type

    def get_agent_type_names(self) -> List[str]:
        return self._agent_types

    def get_agent_lr(self) -> torch.Tensor:
        return self.agent_lr

    def get_present_mask(self) -> torch.Tensor:
        return self.state.present_mask

    def get_npc_state(self) -> torch.Tensor:
        return self.state.npc_state

    def get_npc_size(self) -> torch.Tensor:
        return self.npc_controller.npc_size

    def get_npc_present_mask(self) -> torch.Tensor:
        return self.state.npc_present_mask

    def get_npc_types(self) -> torch.Tensor:
        return self.npc_controller.npc_types

    def get_all_agent_state(self) -> torch.Tensor:
        return torch.cat([self.get_state(), self.get_npc_state()], dim=-2)

    def get_all_agent_size(self) -> torch.Tensor:
        return torch.cat([self.agent_size, self.get_npc_size()], dim=-2)

    def get_all_agent_present_mask(self) -> torch.Tensor:
        return torch.cat([self.get_present_mask(), self.get_npc_present_mask()],
                         dim=-1)

    def get_all_agent_type(self) -> torch.Tensor:
        return torch.cat([self.agent_type, self.get_npc_types()], dim=-1)

    def get_all_agents_absolute(self) -> torch.Tensor:
        """Bx(A+Npc)x6: x, y, psi, length, width, present."""
        return torch.cat([self.get_all_agent_state()[..., :3],
                          self.get_all_agent_size(),
                          self.get_all_agent_present_mask()[..., None].to(
                              self.agent_size.dtype)], dim=-1)

    def get_all_agents_relative(self, exclude_self: bool = True) -> torch.Tensor:
        """BxAx(A+Npc)x6 (BxAx(A+Npc-1)x6 with ``exclude_self``): every
        agent and NPC in each agent's frame (x, y, psi), with its length,
        width and presence."""
        return _relative_views(self.get_all_agents_absolute(), self.agent_count,
                               exclude_self)

    def get_traffic_controls(self) -> Optional[Dict[str, BaseTrafficControl]]:
        return self.traffic_controls

    def get_traffic_light_state(self) -> Optional[torch.Tensor]:
        return self.state.traffic_control_state.get('traffic_light')

    def get_action_model_extras(self) -> Dict[str, Any]:
        """The extras given at construction; per-agent target speeds
        (``target_speeds``, ``target_speeds_mask``: BxAxTx...) as each
        agent's first, (B*A)x..., under ``target_speed`` and
        ``target_speed_mask``."""
        if self.action_model_extras is None:
            return {}
        renamed = {'target_speeds': 'target_speed',
                   'target_speeds_mask': 'target_speed_mask'}
        out = {}
        for k, v in self.action_model_extras.items():
            if k in renamed and v is not None:
                out[renamed[k]] = v.reshape(-1, *v.shape[2:])[:, 0]
            else:
                out[k] = v
        return out

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

    # --- noisy observations ---------------------------------------------------

    def get_noisy_state(self) -> torch.Tensor:
        """BxAx(A+Npc)x4: each agent's view of every state."""
        return self.observation_noise_model.get_noisy_state(self)

    def get_noisy_agent_size(self) -> torch.Tensor:
        """BxAx(A+Npc)x2."""
        return self.observation_noise_model.get_noisy_agent_size(self)

    def get_noisy_present_mask(self) -> torch.Tensor:
        """BxAx(A+Npc) bool."""
        return self.observation_noise_model.get_noisy_present_mask(self)

    def get_noisy_all_agents_absolute(self) -> torch.Tensor:
        """BxAx(A+Npc)x6: x, y, psi, length, width, present as each agent
        observes them."""
        return torch.cat([self.get_noisy_state()[..., :3], self.get_noisy_agent_size(),
                          self.get_noisy_present_mask()[..., None].to(
                              self.agent_size.dtype)], dim=-1)

    def get_noisy_all_agents_relative(self, exclude_self: bool = True) -> torch.Tensor:
        """:meth:`get_noisy_all_agents_absolute` in each agent's frame, from
        its own observed pose (BxAx(A+Npc-1)x6 with ``exclude_self``)."""
        abs_pos = self.get_noisy_all_agents_absolute()
        a = self.agent_count
        idx = torch.arange(a, device=self.device)
        own = abs_pos[:, idx, idx, :]
        rel_xy, rel_psi = relative(origin_xy=own[:, :, None, :2],
                                   origin_psi=own[:, :, None, 2:3],
                                   target_xy=abs_pos[..., :2],
                                   target_psi=abs_pos[..., 2:3])
        rel = torch.cat([rel_xy, rel_psi, abs_pos[..., 3:]], dim=-1)
        return _drop_self(rel, a) if exclude_self else rel

    def get_noisy_lane_features(self) -> Optional[LaneFeatures]:
        return self.observation_noise_model.get_noisy_lane_features(self)

    def get_noisy_road_mesh(self):
        return self.observation_noise_model.get_noisy_road_mesh(self)

    def get_noisy_background_mesh(self):
        return self.observation_noise_model.get_noisy_background_mesh(self)

    def get_noisy_traffic_controls(self) -> Optional[Dict[str, BaseTrafficControl]]:
        return self.observation_noise_model.get_noisy_traffic_controls(self)

    # --- rendering --------------------------------------------------------------

    def check_prim_budget(self, waypoint_count: Optional[int] = None,
                          strict: bool = False) -> None:
        """
        Warn (or with ``strict`` raise ``ValueError``) when the scene's
        worst case, every agent, light and waypoint visible in one camera,
        exceeds the primitive render's per-type cap ``min(max(8,
        band_budget), 56)``: past it the fused render keeps each type's
        prims nearest the view center and drops the rest.

        Args:
            waypoint_count: waypoints rendered per camera; one per agent by
                default when waypoint goals are set.
        """
        budget = getattr(self.renderer.cfg, 'band_budget', None)
        if budget is None:
            return
        cap = min(max(8, int(budget)), 56)
        if waypoint_count is None:
            waypoint_count = self.agent_count if self.waypoint_goals is not None else 0
        quads, tris = self.birdview_mesh_generator.worst_case_prim_counts(
            waypoint_count)
        if quads <= cap and tris <= cap:
            return
        msg = (f"scene content can exceed the renderer's per-camera prim budget: "
               f"worst case {quads} quads / {tris} triangles vs band_budget cap "
               f"{cap} (per type). Frames where more than {cap} prims of one type "
               f"are visible in a single camera will drop the farthest ones. "
               f"Reduce agents/lights/waypoints per scene or raise "
               f"RendererConfig.band_budget (hard max 56).")
        if strict:
            raise ValueError(msg)
        logger.warning(msg)

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
        renderer that has the primitive render, a background texture and
        neither custom colors nor noisy perception, the typed primitives by
        the primitive render; else the frame's mesh (the map mesh and its
        static meshes without a texture, the actors, the signs, the lights
        and the waypoints) by the renderer's ``render_frame`` (for the
        port's renderer the mesh render, hard by default, over the texture
        or the background color; black frames for a ``DummyRenderer``).

        Args:
            camera_xy: (B, Nc, 2) or (B, 2) centers; camera_psi: (B, Nc, 1)
                or (B, 1) headings.
            rendering_mask: (B, Nc, All) which agents each camera shows.
            waypoints: (B, Nc, M, 2) discs to draw;
                waypoints_rendering_mask: (B, Nc, M).
            custom_agent_colors: (B, Nc, All, 3) box colors in [0, 1].
            noisy_perception: draw the map, lane-feature markers and
                controls that the observation noise model observes.
        Returns:
            (B, Nc, 3, H, W) float images in [0, 255].
        """
        res_used = res or self.renderer.res
        if hasattr(self.renderer, 'render_prims_chw') and \
                self.renderer.background_texture is not None and \
                custom_agent_colors is None and not noisy_perception:
            prims, cameras = self.prim_frame(camera_xy, camera_psi, rendering_mask,
                                             fov, waypoints, waypoints_rendering_mask)
            image = self.renderer.render_prims_chw(*prims, res_used, cameras)
        else:
            mesh, cameras = self.mesh_frame(
                camera_xy, camera_psi, rendering_mask, fov, waypoints,
                waypoints_rendering_mask, custom_agent_colors=custom_agent_colors,
                noisy_perception=noisy_perception)
            image = self.renderer.render_frame(mesh, cameras.xy, cameras.sc, res=res_used,
                                               fov=fov)
        return image.reshape(self.batch_size, -1, 3, res_used.height, res_used.width)

    def _camera_masks(self, camera_xy: torch.Tensor, camera_psi: torch.Tensor,
                      rendering_mask: Optional[torch.Tensor]):
        """(B, Nc, 2) centers, (B, Nc, 2) (sin, cos) headings and (B, Nc,
        All) agents shown (present and in ``rendering_mask``)."""
        camera_sc = torch.cat([torch.sin(camera_psi), torch.cos(camera_psi)], dim=-1)
        if camera_xy.dim() == 2:
            camera_xy, camera_sc = camera_xy[:, None], camera_sc[:, None]
        b, n_cameras = camera_xy.shape[0], camera_xy.shape[1]
        present = self.get_all_agent_present_mask()
        present = present[:, None].expand(b, n_cameras, present.shape[-1])
        shown = present if rendering_mask is None else present & rendering_mask
        return camera_xy, camera_sc, shown

    def mesh_frame(self, camera_xy: torch.Tensor, camera_psi: torch.Tensor,
                   rendering_mask: Optional[torch.Tensor] = None,
                   fov: Optional[float] = None,
                   waypoints: Optional[torch.Tensor] = None,
                   waypoints_rendering_mask: Optional[torch.Tensor] = None,
                   custom_agent_colors: Optional[torch.Tensor] = None,
                   noisy_perception: bool = False):
        """
        The per-camera mesh of :meth:`render`'s mesh frame (the map mesh and
        its static meshes unless a texture is set, the actors, the signs,
        the lights and the waypoints; B * Nc cameras, camera fastest) and its
        cameras: ``(RGBMesh, Cameras)``, as the renderer's
        ``render_rgb_mesh_chw`` takes them.
        """
        camera_xy, camera_sc, shown = self._camera_masks(camera_xy, camera_psi,
                                                         rendering_mask)
        b, n_cameras, n_all = shown.shape
        generator = self._noisy_mesh_generator() if noisy_perception \
            else self.birdview_mesh_generator
        mesh = generator.generate(
            n_cameras, agent_state=self.get_all_agent_state()[:, None].expand(
                b, n_cameras, n_all, 4),
            present_mask=shown, traffic_light_state=self.get_traffic_light_state(),
            waypoints=waypoints, waypoints_rendering_mask=waypoints_rendering_mask,
            custom_agent_colors=custom_agent_colors,
            include_background=self.renderer.background_texture is None)
        scale = (2.0 / fov) if fov is not None else self.renderer.scale
        return mesh, Cameras(camera_xy.reshape(-1, 2), camera_sc.reshape(-1, 2), scale)

    def egocentric_mesh_frame(self, fov: Optional[float] = None,
                              n_subsequent_waypoints: int = 1,
                              ego_rotate: bool = True,
                              visibility_matrix: Optional[torch.Tensor] = None,
                              custom_agent_colors: Optional[torch.Tensor] = None,
                              noisy_perception: bool = False):
        """:meth:`mesh_frame` of :meth:`render_egocentric`'s cameras."""
        xy, psi, mask = self._egocentric_cameras(ego_rotate, visibility_matrix)
        return self.mesh_frame(xy, psi, mask, fov,
                               **self._egocentric_waypoints(n_subsequent_waypoints),
                               custom_agent_colors=custom_agent_colors,
                               noisy_perception=noisy_perception)

    def _noisy_mesh_generator(self) -> BirdviewRGBMeshGenerator:
        """A copy of the scene generator with the observed map: the noisy
        background mesh, the noisy dense lane features as triangle markers
        of the 'stop_sign' category added to it, and the noisy controls."""
        generator = self.birdview_mesh_generator.copy()
        background = self.get_noisy_background_mesh()
        if isinstance(background, BirdviewMesh):
            generator.initialize_background_mesh(background)
        lanes = self.get_noisy_lane_features()
        if lanes is not None and lanes.dense_lane_features is not None:
            generator.add_static_meshes([lane_feature_markers(lanes)])
        controls = self.get_noisy_traffic_controls()
        if controls is not None:
            generator.initialize_traffic_controls_mesh(controls)
        return generator

    def prim_frame(self, camera_xy: torch.Tensor, camera_psi: torch.Tensor,
                   rendering_mask: Optional[torch.Tensor] = None,
                   fov: Optional[float] = None,
                   waypoints: Optional[torch.Tensor] = None,
                   waypoints_rendering_mask: Optional[torch.Tensor] = None):
        """
        The typed primitives of :meth:`render`'s textured frame, one batch
        element per camera (B * Nc, camera fastest), and its cameras:
        ``((quads, qz, qcolors, tris, tz, tcolors), Cameras)``, as the
        renderer's ``render_prims_chw`` takes them.
        """
        camera_xy, camera_sc, shown = self._camera_masks(camera_xy, camera_psi,
                                                         rendering_mask)
        b, n_cameras = camera_xy.shape[0], camera_xy.shape[1]
        flat = lambda x: None if x is None else x.reshape(
            (b * n_cameras,) + tuple(x.shape[2:]))
        rep = lambda x: None if x is None else torch.repeat_interleave(
            x, n_cameras, dim=0)
        prims = self.birdview_mesh_generator.generate_prims(
            rep(self.get_all_agent_state()), present_mask=flat(shown),
            traffic_light_state=rep(self.get_traffic_light_state()),
            waypoints=flat(waypoints),
            waypoints_rendering_mask=flat(waypoints_rendering_mask))
        scale = (2.0 / fov) if fov is not None else self.renderer.scale
        return prims, Cameras(camera_xy.reshape(-1, 2), camera_sc.reshape(-1, 2),
                              scale)

    def render_egocentric(self, ego_rotate: bool = True,
                          res: Optional[Resolution] = None,
                          fov: Optional[float] = None,
                          visibility_matrix: Optional[torch.Tensor] = None,
                          custom_agent_colors: Optional[torch.Tensor] = None,
                          n_subsequent_waypoints: int = 1,
                          noisy_perception: bool = False) -> torch.Tensor:
        """
        One camera per agent, centered on it (heading up with
        ``ego_rotate``), showing its own next ``n_subsequent_waypoints``
        waypoint collections; with ``cfg.single_agent_rendering`` each
        camera shows its own agent and the NPCs only.

        Returns:
            BxAx3xHxW float images in [0, 255].
        """
        xy, psi, mask = self._egocentric_cameras(ego_rotate, visibility_matrix)
        return self.render(xy, psi, res=res, rendering_mask=mask, fov=fov,
                           **self._egocentric_waypoints(n_subsequent_waypoints),
                           custom_agent_colors=custom_agent_colors,
                           noisy_perception=noisy_perception)

    def egocentric_prim_frame(self, fov: Optional[float] = None,
                              n_subsequent_waypoints: int = 1,
                              ego_rotate: bool = True,
                              visibility_matrix: Optional[torch.Tensor] = None):
        """:meth:`prim_frame` of :meth:`render_egocentric`'s cameras:
        (primitives of the B * A cameras, Cameras)."""
        xy, psi, mask = self._egocentric_cameras(ego_rotate, visibility_matrix)
        return self.prim_frame(xy, psi, mask, fov,
                               **self._egocentric_waypoints(n_subsequent_waypoints))

    def _egocentric_cameras(self, ego_rotate: bool,
                            visibility_matrix: Optional[torch.Tensor]):
        """(camera_xy, camera_psi, rendering_mask) of one camera per agent."""
        camera_xy = self.get_state()[..., :2]
        camera_psi = self.get_state()[..., 2:3]
        if not ego_rotate:
            camera_psi = torch.full_like(camera_psi, np.pi / 2)
        rendering_mask = visibility_matrix
        if self.cfg.single_agent_rendering:
            a = self.agent_count
            own = torch.cat([torch.eye(a, dtype=torch.bool, device=self.device),
                             torch.ones((a, self.npc_count), dtype=torch.bool,
                                        device=self.device)], dim=-1)
            rendering_mask = own[None].expand(self.batch_size, a, a + self.npc_count)
        return camera_xy, camera_psi, rendering_mask

    def _egocentric_waypoints(self, count: int) -> Dict[str, Optional[torch.Tensor]]:
        """Each agent's camera's own next ``count`` waypoint collections."""
        waypoints = self.get_waypoints(count=count)
        return dict(waypoints=waypoints, waypoints_rendering_mask=None
                    if waypoints is None else self.get_waypoints_mask(count=count))

    # --- infractions --------------------------------------------------------------

    def compute_offroad(self) -> torch.Tensor:
        """BxA offroad losses: from the baked distance grid when there is
        one, else by the exact distance to the road mesh."""
        if self.map_grids is not None:
            loss = offroad_loss_from_grid(self.map_grids, self.get_state(),
                                          self.agent_size,
                                          threshold=self.cfg.offroad_threshold)
        else:
            loss = offroad_infraction_loss(self.get_state(), self.agent_size,
                                           self.road_mesh,
                                           threshold=self.cfg.offroad_threshold)
        return loss * self.get_present_mask()

    def compute_wrong_way(self) -> torch.Tensor:
        """BxA wrong-way losses: from the baked direction grid when there is
        one, else by lanelet queries on the host (it reads the states back),
        else zeros."""
        state = self.get_state()
        if self.map_grids is not None and self.map_grids.direction is not None:
            if self.recenter_offset is not None:
                state = torch.cat([state[..., :2] + self.recenter_offset[:, None],
                                   state[..., 2:]], dim=-1)
            return wrong_way_loss_from_grid(
                self.map_grids, state,
                angle_threshold=self.cfg.wrong_way_angle_threshold
            ) * self.get_present_mask()
        if self.lanelet_map is not None:
            b, a = state.shape[:2]
            if b * a > 64 and not self._warned_host_wrong_way:
                logger.warning(
                    "compute_wrong_way is using the host lanelet path, which is "
                    "O(batch x agents) Python (%d x %d here), far slower than the "
                    "baked grid path; give the simulator map_grids with a "
                    "direction field for lookups on the device.", b, a)
                self._warned_host_wrong_way = True
            return lanelet_orientation_loss(
                self.lanelet_map, state, self.recenter_offset,
                direction_angle_threshold=self.cfg.wrong_way_angle_threshold,
                lanelet_dist_tolerance=self.cfg.lanelet_inclusion_tolerance,
            ) * self.get_present_mask()
        return torch.zeros(state.shape[:2], device=self.device)

    def compute_traffic_lights_violations(self) -> torch.Tensor:
        """BxA bool: agents whose rear crosses a red stopline."""
        state = self.get_state()
        control = (self.traffic_controls or {}).get('traffic_light')
        if control is None:
            return torch.zeros(state.shape[:2], dtype=torch.bool, device=self.device)
        boxes = torch.cat([state[..., :2], self.agent_size, state[..., 2:3]], dim=-1)
        v = red_light_violations(
            boxes, control.corners, self.state.traffic_control_state['traffic_light'],
            red_index=control.allowed_states.index('red'))
        return v & self.get_present_mask()

    def compute_collision(self, agent_types: Optional[List[str]] = None
                          ) -> torch.Tensor:
        """
        BxA collision values by ``cfg.collision_metric``: against agents and
        NPCs (of ``agent_types`` only, when given) by discs or IoU, or the
        exact counts against the other agents (no ``agent_types``).
        """
        metric = self.cfg.collision_metric
        states = self.get_state()
        if metric in (CollisionMetric.nograd, CollisionMetric.nograd_pytorch3d):
            assert agent_types is None, \
                'agent_types unsupported by the selected collision metric'
            boxes = torch.cat([states[..., :2], self.agent_size, states[..., 2:3]],
                              dim=-1)
            present = self.get_present_mask()
            if metric == CollisionMetric.nograd:
                return compute_agent_collisions_metric(boxes, present, present)
            return compute_agent_collisions_metric_pytorch3d(boxes, present)
        all_states = self.get_all_agent_state()
        mask = self.get_all_agent_present_mask()
        if agent_types is not None:
            allowed = torch.as_tensor(
                [self._agent_types.index(t) for t in agent_types
                 if t in self._agent_types], dtype=torch.int32, device=self.device)
            mask = mask & torch.isin(self.get_all_agent_type(), allowed)
        all_boxes = torch.cat([all_states[..., :2], self.get_all_agent_size(),
                               all_states[..., 2:3]], dim=-1)
        collisions = compute_collision_matrix(all_boxes, mask, metric=metric.value)
        return collisions[..., :self.agent_count]


def _relative_views(abs_pos: torch.Tensor, agent_count: int,
                    exclude_self: bool) -> torch.Tensor:
    """BxAxTx6 views of the Bx(T)x6 absolute entries from each of the
    first ``agent_count``: positions and headings relative, the rest as
    they are."""
    xy = abs_pos[..., :agent_count, :2]
    psi = abs_pos[..., :agent_count, 2:3]
    rel_xy, rel_psi = relative(origin_xy=xy[..., :, None, :],
                               origin_psi=psi[..., :, None, :],
                               target_xy=abs_pos[..., None, :, :2],
                               target_psi=abs_pos[..., None, :, 2:3])
    rel_state = torch.cat([rel_xy, rel_psi], dim=-1)
    info = abs_pos[..., None, :, 3:].expand(
        rel_state.shape[:-1] + (abs_pos.shape[-1] - 3,))
    rel = torch.cat([rel_state, info], dim=-1)
    return _drop_self(rel, agent_count) if exclude_self else rel


def lane_feature_markers(lanes: LaneFeatures) -> BirdviewMesh:
    """The dense lane features (B, M, D >= 4: x, y, psi, width, ...) as a
    'stop_sign'-category mesh of one triangle each, on their device: base
    of the feature's width across its position, apex 1 m ahead along psi;
    absent features collapse to the origin."""
    markers = lanes.dense_lane_features
    width = markers[..., 3]
    zero, one = torch.zeros_like(width), torch.ones_like(width)
    tri = torch.stack([torch.stack([zero, -width / 2], dim=-1),
                       torch.stack([zero, width / 2], dim=-1),
                       torch.stack([one, zero], dim=-1)], dim=-2)      # B, M, 3, 2
    verts = rotate(tri, markers[..., None, 2:3]) + markers[..., None, :2]
    verts = torch.where(lanes.dense_lane_features_mask[..., None, None], verts,
                        torch.zeros((), dtype=verts.dtype, device=verts.device))
    b, m = markers.shape[0], markers.shape[1]
    faces = (3 * torch.arange(m, dtype=torch.int32, device=markers.device)[:, None]
             + torch.arange(3, dtype=torch.int32, device=markers.device))
    return BirdviewMesh.set_properties(
        BaseMesh(verts=verts.reshape(b, m * 3, 2), faces=faces.expand(b, m, 3)),
        category='stop_sign')


def _drop_self(rel: torch.Tensor, agent_count: int) -> torch.Tensor:
    """(..., A, T, D) -> (..., A, T - 1, D): each agent's own entry removed,
    by one gather: row i keeps the columns j of ``~eye(A, T)``, whose k-th
    is ``k + (k >= i)``."""
    total = rel.shape[-2]
    k = torch.arange(total - 1, device=rel.device)
    i = torch.arange(agent_count, device=rel.device)[:, None]
    idx = (k + (k >= i).to(k.dtype))[..., None]
    return torch.gather(rel, -2, idx.expand(rel.shape[:-3] + (
        agent_count, total - 1, rel.shape[-1])))
