"""
Per-ego noisy observations of the world (counterpart of
``torchdrivesim_tpu/observation_noise.py``).

:class:`ObservationNoise` gives each ego the exact world seen from its
viewpoint (B x A x (A + Npc) x ...); :class:`StandardSensingObservationNoise`
adds Gaussian position noise in distance tiers and hides entities whose
sight line from the ego passes through another entity's circle;
:class:`MapObservationNoiseFromLog` replays logged noisy lane features,
background meshes and traffic controls by simulation step.

Randomness comes from an explicit ``torch.Generator`` on the simulator's
device (seeded, one draw per call), never from the global generator.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from torchdrivesim_tpu_torch.mesh import tensor_color
from torchdrivesim_tpu_torch.utils import line_circle_intersection_xy


@dataclass
class ObservationNoiseConfig:
    _type_: str = 'base'


@dataclass
class StandardSensingObservationNoiseConfig:
    _type_: str = 'standard_sensing'


@dataclass
class MapObservationNoiseFromLogConfig:
    _type_: str = 'map_observation_noise_from_log'


class ObservationNoise:
    """Each ego sees the exact states, sizes and presence of every agent
    and NPC, and the simulator's own lane features, meshes and controls."""
    def __init__(self, cfg: ObservationNoiseConfig):
        self.cfg = cfg

    def get_noisy_state(self, simulator) -> torch.Tensor:
        """B x A x (A + Npc) x 4."""
        b, a = simulator.batch_size, simulator.agent_count
        return torch.cat([
            simulator.get_state()[:, None].expand(b, a, a, 4),
            simulator.get_npc_state()[:, None].expand(b, a, simulator.npc_count, 4),
        ], dim=-2)

    def get_noisy_present_mask(self, simulator) -> torch.Tensor:
        """B x A x (A + Npc) bool."""
        b, a = simulator.batch_size, simulator.agent_count
        return torch.cat([
            simulator.get_present_mask()[:, None].expand(b, a, a),
            simulator.get_npc_present_mask()[:, None].expand(b, a, simulator.npc_count),
        ], dim=-1)

    def get_noisy_agent_size(self, simulator) -> torch.Tensor:
        """B x A x (A + Npc) x 2."""
        b, a = simulator.batch_size, simulator.agent_count
        return torch.cat([
            simulator.get_agent_size()[:, None].expand(b, a, a, 2),
            simulator.get_npc_size()[:, None].expand(b, a, simulator.npc_count, 2),
        ], dim=-2)

    def get_noisy_lane_features(self, simulator):
        return simulator.lane_features

    def get_noisy_background_mesh(self, simulator):
        return simulator.birdview_mesh_generator.background_mesh

    def get_noisy_traffic_controls(self, simulator):
        return simulator.traffic_controls

    def get_noisy_road_mesh(self, simulator):
        return simulator.road_mesh


class StandardSensingObservationNoise(ObservationNoise):
    """
    Gaussian position noise whose deviation grows with the distance from
    the ego (0.19 beyond 0.5 m, 1.6 beyond 25 m, 3.2 beyond 50 m, 3.83
    beyond 100 m, on every state channel), and an occlusion cull: an entity
    is hidden where the segment from the ego to it meets the circle (of the
    width as diameter) of another entity that is not the ego.

    Args:
        generator: the ``torch.Generator`` of the noise; by default one on
            ``device`` seeded with ``seed``. It must be on the simulator's
            device.
    """
    def __init__(self, cfg: StandardSensingObservationNoiseConfig,
                 generator: Optional[torch.Generator] = None, *, seed: int = 0,
                 device='cuda'):
        super().__init__(cfg)
        if generator is None:
            generator = torch.Generator(device=torch.device(device))
            generator.manual_seed(seed)
        self.generator = generator

    def normal(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """One standard normal draw of ``shape`` from :attr:`generator`."""
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=self.generator.device)

    def deviation(self, simulator) -> torch.Tensor:
        """B x A x (A + Npc) x 1 noise deviation of each entity in each
        ego's view, by its distance from the ego."""
        exposed = simulator.get_state()
        all_states = super().get_noisy_state(simulator)
        dist = torch.linalg.vector_norm(
            exposed[..., None, :2] - all_states[..., :2], dim=-1)
        return torch.stack([0.19 * (dist > 0.5), 1.6 * (dist > 25),
                            3.2 * (dist > 50), 3.83 * (dist > 100)],
                           dim=-1).amax(dim=-1, keepdim=True)

    def get_noisy_state(self, simulator) -> torch.Tensor:
        all_states = super().get_noisy_state(simulator)
        noise = self.normal(all_states.shape, all_states.dtype)
        return all_states + noise * self.deviation(simulator)

    def get_noisy_present_mask(self, simulator) -> torch.Tensor:
        base_mask = super().get_noisy_present_mask(simulator)
        states = super().get_noisy_state(simulator)          # B, A, E, 4
        sizes = super().get_noisy_agent_size(simulator)      # B, A, E, 2
        a, e = base_mask.shape[1], base_mask.shape[2]
        idx = torch.arange(a, device=states.device)
        ego = states[:, idx, idx, :2]                        # B, A, 2
        occluding = line_circle_intersection_xy(
            ego[..., 0][:, :, None, None], ego[..., 1][:, :, None, None],
            states[..., 0][:, :, :, None], states[..., 1][:, :, :, None],
            states[..., 0][:, :, None, :], states[..., 1][:, :, None, :],
            sizes[..., 1][:, :, None, :] / 2)                # B, A, E (target), E
        # an entity does not occlude itself, and the ego occludes nothing in
        # its own view (the sight line starts inside its circle)
        ents = torch.arange(e, device=states.device)
        own = ents[:, None] == ents[None, :]                 # target == occluder
        ego_occluder = (ents[None, :] == idx[:, None])[:, None, :]   # A, 1, E
        occluding = occluding & ~own & ~ego_occluder
        return base_mask & ~occluding.any(dim=-1)


class MapObservationNoiseFromLog(ObservationNoise):
    """
    Logged noisy map observations replayed by simulation step: at step t
    the t-th entry of each log (the simulator's own beyond the log's end or
    without a log).

    Args:
        noisy_lane_features: per step, :class:`LaneFeatures`.
        noisy_background_mesh: per step, a ``BirdviewMesh`` (its missing
            category colors and priorities filled from the scene generator).
        noisy_traffic_controls: per step, a controls dict.
        noisy_crosswalk_features: per step, crosswalk features.
    """
    def __init__(self, cfg: MapObservationNoiseFromLogConfig,
                 noisy_lane_features: Optional[List] = None,
                 noisy_background_mesh: Optional[List] = None,
                 noisy_traffic_controls: Optional[List[Dict]] = None,
                 noisy_crosswalk_features: Optional[List[Tuple]] = None):
        super().__init__(cfg)
        self.noisy_lane_features = noisy_lane_features
        self.noisy_background_mesh = noisy_background_mesh
        self.noisy_traffic_controls = noisy_traffic_controls
        self.noisy_crosswalk_features = noisy_crosswalk_features

    @staticmethod
    def _pick(log, simulator, default):
        """The log's entry at the simulator's step (a host read of the
        step counter), else ``default``."""
        if log is None:
            return default
        t = simulator.internal_time
        return log[t] if t < len(log) else default

    def get_noisy_lane_features(self, simulator):
        return self._pick(self.noisy_lane_features, simulator, simulator.lane_features)

    def get_noisy_background_mesh(self, simulator):
        mesh = self._pick(self.noisy_background_mesh, simulator, None)
        gen = simulator.birdview_mesh_generator
        if mesh is None:
            return gen.background_mesh
        if not hasattr(mesh, 'categories'):
            return mesh
        colors, zs = dict(mesh.colors), dict(mesh.zs)
        for k in mesh.categories:
            colors.setdefault(k, tensor_color(gen.color_map[k]))
            zs.setdefault(k, gen.rendering_levels[k])
        return dataclasses.replace(mesh, colors=colors, zs=zs)

    def get_noisy_road_mesh(self, simulator):
        return self._pick(self.noisy_background_mesh, simulator, simulator.road_mesh)

    def get_noisy_traffic_controls(self, simulator):
        return self._pick(self.noisy_traffic_controls, simulator,
                          simulator.traffic_controls)

    def get_noisy_crosswalk_features(self, simulator):
        return self._pick(self.noisy_crosswalk_features, simulator, None)


def observation_noise_from_config(cfg, device='cuda') -> ObservationNoise:
    """The model named by the config's ``_type_`` (a standard-sensing
    model's generator on ``device``, seeded with 0)."""
    kind = getattr(cfg, '_type_', 'base')
    if kind == 'standard_sensing':
        return StandardSensingObservationNoise(cfg, device=device)
    if kind == 'map_observation_noise_from_log':
        return MapObservationNoiseFromLog(cfg)
    return ObservationNoise(cfg)
