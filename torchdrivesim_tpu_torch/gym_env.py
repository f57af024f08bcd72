"""
The driving environments (counterpart of ``examples/gym_env.py``): the
single-ego :class:`GymEnv` over the stateful simulator, its variant
:class:`IAIGymEnv` whose other vehicles the Inverted AI API drives,
:class:`SingleAgentWrapper`, the example's :func:`main`, and the
vectorized environment of the RL example, :class:`VectorizedGymEnv`.

The single environments have the Gymnasium-like API (``reset``, ``step``,
``render``, ``close``) without depending on the gym package: the
observation is the ego's egocentric view (3, res, res) in [0, 255] as a
host numpy array, the info the ego's offroad, collision, wrong-way and
speed.

In :class:`VectorizedGymEnv`, B environments live in one batched
simulator, each a copy of the same scenario: a few no-reversing bicycle
cars placed on a CARLA town's lanes, the town's traffic lights, its baked
grids and, by default, its baked texture. Agent 0 of each environment is
the ego; the others hold a zero action. A step returns ``(state, obs, reward, done)``: the ego's
bird's-eye view rendered by the hard mesh render (the z-priority raster
over the nearest mip warp of the texture, or over the background color
with the whole map mesh when there is no texture), and the reference's
shaped reward.
"""
import argparse
import contextlib
import random
import signal
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import torchdrivesim_tpu_torch.kinematic as K
from torchdrivesim_tpu_torch.behavior.heuristic import heuristic_initialize
from torchdrivesim_tpu_torch.benchmark import load_or_bake_texture
from torchdrivesim_tpu_torch.infractions import compute_collision_matrix
from torchdrivesim_tpu_torch.map import find_map_config, traffic_controls_from_map_config
from torchdrivesim_tpu_torch.map_grids import (
    offroad_loss_from_grid, wrong_way_loss_from_grid,
)
from torchdrivesim_tpu_torch.mesh import RGBMesh
from torchdrivesim_tpu_torch.rendering.base import Cameras
from torchdrivesim_tpu_torch.simulator import Simulator, SimulatorState, TorchDriveConfig
from torchdrivesim_tpu_torch.utils import Resolution


@dataclass
class GymEnvConfig:
    map_name: str = 'carla_Town02'
    agent_count: int = 6
    res: int = 64
    fov: float = 35.0
    max_steps: int = 200
    offroad_penalty: float = 1.0
    collision_penalty: float = 10.0
    wrong_way_penalty: float = 0.5
    speed_reward: float = 0.1
    use_background_texture: bool = True
    seed: int = 0


def initial_arrays(cfg: GymEnvConfig) -> Dict[str, np.ndarray]:
    """The scenario's agents as the reference draws them: ``agent_state``
    (1, A, 4), ``agent_size`` (1, A, 2) and ``lr`` (1, A), float32 numpy,
    placed by ``heuristic_initialize`` from ``random.Random(cfg.seed)``."""
    cfg_map = find_map_config(cfg.map_name)
    if cfg_map is None:
        raise FileNotFoundError(f"map {cfg.map_name!r} not found")
    attrs, states = heuristic_initialize(cfg_map.lanelet_map, cfg.agent_count,
                                         random.Random(cfg.seed), min_speed=1,
                                         max_speed=6)
    return dict(agent_state=states, agent_size=attrs[..., :2], lr=attrs[..., 2])


def gym_sim_from_arrays(cfg: GymEnvConfig, arrays: Dict[str, np.ndarray],
                        device='cuda') -> Simulator:
    """
    The environment's one-scenario simulator on ``device`` from its agents
    given as numpy arrays (the keys of :func:`initial_arrays`, such as a
    reference simulator's with ``np.asarray`` applied), with the map's
    traffic lights, grids and, with ``cfg.use_background_texture``, texture.
    """
    device = torch.device(device)
    cfg_map = find_map_config(cfg.map_name)
    if cfg_map is None:
        raise FileNotFoundError(f"map {cfg.map_name!r} not found")
    left_handed = bool(cfg_map.left_handed_coordinates)
    kin = K.BicycleNoReversing(dt=0.1, left_handed=left_handed, device=device)
    kin.set_params(lr=np.asarray(arrays['lr'], np.float32))
    kin.set_state(np.asarray(arrays['agent_state'], np.float32))
    n = kin.get_state().shape[1]
    sim = Simulator(
        road_mesh=cfg_map.road_mesh, kinematic_model=kin,
        agent_size=np.asarray(arrays['agent_size'], np.float32),
        initial_present_mask=np.ones((1, n), dtype=bool),
        cfg=TorchDriveConfig(left_handed_coordinates=left_handed),
        traffic_controls=traffic_controls_from_map_config(cfg_map, device=device),
        map_grids=cfg_map.grids(device=device))
    sim.renderer.res = Resolution(cfg.res, cfg.res)
    sim.renderer.scale = 2.0 / cfg.fov
    if cfg.use_background_texture:
        sim.renderer.background_texture = load_or_bake_texture(cfg_map)
    return sim


def build_gym_sim(cfg: GymEnvConfig, device='cuda') -> Simulator:
    """The environment's one-scenario simulator (the reference's
    ``GymEnv._build_sim``), on ``device``."""
    return gym_sim_from_arrays(cfg, initial_arrays(cfg), device)


class GymEnv:
    """
    The single-ego environment: agent 0 of the scenario of
    :func:`build_gym_sim` is the ego, the other agents hold a zero action.
    A reset is a copy of the initial simulator. The reward is the ego's
    ``speed_reward * speed`` less the offroad, collision and wrong-way
    penalties; an episode ends on a collision (terminated) or after
    ``max_steps`` steps (truncated).
    """
    def __init__(self, cfg: GymEnvConfig = GymEnvConfig(), device='cuda'):
        self.cfg = cfg
        self._sim_template = self._build_sim(device)
        self.sim: Optional[Simulator] = None
        self.t = 0
        self.action_size = 2

    def _build_sim(self, device) -> Simulator:
        return build_gym_sim(self.cfg, device)

    @property
    def device(self) -> torch.device:
        return self._sim_template.device

    def reset(self, seed: Optional[int] = None):
        """(observation, {}) of a fresh copy of the initial simulator."""
        self.sim = self._sim_template.copy()
        self.t = 0
        return self._observe(), {}

    def _observe(self) -> np.ndarray:
        """The ego's egocentric view, (3, res, res) in [0, 255]."""
        return self.sim.render_egocentric()[0, 0].cpu().numpy()

    def _full_action(self, action) -> torch.Tensor:
        full = torch.zeros((1, self.sim.agent_count, 2), device=self.device)
        full[0, 0] = torch.as_tensor(np.asarray(action, np.float32), device=self.device)
        return full

    def step(self, action):
        """(observation, reward, terminated, truncated, info) after one step
        with the ego's (2,) action."""
        assert self.sim is not None, "call reset() first"
        self.prev_action = np.asarray(action, np.float32)
        self.sim.step(self._full_action(action))
        self.t += 1
        info = {'offroad': float(self.sim.compute_offroad()[0, 0]),
                'collision': float(self.sim.compute_collision()[0, 0]),
                'wrong_way': float(self.sim.compute_wrong_way()[0, 0]),
                'speed': float(self.sim.get_state()[0, 0, 3])}
        reward = self.get_reward(info)
        terminated = info['collision'] > 0
        truncated = self.t >= self.cfg.max_steps
        return self._observe(), reward, terminated, truncated, info

    def get_reward(self, info) -> float:
        return (self.cfg.speed_reward * info['speed']
                - self.cfg.offroad_penalty * info['offroad']
                - self.cfg.collision_penalty * info['collision']
                - self.cfg.wrong_way_penalty * info['wrong_way'])

    def render(self):
        return self._observe()

    def close(self):
        self.sim = None


class IAIGymEnv(GymEnv):
    """
    The environment with its other vehicles driven by the Inverted AI API:
    INITIALIZE places ``agent_count`` vehicles around the map's center,
    the first becomes the ego (a kinematic bicycle, the only agent of the
    simulator) and the rest NPCs of an
    :class:`~torchdrivesim_tpu_torch.behavior.iai.IAINPCController`, which
    calls DRIVE every step. Resets reuse the same initial conditions. The
    reward is ``speed - offroad - collision - |action|``, clipped to [-10,
    10].
    """
    def _build_sim(self, device) -> Simulator:
        from torchdrivesim_tpu_torch.behavior.iai import IAINPCController, iai_initialize
        device = torch.device(device)
        cfg_map = find_map_config(self.cfg.map_name)
        if cfg_map is None:
            raise FileNotFoundError(f"map {self.cfg.map_name!r} not found")
        location = cfg_map.iai_location_name
        attrs, states, recurrent = iai_initialize(
            location=location, agent_count=self.cfg.agent_count,
            center=tuple(np.asarray(cfg_map.center)), device=device)
        left_handed = bool(cfg_map.left_handed_coordinates)
        kin = K.KinematicBicycle(dt=0.1, left_handed=left_handed, device=device)
        kin.set_params(lr=attrs[:, :1, 2])
        kin.set_state(states[:, :1])
        npc = IAINPCController(
            npc_size=attrs[:, 1:, :2], npc_state=states[:, 1:], location=location,
            recurrent_states=recurrent, agent_type_names=['vehicle'])
        sim = Simulator(
            road_mesh=cfg_map.road_mesh, kinematic_model=kin,
            agent_size=attrs[:, :1, :2],
            initial_present_mask=torch.ones((1, 1), dtype=torch.bool),
            cfg=TorchDriveConfig(left_handed_coordinates=left_handed),
            npc_controller=npc, map_grids=cfg_map.grids(device=device))
        sim.renderer.res = Resolution(self.cfg.res, self.cfg.res)
        sim.renderer.scale = 2.0 / self.cfg.fov
        if self.cfg.use_background_texture:
            sim.renderer.background_texture = load_or_bake_texture(cfg_map)
        return sim

    def _full_action(self, action) -> torch.Tensor:
        return torch.as_tensor(np.asarray(action, np.float32),
                               device=self.device).reshape(1, 1, 2)

    def get_reward(self, info) -> float:
        r = (info['speed'] - info['offroad'] - info['collision']
             - float(np.linalg.norm(self.prev_action)))
        return float(np.clip(r, -10.0, 10.0))


class SingleAgentWrapper:
    """
    The environment's interface without its leading singleton batch and
    agent dimensions (only safe when both are 1); duck-type compatible
    with gymnasium's ``Wrapper``.
    """
    def __init__(self, env):
        self.env = env

    @staticmethod
    def _squeeze(x):
        """Up to two leading dimensions of size 1 removed, in dicts too."""
        if isinstance(x, dict):
            return {k: SingleAgentWrapper._squeeze(v) for k, v in x.items()}
        if isinstance(x, (np.ndarray, torch.Tensor)):
            for _ in range(2):
                if x.ndim > 0 and x.shape[0] == 1:
                    x = x[0]
        return x

    def reset(self, seed: Optional[int] = None):
        obs, info = self.env.reset(seed)
        return self._squeeze(obs), self._squeeze(info)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(
            np.asarray(action).reshape(-1)[:2])
        return (self._squeeze(obs), float(reward), bool(terminated), bool(truncated),
                self._squeeze(info))

    def render(self, *args, **kwargs):
        return self.env.render(*args, **kwargs)

    def close(self):
        self.env.close()


def main(argv: Optional[List[str]] = None) -> None:
    """Two short episodes accelerating straight; a SIGTERM raises
    ``InterruptedError`` for a graceful shutdown."""
    parser = argparse.ArgumentParser(description='Drive the single-ego environment.')
    parser.add_argument('--map', default='carla_Town02')
    parser.add_argument('--agents', type=int, default=6)
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--res', type=int, default=64)
    parser.add_argument('--iai', action='store_true',
                        help='drive NPCs with the Inverted AI API '
                             '(needs the invertedai package + IAI_API_KEY)')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass --device cpu to run on the CPU')

    def sigterm_handler(signum, frame):
        raise InterruptedError("SIGTERM received")

    signal.signal(signal.SIGTERM, sigterm_handler)
    cfg = GymEnvConfig(map_name=args.map, agent_count=args.agents, res=args.res)
    env_cls = IAIGymEnv if args.iai else GymEnv
    with contextlib.closing(SingleAgentWrapper(env_cls(cfg, device))) as env:
        for episode in range(2):
            env.reset()
            action = np.asarray([1.0, 0.0], np.float32)  # accelerate straight
            for i in range(args.steps):
                obs, reward, terminated, truncated, info = env.step(action)
                if info['collision']:
                    print("collision")
                if info['offroad']:
                    print("offroad")
                if terminated or truncated:
                    break
            print(f"episode {episode}: {i + 1} steps, last reward {reward:.2f}")


def _all_agents(state: SimulatorState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, A + N, 4) states and (B, A + N) presence of agents and NPCs."""
    return (torch.cat([state.agent_state, state.npc_state], dim=-2),
            torch.cat([state.present_mask, state.npc_present_mask], dim=-1))


class VectorizedGymEnv:
    """
    ``batch_size`` copies of the environment's scenario as one batched
    simulator, stepped by the pure function of :meth:`make_step_fn`.

    Args:
        cfg: the environment's configuration.
        batch_size: environments.
        device: where the simulator lives (the card by default).
        sim: the one-scenario simulator to copy; built by
            :func:`build_gym_sim` when omitted.
    """
    def __init__(self, cfg: GymEnvConfig = GymEnvConfig(), batch_size: int = 16,
                 device='cuda', sim: Optional[Simulator] = None):
        self.cfg = cfg
        self.batch_size = batch_size
        base = sim if sim is not None else build_gym_sim(cfg, device)
        self.sim = base.extend(batch_size, in_place=False)
        self.initial_state = self.sim.state

    @property
    def device(self) -> torch.device:
        return self.sim.device

    def view(self, state: SimulatorState) -> Tuple[RGBMesh, Cameras]:
        """The per-camera mesh and the egos' cameras from which
        :meth:`make_step_fn`'s step renders the observation of ``state``:
        the actors, and the whole map mesh when there is no texture."""
        return self._view(state, *_all_agents(state))

    def _view(self, state: SimulatorState, all_state: torch.Tensor,
              present: torch.Tensor) -> Tuple[RGBMesh, Cameras]:
        mesh = self.sim.birdview_mesh_generator.generate(
            1, agent_state=all_state[:, None], present_mask=present[:, None],
            include_background=self.sim.renderer.background_texture is None)
        ego = state.agent_state[:, 0]
        cameras = Cameras(ego[:, :2], torch.stack(
            [torch.sin(ego[:, 2]), torch.cos(ego[:, 2])], dim=-1), 2.0 / self.cfg.fov)
        return mesh, cameras

    def make_step_fn(self) -> Callable[[SimulatorState, torch.Tensor],
                                       Tuple[SimulatorState, torch.Tensor,
                                             torch.Tensor, torch.Tensor]]:
        """
        ``step_fn(state, ego_action) -> (state, obs, reward, done)``: one
        step with the egos' (B, 2) normalized (acceleration, steering) and
        the other agents' zero action; ``obs`` is each ego's (B, 3, res,
        res) view in [0, 255] after the step, ``reward`` (B,) the ego's
        ``speed_reward * speed`` less the offroad, collision and wrong-way
        penalties, ``done`` (B,) whether the ego collides.
        """
        sim, cfg = self.sim, self.cfg
        b, a = self.batch_size, sim.agent_count
        sizes = sim.get_all_agent_size()
        res = Resolution(cfg.res, cfg.res)

        def step_fn(state: SimulatorState, ego_action: torch.Tensor):
            rest = ego_action.new_zeros((b, a - 1, 2))
            state = sim.functional_step(state, torch.cat([ego_action[:, None], rest], 1))
            all_state, present = _all_agents(state)
            mesh, cameras = self._view(state, all_state, present)
            obs = sim.renderer.render_rgb_mesh_chw(mesh, res, cameras)
            boxes = torch.cat([all_state[..., :2], sizes, all_state[..., 2:3]], dim=-1)
            collision = compute_collision_matrix(boxes, present)[:, 0]
            if sim.map_grids is not None:
                offroad = offroad_loss_from_grid(sim.map_grids, state.agent_state,
                                                 sim.agent_size)[:, 0]
                wrong_way = wrong_way_loss_from_grid(sim.map_grids,
                                                     state.agent_state)[:, 0]
            else:
                offroad = wrong_way = torch.zeros_like(collision)
            speed = state.agent_state[:, 0, 3]
            reward = (cfg.speed_reward * speed
                      - cfg.offroad_penalty * offroad
                      - cfg.collision_penalty * collision
                      - cfg.wrong_way_penalty * wrong_way)
            return state, obs, reward, collision > 0

        return step_fn


if __name__ == '__main__':
    main()
