"""
The headline env step and its timing (counterpart of
``torchdrivesim_tpu/benchmark.py``): a batch of environments on a CARLA
town, ~20 bicycle-model vehicles each, FSM-driven traffic lights, an
egocentric bird's-eye-view render over the baked map texture, and
collision / offroad / wrong-way / red-light metrics every step.

Also the imitation-learning gradient path (the reference's
``tools/bench_suite.py:config4_il_gradients``): :func:`build_il_scenario`
and :func:`make_il_grad_fn`, the gradient of a policy's rollout loss
through the differentiable render and the dynamics.

The map caches (texture, grids) are read from next to the map; baking them
is not ported.
"""
import os
import random
import statistics
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

import torchdrivesim_tpu_torch.kinematic as K
from torchdrivesim_tpu_torch.behavior.heuristic import heuristic_initialize
from torchdrivesim_tpu_torch.imitation import render_ego
from torchdrivesim_tpu_torch.infractions import compute_collision_matrix
from torchdrivesim_tpu_torch.map import (
    MapConfig, find_map_config, traffic_controls_from_map_config,
)
from torchdrivesim_tpu_torch.map_grids import (
    offroad_loss_from_grid, wrong_way_loss_from_grid,
)
from torchdrivesim_tpu_torch.ops.grids import Grid2D
from torchdrivesim_tpu_torch.rendering.base import Cameras
from torchdrivesim_tpu_torch.simulator import Simulator, TorchDriveConfig
from torchdrivesim_tpu_torch.traffic_controls import red_light_violations
from torchdrivesim_tpu_torch.traffic_lights import BakedLightSchedule
from torchdrivesim_tpu_torch.utils import Resolution


def texture_cache_path(cfg: MapConfig, ppm: float) -> Optional[str]:
    base = cfg.mesh_path or cfg.lanelet_path
    if base is None:
        return None
    return os.path.join(os.path.dirname(base), f'{cfg.name}_tpu_texture_{ppm:g}.npz')


def load_or_bake_texture(cfg: MapConfig, ppm: float = 4.0) -> Grid2D:
    """The map's background texture, read from the float16 cache the JAX
    package bakes next to the map (host numpy data; baking is not ported)."""
    path = texture_cache_path(cfg, ppm)
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            f"no baked texture for map {cfg.name!r} at {path}; bake it with the "
            "JAX package (torchdrivesim_tpu.benchmark.load_or_bake_texture)")
    with np.load(path) as data:
        return Grid2D(data=data['data'].astype(np.float32),
                      origin=data['origin'].astype(np.float32),
                      cell_size=float(data['cell']))


@dataclass
class BenchmarkScenario:
    sim: Simulator
    schedule: Optional[BakedLightSchedule]
    res: int
    fov: float
    dt: float

    def make_step_fn(self, render: bool = True, metrics: bool = True,
                     packed_image: bool = False):
        """
        One env step as a function (state, action) -> (state, outputs dict):
        ``image`` (B, 3, res, res) float in [0, 255] or, with
        ``packed_image``, (B, res, res) int32 0x00BBGGRR; ``collision``,
        ``offroad``, ``wrong_way``, ``light_violation`` per agent.
        """
        sim = self.sim
        gen = sim.birdview_mesh_generator
        renderer = sim.renderer
        res = self.res
        sizes = sim.get_all_agent_size()
        light_control = (sim.traffic_controls or {}).get('traffic_light')

        def step(state, action):
            state = sim.functional_step(state, action)
            light_state = None
            if light_control is not None:
                light_state = state.traffic_control_state['traffic_light']
            all_state = torch.cat([state.agent_state, state.npc_state], dim=-2)
            present = torch.cat([state.present_mask, state.npc_present_mask], dim=-1)
            outputs = {}
            if render:
                ego = state.agent_state[:, 0]
                cameras = Cameras(ego[:, :2], torch.stack(
                    [torch.sin(ego[:, 2]), torch.cos(ego[:, 2])], dim=-1),
                    2.0 / self.fov)
                prims = gen.generate_prims(all_state, present_mask=present,
                                           traffic_light_state=light_state)
                outputs['image'] = renderer.render_prims_chw(
                    *prims, Resolution(res, res), cameras, packed=packed_image)
            if metrics:
                boxes = torch.cat([all_state[..., :2], sizes, all_state[..., 2:3]],
                                  dim=-1)
                outputs['collision'] = compute_collision_matrix(
                    boxes, present)[:, :sim.agent_count]
                if sim.map_grids is not None:
                    outputs['offroad'] = offroad_loss_from_grid(
                        sim.map_grids, state.agent_state, sim.agent_size,
                        threshold=sim.cfg.offroad_threshold)
                    outputs['wrong_way'] = wrong_way_loss_from_grid(
                        sim.map_grids, state.agent_state)
                if light_state is not None:
                    outputs['light_violation'] = red_light_violations(
                        boxes[:, :sim.agent_count], light_control.corners,
                        light_state,
                        red_index=light_control.allowed_states.index('red'))
            return state, outputs

        return step


def build_benchmark_scenario(map_name: str = 'carla_Town02',
                             batch_size: int = 256, agent_count: int = 20,
                             res: int = 128, fov: float = 70.0,
                             dt: float = 0.1, seed: int = 0,
                             n_layouts: int = 4,
                             device='cuda') -> BenchmarkScenario:
    """
    Assemble the benchmark world on ``device``: ``batch_size`` envs on one
    map, each with ``agent_count`` bicycle-model vehicles placed on lanelet
    centerlines (``n_layouts`` distinct layouts tiled over the batch), the
    traffic-light stack on its baked FSM schedule, the baked grids, and the
    renderer. All randomness comes from one ``random.Random(seed)``, drawn
    in the reference's order, so the scenario equals the reference's.
    """
    device = torch.device(device)
    cfg_map = find_map_config(map_name)
    assert cfg_map is not None, f"map {map_name} not found"
    rng = random.Random(seed)
    lanelet_map = cfg_map.lanelet_map
    layouts = [heuristic_initialize(lanelet_map, agent_count, rng,
                                    min_speed=1, max_speed=8)
               for _ in range(min(n_layouts, batch_size))]
    reps = int(np.ceil(batch_size / len(layouts)))
    attrs = np.tile(np.concatenate([a for a, _ in layouts], axis=0),
                    (reps, 1, 1))[:batch_size]
    states = np.tile(np.concatenate([s for _, s in layouts], axis=0),
                     (reps, 1, 1))[:batch_size]

    left_handed = bool(cfg_map.left_handed_coordinates)
    kin = K.KinematicBicycle(dt=dt, left_handed=left_handed, device=device)
    kin.set_params(lr=attrs[..., 2])
    kin.set_state(states)
    cfg = TorchDriveConfig(left_handed_coordinates=left_handed)
    controls = {k: v.extend(batch_size) for k, v in
                traffic_controls_from_map_config(cfg_map, device=device).items()}
    sim = Simulator(
        road_mesh=cfg_map.road_mesh, kinematic_model=kin, agent_size=attrs[..., :2],
        initial_present_mask=np.ones((batch_size, agent_count), dtype=bool),
        cfg=cfg, traffic_controls=controls,
        map_grids=cfg_map.grids(device=device))
    sim.renderer.res = Resolution(res, res)
    sim.renderer.scale = 2.0 / fov
    sim.renderer.background_texture = load_or_bake_texture(cfg_map)

    schedule = None
    controller = cfg_map.traffic_light_controller(rng)
    if controller is not None and 'traffic_light' in controls:
        light_ids = getattr(controls['traffic_light'], 'actor_ids', None)
        if light_ids:
            schedule = BakedLightSchedule(controller, light_ids, device=device)
            sim.set_light_schedule(schedule)
    return BenchmarkScenario(sim=sim, schedule=schedule, res=res, fov=fov, dt=dt)


def run_benchmark(scenario: BenchmarkScenario, steps_per_chunk: int = 100,
                  n_chunks: int = 3, warmup_steps: int = 20) -> dict:
    """
    Time the env step on a CUDA device: each chunk of ``steps_per_chunk``
    steps is timed with CUDA events and synchronized before its time is
    read. Every step's outputs are reduced to a checksum on the device, as
    the reference's benchmark does, so nothing leaves the device.

    Returns:
        env-steps/s per chunk and their median, with the batch size.
    """
    sim = scenario.sim
    if sim.device.type != 'cuda':
        raise RuntimeError(f'run_benchmark times a CUDA device; the scenario '
                           f'is on {sim.device}')
    step = scenario.make_step_fn(render=True, metrics=True)
    b = sim.batch_size
    action = torch.zeros((b, sim.agent_count, 2), device=sim.device)

    def run(state, n, checksum):
        for _ in range(n):
            state, out = step(state, action)
            for v in out.values():
                checksum = checksum + v.sum(dtype=torch.float32)
        return state, checksum

    state = sim.state
    checksum = torch.zeros((), device=sim.device)
    state, checksum = run(state, warmup_steps, checksum)
    torch.cuda.synchronize(sim.device)
    chunk_rates = []
    for _ in range(n_chunks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, checksum = run(state, steps_per_chunk, checksum)
        end.record()
        end.synchronize()
        chunk_rates.append(b * steps_per_chunk / (start.elapsed_time(end) / 1e3))
    return {
        'env_steps_per_sec_median': statistics.median(chunk_rates),
        'chunk_rates': chunk_rates,
        'batch_size': b,
        'steps_per_chunk': steps_per_chunk,
        'checksum': float(checksum),
    }


def build_il_scenario(batch_size: int = 16, agent_count: int = 8, res: int = 64,
                      fov: float = 70.0, seed: int = 0,
                      device='cuda') -> BenchmarkScenario:
    """The imitation-learning gradient configuration: the benchmark world
    (carla_Town02 by default) with the renderer in differentiable mode."""
    scenario = build_benchmark_scenario(batch_size=batch_size,
                                        agent_count=agent_count, res=res,
                                        fov=fov, seed=seed, device=device)
    scenario.sim.renderer.cfg.differentiable = True
    return scenario


def make_il_loss_fn(scenario: BenchmarkScenario, policy: torch.nn.Module,
                    horizon: int = 40) -> Callable[..., torch.Tensor]:
    """
    ``loss_fn(state)``: roll the scenario ``horizon`` steps with the first
    agent of each environment driven by ``policy`` on its differentiable
    egocentric view (actors only, over the bilinear mip warp of the map
    texture) and the others holding zero action; the loss is the mean
    squared final position of the first agent.
    """
    sim = scenario.sim
    scale = 2.0 / scenario.fov

    def loss_fn(state) -> torch.Tensor:
        b, n = state.agent_state.shape[:2]
        rest = torch.zeros((b, n - 1, 2), device=state.agent_state.device)
        for _ in range(horizon):
            image = render_ego(sim, state, scenario.res, scale,
                               include_background=False)
            act = policy(image)
            state = sim.functional_step(state, torch.cat([act[:, None], rest], dim=1))
        return torch.mean(state.agent_state[:, 0, :2] ** 2)

    return loss_fn


def make_il_grad_fn(scenario: BenchmarkScenario, policy: torch.nn.Module,
                    horizon: int = 40
                    ) -> Callable[..., Tuple[torch.Tensor, List[torch.Tensor]]]:
    """``grad_fn(state) -> (loss, grads)``: the loss of
    :func:`make_il_loss_fn` and its gradient with respect to each of the
    policy's parameters, in ``policy.parameters()`` order."""
    loss_fn = make_il_loss_fn(scenario, policy, horizon)
    params = list(policy.parameters())

    def grad_fn(state):
        loss = loss_fn(state)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), list(grads)

    return grad_fn


def run_il_benchmark(scenario: BenchmarkScenario, policy: torch.nn.Module,
                     horizon: int = 40, rollouts_per_chunk: int = 2,
                     n_chunks: int = 3, warmup_rollouts: int = 1) -> dict:
    """
    Time the imitation-learning gradient step on a CUDA device: each chunk
    of ``rollouts_per_chunk`` gradient rollouts is timed by the host clock
    between two ``torch.cuda.synchronize()`` calls.

    Returns:
        grad-rollouts/s and env-steps/s (batch x horizon per rollout) per
        chunk and their medians.
    """
    sim = scenario.sim
    if sim.device.type != 'cuda':
        raise RuntimeError(f'run_il_benchmark times a CUDA device; the scenario '
                           f'is on {sim.device}')
    grad_fn = make_il_grad_fn(scenario, policy, horizon)
    for _ in range(warmup_rollouts):
        grad_fn(sim.state)
    torch.cuda.synchronize(sim.device)
    rates = []
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        for _ in range(rollouts_per_chunk):
            grad_fn(sim.state)
        torch.cuda.synchronize(sim.device)
        rates.append(rollouts_per_chunk / (time.perf_counter() - t0))
    steps = sim.batch_size * horizon
    return {
        'grad_rollouts_per_sec_median': statistics.median(rates),
        'env_steps_per_sec_median': statistics.median(rates) * steps,
        'chunk_rollout_rates': rates,
        'batch_size': sim.batch_size,
        'horizon': horizon,
    }
