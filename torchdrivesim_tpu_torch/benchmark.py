"""
The headline env step and its timing (counterpart of
``torchdrivesim_tpu/benchmark.py``): a batch of environments on a CARLA
town, ~20 bicycle-model vehicles each, FSM-driven traffic lights, an
egocentric bird's-eye-view render over the baked map texture, and
collision / offroad / wrong-way / red-light metrics every step.

BASELINE config 3 (:func:`build_config3_scenario`) is that world on
carla_Town10HD with heterogeneous kinematic models per agent.

Also the imitation-learning gradient path (the reference's
``tools/bench_suite.py:config4_il_gradients``): :func:`build_il_scenario`
and :func:`make_il_grad_fn`, the gradient of a policy's rollout loss
through the differentiable render and the dynamics.

And the RL path (the reference's ``examples/rl_example.py`` at 1024
environments): :func:`build_rl_env` and :func:`run_rl_benchmark`, which
times PPO's rollout collection and its update.

The map caches (texture, grids) are read from next to the map, or baked
there when missing (:func:`load_or_bake_texture`, ``MapConfig.grids``).
"""
import dataclasses
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
from torchdrivesim_tpu_torch.imitation import ego_view, policy_step
from torchdrivesim_tpu_torch.infractions import compute_collision_matrix
from torchdrivesim_tpu_torch.map import (
    MapConfig, cache_writable, find_map_config, traffic_controls_from_map_config,
)
from torchdrivesim_tpu_torch.map_grids import (
    offroad_loss_from_grid, wrong_way_loss_from_grid,
)
from torchdrivesim_tpu_torch.ops.grids import Grid2D
from torchdrivesim_tpu_torch.rendering import lift_renderer_config
from torchdrivesim_tpu_torch.rendering.base import Cameras, RendererConfig
from torchdrivesim_tpu_torch.rendering.renderer import pack_rgb8_chw
from torchdrivesim_tpu_torch.simulator import Simulator, TorchDriveConfig
from torchdrivesim_tpu_torch.traffic_controls import red_light_violations
from torchdrivesim_tpu_torch.traffic_lights import BakedLightSchedule
from torchdrivesim_tpu_torch.utils import Resolution


def texture_cache_path(cfg: MapConfig, ppm: float) -> Optional[str]:
    base = cfg.mesh_path or cfg.lanelet_path
    if base is None:
        return None
    return os.path.join(os.path.dirname(base), f'{cfg.name}_tpu_texture_{ppm:g}.npz')


def load_or_bake_texture(cfg: MapConfig, color_map=None, rendering_levels=None,
                         ppm: float = 4.0, *, device='cuda') -> Grid2D:
    """
    The map's background texture (host numpy data), read from the float16
    cache next to the map; when that is missing, baked from the road mesh
    colored by ``color_map`` and ``rendering_levels`` (the defaults when
    None) on ``device`` (``ops.rasterize.bake_background_texture``: HF on the
    card) and written there as the reference writes it (but never beside
    the maps bundled with the JAX package: ``map.cache_writable``).
    """
    path = texture_cache_path(cfg, ppm)
    if path and os.path.exists(path):
        with np.load(path) as data:
            return Grid2D(data=data['data'].astype(np.float32),
                          origin=data['origin'].astype(np.float32),
                          cell_size=float(data['cell']))
    from torchdrivesim_tpu_torch.mesh import set_colors_with_defaults
    from torchdrivesim_tpu_torch.ops.rasterize import bake_background_texture
    from torchdrivesim_tpu_torch.rendering.base import (
        get_default_color_map, get_default_rendering_levels)
    color_map = get_default_color_map() if color_map is None else color_map
    rendering_levels = get_default_rendering_levels() if rendering_levels is None \
        else rendering_levels
    rgb = set_colors_with_defaults(cfg.road_mesh, color_map, rendering_levels)
    dev = torch.device(device)
    texture = bake_background_texture(
        torch.as_tensor(np.asarray(rgb.verts[0]), device=dev),
        torch.as_tensor(np.asarray(rgb.faces[0]), device=dev),
        torch.as_tensor(np.asarray(rgb.attrs[0]), device=dev),
        background_color=torch.tensor(color_map['background'], dtype=torch.float32,
                                      device=dev) / 255.0,
        pixels_per_meter=ppm)
    data = texture.data.cpu().numpy()
    origin = texture.origin.cpu().numpy().astype(np.float64)
    if cache_writable(path):
        try:
            np.savez_compressed(path, data=data.astype(np.float16), origin=origin,
                                cell=texture.cell_size)
        except OSError:
            pass
    return Grid2D(data=data, origin=origin.astype(np.float32), cell_size=texture.cell_size)


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
        ``image`` (B, 3, res, res) float in [0, 255] (the primitive render
        over the texture, or the frame's mesh, map included, without one)
        or, with ``packed_image``, (B, res, res) int32 0x00BBGGRR; ``collision``,
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
                if renderer.background_texture is not None:
                    prims = gen.generate_prims(all_state, present_mask=present,
                                               traffic_light_state=light_state)
                    outputs['image'] = renderer.render_prims_chw(
                        *prims, Resolution(res, res), cameras, packed=packed_image)
                else:
                    # without a texture the frame's mesh, map included
                    mesh = gen.generate(1, agent_state=all_state[:, None],
                                        present_mask=present[:, None],
                                        traffic_light_state=light_state,
                                        include_background=True)
                    image = renderer.render_rgb_mesh_chw(mesh, Resolution(res, res),
                                                         cameras)
                    outputs['image'] = pack_rgb8_chw(image) if packed_image else image
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
                             use_texture: bool = True,
                             background_downsample: int = 2,
                             n_layouts: int = 4, renderer_config=None,
                             device='cuda') -> BenchmarkScenario:
    """
    Assemble the benchmark world on ``device``: ``batch_size`` envs on one
    map, each with ``agent_count`` bicycle-model vehicles placed on lanelet
    centerlines (``n_layouts`` distinct layouts tiled over the batch), the
    traffic-light stack on its baked FSM schedule, the baked grids, and the
    renderer: over the baked map texture with ``use_texture`` (views no mip
    level covers sample it at ``res / background_downsample`` and upsample),
    else over the map mesh; ``renderer_config`` (a configuration or a dict,
    as ``TorchDriveConfig.renderer`` takes it) replaces the default
    renderer's. All randomness comes from one
    ``random.Random(seed)``, drawn in the reference's order, so the scenario
    equals the reference's.
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
    renderer_cfg = lift_renderer_config(
        RendererConfig() if renderer_config is None else renderer_config)
    if isinstance(renderer_cfg, RendererConfig):
        renderer_cfg = dataclasses.replace(renderer_cfg,
                                           background_downsample=background_downsample)
    cfg = TorchDriveConfig(left_handed_coordinates=left_handed, renderer=renderer_cfg)
    controls = {k: v.extend(batch_size) for k, v in
                traffic_controls_from_map_config(cfg_map, device=device).items()}
    sim = Simulator(
        road_mesh=cfg_map.road_mesh, kinematic_model=kin, agent_size=attrs[..., :2],
        initial_present_mask=np.ones((batch_size, agent_count), dtype=bool),
        cfg=cfg, traffic_controls=controls,
        map_grids=cfg_map.grids(device=device),
        lanelet_map=[lanelet_map] * batch_size)
    sim.renderer.res = Resolution(res, res)
    sim.renderer.scale = 2.0 / fov
    if use_texture:
        sim.renderer.background_texture = load_or_bake_texture(cfg_map)

    schedule = None
    controller = cfg_map.traffic_light_controller(rng)
    if controller is not None and 'traffic_light' in controls:
        light_ids = getattr(controls['traffic_light'], 'actor_ids', None)
        if light_ids:
            schedule = BakedLightSchedule(controller, light_ids, device=device)
            sim.set_light_schedule(schedule)
    return BenchmarkScenario(sim=sim, schedule=schedule, res=res, fov=fov, dt=dt)


#: BASELINE config 3's kinematic models (vehicles, pedestrians, cyclists)
#: and the share of agents each drives
CONFIG3_MODELS = (K.BICYCLE, K.SIMPLE, K.BICYCLE_NO_REVERSING)
CONFIG3_SHARES = (0.6, 0.2, 0.2)


def build_config3_scenario(batch_size: int = 64, agent_count: int = 20,
                           res: int = 128, fov: float = 70.0, seed: int = 0,
                           device='cuda') -> BenchmarkScenario:
    """
    BASELINE config 3, heterogeneous agents (the reference's
    ``tools/bench_suite.py:config3_heterogeneous``): the benchmark world on
    carla_Town10HD (left-handed, 30 lights) with each agent's kinematic
    model drawn by ``np.random.RandomState(0)`` from :data:`CONFIG3_MODELS`
    with :data:`CONFIG3_SHARES`, stepped by a
    :class:`~torchdrivesim_tpu_torch.kinematic.CompoundKinematicModel` over
    the bicycle's parameters (per-agent ``lr``) and states. Its actions are
    4 wide (``sim.action_size``).
    """
    scenario = build_benchmark_scenario(
        map_name='carla_Town10HD', batch_size=batch_size, agent_count=agent_count,
        res=res, fov=fov, seed=seed, device=device)
    sim = scenario.sim
    ids = np.random.RandomState(0).choice(
        CONFIG3_MODELS, size=(batch_size, agent_count), p=CONFIG3_SHARES)
    compound = K.CompoundKinematicModel(ids, params=sim.kinematic_model.params,
                                        dt=scenario.dt, device=sim.device)
    compound.set_state(sim.kinematic_model.get_state())
    sim.kinematic_model = compound
    return scenario


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
    action = torch.zeros((b, sim.agent_count, sim.action_size), device=sim.device)

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
                      fov: float = 70.0, seed: int = 0, use_texture: bool = True,
                      n_layouts: int = 4, device='cuda') -> BenchmarkScenario:
    """The imitation-learning gradient configuration: the benchmark world
    (carla_Town02 by default, ``n_layouts`` distinct layouts tiled over the
    batch) with the renderer in differentiable mode; over the map texture
    with ``use_texture``, else over the road mesh."""
    scenario = build_benchmark_scenario(batch_size=batch_size,
                                        agent_count=agent_count, res=res,
                                        fov=fov, seed=seed, use_texture=use_texture,
                                        n_layouts=n_layouts, device=device)
    scenario.sim.renderer.cfg.differentiable = True
    return scenario


def il_view(scenario: BenchmarkScenario, state):
    """The frame the imitation-learning rollout renders from ``state``:
    (mesh, cameras) of :func:`imitation.ego_view` at the renderer's
    scale."""
    return ego_view(scenario.sim, state, scenario.sim.renderer.scale)


def make_il_rollout_fn(scenario: BenchmarkScenario, policy: torch.nn.Module,
                       horizon: int = 40) -> Callable:
    """
    ``rollout(state) -> state``: ``horizon`` steps of the scenario with the
    first agent of each environment driven by ``policy`` on its
    differentiable egocentric view (:func:`imitation.policy_step` over
    :func:`il_view`'s frame: the actors over the bilinear mip warp of the
    map texture, or over the road mesh without a texture) and the others
    holding zero action.
    """
    def rollout(state):
        for _ in range(horizon):
            state = policy_step(scenario.sim, policy, state, scenario.res)
        return state

    return rollout


def make_il_loss_fn(scenario: BenchmarkScenario, policy: torch.nn.Module,
                    horizon: int = 40) -> Callable[..., torch.Tensor]:
    """``loss_fn(state)``: the mean squared final position of the first
    agent after :func:`make_il_rollout_fn`'s rollout."""
    rollout = make_il_rollout_fn(scenario, policy, horizon)

    def loss_fn(state) -> torch.Tensor:
        return torch.mean(rollout(state).agent_state[:, 0, :2] ** 2)

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


def build_rl_env(batch_size: int = 1024, map_name: str = 'carla_Town02',
                 agent_count: int = 4, res: int = 64, fov: float = 35.0,
                 use_background_texture: bool = True, seed: int = 0,
                 device='cuda'):
    """The RL example's vectorized environment (``rl_example.py``'s
    ``GymEnvConfig(agent_count=4, res=64)``) at ``batch_size``
    environments on ``device``."""
    from torchdrivesim_tpu_torch.gym_env import GymEnvConfig, VectorizedGymEnv
    cfg = GymEnvConfig(map_name=map_name, agent_count=agent_count, res=res, fov=fov,
                       use_background_texture=use_background_texture, seed=seed)
    return VectorizedGymEnv(cfg, batch_size=batch_size, device=device)


def run_rl_benchmark(venv, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     rollout: int = 16, epochs: int = 2, n_chunks: int = 3) -> dict:
    """
    Time PPO on a CUDA device: each chunk is one rollout collection and
    ``epochs`` PPO updates on it, each part timed by the host clock between
    two ``torch.cuda.synchronize()`` calls. A first chunk warms up and is
    not counted.

    Returns:
        env-steps/s of the collection (batch x rollout per collection) and
        ms of the PPO iteration's updates (all epochs), per chunk and their
        medians, and the median ms per update.
    """
    from torchdrivesim_tpu_torch.rl import collect, ppo_update
    device = venv.device
    if device.type != 'cuda':
        raise RuntimeError(f'run_rl_benchmark times a CUDA device; the '
                           f'environment is on {device}')
    step_fn = venv.make_step_fn()
    generator = torch.Generator(device=device).manual_seed(0)
    state = venv.initial_state
    rates, update_ms = [], []
    for chunk in range(n_chunks + 1):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, batch = collect(model, step_fn, state, rollout, generator)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        for _ in range(epochs):
            ppo_update(model, optimizer, batch)
        torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        if chunk:
            rates.append(venv.batch_size * rollout / (t1 - t0))
            update_ms.append((t2 - t1) * 1e3)
    return {
        'collect_env_steps_per_sec_median': statistics.median(rates),
        'ppo_iteration_ms_median': statistics.median(update_ms),
        'ppo_update_ms_median': statistics.median(update_ms) / epochs,
        'chunk_collect_rates': rates,
        'chunk_ppo_iteration_ms': update_ms,
        'batch_size': venv.batch_size,
        'rollout': rollout,
    }
