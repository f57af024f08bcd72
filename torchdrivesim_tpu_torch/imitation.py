"""
Behaviour cloning through the differentiable simulator (counterpart of
``examples/imitation_learning.py``): the loss is the mean squared error
between expert trajectories and the states produced by rolling the policy
through the simulator, and its gradient flows through every kinematic step
and every soft bird's-eye-view render of the rollout.

The synthetic scenario is a straight two-lane road (a lanelet map
triangulated into a road mesh, rendered under every frame) with a
lane-keeping expert, so the loop runs without a dataset.

No activation checkpointing: each step keeps its render outputs, the
render Functions' saved inputs and the policy's activations for the backward
pass (a few MB per step at the IL configuration), so every render kernel
runs once per step forward and the soft raster's backward kernel once per
step backward, and nothing is recomputed.
"""
from typing import Callable, Tuple

import numpy as np
import torch

import torchdrivesim_tpu_torch.kinematic as K
from torchdrivesim_tpu_torch.lanelet2 import (
    Lanelet, LaneletMap, LaneletPoint, Linestring, road_mesh_from_lanelet_map,
)
from torchdrivesim_tpu_torch.mesh import BirdviewMesh
from torchdrivesim_tpu_torch.rendering.base import Cameras, RendererConfig
from torchdrivesim_tpu_torch.simulator import (
    Simulator, SimulatorState, TorchDriveConfig,
)
from torchdrivesim_tpu_torch.utils import Resolution


def build_synthetic_batch(batch_size: int, horizon: int, seed: int = 0,
                          device='cuda') -> Tuple[BirdviewMesh, torch.Tensor,
                                                  torch.Tensor]:
    """
    The synthetic straight-road scenario and lane-keeping expert.

    Returns:
        (road mesh, host BirdviewMesh of batch ``batch_size``;
         initial states (B, 1, 4); expert trajectories (T, B, 1, 4)),
        the tensors on ``device``.
    """
    def ls(lid, ys, base):
        return Linestring(id=lid, points=[
            LaneletPoint(id=base + i, x=float(x), y=ys)
            for i, x in enumerate(range(0, 220, 10))])
    left, right = ls(1, 4.0, 100), ls(2, -4.0, 200)
    lanelet_map = LaneletMap(left.points + right.points, [left, right],
                             [Lanelet(id=1, left_bound=left, right_bound=right)])
    road = BirdviewMesh.set_properties(road_mesh_from_lanelet_map(lanelet_map), 'road')
    road = BirdviewMesh.collate([road] * batch_size)

    rng = np.random.RandomState(seed)
    x0 = rng.uniform(5, 40, (batch_size, 1))
    y0 = rng.uniform(-2.0, 2.0, (batch_size, 1))
    v0 = rng.uniform(3, 7, (batch_size, 1))
    states0 = np.concatenate([x0, y0, np.zeros_like(x0), v0],
                             axis=-1)[:, None, :]  # B x A=1 x 4

    # expert: drive straight at constant speed while centering on y=0
    traj = np.zeros((horizon, batch_size, 1, 4), np.float32)
    s = states0.copy()
    for t in range(horizon):
        s = s.copy()
        s[..., 0] += s[..., 3] * 0.1
        s[..., 1] *= 0.9  # exponential pull toward the lane center
        traj[t] = s
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return road, as_t(states0), as_t(traj)


def build_synthetic_simulator(road: BirdviewMesh, states0: torch.Tensor,
                              res: int = 64, fov: float = 35.0) -> Simulator:
    """The example's simulator: one simple-model ego per environment on the
    road mesh, the differentiable renderer at ``res`` and ``fov`` meters,
    on the device of ``states0``."""
    b = states0.shape[0]
    kin = K.SimpleKinematicModel(dt=0.1, device=states0.device)
    kin.set_state(states0)
    cfg = TorchDriveConfig(renderer=RendererConfig(differentiable=True))
    sim = Simulator(
        road_mesh=road, kinematic_model=kin,
        agent_size=torch.tensor([[[4.6, 2.0]]]).expand(b, 1, 2),
        initial_present_mask=torch.ones((b, 1), dtype=torch.bool), cfg=cfg)
    sim.renderer.res = Resolution(res, res)
    sim.renderer.scale = 2.0 / fov
    return sim


def render_ego(sim: Simulator, state: SimulatorState, res: int, scale: float,
               include_background: bool) -> torch.Tensor:
    """Each environment's differentiable egocentric view from its first
    agent, (B, 3, res, res) in [0, 255]."""
    all_state = torch.cat([state.agent_state, state.npc_state], dim=-2)
    present = torch.cat([state.present_mask, state.npc_present_mask], dim=-1)
    mesh = sim.birdview_mesh_generator.generate(
        1, agent_state=all_state[:, None], present_mask=present[:, None],
        include_background=include_background)
    ego = state.agent_state[:, 0]
    cameras = Cameras(ego[:, :2], torch.stack([torch.sin(ego[:, 2]),
                                               torch.cos(ego[:, 2])], dim=-1),
                      scale)
    return sim.renderer.render_rgb_mesh_chw(mesh, Resolution(res, res), cameras)


def make_bc_train_step(sim: Simulator, policy: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, res: int
                       ) -> Callable[[SimulatorState, torch.Tensor], torch.Tensor]:
    """
    The behaviour-cloning training step: one rollout of T steps, each a
    render, a policy call and a kinematic step, the loss against the expert
    and one optimizer step on its gradient.

    Returns:
        ``train_step(state0, expert) -> loss`` where ``expert`` is
        (T, B, A, 4); the loss is returned detached, before the update.
    """
    def loss_fn(state0: SimulatorState, expert: torch.Tensor) -> torch.Tensor:
        state, preds = state0, []
        for _ in range(expert.shape[0]):
            image = render_ego(sim, state, res, sim.renderer.scale,
                               include_background=True)
            action = policy(image)[:, None, :]                 # B x 1 x Ac
            state = sim.functional_step(state, action)
            preds.append(state.agent_state)
        preds = torch.stack(preds)
        return torch.mean((preds[..., :2] - expert[..., :2]) ** 2)

    def train_step(state0: SimulatorState, expert: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state0, expert)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def make_optimizer(policy: torch.nn.Module, lr: float = 3e-4) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(policy.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)
