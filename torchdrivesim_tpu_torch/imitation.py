"""
Behaviour cloning through the differentiable simulator (counterpart of
``examples/imitation_learning.py``): the loss is the mean squared error
between expert trajectories and the states produced by rolling the policy
through the simulator, and its gradient flows through every kinematic step
and every soft bird's-eye-view render of the rollout (with teacher forcing,
each step starts from the expert's states, and through the steps only).

The synthetic scenario is a straight two-lane road (a lanelet map
triangulated into a road mesh, rendered under every frame) with a
lane-keeping expert, so the loop runs without a dataset. The dataset
scenario takes INTERACTION cases: each ego is a recorded vehicle track,
the case's other agents are replayed as NPCs and drawn in every frame, and
the road mesh is triangulated from the location's lanelet map.

No activation checkpointing: each step keeps its render outputs, the
render Functions' saved inputs and the policy's activations for the backward
pass (a few MB per step at the IL configuration), so every render kernel
runs once per step forward and the soft raster's backward kernel once per
step backward, and nothing is recomputed.
"""
import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

import torchdrivesim_tpu_torch.kinematic as K
from torchdrivesim_tpu_torch import tracing
from torchdrivesim_tpu_torch.lanelet2 import (
    Lanelet, LaneletMap, LaneletPoint, Linestring, road_mesh_from_lanelet_map,
)
from torchdrivesim_tpu_torch.mesh import BirdviewMesh
from torchdrivesim_tpu_torch.rendering.base import Cameras, RendererConfig
from torchdrivesim_tpu_torch.simulator import (
    NPCController, ReplayController, Simulator, SimulatorState, TorchDriveConfig,
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


def build_dataset_batch(dataset_path: str, location: Optional[str], batch: int,
                        horizon: int, device='cuda'
                        ) -> Tuple[BirdviewMesh, torch.Tensor, torch.Tensor,
                                   ReplayController]:
    """
    ``batch`` INTERACTION segments (``subsample(batch, seed=0)`` of the
    location's, or of every location's when ``location`` is None) as the
    example's scenario: each segment's ego (its first agent) is controlled
    and follows its recorded track as the expert, the other agents are
    replayed.

    Returns:
        (road mesh, host BirdviewMesh of batch B; initial ego states (B, 1,
         4); expert ego states (T, B, 1, 4) for T = min(horizon, frames -
         1); a ReplayController of agents 1..), the tensors on ``device``.
    """
    from torchdrivesim_tpu_torch.behavior.interaction import INTERACTIONDataset
    ds = INTERACTIONDataset(dataset_path,
                            location_names=[location] if location else None)
    ds.subsample(num_segments=batch, seed=0)
    data = INTERACTIONDataset.collate([ds[i] for i in range(len(ds))], device=device)
    gt, present = data['agent_states'], data['present_mask']     # B x A x T (x 4)
    horizon = min(horizon, gt.shape[2] - 1)
    expert = gt[:, 0, 1:horizon + 1].permute(1, 0, 2)[:, :, None].contiguous()
    npc = ReplayController(npc_size=data['agent_attributes'][:, 1:, :2],
                           npc_states=gt[:, 1:], npc_present_masks=present[:, 1:])
    return data['road_mesh'], gt[:, :1, 0].contiguous(), expert, npc


def build_synthetic_simulator(road: BirdviewMesh, states0: torch.Tensor,
                              res: int = 64, fov: float = 35.0,
                              npc_controller: Optional[NPCController] = None
                              ) -> Simulator:
    """The example's simulator: one simple-model ego per environment on the
    road mesh (and the NPCs of ``npc_controller``, drawn in every frame),
    the differentiable renderer at ``res`` and ``fov`` meters, on the
    device of ``states0``."""
    b = states0.shape[0]
    kin = K.SimpleKinematicModel(dt=0.1, device=states0.device)
    kin.set_state(states0)
    cfg = TorchDriveConfig(renderer=RendererConfig(differentiable=True))
    sim = Simulator(
        road_mesh=road, kinematic_model=kin,
        agent_size=torch.tensor([[[4.6, 2.0]]]).expand(b, 1, 2),
        initial_present_mask=torch.ones((b, 1), dtype=torch.bool), cfg=cfg,
        npc_controller=npc_controller)
    sim.renderer.res = Resolution(res, res)
    sim.renderer.scale = 2.0 / fov
    return sim


def ego_view(sim: Simulator, state: SimulatorState, scale: float):
    """Each environment's egocentric frame from its first agent: (the
    frame's mesh, as the renderer takes it: the actors, and the map mesh
    when the renderer has no texture, as ``Simulator.render`` decides; the
    cameras at ``scale``)."""
    all_state = torch.cat([state.agent_state, state.npc_state], dim=-2)
    present = torch.cat([state.present_mask, state.npc_present_mask], dim=-1)
    mesh = sim.birdview_mesh_generator.generate(
        1, agent_state=all_state[:, None], present_mask=present[:, None],
        include_background=sim.renderer.background_texture is None)
    ego = state.agent_state[:, 0]
    cameras = Cameras(ego[:, :2], torch.stack([torch.sin(ego[:, 2]),
                                               torch.cos(ego[:, 2])], dim=-1),
                      scale)
    return mesh, cameras


def render_ego(sim: Simulator, state: SimulatorState, res: int) -> torch.Tensor:
    """Each environment's differentiable egocentric view from its first
    agent (:func:`ego_view` at the renderer's scale), (B, 3, res, res) in
    [0, 255]."""
    mesh, cameras = ego_view(sim, state, sim.renderer.scale)
    return sim.renderer.render_rgb_mesh_chw(mesh, Resolution(res, res), cameras)


def policy_step(sim: Simulator, policy: torch.nn.Module, state: SimulatorState,
                res: int) -> SimulatorState:
    """One step of the rollout: the first agent's view (:func:`render_ego`),
    the policy's action for that agent (the span ``policy``), zero action
    for the others, and the kinematic step."""
    image = render_ego(sim, state, res)
    with tracing.span('policy'):
        action = policy(image)[:, None, :]                         # B x 1 x Ac
    rest = state.agent_state.shape[1] - 1
    if rest:
        action = torch.cat([action, action.new_zeros(
            (action.shape[0], rest, action.shape[2]))], dim=1)
    return sim.functional_step(state, action)


def make_bc_loss_fn(sim: Simulator, policy: torch.nn.Module, res: int,
                    teacher_forcing: bool = False
                    ) -> Callable[[SimulatorState, torch.Tensor], torch.Tensor]:
    """
    The behaviour-cloning loss: one rollout of T steps of
    :func:`policy_step`, and the mean squared error of the positions
    against the expert's. With ``teacher_forcing`` each step starts from
    the expert's frame: after the step the agents' states are replaced by
    the expert's, the predicted states kept for the loss. Nothing the
    policy computes then reaches a later frame, so the renders take no part
    in the backward pass.

    Returns:
        ``loss_fn(state0, expert) -> loss`` where ``expert`` is (T, B, A, 4).
    """
    def loss_fn(state0: SimulatorState, expert: torch.Tensor) -> torch.Tensor:
        state, preds = state0, []
        for target in expert:
            state = policy_step(sim, policy, state, res)
            preds.append(state.agent_state)
            if teacher_forcing:
                state = dataclasses.replace(state, agent_state=target)
        preds = torch.stack(preds)
        return torch.mean((preds[..., :2] - expert[..., :2]) ** 2)

    return loss_fn


def make_bc_train_step(sim: Simulator, policy: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, res: int,
                       teacher_forcing: bool = False
                       ) -> Callable[[SimulatorState, torch.Tensor], torch.Tensor]:
    """
    The behaviour-cloning training step: the loss of :func:`make_bc_loss_fn`
    (with ``teacher_forcing`` as there) and one optimizer step on its
    gradient.

    Returns:
        ``train_step(state0, expert) -> loss`` where ``expert`` is
        (T, B, A, 4); the loss is returned detached, before the update.
    """
    loss_fn = make_bc_loss_fn(sim, policy, res, teacher_forcing)

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
