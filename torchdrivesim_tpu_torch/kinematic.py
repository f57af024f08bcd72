"""
Kinematic bicycle model as pure functions over batched agent tensors
(counterpart of ``torchdrivesim_tpu/kinematic.py``; the single-model bicycle
path of the env step).

Agent state is a ``(..., 4)`` tensor ``(x, y, psi, v)``; actions are
normalized ``(accel, steering)`` in [-1, 1] units, optionally padded to the
reference's 4-wide action buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

BICYCLE = 3          #: model id of the kinematic bicycle, as in the reference


@dataclasses.dataclass
class KinematicParams:
    """Per-agent rear-axis offset ``lr`` plus the bicycle's static limits."""
    lr: torch.Tensor
    dt: float = 0.1
    left_handed: bool = False
    max_acceleration: float = 5.0
    max_steering: float = float(np.pi / 2)


def _bicycle_core(state: torch.Tensor, a: torch.Tensor, beta: torch.Tensor,
                  params: KinematicParams, dt: float) -> torch.Tensor:
    """Shared bicycle update; ``lr`` is sanitized against NaN and 0."""
    if params.left_handed:
        beta = -beta
    x, y, psi, v = state.unbind(-1)
    lr = torch.broadcast_to(params.lr, v.shape)
    lr = torch.where(torch.isnan(lr) | (lr == 0), torch.ones_like(lr), lr)
    v = v + a * dt
    x = x + v * torch.cos(psi + beta) * dt
    y = y + v * torch.sin(psi + beta) * dt
    psi = psi + (v / lr) * torch.sin(beta) * dt
    return torch.stack([x, y, psi, v], dim=-1)


def bicycle_step(state: torch.Tensor, action: torch.Tensor,
                 params: KinematicParams, dt: float) -> torch.Tensor:
    """Kinematic bicycle step; ``action`` is normalized (accel, steering)."""
    return _bicycle_core(state, action[..., 0] * params.max_acceleration,
                         action[..., 1] * params.max_steering, params, dt)


def step(state: torch.Tensor, action: torch.Tensor, params: KinematicParams,
         dt: Optional[float] = None, single_model: int = BICYCLE
         ) -> torch.Tensor:
    """
    Advance agent states one step with one model for every agent.

    Only the bicycle is ported; the heterogeneous (per-agent model id)
    dispatch of the reference is not.
    """
    if single_model != BICYCLE:
        raise NotImplementedError(f"kinematic model {single_model} is not ported")
    return bicycle_step(state, action, params, params.dt if dt is None else dt)


class KinematicBicycle:
    """
    Object facade holding the bicycle's state and parameters (the
    reference's ``KinematicBicycle`` interface, subset used by the
    benchmark).
    """
    def __init__(self, max_acceleration: float = 5.0,
                 max_steering: float = float(np.pi / 2), dt: float = 0.1,
                 left_handed: bool = False, device='cpu'):
        self.dt = dt
        self.device = torch.device(device)
        self.state: Optional[torch.Tensor] = None
        self.params = KinematicParams(
            lr=torch.ones((), device=self.device), dt=dt,
            left_handed=left_handed, max_acceleration=float(max_acceleration),
            max_steering=float(max_steering))

    def set_params(self, lr) -> None:
        self.params = dataclasses.replace(
            self.params, lr=torch.as_tensor(lr, dtype=torch.float32,
                                            device=self.device))

    def set_state(self, state) -> None:
        self.state = torch.as_tensor(state, dtype=torch.float32,
                                     device=self.device)

    def get_state(self) -> torch.Tensor:
        return self.state
