"""
Kinematic models as pure functions over batched agent tensors (counterpart
of ``torchdrivesim_tpu/kinematic.py``; the single-model bicycle path of the
env step, the no-reversing bicycle of the RL environment and the simple
model of the behaviour-cloning example).

Agent state is a ``(..., 4)`` tensor ``(x, y, psi, v)``. Bicycle actions are
normalized ``(accel, steering)``; simple-model actions are the normalized
state derivative ``(dx, dy, dpsi, dv)``. Shorter actions are zero-padded to
the reference's 4-wide action buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

SIMPLE = 1           #: model id of the simple model, as in the reference
BICYCLE = 3          #: model id of the kinematic bicycle, as in the reference
BICYCLE_NO_REVERSING = 4   #: the bicycle that stops rather than reversing
ACTION_BUF = 4       #: unified action buffer width


@dataclasses.dataclass
class KinematicParams:
    """Per-agent rear-axis offset ``lr`` plus the bicycle's static limits."""
    lr: torch.Tensor
    dt: float = 0.1
    left_handed: bool = False
    max_acceleration: float = 5.0
    max_steering: float = float(np.pi / 2)
    max_dx: float = 20.0
    max_dpsi: float = float(10 * np.pi)
    max_dv: float = 5.0


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


def bicycle_no_reversing_step(state: torch.Tensor, action: torch.Tensor,
                              params: KinematicParams, dt: float) -> torch.Tensor:
    """The bicycle, with an acceleration that would reverse the agent
    replaced by the one that stops it (``-v / dt``)."""
    acc = action[..., 0] * params.max_acceleration
    v = state[..., 3]
    acc = torch.where(v + acc * dt < 0, -v / dt, acc)
    return _bicycle_core(state, acc, action[..., 1] * params.max_steering,
                         params, dt)


def simple_step(state: torch.Tensor, action: torch.Tensor,
                params: KinematicParams, dt: float) -> torch.Tensor:
    """The action is the normalized state derivative (dx, dy, dpsi, dv)."""
    scale = (params.max_dx, params.max_dx, params.max_dpsi, params.max_dv)
    deriv = torch.stack([action[..., k] * scale[k] for k in range(4)], dim=-1)
    return state + deriv * dt


_STEP_FNS = {SIMPLE: simple_step, BICYCLE: bicycle_step,
             BICYCLE_NO_REVERSING: bicycle_no_reversing_step}


def _pad_action(action: torch.Tensor) -> torch.Tensor:
    pad = ACTION_BUF - action.shape[-1]
    if pad > 0:
        action = torch.cat([action, action.new_zeros(action.shape[:-1] + (pad,))],
                           dim=-1)
    return action


def step(state: torch.Tensor, action: torch.Tensor, params: KinematicParams,
         dt: Optional[float] = None, single_model: int = BICYCLE
         ) -> torch.Tensor:
    """
    Advance agent states one step with one model for every agent.

    The simple model, the bicycle and the no-reversing bicycle are ported;
    the other models and the heterogeneous (per-agent model id) dispatch of
    the reference are not.
    """
    if single_model not in _STEP_FNS:
        raise NotImplementedError(f"kinematic model {single_model} is not ported")
    return _STEP_FNS[single_model](state, _pad_action(action), params,
                                   params.dt if dt is None else dt)


class KinematicModel:
    """
    Object facade holding a model's state and parameters on ``device`` (the
    reference's ``KinematicModel`` interface, subset used by the port).
    """
    model_id = BICYCLE

    def __init__(self, params: KinematicParams, device):
        self.dt = params.dt
        self.device = torch.device(device)
        self.state: Optional[torch.Tensor] = None
        self.params = params

    def set_state(self, state) -> None:
        self.state = torch.as_tensor(state, dtype=torch.float32,
                                     device=self.device)

    def get_state(self) -> torch.Tensor:
        return self.state

    def extend(self, n: int) -> None:
        """Repeat every batch element of the state and of a batched ``lr``
        ``n`` times contiguously."""
        self.state = torch.repeat_interleave(self.state, n, dim=0)
        if self.params.lr.dim() > 0:
            self.params = dataclasses.replace(
                self.params, lr=torch.repeat_interleave(self.params.lr, n, dim=0))


class SimpleKinematicModel(KinematicModel):
    """The action is the normalized state derivative."""
    model_id = SIMPLE

    def __init__(self, max_dx: float = 20, max_dpsi: float = 10 * np.pi,
                 max_dv: float = 5, dt: float = 0.1, *, device):
        super().__init__(KinematicParams(
            lr=torch.ones((), device=device), dt=dt, max_dx=float(max_dx),
            max_dpsi=float(max_dpsi), max_dv=float(max_dv)), device)


class KinematicBicycle(KinematicModel):
    """The kinematic bicycle; ``lr`` per agent via :meth:`set_params`."""
    model_id = BICYCLE

    def __init__(self, max_acceleration: float = 5.0,
                 max_steering: float = float(np.pi / 2), dt: float = 0.1,
                 left_handed: bool = False, *, device):
        super().__init__(KinematicParams(
            lr=torch.ones((), device=device), dt=dt, left_handed=left_handed,
            max_acceleration=float(max_acceleration),
            max_steering=float(max_steering)), device)

    def set_params(self, lr) -> None:
        self.params = dataclasses.replace(
            self.params, lr=torch.as_tensor(lr, dtype=torch.float32,
                                            device=self.device))


class BicycleNoReversing(KinematicBicycle):
    """The kinematic bicycle that stops at zero speed instead of reversing."""
    model_id = BICYCLE_NO_REVERSING
