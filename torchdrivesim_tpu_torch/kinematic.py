"""
Kinematic models as pure functions over batched agent tensors (counterpart
of ``torchdrivesim_tpu/kinematic.py``).

Agent state is a ``(..., 4)`` tensor ``(x, y, psi, v)``. Each model is a
pure function ``step(state, action, params, dt)``; actions are normalized
and zero-padded to the 4-wide action buffer, so a model with a smaller
action space reads a prefix.

Heterogeneous agents (:class:`CompoundKinematicModel`) evaluate every model
in use on every agent and select each agent's result with ``torch.where``
keyed on its integer model id: no batch splitting, no data-dependent shapes
and no host synchronization in the step. The set of models in use is
computed on the host when the compound model is built, extended or
indexed, and passed to :func:`step`.

Per-channel scale factors are applied as Python scalars, never as tensors
built from Python lists, so a step issues no host-to-device copy and can be
captured in a CUDA graph.
"""
from __future__ import annotations

import copy as _copy
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from torchdrivesim_tpu_torch.utils import rotate

STATE_SIZE = 4   #: (x, y, psi, v)
ACTION_BUF = 4   #: unified action buffer width (max over models)

# Model ids, as in the reference (values of ``model_assignments``).
TELEPORT = 0                 #: the action is the next state
SIMPLE = 1                   #: the action is the normalized state derivative
ORIENTED = 2                 #: SIMPLE with the xy action in the agent frame
BICYCLE = 3                  #: kinematic bicycle, normalized (accel, steering)
BICYCLE_NO_REVERSING = 4     #: the bicycle that stops rather than reversing
BICYCLE_BY_DISPLACEMENT = 5  #: the bicycle driven by a velocity vector
BICYCLE_BY_ORIENTED_DISPLACEMENT = 6  #: its agent-frame variant
NUM_MODELS = 7

MODEL_ACTION_SIZE = {
    TELEPORT: 4, SIMPLE: 4, ORIENTED: 4, BICYCLE: 2, BICYCLE_NO_REVERSING: 2,
    BICYCLE_BY_DISPLACEMENT: 2, BICYCLE_BY_ORIENTED_DISPLACEMENT: 2,
}


@dataclasses.dataclass
class KinematicParams:
    """Per-agent rear-axis offset ``lr`` (broadcastable to the agent batch
    shape) plus the models' static limits and normalization factors."""
    lr: torch.Tensor
    dt: float = 0.1
    left_handed: bool = False
    max_acceleration: float = 5.0
    max_steering: float = float(np.pi / 2)
    max_dx: float = 20.0
    max_dpsi: float = float(10 * np.pi)
    max_dv: float = 5.0


def pack_state(x, y, psi, speed) -> torch.Tensor:
    """Stack state components into (..., 4)."""
    return torch.stack([x, y, psi, speed], dim=-1)


def unpack_state(state: torch.Tensor):
    """Split a (..., 4) state into (x, y, psi, speed)."""
    return state[..., 0], state[..., 1], state[..., 2], state[..., 3]


# ----------------------------------------------------------------------------
# Normalization
# ----------------------------------------------------------------------------

def _norm_factors(model_id: int, params: KinematicParams) -> Optional[Tuple[float, ...]]:
    if model_id in (SIMPLE, ORIENTED):
        return (params.max_dx, params.max_dx, params.max_dpsi, params.max_dv)
    if model_id in (BICYCLE, BICYCLE_NO_REVERSING):
        return (params.max_acceleration, params.max_steering)
    if model_id in (BICYCLE_BY_DISPLACEMENT, BICYCLE_BY_ORIENTED_DISPLACEMENT):
        return (params.max_dx, params.max_dx)
    return None


def _per_channel(action: torch.Tensor, factors, divide: bool) -> torch.Tensor:
    if action.shape[-1] != len(factors):
        raise ValueError(f'expected {len(factors)} action channels, got '
                         f'{action.shape[-1]}')
    chans = [action[..., k] / f if divide else action[..., k] * f
             for k, f in enumerate(factors)]
    return torch.stack(chans, dim=-1)


def normalize_action(model_id: int, action: torch.Tensor,
                     params: KinematicParams) -> torch.Tensor:
    """Scale a raw action into [-1, 1] units for the given model (the
    teleporting model's action passes unchanged)."""
    factors = _norm_factors(model_id, params)
    return action if factors is None else _per_channel(action, factors, True)


def denormalize_action(model_id: int, action: torch.Tensor,
                       params: KinematicParams) -> torch.Tensor:
    """Inverse of :func:`normalize_action`."""
    factors = _norm_factors(model_id, params)
    return action if factors is None else _per_channel(action, factors, False)


# ----------------------------------------------------------------------------
# Per-model step functions (state (..., 4), action (..., 4) padded)
# ----------------------------------------------------------------------------

def teleport_step(state: torch.Tensor, action: torch.Tensor,
                  params: KinematicParams, dt: float) -> torch.Tensor:
    """The action is the next state."""
    return action[..., :STATE_SIZE]


def simple_step(state: torch.Tensor, action: torch.Tensor,
                params: KinematicParams, dt: float) -> torch.Tensor:
    """The action is the normalized state derivative (dx, dy, dpsi, dv)."""
    return state + denormalize_action(SIMPLE, action[..., :4], params) * dt


def oriented_step(state: torch.Tensor, action: torch.Tensor,
                  params: KinematicParams, dt: float) -> torch.Tensor:
    """Like :func:`simple_step`, with the xy action in the agent frame."""
    xy = rotate(action[..., :2], state[..., 2:3])
    return simple_step(state, torch.cat([xy, action[..., 2:4]], dim=-1), params, dt)


def _bicycle_core(state: torch.Tensor, a: torch.Tensor, beta: torch.Tensor,
                  params: KinematicParams, dt: float) -> torch.Tensor:
    """Shared bicycle update. ``lr`` is sanitized against NaN and 0
    (pedestrians carry a NaN ``lr``): under the compute-all-and-select
    dispatch the bicycle runs on every agent, and a NaN here would reach
    the gradients of the other agents through ``torch.where``."""
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
    raw = denormalize_action(BICYCLE, action[..., :2], params)
    return _bicycle_core(state, raw[..., 0], raw[..., 1], params, dt)


def bicycle_no_reversing_step(state: torch.Tensor, action: torch.Tensor,
                              params: KinematicParams, dt: float) -> torch.Tensor:
    """The bicycle, with an acceleration that would reverse the agent
    replaced by the one that stops it (``-v / dt``)."""
    raw = denormalize_action(BICYCLE, action[..., :2], params)
    acc, v = raw[..., 0], state[..., 3]
    acc = torch.where(v + acc * dt < 0, -v / dt, acc)
    return _bicycle_core(state, acc, raw[..., 1], params, dt)


def bicycle_fit_action(future_state: torch.Tensor, current_state: torch.Tensor,
                       params: KinematicParams, dt: float) -> torch.Tensor:
    """Inverse bicycle dynamics with reversing: the normalized (accel,
    steering) that moves ``current_state`` towards ``future_state``'s
    position."""
    f_x, f_y = future_state[..., 0], future_state[..., 1]
    c_x, c_y, c_psi, c_v = current_state.unbind(-1)
    vx = (f_x - c_x) / dt
    vy = (f_y - c_y) / dt
    speed = torch.sqrt(vx ** 2 + vy ** 2)
    beta = torch.atan2(vy, vx) - c_psi * torch.sign(torch.abs(speed))
    beta = torch.remainder(beta + np.pi, 2 * np.pi) - np.pi
    reversing = torch.sign(torch.cos(beta)) == -1
    v = torch.where(reversing, -speed, speed)
    beta = torch.where(reversing, beta - np.pi * torch.sign(beta), beta)
    a = (v - c_v) / dt
    if params.left_handed:
        beta = -beta
    return normalize_action(BICYCLE, torch.stack([a, beta], dim=-1), params)


def bicycle_by_displacement_step(state: torch.Tensor, action: torch.Tensor,
                                 params: KinematicParams, dt: float) -> torch.Tensor:
    """The bicycle driven by a normalized world-frame velocity action: the
    bicycle action fitted to the displaced position, then stepped."""
    xy = action[..., :2] * params.max_dx
    x, y, psi, v = state.unbind(-1)
    target = torch.stack([x + xy[..., 0] * dt, y + xy[..., 1] * dt, psi, v], dim=-1)
    return bicycle_step(state, bicycle_fit_action(target, state, params, dt),
                        params, dt)


def bicycle_by_oriented_displacement_step(state: torch.Tensor, action: torch.Tensor,
                                          params: KinematicParams,
                                          dt: float) -> torch.Tensor:
    """Agent-frame variant of :func:`bicycle_by_displacement_step`."""
    xy = rotate(action[..., :2], state[..., 2:3])
    return bicycle_by_displacement_step(
        state, torch.cat([xy, action[..., 2:]], dim=-1), params, dt)


_STEP_FNS = {
    TELEPORT: teleport_step,
    SIMPLE: simple_step,
    ORIENTED: oriented_step,
    BICYCLE: bicycle_step,
    BICYCLE_NO_REVERSING: bicycle_no_reversing_step,
    BICYCLE_BY_DISPLACEMENT: bicycle_by_displacement_step,
    BICYCLE_BY_ORIENTED_DISPLACEMENT: bicycle_by_oriented_displacement_step,
}


# ----------------------------------------------------------------------------
# Per-model fit_action functions
# ----------------------------------------------------------------------------

def teleport_fit_action(future_state, current_state, params, dt):
    return future_state


def simple_fit_action(future_state, current_state, params, dt):
    return normalize_action(SIMPLE, (future_state - current_state) / dt, params)


def oriented_fit_action(future_state, current_state, params, dt):
    parent = simple_fit_action(future_state, current_state, params, dt)
    xy = rotate(parent[..., :2], -current_state[..., 2:3])
    return torch.cat([xy, parent[..., 2:]], dim=-1)


def bicycle_by_displacement_fit_action(future_state, current_state, params, dt):
    dx = (future_state[..., 0] - current_state[..., 0]) / dt
    dy = (future_state[..., 1] - current_state[..., 1]) / dt
    return torch.stack([dx, dy], dim=-1) / params.max_dx


def bicycle_by_oriented_displacement_fit_action(future_state, current_state,
                                                params, dt):
    action = bicycle_by_displacement_fit_action(future_state, current_state,
                                                params, dt)
    return rotate(action[..., :2], -current_state[..., 2:3])


_FIT_FNS = {
    TELEPORT: teleport_fit_action,
    SIMPLE: simple_fit_action,
    ORIENTED: oriented_fit_action,
    BICYCLE: bicycle_fit_action,
    BICYCLE_NO_REVERSING: bicycle_fit_action,
    BICYCLE_BY_DISPLACEMENT: bicycle_by_displacement_fit_action,
    BICYCLE_BY_ORIENTED_DISPLACEMENT: bicycle_by_oriented_displacement_fit_action,
}


# ----------------------------------------------------------------------------
# Dispatch: one model, or compute-all-and-select over per-agent model ids
# ----------------------------------------------------------------------------

def _pad_action(action: torch.Tensor) -> torch.Tensor:
    pad = ACTION_BUF - action.shape[-1]
    if pad > 0:
        action = torch.cat([action, action.new_zeros(action.shape[:-1] + (pad,))],
                           dim=-1)
    return action


def _models(models: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """The models a per-agent dispatch evaluates, in ascending id order:
    ``models`` (the ids in use, known on the host) or every model."""
    return tuple(range(NUM_MODELS)) if models is None else tuple(sorted(set(models)))


def _check_model(model_id) -> None:
    if model_id not in _STEP_FNS:
        raise ValueError(f'unknown kinematic model id {model_id!r}')


def step(state: torch.Tensor, action: torch.Tensor, params: KinematicParams,
         dt: Optional[float] = None, single_model: int = BICYCLE,
         model_ids: Optional[torch.Tensor] = None,
         models: Optional[Sequence[int]] = None) -> torch.Tensor:
    """
    Advance agent states one step.

    Args:
        state: (..., 4) agent states.
        action: (..., Ac) normalized actions, Ac any model's action size or
            the 4-wide buffer.
        params: kinematic parameters.
        dt: time delta, ``params.dt`` by default.
        single_model: the model of every agent when ``model_ids`` is None.
        model_ids: (...) int tensor of per-agent model ids: every model in
            ``models`` (every model when None) runs on every agent, in
            ascending id order, and each agent takes its own model's result
            (its state unchanged if no evaluated model is its own). A single
            model in ``models`` returns its result for all agents.
        models: the model ids in use, known on the host.
    Returns:
        (..., 4) next states.
    """
    dt = params.dt if dt is None else dt
    action = _pad_action(action)
    if model_ids is None:
        _check_model(single_model)
        return _STEP_FNS[single_model](state, action, params, dt)
    used = _models(models)
    out = state
    for mid in used:
        _check_model(mid)
        candidate = _STEP_FNS[mid](state, action, params, dt)
        if len(used) == 1:
            return candidate
        out = torch.where((model_ids == mid)[..., None], candidate, out)
    return out


def fit_action(future_state: torch.Tensor, current_state: torch.Tensor,
               params: KinematicParams, dt: Optional[float] = None,
               single_model: int = BICYCLE,
               model_ids: Optional[torch.Tensor] = None,
               models: Optional[Sequence[int]] = None) -> torch.Tensor:
    """
    Inverse dynamics: the normalized action that would (approximately) move
    ``current_state`` to ``future_state``, zero-padded to the 4-wide buffer;
    per agent by ``model_ids`` as in :func:`step` (zeros for an agent no
    evaluated model owns).
    """
    dt = params.dt if dt is None else dt
    if model_ids is None:
        _check_model(single_model)
        return _pad_action(_FIT_FNS[single_model](future_state, current_state,
                                                  params, dt))
    out = future_state.new_zeros(future_state.shape[:-1] + (ACTION_BUF,))
    for mid in _models(models):
        _check_model(mid)
        candidate = _pad_action(_FIT_FNS[mid](future_state, current_state, params, dt))
        out = torch.where((model_ids == mid)[..., None], candidate, out)
    return out


# ----------------------------------------------------------------------------
# Object facade (the reference's class names; explicit state and device)
# ----------------------------------------------------------------------------

def _default_params(device, dt: float, **limits) -> KinematicParams:
    return KinematicParams(lr=torch.ones((), device=device), dt=dt,
                           **{k: float(v) for k, v in limits.items()})


def _repeat(x: torch.Tensor, n: int) -> torch.Tensor:
    """Every batch element repeated ``n`` times contiguously; a 0-dim
    tensor (a parameter shared by every agent) as it is."""
    return x if x.dim() == 0 else torch.repeat_interleave(x, n, dim=0)


class KinematicModel:
    """
    Facade holding a model's state and parameters on ``device`` and
    delegating to the pure functions above. Methods that change the model
    rebind its attributes and never write into shared tensors, so a shallow
    copy (:meth:`copy`) is independent.
    """
    model_id = SIMPLE

    def __init__(self, params: KinematicParams, device):
        self.dt = params.dt
        self.device = torch.device(device)
        self.state: Optional[torch.Tensor] = None
        self.params = params

    @property
    def action_size(self) -> int:
        return MODEL_ACTION_SIZE[self.model_id]

    @property
    def state_size(self) -> int:
        return STATE_SIZE

    @property
    def batch_size(self) -> int:
        """Agents in the state's batch dimensions (0 without a state)."""
        return int(np.prod(self.state.shape[:-1])) if self.state is not None else 0

    pack_state = staticmethod(pack_state)
    unpack_state = staticmethod(unpack_state)

    def flattening(self, batch_shape) -> None:
        """Flatten the batch dimensions of a per-agent ``lr``."""
        if self.params.lr.dim() > 1:
            self.params = dataclasses.replace(self.params, lr=self.params.lr.reshape(-1))

    def unflattening(self, batch_shape) -> None:
        """Give a per-agent ``lr`` the batch shape ``batch_shape`` again."""
        if self.params.lr.dim() >= 1:
            self.params = dataclasses.replace(
                self.params, lr=self.params.lr.reshape(tuple(batch_shape)))

    def map_param(self, f) -> None:
        """Apply ``f`` to the per-agent parameter ``lr``."""
        self.params = dataclasses.replace(self.params, lr=f(self.params.lr))

    def to(self, device) -> "KinematicModel":
        """Move the state and parameters to ``device`` (in place); returns
        the model."""
        self.device = torch.device(device)
        if self.state is not None:
            self.state = self.state.to(self.device)
        self.params = dataclasses.replace(self.params, lr=self.params.lr.to(self.device))
        return self

    def set_state(self, state) -> None:
        self.state = torch.as_tensor(state, dtype=torch.float32,
                                     device=self.device)

    def get_state(self) -> torch.Tensor:
        return self.state

    def get_params(self) -> dict:
        """The model's named per-agent parameters."""
        return {}

    def set_params(self, **kwargs) -> None:
        """Set named parameters; a name the model does not have raises
        instead of being dropped."""
        known = self.get_params()
        unknown = sorted(k for k in kwargs if k not in known)
        if unknown:
            raise ValueError(
                f'{type(self).__name__} does not accept kinematic parameters '
                f'{unknown}; known parameters: {sorted(known)}')
        if 'lr' in kwargs:
            self.params = dataclasses.replace(
                self.params, lr=torch.as_tensor(kwargs['lr'], dtype=torch.float32,
                                                device=self.device))

    def step(self, action, dt: Optional[float] = None) -> None:
        self.state = step(self.state, torch.as_tensor(action, device=self.device),
                          self.params, dt, single_model=self.model_id)

    def fit_action(self, future_state, current_state=None,
                   dt: Optional[float] = None) -> torch.Tensor:
        """The normalized action of :func:`fit_action`, cut to the model's
        action size."""
        current = self.state if current_state is None else current_state
        act = fit_action(torch.as_tensor(future_state, device=self.device),
                         torch.as_tensor(current, device=self.device), self.params,
                         dt, single_model=self.model_id)
        return act[..., :self.action_size]

    def normalize_action(self, action: torch.Tensor) -> torch.Tensor:
        return normalize_action(self.model_id, action, self.params)

    def denormalize_action(self, action: torch.Tensor) -> torch.Tensor:
        return denormalize_action(self.model_id, action, self.params)

    def copy(self) -> "KinematicModel":
        """A shallow copy sharing the state and parameter tensors."""
        return _copy.copy(self)

    def extend(self, n: int) -> None:
        """Repeat every batch element of the state and of a batched ``lr``
        ``n`` times contiguously."""
        self.state = _repeat(self.state, n)
        self.params = dataclasses.replace(self.params, lr=_repeat(self.params.lr, n))

    def select_batch_elements(self, idx) -> None:
        """Keep the batch elements ``idx`` (a list, array or tensor of
        indices) of the state and of a batched ``lr``."""
        idx = torch.as_tensor(np.asarray(idx) if not torch.is_tensor(idx) else idx,
                              dtype=torch.int64, device=self.device)
        self.state = self.state[idx]
        if self.params.lr.dim() > 0:
            self.params = dataclasses.replace(self.params, lr=self.params.lr[idx])


class TeleportingKinematicModel(KinematicModel):
    """The action is the next state."""
    model_id = TELEPORT

    def __init__(self, dt: float = 0.1, *, device):
        super().__init__(_default_params(device, dt), device)


class SimpleKinematicModel(KinematicModel):
    """The action is the normalized state derivative."""
    model_id = SIMPLE

    def __init__(self, max_dx: float = 20, max_dpsi: float = 10 * np.pi,
                 max_dv: float = 5, dt: float = 0.1, *, device):
        super().__init__(_default_params(device, dt, max_dx=max_dx, max_dpsi=max_dpsi,
                                         max_dv=max_dv), device)


class OrientedKinematicModel(SimpleKinematicModel):
    """The simple model with its xy action in the agent frame."""
    model_id = ORIENTED


class KinematicBicycle(KinematicModel):
    """The kinematic bicycle; ``lr`` per agent via :meth:`set_params`."""
    model_id = BICYCLE

    def __init__(self, max_acceleration: float = 5.0,
                 max_steering: float = float(np.pi / 2), dt: float = 0.1,
                 left_handed: bool = False, *, device):
        super().__init__(_default_params(device, dt, max_acceleration=max_acceleration,
                                         max_steering=max_steering), device)
        self.params = dataclasses.replace(self.params, left_handed=bool(left_handed))

    @property
    def left_handed(self) -> bool:
        return self.params.left_handed

    @left_handed.setter
    def left_handed(self, value: bool) -> None:
        self.params = dataclasses.replace(self.params, left_handed=bool(value))

    def get_params(self) -> dict:
        return {'lr': self.params.lr}

    def set_params(self, **kwargs) -> None:
        if 'lr' not in kwargs:
            raise ValueError(f'{type(self).__name__}.set_params needs lr')
        super().set_params(**kwargs)


class BicycleNoReversing(KinematicBicycle):
    """The kinematic bicycle that stops at zero speed instead of reversing."""
    model_id = BICYCLE_NO_REVERSING


class BicycleByDisplacement(KinematicBicycle):
    """The bicycle driven by a normalized world-frame velocity action."""
    model_id = BICYCLE_BY_DISPLACEMENT

    def __init__(self, max_dx: float = 20, dt: float = 0.1, *, device):
        super().__init__(dt=dt, device=device)
        self.params = dataclasses.replace(self.params, max_dx=float(max_dx))

    def step_from_xy(self, xy, dt: Optional[float] = None) -> None:
        """Step from the first two action channels, ignoring any others."""
        self.state = step(self.state, torch.as_tensor(xy, device=self.device)[..., :2],
                          self.params, dt, single_model=self.model_id)


class BicycleByOrientedDisplacement(BicycleByDisplacement):
    """Agent-frame variant of :class:`BicycleByDisplacement`."""
    model_id = BICYCLE_BY_ORIENTED_DISPLACEMENT


class CompoundKinematicModel(KinematicModel):
    """
    Heterogeneous agents: ``model_assignments`` holds each agent's model id
    (the module's constants), and every model in use runs on every agent
    with each agent's own result selected (:func:`step` with
    ``model_ids``). All models read one shared :class:`KinematicParams`, so
    ``lr`` (the bicycle family's) is its one named parameter.

    :attr:`models_in_use` is computed on the host from the assignments
    given, here and in :meth:`extend` and :meth:`select_batch_elements`, so
    the step never reads the ids back from the device.
    """
    #: as the reference's compound: its normalization is the simple
    #: model's, over the 4-wide action buffer
    model_id = SIMPLE

    def __init__(self, model_assignments, params: Optional[KinematicParams] = None,
                 dt: float = 0.1, *, device):
        if params is None:
            params = _default_params(device, dt)
        else:
            params = dataclasses.replace(params, dt=dt)
        super().__init__(params, device)
        self._set_assignments(np.asarray(model_assignments, dtype=np.int64))

    def _set_assignments(self, ids: np.ndarray) -> None:
        for mid in np.unique(ids):
            _check_model(int(mid))
        self._host_assignments = ids
        self.models_in_use: Tuple[int, ...] = tuple(int(i) for i in np.unique(ids))
        self.model_assignments = torch.as_tensor(ids, device=self.device)

    @property
    def action_size(self) -> int:
        return ACTION_BUF

    @property
    def batch_assignments(self) -> torch.Tensor:
        """The model ids flattened."""
        return self.model_assignments.reshape(-1)

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.model_assignments.shape)

    def to(self, device) -> "CompoundKinematicModel":
        super().to(device)
        self.model_assignments = self.model_assignments.to(self.device)
        return self

    def get_params(self) -> dict:
        return {'lr': self.params.lr}

    def step(self, action, dt: Optional[float] = None) -> None:
        self.state = step(self.state, torch.as_tensor(action, device=self.device),
                          self.params, dt, model_ids=self.model_assignments,
                          models=self.models_in_use)

    def fit_action(self, future_state, current_state=None,
                   dt: Optional[float] = None) -> torch.Tensor:
        current = self.state if current_state is None else current_state
        return fit_action(torch.as_tensor(future_state, device=self.device),
                          torch.as_tensor(current, device=self.device), self.params,
                          dt, model_ids=self.model_assignments,
                          models=self.models_in_use)

    def extend(self, n: int) -> None:
        super().extend(n)
        self._set_assignments(np.repeat(self._host_assignments, n, axis=0))

    def select_batch_elements(self, idx) -> None:
        super().select_batch_elements(idx)
        host_idx = idx.cpu().numpy() if torch.is_tensor(idx) else np.asarray(idx)
        self._set_assignments(self._host_assignments[host_idx])
