"""
Traffic controls: static rectangular stoplines with discrete state
(counterpart of ``torchdrivesim_tpu/traffic_controls.py``).

The state advance (replay, then the control's own ``compute_state``, e.g. a
baked FSM schedule, then hold) and the red-light check are pure tensor
functions; the classes hold the static stopline tensors.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from torchdrivesim_tpu_torch.ops.box import (
    box2corners, box2corners_with_rear_factor, boxes_overlap_sat_cross,
)
from torchdrivesim_tpu_torch.utils import as_batch_index, host_repeat, time_slice

#: far-away placeholder for masked stopline corners
MASKED_CORNER_VALUE = -1000.0


def masked_corners(pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Stopline corners (BxNx4x2) with absent entries displaced far away."""
    corners = box2corners(pos)
    m = mask.to(corners.dtype)[..., None, None]
    return corners * m + (1 - m) * MASKED_CORNER_VALUE


def replay_or_hold_state(state: torch.Tensor, replay_states: torch.Tensor,
                         time: torch.Tensor) -> torch.Tensor:
    """
    While ``time`` is within the replay horizon use the recorded state,
    otherwise hold the current one.

    Args:
        state: BxN current state indices.
        replay_states: BxNxT recorded states (T may be 0).
        time: scalar step index tensor.
    """
    total = replay_states.shape[-1]
    if total == 0:
        return state
    replayed = time_slice(replay_states, time, dim=-1)
    return torch.where(time < total, replayed, state)


def red_light_violations(agent_state: torch.Tensor, light_corners: torch.Tensor,
                         light_state: torch.Tensor, red_index: int,
                         rear_factor: float = 0.1) -> torch.Tensor:
    """
    Which agents overlap a red stopline, batched over agents x lights.

    Args:
        agent_state: BxAx5 agent boxes (x, y, length, width, orientation).
        light_corners: BxNx4x2 stopline corners (masked entries far away).
        light_state: BxN state indices.
    Returns:
        BxA boolean violation flags.
    """
    b, a = agent_state.shape[0], agent_state.shape[1]
    n = light_corners.shape[1]
    if a == 0 or n == 0 or b == 0:
        return torch.zeros((b, a), dtype=torch.bool, device=agent_state.device)
    agent_corners = box2corners_with_rear_factor(agent_state, rear_factor)
    overlap = boxes_overlap_sat_cross(agent_corners, light_corners)
    is_red = (light_state == red_index)[:, None]          # B x 1 x N
    return (overlap & is_red).any(dim=-1)


class BaseTrafficControl:
    """
    Stoplines of one kind.

    Args:
        pos: BxNx5 stopline tensor (x, y, length, width, orientation).
        allowed_states: state names, e.g. light colors.
        replay_states: BxNxT recorded state indices (default T=0).
        mask: BxN presence flags.
    """
    def __init__(self, pos, allowed_states: Optional[List[str]] = None,
                 replay_states=None, mask=None, *, device):
        device = torch.device(device)
        self.pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
        self.allowed_states = allowed_states if allowed_states is not None \
            else self._default_allowed_states()
        self.replay_states = (
            torch.as_tensor(replay_states, dtype=torch.int32, device=device)
            if replay_states is not None else
            torch.zeros(self.pos.shape[:2] + (0,), dtype=torch.int32,
                        device=device))
        self.mask = (torch.as_tensor(mask, dtype=torch.bool, device=device)
                     if mask is not None else
                     torch.ones(self.pos.shape[:2], dtype=torch.bool,
                                device=device))
        self.corners = masked_corners(self.pos, self.mask)
        self.state = self._default_state()

    @classmethod
    def _default_allowed_states(cls) -> List[str]:
        return ['none']

    def _default_state(self) -> torch.Tensor:
        if self.replay_states.shape[-1] > 0:
            return self.replay_states[..., 0]
        return torch.zeros(self.pos.shape[:2], dtype=torch.int32,
                           device=self.pos.device)

    @property
    def total_replay_time(self) -> int:
        return self.replay_states.shape[-1]

    #: the batched tensors that ``extend`` and ``select_batch_elements`` map
    _BATCHED = ('pos', 'corners', 'mask', 'replay_states', 'state')

    def copy(self) -> "BaseTrafficControl":
        """A copy sharing the (never written) tensors: every change rebinds
        an attribute. Unlike the reference's, it keeps ``actor_ids`` and a
        light schedule."""
        other = self.__class__.__new__(self.__class__)
        other.__dict__.update(self.__dict__)
        other.allowed_states = list(self.allowed_states)
        return other

    def to(self, device=None) -> "BaseTrafficControl":
        return self

    def _map(self, f, in_place: bool) -> "BaseTrafficControl":
        target = self if in_place else self.copy()
        for name in self._BATCHED:
            setattr(target, name, f(getattr(self, name)))
        return target

    def extend(self, n: int, in_place: bool = True) -> "BaseTrafficControl":
        """Every batch element repeated ``n`` times contiguously: this
        control, or with ``in_place=False`` a copy."""
        return self._map(lambda x: host_repeat(x, n), in_place)

    def select_batch_elements(self, idx, in_place: bool = True
                              ) -> "BaseTrafficControl":
        """The batch elements ``idx``: this control, or with
        ``in_place=False`` a copy."""
        idx = as_batch_index(idx, self.pos.device)
        return self._map(lambda x: x[idx], in_place)

    def set_state(self, state: torch.Tensor) -> None:
        self.state = state

    def compute_state(self, state: torch.Tensor, time: torch.Tensor
                      ) -> torch.Tensor:
        """Subclass hook for self-driven state. Default: hold."""
        return state

    def advance(self, state: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        """The control state advance: replay -> compute_state -> hold."""
        return replay_or_hold_state(self.compute_state(state, time),
                                    self.replay_states, time)

    def step(self, time) -> None:
        """Advance :attr:`state` to ``time`` (an int or a 0-dim tensor)."""
        self.state = self.advance(self.state, torch.as_tensor(
            time, dtype=torch.int32, device=self.pos.device))

    def compute_violation(self, agent_state: torch.Tensor) -> torch.Tensor:
        """Base controls report no violations: (B, A) False."""
        return torch.zeros(agent_state.shape[:2], dtype=torch.bool,
                           device=agent_state.device)


class TrafficLightControl(BaseTrafficControl):
    """
    Traffic lights; violation = red light and box overlap with the stopline.
    Optionally driven by a :class:`BakedLightSchedule` (:meth:`set_schedule`).
    """
    violation_rear_factor = 0.1

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.schedule = None
        self.dt = None

    @classmethod
    def _default_allowed_states(cls) -> List[str]:
        return ['red', 'yellow', 'green']

    def set_schedule(self, schedule, dt: float) -> None:
        if schedule is not None:
            n = self.pos.shape[1]
            assert len(schedule.light_ids) == n, \
                f"schedule drives {len(schedule.light_ids)} lights, control has {n}"
        self.schedule = schedule
        self.dt = dt

    def compute_state(self, state: torch.Tensor, time: torch.Tensor
                      ) -> torch.Tensor:
        if self.schedule is None:
            return state
        lights = self.schedule.states_at(time.to(torch.float32) * self.dt)
        return torch.broadcast_to(lights[None], state.shape).to(state.dtype)

    def compute_violation(self, agent_state: torch.Tensor) -> torch.Tensor:
        """(B, A) agents of (B, A, 5) boxes overlapping a red stopline."""
        return red_light_violations(
            agent_state, self.corners, self.state,
            red_index=self.allowed_states.index('red'),
            rear_factor=self.violation_rear_factor)


class YieldControl(BaseTrafficControl):
    """Yield signs; no violations are computed."""


class StopSignControl(BaseTrafficControl):
    """Stop signs; no violations are computed."""
