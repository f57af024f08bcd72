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
from torchdrivesim_tpu_torch.utils import time_slice

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

    def extend(self, n: int) -> "BaseTrafficControl":
        """A copy with every batch element repeated ``n`` times."""
        other = self.__class__.__new__(self.__class__)
        other.__dict__.update(self.__dict__)
        for name in ('pos', 'corners', 'mask', 'replay_states', 'state'):
            setattr(other, name,
                    torch.repeat_interleave(getattr(self, name), n, dim=0))
        return other

    def compute_state(self, state: torch.Tensor, time: torch.Tensor
                      ) -> torch.Tensor:
        """Subclass hook for self-driven state. Default: hold."""
        return state

    def advance(self, state: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        """The control state advance: replay -> compute_state -> hold."""
        return replay_or_hold_state(self.compute_state(state, time),
                                    self.replay_states, time)


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
