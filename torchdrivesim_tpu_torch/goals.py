"""
Waypoint goals: the state of per-agent waypoint collections, its advance
on arrival, and the :class:`WaypointGoal` facade over them (counterpart of
``torchdrivesim_tpu/goals.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from torchdrivesim_tpu_torch.utils import as_batch_index, host_repeat


@dataclass
class WaypointGoalState:
    """Mutable waypoint-goal state."""
    state: torch.Tensor  #: BxAx1 int, current collection index
    mask: torch.Tensor   #: BxAxNxM bool, waypoints still active (padding excluded)


def gather_current(waypoints: torch.Tensor, goal_state: WaypointGoalState,
                   count: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Waypoints and masks of the current (and next ``count-1``) collections.

    Args:
        waypoints: BxAxNxMx2.
    Returns:
        (BxAx(count*M)x2 waypoints, BxAx(count*M) mask); out-of-range
        collections are masked off and zeroed.
    """
    b, a, n, m = waypoints.shape[:4]
    offsets = torch.arange(count, dtype=goal_state.state.dtype,
                           device=waypoints.device)
    idx = goal_state.state + offsets[None, None]          # BxAxcount
    valid = idx < n
    idx = torch.clamp(idx, 0, n - 1).long()
    wp = torch.gather(waypoints, 2, idx[..., None, None].expand(b, a, count, m, 2))
    mk = torch.gather(goal_state.mask, 2, idx[..., None].expand(b, a, count, m))
    mk = mk & valid[..., None]
    wp = torch.where(valid[..., None, None], wp, torch.zeros_like(wp))
    return wp.reshape(b, a, count * m, 2), mk.reshape(b, a, count * m)


def step_waypoints(waypoints: torch.Tensor, goal_state: WaypointGoalState,
                   agent_states: torch.Tensor, threshold: float = 2.0
                   ) -> WaypointGoalState:
    """
    Advance waypoint goals one step: an agent within ``threshold`` of any
    active waypoint of its current collection clears that collection and
    moves to the next one (clamped to the last).
    """
    n = waypoints.shape[2]
    current_wp, current_mask = gather_current(waypoints, goal_state, count=1)
    d2 = ((agent_states[..., None, :2] - current_wp) ** 2).sum(dim=-1)
    overlap = (d2 <= threshold ** 2) & current_mask            # BxAxM
    hit = overlap.any(dim=-1, keepdim=True)                    # BxAx1
    hit = hit & current_mask.any(dim=-1, keepdim=True)
    idx = torch.arange(n, device=waypoints.device)[None, None, :, None]
    clear = hit[..., None] & goal_state.mask & (idx == goal_state.state[..., None])
    new_state = torch.clamp(goal_state.state + hit.to(goal_state.state.dtype),
                            0, n - 1)
    return WaypointGoalState(state=new_state, mask=goal_state.mask & ~clear)


def init_waypoint_state(waypoints: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> WaypointGoalState:
    """Collection 0 current, every given waypoint active."""
    if mask is None:
        mask = torch.ones(waypoints.shape[:-1], dtype=torch.bool,
                          device=waypoints.device)
    state = torch.zeros(waypoints.shape[:2] + (1,), dtype=torch.int32,
                        device=waypoints.device)
    return WaypointGoalState(state=state, mask=mask)


class WaypointGoal:
    """
    Per-agent waypoint goals: the static BxAxNxMx2 ``waypoints`` (N
    collections of M waypoints each) and their :class:`WaypointGoalState`,
    advanced by :func:`step_waypoints`.

    Args:
        waypoints: BxAxNxMx2 tensor (or anything ``torch.as_tensor`` takes).
        mask: BxAxNxM bool, the waypoints that are not padding.
    """
    def __init__(self, waypoints, mask=None, *, device=None):
        self.waypoints = torch.as_tensor(waypoints, dtype=torch.float32,
                                         device=device)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool,
                                   device=self.waypoints.device)
        self._state = init_waypoint_state(self.waypoints, mask)
        self.max_goal_idx = self.waypoints.shape[2]

    @property
    def state(self) -> torch.Tensor:
        return self._state.state

    @state.setter
    def state(self, value):
        self._state = dataclasses.replace(self._state, state=value)

    @property
    def mask(self) -> torch.Tensor:
        return self._state.mask

    @mask.setter
    def mask(self, value):
        self._state = dataclasses.replace(self._state, mask=value)

    def get_waypoints(self, count: int = 1) -> torch.Tensor:
        """BxAx(count*M)x2: the current and next ``count - 1`` collections."""
        return gather_current(self.waypoints, self._state, count)[0]

    def get_masks(self, count: int = 1) -> torch.Tensor:
        """BxAx(count*M) bool masks of :meth:`get_waypoints`."""
        return gather_current(self.waypoints, self._state, count)[1]

    def step(self, agent_states: torch.Tensor, time: int = 0,
             threshold: float = 2.0) -> None:
        self._state = step_waypoints(self.waypoints, self._state, agent_states,
                                     threshold)

    def copy(self) -> "WaypointGoal":
        """A copy sharing the (never written) tensors."""
        other = self.__class__.__new__(self.__class__)
        other.__dict__.update(self.__dict__)
        return other

    def to(self, device=None) -> "WaypointGoal":
        return self

    def _map(self, f, in_place: bool) -> "WaypointGoal":
        target = self if in_place else self.copy()
        target.waypoints = f(self.waypoints)
        target._state = WaypointGoalState(state=f(self._state.state),
                                          mask=f(self._state.mask))
        return target

    def extend(self, n: int, in_place: bool = True) -> "WaypointGoal":
        return self._map(lambda x: host_repeat(x, n), in_place)

    def select_batch_elements(self, idx, in_place: bool = True) -> "WaypointGoal":
        idx = as_batch_index(idx, self.waypoints.device)
        return self._map(lambda x: x[idx], in_place)
