"""
Waypoint goals: the state of per-agent waypoint collections and its advance
on arrival (counterpart of the pure functions of
``torchdrivesim_tpu/goals.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


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
