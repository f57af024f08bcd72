"""The kinematic bicycle (TorchDriveSim's, normalized actions) and the
traffic-light FSMs, plainly."""
from fractions import Fraction
from typing import List

import torch

MAX_ACCELERATION = 5.0
MAX_STEERING = 1.5707963267948966     # pi / 2


def bicycle_step(state: torch.Tensor, action: torch.Tensor, lr: torch.Tensor,
                 dt: float, left_handed: bool) -> torch.Tensor:
    """One step of (..., 4) states (x, y, psi, v) under (..., 2) actions in
    [-1, 1] (acceleration, steering), rear axle ``lr`` (...)."""
    a = action[..., 0] * MAX_ACCELERATION
    beta = action[..., 1] * MAX_STEERING
    if left_handed:
        beta = -beta
    x, y, psi, v = state.unbind(-1)
    v = v + a * dt
    x = x + v * torch.cos(psi + beta) * dt
    y = y + v * torch.sin(psi + beta) * dt
    psi = psi + (v / lr) * torch.sin(beta) * dt
    return torch.stack([x, y, psi, v], dim=-1)


def light_states(fsms: List[dict], ids: List[int], step: int, dt: float) -> List[int]:
    """Each light's state index (red 0, yellow 1, green 2) after ``step``
    steps of ``dt`` seconds: every FSM starts at its first phase with the
    phase's full duration and moves on when its time is used up exactly
    (a boundary belongs to the next phase); after the last phase it goes
    back to its cycle's start. Exact rational time."""
    names = ('red', 'yellow', 'green')
    t = Fraction(step) * Fraction(str(dt))
    current = []
    for fsm in fsms:
        phases = [(Fraction(str(d)), row) for d, row in fsm['phases']]
        k, elapsed = 0, Fraction(0)
        while elapsed + phases[k][0] <= t:
            elapsed += phases[k][0]
            k = k + 1 if k + 1 < len(phases) else fsm['cycle_start']
        current.append(phases[k][1])
    out = []
    for i in ids:
        # a light follows the first FSM that names it, red where its
        # current phase does not
        owner = next((f for f, fsm in enumerate(fsms)
                      if any(str(i) in row for _, row in fsm['phases'])), None)
        color = None if owner is None else current[owner].get(str(i))
        out.append(0 if color is None else names.index(color))
    return out
