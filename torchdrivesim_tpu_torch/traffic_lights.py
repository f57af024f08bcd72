"""
Traffic-light state machines (counterpart of
``torchdrivesim_tpu/traffic_lights.py``).

1. Host FSM classes with the reference's JSON format (``from_json``, and
   ``to_json`` to write it back) and tick semantics. Their random initial
   states come from an explicit ``random.Random``.
2. :class:`BakedLightSchedule`: the FSM cycle unrolled once on the host into
   per-light phase tables, after which the light state at any simulation
   time is a tensor lookup on the device.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass
from enum import Enum, auto
from functools import reduce
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class TrafficLightState(Enum):
    none = auto()
    green = auto()
    yellow = auto()
    red = auto()


ActorStates = Dict[str, TrafficLightState]

#: index of each color in `TrafficLightControl` allowed_states ['red','yellow','green']
CONTROL_STATE_INDEX = {'red': 0, 'yellow': 1, 'green': 2, 'none': 0}


@dataclass(eq=True)
class TrafficLightGroupState:
    """One state of a group of lights."""
    actor_states: ActorStates
    sequence_number: int
    duration: float  # seconds
    next_state: int


def _group_states_from_json_items(items) -> List[TrafficLightGroupState]:
    return [
        TrafficLightGroupState(
            actor_states={k: TrafficLightState[v] for k, v in it["actor_states"].items()},
            sequence_number=int(it["state"]),
            duration=float(it["duration"]),
            next_state=int(it["next_state"]),
        )
        for it in items
    ]


def _group_state_to_json_item(state: TrafficLightGroupState) -> Dict:
    return {
        "actor_states": {k: v.name for k, v in state.actor_states.items()},
        "state": str(state.sequence_number),
        "duration": state.duration,
        "next_state": str(state.next_state),
    }


class TrafficLightStateMachine:
    """
    Cyclic FSM over group states: large dt can skip several states; landing
    exactly on a boundary starts the next state at full duration. The
    initial state is drawn from ``rng``.
    """
    def __init__(self, group_states: List[TrafficLightGroupState],
                 rng: random.Random):
        self._states = group_states
        self._rng = rng
        self._time_remaining: Optional[float] = None
        self._current_state: Optional[TrafficLightGroupState] = None
        self._duration: Optional[float] = None
        self.reset()

    @classmethod
    def from_json(cls, json_file_path: str,
                  rng: random.Random) -> "TrafficLightStateMachine":
        """Load the group states from the JSON file (a list of items with
        ``actor_states``, ``state``, ``duration`` and ``next_state``); the
        initial state is drawn from ``rng``."""
        with open(json_file_path, "rb") as f:
            items = json.load(f)
        try:
            return cls(_group_states_from_json_items(items), rng)
        except KeyError as e:
            raise ValueError(f"KeyError: {e} in {json_file_path}")

    def to_json(self) -> str:
        """The group states in the JSON format they are loaded from."""
        return json.dumps([_group_state_to_json_item(s) for s in self._states])

    def reset(self):
        state = self._rng.randint(0, len(self._states) - 1)
        self.set_to(state, self._states[state].duration)

    def set_to(self, state_index: int, time_remaining: float):
        state = min(max(state_index, 0), len(self._states) - 1)
        self._current_state = self._states[state]
        self._duration = self._current_state.duration
        self._time_remaining = min(time_remaining, self._duration)

    def tick(self, dt: float):
        self._time_remaining -= dt
        while self._time_remaining <= 0:
            next_state = self._current_state.next_state
            next_duration = self._states[next_state].duration
            if self._time_remaining == 0:
                self.set_to(next_state, next_duration)
                break
            elif self._time_remaining + next_duration > 0:
                self._time_remaining += next_duration
                self.set_to(next_state, self._time_remaining)
                break
            else:
                self._time_remaining += next_duration
                self._current_state = self._states[next_state]

    @property
    def states(self) -> List[TrafficLightGroupState]:
        return self._states

    @property
    def duration(self) -> float:
        """The full duration of the current state."""
        return self._duration

    @property
    def current_state(self) -> TrafficLightGroupState:
        return self._current_state

    @property
    def time_remaining(self) -> float:
        return self._time_remaining

    def get_current_actor_states(self) -> ActorStates:
        return self.current_state.actor_states


class TrafficLightController:
    """Ticks a set of FSMs together. The current light states, each
    machine's state number and time remaining are collected after every
    :meth:`tick`, :meth:`set_to` and :meth:`reset`."""
    def __init__(self, traffic_fsms: List[TrafficLightStateMachine]):
        self.traffic_fsms = traffic_fsms
        self._time_remaining = None
        self._current_state = None
        self._state_per_machine = None
        self.reset()

    @classmethod
    def from_json(cls, json_file_path: str,
                  rng: random.Random) -> "TrafficLightController":
        """Load the controller; each FSM draws its initial state from
        ``rng`` at construction and again at the controller's reset, the
        same draws in the same order as the reference's global ``random``."""
        with open(json_file_path, "rb") as f:
            items = json.load(f)
        try:
            return cls([TrafficLightStateMachine(
                _group_states_from_json_items(sm), rng) for sm in items])
        except KeyError as e:
            raise ValueError(f"KeyError: {e} in {json_file_path}")

    def to_json(self) -> str:
        """Every machine's group states in the format of :meth:`from_json`."""
        return json.dumps([[_group_state_to_json_item(s) for s in fsm.states]
                           for fsm in self.traffic_fsms])

    def tick(self, dt: float):
        for fsm in self.traffic_fsms:
            fsm.tick(dt)
        self.update_current_state_and_time()

    def set_to(self, light_states: List[List[float]]):
        """Put machine i in state ``light_states[i][0]`` with
        ``light_states[i][1]`` seconds remaining (at most its duration)."""
        for i, (state, time_remaining) in enumerate(light_states):
            self.traffic_fsms[i].set_to(int(state), time_remaining)
        self.update_current_state_and_time()

    def reset(self):
        for fsm in self.traffic_fsms:
            fsm.reset()
        self.update_current_state_and_time()

    def update_current_state_and_time(self):
        """Collect the machines' current light states, state numbers and
        times remaining."""
        self._current_state = self.collect_all_current_light_states()
        self._state_per_machine = [fsm.current_state.sequence_number
                                   for fsm in self.traffic_fsms]
        self._time_remaining = [fsm.time_remaining for fsm in self.traffic_fsms]

    @property
    def current_state(self) -> ActorStates:
        return self._current_state

    @property
    def current_state_with_name(self) -> Dict[str, str]:
        """Each light's current state by name ('red', 'yellow', ...)."""
        return {k: v.name for k, v in self._current_state.items()}

    @property
    def state_per_machine(self) -> List[int]:
        return self._state_per_machine

    @property
    def time_remaining(self) -> List[float]:
        return self._time_remaining

    def get_number_of_light_groups(self) -> int:
        return len(self.traffic_fsms)

    def collect_all_current_light_states(self) -> ActorStates:
        """Every machine's current actor states in one dict."""
        return reduce(lambda x, y: {**x, **y},
                      [fsm.get_current_actor_states() for fsm in self.traffic_fsms], {})


def current_light_state_tensor_from_controller(
        traffic_light_controller: TrafficLightController,
        traffic_light_ids: Sequence[int], device='cuda') -> torch.Tensor:
    """The controller's current state of each light of
    ``traffic_light_ids``, as int32 indices into the traffic-light
    control's allowed states, on ``device``."""
    state = traffic_light_controller.current_state
    return torch.tensor([CONTROL_STATE_INDEX[state[str(i)].name]
                         for i in traffic_light_ids], dtype=torch.int32, device=device)


class BakedLightSchedule:
    """
    Unrolls FSM cycles into per-light phase tables so the light state at any
    time is a pure tensor lookup, exactly equivalent to ticking the host FSM
    by ``t`` seconds.

    Args:
        controller: host controller (defines FSMs + initial states).
        light_ids: the actor ids to expose, in tensor order.
        device: where the tables live.
    """
    MAX_PHASES = 64

    def __init__(self, controller: TrafficLightController,
                 light_ids: Sequence[int], *, device):
        self.light_ids = [int(i) for i in light_ids]
        id_strs = [str(i) for i in self.light_ids]
        n_fsm = len(controller.traffic_fsms)
        rows_dur = np.zeros((n_fsm, self.MAX_PHASES), dtype=np.float32)
        rows_color = np.zeros((n_fsm, self.MAX_PHASES, len(id_strs)), dtype=np.int32)
        cycle_start = np.zeros((n_fsm,), dtype=np.int32)
        n_rows = np.zeros((n_fsm,), dtype=np.int32)
        offset = np.zeros((n_fsm,), dtype=np.float32)

        for f, fsm in enumerate(controller.traffic_fsms):
            # unroll: current state first (with its elapsed time as offset)
            seq = []
            visited = {}
            idx = fsm.current_state.sequence_number
            while True:
                if idx in visited:
                    cycle_start[f] = visited[idx]
                    break
                visited[idx] = len(seq)
                seq.append(idx)
                idx = fsm.states[idx].next_state
                if len(seq) > self.MAX_PHASES:
                    raise ValueError("FSM cycle longer than MAX_PHASES")
            n_rows[f] = len(seq)
            offset[f] = fsm.states[seq[0]].duration - fsm.time_remaining
            for r, s in enumerate(seq):
                gs = fsm.states[s]
                rows_dur[f, r] = gs.duration
                for li, id_str in enumerate(id_strs):
                    color = gs.actor_states.get(id_str)
                    if color is not None:
                        rows_color[f, r, li] = CONTROL_STATE_INDEX[color.name]

        # each light follows the first FSM that mentions it
        light_fsm = np.zeros((len(id_strs),), dtype=np.int64)
        for li, id_str in enumerate(id_strs):
            for f, fsm in enumerate(controller.traffic_fsms):
                if any(id_str in gs.actor_states for gs in fsm.states):
                    light_fsm[li] = f
                    break

        cum = np.cumsum(rows_dur, axis=1)
        tail_end = np.where(cycle_start > 0,
                            cum[np.arange(n_fsm), cycle_start - 1], 0.0)
        total = cum[np.arange(n_fsm), n_rows - 1]
        self.load_tables(cum, rows_color, tail_end.astype(np.float32),
                         (total - tail_end).astype(np.float32), offset,
                         light_fsm, n_rows, device)

    @classmethod
    def from_tables(cls, durations_cum, colors, tail_end, period, offset,
                    light_fsm, n_rows, light_ids, *, device
                    ) -> "BakedLightSchedule":
        """Rebuild a schedule from its tables (numpy arrays)."""
        out = cls.__new__(cls)
        out.light_ids = [int(i) for i in light_ids]
        out.load_tables(durations_cum, colors, tail_end, period, offset,
                        light_fsm, n_rows, device)
        return out

    def load_tables(self, durations_cum, colors, tail_end, period, offset,
                    light_fsm, n_rows, device) -> None:
        as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                             device=device)
        self.durations_cum = as_t(durations_cum, torch.float32)
        self.colors = as_t(colors, torch.int32)
        self.tail_end = as_t(tail_end, torch.float32)
        self.period = as_t(period, torch.float32)
        self.offset = as_t(offset, torch.float32)
        self.light_fsm = as_t(light_fsm, torch.int64)
        self.n_rows = as_t(n_rows, torch.int64)

    def states_at(self, time_s: torch.Tensor) -> torch.Tensor:
        """
        Light states at simulation time ``time_s`` seconds (a float32 scalar
        tensor).

        Returns:
            (num_lights,) int32 indices into ['red', 'yellow', 'green'].
        """
        t = time_s.to(torch.float32) + self.offset          # per FSM
        # fold times beyond the tail into the cycle; the remainder takes the
        # divisor's sign, computed from fmod as the reference computes it
        in_cycle = t - self.tail_end
        period = torch.clamp(self.period, min=1e-6)
        rem = torch.fmod(in_cycle, period)
        rem = torch.where((rem != 0) & ((rem < 0) != (period < 0)),
                          rem + period, rem)
        t = torch.where(t <= self.tail_end, t, self.tail_end + rem)
        # row index: first cumulative end-time strictly greater than t
        row = (self.durations_cum <= t[..., None]).sum(dim=-1)
        row = torch.minimum(row, self.n_rows - 1)
        fsm_rows = row[self.light_fsm]                     # per light
        light_idx = torch.arange(self.colors.shape[-1], device=t.device)
        return self.colors[self.light_fsm, fsm_rows, light_idx]
