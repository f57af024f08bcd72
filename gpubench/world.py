"""
The general input generator: from a configuration, a cell's traffic and a
seed, the inputs both the program and the reference are given.

* Map data is read by path from the maps bundled beside the port
  (``torchdrivesim_tpu/resources/maps/<map>/``): the grids (``.npz``), the
  stoplines and the light controller (``.json``) and the road mesh
  (``.json``). Reading files imports nothing.
* Agents are placed from the configuration's ``layout_seed``: ``layouts``
  layouts of ``agents`` cars on cells of the direction grid that lie on the
  road and carry one lane direction, heading along it, at a speed drawn from
  ``speed``, without overlaps (discs with gaps, as the reference's
  heuristic initializer checks). Every run seed gets the same set of
  layouts, so the same work, in its own order: ``numpy.random
  .default_rng(seed)`` permutes them before they tile the batch.
* Each light controller FSM starts in a state drawn from the run seed's
  generator, at the state's full duration; its cycle is unrolled into the
  tables the port's ``BakedLightSchedule.from_tables`` takes.
"""
import json
import os
from typing import Dict

import numpy as np

from gpubench.harness import ROOT

MAPS = os.path.join(ROOT, 'torchdrivesim_tpu', 'resources', 'maps')
CAR_LENGTH, CAR_WIDTH, CAR_LR = 4.97, 2.04, 1.96
LIGHT_STATES = ('red', 'yellow', 'green')
DIRECTION_INVALID = 255
MAX_PHASES = 64


def map_file(map_name: str, suffix: str) -> str:
    return os.path.join(MAPS, map_name, f'{map_name}{suffix}')


def map_metadata(map_name: str) -> dict:
    with open(os.path.join(MAPS, map_name, 'metadata.json')) as f:
        return json.load(f)


def load_grids(map_name: str) -> Dict[str, np.ndarray]:
    with np.load(map_file(map_name, '_tpu_grids_v2.npz')) as d:
        return {k: d[k] for k in d.files}


def load_road_mesh(map_name: str):
    """(verts (V, 2) float32, faces (F, 3) int64, categories, vertex
    category index (V,)) of the map's road mesh file."""
    with open(map_file(map_name, '_mesh.json')) as f:
        m = json.load(f)
    return (np.asarray(m['verts'][0], np.float32), np.asarray(m['faces'][0], np.int64),
            list(m['categories']), np.asarray(m['vert_category'][0], np.int64))


def _discs(box: np.ndarray, num_discs: int = 5):
    half = (num_discs - 1) // 2
    xy, length, width, yaw = box[..., :2], box[..., 2], box[..., 3], box[..., 4]
    r = np.minimum(length, width) / 2
    span = np.maximum(length, width) / 2 - r
    offs = np.asarray([i / half for i in range(-half, half + 1)])
    yaw_eff = yaw + (np.pi / 2) * (width > length)
    cx = offs[None] * span[..., None] * np.cos(yaw_eff)[..., None] + xy[..., 0:1]
    cy = offs[None] * span[..., None] * np.sin(yaw_eff)[..., None] + xy[..., 1:2]
    return np.stack([cx, cy], axis=-1), r


def _collides(me: np.ndarray, others: np.ndarray) -> bool:
    ca, ra = _discs(me[None])
    cb, rb = _discs(others)
    d = np.sqrt(((ca[0][None, :, None] - cb[:, None]) ** 2).sum(-1)).min(axis=(1, 2))
    return bool(np.any(d < ra[0] + rb))


def lane_cells(grids: Dict[str, np.ndarray]):
    """World (x, y) of the direction grid's cells on the road with exactly
    one lane direction, and that direction (radians)."""
    direction = grids['direction'][..., 0]
    distance = grids['distance'][..., 0].astype(np.float32)
    q0 = direction & 0xFF
    q1 = (direction >> 8) & 0xFF
    rows, cols = np.nonzero((q0 != DIRECTION_INVALID) & (q1 == DIRECTION_INVALID)
                            & (distance <= 0.0))
    cell = float(grids['direction_cell'])
    origin = grids['direction_origin']
    xy = np.stack([origin[0] + cols * cell, origin[1] + rows * cell], axis=-1)
    angle = q0[rows, cols].astype(np.float64) / 254.0 * (2 * np.pi) - np.pi
    return xy, angle, cell


def place_agents(rng: np.random.Generator, grids, agents: int, speed,
                 attempts: int = 500) -> np.ndarray:
    """(agents, 4) float32 (x, y, psi, v) of one layout."""
    xy, angle, cell = lane_cells(grids)
    states = []
    for _ in range(agents):
        for _ in range(attempts):
            k = int(rng.integers(len(xy)))
            x, y = xy[k] + rng.uniform(-cell / 2, cell / 2, size=2)
            v = float(rng.uniform(speed[0], speed[1]))
            if states:
                others = np.asarray([[s[0], s[1], CAR_LENGTH + 1.0, CAR_WIDTH + 0.2, s[2]]
                                     for s in states])
                if _collides(np.asarray([x, y, CAR_LENGTH, CAR_WIDTH, angle[k]]), others):
                    continue
            states.append([x, y, angle[k], v])
            break
        else:
            raise RuntimeError('agent placement failed')
    return np.asarray(states, np.float32)


def box_corners(box: np.ndarray) -> np.ndarray:
    """(..., 5) boxes (x, y, length, width, angle) -> (..., 4, 2) corners
    (+l+w, -l+w, -l-w, +l-w)/2 rotated, in float32."""
    box = box.astype(np.float32)
    x, y, l, w, a = (box[..., i:i + 1] for i in range(5))
    x4 = l / 2 * np.asarray([1, -1, -1, 1], np.float32)
    y4 = w / 2 * np.asarray([1, 1, -1, -1], np.float32)
    c, s = np.cos(a), np.sin(a)
    return np.stack([x4 * c - y4 * s + x, x4 * s + y4 * c + y], axis=-1).astype(np.float32)


def lights(map_name: str, rng: np.random.Generator) -> dict:
    """The traffic lights: boxes, corners, ids and the unrolled schedule of
    the controller's FSMs, each started in a state drawn from ``rng`` at its
    full duration."""
    with open(map_file(map_name, '_stoplines.json')) as f:
        stoplines = [s for s in json.load(f) if s['agent_type'] == 'traffic_light']
    with open(map_file(map_name, '_traffic_light_controller.json')) as f:
        fsms = json.load(f)
    ids = [int(s['actor_id']) for s in stoplines]
    pos = np.asarray([[s['x'], s['y'], s['length'], s['width'], s['orientation']]
                      for s in stoplines], np.float32)
    id_strs = [str(i) for i in ids]
    n_fsm = len(fsms)
    durations = np.zeros((n_fsm, MAX_PHASES), np.float32)
    colors = np.zeros((n_fsm, MAX_PHASES, len(ids)), np.int32)
    cycle_start = np.zeros(n_fsm, np.int32)
    n_rows = np.zeros(n_fsm, np.int32)
    fsm_states = []
    for f, items in enumerate(fsms):
        by_number = {int(it['state']): it for it in items}
        numbers = sorted(by_number)
        start = numbers[int(rng.integers(len(numbers)))]
        seq, seen, idx = [], {}, start
        while idx not in seen:
            seen[idx] = len(seq)
            seq.append(idx)
            idx = int(by_number[idx]['next_state'])
        cycle_start[f] = seen[idx]
        n_rows[f] = len(seq)
        phases = []
        for r, s in enumerate(seq):
            it = by_number[s]
            durations[f, r] = float(it['duration'])
            row = {}
            for li, key in enumerate(id_strs):
                if key in it['actor_states']:
                    colors[f, r, li] = LIGHT_STATES.index(it['actor_states'][key])
                    row[key] = it['actor_states'][key]
            phases.append((float(it['duration']), row))
        fsm_states.append({'phases': phases, 'cycle_start': int(seen[idx])})
    light_fsm = np.zeros(len(ids), np.int64)
    for li, key in enumerate(id_strs):
        for f, items in enumerate(fsms):
            if any(key in it['actor_states'] for it in items):
                light_fsm[li] = f
                break
    cum = np.cumsum(durations, axis=1)
    tail_end = np.where(cycle_start > 0, cum[np.arange(n_fsm), cycle_start - 1], 0.0)
    total = cum[np.arange(n_fsm), n_rows - 1]
    # each light follows the first FSM that names it, red where that FSM's
    # first phase does not
    state0 = [colors[light_fsm[li], 0, li] for li in range(len(ids))]
    return {'ids': ids, 'pos': pos, 'corners': box_corners(pos),
            'state0': np.asarray(state0, np.int32),
            'schedule': {'durations_cum': cum, 'colors': colors,
                         'tail_end': tail_end.astype(np.float32),
                         'period': (total - tail_end).astype(np.float32),
                         'offset': np.zeros(n_fsm, np.float32),
                         'light_fsm': light_fsm, 'n_rows': n_rows},
            'fsms': fsm_states}


def make_world(config: dict, traffic: dict, seed: int) -> dict:
    """The inputs of one run, host numpy: ``agent_state`` (B, A, 4),
    ``agent_size`` (B, A, 2), ``lr`` (B, A), the lights and the grids of
    the configuration's map."""
    rng = np.random.default_rng(seed)
    name = config['map']
    grids = load_grids(name)
    b, a = int(traffic.get('batch', config.get('batch_size'))), int(config['agents'])
    pool = np.random.default_rng(int(config['layout_seed']))
    layouts = np.stack([place_agents(pool, grids, a, config['speed'])
                        for _ in range(min(int(config['layouts']), b))])
    layouts = layouts[rng.permutation(len(layouts))]
    reps = -(-b // len(layouts))
    states = np.tile(layouts, (reps, 1, 1))[:b]
    world = {
        'map': name,
        'left_handed': bool(map_metadata(name)['left_handed_coordinates']),
        'agent_state': states,
        'agent_size': np.broadcast_to(np.asarray([CAR_LENGTH, CAR_WIDTH], np.float32),
                                      (b, a, 2)).copy(),
        'lr': np.full((b, a), CAR_LR, np.float32),
        'grids': grids,
        'lights': lights(name, rng),
    }
    return world
