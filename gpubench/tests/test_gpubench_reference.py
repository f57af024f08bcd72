"""The plain reference against the port's CPU path at tiny sizes: one
rollout step (and a few) of the mesh-rendered rollout, and a short IL
gradient; and the offroad grid that both read against the road mesh."""
import time

import numpy as np
import pytest
import torch

from gpubench import harness, world

SEED = 4_000_000_123
ROLLOUT = {'batch': 2, 'check_envs': 2, 'check_steps': 2, 'episode_steps': 3,
           'warmup_steps': 1, 'config': {'res': 32}}
IL = {'batch': 2, 'horizon': 3, 'warmup_rollouts': 0, 'config': {'res': 32}}


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(4)


def run(cell, overrides, patch=None):
    return harness.run_cell(cell, SEED, 0.0, False, device='cpu',
                            t_start=time.perf_counter(), overrides=overrides, patch=patch)


def test_rollout_step_matches_the_port():
    res = run('rollout_untextured', ROLLOUT)
    c = {k: v['value'] for k, v in res['compared'].items()}
    assert c['state_gap'] == 0.0 and c['image_mismatch'] == 0.0
    assert c['collision_gap'] <= 1e-6 and c['wrong_way_gap'] <= 1e-6
    assert c['offroad_mismatch'] == 0.0 and c['light_violation_mismatch'] == 0.0
    assert res['correct']


def test_il_gradient_matches_the_port():
    res = run('il_untextured', IL)
    c = {k: v['value'] for k, v in res['compared'].items()}
    assert c['loss_gap'] <= 1e-6 and c['grad_cos_gap'] <= 1e-6
    assert res['correct']


def test_bundled_distance_grid_is_the_road_meshs():
    """The offroad distance grid that both sides read is the distance to the
    road mesh's 'road' faces at its nodes, worked out here point to
    triangle (not by the package's baker), to the grid's float16 rounding."""
    verts, faces, cats, vcat = world.load_road_mesh('carla_Town02')
    tri = torch.as_tensor(verts[faces[vcat[faces[:, 0]] == cats.index('road')]],
                          dtype=torch.float64)
    g = world.load_grids('carla_Town02')
    d = g['distance'][..., 0].astype(np.float64)
    origin, cell = g['distance_origin'], float(g['distance_cell'])
    rng = np.random.default_rng(5)
    rows = rng.integers(0, d.shape[0], 600)
    cols = rng.integers(0, d.shape[1], 600)
    p = torch.as_tensor(np.stack([origin[0] + cols * cell, origin[1] + rows * cell], -1))
    p = p[:, None, None]
    a, b = tri[None], tri.roll(-1, dims=1)[None]
    e, ap = b - a, p - a
    u = ((ap * e).sum(-1) / (e * e).sum(-1).clamp(min=1e-30)).clamp(0, 1)
    edge = ((ap - u[..., None] * e) ** 2).sum(-1).amin(-1)
    cross = e[..., 0] * ap[..., 1] - e[..., 1] * ap[..., 0]
    inside = (cross >= 0).all(-1) | (cross <= 0).all(-1)
    exact = torch.where(inside, 0.0, edge).amin(-1).sqrt().numpy()
    want = d[rows, cols]
    assert (inside.any(-1).numpy() == (want == 0)).mean() > 0.99
    assert np.all(np.abs(exact - want) <= 1e-3 + want * 2.0 ** -10)
