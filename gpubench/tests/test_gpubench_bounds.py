"""The frozen bound arithmetic gives chip_smoke.py's numbers on the same
small scenes."""
import sys

import numpy as np
import pytest
import torch

from gpubench import bounds, harness

sys.path.insert(0, harness.ROOT)
chip_smoke = pytest.importorskip('chip_smoke')


def test_peaks_and_operation_counts_are_chip_smokes():
    for name in ('HBM_BYTES_PER_S', 'FP32_INSTR_PER_S', 'SFU_OPS_PER_S', 'BOUND_TILE',
                 'SOFT_FWD_OPS', 'SOFT_FWD_SFU', 'SOFT_ACCUM_BWD_OPS',
                 'SOFT_ACCUM_BWD_SFU', 'HARD_CHUNKED_FACE_OPS'):
        assert getattr(bounds, name) == getattr(chip_smoke, name), name


@pytest.mark.parametrize('n_bytes,n_ops,n_sfu', [(1e9, 1e6, 0), (1e3, 1e12, 0),
                                                 (1e3, 1e6, 1e12)])
def test_bound(n_bytes, n_ops, n_sfu):
    ms, _ = chip_smoke.bound(n_bytes, n_ops, n_sfu)
    assert bounds.bound_s(n_bytes, n_ops, n_sfu) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_tile_pairs():
    rng = np.random.RandomState(0)
    corners = torch.as_tensor(rng.uniform(-40, 170, (3, 30, 4, 2)), dtype=torch.float32)
    valid = bounds.prim_valid(corners)
    assert torch.equal(valid, chip_smoke.prim_valid(corners))
    for res in (64, 128, 80):
        assert bounds.tile_pairs(corners, valid, res) == \
            chip_smoke.tile_pairs(corners, valid, res)


@pytest.mark.parametrize('backward', [False, True])
def test_soft_pairs_and_grouped_bounds(backward):
    """With no shared faces, the grouped bounds are chip_smoke's; with the
    road mesh shared, only its bytes change, counted once for the frame."""
    rng = np.random.RandomState(1)
    b, f, res = 2, 256, 64
    coef = torch.as_tensor(rng.normal(0, 0.3, (b, f, 3, 3)), dtype=torch.float32)
    coef[..., 2] = torch.as_tensor(rng.uniform(-30, 20, (b, f, 3)), dtype=torch.float32)
    zw = torch.rand((b, 1, f))
    color = torch.rand((b, f, 3))
    assert bounds.soft_tile_pairs(coef, res) == chip_smoke.soft_tile_pairs(coef, res)
    (ms, _), _ = chip_smoke.accum_bound((coef, zw, color), res, backward)
    assert bounds.accum_bound_s(coef, res, backward) * 1e3 == pytest.approx(ms, rel=1e-12)
    pairs = chip_smoke.soft_tile_pairs(coef, res) * 256
    ops, sfu = ((bounds.SOFT_ACCUM_BWD_OPS, bounds.SOFT_ACCUM_BWD_SFU) if backward
                else (bounds.SOFT_FWD_OPS, bounds.SOFT_FWD_SFU))
    faces = 200 * 10 * 4 + b * (56 * 13 * 4 + 16)
    n_bytes = (2 if backward else 1) * faces + b * 5 * res * res * 4
    assert bounds.accum_bound_s(coef, res, backward, shared=200) == pytest.approx(
        bounds.bound_s(n_bytes, pairs * ops, pairs * sfu), rel=1e-12)


def test_hard_bound_counts_the_road_mesh_once():
    """B6b's bound reads the road mesh once for the frame, whatever the
    number of cameras, and each camera's pose, actors and image; its
    operations are the tile pairs of every face in each camera's screen."""
    from gpubench.reference.render import screen
    rng = np.random.RandomState(2)
    res, scale, f = 128, 2.0 / 70.0, 300
    road = torch.as_tensor(rng.uniform(-60, 60, (f, 3, 2)), dtype=torch.float32)
    quads = torch.as_tensor(rng.uniform(-10, 140, (4, 44, 4, 2)), dtype=torch.float32)
    tris = torch.as_tensor(rng.uniform(-10, 140, (4, 20, 3, 2)), dtype=torch.float32)
    xy = torch.as_tensor(rng.uniform(-20, 20, (4, 2)), dtype=torch.float32)
    psi = torch.as_tensor(rng.uniform(-3, 3, 4), dtype=torch.float32)
    sc = torch.stack([torch.sin(psi), torch.cos(psi)], -1)
    t = bounds.hard_bound_s(road, quads, tris, xy, sc, scale, res, True, chunk=3)
    rt = screen(road.reshape(1, -1, 2).expand(4, -1, -1), xy, sc, scale, res,
                True).reshape(4, f, 3, 2)
    boxes = torch.cat([quads[:, :, [0, 1, 2]], quads[:, :, [0, 2, 3]]], dim=1)
    pairs = sum(chip_smoke.tile_pairs(x, chip_smoke.prim_valid(x), res)
                for x in (rt, boxes, tris))
    n_bytes = f * 32 + 4 * ((88 + 20) * 32 + 16) + 4 * 3 * res * res * 4
    assert t == pytest.approx(bounds.bound_s(
        n_bytes, pairs * 256 * bounds.HARD_CHUNKED_FACE_OPS), rel=1e-12)
