"""
The primitive winner's per-tile cull, on the CPU: the plain version
``ops/prims.py: prim_tile_keep_reference`` of the test with which each 16 x
16 pixel tile of kernels B1 (``csrc/fused_render.cu``), B7 and B8
(``csrc/prim_raster.cu``) drops the primitives that cannot reach it
(``csrc/prim_winner.cuh``).

* The cull keeps every (tile, primitive) pair in which the plain float32
  inside test and the pixel's band bit accept some pixel of the tile, at res
  16, 64, 80, 128 and 144, on random scenes and on four adversarial kinds
  (``chip_smoke.prim_cull_scene``): boundary prims whose value at a tile's
  corner pixel is exactly 0 or +-0.5, nextafter(+-0.5, 0), or inside in
  float32 while outside in float64 (on these the cull without its slack
  drops pairs that count); parallelograms whose corner 2 is far from c1 +
  c3 - c0; near-degenerate prims; prims larger than the view.
* The plain winner with every pair the cull drops replaced by the sentinel,
  tile by tile, equals the unculled winner bit for bit on the same cases.
* Hand-made operands (``chip_smoke.prim_edge_operands``): an edge whose
  coefficients are all 0 (value 0 everywhere, inside a triangle: only the
  strict inequality keeps it), constant quad coordinates +-0.5, NaN and
  infinite coefficients, and an edge with subnormal products (only delta's
  underflow term keeps it) are kept.

Operands come from numpy with fixed seeds, through the row-major sort with
its band masks and ``prep_prims``.
"""
import pytest
import torch

import chip_smoke
from torchdrivesim_tpu_torch.ops import prims, warp
from torchdrivesim_tpu_torch.ops.rasterize import SENTINEL, band_rows

torch.set_num_threads(1)

KINDS = ('random',) + chip_smoke.PRIM_CULL_KINDS
RESES = (16, 64, 80, 128, 144)
TILE = prims.PRIM_TILE


def _operands(kind, res):
    seed = 100 * KINDS.index(kind) + res
    if kind == 'random':
        scene = prims.random_prims(seed, 2, 30, 20, res, 'cpu')
    else:
        scene = chip_smoke.prim_cull_scene(kind, seed, 2, res, 'cpu')
    return chip_smoke.prim_cull_operands(scene, res)


def _counts(ops, res):
    """(B, P, res, res): where a primitive counts in the winner: its pack
    is not the sentinel, it passes the plain float32 inside test and its
    chunk's bit is set in the pixel's band; quads first."""
    qcoef, qpk, tcoef, tpk, qmask, tmask = ops
    px = (torch.arange(res, dtype=torch.float32) + 0.5)[:, None]
    py = (torch.arange(res, dtype=torch.float32) + 0.5)[None, :]

    def edge(coef, k):
        c = lambda j: coef[:, k, :, j, None, None]
        return warp.affine(c(0), px, c(1), py, c(2))
    inside = torch.cat([
        torch.maximum(edge(qcoef, 0).abs(), edge(qcoef, 1).abs()) <= 0.5,
        torch.minimum(torch.minimum(edge(tcoef, 0), edge(tcoef, 1)), edge(tcoef, 2)) >= 0,
    ], dim=1) & (torch.cat([qpk, tpk], dim=1) != SENTINEL)[..., None]
    if qmask is None:
        return inside
    live = torch.cat([m[:, :, 0].repeat_interleave(8, dim=2) for m in (qmask, tmask)],
                     dim=2) != 0                                   # (B, J, P)
    rows = live[:, torch.arange(res) // band_rows(res)]           # (B, res, P)
    return inside & rows.transpose(1, 2)[..., None]


def _per_tile(x, res):
    """(B, P, res, res) -> (B, tiles, P): any over each tile's pixels."""
    b, n = x.shape[:2]
    per = res // TILE
    return x.reshape(b, n, per, TILE, per, TILE).any(dim=5).any(dim=3) \
        .reshape(b, n, per * per).transpose(1, 2)


def _to_pixels(keep, res):
    """(B, tiles, P) -> (B, P, res, res)."""
    b, _, n = keep.shape
    per = res // TILE
    k = keep.transpose(1, 2).reshape(b, n, per, 1, per, 1)
    return k.expand(b, n, per, TILE, per, TILE).reshape(b, n, res, res)


def _culled_winner(ops, keep, res):
    """The winner with each pair the cull drops taken out, tile by tile."""
    pk = torch.cat([ops[1], ops[3]], dim=1)[..., 0]
    vals = torch.where(_counts(ops, res) & _to_pixels(keep, res),
                       pk[:, :, None, None], SENTINEL)
    return vals.amin(dim=1)


@pytest.mark.parametrize('res', RESES)
@pytest.mark.parametrize('kind', KINDS)
def test_cull_keeps_every_reaching_pair(kind, res, monkeypatch):
    ops = _operands(kind, res)
    keep = prims.prim_tile_keep_reference(*ops, res)
    reach = _per_tile(_counts(ops, res), res)
    b, qp, tp = ops[1].shape[0], ops[1].shape[1], ops[3].shape[1]
    assert keep.shape == reach.shape == (b, prims.prim_tiles(res), qp + tp)
    assert int(reach.sum()) > 0
    assert int((reach & ~keep).sum()) == 0
    # the sentinel is never listed; the cull drops something past one tile
    pk = torch.cat([ops[1], ops[3]], dim=1)[..., 0]
    assert not bool((keep & (pk == SENTINEL)[:, None, :]).any())
    if res > TILE:
        assert int((~keep & (pk != SENTINEL)[:, None, :]).sum()) > 0
    if kind == 'boundary':
        # without the slack the cull would drop pairs that count here
        monkeypatch.setattr(prims, '_CULL_SLACK', 0.0)
        bare = prims.prim_tile_keep_reference(*ops, res)
        assert int((reach & ~bare).sum()) > 0


@pytest.mark.parametrize('res', RESES)
@pytest.mark.parametrize('kind', KINDS)
def test_culled_winner_equals_unculled(kind, res):
    ops = _operands(kind, res)
    keep = prims.prim_tile_keep_reference(*ops, res)
    want = prims.prim_winner_reference(*ops, res)
    assert torch.equal(_culled_winner(ops, keep, res), want)
    assert int((want != SENTINEL).sum()) > 0
    if res <= 64:
        # literally: the plain winner over each tile's kept packs only
        b, tiles = keep.shape[:2]
        qp = ops[1].shape[1]
        rep = lambda x: None if x is None else x.repeat_interleave(tiles, dim=0)
        flat = keep.reshape(b * tiles, -1)
        qpk = torch.where(flat[:, :qp, None], rep(ops[1]), SENTINEL)
        tpk = torch.where(flat[:, qp:, None], rep(ops[3]), SENTINEL)
        runs = prims.prim_winner_reference(rep(ops[0]), qpk, rep(ops[2]), tpk,
                                           rep(ops[4]), rep(ops[5]), res)
        per = res // TILE
        runs = runs.reshape(b, per, per, per, TILE, per, TILE)
        tiled = torch.stack([runs[:, i, j, i, :, j] for i in range(per)
                             for j in range(per)], dim=1)
        got = tiled.reshape(b, per, per, TILE, TILE).transpose(2, 3).reshape(b, res, res)
        assert torch.equal(got, want)


def test_cull_keeps_flat_and_nonfinite_prims(monkeypatch):
    """``chip_smoke.prim_edge_operands`` at res 32, no masks: a triangle
    with one edge all 0 (value 0 everywhere: the strict inequality keeps it
    where delta is 0); quads whose coordinates are the constants +-0.5
    (inside everywhere); a triangle and a quad with a NaN or an infinite
    coefficient (kept, never winning); a triangle whose edge has subnormal
    products, inside in float32 at row 15 while its float64 value is below
    0 over rows 0-15 (kept there by delta's underflow term). The culled
    winner equals the unculled one, and without the underflow term it
    does not."""
    ops = chip_smoke.prim_edge_operands('cpu') + (None, None)
    keep = prims.prim_tile_keep_reference(*ops, 32)
    assert keep[0, :, 0].all() and keep[0, :, 1].all()          # quads 0, 1
    assert keep[0, :, 9].all()                                  # triangle 1 (NaN)
    assert keep[0, :, 8].tolist() == [True, True, False, False]  # triangle 0
    assert keep[0, :, 10].all()                                 # triangle 2 (subnormal)
    want = prims.prim_winner_reference(*ops, 32)
    assert torch.equal(_culled_winner(ops, keep, 32), want)
    assert int((want == (5 << 24)).sum()) == 11 * 32
    assert int((want == ops[1][0, 0, 0]).sum()) == 4 * 32
    assert int((want == ops[3][0, 2, 0]).sum()) == 17 * 32
    monkeypatch.setattr(prims, '_CULL_UNDERFLOW', 0.0)
    bare = prims.prim_tile_keep_reference(*ops, 32)
    assert bare[0, :, 10].tolist() == [False, False, True, True]
    assert not torch.equal(_culled_winner(ops, bare, 32), want)
