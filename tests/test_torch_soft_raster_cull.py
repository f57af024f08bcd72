"""
The single-group soft raster's per-tile face cull, on the CPU: kernels B4a
and B4b (``csrc/soft_raster.cu``) run one block per 16 x 16 pixel tile,
which folds only the faces the shared cull lists for its tile (plain
version ``ops/soft.py: soft_tile_lists_reference``); the faces it drops must
add exactly nothing there.

* With each tile's dropped faces replaced by the padding face (C = -1e9,
  z weight 0, color 0), ``soft_raster_fwd_reference`` equals the unculled
  forward bit for bit, at res 32 (2 x 2 whole tiles), 40 (ragged last tiles)
  and 64.
* At res 16 (one tile) ``soft_raster_bwd_reference`` over the listed faces
  only gives the listed faces' gradient rows and gbg bit for bit, and the
  unculled rows of the dropped faces are 0.
* Both hold on random faces (a face covering the view, a degenerate one),
  on road-like faces (most off-view), on boundary faces (one edge peaking at
  nextafter(-4, 0), -4 or -4.001 at a tile corner) and on the config-4
  frame (``chip_smoke.il_frame_operands``).

Operands come from ``chip_smoke`` (numpy, fixed seeds), whose card checks
use the same generators.
"""
import pytest
import torch

import chip_smoke
from torchdrivesim_tpu_torch.ops import soft

torch.set_num_threads(1)

#: (seed, cameras, faces) per kind; boundary faces add three per tile and
#: one per inner tile to the random ones, filling one group of 128
SIZES = {'random': (41, 2, 45), 'road': (42, 1, 128), 'boundary': (43, 1, None)}


def _operands(kind, res):
    seed, b, n_faces = SIZES[kind]
    if kind == 'boundary':
        n_faces = soft.MAX_FACES - chip_smoke.boundary_extra(res, slack_faces=True)
    return chip_smoke.soft_case_operands(kind, seed + res, b, n_faces, res, 'cpu')


def _il_operands(res):
    from torchdrivesim_tpu_torch.benchmark import build_il_scenario
    scenario = build_il_scenario(batch_size=2, res=res, device='cpu')
    _, ops = chip_smoke.il_frame_operands(scenario, scenario.sim.state)
    g = torch.empty_like(ops[3]).uniform_(-1, 1, generator=torch.Generator().manual_seed(res))
    return ops, g


def _case(kind, res):
    return _il_operands(res) if kind == 'il' else _operands(kind, res)


def _masked_forward(ops, keep):
    """``soft_raster_fwd_reference`` with each tile's dropped faces
    replaced by the padding face: every tile runs as a camera of its own,
    and each pixel is taken from its tile's run."""
    coef, zw, color, bg = ops
    b, tiles, n_faces = keep.shape
    res = bg.shape[-1]
    kept = keep.reshape(b * tiles, n_faces)
    rep = lambda x: x.repeat_interleave(tiles, dim=0)
    pad = torch.zeros((3, 3), dtype=coef.dtype)
    pad[:, 2] = -1e9
    runs = soft.soft_raster_fwd_reference(
        torch.where(kept[..., None, None], rep(coef), pad),
        torch.where(kept[:, None, :], rep(zw), torch.zeros((), dtype=zw.dtype)),
        torch.where(kept[..., None], rep(color), torch.zeros((), dtype=color.dtype)),
        rep(bg)).reshape(b, tiles, 3, res, res)
    per, tile = -(-res // soft.ACCUM_TILE), soft.ACCUM_TILE
    out = torch.empty_like(bg)
    for t in range(tiles):
        r, c = (t // per) * tile, (t % per) * tile
        out[..., r:r + tile, c:c + tile] = runs[:, t, :, r:r + tile, c:c + tile]
    return out


@pytest.mark.parametrize('kind,res', [
    ('random', 32), ('random', 40), ('random', 64), ('road', 32), ('road', 40),
    ('road', 64), ('boundary', 32), ('boundary', 40), ('boundary', 64), ('il', 64)])
def test_masked_forward_is_bit_identical(kind, res):
    ops, _ = _case(kind, res)
    keep = soft.soft_tile_lists_reference(ops[0], res)
    assert int((~keep).sum()) > 0 and int(keep.sum()) > 0
    want = soft.soft_raster_fwd_reference(*ops)
    assert torch.equal(_masked_forward(ops, keep), want)
    # the cull is not vacuous: some pixel sees a face
    assert float((want - ops[3]).abs().max()) > 0


@pytest.mark.parametrize('kind', ['random', 'road', 'boundary', 'il'])
def test_backward_over_listed_faces_is_bit_identical(kind):
    res = 16
    ops, g = _case(kind, res)
    keep = soft.soft_tile_lists_reference(ops[0], res)[:, 0]        # (B, F)
    dropped = 0
    for cam in range(ops[0].shape[0]):
        one = lambda x: x[cam:cam + 1]
        coef, zw, color, bg = map(one, ops)
        full = soft.soft_raster_bwd_reference(coef, zw, color, bg, one(g))
        rows = chip_smoke.accum_rows(full[:3])[0]
        listed = keep[cam].nonzero()[:, 0]
        got = soft.soft_raster_bwd_reference(coef[:, listed], zw[:, :, listed],
                                             color[:, listed], bg, one(g))
        assert torch.equal(chip_smoke.accum_rows(got[:3])[0], rows[listed])
        assert torch.equal(got[3], full[3])
        assert int((rows[~keep[cam]] != 0).sum()) == 0
        assert float(rows[listed].abs().max()) > 0
        dropped += int((~keep[cam]).sum())
    assert dropped > 0


def test_slack_keeps_faces_the_float64_test_alone_would_drop(monkeypatch):
    """The boundary operands' slack faces (``chip_smoke.slack_edge``: float32
    edge value nextafter(-4, 0) at a tile's first pixel, exact value <= -4)
    are what the cull's slack is for: without it the plain cull drops some,
    and the masked forward then differs from the unculled one, as the
    card's bit-for-bit checks of these operands would."""
    ops, _ = chip_smoke.soft_case_operands('boundary', 15, 4, 97, 40, 'cpu')
    want = soft.soft_raster_fwd_reference(*ops)
    keep = soft.soft_tile_lists_reference(ops[0], 40)
    monkeypatch.setattr(soft, '_CULL_SLACK', 0.0)
    keep_without = soft.soft_tile_lists_reference(ops[0], 40)
    assert int((keep_without & ~keep).sum()) == 0
    assert int((keep & ~keep_without).sum()) > 0
    assert int((_masked_forward(ops, keep_without) != want).sum()) > 0
