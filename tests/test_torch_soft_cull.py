"""
The grouped soft raster's per-tile face cull, on the CPU: the plain version
``ops/soft.py: soft_tile_lists_reference`` of the first phase of kernels B5a
and B5b (``csrc/soft_accum.cu``), which drops a face from a 16 x 16 pixel
tile where one of its edge values is at most -4 - slack over the whole tile.

* The cull keeps every (tile, face) pair in which the face's float32 window
  ramp ``clamp(tmin + 4, 0, 1)`` is nonzero at some pixel of the tile (a
  nonzero alpha needs a nonzero window): on random faces, on road-like faces
  (most far off-view, as on the Town02 frame) and on boundary faces whose
  largest edge value over a tile is nextafter(-4, 0) (kept), exactly -4 (may
  be dropped) or -4.001 (dropped).
* The plain grouped forward with each tile's dropped faces replaced by
  padding faces equals the unculled forward bit for bit, at res 40 (ragged
  tiles), 48 and 64.
* At res 16 (one tile) the plain grouped backward over the listed faces
  only, each group's listed faces as one group (the kernel's segments;
  groups with none left out), gives the listed faces' rows bit for bit, and
  the unculled backward's rows of the dropped faces are 0.

Operands come from ``chip_smoke`` (numpy, fixed seeds), whose card checks
use the same generators.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from torchdrivesim_tpu_torch.ops import soft

torch.set_num_threads(1)

MAKERS = {'random': chip_smoke.accum_random_operands,
          'road': chip_smoke.accum_road_operands,
          'boundary': chip_smoke.accum_boundary_operands}
#: (seed, cameras, faces before padding) per kind
SIZES = {'random': (31, 2, 200), 'road': (32, 1, 1000), 'boundary': (33, 2, 120)}


def _operands(kind, res):
    seed, b, n_faces = SIZES[kind]
    return MAKERS[kind](seed + res, b, n_faces, res, 'cpu')


def _reach(coef, res):
    """(B, tiles, F): where the face's window ramp is nonzero at some pixel
    of the tile, by the plain version's own float32 face terms."""
    b, n_faces = coef.shape[:2]
    px, py = soft._pixel_grids(res, coef)
    tile = soft.ACCUM_TILE
    per = -(-res // tile)
    extra = per * tile - res
    out = []
    for f in range(n_faces):
        tmin = soft._face_terms(coef, f, px, py)[3]
        window = F.pad(torch.clamp(tmin + 4.0, 0.0, 1.0), (0, extra, 0, extra))
        out.append((window > 0).reshape(b, per, tile, per, tile).any(dim=4).any(dim=2)
                   .reshape(b, per * per))
    return torch.stack(out, dim=-1)


@pytest.mark.parametrize('kind,res', [('random', 40), ('road', 64), ('boundary', 64),
                                      ('boundary', 40)])
def test_cull_keeps_every_reaching_pair(kind, res):
    (coef, _, _), _ = _operands(kind, res)
    keep = soft.soft_tile_lists_reference(coef, res)
    reach = _reach(coef, res)
    assert keep.shape == reach.shape == (coef.shape[0], soft.accum_tiles(res),
                                         coef.shape[1])
    assert int((reach & ~keep).sum()) == 0
    assert int(reach.sum()) > 0
    # at least the pairs the card's bounds count (no slack there)
    assert int(keep.sum()) >= chip_smoke.soft_tile_pairs(coef, res)
    # the cull drops something, and on the road most pairs
    assert int((~keep).sum()) > 0
    if kind == 'road':
        assert float(keep.double().mean()) < 0.2
    if kind == 'boundary':
        # the boundary faces: first edge only, kept where nextafter(-4, 0)
        # is reached; the slack keeps some that reach nowhere (the -4 ones)
        edge_only = (coef[:, :, 1:] == 0).all(dim=(2, 3)) & (coef[:, :, 0, :2] != 0).all(-1)
        assert int(edge_only.sum()) == 3 * coef.shape[0] * soft.accum_tiles(res)
        assert int((keep & ~reach & edge_only[:, None, :]).sum()) > 0


def test_cull_boundary_faces_by_hand():
    """One face per case at res 16 (one tile): its only live edge is
    nextafter(-4, 0) at pixel (0.5, 15.5) and lower elsewhere (kept, and its
    alpha there is nonzero), exactly -4 there (window 0 everywhere), or
    -4.001 (dropped)."""
    f32 = np.float32
    rng = np.random.RandomState(5)
    rows = []
    for target in (np.nextafter(f32(-4), f32(0)), f32(-4), f32(-4.001)):
        a, b, c = chip_smoke.boundary_edge(rng, -0.5, 15.5, target)
        rows.append([[a, b, c], [0, 0, 0], [0, 0, 0]])
    coef = torch.as_tensor(np.asarray([rows], np.float32))
    px, py = soft._pixel_grids(16, coef)
    keep = soft.soft_tile_lists_reference(coef, 16)[0, 0]
    edges, _, _, _, alpha = soft._face_terms(coef, 0, px, py)
    assert float(edges[0][0, 0, 15]) == float(np.nextafter(f32(-4), f32(0)))
    assert float(alpha[0, 0, 15]) > 0 and int((alpha > 0).sum()) == 1
    assert float(soft._face_terms(coef, 1, px, py)[3].max()) == -4.0
    assert float(soft._face_terms(coef, 2, px, py)[3].max()) <= float(f32(-4.001))
    assert keep.tolist() == [True, True, False]


def _masked_forward(ops, keep, res):
    """``soft_accum_fwd_reference`` with each tile's dropped faces replaced
    by padding faces: every tile runs as a camera of its own, and each pixel
    is taken from its tile's run."""
    coef, zw, color = ops
    b, tiles, n_faces = keep.shape
    kept = keep.reshape(b * tiles, n_faces)
    rep = lambda x: x.repeat_interleave(tiles, dim=0)
    pad = torch.zeros((3, 3), dtype=coef.dtype)
    pad[:, 2] = -1e9
    runs = soft.soft_accum_fwd_reference(
        torch.where(kept[..., None, None], rep(coef), pad),
        torch.where(kept[:, None, :], rep(zw), torch.zeros((), dtype=zw.dtype)),
        torch.where(kept[..., None], rep(color), torch.zeros((), dtype=color.dtype)),
        res)
    per, tile = -(-res // soft.ACCUM_TILE), soft.ACCUM_TILE
    out = []
    for x in runs:
        x = x.reshape(b, tiles, *x.shape[1:])
        y = torch.empty_like(x[:, 0])
        for t in range(tiles):
            r, c = (t // per) * tile, (t % per) * tile
            y[..., r:r + tile, c:c + tile] = x[:, t, ..., r:r + tile, c:c + tile]
        out.append(y)
    return out


@pytest.mark.parametrize('kind', ['random', 'road', 'boundary'])
@pytest.mark.parametrize('res', [40, 48, 64])
def test_masked_forward_is_bit_identical(kind, res):
    ops, _ = _operands(kind, res)
    keep = soft.soft_tile_lists_reference(ops[0], res)
    assert int((~keep).sum()) > 0
    want = soft.soft_accum_fwd_reference(*ops, res)
    got = _masked_forward(ops, keep, res)
    for name, a, w in zip(('num', 'den', 'transp'), got, want):
        assert torch.equal(a, w), name
    # the cull is not vacuous: some pixel sees a face
    assert float((1.0 - want[2]).max()) > 0


def _segments(listed: torch.Tensor):
    """Slices of ``listed`` (ascending face indices) by group: the
    kernel's segments."""
    groups = (listed // soft.MAX_FACES).tolist()
    cuts = [0] + [i for i in range(1, len(groups)) if groups[i] != groups[i - 1]]
    return [slice(lo, hi) for lo, hi in zip(cuts, cuts[1:] + [len(groups)])]


@pytest.mark.parametrize('kind', ['random', 'road', 'boundary'])
def test_backward_over_listed_faces_is_bit_identical(monkeypatch, kind):
    res = 16
    ops, bg = _operands(kind, res)
    keep = soft.soft_tile_lists_reference(ops[0], res)[:, 0]        # (B, F)
    totals = soft.soft_accum_fwd_reference(*ops, res)
    grads = chip_smoke.composite_cotangents(soft, totals, bg, 7)
    dropped = 0
    for cot in (grads, (torch.zeros_like(grads[0]), torch.zeros_like(grads[1]), grads[2])):
        for cam in range(ops[0].shape[0]):
            one = lambda x: x[cam:cam + 1]
            coef, zw, color = map(one, ops)
            cam_cot = [one(c) for c in cot]
            full = chip_smoke.accum_rows(soft.soft_accum_bwd_reference(
                coef, zw, color, *cam_cot))[0]
            listed = keep[cam].nonzero()[:, 0]
            with monkeypatch.context() as m:
                m.setattr(soft, '_groups', lambda n: _segments(listed))
                got = chip_smoke.accum_rows(soft.soft_accum_bwd_reference(
                    coef[:, listed], zw[:, :, listed], color[:, listed], *cam_cot))[0]
            assert torch.equal(got, full[listed])
            assert int((full[~keep[cam]] != 0).sum()) == 0
            assert float(got.abs().max()) > 0
            dropped += int((~keep[cam]).sum())
    assert dropped > 0
