"""
The hard raster's per-tile face cull, on the CPU: the plain version
``ops/hard.py: hard_tile_keep_reference`` of the test with which each 16 x
16 pixel tile of kernels B6a and B6b (``csrc/hard_raster.cu``) drops the
faces that cannot reach it, and the plain version of the chunked kernel's
fold over each tile's kept faces (``raster_chunked_listed_reference``; the
packed kernel's minimum is order-free, so the first item below is all its
fold needs).

* No dropped face is inside at any pixel of its tile (brute force over
  every pixel, res 32 and 40, whose last tile row and column are ragged),
  on random faces, on faces touching a tile only at its corner pixel centre
  (``chip_smoke.hard_boundary_faces``: without the cull's slack the test
  drops faces that count there) and on the tie scene below.
* The listed fold equals the unculled plain versions bit for bit: random
  faces at res 64, 32 and the ragged 40 and 72, the packed scenes (12 and
  127 faces) as chunked operands of one partial chunk; the tie
  scene (``chip_smoke.hard_tie_operands``: one z for the faces around each
  chunk boundary 128, 256, ..., colors falling with the index), on which a
  plain face-by-face ``<`` fold, or the smallest color over all chunks,
  gives other pixels; and the boundary faces.
* Hand-made edges (``chip_smoke.hard_edge_operands``, res 40): an edge
  through the ragged last row's (column's) pixel centres, all-zero edges, a
  subnormal edge (kept only by delta's underflow term), NaN and infinite
  coefficients and a zero-area face with the sentinel key.

Operands come from numpy with fixed seeds.
"""
import pytest
import torch

import chip_smoke
from torchdrivesim_tpu_torch.ops import hard, prims, warp

torch.set_num_threads(1)

TILE = prims.PRIM_TILE


def _scene(kind, res):
    """((coef, key[, rgb]), background, sentinel) of one test scene."""
    seed = 7 * res + len(kind)
    if kind == 'ties':
        ops, bg = chip_smoke.hard_tie_operands(seed, 2, 600, res, 'cpu')
    else:
        n_faces = {'random_packed': 40, 'random_chunked': 300, 'boundary': 48}[kind]
        make = chip_smoke.hard_boundary_faces if kind == 'boundary' else hard.random_faces
        *faces, bg = make(seed, 2, n_faces, res, 'cpu')
        ops = hard.hard_operands(*faces)
    return ops, bg, hard.PACKED_SENTINEL if len(ops) == 2 else hard.Z_SENTINEL


def _inside(coef, res):
    """(B, F, res, res) the plain float32 inside test at every pixel."""
    px = (torch.arange(res, dtype=torch.float32) + 0.5)[:, None]
    py = (torch.arange(res, dtype=torch.float32) + 0.5)[None, :]

    def edge(k):
        c = lambda j: coef[:, k, :, j, None, None]
        return warp.affine(c(0), px, c(1), py, c(2))
    return torch.minimum(torch.minimum(edge(0), edge(1)), edge(2)) >= 0


def _reach(ops, sentinel, res):
    """(B, tiles, F): whether each face, its key not the sentinel, is inside
    at some pixel of each tile (tiles row-major, the last ones ragged)."""
    x = _inside(ops[0], res) & (ops[1] != sentinel)[..., None, None]
    b, f = x.shape[:2]
    per = -(-res // TILE)
    pad = per * TILE - res
    x = torch.nn.functional.pad(x, (0, pad, 0, pad))
    return x.reshape(b, f, per, TILE, per, TILE).any(dim=5).any(dim=3) \
        .reshape(b, f, per * per).transpose(1, 2)


def _as_chunked(coef, packed):
    """Chunked operands that give the packed operands' image: z-bits of
    rank + 1 (the sentinel kept), the pack's RGB8. With at most 127 faces,
    one chunk: its minimum color among exactly the least z-bits is the
    packed minimum's color."""
    rank = (packed >> 24).float() + 1.0
    zbits = torch.where(packed == hard.PACKED_SENTINEL, hard.Z_SENTINEL,
                        rank.view(torch.int32))
    return coef, zbits, packed & 0xFFFFFF


@pytest.mark.parametrize('res', (32, 40))
@pytest.mark.parametrize('kind', ('random_packed', 'random_chunked', 'boundary', 'ties'))
def test_cull_drops_no_face_that_reaches_its_tile(kind, res, monkeypatch):
    ops, _, sentinel = _scene(kind, res)
    keep = hard.hard_tile_keep_reference(ops[0], ops[1], sentinel, res)
    reach = _reach(ops, sentinel, res)
    b, f = ops[1].shape
    assert keep.shape == reach.shape == (b, hard.hard_tiles(res), f)
    assert int(reach.sum()) > 0
    assert int((reach & ~keep).sum()) == 0
    # the sentinel is never kept, and the cull drops real faces
    assert not bool((keep & (ops[1] == sentinel)[:, None, :]).any())
    assert int((~keep & (ops[1] != sentinel)[:, None, :]).sum()) > 0
    if kind == 'boundary':
        # without the slack the cull would drop faces that count here
        monkeypatch.setattr(prims, '_CULL_SLACK', 0.0)
        bare = hard.hard_tile_keep_reference(ops[0], ops[1], sentinel, res)
        assert int((reach & ~bare).sum()) > 0


@pytest.mark.parametrize('kind,n_faces,res', [
    ('random', 12, 64), ('random', 127, 40), ('random', 128, 32), ('random', 300, 72),
    ('random', 300, 40), ('ties', 600, 32), ('ties', 600, 40), ('boundary', 48, 32)])
def test_listed_fold_equals_plain_versions(kind, n_faces, res):
    if kind == 'ties':
        ops, bg = chip_smoke.hard_tie_operands(n_faces + res, 2, n_faces, res, 'cpu')
    else:
        make = chip_smoke.hard_boundary_faces if kind == 'boundary' else hard.random_faces
        *faces, bg = make(n_faces + res, 2, n_faces, res, 'cpu')
        ops = hard.hard_operands(*faces)
    assert len(ops) == (2 if n_faces <= hard.MAX_PACKED_FACES else 3)
    want = hard.raster_reference(ops, bg, res)
    if len(ops) == 2:
        ops = _as_chunked(*ops)
        assert torch.equal(hard.raster_chunked_reference(*ops, bg, res), want)
    assert torch.equal(hard.raster_chunked_listed_reference(*ops, bg, res), want)
    assert int((want != bg).any(dim=1).sum()) > 0           # some faces show


@pytest.mark.parametrize('res', (32, 40))
def test_tie_scene_needs_the_chunk_semantics(res):
    """On the tie scene the plain version's pixels differ from both folds
    that ignore the chunks: the first inside face with the least z-bits
    (a face-by-face ``<``) and the smallest color among all inside faces
    with the least z-bits. So the listed fold's equality above tests the
    chunk runs and the strict-less fold."""
    (coef, zbits, rgb), bg = chip_smoke.hard_tie_operands(600 + res, 2, 600, res, 'cpu')
    want = hard.raster_chunked_reference(coef, zbits, rgb, bg, res)
    zv = torch.where(_inside(coef, res), zbits[..., None, None], hard.Z_SENTINEL)
    bz = zv.amin(dim=1, keepdim=True)
    hit = (zv == bz) & (bz < hard.Z_SENTINEL)
    first = torch.gather(rgb[..., None, None].expand_as(zv), 1,
                         hit.int().argmax(dim=1, keepdim=True))[:, 0]
    smallest = torch.where(hit, rgb[..., None, None], 1 << 24).amin(dim=1)
    covered = hit.any(dim=1)
    for naive in (first, smallest):
        img = hard._composite(covered.flatten(1), naive.flatten(1),
                              bg.flatten(2), res)
        assert int((img != want).any(dim=1).sum()) > 0


def test_cull_keeps_hand_made_edges(monkeypatch):
    """``chip_smoke.hard_edge_operands`` at res 40: the kept faces per tile
    (3 x 3 tiles, the last row and column 8 pixels wide), the pixels each
    face wins, and the listed fold equal to the plain versions of both
    kernels (packed and chunked give one image); without delta's underflow
    term the subnormal face is dropped from tile row 0, where it wins row
    15."""
    coef, packed, zbits, rgb = chip_smoke.hard_edge_operands('cpu')
    bg = torch.full((1, 3, 40, 40), 0.25)
    keep = hard.hard_tile_keep_reference(coef, packed, hard.PACKED_SENTINEL, 40)
    assert torch.equal(keep, hard.hard_tile_keep_reference(coef, zbits, hard.Z_SENTINEL, 40))
    rows = lambda *r: [t // 3 in r for t in range(9)]
    cols = lambda *c: [t % 3 in c for t in range(9)]
    assert keep[0, :, 0].tolist() == rows(0)                  # rows 0-10
    assert keep[0, :, 1].tolist() == rows(2)                  # row 39
    assert keep[0, :, 2].tolist() == cols(2)                  # column 39
    assert keep[0, :, 3].tolist() == rows(0, 1)               # rows 15-20
    assert keep[0, :, 4].tolist() == rows(0, 1)               # rows 0-30
    assert keep[0, :, 5].all() and keep[0, :, 6].all()        # zero, NaN
    assert not keep[0, :, 7].any()                            # sentinel
    img = hard.raster_packed_reference(coef, packed, bg, 40)
    assert torch.equal(hard.raster_chunked_listed_reference(coef, zbits, rgb, bg, 40), img)
    assert torch.equal(hard.raster_chunked_reference(coef, zbits, rgb, bg, 40), img)
    wins = {}
    for f, c in enumerate(rgb[0, :6].tolist()):
        want = torch.tensor([(c >> 16) & 255, (c >> 8) & 255, c & 255]) / 255.0
        wins[f] = int(((img[0] - want[:, None, None]).abs() < 1e-6).all(dim=0).sum())
    assert wins == {0: 11 * 39, 1: 40, 2: 39, 3: 6 * 39, 4: 14 * 39, 5: 8 * 39}
    monkeypatch.setattr(prims, '_CULL_UNDERFLOW', 0.0)
    bare = hard.hard_tile_keep_reference(coef, packed, hard.PACKED_SENTINEL, 40)
    assert bare[0, :, 3].tolist() == rows(1)
    assert not torch.equal(hard.raster_chunked_listed_reference(coef, zbits, rgb, bg, 40),
                           img)
