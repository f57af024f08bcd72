"""
The float-color hard raster (``torchdrivesim_tpu_torch.ops.hard_faces``,
kernel HF on the card) on the CPU against the JAX package's plain hard
raster (``rasterize_hard_faces``, and ``_rasterize_hard_rect`` for frames
that are not square):

* the plain version (image and winner index) on random faces of both
  windings with every fifth degenerate, z on four levels (ties), z at
  BIG_Z, +-inf and NaN, corners on pixel centres, slivers, corners a few
  ulps off pixel centres, up to +-1e6, +-inf and NaN, and a crowded tile,
  square and rectangular, against the reference jitted: exact wherever the image does
  not hang on the rounding of an edge value's ``ex * dy - ey * dx`` (the
  reference's compiled code may fuse a product into the difference), and
  the reference's value one of the roundings' everywhere;
* the autograd.Function's gradients (colors, background) against autograd
  through the plain ``torch.where`` chain and against ``jax.grad`` of the
  reference;
* the kernel's per-tile float64 edge test (its plain version
  ``hard_faces_tile_keep_reference``) drops no face that covers a pixel of
  its tile and can win;
* the kernel's per-tile lists (their plain version
  ``hard_faces_tile_lists_reference``: each face's conservative box of
  tiles, ``face_tile_ranges``, and the edge test) drop no (tile, face) pair
  in which the face covers a pixel centre under HF's rounding, on the cases
  above and on corners a few ulps off pixel centres, up to +-1e6, +-inf and
  NaN; they are ascending and a subset of the edge test's pairs, and
  ``hard_faces_cover_reference`` gives exactly the covering pairs;
* the differentiable primitive render and the differentiable face soup
  run HF (one call per frame) and no other raster.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torchdrivesim_tpu_torch.ops import hard_faces as HF
from torchdrivesim_tpu_torch.rendering.base import Cameras
from torchdrivesim_tpu_torch.utils import Resolution

torch.set_num_threads(1)


def _fma_first(ex, dy, ey, dx):
    """``ex * dy - ey * dx`` with the first product fused into the
    difference."""
    return (ex.double() * dy.double() - (ey * dx).double()).float()


def _fma_second(ex, dy, ey, dx):
    """... with the second product fused."""
    return ((ex * dy).double() - ey.double() * dx.double()).float()


def _reference_rect(corners, z, color, bg_hwc):
    """The reference's rectangular plain raster of a face soup, jitted: each
    face as its own three vertices, z and color on every vertex."""
    from torchdrivesim_tpu.ops.rasterize import _rasterize_hard_rect
    b, f = z.shape
    h, w = bg_hwc.shape[1:3]
    verts = np.concatenate([corners.reshape(b, f * 3, 2),
                            np.repeat(z, 3, axis=1)[..., None]], -1)
    faces = np.arange(f * 3, dtype=np.int32).reshape(1, f, 3).repeat(b, 0)
    attrs = np.repeat(color, 3, axis=1)
    fn = jax.jit(lambda v, fc, a, bg: _rasterize_hard_rect(v, fc, a, h, w, bg))
    return np.asarray(fn(*map(jnp.asarray, (verts, faces, attrs, bg_hwc))))


CASES = {
    'random_square': ('random', 0, 2, 120, 32, 32),
    'random_rect': ('random', 1, 2, 200, 24, 56),
    'centres_rect': ('centres', 2, 2, 90, 40, 24),
    'slivers_square': ('slivers', 3, 2, 120, 32, 32),
    'no_faces': ('random', 4, 1, 0, 16, 16),
    'ulps_square': ('ulps', 10, 2, 150, 32, 32),
    'far_rect': ('far', 11, 2, 120, 24, 56),
    'nonfinite_square': ('nonfinite', 12, 2, 120, 32, 32),
    'crowd_square': ('crowd', 13, 1, 600, 32, 32),
}


@pytest.mark.parametrize('case', list(CASES))
def test_plain_version_matches_jax(case, monkeypatch):
    kind, seed, b, f, h, w = CASES[case]
    ops = chip_smoke.hf_random_operands(kind, seed, b, f, h, w, 'cpu')
    corners, z, color, bg = (t.numpy() for t in ops)
    want = _reference_rect(corners, z, color, bg.transpose(0, 2, 3, 1)).transpose(0, 3, 1, 2)
    if h == w:
        from torchdrivesim_tpu.ops.rasterize import rasterize_hard_faces
        square = jax.jit(lambda c, zz, col, g: rasterize_hard_faces(c, zz, col, h, g))(
            *map(jnp.asarray, (corners, z, color, bg.transpose(0, 2, 3, 1))))
        np.testing.assert_array_equal(np.asarray(square).transpose(0, 3, 1, 2), want)
    got, winner = HF.hard_faces(*ops)
    variants = [got.numpy()]
    for rounding in (_fma_first, _fma_second):
        monkeypatch.setattr(HF, 'edge_value', rounding)
        variants.append(HF.hard_faces(*ops)[0].numpy())
    monkeypatch.undo()
    determinate = np.logical_and.reduce([v == variants[0] for v in variants])
    explained = np.logical_or.reduce([v == want for v in variants])
    ambiguous = int((~determinate).any(axis=1).sum())
    print(f'{case}: {int((variants[0] != want).any(axis=1).sum())} of {b * h * w} '
          f'pixels differ from the reference, {ambiguous} hang on the rounding')
    np.testing.assert_array_equal(variants[0][determinate], want[determinate])
    assert explained.all()
    # slivers with edges through pixel centres are built to hang on it
    assert ambiguous <= (0.25 if kind == 'slivers' else 0.01) * b * h * w
    # the winner index names the face whose color the pixel took
    won = winner.numpy() >= 0
    if not f:
        assert not won.any() and np.array_equal(got.numpy(), bg)
        return
    idx = np.clip(winner.numpy(), 0, None)
    picked = np.take_along_axis(color, idx.reshape(b, -1, 1), axis=1).reshape(b, h, w, 3)
    np.testing.assert_array_equal(np.where(won[..., None], picked,
                                           bg.transpose(0, 2, 3, 1)),
                                  got.numpy().transpose(0, 2, 3, 1))
    assert 0 < won.mean() and (kind == 'slivers' or won.mean() > 0.5)


def test_ties_keep_the_first_face_and_bad_z_never_wins():
    """Two identical faces over the whole frame at the same z: the first
    wins; a face at BIG_Z, +inf or NaN before them never does; -inf wins."""
    big = [[-5.0, -5.0], [40.0, -5.0], [-5.0, 40.0]]
    corners = torch.tensor([[big, big[::-1], big, big]], dtype=torch.float32)
    color = torch.eye(4, 3)[None]
    bg = torch.zeros(1, 3, 16, 16)
    for bad in (1e9, float('inf'), float('nan')):
        z = torch.tensor([[bad, 2.0, 2.0, 3.0]])
        image, winner = HF.hard_faces(corners, z, color, bg)
        assert (winner == 1).all() and (image[0, 1] == 1).all()
    image, winner = HF.hard_faces(corners, torch.tensor([[2.0, 2.0, float('-inf'), 3.0]]),
                                  color, bg)
    assert (winner == 2).all()


def test_gradients_match_the_plain_chain_and_jax():
    from torchdrivesim_tpu.ops.rasterize import rasterize_hard_faces
    ops = chip_smoke.hf_random_operands('random', 5, 2, 60, 24, 24, 'cpu')
    corners, z, color, bg = ops
    g = torch.from_numpy(np.random.RandomState(6).rand(2, 3, 24, 24).astype(np.float32))
    grads = []
    for fn in (lambda c, b: HF.rasterize_hard_faces(corners, z, c, b),
               lambda c, b: HF.hard_faces_reference(corners, z, c, b)[0]):
        c, b = color.clone().requires_grad_(), bg.clone().requires_grad_()
        grads.append(torch.autograd.grad((fn(c, b) * g).sum(), (c, b)))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    jgrad = jax.grad(lambda c, b: jnp.sum(rasterize_hard_faces(
        jnp.asarray(corners.numpy()), jnp.asarray(z.numpy()), c, 24, b)
        * jnp.asarray(g.numpy().transpose(0, 2, 3, 1))), argnums=(0, 1))(
        jnp.asarray(color.numpy()), jnp.asarray(bg.numpy().transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(grads[0][0].numpy(), np.asarray(jgrad[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(grads[0][1].numpy(),
                               np.asarray(jgrad[1]).transpose(0, 3, 1, 2), rtol=0, atol=0)
    assert float(grads[0][0].abs().sum()) > 0 and float(grads[0][1].abs().sum()) > 0


@pytest.mark.parametrize('kind,h,w', [('random', 40, 40), ('centres', 40, 56),
                                      ('slivers', 48, 40), ('grazing', 48, 48)])
def test_tile_cull_drops_no_face_that_can_win(kind, h, w):
    ops = chip_smoke.hf_grazing_operands(9, 2, 40, h, 'cpu') if kind == 'grazing' \
        else chip_smoke.hf_random_operands(kind, 9, 2, 150, h, w, 'cpu')
    corners, z, color, bg = ops
    keep = HF.hard_faces_tile_keep_reference(corners, z, h, w)     # (B, tiles, F)
    a0, a1, ex, ey, area = HF._face_edges(corners)
    px = (torch.arange(h) + 0.5)[:, None].expand(h, w)
    py = (torch.arange(w) + 0.5)[None, :].expand(h, w)
    e = HF.edge_value(ex[..., None, None], py - a1[..., None, None],
                      ey[..., None, None], px - a0[..., None, None])     # (B, F, 3, H, W)
    cover = ((e >= 0).all(dim=2) | (e <= 0).all(dim=2)) & HF._usable(area, z)[..., None, None]
    tw = -(-w // HF.TILE)
    ty, tx = torch.arange(h) // HF.TILE, torch.arange(w) // HF.TILE
    tile_of = ty[:, None] * tw + tx[None, :]                          # (H, W)
    kept_at = keep[:, tile_of.reshape(-1)].reshape(2, h, w, -1).permute(0, 3, 1, 2)
    assert not (cover & ~kept_at).any()
    dropped = 1.0 - float(keep.float().mean())
    print(f'{kind}: the cull drops {dropped * 100:.1f}% of the (tile, face) pairs')
    assert dropped > 0.3


def _dense_cover(corners, z, h, w):
    """(B, tiles, F) whether the face covers a pixel centre of the tile
    under HF's rounding and passes its area and z tests, pixel by pixel."""
    a0, a1, ex, ey, area = HF._face_edges(corners)
    px = (torch.arange(h) + 0.5)[:, None].expand(h, w)
    py = (torch.arange(w) + 0.5)[None, :].expand(h, w)
    e = HF.edge_value(ex[..., None, None], py - a1[..., None, None],
                      ey[..., None, None], px - a0[..., None, None])     # (B, F, 3, H, W)
    cover = ((e >= 0).all(dim=2) | (e <= 0).all(dim=2)) & HF._usable(area, z)[..., None, None]
    b, f = z.shape
    th, tw = -(-h // HF.TILE), -(-w // HF.TILE)
    padded = torch.zeros(b, f, th * HF.TILE, tw * HF.TILE, dtype=torch.bool)
    padded[..., :h, :w] = cover
    return padded.reshape(b, f, th, HF.TILE, tw, HF.TILE).any(-1).any(-2) \
        .reshape(b, f, th * tw).transpose(1, 2)


@pytest.mark.parametrize('kind,f,h,w', [
    ('random', 150, 40, 40), ('centres', 150, 40, 56), ('slivers', 150, 48, 40),
    ('grazing', 40, 48, 48), ('ulps', 150, 40, 40), ('far', 150, 40, 56),
    ('nonfinite', 150, 40, 40), ('crowd', 700, 32, 32)])
def test_tile_lists_keep_every_covering_pair(kind, f, h, w):
    ops = chip_smoke.hf_grazing_operands(9, 2, f, h, 'cpu') if kind == 'grazing' \
        else chip_smoke.hf_random_operands(kind, 9, 2, f, h, w, 'cpu')
    corners, z = ops[:2]
    lists, counts = HF.hard_faces_tile_lists_reference(corners, z, h, w)
    b, tiles = counts.shape
    assert torch.equal(counts, (lists >= 0).sum(-1).to(torch.int32))
    assert ((lists[..., 1:] > lists[..., :-1]) | (lists[..., 1:] < 0)).all()   # ascending
    listed = torch.zeros(b, tiles, f + 1, dtype=torch.bool)
    listed.scatter_(2, lists.long() % (f + 1), True)                # -1 lands in slot f
    listed = listed[..., :f]
    cover = _dense_cover(corners, z, h, w)
    assert not (cover & ~listed).any()
    assert not (listed & ~HF.hard_faces_tile_keep_reference(corners, z, h, w)).any()
    cam, face, tile = HF.hard_faces_cover_reference(corners, z, h, w, chunk=97)
    got = torch.zeros_like(cover)
    got[cam, tile, face] = True
    assert torch.equal(got, cover) and len(cam) == int(cover.sum())
    # a face whose area or z test fails has an empty range; some faces get
    # the whole frame (non-finite corners, slivers), some an empty one
    rng = HF.face_tile_ranges(corners, z, h, w)
    empty = (rng[..., 0] > rng[..., 1]) | (rng[..., 2] > rng[..., 3])
    assert empty[~HF._usable(HF._face_edges(corners)[4], z)].all()
    print(f'{kind}: {int(listed.sum())} listed, {int(cover.sum())} covering pairs, '
          f'longest list {int(counts.max())} (capacity {HF.list_capacity(f)})')
    if kind == 'crowd':
        assert int(counts.max()) > HF.list_capacity(f)
    if kind == 'nonfinite':
        bad = ~torch.isfinite(corners).flatten(-2).all(-1) & HF._usable(HF._face_edges(corners)[4], z)
        assert bad.any() and (rng[bad] == torch.tensor([0, (h - 1) // 16, 0, (w - 1) // 16])).all()


def test_hard_faces_scratch_is_sized_from_the_shapes():
    assert HF.list_capacity(94) == 94 and HF.list_capacity(59744) == HF.LIST_CAP
    # one 64-byte record per face; a count and the list per 16 x 16 tile
    assert HF.scratch_bytes(1, 59744, 512, 1121) == 59744 * 64 + 2272 * 4 * (1 + HF.LIST_CAP)
    assert HF.scratch_bytes(3, 0, 16, 16) == 3 * 4


def test_differentiable_routes_run_hf_once(monkeypatch):
    """The differentiable primitive render and face soup call ``hard_faces``
    once per frame and nothing else that rasterizes."""
    import torchdrivesim_tpu_torch.ops.hard_faces as hf_module
    import torchdrivesim_tpu_torch.rendering.renderer as R
    from torchdrivesim_tpu_torch.rendering import Renderer, RendererConfig
    calls, real = [], hf_module.hard_faces

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    def refuse(*args, **kw):
        raise AssertionError('another raster ran')
    monkeypatch.setattr(hf_module, 'hard_faces', counted)
    for name in ('raster', 'render_coefs_fused', 'rasterize_hard_prims_banded',
                 'rasterize_softmax_coefs'):
        monkeypatch.setattr(R, name, refuse)
    renderer = Renderer(RendererConfig(differentiable=True), 'cpu')
    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rng.uniform(-10, 10, s).astype(np.float32))
    cams = Cameras(t(2, 2), torch.tensor([[0.0, 1.0], [1.0, 0.0]]), 2.0 / 40)
    colors = lambda n: torch.from_numpy(rng.rand(2, n, 3).astype(np.float32))
    image = renderer.render_prims_chw(t(2, 5, 4, 2), t(2, 5), colors(5), t(2, 3, 3, 2),
                                      t(2, 3), colors(3), Resolution(32, 32), cams)
    assert calls == [(2, 13, 3, 2)] and image.shape == (2, 3, 32, 32)
    image = renderer.render_faces_chw(t(2, 7, 3, 2), t(2, 7), colors(7),
                                      Resolution(48, 48), cams)
    assert len(calls) == 2 and calls[1] == (2, 7, 3, 2) and torch.isfinite(image).all()
    hard = Renderer(dataclasses.replace(renderer.cfg, differentiable=False), 'cpu')
    monkeypatch.setattr(R, 'raster', lambda *a: torch.zeros(2, 3, 32, 32))
    hard.render_faces_chw(t(2, 7, 3, 2), t(2, 7), colors(7), Resolution(32, 32), cams)
    assert len(calls) == 2
