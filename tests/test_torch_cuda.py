"""
The port's CUDA kernels against their plain PyTorch versions on a CUDA card
(skips without one): the fused render, the nearest and bilinear background
warps, the soft raster's forward and backward, single-group and grouped,
the hard raster's packed and chunked kernels, and the primitive raster,
banded and unbanded.
Imports neither JAX nor the JAX package, so it also runs where JAX is
absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The fused render, the warps and the hard and primitive rasters must match
their plain versions exactly (the same operations, each rounded on its
own; the bilinear warp from the camera poses, on both branches,
left-handed and at the texture's corners and bounds). The bilinear warp's
pose VJP must come within rtol 1e-5 of its plain closed form (the same
float32 terms per pixel, float64 sums in another order) and within 1e-4 of
the autograd chain, and repeat bit for bit. The soft raster is judged
through its plain version in float64: the
kernel's error may exceed the plain version's by at most 1e-5 (forward)
or 1e-4 relative plus 1e-6 of the largest value (backward), since its
per-face sums run in another order; on the operands that stress its
per-tile face cull its forward and gbg must match exactly. The grouped
forward performs the plain version's operations in its order over the
faces that reach each pixel tile (the others add exactly 0), so it must
match it exactly; the grouped
backward is judged face by face (``chip_smoke.judge_rows``), for the
cotangents of the composite; the per-tile face lists must equal the plain
cull's. The fused render and the primitive rasters also run on the scenes
that stress their per-tile primitive cull (``chip_smoke.prim_cull_scene``:
boundary, parallelogram, near-degenerate and larger-than-view prims), bit
for bit, and on the simulator facade's egocentric frames, under the
per-type cap and past it (the sort route), bit for bit. The chunked hard
raster and the grouped soft raster also run on the frames of the NPC
replay and of the dataset imitation learning (the INTERACTION-layout data
that ``chip_smoke.write_interaction_data`` writes). The nearest warp and the
packed hard raster also run on the face-soup frame, and the soft raster
over the full-resolution bilinear background. The float-color hard raster
(HF) must match its plain version bit for bit, image and winner index, on
random, pixel-centred, sliver and tile-grazing faces and on the
differentiable primitive and face-soup frames.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torchdrivesim_tpu_torch.ops import fused, hard, prims, soft, warp
from torchdrivesim_tpu_torch.ops.rasterize import (
    n_bands_for, prep_sorted_prim_coefs, sort_prims_rowmajor_with_masks,
)
from torchdrivesim_tpu_torch.ops.warp import (
    build_mip_pyramid, select_mip, warp_coefficients,
)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


def _operands(seed, b, res, device):
    """Random screen-space scene; every other camera on the transposed
    branch (heading near 0 or 180 degrees)."""
    rng = np.random.RandomState(seed)
    tex = rng.rand(300, 300, 3).astype(np.float32)
    mip = select_mip(build_mip_pyramid(tex, np.zeros(2), 0.5), fov=40.0).to(device)
    ang = rng.rand(b) * 2 * np.pi
    ang[::2] = np.deg2rad(rng.uniform(-5, 5, ang[::2].shape))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    c0 = rng.rand(b, 30, 2) * 140 - 6
    e1, e2 = rng.randn(b, 30, 2) * 6, rng.randn(b, 30, 2) * 6
    quads = t(np.stack([c0, c0 + e1, c0 + e1 + e2, c0 + e2], axis=2))
    prep = prep_sorted_prim_coefs(
        quads, t(rng.rand(b, 30)), t(rng.rand(b, 30, 3)),
        t(rng.rand(b, 12, 3, 2) * 140 - 6), t(rng.rand(b, 12)),
        t(rng.rand(b, 12, 3)), res, 56, n_bands_for(res))
    qcoef, qpk, qmask, tcoef, tpk, tmask = prep
    fcoef, icoef = warp_coefficients(
        mip, t(rng.rand(b, 2) * 120 + 10),
        t(np.stack([np.sin(ang), np.cos(ang)], -1)), 2.0 / 40.0,
        t([0.1, 0.2, 0.3]), res=res)
    return mip, (fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask)


CULL_KINDS = ('boundary', 'parallelogram', 'near_degenerate', 'larger_than_view')


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('res,packed,kind', [
    (128, False, 'random'), (128, True, 'random'), (64, False, 'random'),
    (32, True, 'random'), (96, False, 'random'),
    *((res, packed, kind) for kind in CULL_KINDS for res in (128, 80, 16)
      for packed in (False, True))])
def test_kernel_matches_plain_version(cuda, res, packed, kind):
    if kind == 'random':
        mip, ops = _operands(res + packed, 8, res, cuda)
    else:
        from chip_smoke import cull_fused_operands
        mip, ops = cull_fused_operands(kind, res, 8, res, cuda)
    before = fused.LAUNCHES
    got = fused.render_coefs_fused(mip, *ops, res, packed)
    want = fused.render_coefs_fused_reference(mip, *ops, res, packed)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    assert int((got != want).sum()) == 0


def _warp_case(kind, res, b, device):
    """The bilinear warp's arguments for ``kind``: random poses (both
    branches), left-handed, cameras at the texture's corners, or cameras
    whose view rows and columns lie exactly on the texture's bounds."""
    from chip_smoke import bilinear_warp_case, edge_warp_case
    if kind == 'bounds':
        return edge_warp_case(device, res)
    corners = [[3.0, 4.0], [146.0, 2.0], [2.0, 147.0], [148.0, 149.0]] * (b // 4)
    return bilinear_warp_case(res + 1, b, device, left_handed=kind == 'left_handed',
                              cam_xy=corners if kind == 'corner' else None)


WARP_CASES = [(64, 16, 'random'), (128, 8, 'random'), (32, 4, 'random'),
              (64, 16, 'left_handed'), (64, 8, 'corner'), (64, 4, 'bounds')]


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('res,b,kind', WARP_CASES)
def test_warp_kernel_matches_plain_version(cuda, res, b, kind):
    """B3 from the poses equals ``warp_coefficients`` and the plain
    bilinear body bit for bit, the poses given as a strided slice."""
    mip, xy, sc, scale, bg, lh = _warp_case(kind, res, b, cuda)
    fcoef, icoef = warp_coefficients(mip, xy, sc, scale, bg, lh, res=res)
    if kind != 'bounds':
        assert (icoef[:, 0, 2] == 1).any() and (icoef[:, 0, 2] == 0).any()
    strided = torch.cat([xy, torch.zeros_like(xy)], dim=1)[:, :2]
    before = warp.LAUNCHES
    got = warp.warp_background_bilinear(mip, strided, sc, scale, bg, lh, res)
    want = warp.warp_view_bilinear_reference(mip.data, fcoef, icoef, res)
    torch.cuda.synchronize()
    assert warp.LAUNCHES == before + 1
    assert int((got != want).sum()) == 0


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('res,b,kind', WARP_CASES)
def test_warp_vjp_kernel_matches_plain_version(cuda, res, b, kind):
    """The pose-VJP kernel against its plain closed form (rtol 1e-5 with
    atol 1e-6 x max|grad|: the same float32 terms per pixel, float64 sums
    in another order) and the autograd chain (rtol 1e-4); a second launch
    repeats the first bit for bit."""
    from chip_smoke import autograd_warp_vjp, judge_vjp
    mip, xy, sc, scale, bg, lh = _warp_case(kind, res, b, cuda)
    out = warp.warp_background_bilinear_reference(mip, xy, sc, scale, bg, lh, res)
    g = torch.as_tensor(np.random.RandomState(res + b).uniform(
        -1, 1, tuple(out.shape)).astype(np.float32), device=cuda)
    before = warp.VJP_LAUNCHES
    got = warp.warp_bilinear_vjp(mip, out, g, xy, sc, scale, lh, res)
    again = warp.warp_bilinear_vjp(mip, out, g, xy, sc, scale, lh, res)
    plain = warp.warp_bilinear_vjp_reference(mip, out, g, xy, sc, scale, lh, res)
    chain = autograd_warp_vjp(warp, mip, out, g, xy, sc, scale, lh, res)
    torch.cuda.synchronize()
    assert warp.VJP_LAUNCHES == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert judge_vjp(got, plain, 1e-5)[1] == 0
    assert judge_vjp(got, chain)[1] == 0


def _soft_operands(seed, b, n_faces, res, device):
    """Random faces at the renderer's priority levels, one covering the
    view, one degenerate; a random background and output cotangent."""
    rng = np.random.RandomState(seed)
    verts = np.concatenate([rng.uniform(-8, res + 8, (b, n_faces * 3, 2)),
                            rng.uniform(2, 15, (b, n_faces * 3, 1))], axis=-1)
    verts[:, 0:3, :2] = [[-3 * res, -3 * res], [5 * res, -3 * res], [-3 * res, 5 * res]]
    verts[:, -3:] = 0.0
    verts[:, :, 2] = np.repeat(verts[:, ::3, 2], 3, axis=1)
    faces = np.tile(np.arange(n_faces * 3).reshape(1, n_faces, 3), (b, 1, 1))
    attrs = np.repeat(rng.rand(b, n_faces, 1, 3), 3, axis=2).reshape(b, n_faces * 3, 3)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    coef, zw, color = soft.soft_coefficients(
        t(verts), torch.as_tensor(faces, device=device), t(attrs), 0.5, 0.5)
    ops = (coef, zw[:, None, :].contiguous(), color, t(rng.rand(b, 3, res, res)))
    return ops, t(rng.uniform(-1, 1, (b, 3, res, res)))


def _judge(got, plain, exact, rtol, atol=None):
    got, plain, exact = got.double(), plain.double(), exact.double()
    if atol is None:
        atol = 1e-6 * float(exact.abs().max())
    tol = atol + rtol * exact.abs()
    return int(((got - exact).abs() > (plain - exact).abs() + tol).sum())


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('b,n_faces,res', [(16, 24, 64), (4, 128, 64), (2, 128, 128),
                                           (8, 45, 32)])
def test_soft_kernels_match_plain_versions(cuda, b, n_faces, res):
    ops, g = _soft_operands(n_faces + res, b, n_faces, res, cuda)
    exact_in = [x.double() for x in ops]
    before = (soft.FWD_LAUNCHES, soft.BWD_LAUNCHES)
    got = soft.soft_raster_fwd(*ops)
    assert _judge(got, soft.soft_raster_fwd_reference(*ops),
                  soft.soft_raster_fwd_reference(*exact_in), 0.0, 1e-5) == 0
    grads = soft.soft_raster_bwd(*ops, g)
    plain = soft.soft_raster_bwd_reference(*ops, g)
    exact = soft.soft_raster_bwd_reference(*exact_in, g.double())
    torch.cuda.synchronize()
    assert (soft.FWD_LAUNCHES, soft.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    for a, p, e in zip(grads, plain, exact):
        assert a.shape == p.shape
        assert _judge(a, p, e, 1e-4) == 0


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('kind,seed,b,n_faces,res', [
    ('boundary', 14, 4, 71, 64), ('boundary', 15, 4, 97, 40), ('road', 16, 8, 120, 64),
    ('random', 8, 2, 128, 128), ('random', 7, 8, 45, 32)])
def test_soft_kernels_on_cull_cases(cuda, kind, seed, b, n_faces, res):
    """B4a and B4b on the operands that stress their per-tile face cull
    (``chip_smoke.soft_case_operands``: edges that peak at nextafter(-4, 0),
    -4 or -4.001 at a tile corner, edges that only the cull's slack keeps,
    ragged tiles at res 40, road-like faces most off-view, the largest
    shared memory at F = 128, res 128): the forward and gbg equal to their
    plain versions bit for bit (the faces a tile drops add exactly 0
    there), the backward within the tolerance above."""
    from chip_smoke import soft_case_operands
    ops, g = soft_case_operands(kind, seed, b, n_faces, res, cuda)
    assert ops[0].shape[1] <= soft.MAX_FACES
    exact_in = [x.double() for x in ops]
    got, plain = soft.soft_raster_fwd(*ops), soft.soft_raster_fwd_reference(*ops)
    assert torch.equal(got, plain)
    grads = soft.soft_raster_bwd(*ops, g)
    want = soft.soft_raster_bwd_reference(*ops, g)
    exact = soft.soft_raster_bwd_reference(*exact_in, g.double())
    torch.cuda.synchronize()
    for a, p, e in zip(grads, want, exact):
        assert a.shape == p.shape
        assert _judge(a, p, e, 1e-4) == 0
    assert torch.equal(grads[3], want[3])


@pytest.mark.depends_on_cuda
def test_soft_backward_is_deterministic(cuda):
    ops, g = _soft_operands(3, 4, 128, 64, cuda)
    first = soft.soft_raster_bwd(*ops, g)
    second = soft.soft_raster_bwd(*ops, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _accum_operands(seed, b, n_faces, res, device, kind='random'):
    """Faces padded to whole groups (random: :func:`_soft_operands`;
    boundary and road: ``chip_smoke.accum_boundary_operands``,
    ``accum_road_operands``), the plain forward's totals and the cotangents
    the composite over its background sends to them."""
    import chip_smoke
    if kind == 'random':
        (coef, zw, color, bg), _ = _soft_operands(seed, b, n_faces, res, device)
        ops = soft.pad_to_groups(coef, zw, color)
    else:
        make = {'boundary': chip_smoke.accum_boundary_operands,
                'road': chip_smoke.accum_road_operands}[kind]
        ops, bg = make(seed, b, n_faces, res, device)
    totals = soft.soft_accum_fwd_reference(*ops, res)
    return ops, totals, chip_smoke.composite_cotangents(soft, totals, bg, seed + 1)


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('b,n_faces,res,kind', [
    (4, 129, 64, 'random'), (2, 300, 128, 'random'), (1, 2000, 256, 'random'),
    (16, 256, 64, 'random'), (2, 200, 64, 'boundary'), (1, 100, 40, 'boundary'),
    (2, 4500, 64, 'road')])
def test_grouped_soft_kernels_match_plain_versions(cuda, b, n_faces, res, kind):
    """B5a and B5b over every group in one launch each, a partial last
    group included, against their plain versions: the forward bit for bit,
    the backward face by face (``chip_smoke.judge_rows``) for the
    composite's cotangents and for the transp chain alone; on random faces,
    on boundary faces (an edge at nextafter(-4, 0), -4 or -4.001 at a tile's
    corner, ragged tiles at res 40) and on road-like faces, most off-view."""
    from chip_smoke import judge_rows
    ops, plain, grads = _accum_operands(n_faces + res, b, n_faces, res, cuda, kind)
    assert ops[0].shape[1] % soft.MAX_FACES == 0 and ops[0].shape[1] >= n_faces
    exact_in = [x.double() for x in ops]
    before = (soft.ACCUM_FWD_LAUNCHES, soft.ACCUM_BWD_LAUNCHES)
    for a, p in zip(soft.soft_accum_fwd(*ops, res), plain):
        assert torch.equal(a, p)
    for cot in (grads, (torch.zeros_like(grads[0]), torch.zeros_like(grads[1]), grads[2])):
        out = soft.soft_accum_bwd(*ops, *cot)
        want = soft.soft_accum_bwd_reference(*ops, *cot)
        exact = soft.soft_accum_bwd_reference(*exact_in, *(x.double() for x in cot))
        torch.cuda.synchronize()
        assert [a.shape for a in out] == [p.shape for p in want]
        assert judge_rows(out, want, exact, 'backward')[1] == 0
    assert (soft.ACCUM_FWD_LAUNCHES, soft.ACCUM_BWD_LAUNCHES) == (before[0] + 1,
                                                                  before[1] + 2)


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('b,n_faces,res,kind', [(2, 300, 64, 'random'),
                                                (2, 200, 64, 'boundary'),
                                                (1, 100, 40, 'boundary'),
                                                (2, 4500, 64, 'road')])
def test_grouped_soft_tile_lists_match_plain_cull(cuda, b, n_faces, res, kind):
    """The per-tile face lists that B5a and B5b write: each tile's count
    equal to ``soft_tile_lists_reference``'s, its list the kept faces in
    ascending order."""
    from chip_smoke import compare_tile_lists
    ops, _, grads = _accum_operands(n_faces + res, b, n_faces, res, cuda, kind)
    bad_counts, bad_entries, share = compare_tile_lists(soft, ops, res, grads, kind)
    assert (bad_counts, bad_entries) == (0, 0)
    assert 0 < share < 1


@pytest.mark.depends_on_cuda
def test_grouped_soft_backward_is_deterministic(cuda):
    ops, _, grads = _accum_operands(5, 2, 300, 64, cuda)
    first = soft.soft_accum_bwd(*ops, *grads)
    second = soft.soft_accum_bwd(*ops, *grads)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('res,b', [(64, 1024), (128, 8), (32, 4)])
def test_nearest_warp_kernel_matches_plain_version(cuda, res, b):
    mip, ops = _operands(res + 2, b, res, cuda)
    fcoef, icoef = ops[:2]
    assert (icoef[:, 0, 2] == 1).any() and (icoef[:, 0, 2] == 0).any()
    before = warp.NEAREST_LAUNCHES
    got = warp.warp_view_nearest(mip.data, fcoef, icoef, res)
    want = warp.warp_view_nearest_reference(mip.data, fcoef, icoef, res)
    torch.cuda.synchronize()
    assert warp.NEAREST_LAUNCHES == before + 1
    assert int((got != want).sum()) == 0


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('n_faces,b,res,case', [
    (1, 8, 64, 'random'), (12, 1024, 64, 'random'), (127, 16, 64, 'random'),
    (128, 8, 64, 'random'), (129, 8, 32, 'random'), (300, 4, 64, 'random'),
    (17000, 2, 64, 'random'), (17000, 2, 64, 'ties'), (12, 16, 40, 'random'),
    (300, 4, 40, 'random'), (12, 16, 72, 'random'), (300, 4, 72, 'random'),
    (48, 8, 64, 'boundary'), (300, 4, 80, 'boundary')])
def test_hard_raster_kernels_match_plain_versions(cuda, n_faces, b, res, case):
    """Both kernels on random faces, on the cross-chunk tie scene
    (``chip_smoke.hard_tie_operands``), at the ragged res 40 and 72 and on
    faces touching a tile only at its corner pixel centre
    (``chip_smoke.hard_boundary_faces``), against the plain versions."""
    import chip_smoke
    if case == 'ties':
        ops, bg = chip_smoke.hard_tie_operands(n_faces + res, b, n_faces, res, cuda)
    else:
        make = chip_smoke.hard_boundary_faces if case == 'boundary' else hard.random_faces
        corners, z, colors, bg = make(n_faces + res, b, n_faces, res, cuda)
        ops = hard.hard_operands(corners, z, colors)
    packed = len(ops) == 2
    before = (hard.PACKED_LAUNCHES, hard.CHUNKED_LAUNCHES)
    got = hard.raster(ops, bg, res)
    want = hard.raster_reference(ops, bg, res)
    torch.cuda.synchronize()
    assert (hard.PACKED_LAUNCHES, hard.CHUNKED_LAUNCHES) == (
        before[0] + packed, before[1] + (not packed))
    assert int((got != want).sum()) == 0
    assert int((got != bg).any(dim=1).sum()) > 0          # some faces show


@pytest.mark.depends_on_cuda
def test_hard_raster_kernels_keep_hand_made_edges(cuda):
    """``chip_smoke.hard_edge_operands`` at res 40 (edges through the ragged
    last row's and column's pixel centres, all-zero, subnormal, NaN and
    infinite coefficients, a zero-area face): both kernels equal their plain
    versions and each other."""
    import chip_smoke
    coef, packed, zbits, rgb = chip_smoke.hard_edge_operands(cuda)
    bg = torch.rand(1, 3, 40, 40, device=cuda)
    got = hard.raster_packed(coef, packed, bg, 40)
    got_z = hard.raster_chunked(coef, zbits, rgb, bg, 40)
    want = hard.raster_packed_reference(coef, packed, bg, 40)
    torch.cuda.synchronize()
    assert int((got != want).sum()) == 0
    assert int((got_z != want).sum()) == 0
    assert torch.equal(want, hard.raster_chunked_reference(coef, zbits, rgb, bg, 40))


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('res,b,q,t,case', [
    (16, 8, 10, 6, 'random'), (64, 64, 30, 12, 'one_z_level'),
    (128, 16, 44, 20, 'random'), (128, 8, 56, 8, 'dense_band'),
    (256, 4, 44, 20, 'color_background'), (96, 8, 0, 12, 'random'),
    *((res, 8, 24, 24, kind) for kind in CULL_KINDS for res in (144, 80, 16))])
def test_prim_raster_kernels_match_plain_versions(cuda, res, b, q, t, case):
    """B7 on row-major-sorted prims with their masks and B8 on the unsorted
    prims, against the plain versions; B8 on the sorted prims equals B7
    where the masks cover every prim (not so for parallelograms)."""
    if case in CULL_KINDS:
        from chip_smoke import prim_cull_scene
        *scene, bg = prim_cull_scene(case, res + 1, b, res, cuda, q, t)
    else:
        *scene, bg = prims.random_prims(res + q, b, q, t, res, cuda,
                                        z_levels=1 if case == 'one_z_level' else 4,
                                        rows=(40.0, 52.0) if case == 'dense_band' else None)
    if case == 'color_background':
        bg = torch.rand(b, 3, device=cuda)[:, :, None, None].expand(b, 3, res, res)
    n_bands = n_bands_for(res)
    sq, sqz, sqc, qm = sort_prims_rowmajor_with_masks(*scene[:3], res, 56, n_bands)
    st, stz, stc, tm = sort_prims_rowmajor_with_masks(*scene[3:], res, 56, n_bands)
    banded = (sq, sqz, sqc, st, stz, stc, res, bg, qm, tm)
    before = (prims.B7_LAUNCHES, prims.B8_LAUNCHES)
    got = prims.rasterize_hard_prims_banded(*banded)
    want = prims.rasterize_hard_prims_banded_reference(*banded)
    got8 = prims.rasterize_hard_prims(*scene, res, bg)
    want8 = prims.rasterize_hard_prims_reference(*scene, res, bg)
    same8 = prims.rasterize_hard_prims(*banded[:8])
    torch.cuda.synchronize()
    assert (prims.B7_LAUNCHES, prims.B8_LAUNCHES) == (before[0] + 1, before[1] + 2)
    assert int((got != want).sum()) == 0
    assert int((got8 != want8).sum()) == 0
    if case != 'parallelogram':
        assert int((same8 != got).sum()) == 0
    assert int((got != bg).any(dim=1).sum()) > 0          # some prims show
    if n_bands > 1 and case not in CULL_KINDS:
        assert int(qm.sum() + tm.sum()) < qm.numel() + tm.numel()   # chunks skipped


@pytest.mark.depends_on_cuda
def test_prim_raster_kernel_keeps_flat_subnormal_and_nonfinite_prims(cuda):
    """B8 on ``chip_smoke.prim_edge_operands`` (an all-zero edge, constant
    quad coordinates +-0.5, NaN and infinite coefficients, subnormal
    products), against the plain version, bit for bit."""
    from chip_smoke import prim_edge_operands
    ops = prim_edge_operands(cuda)
    bg = torch.rand(1, 3, 32, 32, device=cuda)
    got = prims.raster_prims(*ops, bg, 32)
    want = prims.raster_prims_reference(*ops, bg, 32)
    torch.cuda.synchronize()
    assert int((got != want).sum()) == 0


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('path', ['config3', 'tiled256'])
def test_fused_kernel_on_new_path_operands(cuda, path):
    """B1 on the operands of BASELINE config 3's frame (Town10HD's texture,
    50 quads and 20 triangles per camera) and of a res-256 frame (2 x 2
    sub-views of 128 per camera, all in one launch), from
    ``Renderer.fused_frame_operands`` as the step builds them: bit for bit
    its plain version, after a few steps with seeded actions."""
    from chip_smoke import fused_frame
    from torchdrivesim_tpu_torch.benchmark import (
        build_benchmark_scenario, build_config3_scenario)
    if path == 'config3':
        scenario = build_config3_scenario(batch_size=8, device=cuda)
    else:
        scenario = build_benchmark_scenario(batch_size=8, res=256, device=cuda)
    sim = scenario.sim
    step = scenario.make_step_fn(render=False, metrics=False)
    rng = np.random.RandomState(3)
    state = sim.state
    for _ in range(3):
        state, _ = step(state, torch.as_tensor(
            rng.uniform(-1, 1, (8, sim.agent_count, sim.action_size)),
            dtype=torch.float32, device=cuda))
    mip, ops, res, n, _, (n_quads, n_tris) = fused_frame(scenario, state)
    assert (res, n, ops[0].shape[0]) == ((128, 1, 8) if path == 'config3' else (128, 2, 32))
    if path == 'config3':
        assert (n_quads, n_tris) == (50, 20)
    for packed in (False, True):
        before = fused.LAUNCHES
        got = fused.render_coefs_fused(mip, *ops, res, packed)
        want = fused.render_coefs_fused_reference(mip, *ops, res, packed)
        torch.cuda.synchronize()
        assert fused.LAUNCHES == before + 1
        assert int((got != want).sum()) == 0


@pytest.mark.depends_on_cuda
def test_compound_kinematic_step_captures_in_a_cuda_graph(cuda):
    """One step of config 3's compound kinematic model is captured in a CUDA
    graph (the capture fails on a host sync) and its replay equals the
    eager step bit for bit."""
    from chip_smoke import graph_replay
    from torchdrivesim_tpu_torch import kinematic as K
    from torchdrivesim_tpu_torch.benchmark import CONFIG3_MODELS
    rng = np.random.RandomState(5)
    ids = rng.choice(CONFIG3_MODELS, size=(16, 20))
    params = K.KinematicParams(lr=torch.as_tensor(rng.uniform(1, 2, (16, 20)),
                                                  dtype=torch.float32, device=cuda),
                               left_handed=True)
    km = K.CompoundKinematicModel(ids, params=params, device=cuda)
    state = torch.as_tensor(rng.uniform(-5, 5, (16, 20, 4)), dtype=torch.float32,
                            device=cuda)
    act = torch.as_tensor(rng.uniform(-1, 1, (16, 20, 4)), dtype=torch.float32,
                          device=cuda)
    fn = lambda: K.step(state, act, km.params, model_ids=km.model_assignments,
                        models=km.models_in_use)
    eager = fn()
    assert torch.equal(graph_replay(fn), eager)


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('count', [1, 5])
def test_fused_kernel_on_facade_frames(cuda, count):
    """B1 on ``render_egocentric``'s frames of the facade (Town02, B = 4,
    20 agents, one waypoint per collection): at ``n_subsequent_waypoints=1``
    (30 triangles per camera) bit for bit its plain version, and equal to
    the same frame forced through the sort route; at 5 (70 triangles, past
    the per-type cap of 56: the sort route) bit for bit its plain version,
    one launch per frame."""
    from chip_smoke import facade_frame, facade_world
    from torchdrivesim_tpu_torch.utils import Resolution
    sim = facade_world(4, cuda)
    sim.step(torch.full((4, 20, 2), 0.01, device=cuda))
    mip, ops, res, n, _, (_, n_tris) = facade_frame(sim, count)
    assert (res, n, ops[0].shape[0]) == (128, 1, 80)
    assert (n_tris > sim.renderer._prim_cap) == (count == 5)
    for packed in (False, True):
        got = fused.render_coefs_fused(mip, *ops, res, packed)
        want = fused.render_coefs_fused_reference(mip, *ops, res, packed)
        torch.cuda.synchronize()
        assert int((got != want).sum()) == 0
    if count == 1:
        prims, cams = sim.egocentric_prim_frame(fov=70.0)
        forced = sim.renderer.fused_frame_operands(*prims, res, cams, force_sort=True)
        sorted_image = fused.render_coefs_fused(forced[0], *forced[1], res)
        assert torch.equal(sorted_image, fused.render_coefs_fused(mip, *ops, res))
    before = fused.LAUNCHES
    sim.render_egocentric(res=Resolution(128, 128), fov=70.0,
                          n_subsequent_waypoints=count)
    assert fused.LAUNCHES == before + 1


@pytest.mark.depends_on_cuda
def test_hard_chunked_kernel_on_replay_frame(cuda, tmp_path):
    """B6b on the replay example's frame (case 1 of
    ``chip_smoke.write_interaction_data``, res 256, fov 100 m, the Town02
    mesh and 19 replayed actors, one camera) bit for bit its plain
    version, one launch per frame."""
    from chip_smoke import replay_argv, replay_frame, write_interaction_data
    from torchdrivesim_tpu_torch.examples import replay
    root = write_interaction_data(str(tmp_path), cases=1)
    sim, states = replay.build_simulator(replay.parse_args(replay_argv(root, cuda)))
    for t in range(12):
        sim.step(states[:, :1, t + 1])
    assert sim.npc_count == 19 and int(sim.get_npc_present_mask().sum()) == 19
    bg, ops, _, _ = replay_frame(sim)
    assert len(ops) == 3 and ops[1].shape[1] > 16000 and bg.shape == (1, 3, 256, 256)
    got = hard.raster(ops, bg, 256)
    want = hard.raster_reference(ops, bg, 256)
    torch.cuda.synchronize()
    assert int((got != want).sum()) == 0
    before = hard.CHUNKED_LAUNCHES
    sim.render_egocentric()
    assert hard.CHUNKED_LAUNCHES == before + 1


@pytest.mark.depends_on_cuda
def test_grouped_soft_kernels_on_dataset_il_frame(cuda, tmp_path):
    """B5a and B5b on the dataset imitation-learning frame (B = 4 segments
    of ``chip_smoke.write_interaction_data``, the road mesh of Town02's
    .osm and 20 actors per camera, res 64): the forward bit for bit its
    plain version, the backward face by face for the composite's
    cotangents, the per-tile face lists equal to the plain cull's."""
    from chip_smoke import (
        compare_tile_lists, composite_cotangents, dataset_il_frame, dataset_il_world,
        judge_rows, write_interaction_data)
    root = write_interaction_data(str(tmp_path), cases=2)
    sim, _, _ = dataset_il_world(root, 4, 40, 64, cuda)
    bg, ops = dataset_il_frame(sim, sim.state)
    assert ops[0].shape[1] > 3384 and ops[0].shape[1] % soft.MAX_FACES == 0
    plain = soft.soft_accum_fwd_reference(*ops, 64)
    for a, p in zip(soft.soft_accum_fwd(*ops, 64), plain):
        assert torch.equal(a, p)
    grads = composite_cotangents(soft, plain, bg, 3)
    out = soft.soft_accum_bwd(*ops, *grads)
    want = soft.soft_accum_bwd_reference(*ops, *grads)
    exact = soft.soft_accum_bwd_reference(*(x.double() for x in ops),
                                          *(g.double() for g in grads))
    torch.cuda.synchronize()
    assert judge_rows(out, want, exact, 'dataset IL backward')[1] == 0
    assert compare_tile_lists(soft, ops, 64, grads, 'dataset IL')[:2] == (0, 0)


@pytest.mark.depends_on_cuda
def test_kernels_on_face_soup_frame(cuda):
    """B2 and B6a on the face-soup frame (``chip_smoke.faces_world`` at B =
    8: the headline world's agents, lights and two waypoint discs per
    camera, culled to 64 faces) bit for bit their plain versions; one
    launch of each per ``render_faces_chw``, and one B6a without the
    texture."""
    from chip_smoke import FOV, RES, faces_frame, faces_operands, faces_world
    from torchdrivesim_tpu_torch.rendering import Renderer
    from torchdrivesim_tpu_torch.utils import Resolution
    scenario, wps, mask = faces_world(8, cuda)
    renderer = scenario.sim.renderer
    faces, cams = faces_frame(scenario, scenario.sim.state, wps, mask)
    bg, ops, _, (mip, fcoef, icoef) = faces_operands(renderer, faces, cams)
    assert len(ops) == 2 and ops[1].shape[1] == 64 and cams.scale == 2.0 / FOV
    got = warp.warp_view_nearest(mip.data, fcoef, icoef, RES)
    assert torch.equal(got, warp.warp_view_nearest_reference(mip.data, fcoef, icoef, RES))
    assert torch.equal(hard.raster(ops, bg, RES), hard.raster_reference(ops, bg, RES))
    before = (warp.NEAREST_LAUNCHES, hard.PACKED_LAUNCHES)
    renderer.render_faces_chw(*faces, Resolution(RES, RES), cams)
    assert (warp.NEAREST_LAUNCHES, hard.PACKED_LAUNCHES) == (before[0] + 1, before[1] + 1)
    plain = Renderer(renderer.cfg, cuda)
    ubg, uops, _, uwarp = faces_operands(plain, faces, cams)
    assert uwarp is None and len(uops) == 2
    assert torch.equal(hard.raster(uops, ubg, RES), hard.raster_reference(uops, ubg, RES))


@pytest.mark.depends_on_cuda
def test_soft_kernels_under_quad_background(cuda):
    """B4a and B4b on config 4's frame over the full-resolution bilinear
    background (``diff_fast_background=False``: ``sample_background_quad``,
    B = 4, res 64): within the tolerance of the soft raster above; a render
    launches B4a and no warp."""
    from torchdrivesim_tpu_torch.benchmark import build_il_scenario, il_view
    from torchdrivesim_tpu_torch.utils import Resolution
    scenario = build_il_scenario(batch_size=4, agent_count=8, res=64, device=cuda)
    renderer = scenario.sim.renderer
    renderer.cfg.diff_fast_background = False
    mesh, cams = il_view(scenario, scenario.sim.state)
    bg, (coef, zw, color) = renderer.soft_frame_operands(mesh, 64, cams)
    ops = (coef, zw.contiguous(), color, bg.contiguous())
    g = torch.empty_like(bg).uniform_(-1, 1)
    exact_in = [x.double() for x in ops]
    assert _judge(soft.soft_raster_fwd(*ops), soft.soft_raster_fwd_reference(*ops),
                  soft.soft_raster_fwd_reference(*exact_in), 0.0, 1e-5) == 0
    grads = soft.soft_raster_bwd(*ops, g)
    plain = soft.soft_raster_bwd_reference(*ops, g)
    exact = soft.soft_raster_bwd_reference(*exact_in, g.double())
    torch.cuda.synchronize()
    for a, p, e in zip(grads, plain, exact):
        assert _judge(a, p, e, 1e-4) == 0
    before = (soft.FWD_LAUNCHES, warp.LAUNCHES)
    renderer.render_rgb_mesh_chw(mesh, Resolution(64, 64), cams)
    assert (soft.FWD_LAUNCHES, warp.LAUNCHES) == (before[0] + 1, before[1])


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('kind,b,f,h,w', [
    ('random', 4, 300, 64, 64), ('random', 2, 1000, 72, 40), ('centres', 4, 200, 48, 80),
    ('slivers', 4, 300, 64, 64), ('grazing', 4, 40, 64, 64), ('random', 2, 0, 32, 48),
    ('ulps', 4, 300, 64, 64), ('far', 2, 300, 72, 40), ('nonfinite', 4, 300, 64, 64),
    ('crowd', 2, 700, 48, 48)])
def test_hard_faces_kernel_matches_plain_version(cuda, kind, b, f, h, w):
    """HF (``csrc/hard_faces.cu``) bit for bit its plain version, image and
    winner index: random faces of both windings (degenerate, z ties, z at
    BIG_Z, +-inf, NaN), corners on pixel centres, slivers, faces grazing a
    tile's corner pixel (``chip_smoke.hf_grazing_operands``), corners a few
    ulps off pixel centres, up to +-1e6 and +-inf or NaN, a tile whose list
    overflows its capacity (``crowd``), rectangular frames and no faces;
    its per-tile lists equal as sets to ``hard_faces_tile_lists_reference``;
    its gradients within 1e-5 of the largest value of autograd's through
    the plain version."""
    from chip_smoke import compare_hf, compare_hf_grad, hf_grazing_operands, hf_random_operands
    from torchdrivesim_tpu_torch.ops import hard_faces
    ops = hf_grazing_operands(b, b, f, h, cuda) if kind == 'grazing' \
        else hf_random_operands(kind, f + h, b, f, h, w, cuda)
    before = hard_faces.LAUNCHES
    overflow = True if kind == 'crowd' else None if f > hard_faces.LIST_CAP else False
    assert compare_hf(ops, kind, overflow) == 0.0
    assert hard_faces.LAUNCHES == before + 1
    if f:
        compare_hf_grad(ops, kind)


@pytest.mark.depends_on_cuda
def test_hard_faces_on_the_differentiable_routes(cuda):
    """HF on the differentiable primitive frame of the facade world (B = 4)
    and on a differentiable face-soup frame (B = 8), bit for bit its plain
    version; one HF launch per frame and no other kernel."""
    from chip_smoke import (FOV, RES, compare_hf, count_kernels, facade_world, faces_frame,
                            faces_world, launched_since)
    from torchdrivesim_tpu_torch.ops import hard_faces
    from torchdrivesim_tpu_torch.rendering import Pytorch3DRendererConfig, Renderer
    from torchdrivesim_tpu_torch.utils import Resolution
    sim = facade_world(4, cuda, renderer_config=Pytorch3DRendererConfig())
    before = count_kernels()
    image = sim.render_egocentric(res=Resolution(64, 64), fov=FOV)
    assert launched_since(before) == {'hard_faces': 1}
    prims, cams = sim.egocentric_prim_frame(fov=FOV)
    ops = tuple(t.detach().contiguous()
                for t in sim.renderer.prims_plain_operands(*prims, 64, cams))
    compare_hf(ops, 'differentiable primitive frame')
    assert torch.equal(image.reshape(-1, 3, 64, 64), hard_faces.hard_faces(*ops)[0] * 255.0)
    scenario, wps, mask = faces_world(8, cuda)
    renderer = Renderer(dataclasses.replace(scenario.sim.renderer.cfg, differentiable=True),
                        cuda)
    renderer.background_texture = scenario.sim.renderer.background_texture
    faces, cams = faces_frame(scenario, scenario.sim.state, wps, mask)
    bg, fops, _ = renderer.face_frame_operands(*faces, RES, cams)
    compare_hf(tuple(t.contiguous() for t in (*fops, bg)), 'differentiable face soup')
    before = count_kernels()
    renderer.render_faces_chw(*faces, Resolution(RES, RES), cams)
    assert launched_since(before) == {'hard_faces': 1}
