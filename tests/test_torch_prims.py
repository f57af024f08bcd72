"""
The port's typed-primitive raster and the renderer branches it serves,
against the JAX package on the same inputs (made with numpy from a seed):

* ``ops.rasterize.sort_prims_rowmajor(_with_masks)`` and ``ops.prims
  .prep_prims`` against the reference's functions run eagerly, one XLA op at
  a time: order, masks, coefficients and packs bit-identical;
* the banded raster (B7) and the unbanded raster (B8), plain versions,
  against ``rasterize_hard_pallas_prims_banded`` / ``_prims`` with their
  Pallas kernels in interpret mode: both resolve an integer winner per
  pixel, so the comparison is exact up to one traced cause, the reference's
  compiled CPU code fusing some ``a*x + b*y + c`` into FMAs. The port is
  rendered under the three roundings (``tests.test_torch_warp_nearest
  .judge_roundings``); every pixel whose value does not depend on the
  rounding matches exactly and the reference's value is one of them at
  every pixel;
* ``sample_background_packed`` against the reference under ``jit`` (whose
  ``x / 255.0`` is a product by float32(1/255)): exact; sampled at res / 2
  and upsampled bilinearly: within 1e-6;
* ``Renderer.render_prims_chw`` and the hard mesh render against
  ``JaxRenderer`` under ``jit``, with ``jax_renderer._on_tpu`` patched to
  True before the texture is set (else no mip pyramid, and the JAX CPU path
  takes its XLA fallbacks, which have other semantics) and every
  ``pallas_call`` in interpret mode: at least 99.9% of the pixels identical
  (under ``jit`` the screen transform may fuse into FMAs and move a
  primitive's edge by an ulp);
* the benchmark step without a texture renders the frame's mesh;
* the differentiable primitive render (the reference's plain fallback:
  ``cull_prims_to_view``, bit-identical to the reference run eagerly, and
  ``rasterize_hard_faces``) against ``JaxRenderer`` as above.
"""
import ctypes
import functools
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdrivesim_tpu.ops.pallas_fused as F
import torchdrivesim_tpu.ops.pallas_rasterize as R
import torchdrivesim_tpu.ops.pallas_warp as W
from tests.test_torch_warp_nearest import judge_roundings
from torchdrivesim_tpu.ops import rasterize as jax_rasterize
from torchdrivesim_tpu_torch import tracing
from torchdrivesim_tpu_torch.ops import prims
from torchdrivesim_tpu_torch.ops import rasterize


def launches(kernel: str) -> int:
    """The launches so far of the hand-written ``kernel`` (B1 ... HF)."""
    return tracing.counts().get(f'launch.{kernel}', 0)


torch.set_num_threads(1)

BG_COLOR = np.asarray([0.1, 0.2, 0.3], np.float32)


@pytest.fixture
def interpret_mode(monkeypatch):
    original = R.pl.pallas_call
    for mod in (W, R, F):
        monkeypatch.setattr(mod.pl, 'pallas_call',
                            functools.partial(original, interpret=True))


def _prims(seed, b, q, t, res, z_levels=4):
    """``ops.prims.random_prims`` as numpy, without the background: ties in
    z and in top rows, degenerate, off-screen and absent prims."""
    return tuple(x.numpy() for x in prims.random_prims(seed, b, q, t, res, 'cpu',
                                                       z_levels=z_levels)[:6])


def _dense_band(res=128):
    """Three bumper-to-bumper lanes of boxes crossing one band (the
    reference's dense-band case, tests/test_pallas_rasterize.py)."""
    boxes = [(40.0 + 8.0 * lane, 4.0 + 10.0 * i) for lane in range(3) for i in range(12)]
    quads = np.zeros((1, len(boxes), 4, 2), np.float32)
    for k, (r, c) in enumerate(boxes):
        quads[0, k] = [[r - 2, c - 4], [r - 2, c + 4], [r + 2, c + 4], [r + 2, c - 4]]
    rng = np.random.RandomState(2)
    return (quads, rng.uniform(1, 5, (1, len(boxes))).astype(np.float32),
            rng.uniform(0, 1, (1, len(boxes), 3)).astype(np.float32),
            np.zeros((1, 0, 3, 2), np.float32), np.zeros((1, 0), np.float32),
            np.zeros((1, 0, 3), np.float32))


SORT_CASES = {
    'quads': dict(k=4, n=30, res=64),
    'tris': dict(k=3, n=21, res=64),
    'over_cap_quads': dict(k=4, n=70, res=128),
    'over_cap_tris': dict(k=3, n=60, res=256),
    'empty': dict(k=3, n=0, res=64),
}


def _sort_input(seed, k, n, res):
    quads, qz, qc, tris, tz, tc = _prims(seed, 2, n, n, res)
    return (quads, qz, qc) if k == 4 else (tris, tz, tc)


@pytest.mark.parametrize('case', list(SORT_CASES))
def test_sort_rowmajor_matches_jax(case):
    kw = SORT_CASES[case]
    res, cap = kw['res'], 56
    arrays = _sort_input(sum(map(ord, case)), kw['k'], kw['n'], res)
    n_bands = rasterize.n_bands_for(res)
    want = [np.asarray(x) for x in jax_rasterize.sort_prims_rowmajor_with_masks(
        *map(jnp.asarray, arrays), res, cap, n_bands)]
    got = [x.numpy() for x in rasterize.sort_prims_rowmajor_with_masks(
        *map(torch.from_numpy, arrays), res, cap, n_bands)]
    for name, g, w in zip(('corners', 'z', 'color', 'mask'), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    plain = [np.asarray(x) for x in jax_rasterize.sort_prims_rowmajor(
        *map(jnp.asarray, arrays), res, cap)]
    for g, w in zip(rasterize.sort_prims_rowmajor(*map(torch.from_numpy, arrays),
                                                  res, cap), plain):
        np.testing.assert_array_equal(g.numpy(), w)
    if kw['n'] > cap:
        assert got[0].shape[1] == cap
    if kw['n']:
        assert got[3].any() and not got[3].all()


PREP_CASES = {
    'mixed': dict(q=30, t=12, res=64),
    'max_prims': dict(q=70, t=57, res=128),
    'no_tris': dict(q=9, t=0, res=32),
    'no_quads': dict(q=0, t=5, res=32),
    'z_ties_one_level': dict(q=20, t=20, res=64, z_levels=1),
}


@pytest.mark.parametrize('case', list(PREP_CASES))
def test_prep_prims_matches_jax(case):
    kw = dict(PREP_CASES[case])
    scene = _prims(sum(map(ord, case)), 2, kw['q'], kw['t'], kw['res'],
                   z_levels=kw.get('z_levels', 4))
    want = [np.asarray(x) for x in R._prep_prims(*map(jnp.asarray, scene))]
    got = [x.numpy() for x in prims.prep_prims(*map(torch.from_numpy, scene))]
    for name, g, w in zip(('qcoef', 'qpk', 'tcoef', 'tpk'), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    live = np.concatenate([got[1], got[3]], axis=1)
    assert (live != 0x7FFFFFFF).any() and (live == 0x7FFFFFFF).any()


def test_prep_prims_rejects_more_than_127():
    scene = map(torch.from_numpy, _prims(0, 1, 64, 64, 32))
    with pytest.raises(ValueError):
        prims.prep_prims(*scene)


RASTER_CASES = {
    'res16': dict(b=2, q=10, t=6, res=16),
    'res64': dict(b=2, q=30, t=12, res=64),
    'res128': dict(b=2, q=44, t=20, res=128),
    'res256': dict(b=1, q=44, t=20, res=256),
    'res64_one_z_level': dict(b=2, q=24, t=16, res=64, z_levels=1),
    'dense_band': dict(res=128),
}


def _raster_case(case):
    kw = dict(RASTER_CASES[case])
    res = kw['res']
    if case == 'dense_band':
        scene = _dense_band(res)
    else:
        scene = _prims(sum(map(ord, case)), kw['b'], kw['q'], kw['t'], res,
                       z_levels=kw.get('z_levels', 4))
    rng = np.random.RandomState(len(case))
    bg = rng.rand(scene[1].shape[0], 3, res, res).astype(np.float32)
    return scene, bg, res


def _sorted(scene, res):
    """Both types row-major sorted with masks (numpy), by the port's sort,
    which ``test_sort_rowmajor_matches_jax`` holds bit-identical to the
    reference's."""
    n_bands = rasterize.n_bands_for(res)
    out = []
    for arrays in (scene[:3], scene[3:]):
        out.append([x.numpy() for x in rasterize.sort_prims_rowmajor_with_masks(
            *map(torch.from_numpy, arrays), res, 56, n_bands)])
    (sq, sqz, sqc, qm), (st, stz, stc, tm) = out
    return (sq, sqz, sqc, st, stz, stc), qm, tm


@pytest.mark.parametrize('case', list(RASTER_CASES))
def test_banded_raster_matches_jax_kernel(interpret_mode, case):
    """B7 on the reference's sorted prims and masks."""
    scene, bg, res = _raster_case(case)
    sorted_scene, qm, tm = _sorted(scene, res)
    want = np.asarray(R.rasterize_hard_pallas_prims_banded(
        *map(jnp.asarray, sorted_scene), res, jnp.asarray(bg), jnp.asarray(qm),
        jnp.asarray(tm)))
    args = [torch.from_numpy(a) for a in sorted_scene] + [res, torch.from_numpy(bg)] \
        + [torch.from_numpy(qm), torch.from_numpy(tm)]
    before = (launches('B7'), launches('B8'))
    got = prims.rasterize_hard_prims_banded(*args).numpy()
    assert (launches('B7'), launches('B8')) == before    # the CPU runs no kernel
    np.testing.assert_array_equal(
        got, prims.rasterize_hard_prims_banded_reference(*args).numpy())
    ambiguous = judge_roundings(
        lambda: prims.rasterize_hard_prims_banded_reference(*args).numpy(), want,
        f'B7 {case}')
    assert ambiguous <= 0.001 * got[:, 0].size
    covered = (got != bg).any(axis=1)
    assert covered.any() and not covered.all()
    # B8 on the same sorted prims draws the same image
    np.testing.assert_array_equal(prims.rasterize_hard_prims(*args[:8]).numpy(), got)
    if case == 'dense_band':
        assert qm[0, 0].sum() == 0 and qm[0, 1].sum() > 0


@pytest.mark.parametrize('case', ['res16', 'res64', 'res128', 'res256'])
def test_unbanded_raster_matches_jax_kernel(interpret_mode, case):
    """B8 on unsorted prims."""
    scene, bg, res = _raster_case(case)
    want = np.asarray(R.rasterize_hard_pallas_prims(
        *map(jnp.asarray, scene), res, jnp.asarray(bg)))
    args = [torch.from_numpy(a) for a in scene] + [res, torch.from_numpy(bg)]
    ambiguous = judge_roundings(
        lambda: prims.rasterize_hard_prims_reference(*args).numpy(), want, f'B8 {case}')
    assert ambiguous <= 0.001 * want[:, 0].size


def test_expanded_background_is_read_through_its_strides():
    """A per-camera color expanded to (B, 3, res, res) gives the same image
    as the materialised background, and the wrapper reads it with pixel
    stride 0."""
    scene, _, res = _raster_case('res64')
    ops = prims.prep_prims(*map(torch.from_numpy, scene))
    color = torch.rand(2, 3)
    expanded = color[:, :, None, None].expand(2, 3, res, res)
    assert prims._background_strides(expanded, res)[1:] == (3, 1, 0)
    assert prims._background_strides(expanded.contiguous(), res)[1:] == (
        3 * res * res, res * res, 1)
    np.testing.assert_array_equal(
        prims.raster_prims(*ops, expanded, res).numpy(),
        prims.raster_prims(*ops, expanded.contiguous(), res).numpy())


def test_wrapper_checks_its_operands():
    scene, bg, res = _raster_case('res64')
    ops = prims.prep_prims(*map(torch.from_numpy, scene))
    bg = torch.from_numpy(bg)
    n_bands = rasterize.n_bands_for(res)
    qm = torch.ones((2, n_bands, 1, ops[1].shape[1] // 8), dtype=torch.int32)
    tm = torch.ones((2, n_bands, 1, ops[3].shape[1] // 8), dtype=torch.int32)
    # every mask bit set: B7 equals B8
    np.testing.assert_array_equal(prims.raster_prims(*ops, bg, res, qm, tm).numpy(),
                                  prims.raster_prims(*ops, bg, res).numpy())
    with pytest.raises(ValueError):
        prims.raster_prims(*ops, bg, 48)                    # background's size
    with pytest.raises(ValueError):
        prims.raster_prims(*ops, bg, res, qm)               # one mask
    with pytest.raises(ValueError):
        prims.raster_prims(*ops, bg, res, torch.cat([qm, qm], 1), tm)  # bands
    with pytest.raises(ValueError):
        prims.raster_prims(ops[0].double(), *ops[1:], bg, res)
    with pytest.raises(ValueError):
        prims.raster_prims(*ops, bg[:, :, :60, :60], 60)    # not a multiple of 16


_STUB = r'''
#include <stdint.h>
/* the kernel's C signature; returns the index of the first wrong argument */
int tds_prim_raster(const void* qcoef, const void* qpk, const void* tcoef,
                    const void* tpk, const void* qmask, const void* tmask,
                    const void* bg, int batch, int res, int rpb, int qp, int tp,
                    long long bg_sb, long long bg_sc, long long bg_sp, void* out,
                    void* stream) {
  const void* p[5] = {qcoef, qpk, tcoef, tpk, qmask};
  for (int i = 0; i < 5; ++i)
    if ((uintptr_t)p[i] != 0x7f0000001000ull + 0x100 * i) return 1 + i;
  if (tmask != 0) return 6;
  if ((uintptr_t)bg != 0x7f0000001600ull) return 7;
  if (batch != 256 || res != 256 || rpb != 16 || qp != 48 || tp != 24) return 8;
  if (bg_sb != 3 || bg_sc != 1 || bg_sp != 0) return 9;
  if ((uintptr_t)out != 0x7f00000ff000ull) return 10;
  if ((uintptr_t)stream != 0x7ffd12345678abc0ull) return 11;
  return 0;
}
'''


def test_kernel_entry_point_receives_its_arguments(tmp_path):
    """The ctypes binding passes every argument in place, null masks and
    64-bit pointers (the stream) included, to a stub with the kernel's C
    signature."""
    cc = shutil.which('cc')
    if cc is None:
        pytest.skip('needs a C compiler')
    src, lib = tmp_path / 'stub.c', tmp_path / 'stub.so'
    src.write_text(_STUB)
    subprocess.run([cc, '-shared', '-fPIC', '-o', str(lib), str(src)], check=True)
    stub = prims._bind(ctypes.CDLL(str(lib)))
    ptrs = [0x7f0000001000 + 0x100 * i for i in range(5)] + [None, 0x7f0000001600]
    assert prims._launch(stub, ptrs, 256, 256, 48, 24, (3, 1, 0), 0x7f00000ff000,
                         0x7ffd12345678abc0) == 0


# --- the full-resolution background and the renderer ------------------------

@pytest.fixture(scope='module')
def town02_texture():
    from torchdrivesim_tpu_torch.benchmark import load_or_bake_texture
    from torchdrivesim_tpu_torch.map import find_map_config
    return load_or_bake_texture(find_map_config('carla_Town02'))


def _cameras(seed, b, texture):
    """Cameras over the texture (some views reach past its edge), random
    headings."""
    rng = np.random.RandomState(seed)
    h, w = texture.data.shape[:2]
    lo = np.asarray(texture.origin, np.float32)
    xy = (lo + rng.rand(b, 2) * np.asarray([w, h]) * texture.cell_size).astype(np.float32)
    ang = rng.rand(b) * 2 * np.pi
    return xy, np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)


@pytest.mark.parametrize('res,fov,left_handed', [(32, 200.0, False), (64, 400.0, True),
                                                 (112, 70.0, False)])
def test_sample_background_packed_matches_jax(town02_texture, res, fov, left_handed):
    """The texel each pixel takes, and the background color off the texture,
    against the reference's jitted function on the unpadded packed
    texture."""
    from torchdrivesim_tpu.ops.grids import Grid2D as JaxGrid
    tex = town02_texture
    jtex = jax_rasterize.pack_texture_rgb8(JaxGrid(
        data=jnp.asarray(tex.data), origin=jnp.asarray(tex.origin),
        cell_size=tex.cell_size))
    packed = rasterize.pack_texture_rgb8(tex.data)
    np.testing.assert_array_equal(packed, np.asarray(jtex.data)[..., 0].astype(np.int64))
    xy, sc = _cameras(res, 8, tex)
    want = np.asarray(jax.jit(lambda a, b: jax_rasterize.sample_background_packed(
        jtex, a, b, 2.0 / fov, res, jnp.asarray(BG_COLOR), left_handed=left_handed,
        chw=True))(xy, sc))
    got = rasterize.sample_background_packed(
        torch.from_numpy(packed), tex.origin, tex.cell_size, torch.from_numpy(xy),
        torch.from_numpy(sc), 2.0 / fov, res, torch.from_numpy(BG_COLOR),
        left_handed=left_handed).numpy()
    np.testing.assert_array_equal(got, want)
    off = (got == BG_COLOR[None, :, None, None]).all(axis=1)
    assert off.any() and not off.all()
    # sampled at res / 2 and upsampled bilinearly, as the benchmark scenario
    # configures it: within 1e-6 of the reference (its compiled contraction
    # fuses some products into FMAs, at some widths only)
    want = np.asarray(jax.jit(lambda a, b: jax_rasterize.sample_background_packed(
        jtex, a, b, 2.0 / fov, res, jnp.asarray(BG_COLOR), left_handed=left_handed,
        downsample=2, chw=True))(xy, sc))
    got = rasterize.sample_background_packed(
        torch.from_numpy(packed), tex.origin, tex.cell_size, torch.from_numpy(xy),
        torch.from_numpy(sc), 2.0 / fov, res, torch.from_numpy(BG_COLOR),
        left_handed=left_handed, downsample=2).numpy()
    print(f'res {res} downsample 2: {int((got != want).sum())} of {got.size} values '
          f'differ, max {np.abs(got - want).max():.3g}')
    assert got.shape == want.shape == (8, 3, res, res)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope='module')
def renderers(town02_texture):
    """(JAX textured, JAX untextured, port textured, port untextured): the
    JAX renderers on their TPU path, every pallas_call in interpret mode,
    for as long as the module's tests run."""
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from torchdrivesim_tpu.ops.grids import Grid2D as JaxGrid
    from torchdrivesim_tpu.rendering.base import JaxRendererConfig
    from torchdrivesim_tpu_torch.rendering.base import RendererConfig
    from torchdrivesim_tpu_torch.rendering.renderer import Renderer
    tex = town02_texture
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jr, '_on_tpu', lambda: True)
        for mod in (W, R, F):
            m.setattr(mod.pl, 'pallas_call',
                      functools.partial(mod.pl.pallas_call, interpret=True))
        j_tex = jr.JaxRenderer(JaxRendererConfig(), background_texture=JaxGrid(
            data=jnp.asarray(tex.data), origin=jnp.asarray(tex.origin),
            cell_size=tex.cell_size))
        j_plain = jr.JaxRenderer(JaxRendererConfig())
        p_tex = Renderer(RendererConfig(), 'cpu')
        p_tex.background_texture = tex
        yield j_tex, j_plain, p_tex, Renderer(RendererConfig(), 'cpu')


def _world_prims(seed, xy, fov, q=24, t=12):
    """World-space boxes (cycle order) and triangles around each camera,
    within and beyond its view, z on the renderer's levels (ties)."""
    rng = np.random.RandomState(seed)
    b = xy.shape[0]
    center = xy[:, None] + rng.uniform(-0.6, 0.6, (b, q, 2)) * fov
    ang = rng.rand(b, q) * 2 * np.pi
    half = rng.uniform(0.02, 0.08, (b, q, 2)) * fov
    fwd = np.stack([np.cos(ang), np.sin(ang)], -1) * half[..., :1]
    side = np.stack([-np.sin(ang), np.cos(ang)], -1) * half[..., 1:]
    quads = np.stack([center - fwd - side, center + fwd - side, center + fwd + side,
                      center - fwd + side], axis=2)
    tris = xy[:, None, None] + rng.uniform(-0.6, 0.6, (b, t, 3, 2)) * fov
    levels = np.asarray([2, 3, 4, 11], np.float32)
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(quads), levels[rng.randint(0, 4, (b, q))], f32(rng.rand(b, q, 3)),
            f32(tris), levels[rng.randint(0, 4, (b, t))], f32(rng.rand(b, t, 3)))


def _same_pixels(got, want, label):
    axis = 1 if got.ndim == 4 else None
    same = (got == want).all(axis=axis) if axis else (got == want)
    print(f'{label}: {int(same.sum())} of {same.size} pixels identical')
    return same.mean()


RENDER_CASES = {
    'untextured_res64': dict(res=64, fov=35.0),
    'untextured_res128': dict(res=128, fov=70.0),
    'untextured_res256': dict(res=256, fov=70.0, b=1),
    'untextured_res64_packed': dict(res=64, fov=35.0, packed=True),
    'wide_view_res32_fov200': dict(res=32, fov=200.0, textured=True),
    'wide_view_res32_packed': dict(res=32, fov=200.0, textured=True, packed=True),
    'padded_res100_untextured': dict(res=100, fov=35.0),
    'padded_res100_textured': dict(res=100, fov=40.0, textured=True),
}


@pytest.mark.parametrize('case', list(RENDER_CASES))
def test_render_prims_matches_jax(renderers, town02_texture, case):
    from torchdrivesim_tpu.rendering.base import Cameras as JaxCameras
    from torchdrivesim_tpu.utils import Resolution as JaxResolution
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    from torchdrivesim_tpu_torch.utils import Resolution
    kw = RENDER_CASES[case]
    res, fov, packed = kw['res'], kw['fov'], kw.get('packed', False)
    j_tex, j_plain, p_tex, p_plain = renderers
    jr, pr = (j_tex, p_tex) if kw.get('textured') else (j_plain, p_plain)
    xy, sc = _cameras(sum(map(ord, case)), kw.get('b', 2), town02_texture)
    scene = _world_prims(len(case), xy, fov)
    want = np.asarray(jax.jit(lambda *a: jr.render_prims_chw(
        *a[:6], JaxResolution(res, res), JaxCameras(a[6], a[7], 2.0 / fov),
        packed=packed))(*scene, xy, sc))
    before = (launches('B7'), launches('B1'))
    got = pr.render_prims_chw(*map(torch.from_numpy, scene), Resolution(res, res),
                              Cameras(torch.from_numpy(xy), torch.from_numpy(sc),
                                      2.0 / fov), packed=packed).numpy()
    assert (launches('B7'), launches('B1')) == before
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _same_pixels(got, want, case) >= 0.999
    # the branch taken: the fused render only where a mip level covers the
    # (padded) view; the frames show prims and background
    size = -(-res // 16) * 16
    assert (pr._warp_mip(2.0 / fov * res / size, size) is None) == \
        (case != 'padded_res100_textured')
    flat = got.reshape(-1) if packed else got.transpose(1, 0, 2, 3).reshape(3, -1).T
    assert len(np.unique(flat, axis=0)) >= 4


def test_render_prims_tiling_above_128_over_a_texture_is_not_ported(renderers):
    """Since the sub-camera tiling is ported, a textured view above 128
    pixels renders as 2 x 2 sub-views of 128 (tests/test_torch_tiled.py
    holds it to the reference) instead of raising."""
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    from torchdrivesim_tpu_torch.utils import Resolution
    p_tex = renderers[2]
    xy = torch.tensor([[100.0, 200.0]])
    sc = torch.tensor([[0.0, 1.0]])
    scene = [torch.from_numpy(a) for a in _world_prims(0, xy.numpy(), 70.0)]
    assert p_tex._tiled_mip(2.0 / 70.0, 256)[1:] == (128, 2)
    image = p_tex.render_prims_chw(*scene, Resolution(256, 256), Cameras(xy, sc, 2.0 / 70.0))
    assert image.shape == (1, 3, 256, 256) and torch.isfinite(image).all()


@pytest.mark.parametrize('k', [4, 3])
def test_cull_prims_to_view_matches_jax_with_ties(k):
    """The reference's ``cull_prims_to_view`` (run eagerly) for quads and
    triangles: the prims kept and their order bit-identical, with distance
    ties (a permuted copy shares the centroid, a mirrored one the distance)
    and degenerate prims (area from corners 0 -> 1 and 0 -> K-1), which
    sort last."""
    rng = np.random.RandomState(k)
    res, b, n, keep = 64, 3, 60, 32
    corners = rng.uniform(-30, res + 30, (b, n, k, 2)).astype(np.float32)
    corners[:, 10] = corners[:, 2, np.roll(np.arange(k), 1)]
    corners[:, 11] = res - corners[:, 2]
    corners[:, 12] = corners[:, 4]
    corners[:, ::7, 1] = corners[:, ::7, 0]
    z = rng.rand(b, n).astype(np.float32)
    colors = rng.rand(b, n, 3).astype(np.float32)
    want = jax_rasterize.cull_prims_to_view(*map(jnp.asarray, (corners, z, colors)),
                                            res, keep)
    got = rasterize.cull_prims_to_view(*map(torch.from_numpy, (corners, z, colors)),
                                       res, keep)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    small = rasterize.cull_prims_to_view(*map(torch.from_numpy, (corners, z, colors)),
                                         res, n)
    assert small[0].shape == (b, n, k, 2)


@pytest.mark.parametrize('textured', [False, True])
def test_differentiable_render_prims_matches_jax(renderers, town02_texture, monkeypatch,
                                                 textured):
    """With ``cfg.differentiable`` the primitive render is the reference's
    plain fallback (``jax_renderer.py:712-747``): each type culled to 32
    prims, quads as triangle pairs, ``rasterize_hard_faces`` over the
    full-resolution sample of the texture or the background color; no
    kernel runs. Res 64, 40 quads and 40 triangles per camera."""
    from torchdrivesim_tpu.rendering.base import Cameras as JaxCameras
    from torchdrivesim_tpu.utils import Resolution as JaxResolution
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    from torchdrivesim_tpu_torch.utils import Resolution
    res, fov = 64, 35.0
    j_tex, j_plain, p_tex, p_plain = renderers
    jr, pr = (j_tex, p_tex) if textured else (j_plain, p_plain)
    monkeypatch.setattr(jr.cfg, 'differentiable', True)
    monkeypatch.setattr(pr.cfg, 'differentiable', True)
    xy, sc = _cameras(11 + textured, 2, town02_texture)
    scene = _world_prims(5 + textured, xy, fov, q=40, t=40)
    want = np.asarray(jax.jit(lambda *a: jr.render_prims_chw(
        *a[:6], JaxResolution(res, res), JaxCameras(a[6], a[7], 2.0 / fov)))(*scene, xy, sc))
    before = (launches('B7'), launches('B8'), launches('B1'))
    got = pr.render_prims_chw(*map(torch.from_numpy, scene), Resolution(res, res),
                              Cameras(torch.from_numpy(xy), torch.from_numpy(sc),
                                      2.0 / fov)).numpy()
    assert (launches('B7'), launches('B8'), launches('B1')) == before
    assert got.shape == want.shape == (2, 3, res, res)
    assert _same_pixels(got, want, f'differentiable textured={textured}') >= 0.999
    assert len(np.unique(got.transpose(1, 0, 2, 3).reshape(3, -1).T, axis=0)) >= 4


def _world_mesh(seed, xy, fov, n_faces=80):
    """A world-space triangle soup around each camera, flat colors and z
    per face on a few levels."""
    rng = np.random.RandomState(seed)
    b = xy.shape[0]
    corners = xy[:, None, None] + rng.uniform(-0.6, 0.6, (b, n_faces, 1, 2)) * fov \
        + rng.uniform(-0.1, 0.1, (b, n_faces, 3, 2)) * fov
    z = np.repeat(rng.randint(2, 6, (b, n_faces, 1)), 3, axis=2).astype(np.float32)
    verts = np.concatenate([corners, z[..., None]], axis=-1).reshape(b, n_faces * 3, 3)
    faces = np.tile(np.arange(n_faces * 3, dtype=np.int32).reshape(1, n_faces, 3),
                    (b, 1, 1))
    attrs = np.repeat(rng.rand(b, n_faces, 1, 3), 3, axis=2).reshape(b, n_faces * 3, 3)
    return verts.astype(np.float32), faces, attrs.astype(np.float32)


MESH_CASES = {
    'wide_view_res32_fov200': dict(res=32, fov=200.0, textured=True),
    'padded_res100_textured': dict(res=100, fov=40.0, textured=True),
    'padded_res100_untextured': dict(res=100, fov=35.0),
    'res144_textured': dict(res=144, fov=70.0, textured=True),
}


@pytest.mark.parametrize('case', list(MESH_CASES))
def test_hard_mesh_render_matches_jax(renderers, town02_texture, case):
    from torchdrivesim_tpu.mesh import RGBMesh as JaxMesh
    from torchdrivesim_tpu.rendering.base import Cameras as JaxCameras
    from torchdrivesim_tpu.utils import Resolution as JaxResolution
    from torchdrivesim_tpu_torch.mesh import RGBMesh
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    from torchdrivesim_tpu_torch.utils import Resolution
    kw = MESH_CASES[case]
    res, fov = kw['res'], kw['fov']
    j_tex, j_plain, p_tex, p_plain = renderers
    jr, pr = (j_tex, p_tex) if kw.get('textured') else (j_plain, p_plain)
    xy, sc = _cameras(sum(map(ord, case)), 2, town02_texture)
    verts, faces, attrs = _world_mesh(len(case), xy, fov)
    want = np.asarray(jax.jit(lambda v, f, a, x, s: jr.render_rgb_mesh_chw(
        JaxMesh(v, f, a), JaxResolution(res, res), JaxCameras(x, s, 2.0 / fov)))(
        verts, faces, attrs, xy, sc))
    got = pr.render_rgb_mesh_chw(
        RGBMesh(*map(torch.from_numpy, (verts, faces, attrs))), Resolution(res, res),
        Cameras(torch.from_numpy(xy), torch.from_numpy(sc), 2.0 / fov)).numpy()
    assert got.shape == want.shape == (2, 3, res, res)
    assert _same_pixels(got, want, case) >= 0.999
    assert len(np.unique(got.transpose(1, 0, 2, 3).reshape(3, -1).T, axis=0)) >= 4


def test_benchmark_step_without_texture_renders_the_frame_mesh():
    """Without a texture the step's image is the hard render of the frame's
    mesh, map included (the reference's ``make_step_fn`` branch), both
    float and packed."""
    from torchdrivesim_tpu_torch.benchmark import build_benchmark_scenario
    from torchdrivesim_tpu_torch.rendering.renderer import pack_rgb8_chw
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    from torchdrivesim_tpu_torch.utils import Resolution
    scn = build_benchmark_scenario(batch_size=2, agent_count=8, res=64, device='cpu')
    sim = scn.sim
    sim.renderer.background_texture = None
    action = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (2, 8, 2)).astype(np.float32))
    state, out = scn.make_step_fn(metrics=False)(sim.state, action)
    all_state = torch.cat([state.agent_state, state.npc_state], dim=-2)
    present = torch.cat([state.present_mask, state.npc_present_mask], dim=-1)
    mesh = sim.birdview_mesh_generator.generate(
        1, agent_state=all_state[:, None], present_mask=present[:, None],
        traffic_light_state=state.traffic_control_state['traffic_light'],
        include_background=True)
    ego = state.agent_state[:, 0]
    cams = Cameras(ego[:, :2], torch.stack([torch.sin(ego[:, 2]), torch.cos(ego[:, 2])],
                                           -1), 2.0 / scn.fov)
    want = sim.renderer.render_rgb_mesh_chw(mesh, Resolution(64, 64), cams)
    assert mesh.faces.shape[1] > 16000
    np.testing.assert_array_equal(out['image'].numpy(), want.numpy())
    road = torch.tensor(sim.renderer.color_map['road'], dtype=torch.float32)
    assert ((want - road[None, :, None, None]).abs() < 0.5).all(dim=1).any()
    np.testing.assert_array_equal(pack_rgb8_chw(want).numpy(),
                                  scn.make_step_fn(metrics=False, packed_image=True)(
                                      sim.state, action)[1]['image'].numpy())


def test_frame_without_prims_renders_the_background(renderers):
    """No primitive at all (the reference's prep fails on the empty z
    minimum, ROADMAP section C): the port draws the background."""
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    from torchdrivesim_tpu_torch.utils import Resolution
    p_plain = renderers[3]
    empty = lambda *shape: torch.zeros((2, 0) + shape)
    cams = Cameras(torch.zeros(2, 2), torch.tensor([[0.0, 1.0], [1.0, 0.0]]), 2.0 / 35.0)
    image = p_plain.render_prims_chw(empty(4, 2), empty(), empty(3), empty(3, 2), empty(),
                                     empty(3), Resolution(48, 48), cams, packed=True)
    assert image.shape == (2, 48, 48) and not image.any()
