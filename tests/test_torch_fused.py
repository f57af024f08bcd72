"""
The port's fused render (``torchdrivesim_tpu_torch.ops.fused``) against the
JAX package's Pallas kernel in interpret mode, on identical operands: the
texture, warp coefficients and prepared primitives are built once by the
JAX package and handed to both as numpy. Both resolve an integer winner per
pixel, so the comparison is exact.

Exact up to one traced cause: the port rounds every multiply and add of an
``a*x + b*y + c`` on its own, while the reference's compiled CPU code fuses
some of them into FMAs (``fma(a, x, b*y)`` in one fusion, ``fma(b, y, a*x)``
in another). A pixel whose outcome hangs on the last bit of such a sum can
therefore differ. The test renders the port under all three roundings and
requires the reference's value at EVERY pixel to be one of them; every pixel
whose outcome does not depend on the rounding must match exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import torchdrivesim_tpu.ops.pallas_fused as F
import torchdrivesim_tpu.ops.pallas_rasterize as R
import torchdrivesim_tpu.ops.pallas_warp as W
from torchdrivesim_tpu.ops.grids import Grid2D
from torchdrivesim_tpu.ops.rasterize import prep_sorted_prim_coefs
from torchdrivesim_tpu_torch.ops import fused, warp

torch.set_num_threads(1)

SENT = 0x7FFFFFFF
FOV = 40.0
BG_COLOR = np.asarray([0.1, 0.2, 0.3], np.float32)


@pytest.fixture
def interpret_mode(monkeypatch):
    original = pl.pallas_call
    for mod in (W, R, F):
        monkeypatch.setattr(mod.pl, 'pallas_call',
                            functools.partial(original, interpret=True))


def _scene(seed, b=1, q=30, t=12, angles=None, cam_xy=None):
    """The recipe of tests/test_pallas_fused.py, as numpy."""
    rng = np.random.RandomState(seed)
    tex = rng.rand(300, 300, 3).astype(np.float32)
    xy = (rng.rand(b, 2) * 120 + 10).astype(np.float32)
    ang = rng.rand(b) * 2 * np.pi
    if angles is not None:
        ang = np.asarray(angles)
    if cam_xy is not None:
        xy = np.asarray(cam_xy, np.float32)
    sc = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    c0 = rng.rand(b, q, 2) * 140 - 6
    e1 = rng.randn(b, q, 2) * 6
    e2 = rng.randn(b, q, 2) * 6
    quads = np.stack([c0, c0 + e1, c0 + e1 + e2, c0 + e2], axis=2).astype(np.float32)
    tris = (rng.rand(b, t, 3, 2) * 140 - 6).astype(np.float32)
    qz, tz = rng.rand(b, q).astype(np.float32), rng.rand(b, t).astype(np.float32)
    qc, tc = rng.rand(b, q, 3).astype(np.float32), rng.rand(b, t, 3).astype(np.float32)
    return tex, xy, sc, quads, qz, qc, tris, tz, tc


def _jax_mip(tex):
    grid = Grid2D(data=jnp.asarray(tex), origin=jnp.zeros(2), cell_size=0.5)
    return W.select_mip(W.build_mip_pyramid(grid), fov=FOV)


def _port_mip(tex):
    return warp.select_mip(warp.build_mip_pyramid(tex, np.zeros(2), 0.5), fov=FOV)


def _operands(scene, res, no_prims=False):
    tex, xy, sc, quads, qz, qc, tris, tz, tc = scene
    b = xy.shape[0]
    n_bands = R.n_bands_for(res)
    if no_prims:
        # degenerate (all-zero) prims with dead masks: only the warp remains
        # (padded like the prim cases, so the reference compiles once)
        qp, tp = -(-quads.shape[1] // 8) * 8, -(-tris.shape[1] // 8) * 8
        return (np.zeros((b, 2, qp, 3), np.float32), np.full((b, qp, 1), SENT, np.int32),
                np.zeros((b, 3, tp, 3), np.float32), np.full((b, tp, 1), SENT, np.int32),
                np.zeros((b, n_bands, 1, qp // 8), np.int32),
                np.zeros((b, n_bands, 1, tp // 8), np.int32))
    prep = prep_sorted_prim_coefs(*map(jnp.asarray, (quads, qz, qc, tris, tz, tc)),
                                  res, 56, n_bands)
    qcoef, qpk, qmask, tcoef, tpk, tmask = map(np.asarray, prep)
    return qcoef, qpk, tcoef, tpk, qmask, tmask


# one compile per operand shape (the kernel is traced anew on every eager call)
_jax_render = jax.jit(F.render_coefs_fused_pallas,
                      static_argnames=('scale', 'res', 'packed_output'))


def _fma(a, x, y):
    """float32 ``a*x + y`` with one rounding (the product is exact in float64)."""
    return (a.double() * x.double() + y.double()).float()


#: the roundings of ``a*x + b*y + c`` the reference's compiled code may use
ROUNDINGS = {
    'fma_ax': lambda a, x, b, y, c: _fma(a, x, b * y) + c,
    'fma_by': lambda a, x, b, y, c: _fma(b, y, a * x) + c,
}


def _render_both(scene, res, monkeypatch, packed=False, no_prims=False):
    tex, xy, sc = scene[:3]
    mip = _jax_mip(tex)
    ops = _operands(scene, res, no_prims)
    ref = _jax_render(mip, jnp.asarray(xy), jnp.asarray(sc), scale=2.0 / FOV,
                      background_color=jnp.asarray(BG_COLOR),
                      qcoef=ops[0], qpk=ops[1], tcoef=ops[2], tpk=ops[3],
                      qmask=ops[4], tmask=ops[5], res=res, packed_output=packed)
    fcoef, icoef = map(np.asarray, W.warp_coefficients(
        mip, jnp.asarray(xy), jnp.asarray(sc), 2.0 / FOV, jnp.asarray(BG_COLOR),
        res=res))
    args = [_port_mip(tex), torch.from_numpy(fcoef), torch.from_numpy(icoef)]
    args += [torch.from_numpy(np.array(a)) for a in ops]
    got = fused.render_coefs_fused(*args, res, packed).numpy()
    variants = [got]
    for rounding in ROUNDINGS.values():
        with monkeypatch.context() as m:
            m.setattr(warp, 'affine', rounding)
            variants.append(fused.render_coefs_fused(*args, res, packed).numpy())
    return np.asarray(ref), got, variants, icoef


CASES = {
    'res128': dict(seed=0, res=128),
    'res64': dict(seed=7, res=64),
    'res32': dict(seed=3, res=32),
    'near_90deg': dict(seed=5, res=128, angles=np.deg2rad([-94.5])),
    # headings near 0 / 180 deg take the transposed-window branch
    'flip_branch': dict(seed=8, res=128, angles=np.deg2rad([178.0])),
    'texture_edge': dict(seed=2, res=128, cam_xy=[[148.0, 3.0]]),
    'no_prims': dict(seed=3, res=128, no_prims=True),
    'packed_res64_flip': dict(seed=4, res=64, packed=True,
                              angles=np.deg2rad([182.0])),
}


@pytest.mark.parametrize('case', list(CASES))
def test_fused_reference_matches_jax_kernel(interpret_mode, monkeypatch, case):
    kw = dict(CASES[case])
    seed, res = kw.pop('seed'), kw.pop('res')
    packed, no_prims = kw.pop('packed', False), kw.pop('no_prims', False)
    scene = _scene(seed, **kw)
    ref, got, variants, icoef = _render_both(scene, res, monkeypatch,
                                             packed=packed, no_prims=no_prims)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    determinate = np.logical_and.reduce([v == got for v in variants])
    explained = np.logical_or.reduce([v == ref for v in variants])
    print(f'{case}: {int((got != ref).sum())} of {ref.size} values differ from '
          f'the reference, {int((~determinate).sum())} hang on the rounding')
    np.testing.assert_array_equal(got[determinate], ref[determinate])
    assert explained.all()
    if case in ('packed_res64_flip', 'flip_branch'):
        assert (icoef[:, 0, 2] == 1).all()
    if case == 'near_90deg':
        assert (icoef[:, 0, 2] == 0).all()
    if case == 'texture_edge':
        # some pixels fall off the texture and take the background color
        bg = np.floor(BG_COLOR * np.float32(255)) * np.float32(1 / 255)
        assert (ref == bg[None, :, None, None]).all(axis=1).any()


def test_mip_pyramid_and_selection_match():
    tex = _scene(1)[0]
    grid = Grid2D(data=jnp.asarray(tex), origin=jnp.zeros(2), cell_size=0.5)
    ref = W.build_mip_pyramid(grid)
    got = warp.build_mip_pyramid(tex, np.zeros(2), 0.5)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(r.data)[..., 0])
        np.testing.assert_array_equal(g.origin, np.asarray(r.origin))
        assert g.cell_size == r.cell_size and g.valid_shape == r.valid_shape
    for fov, res in [(40.0, 128), (70.0, 128), (70.0, 64), (200.0, 32)]:
        assert (warp.select_mip(got, fov, res).cell_size
                == W.select_mip(ref, fov, res).cell_size)


@pytest.mark.parametrize('res,lh', [(128, False), (64, True)])
def test_warp_coefficients_match(res, lh):
    tex, xy, sc = _scene(6, b=16)[:3]
    ang = np.linspace(-np.pi, np.pi, 16)
    sc = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    fref, iref = map(np.asarray, W.warp_coefficients(
        _jax_mip(tex), jnp.asarray(xy), jnp.asarray(sc), 2.0 / FOV,
        jnp.asarray(BG_COLOR), left_handed=lh, res=res))
    fgot, igot = warp.warp_coefficients(
        _port_mip(tex), torch.from_numpy(xy), torch.from_numpy(sc), 2.0 / FOV,
        torch.from_numpy(BG_COLOR), left_handed=lh, res=res)
    np.testing.assert_array_equal(igot.numpy(), iref)
    np.testing.assert_allclose(fgot.numpy(), fref, rtol=1e-6)


def test_wrapper_rejects_bad_operands():
    scene = _scene(0, b=2)
    tex, xy, sc = scene[:3]
    mip = _port_mip(tex)
    ops = [torch.from_numpy(a) for a in _operands(scene, 128, no_prims=True)]
    fcoef = torch.zeros((2, 1, 14))
    icoef = torch.zeros((2, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused.render_coefs_fused(mip, fcoef, icoef, *ops, res=120)
    with pytest.raises(ValueError):
        fused.render_coefs_fused(mip, fcoef.double(), icoef, *ops, res=128)


_STUB = r'''
#include <stdint.h>
/* the kernel's C signature; returns the index of the first wrong argument */
int tds_fused_render(const void* p0, const void* p1, const void* p2,
                     const void* p3, const void* p4, const void* p5,
                     const void* p6, const void* p7, const void* p8,
                     int tex_h, int tex_w, int batch, int res, int rpb,
                     int qp, int tp, int packed, void* out, void* stream) {
  const void* p[9] = {p0, p1, p2, p3, p4, p5, p6, p7, p8};
  for (int i = 0; i < 9; ++i)
    if ((uintptr_t)p[i] != 0x7f0000001000ull + 0x100 * i) return 1 + i;
  if (tex_h != 384 || tex_w != 512) return 10;
  if (batch != 256 || res != 128 || rpb != 32) return 11;
  if (qp != 48 || tp != 24 || packed != 1) return 12;
  if ((uintptr_t)out != 0x7f00000ff000ull) return 13;
  if ((uintptr_t)stream != 0x7ffd12345678abc0ull) return 14;
  return 0;
}
'''


def test_kernel_entry_point_receives_its_arguments(tmp_path):
    """The ctypes binding passes every argument in place, 64-bit pointers
    (the stream) included, to a stub with the kernel's C signature."""
    import ctypes
    import shutil
    import subprocess
    cc = shutil.which('cc')
    if cc is None:
        pytest.skip('needs a C compiler')
    src, lib = tmp_path / 'stub.c', tmp_path / 'stub.so'
    src.write_text(_STUB)
    subprocess.run([cc, '-shared', '-fPIC', '-o', str(lib), str(src)], check=True)
    stub = fused._bind(ctypes.CDLL(str(lib)))
    ptrs = [0x7f0000001000 + 0x100 * i for i in range(9)]
    assert fused._launch(stub, ptrs, 384, 512, 256, 128, 48, 24, True,
                         0x7f00000ff000, 0x7ffd12345678abc0) == 0
