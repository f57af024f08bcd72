"""
The port's bilinear background warp (``torchdrivesim_tpu_torch.ops.warp``)
against the JAX package's Pallas kernel in interpret mode, on identical
operands: the mip level and the warp coefficients are built by the JAX
package and handed to both as numpy; and the differentiable background
``warp_background_diff`` against the JAX custom VJP.

Tolerances:

* the image: the exact value is the reference's own, the JAX kernel
  body run in interpret mode in float64 on the same coefficients. The
  port's plain version in float64 equals it to 1e-7 absolute (the port
  reads texels as float32 k/255, the float64 reference as float64 k/255),
  and the port in float32 is no further from it than the reference in
  float32 beyond 1e-5: |port - exact| <= |reference - exact| + 1e-5. The
  two-pass positions ``a*x + b*y + c`` reach ~256 texels, where one float32
  ulp is 3e-5 texel, and the reference's compiled CPU code contracts some
  of them into FMAs, so on a random texture a lerp can move by a few 1e-6
  either way;
* pixels whose validity test (texture row or column against the texture's
  bounds) lies within 1e-4 texel of its bound may take the texture on one
  side and the background color on the other: they are counted, printed
  and left out;
* the pose gradients rtol 1e-4 (with atol 1e-6 x max|grad|): central
  differences of the two forwards and the same chain through the sampling
  positions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdrivesim_tpu.ops.pallas_warp as W
from torchdrivesim_tpu.ops.grids import Grid2D
from torchdrivesim_tpu_torch.ops import warp

from tests.test_torch_soft import float64_jax

torch.set_num_threads(1)

FOV = 40.0
BG_COLOR = np.asarray([0.1, 0.2, 0.3], np.float32)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(W.pl, 'pallas_call',
                        functools.partial(W.pl.pallas_call, interpret=True))


def _scene(seed, b, res, cam_xy=None, left_handed=False):
    """Random texture; cameras at random positions, the even ones heading
    within 20 degrees of 0 or 180 (the transposed-window branch), the odd
    ones within 30 degrees of 90 or 270 (the standard branch)."""
    rng = np.random.RandomState(seed)
    tex = rng.rand(300, 300, 3).astype(np.float32)
    xy = (rng.rand(b, 2) * 120 + 10).astype(np.float32)
    if cam_xy is not None:
        xy = np.asarray(cam_xy, np.float32)
    ang = np.deg2rad(np.where(np.arange(b) % 2 == 0,
                              rng.uniform(-20, 20, b), rng.uniform(60, 120, b))
                     + 180 * (rng.rand(b) > 0.5))
    sc = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    grid = Grid2D(data=jnp.asarray(tex), origin=jnp.zeros(2), cell_size=0.5)
    jmip = W.select_mip(W.build_mip_pyramid(grid), fov=FOV, res=res)
    mip = warp.select_mip(warp.build_mip_pyramid(tex, np.zeros(2), 0.5), FOV, res)
    assert mip.cell_size == jmip.cell_size
    return jmip, mip, xy, sc


def _judge(got, got64, want, exact, name, atol, skip):
    """The port in float32 (``got``) and float64 (``got64``) against the
    reference in float32 (``want``) and float64 (``exact``), as the module
    docstring says; ``skip`` masks values left out."""
    got, got64, want, exact = (np.asarray(x, np.float64)
                               for x in (got, got64, want, exact))
    assert got.shape == want.shape == exact.shape == got64.shape, name
    keep = ~skip
    np.testing.assert_allclose(got64[keep], exact[keep], rtol=0, atol=1e-7,
                               err_msg=f'{name}: float64 formula')
    ok = np.abs(got - exact) <= np.abs(want - exact) + atol
    print(f'{name}: max difference {np.abs(got - want)[keep].max():.3g}, '
          f'{int((~keep).sum())} values left out')
    assert ok[keep].all(), f'{name}: {int((~ok[keep]).sum())} values off'


_jax_warp = jax.jit(W.warp_background_bilinear,
                    static_argnames=('scale', 'left_handed', 'res'))


CASES = {
    'res32': dict(seed=0, b=4, res=32),
    'res64': dict(seed=1, b=4, res=64),
    'res64_left_handed': dict(seed=2, b=2, res=64, left_handed=True),
    # cameras near the texture's corner: part of each view is off the texture
    'texture_edge': dict(seed=3, b=2, res=64, cam_xy=[[3.0, 4.0], [146.0, 2.0]]),
}


@pytest.mark.parametrize('case', list(CASES))
def test_bilinear_plain_matches_jax_kernel(interpret_mode, case):
    kw = dict(CASES[case])
    res, lh = kw['res'], kw.pop('left_handed', False)
    jmip, mip, xy, sc = _scene(**kw)
    args = (jnp.asarray(xy), jnp.asarray(sc))
    want = np.asarray(_jax_warp(jmip, *args, scale=2.0 / FOV,
                                background_color=jnp.asarray(BG_COLOR),
                                left_handed=lh, res=res))
    fcoef, icoef = map(np.asarray, W.warp_coefficients(
        jmip, *args, 2.0 / FOV, jnp.asarray(BG_COLOR), left_handed=lh, res=res))
    assert (icoef[:, 0, 2] == 1).any() and (icoef[:, 0, 2] == 0).any()
    with float64_jax(W), pytest.MonkeyPatch.context() as mp:
        # the same coefficients as the float32 run, widened
        mp.setattr(W, 'warp_coefficients', lambda *a, **k: (
            jnp.asarray(fcoef, jnp.float64), jnp.asarray(icoef)))
        exact = np.asarray(jax.jit(lambda: W.warp_background_bilinear(
            jmip, *args, 2.0 / FOV, jnp.asarray(BG_COLOR), left_handed=lh,
            res=res))())
    f32, i32 = torch.from_numpy(fcoef.copy()), torch.from_numpy(icoef.copy())
    got = warp.warp_view_bilinear(mip.data, f32, i32, res).numpy()
    got64 = warp.warp_view_bilinear_reference(mip.data, f32.double(), i32, res).numpy()
    # pixels whose validity test sits within 1e-4 texel of its bound
    r = np.arange(res, dtype=np.float64)[None, :, None]
    c = np.arange(res, dtype=np.float64)[None, None, :]
    f = lambda k: fcoef[:, 0, k].astype(np.float64)[:, None, None]
    ty, tx = f(6) * r + f(7) * c + f(8), f(9) * r + f(10) * c + f(11)
    near = np.minimum.reduce([np.abs(ty), np.abs(ty - f(12)),
                              np.abs(tx), np.abs(tx - f(13))]) < 1e-4
    _judge(got, got64, want, exact, case, atol=1e-5,
           skip=np.repeat(near[:, None], 3, axis=1))
    if case == 'texture_edge':
        bg = np.floor(BG_COLOR * np.float32(255)) * np.float32(1 / 255)
        assert (want == bg[None, :, None, None]).all(axis=1).any()


def test_sample_positions_match():
    jmip, mip, xy, sc = _scene(4, 3, 64)
    want = W._sample_positions(jmip, jnp.asarray(xy), jnp.asarray(sc), 2.0 / FOV,
                               res=64, left_handed=True)
    got = warp.sample_positions(mip, torch.from_numpy(xy), torch.from_numpy(sc),
                                2.0 / FOV, res=64, left_handed=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize('res,lh', [(64, False), (32, True)])
def test_warp_background_diff_gradients_match_jax(interpret_mode, res, lh):
    jmip, mip, xy, sc = _scene(5, 2, res)
    weight = np.random.RandomState(6).uniform(-1, 1, (2, 3, res, res)).astype(np.float32)

    def jloss(cxy, csc):
        out = W.warp_background_diff(jmip, cxy, csc, 2.0 / FOV,
                                     jnp.asarray(BG_COLOR), left_handed=lh, res=res)
        return jnp.sum(out * weight)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xy), jnp.asarray(sc))
    cxy = torch.from_numpy(xy).requires_grad_(True)
    csc = torch.from_numpy(sc).requires_grad_(True)
    out = warp.warp_background_diff(mip, cxy, csc, 2.0 / FOV,
                                    torch.from_numpy(BG_COLOR), left_handed=lh,
                                    res=res)
    (out * torch.from_numpy(weight)).sum().backward()
    for name, g, w in (('cam_xy', cxy.grad, want[0]), ('cam_sc', csc.grad, want[1])):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(w).max()), err_msg=name)


def test_wrapper_rejects_bad_operands():
    tex = torch.zeros((128, 256), dtype=torch.int32)
    fcoef = torch.zeros((2, 1, 14))
    icoef = torch.zeros((2, 1, 4), dtype=torch.int32)
    assert warp.warp_view_bilinear(tex, fcoef, icoef, 16).shape == (2, 3, 16, 16)
    with pytest.raises(ValueError):
        warp.warp_view_bilinear(tex, fcoef, icoef, 130)
    with pytest.raises(ValueError):
        warp.warp_view_bilinear(tex, fcoef.double(), icoef, 16)
    with pytest.raises(ValueError):
        warp.warp_view_bilinear(tex[:64], fcoef, icoef, 16)


_STUB = r'''
#include <stdint.h>
/* the kernel's C signature; returns the index of the first wrong argument */
int tds_warp_bilinear(const float* fcoef, const int* icoef, const int* tex,
                      int tex_h, int tex_w, int batch, int res, void* out,
                      void* stream) {
  if ((uintptr_t)fcoef != 0x7f0000001000ull) return 1;
  if ((uintptr_t)icoef != 0x7f0000001100ull) return 2;
  if ((uintptr_t)tex != 0x7f0000001200ull) return 3;
  if (tex_h != 384 || tex_w != 512) return 4;
  if (batch != 16 || res != 64) return 5;
  if ((uintptr_t)out != 0x7f00000ff000ull) return 6;
  if ((uintptr_t)stream != 0x7ffd12345678abc0ull) return 7;
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
    stub = warp._bind_bilinear(ctypes.CDLL(str(lib)))
    assert stub.tds_warp_bilinear(0x7f0000001000, 0x7f0000001100, 0x7f0000001200,
                                  384, 512, 16, 64, 0x7f00000ff000,
                                  0x7ffd12345678abc0) == 0
