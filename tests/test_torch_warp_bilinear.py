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
  positions. The port's plain VJP is the chain in closed form with float64
  sums; it is held to the same tolerance against the autograd chain
  through ``sample_positions`` (``chip_smoke.autograd_warp_vjp``, the
  port's backward before the VJP kernel) and against the JAX custom VJP;
* the forward from the poses: bit for bit. ``csrc/warp_coef.cuh`` builds
  the coefficients on the card from the host's float32 constants
  (``warp._pose_constants``); its transcription to numpy float32 here
  must give ``warp_coefficients``' coefficients bit for bit.
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

import chip_smoke
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
    got = warp.warp_view_bilinear_reference(mip.data, f32, i32, res).numpy()
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


def _pose_coefficients(mip, xy, sc, scale, bg, left_handed, res):
    """``csrc/warp_coef.cuh:warp_coefficients`` transcribed to numpy float32
    (every operation rounded on its own, as the kernel's intrinsics), from
    the constants the wrapper passes: (fcoef (B, 1, 14), icoef (B, 1, 4)).
    ``/ cell`` is a product by float32(1 / cell), as PyTorch computes it on
    CUDA tensors; for the power-of-two cells here that is the division."""
    f = np.float32
    m, mh0, orig_x, orig_y, cell, lh, h_tex, w_tex = map(
        f, warp._pose_constants(mip, scale, res, left_handed))
    x, y = xy[:, 0].astype(f), xy[:, 1].astype(f)
    sn, cs = sc[:, 0].astype(f), sc[:, 1].astype(f)
    a_y, b_y = (-sn) * m, ((-lh) * cs) * m
    a_x, b_x = (-cs) * m, (lh * sn) * m
    inv_cell = f(1) / cell
    cy, cx = (y - orig_y) * inv_cell, (x - orig_x) * inv_cell
    e_y = cy + mh0 * (sn + lh * cs)
    e_x = cx + mh0 * (cs - lh * sn)
    h_pad, w_pad = mip.data.shape
    oy = np.clip(8 * np.rint((cy - f(63.5)) * f(0.125)).astype(np.int32), 0,
                 max(h_pad - 128, 0))
    ox = np.clip(128 * np.rint((cx - f(128)) * f(1 / 128)).astype(np.int32), 0,
                 max(w_pad - 256, 0))
    e1, e2 = e_y - oy.astype(f), e_x - ox.astype(f)
    flip = np.abs(a_y) < np.abs(a_x)
    pa1, pb1, pe1 = (np.where(flip, p, q) for p, q in ((a_x, a_y), (b_x, b_y), (e2, e1)))
    pa2, pb2, pe2 = (np.where(flip, p, q) for p, q in ((a_y, a_x), (b_y, b_x), (e1, e2)))
    safe = np.where(np.abs(pa1) < f(1e-9), f(1e-9), pa1)
    q = np.clip(np.asarray(bg, f) * f(255), f(0), f(255)).astype(np.int32)
    full = lambda v: np.full_like(a_y, v)
    fcoef = np.stack([pa1, pb1, pe1, pa2 / safe, pb2 - (pa2 * pb1) / safe,
                      pe2 - (pa2 * pe1) / safe, a_y, b_y, e_y, a_x, b_x, e_x,
                      full(h_tex), full(w_tex)], -1)[:, None]
    icoef = np.stack([oy, ox, flip.astype(np.int32),
                      np.full_like(oy, q[0] | (q[1] << 8) | (q[2] << 16))], -1)[:, None]
    return fcoef, icoef


def _pose_case(case):
    """(mip, cam_xy, cam_sc, scale, background colour, left_handed), res of
    a case of CASES, or of the cameras whose view rows and columns lie
    exactly on the texture's bounds (``chip_smoke.edge_warp_case``)."""
    if case == 'texture_bounds':
        return chip_smoke.edge_warp_case(torch.device('cpu')), 64
    kw = dict(CASES[case])
    res, lh = kw['res'], kw.pop('left_handed', False)
    _, mip, xy, sc = _scene(**kw)
    return (mip, torch.from_numpy(xy), torch.from_numpy(sc), 2.0 / FOV,
            torch.from_numpy(BG_COLOR), lh), res


@pytest.mark.parametrize('case', [*CASES, 'texture_bounds'])
def test_pose_forward_matches_coefficient_path(case):
    """The kernel's coefficient arithmetic (transcribed) from the wrapper's
    constants gives ``warp_coefficients`` bit for bit, on both branches,
    left-handed and at the texture's edge; and the pose-driven forward's
    plain version is ``warp_coefficients`` then the bilinear body."""
    wargs, res = _pose_case(case)
    mip, xy, sc, scale, bg, lh = wargs
    fcoef, icoef = warp.warp_coefficients(mip, xy, sc, scale, bg, lh, res=res)
    assert (icoef[:, 0, 2] == 1).any() and (icoef[:, 0, 2] == 0).any()
    want_f, want_i = _pose_coefficients(mip, xy.numpy(), sc.numpy(), scale,
                                        bg.numpy(), lh, res)
    np.testing.assert_array_equal(fcoef.numpy().view(np.uint32), want_f.view(np.uint32))
    np.testing.assert_array_equal(icoef.numpy(), want_i)
    got = warp.warp_background_bilinear(*wargs, res)
    want = warp.warp_view_bilinear_reference(mip.data, fcoef, icoef, res)
    assert torch.equal(got, want)
    if case in ('texture_edge', 'texture_bounds'):
        colour = torch.stack([warp._channel(icoef[0, 0, 3], ch) for ch in range(3)])
        bg_px = (got == colour[None, :, None, None]).all(1)
        assert bg_px.any() and not bg_px.all()


@pytest.mark.parametrize('case', list(CASES))
def test_vjp_plain_matches_autograd_chain_and_jax(monkeypatch, case):
    """The closed-form plain VJP against the autograd chain through
    ``sample_positions`` and against the JAX custom VJP, all three on the
    port's view (the JAX forward patched to return it), rtol 1e-4 (atol
    1e-6 x max|grad|)."""
    kw = dict(CASES[case])
    res, lh = kw['res'], kw.pop('left_handed', False)
    jmip, mip, xy, sc = _scene(**kw)
    b = xy.shape[0]
    g = np.random.RandomState(20 + kw['seed']).uniform(-1, 1, (b, 3, res, res)
                                                        ).astype(np.float32)
    txy, tsc, tg = torch.from_numpy(xy), torch.from_numpy(sc), torch.from_numpy(g)
    out = warp.warp_background_bilinear(mip, txy, tsc, 2.0 / FOV,
                                        torch.from_numpy(BG_COLOR), lh, res)
    monkeypatch.setattr(W, 'warp_background_bilinear',
                        lambda *a, **k: jnp.asarray(out.numpy()))
    _, vjp_fn = jax.vjp(lambda cxy, csc: W.warp_background_diff(
        jmip, cxy, csc, 2.0 / FOV, jnp.asarray(BG_COLOR), left_handed=lh, res=res),
        jnp.asarray(xy), jnp.asarray(sc))
    jax_grads = [np.asarray(v) for v in vjp_fn(jnp.asarray(g))]
    plain = warp.warp_bilinear_vjp_reference(mip, out, tg, txy, tsc, 2.0 / FOV, lh, res)
    assert [tuple(p.shape) for p in plain] == [(b, 2), (b, 2)]
    chain = chip_smoke.autograd_warp_vjp(warp, mip, out, tg, txy, tsc, 2.0 / FOV, lh, res)
    for oracle, want in (('autograd chain', [w.numpy() for w in chain]),
                         ('JAX custom VJP', jax_grads)):
        for name, got, w in zip(('cam_xy', 'cam_sc'), plain, want):
            assert np.abs(w).max() > 0, name
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=f'{case} {name} against the {oracle}')


def test_wrapper_rejects_bad_operands():
    mip = warp.MipLevel(torch.zeros((128, 256), dtype=torch.int32),
                        np.zeros(2, np.float32), 1.0, (128, 256))
    xy = torch.zeros((2, 2))
    sc = torch.tensor([[0.0, 1.0], [1.0, 0.0]])
    bg = torch.tensor([0.1, 0.2, 0.3])
    out = warp.warp_background_bilinear(mip, xy, sc, 0.05, bg, res=16)
    assert out.shape == (2, 3, 16, 16)
    assert [tuple(v.shape) for v in warp.warp_bilinear_vjp(
        mip, out, out, xy, sc, 0.05, res=16)] == [(2, 2), (2, 2)]
    small, as_float, flat = (
        warp.MipLevel(t, mip.origin, 1.0, mip.valid_shape)
        for t in (mip.data[:64], mip.data.float(), mip.data.reshape(-1)))
    for bad in (dict(res=130), dict(cam_xy=xy[:1]), dict(cam_sc=sc.reshape(1, 4)),
                dict(cam_xy=xy.to('meta')), dict(cam_xy=xy.long()), dict(mip=small),
                dict(mip=as_float), dict(mip=flat)):
        kw = {**dict(mip=mip, cam_xy=xy, cam_sc=sc, res=16), **bad}
        with pytest.raises(ValueError):
            warp.warp_background_bilinear(kw['mip'], kw['cam_xy'], kw['cam_sc'], 0.05,
                                          bg, res=kw['res'])
    for args in ((mip, out[:, :, :8], out, 16), (mip, out, out[:1], 16),
                 (mip, out, out, 1), (small, out, out, 16)):
        with pytest.raises(ValueError):
            warp.warp_bilinear_vjp(args[0], args[1], args[2], xy, sc, 0.05, res=args[3])


_STUB = r"""
#include <stdint.h>
/* the kernels' C signatures; each returns the index of the first wrong
   argument */
static int poses_ok(const float* xy, int xs0, int xs1, const float* sc,
                    int ss0, int ss1) {
  return (uintptr_t)xy == 0x7f0000001100ull && xs0 == 32 && xs1 == 1
      && (uintptr_t)sc == 0x7f0000001200ull && ss0 == 2 && ss1 == 1;
}
static int consts_ok(float m, float mh0, float ox, float oy, float cell,
                     float lh, float h_tex, float w_tex) {
  return m == 0.625f && mh0 == 19.6875f && ox == -3.5f && oy == 7.25f
      && cell == 2.0f && lh == -1.0f && h_tex == 300.0f && w_tex == 301.0f;
}
int tds_warp_bilinear_pose(const int* tex, int tex_h, int tex_w,
                           const float* cam_xy, int xy_s0, int xy_s1,
                           const float* cam_sc, int sc_s0, int sc_s1,
                           const float* bg, float m, float mh0, float origin_x,
                           float origin_y, float cell, float lh, float h_tex,
                           float w_tex, int batch, int res, void* out,
                           void* stream) {
  if ((uintptr_t)tex != 0x7f0000001000ull) return 1;
  if (tex_h != 384 || tex_w != 512) return 2;
  if (!poses_ok(cam_xy, xy_s0, xy_s1, cam_sc, sc_s0, sc_s1)) return 3;
  if ((uintptr_t)bg != 0x7f0000001300ull) return 4;
  if (!consts_ok(m, mh0, origin_x, origin_y, cell, lh, h_tex, w_tex)) return 5;
  if (batch != 16 || res != 64) return 6;
  if ((uintptr_t)out != 0x7f00000ff000ull) return 7;
  if ((uintptr_t)stream != 0x7ffd12345678abc0ull) return 8;
  return 0;
}
int tds_warp_bilinear_vjp(const float* out, const float* g,
                          const float* cam_xy, int xy_s0, int xy_s1,
                          const float* cam_sc, int sc_s0, int sc_s1, float m,
                          float mh0, float origin_x, float origin_y, float cell,
                          float lh, float h_tex, float w_tex, int batch, int res,
                          void* gxy, void* gsc, void* stream) {
  if ((uintptr_t)out != 0x7f00000ff000ull || (uintptr_t)g != 0x7f00000fe000ull)
    return 1;
  if (!poses_ok(cam_xy, xy_s0, xy_s1, cam_sc, sc_s0, sc_s1)) return 2;
  if (!consts_ok(m, mh0, origin_x, origin_y, cell, lh, h_tex, w_tex)) return 3;
  if (batch != 16 || res != 64) return 4;
  if ((uintptr_t)gxy != 0x7f0000002000ull || (uintptr_t)gsc != 0x7f0000003000ull)
    return 5;
  if ((uintptr_t)stream != 0x7ffd12345678abc0ull) return 6;
  return 0;
}
"""


def test_kernel_entry_point_receives_its_arguments(tmp_path):
    """The ctypes bindings pass every argument in place, 64-bit pointers
    (the stream) and float constants included, to stubs with the kernels'
    C signatures."""
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
    poses = (0x7f0000001100, 32, 1, 0x7f0000001200, 2, 1)
    consts = (0.625, 19.6875, -3.5, 7.25, 2.0, -1.0, 300.0, 301.0)
    assert stub.tds_warp_bilinear_pose(0x7f0000001000, 384, 512, *poses,
                                       0x7f0000001300, *consts, 16, 64,
                                       0x7f00000ff000, 0x7ffd12345678abc0) == 0
    assert stub.tds_warp_bilinear_vjp(0x7f00000ff000, 0x7f00000fe000, *poses,
                                      *consts, 16, 64, 0x7f0000002000,
                                      0x7f0000003000, 0x7ffd12345678abc0) == 0
