"""
The port's nearest-texel background warp (``torchdrivesim_tpu_torch.ops.warp
.warp_view_nearest``, kernel B2) against the JAX package's
``warp_background_pallas`` with its Pallas kernel in interpret mode.

* On identical operands (the JAX package's mip level and warp coefficients
  handed to both as numpy) the two pick texels by the same integer index
  arithmetic, so the comparison is exact up to one traced cause: the port
  rounds every multiply and add of an ``a*x + b*y + c`` on its own, while
  the reference's compiled CPU code fuses some of them into FMAs. The test
  renders the port under all three roundings; every pixel whose value does
  not depend on the rounding must match exactly, and at every pixel the
  reference's value must be one of the three. The pixels that hang on the
  rounding are counted and bounded (at most 1%).
* End to end (each package computes its own coefficients, which agree to
  1e-6 relative), at least 99.9% of the pixels are identical.
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

import torchdrivesim_tpu.ops.pallas_warp as W
from tests.test_torch_fused import ROUNDINGS
from torchdrivesim_tpu.ops.grids import Grid2D
from torchdrivesim_tpu_torch import tracing
from torchdrivesim_tpu_torch.ops import warp


def launches(kernel: str) -> int:
    """The launches so far of the hand-written ``kernel`` (B1 ... HF)."""
    return tracing.counts().get(f'launch.{kernel}', 0)


torch.set_num_threads(1)

FOV = 40.0
BG_COLOR = np.asarray([0.1, 0.2, 0.3], np.float32)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(W.pl, 'pallas_call',
                        functools.partial(W.pl.pallas_call, interpret=True))


def _scene(seed, b, res, cam_xy=None):
    """A random texture; cameras at random positions, the even ones heading
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


_jax_warp = jax.jit(W.warp_background_pallas,
                    static_argnames=('scale', 'left_handed', 'res'))


def judge_roundings(render, want, label):
    """``render()`` (numpy, channels on axis -3) against the reference's
    ``want`` under the three roundings of ``warp.affine``: exact wherever
    they agree, one of them everywhere. Returns the count of pixels that
    hang on the rounding."""
    got = render()
    variants = [got]
    for rounding in ROUNDINGS.values():
        with pytest.MonkeyPatch.context() as m:
            m.setattr(warp, 'affine', rounding)
            variants.append(render())
    assert got.shape == want.shape and got.dtype == want.dtype
    determinate = np.logical_and.reduce([v == got for v in variants])
    explained = np.logical_or.reduce([v == want for v in variants])
    ambiguous = int((~determinate).any(axis=-3).sum())
    print(f'{label}: {int((got != want).any(axis=-3).sum())} of '
          f'{got[..., 0, :, :].size} pixels differ from the reference, '
          f'{ambiguous} hang on the rounding')
    np.testing.assert_array_equal(got[determinate], want[determinate])
    assert explained.all()
    return ambiguous


CASES = {
    'res32': dict(seed=0, b=4, res=32),
    'res64': dict(seed=1, b=4, res=64),
    'res128': dict(seed=2, b=2, res=128),
    'res64_left_handed': dict(seed=3, b=2, res=64, left_handed=True),
    # cameras near the texture's corners: part of each view is off the texture
    'texture_edge': dict(seed=4, b=2, res=64, cam_xy=[[3.0, 4.0], [146.0, 2.0]]),
}


@pytest.mark.parametrize('case', list(CASES))
def test_nearest_plain_matches_jax_kernel(interpret_mode, case):
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
    ops = (mip.data, torch.from_numpy(fcoef.copy()), torch.from_numpy(icoef.copy()), res)
    assert want.shape == (kw['b'], 3, res, res) and want.dtype == np.float32
    ambiguous = judge_roundings(lambda: warp.warp_view_nearest(*ops).numpy(), want, case)
    assert ambiguous <= 0.01 * kw['b'] * res * res
    if case == 'texture_edge':
        bg = np.floor(BG_COLOR * np.float32(255)) * np.float32(1 / 255)
        assert (want == bg[None, :, None, None]).all(axis=1).any()


@pytest.mark.parametrize('res', [32, 64])
def test_warp_background_nearest_end_to_end(interpret_mode, res):
    """Each package from its own coefficients: >= 99.9% identical pixels."""
    jmip, mip, xy, sc = _scene(5, 8, res)
    want = np.asarray(_jax_warp(jmip, jnp.asarray(xy), jnp.asarray(sc), scale=2.0 / FOV,
                                background_color=jnp.asarray(BG_COLOR),
                                left_handed=False, res=res))
    got = warp.warp_background_nearest(mip, torch.from_numpy(xy), torch.from_numpy(sc),
                                       2.0 / FOV, torch.from_numpy(BG_COLOR),
                                       res=res).numpy()
    same = (got == want).all(axis=1)
    print(f'res {res}: {int(same.sum())} of {same.size} pixels identical')
    assert same.mean() >= 0.999


def test_nearest_is_the_packed_texel_unpacked():
    """The plain version unpacks the packed background the fused render
    composites, channel k = ((t >> 8k) & 255) * float32(1/255)."""
    _, mip, xy, sc = _scene(6, 4, 64)
    fcoef, icoef = warp.warp_coefficients(mip, torch.from_numpy(xy), torch.from_numpy(sc),
                                          2.0 / FOV, torch.from_numpy(BG_COLOR), res=64)
    packed = warp.warp_view_packed_reference(mip.data, fcoef, icoef, 64).numpy()
    got = warp.warp_view_nearest(mip.data, fcoef, icoef, 64).numpy()
    for k in range(3):
        want = ((packed >> (8 * k)) & 255).astype(np.float32) * np.float32(1 / 255)
        np.testing.assert_array_equal(got[:, k], want)


def test_wrapper_rejects_bad_operands():
    tex = torch.zeros((128, 256), dtype=torch.int32)
    fcoef = torch.zeros((2, 1, 14))
    icoef = torch.zeros((2, 1, 4), dtype=torch.int32)
    before = launches('B2')
    assert warp.warp_view_nearest(tex, fcoef, icoef, 16).shape == (2, 3, 16, 16)
    assert launches('B2') == before          # the CPU runs no kernel
    with pytest.raises(ValueError):
        warp.warp_view_nearest(tex, fcoef, icoef, 129)
    with pytest.raises(ValueError):
        warp.warp_view_nearest(tex, fcoef.double(), icoef, 16)
    with pytest.raises(ValueError):
        warp.warp_view_nearest(tex[:64], fcoef, icoef, 16)


_STUB = r'''
#include <stdint.h>
/* the kernel's C signature; returns the index of the first wrong argument */
int tds_warp_nearest(const void* fcoef, const void* icoef, const void* tex,
                     int tex_h, int tex_w, int batch, int res, void* out,
                     void* stream) {
  if ((uintptr_t)fcoef != 0x7f0000001000ull) return 1;
  if ((uintptr_t)icoef != 0x7f0000001100ull) return 2;
  if ((uintptr_t)tex != 0x7f0000001200ull) return 3;
  if (tex_h != 384 || tex_w != 512) return 4;
  if (batch != 1024 || res != 64) return 5;
  if ((uintptr_t)out != 0x7f00000ff000ull) return 6;
  if ((uintptr_t)stream != 0x7ffd12345678abc0ull) return 7;
  return 0;
}
'''


def test_kernel_entry_point_receives_its_arguments(tmp_path):
    """The ctypes binding passes every argument in place, 64-bit pointers
    (the stream) included, to a stub with the kernel's C signature."""
    cc = shutil.which('cc')
    if cc is None:
        pytest.skip('needs a C compiler')
    src, lib = tmp_path / 'stub.c', tmp_path / 'stub.so'
    src.write_text(_STUB)
    subprocess.run([cc, '-shared', '-fPIC', '-o', str(lib), str(src)], check=True)
    stub = warp._bind_nearest(ctypes.CDLL(str(lib)))
    assert stub.tds_warp_nearest(0x7f0000001000, 0x7f0000001100, 0x7f0000001200,
                                 384, 512, 1024, 64, 0x7f00000ff000,
                                 0x7ffd12345678abc0) == 0
