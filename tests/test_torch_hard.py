"""
The port's hard z-priority raster (``torchdrivesim_tpu_torch.ops.hard``,
kernels B6a and B6b) against the JAX package's ``rasterize_hard_pallas``
with its Pallas kernels in interpret mode, on identical inputs (corners, z,
colors and background made with numpy and handed to both); and the view
cull ``cull_faces_to_view`` against the JAX function.

Both resolve an integer winner per pixel, so the comparison is exact up to
one traced cause: the port rounds every multiply and add of an edge value
``a*x + b*y + c`` on its own, while the reference's compiled CPU code fuses
some of them into FMAs. The test renders the port under all three roundings;
every pixel whose value does not depend on the rounding must match exactly,
and at every pixel the reference's value must be one of the three. Inputs
on a 1/8-pixel grid make every edge value exact, so there the match is
exact at every pixel, pixels that lie exactly on an edge included.
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

import torchdrivesim_tpu.ops.pallas_rasterize as R
from tests.test_torch_warp_nearest import judge_roundings
from torchdrivesim_tpu.ops import rasterize as jax_rasterize
from torchdrivesim_tpu_torch import tracing
from torchdrivesim_tpu_torch.ops import hard
from torchdrivesim_tpu_torch.ops.rasterize import cull_faces_to_view


def launches(kernel: str) -> int:
    """The launches so far of the hand-written ``kernel`` (B1 ... HF)."""
    return tracing.counts().get(f'launch.{kernel}', 0)


torch.set_num_threads(1)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(R.pl, 'pallas_call',
                        functools.partial(R.pl.pallas_call, interpret=True))


_jax_raster = jax.jit(R.rasterize_hard_pallas, static_argnums=3)


def _faces(seed, b, f, res, grid=False, ties=False):
    """Random faces over the view and a little beyond, both windings, every
    fifth one degenerate (a repeated corner) and one nearly so; z on a few
    levels (``ties``: pairs whose bumped z is exactly equal); random colors
    and background. ``grid`` puts the corners on a 1/8-pixel grid."""
    rng = np.random.RandomState(seed)
    corners = rng.uniform(-8, res + 8, (b, f, 3, 2))
    if grid:
        corners = np.round(corners * 8) / 8
    corners[:, ::5, 2] = corners[:, ::5, 0]
    if f > 3:
        corners[:, 3, 2] = corners[:, 3, 0] + 1e-6 * (corners[:, 3, 1] - corners[:, 3, 0])
    corners = corners.astype(np.float32)
    z = rng.randint(0, 4, (b, f)).astype(np.float32) * 2.0 + 3.0
    if ties:
        # z_j = z_i + bump_i - bump_j, kept where float32 makes the bumped
        # values equal
        bump = np.arange(f, dtype=np.float32) * np.float32(min(1e-4, 0.09 / f))
        for i in range(0, f - 1, 2):
            z[:, i + 1] = (z[:, i] + bump[i]) - bump[i + 1]
        zb = z + bump
        assert (zb[:, 0::2][:, :(f // 2)] == zb[:, 1::2][:, :(f // 2)]).any()
    colors = rng.rand(b, f, 3).astype(np.float32)
    bg = rng.rand(b, 3, res, res).astype(np.float32)
    return corners, z, colors, bg


def _compare(corners, z, colors, bg, res, label):
    """The reference's image against the port's plain version under every
    rounding (see the module docstring); returns the count of pixels that
    hang on the rounding."""
    want = np.asarray(_jax_raster(*map(jnp.asarray, (corners, z, colors)), res,
                                  jnp.asarray(bg)))
    args = [torch.from_numpy(a) for a in (corners, z, colors)] + [res, torch.from_numpy(bg)]
    assert np.array_equal(hard.rasterize_hard(*args).numpy(),
                          hard.rasterize_hard_reference(*args).numpy())
    assert want.dtype == np.float32
    return judge_roundings(lambda: hard.rasterize_hard_reference(*args).numpy(),
                           want, label)


CASES = {
    # the packed kernel (B6a): at most 127 faces
    'F1': dict(f=1, b=2, res=32),
    'F12': dict(f=12, b=2, res=64),
    'F12_ties': dict(f=12, b=2, res=64, ties=True),
    'F127': dict(f=127, b=2, res=32),
    'F127_grid': dict(f=127, b=2, res=32, grid=True),
    # the chunked kernel (B6b)
    'F128': dict(f=128, b=2, res=32),
    'F129': dict(f=129, b=1, res=32, ties=True),
    'F300': dict(f=300, b=1, res=32),
    'F300_grid': dict(f=300, b=1, res=32, grid=True, ties=True),
}


@pytest.mark.parametrize('case', list(CASES))
def test_hard_plain_matches_jax_kernel(interpret_mode, case):
    kw = dict(CASES[case])
    res = kw['res']
    ops = _faces(sum(map(ord, case)), kw['b'], kw['f'], res,
                 grid=kw.get('grid', False), ties=kw.get('ties', False))
    ambiguous = _compare(*ops, res, case)
    if kw.get('grid'):
        assert ambiguous == 0
    assert ambiguous <= 0.01 * kw['b'] * res * res
    # the packed pack holds the rank in 7 bits: the dispatch is F <= 127
    n_ops = len(hard.hard_operands(*map(torch.from_numpy, ops[:3])))
    assert n_ops == (2 if kw['f'] <= 127 else 3)


def test_hard_on_the_untextured_town02_mesh(interpret_mode):
    """The whole uncculled Town02 road mesh (16,920 faces, 133 chunks) from
    a camera on the road, at res 32."""
    from torchdrivesim_tpu.map import find_map_config
    from torchdrivesim_tpu.mesh import set_colors_with_defaults
    from torchdrivesim_tpu.rendering.base import (
        get_default_color_map, get_default_rendering_levels)
    road = find_map_config('carla_Town02').road_mesh
    rgb = set_colors_with_defaults(road, get_default_color_map(),
                                   get_default_rendering_levels())
    verts = jnp.asarray(rgb.verts, jnp.float32)
    cam_xy = jnp.asarray([[135.85243, 234.5616]], jnp.float32)
    psi = -1.3843316
    cam_sc = jnp.asarray([[np.sin(psi), np.cos(psi)]], jnp.float32)
    rc = jax_rasterize.camera_rows_cols(verts[..., :2], cam_xy, cam_sc, 2.0 / 35.0, 32)
    sv = jnp.concatenate([rc, verts[..., 2:3]], axis=-1)
    corners, z, colors = map(np.asarray, jax_rasterize._face_arrays(
        sv, jnp.asarray(rgb.faces), jnp.asarray(rgb.attrs, jnp.float32)))
    assert corners.shape[1] > 16000
    bg = np.broadcast_to(np.asarray([0, 0, 0], np.float32)[None, :, None, None],
                         (1, 3, 32, 32)).copy()
    ambiguous = _compare(corners, z, colors, bg, 32, 'Town02 mesh')
    assert ambiguous <= 0.01 * 32 * 32


def test_cull_matches_jax_with_ties():
    """The faces kept and their order, with distance ties (faces whose
    centroids coincide, or lie at the same distance from the center) and
    degenerate faces, which sort last."""
    rng = np.random.RandomState(7)
    res, b, f, k = 32, 3, 40, 16
    corners = rng.uniform(-20, res + 20, (b, f, 3, 2)).astype(np.float32)
    # permuted copies share the centroid exactly; mirrored copies the distance
    corners[:, 10] = corners[:, 2, [1, 2, 0]]
    corners[:, 11] = corners[:, 2, [2, 0, 1]]
    corners[:, 12] = res - corners[:, 2]
    corners[:, 13] = corners[:, 4]
    corners[:, ::7, 1] = corners[:, ::7, 0]
    z = rng.rand(b, f).astype(np.float32)
    colors = rng.rand(b, f, 3).astype(np.float32)
    want = jax_rasterize.cull_faces_to_view(*map(jnp.asarray, (corners, z, colors)), res, k)
    got = cull_faces_to_view(*map(torch.from_numpy, (corners, z, colors)), res, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a set within the budget passes through
    small = cull_faces_to_view(*map(torch.from_numpy, (corners, z, colors)), res, f)
    assert small[0].shape == (b, f, 3, 2)


def test_wrappers_check_their_operands():
    corners, z, colors, bg = map(torch.from_numpy, _faces(1, 2, 12, 16))
    coef, packed = hard.hard_operands(corners, z, colors)
    before = (launches('B6a'), launches('B6b'))
    assert hard.raster_packed(coef, packed, bg, 16).shape == (2, 3, 16, 16)
    assert (launches('B6a'), launches('B6b')) == before   # no kernel
    with pytest.raises(ValueError):
        hard.raster_packed(coef, packed, bg, 32)
    with pytest.raises(ValueError):
        hard.raster_packed(coef.double(), packed, bg, 16)
    with pytest.raises(ValueError):
        hard.raster_packed(coef, packed.long(), bg, 16)
    big = [torch.from_numpy(a) for a in _faces(2, 1, 128, 16)]
    coef, zbits, rgb = hard.hard_operands(*big[:3])
    with pytest.raises(ValueError):
        hard.raster_packed(coef, zbits, big[3], 16)
    assert hard.raster_chunked(coef, zbits, rgb, big[3], 16).shape == (1, 3, 16, 16)


_STUB = r'''
#include <stdint.h>
/* the kernels' C signatures; each returns the index of the first wrong
   argument */
int tds_hard_raster_packed(const void* coef, const void* packed, const void* bg,
                           int batch, int n_faces, int res, void* out,
                           void* stream) {
  if ((uintptr_t)coef != 0x7f0000001000ull) return 1;
  if ((uintptr_t)packed != 0x7f0000001100ull) return 2;
  if ((uintptr_t)bg != 0x7f0000001200ull) return 3;
  if (batch != 1024 || n_faces != 12 || res != 64) return 4;
  if ((uintptr_t)out != 0x7f00000ff000ull) return 5;
  if ((uintptr_t)stream != 0x7ffd12345678abc0ull) return 6;
  return 0;
}
int tds_hard_raster_chunked(const void* coef, const void* zbits, const void* rgb,
                            const void* bg, int batch, int n_faces, int res,
                            void* out, void* stream) {
  if ((uintptr_t)coef != 0x7f0000001000ull) return 1;
  if ((uintptr_t)zbits != 0x7f0000001100ull) return 2;
  if ((uintptr_t)rgb != 0x7f0000001200ull) return 3;
  if ((uintptr_t)bg != 0x7f0000001300ull) return 4;
  if (batch != 16 || n_faces != 16932 || res != 64) return 5;
  if ((uintptr_t)out != 0x7f00000ff000ull) return 6;
  if ((uintptr_t)stream != 0x7ffd12345678abc0ull) return 7;
  return 0;
}
'''


def test_kernel_entry_points_receive_their_arguments(tmp_path):
    """The ctypes bindings pass every argument in place, 64-bit pointers
    (the stream) included, to stubs with the kernels' C signatures."""
    cc = shutil.which('cc')
    if cc is None:
        pytest.skip('needs a C compiler')
    src, lib = tmp_path / 'stub.c', tmp_path / 'stub.so'
    src.write_text(_STUB)
    subprocess.run([cc, '-shared', '-fPIC', '-o', str(lib), str(src)], check=True)
    stub = hard._bind(ctypes.CDLL(str(lib)))
    assert stub.tds_hard_raster_packed(0x7f0000001000, 0x7f0000001100, 0x7f0000001200,
                                       1024, 12, 64, 0x7f00000ff000,
                                       0x7ffd12345678abc0) == 0
    assert stub.tds_hard_raster_chunked(0x7f0000001000, 0x7f0000001100, 0x7f0000001200,
                                        0x7f0000001300, 16, 16932, 64, 0x7f00000ff000,
                                        0x7ffd12345678abc0) == 0
