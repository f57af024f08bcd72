"""
The port's soft raster (``torchdrivesim_tpu_torch.ops.soft``) against the
JAX package's single-group Pallas kernels in interpret mode, on identical
operands: the edge coefficients, z weights and colors are built once by the
JAX package's ``_soft_coefficients`` and handed to both as numpy.

The exact value is the reference's own: the JAX package's code (the Pallas
kernel bodies in interpret mode, or its plain XLA composition) run in
float64 on the same operands. Two checks against it:

* the port's plain version in float64 equals it to 1e-9 relative (atol
  1e-12 x max|exact|): the same formula, up to float64 rounding;
* the port in float32 is no further from it than the reference in float32,
  beyond the tolerance: |port - exact| <= |reference - exact| + tol.

Tolerances for the float32 check:

* forward 1e-5 absolute: both sides add the faces in the same order, so
  they differ only by rounding (XLA's CPU code contracts some products
  into FMAs, and the two ``exp`` implementations may differ by an ulp);
* backward and the gradients through the whole composition: rtol 1e-4
  with atol 1e-6 x max|grad| per gradient, for the summation order (the
  reference sums 13 per-face terms over image rows, then over lanes; the
  plain version over all pixels at once).

The float32 check is measured from the exact value rather than from the
reference because some values are ill-conditioned in float32: a face's
clamped sigmoid tail carries a z weight of up to e^36, so the blend and its
gradient sums amplify last-ulp differences, and ``dl/dw`` cancels where one
face dominates a pixel; there the reference itself is off by more than the
tolerance. The tests print how many values differ from the reference by
more than the tolerance.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdrivesim_tpu.ops import pallas_soft as PS
from torchdrivesim_tpu_torch.ops import soft

torch.set_num_threads(1)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def float64_jax(*modules):
    """Runs the JAX package's ``modules`` in float64 (their kernel bodies,
    scratch and outputs included): x64 on, and each module's ``jnp`` read
    through :class:`_Float64Numpy`."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for module in modules:
            mp.setattr(module, 'jnp', _Float64Numpy())
        yield


def _f64(*arrays):
    return [jnp.asarray(np.asarray(a, np.float64)) for a in arrays]


def _scene(seed, b=2, n_tri=9, res=32):
    """Random screen-space triangles (row, col, z) with flat colors: random
    overlapping faces, one face covering the whole view (alpha == 1 inside
    it), one degenerate face (all corners at the origin, C = -1e9)."""
    rng = np.random.RandomState(seed)
    verts = np.concatenate([
        rng.uniform(-6, res + 6, (b, n_tri * 3, 2)),
        rng.uniform(2, 15, (b, n_tri * 3, 1)),
    ], axis=-1).astype(np.float32)
    big = np.asarray([[-3 * res, -3 * res], [5 * res, -3 * res],
                      [-3 * res, 5 * res]], np.float32)
    verts[:, 0:3, :2] = big
    verts[:, 0:3, 2] = 18.0          # low priority: the others blend over it
    for fi in range(n_tri):
        verts[:, fi * 3:(fi + 1) * 3, 2] = verts[:, fi * 3:fi * 3 + 1, 2]
    verts[:, -3:, :] = 0.0
    faces = np.tile(np.arange(n_tri * 3, dtype=np.int32).reshape(1, n_tri, 3),
                    (b, 1, 1))
    attrs = np.repeat(rng.uniform(0, 1, (b, n_tri, 1, 3)), 3, axis=2)
    attrs = attrs.reshape(b, n_tri * 3, 3).astype(np.float32)
    bg = rng.uniform(0, 1, (b, 3, res, res)).astype(np.float32)
    return verts, faces, attrs, bg


def _operands(scene, sigma=0.5, gamma=0.5):
    verts, faces, attrs, bg = scene
    coef, zw, color = PS._soft_coefficients(jnp.asarray(verts), jnp.asarray(faces),
                                            jnp.asarray(attrs), sigma, gamma)
    return np.asarray(coef), np.asarray(zw)[:, None, :], np.asarray(color), bg


def _judge(got, got64, want, exact, name, rtol=1e-4, atol=None):
    """The port in float32 (``got``) and in float64 (``got64``) against the
    reference in float32 (``want``) and its exact value (``exact``), as the
    module docstring says; atol defaults to 1e-6 x max|exact|."""
    got, got64, want, exact = (np.asarray(x, np.float64)
                               for x in (got, got64, want, exact))
    assert got.shape == want.shape == exact.shape == got64.shape, name
    scale = float(np.abs(exact).max())
    np.testing.assert_allclose(got64, exact, rtol=1e-9, atol=1e-12 * scale,
                               err_msg=f'{name}: float64 formula')
    if atol is None:
        atol = 1e-6 * scale
    tol = atol + rtol * np.abs(exact)
    apart = np.abs(got - want) > tol
    print(f'{name}: {int(apart.sum())} of {apart.size} values beyond tol of the '
          f'reference, max difference {np.abs(got - want).max():.3g}')
    assert (np.abs(got - exact) <= np.abs(want - exact) + tol).all(), name


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('seed,res', [(0, 32), (1, 64)])
def test_forward_matches_jax_kernel(seed, res):
    coef, zw, color, bg = _operands(_scene(seed, res=res))
    assert (coef[:, -1, :, 2] == -1e9).all()           # the degenerate face
    want = PS._pallas_soft_fwd(jnp.asarray(coef), jnp.asarray(zw),
                               jnp.asarray(color), jnp.asarray(bg), res=res,
                               cams=1, interpret=True)
    with float64_jax(PS):
        exact = PS._pallas_soft_fwd(*_f64(coef, zw, color, bg), res=res, cams=1,
                                    interpret=True)
    got = soft.soft_raster_fwd(*map(_t, (coef, zw, color, bg)))
    got64 = soft.soft_raster_fwd(*(_t(x).double() for x in (coef, zw, color, bg)))
    _judge(got.numpy(), got64.numpy(), want, exact, f'seed {seed} res {res} image',
           rtol=0.0, atol=1e-5)


def test_forward_covers_fully_inside():
    """Inside the covering face alpha rounds to exactly 1: no background
    shows through, which the backward must survive without dividing."""
    coef, zw, color, bg = _operands(_scene(2, n_tri=2))
    px, py = soft._pixel_grids(32, _t(coef))
    alpha = soft._face_terms(_t(coef), 0, px, py)[-1]
    assert (alpha == 1.0).any()


@pytest.mark.parametrize('seed', [0, 3])
def test_backward_matches_jax_kernel(seed):
    res = 32
    coef, zw, color, bg = _operands(_scene(seed, res=res))
    g = np.random.RandomState(99 + seed).uniform(-1, 1, bg.shape).astype(np.float32)
    want = PS._pallas_soft_bwd(*map(jnp.asarray, (coef, zw, color, bg, g)),
                               res=res, cams=1, interpret=True)
    with float64_jax(PS):
        exact = PS._pallas_soft_bwd(*_f64(coef, zw, color, bg, g), res=res,
                                    cams=1, interpret=True)
    got = soft.soft_raster_bwd(*map(_t, (coef, zw, color, bg, g)))
    got64 = soft.soft_raster_bwd(*(_t(x).double() for x in (coef, zw, color, bg, g)))
    for name, a, a64, b, e in zip(('gcoef', 'gzw', 'gcolor', 'gbg'), got, got64,
                                  want, exact):
        _judge(a.numpy(), a64.numpy(), b, e, name)


def test_gradients_through_coefficients_match_jax():
    """Autograd through the port's coefficients and Function against
    ``jax.grad`` of ``rasterize_softmax_pallas`` (interpret mode), w.r.t.
    vertices, colors and background."""
    res = 32
    verts, faces, attrs, bg = _scene(4, b=1, n_tri=6, res=res)
    weight = np.random.RandomState(7).uniform(-1, 1, (1, 3, res, res)).astype(np.float32)

    def jloss(v, a, b_):
        img = PS.rasterize_softmax_pallas(v, jnp.asarray(faces), a, res,
                                          jnp.transpose(b_, (0, 2, 3, 1)),
                                          interpret=True)
        return jnp.sum(jnp.transpose(img, (0, 3, 1, 2)) * weight)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (verts, attrs, bg)))
    with float64_jax(PS):
        exact = jax.grad(jloss, argnums=(0, 1, 2))(*_f64(verts, attrs, bg))

    def grads(dtype):
        leaves = [_t(x).to(dtype).requires_grad_(True) for x in (verts, attrs, bg)]
        img = soft.rasterize_softmax_chw(leaves[0], _t(faces), leaves[1], res,
                                         leaves[2])
        (img * _t(weight).to(dtype)).sum().backward()
        return [x.grad.numpy() for x in leaves]

    for name, a, a64, b, e in zip(('verts', 'attrs', 'background'),
                                  grads(torch.float32), grads(torch.float64),
                                  want, exact):
        assert np.isfinite(a).all(), name
        _judge(a, a64, b, e, name)


@pytest.mark.parametrize('seed', [8, 9])
def test_plain_composition_matches_jax_and_kernel_path(seed):
    """``ops.rasterize.rasterize_softmax``, the whole composition in plain
    PyTorch (channels last), against the reference's plain XLA
    ``rasterize_softmax`` and against the kernel path
    ``rasterize_softmax_chw``: the image and its gradients w.r.t. vertices,
    colors and background."""
    from torchdrivesim_tpu.ops import rasterize as jax_rasterize
    from torchdrivesim_tpu.ops.rasterize import rasterize_softmax as jax_plain
    from torchdrivesim_tpu_torch.ops.rasterize import rasterize_softmax
    res = 32
    verts, faces, attrs, bg = _scene(seed, b=1, n_tri=6, res=res)
    bg_hwc = np.ascontiguousarray(np.transpose(bg, (0, 2, 3, 1)))
    weight = np.random.RandomState(seed).uniform(-1, 1, (1, res, res, 3)).astype(np.float32)

    def jloss(v, a, b_):
        return jnp.sum(jax_plain(v, jnp.asarray(faces), a, res, b_) * weight)

    def reference(cast):
        leaves = cast(verts, attrs, bg_hwc)
        img = jax_plain(leaves[0], jnp.asarray(faces), leaves[1], res, leaves[2])
        return [img, *jax.grad(jloss, argnums=(0, 1, 2))(*leaves)]

    want = reference(lambda *a: [jnp.asarray(x) for x in a])
    with float64_jax(jax_rasterize):
        exact = reference(_f64)

    def run(fn, dtype):
        leaves = [_t(x).to(dtype).requires_grad_(True) for x in (verts, attrs, bg_hwc)]
        img = fn(leaves[0], _t(faces), leaves[1], leaves[2])
        (img * _t(weight).to(dtype)).sum().backward()
        return [img.detach().numpy()] + [x.grad.numpy() for x in leaves]

    plain = lambda v, f, a, b_: rasterize_softmax(v, f, a, res, b_)
    kernel_path = lambda v, f, a, b_: soft.rasterize_softmax_chw(
        v, f, a, res, b_.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got, got64 = run(plain, torch.float32), run(plain, torch.float64)
    names = ('image', 'verts', 'attrs', 'background')
    for name, g, g64, w, e in zip(names, got, got64, want, exact):
        _judge(g, g64, w, e, name,
               **({'rtol': 0.0, 'atol': 1e-5} if name == 'image' else {}))
    # the kernel path is the same function: in float64 the two agree to
    # rounding. (In float32 the kernel path's A*px + B*py + C form rounds
    # each edge value to ~ulp(C), more than the direct distance does; the
    # kernel-path tests above hold it to the reference's kernels.)
    for name, g, w in zip(names, run(kernel_path, torch.float64), got64):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-10 * np.abs(w).max(),
                                   err_msg=name)


def test_plain_function_gradcheck_float64():
    """The Function's hand-written backward against finite differences of
    its forward, in float64 on a tiny case (three faces, 8 x 8)."""
    res = 8
    verts, faces, attrs, bg = _scene(5, b=1, n_tri=3, res=res)
    verts[0, 3:6, :2] = [[1.0, 1.0], [6.5, 2.0], [2.0, 6.0]]
    verts[0, 6:9, :2] = [[0.5, 7.0], [5.0, 1.5], [7.5, 6.5]]
    coef, zw, color, _ = _operands((verts, faces, attrs, bg))
    inputs = tuple(_t(x).double().requires_grad_(True) for x in (coef, zw, color, bg))
    assert torch.autograd.gradcheck(soft.SoftRaster.apply, inputs, eps=1e-6,
                                    atol=1e-6, rtol=1e-4)


def test_no_faces_returns_background_and_bounds_are_checked():
    bg = torch.rand(1, 3, 16, 16)
    verts = torch.zeros(1, 0, 3)
    faces = torch.zeros(1, 0, 3, dtype=torch.int64)
    assert soft.rasterize_softmax_chw(verts, faces, torch.zeros(1, 0, 3), 16, bg) is bg
    faces = torch.zeros(1, 129, 3, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match='B5a/b'):
        soft.rasterize_softmax_chw(torch.zeros(1, 3, 3), faces,
                                   torch.zeros(1, 3, 3), 16, bg)
    coef, zw, color = torch.zeros(1, 2, 3, 3), torch.zeros(1, 1, 2), torch.zeros(1, 2, 3)
    with pytest.raises(ValueError):
        soft.soft_raster_fwd(coef, zw.double(), color, bg)
    with pytest.raises(ValueError):
        soft.soft_raster_fwd(coef, torch.zeros(1, 2), color, bg)


_STUB = r'''
#include <stdint.h>
/* the kernels' C signatures; each returns the index of the first wrong
   argument */
static int ptr(const void* p, uintptr_t want) { return (uintptr_t)p == want; }
int tds_soft_raster_fwd(const float* coef, const float* zw, const float* color,
                        const float* bg, int batch, int n_faces, int res,
                        void* out, void* stream) {
  if (!ptr(coef, 0x7f0000001000ull)) return 1;
  if (!ptr(zw, 0x7f0000001100ull)) return 2;
  if (!ptr(color, 0x7f0000001200ull)) return 3;
  if (!ptr(bg, 0x7f0000001300ull)) return 4;
  if (batch != 16 || n_faces != 24 || res != 64) return 5;
  if (!ptr(out, 0x7f00000ff000ull)) return 6;
  if (!ptr(stream, 0x7ffd12345678abc0ull)) return 7;
  return 0;
}
int tds_soft_raster_bwd(const float* coef, const float* zw, const float* color,
                        const float* bg, const float* g, int batch,
                        int n_faces, int res, void* partial, void* gbg,
                        void* stream) {
  if (!ptr(coef, 0x7f0000001000ull)) return 1;
  if (!ptr(zw, 0x7f0000001100ull)) return 2;
  if (!ptr(color, 0x7f0000001200ull)) return 3;
  if (!ptr(bg, 0x7f0000001300ull)) return 4;
  if (!ptr(g, 0x7f0000001400ull)) return 5;
  if (batch != 16 || n_faces != 128 || res != 64) return 6;
  if (!ptr(partial, 0x7f00000fe000ull)) return 7;
  if (!ptr(gbg, 0x7f00000ff000ull)) return 8;
  if (!ptr(stream, 0x7ffd12345678abc0ull)) return 9;
  return 0;
}
'''


def test_kernel_entry_points_receive_their_arguments(tmp_path):
    """The ctypes bindings pass every argument in place, 64-bit pointers
    (the stream) included, to stubs with the kernels' C signatures."""
    import ctypes
    import shutil
    import subprocess
    cc = shutil.which('cc')
    if cc is None:
        pytest.skip('needs a C compiler')
    src, lib = tmp_path / 'stub.c', tmp_path / 'stub.so'
    src.write_text(_STUB)
    subprocess.run([cc, '-shared', '-fPIC', '-o', str(lib), str(src)], check=True)
    stub = soft._bind(ctypes.CDLL(str(lib)))
    ptrs = [0x7f0000001000 + 0x100 * i for i in range(5)]
    stream = 0x7ffd12345678abc0
    assert stub.tds_soft_raster_fwd(*ptrs[:4], 16, 24, 64, 0x7f00000ff000,
                                    stream) == 0
    assert stub.tds_soft_raster_bwd(*ptrs, 16, 128, 64, 0x7f00000fe000,
                                    0x7f00000ff000, stream) == 0
