"""
The port's grouped soft raster (``ops/soft.py``: ``SoftAccum``, the plain
versions of kernels B5a and B5b, and the composite) against the JAX
package's grouped path, ``rasterize_softmax_pallas`` above ``MAX_FACES``
faces or above res 128, with its Pallas kernels in interpret mode:

* forward, at the reference's own grouped cases
  (``tests/test_pallas_soft.py:116-120``);
* gradients with ``MAX_FACES`` patched to 16 (and to 8 at res 80, two pixel
  bands in the reference's backward) in both packages, as
  ``tests/test_pallas_soft.py:139-150`` does: the accumulators' VJP (the
  coefficient, z-weight and color gradients) and the whole composition
  (vertex, color and background gradients);
* which path each face count and size takes, and the ctypes bindings of
  ``csrc/soft_accum.cu``.

The slice as a whole (the rollout gradient over a road mesh, a frame of the
Town02 road mesh) is in ``tests/test_torch_il_untextured.py``.

The reference's interpret-mode kernels are jitted one group at a time
(``_pallas_accum_fwd`` / ``_pallas_accum_bwd`` wrapped in ``jax.jit``; the
grouped loop and the combination run as the reference writes them): a
128-face kernel body takes ~60 s to compile on the CPU and a 16-face one
~7 s, so the forward cases run the reference with 16-face groups. The port
runs its float64 check with its own 128-face groups (a sum of non-negative
terms, which regrouping moves by float64 rounding only) and its float32
check with the reference's 16: in float32 the grouping changes the
rounding of the ill-conditioned pixels (z weights up to e^36 on clamped
sigmoid tails; at F = 136, res 96, 46 of 27,648 values moved beyond the
tolerance when the port grouped by 128).

Exactness as in ``tests/test_torch_soft.py``: the reference's code run in
float64 (``float64_jax``) is the exact value; the port in float64 must
equal it to 1e-9 relative, and in float32 be no further from it than the
reference in float32 beyond the tolerance: gradients 1e-4 relative plus
1e-6 of the largest value; the image rtol 1e-4 plus atol 2e-3, the
reference's own tolerance for its grouped forward
(``tests/test_pallas_soft.py:127-128``). The jitted reference contracts
its edge values into FMAs, the port rounds each operation, and a z weight
of up to e^36 on a clamped sigmoid tail turns that last-ulp difference
into up to ~3e-3 at an ill-conditioned pixel, where the two float32
results are both that far from the exact value (measured at F = 24, res
256: 10 of 196,608 values beyond 1e-5, the worst 0.0782 and 0.0792
against an exact 0.0816).
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

from tests.test_torch_soft import _f64, _judge, _scene, _t, float64_jax
from torchdrivesim_tpu.ops import pallas_soft as PS
from torchdrivesim_tpu_torch.ops import soft

torch.set_num_threads(1)


@pytest.fixture
def jax_grouped(monkeypatch):
    """The reference's grouped kernels in interpret mode, each group's call
    jitted; yields a setter for both packages' group size."""
    monkeypatch.setattr(PS.pl, 'pallas_call',
                        functools.partial(PS.pl.pallas_call, interpret=True))
    for name in ('_pallas_accum_fwd', '_pallas_accum_bwd'):
        monkeypatch.setattr(PS, name, jax.jit(getattr(PS, name),
                                              static_argnames=('res', 'cams',
                                                               'interpret')))

    def groups(jax_size, port_size=None):
        monkeypatch.setattr(PS, 'MAX_FACES', jax_size)
        monkeypatch.setattr(soft, 'MAX_FACES', port_size or jax_size)
    return groups


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(soft, name)

    def wrapped(*args):
        calls.append(args[0].shape[1])
        return fn(*args)
    monkeypatch.setattr(soft, name, wrapped)
    return calls


@pytest.mark.parametrize('n_tri,res,b', [(256, 32, 2), (512, 32, 1), (136, 96, 1),
                                         (24, 256, 1)])
def test_grouped_forward_matches_jax(jax_grouped, monkeypatch, n_tri, res, b):
    jax_grouped(16)
    verts, faces, attrs, bg = _scene(n_tri + res, b=b, n_tri=n_tri, res=res)
    bg_hwc = np.ascontiguousarray(np.transpose(bg, (0, 2, 3, 1)))

    def reference(*arrays):
        v, a, g = arrays
        img = PS.rasterize_softmax_pallas(v, jnp.asarray(faces), a, res, g)
        return np.transpose(np.asarray(img), (0, 3, 1, 2))

    want = reference(*map(jnp.asarray, (verts, attrs, bg_hwc)))
    with float64_jax(PS):
        exact = reference(*_f64(verts, attrs, bg_hwc))
    calls = _counting(monkeypatch, 'soft_accum_fwd_reference')
    port = lambda dt: soft.rasterize_softmax_chw(
        _t(verts).to(dt), _t(faces), _t(attrs).to(dt), res, _t(bg).to(dt)).numpy()
    got = port(torch.float32)
    monkeypatch.setattr(soft, 'MAX_FACES', 128)
    got64 = port(torch.float64)
    # both went through the grouped plain forward, in whole groups
    assert calls == [-(-n_tri // 16) * 16, -(-n_tri // 128) * 128]
    _judge(got, got64, want, exact, f'F={n_tri} res {res} image', rtol=1e-4, atol=2e-3)


def _jax_totals(coef, zw, color, res):
    """The reference's grouped loop and combination (``pallas_soft.py:
    648-657``) over faces already padded to whole groups."""
    b, n = coef.shape[:2]
    num = jnp.zeros((b, 3, res * res // 128, 128), coef.dtype)
    den = jnp.zeros((b, res * res // 128, 128), coef.dtype)
    transp = jnp.ones((b, res * res // 128, 128), coef.dtype)
    # interpret=False as rasterize_softmax_pallas passes it (the patched
    # pallas_call interprets either way): both share one jitted kernel
    for lo in range(0, n, PS.MAX_FACES):
        hi = lo + PS.MAX_FACES
        ng, dg, tg = PS._soft_accum_core(coef[:, lo:hi], zw[:, :, lo:hi],
                                         color[:, lo:hi], res, 1, False)
        num, den, transp = num + ng, den + dg, transp * tg
    return num, den, transp


@pytest.mark.parametrize('n_tri,res,group,atol', [(40, 32, 16, None), (12, 80, 8, 8e-3)])
def test_grouped_gradients_match_jax(jax_grouped, n_tri, res, group, atol):
    """The accumulators' VJP for random cotangents (coefficient, z-weight
    and color gradients), and the gradients of the whole composition with
    respect to vertices, colors and background; at res 80 the vertex
    gradients to the reference's own 8e-3 for that case
    (``tests/test_pallas_soft.py:136-142``: the per-pixel terms of the
    coefficient gradients are O(res) and cancel, so the reduction order
    costs ~eps * res * sqrt(pixels); measured here: 5 of the 36 vertex
    gradients 2.1e-3 beyond the default, at a scale of 15.2)."""
    jax_grouped(group)
    verts, faces, attrs, bg = _scene(n_tri, b=1, n_tri=n_tri, res=res)
    c, z, k = soft.soft_coefficients(_t(verts), _t(faces), _t(attrs), 0.5, 0.5)
    coef, zw, color = soft.pad_to_groups(c, z[:, None, :], k)
    rng = np.random.RandomState(res)
    cot = [rng.uniform(-1, 1, shape).astype(np.float32)
           for shape in ((1, 3, res, res), (1, res, res), (1, res, res))]

    def reference(*ops):
        _, vjp = jax.vjp(lambda *o: _jax_totals(*o, res), *ops)
        flat = [jnp.asarray(c.reshape(c.shape[:-2] + (res * res // 128, 128)),
                            ops[0].dtype) for c in cot]
        return [np.asarray(g) for g in vjp(tuple(flat))]

    want = reference(*(jnp.asarray(x.numpy()) for x in (coef, zw, color)))
    with float64_jax(PS):
        exact = reference(*_f64(coef, zw, color))
    got = soft.soft_accum_bwd_reference(coef, zw, color, *map(_t, cot))
    got64 = soft.soft_accum_bwd_reference(*(x.double() for x in (coef, zw, color)),
                                          *(_t(c).double() for c in cot))
    for name, a, a64, w, e in zip(('gcoef', 'gzw', 'gcolor'), got, got64, want, exact):
        _judge(a.numpy(), a64.numpy(), w, e, name)

    weight = np.random.RandomState(99).uniform(-1, 1, (1, 3, res, res)).astype(np.float32)

    def jloss(v, a, b_):
        img = PS.rasterize_softmax_pallas(v, jnp.asarray(faces), a, res,
                                          jnp.transpose(b_, (0, 2, 3, 1)))
        return jnp.sum(jnp.transpose(img, (0, 3, 1, 2)) * weight)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (verts, attrs, bg)))
    with float64_jax(PS):
        exact = jax.grad(jloss, argnums=(0, 1, 2))(*_f64(verts, attrs, bg))

    def grads(dtype):
        leaves = [_t(x).to(dtype).requires_grad_(True) for x in (verts, attrs, bg)]
        img = soft.rasterize_softmax_chw(leaves[0], _t(faces), leaves[1], res, leaves[2])
        (img * _t(weight).to(dtype)).sum().backward()
        return [x.grad.numpy() for x in leaves]

    for name, a, a64, w, e in zip(('verts', 'attrs', 'background'), grads(torch.float32),
                                  grads(torch.float64), want, exact):
        assert np.isfinite(a).all(), name
        _judge(a, a64, np.asarray(w), np.asarray(e), name,
               **({'atol': atol} if name == 'verts' and atol else {}))


def test_paths_taken(monkeypatch):
    """Up to 128 faces at up to 128 pixels take the single-group kernels
    (B4a/B4b); more faces or a larger view the grouped ones (B5a/B5b), the
    faces padded to whole groups."""
    single = _counting(monkeypatch, 'soft_raster_fwd')
    grouped = _counting(monkeypatch, 'soft_accum_fwd')
    for n_tri, res in ((128, 32), (129, 32), (24, 144)):
        verts, faces, attrs, bg = _scene(n_tri, b=1, n_tri=n_tri, res=res)
        soft.rasterize_softmax_chw(_t(verts), _t(faces), _t(attrs), res, _t(bg))
    assert single == [128] and grouped == [256, 128]


_STUB = r'''
#include <stdint.h>
/* the grouped kernels' C signatures; each returns the index of the first
   wrong argument */
static int ptr(const void* p, uintptr_t want) { return (uintptr_t)p == want; }
int tds_soft_accum_fwd(const float* coef, const float* zw, const float* color,
                       int batch, int n_faces, int group, int res, void* list,
                       void* counts, void* num, void* den, void* transp,
                       void* stream) {
  if (!ptr(coef, 0x7f0000001000ull)) return 1;
  if (!ptr(zw, 0x7f0000001100ull)) return 2;
  if (!ptr(color, 0x7f0000001200ull)) return 3;
  if (batch != 16 || n_faces != 17024 || group != 128 || res != 64) return 4;
  if (!ptr(list, 0x7f00000fb000ull)) return 5;
  if (!ptr(counts, 0x7f00000fc000ull)) return 6;
  if (!ptr(num, 0x7f00000fd000ull)) return 7;
  if (!ptr(den, 0x7f00000fe000ull)) return 8;
  if (!ptr(transp, 0x7f00000ff000ull)) return 9;
  if (!ptr(stream, 0x7ffd12345678abc0ull)) return 10;
  return 0;
}
int tds_soft_accum_bwd(const float* coef, const float* zw, const float* color,
                       const float* gnum, const float* gden, const float* gtransp,
                       int batch, int n_faces, int group, int res, void* list,
                       void* counts, void* scratch, void* partial, void* stream) {
  if (!ptr(coef, 0x7f0000001000ull)) return 1;
  if (!ptr(zw, 0x7f0000001100ull)) return 2;
  if (!ptr(color, 0x7f0000001200ull)) return 3;
  if (!ptr(gnum, 0x7f0000001300ull)) return 4;
  if (!ptr(gden, 0x7f0000001400ull)) return 5;
  if (!ptr(gtransp, 0x7f0000001500ull)) return 6;
  if (batch != 16 || n_faces != 17024 || group != 128 || res != 64) return 7;
  if (!ptr(list, 0x7f00000fc000ull)) return 8;
  if (!ptr(counts, 0x7f00000fd000ull)) return 9;
  if (!ptr(scratch, 0x7f00000fe000ull)) return 10;
  if (!ptr(partial, 0x7f00000ff000ull)) return 11;
  if (!ptr(stream, 0x7ffd12345678abc0ull)) return 12;
  return 0;
}
'''


def test_grouped_entry_points_receive_their_arguments(tmp_path):
    """The ctypes bindings of ``csrc/soft_accum.cu`` pass every argument in
    place, 64-bit pointers (the per-tile lists, their counts and the stream)
    included, to stubs with the kernels' C signatures."""
    cc = shutil.which('cc')
    if cc is None:
        pytest.skip('needs a C compiler')
    src, lib = tmp_path / 'stub.c', tmp_path / 'stub.so'
    src.write_text(_STUB)
    subprocess.run([cc, '-shared', '-fPIC', '-o', str(lib), str(src)], check=True)
    stub = soft._bind_accum(ctypes.CDLL(str(lib)))
    ptrs = [0x7f0000001000 + 0x100 * i for i in range(6)]
    stream = 0x7ffd12345678abc0
    assert stub.tds_soft_accum_fwd(*ptrs[:3], 16, 17024, 128, 64, 0x7f00000fb000,
                                   0x7f00000fc000, 0x7f00000fd000, 0x7f00000fe000,
                                   0x7f00000ff000, stream) == 0
    assert stub.tds_soft_accum_bwd(*ptrs, 16, 17024, 128, 64, 0x7f00000fc000,
                                   0x7f00000fd000, 0x7f00000fe000, 0x7f00000ff000,
                                   stream) == 0


@pytest.mark.parametrize('seed,b,n_faces,res', [(12, 2, 300, 32), (11, 1, 129, 48)])
def test_card_backward_check_sees_a_transp_chain_fault(monkeypatch, seed, b, n_faces, res):
    """``chip_smoke.compare_accum``, the card's check of B5a/B5b, run on the
    CPU (where the wrappers run the plain versions, so 0 values come out
    over tolerance): for the composite's cotangents and for the transp chain
    alone, a backward that sends ``gtransp`` itself to every group must
    come out over tolerance wherever it changes a value, else the check
    raises. At F = 129 the second group holds only the degenerate face, so
    the fault changes nothing there."""
    import chip_smoke
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda: None)
    monkeypatch.setattr(chip_smoke, 'cuda_ms_once', lambda fn: (fn(), 0.0))
    ops, bg = chip_smoke.accum_random_operands(seed, b, n_faces, res, 'cpu')
    (_, fwd_over), (_, bwd_over), bits, _, grads, caught = chip_smoke.compare_accum(
        soft, ops, bg, res, seed + 1, 'CPU')
    assert (fwd_over, bwd_over, bits) == (0, 0, 0)
    assert all(float(g.abs().max()) > 0 for g in grads)
    assert all(caught) == (n_faces > 129)


@pytest.mark.parametrize('kind,seed,b,n_faces,res', [
    ('random', 21, 2, 300, 40), ('random', 22, 1, 129, 64),
    ('boundary', 23, 2, 200, 64), ('boundary', 24, 1, 100, 40),
    ('road', 25, 2, 700, 48)])
def test_listed_fold_is_bit_equal_to_the_face_by_face_fold(kind, seed, b, n_faces, res):
    """The plain versions of B5a and B5b, which fold per 16 x 16 tile and
    group only the faces the plain cull lists, against the fold of every
    face over every pixel (``soft_accum_*_facewise``): the totals and, for
    the composite's cotangents and for the transp chain alone, the 13
    gradient terms of every face equal bit for bit (ragged tiles at res 40;
    boundary faces whose edge is at or beside -4 at a tile's corner; road
    faces mostly off view)."""
    import chip_smoke
    make = {'random': chip_smoke.accum_random_operands,
            'boundary': chip_smoke.accum_boundary_operands,
            'road': chip_smoke.accum_road_operands}[kind]
    ops, bg = make(seed, b, n_faces, res, 'cpu')
    keep = soft.soft_tile_lists_reference(ops[0], res)
    assert 0 < int(keep.sum()) < keep.numel()
    totals = soft.soft_accum_fwd_facewise(*ops, res)
    for name, got, want in zip(('num', 'den', 'transp'),
                               soft.soft_accum_fwd_reference(*ops, res), totals):
        assert torch.equal(got, want), name
    grads = chip_smoke.composite_cotangents(soft, totals, bg, seed)
    for cot in (grads, (torch.zeros_like(grads[0]), torch.zeros_like(grads[1]), grads[2])):
        got = soft.soft_accum_bwd_reference(*ops, *cot)
        want = soft.soft_accum_bwd_facewise(*ops, *cot)
        for name, g, w in zip(('gcoef', 'gzw', 'gcolor'), got, want):
            assert torch.equal(g, w), name
        assert float(got[0].abs().max()) > 0
