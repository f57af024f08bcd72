"""
The port's operand prep (``torchdrivesim_tpu_torch.ops.rasterize
.prep_sorted_prim_coefs``: a stable sort and a gather) against the JAX
package's ``prep_sorted_prim_coefs`` (ranks, byte-plane permutation matmul)
on the same numpy scenes: packs and masks exact, coefficients to rtol 1e-6.

The reference runs eagerly, one XLA op at a time, as written. Under ``jit``
XLA fuses its multiply-adds into FMAs, and coefficients that cancel (a
triangle's ``c`` of ~1e4 from products of ~3e4, a near-degenerate quad's
``1 / cross``) then move by an ulp of their terms; the packs and masks, and
the rendered pixels, are what the slice test compares under ``jit``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdrivesim_tpu.ops.rasterize import prep_sorted_prim_coefs as jax_prep
from torchdrivesim_tpu_torch.ops.rasterize import (
    band_rows, n_bands_for, prep_sorted_prim_coefs,
)
from torchdrivesim_tpu.ops import pallas_rasterize

torch.set_num_threads(1)

CAP = 56


def _scene(seed, b, q, t, degenerate=False, ties=True, absent=0):
    """The recipe of tests/test_prep_permutation.py, as numpy: z ties (z
    rounded to integers), rmin ties (shared top rows), degenerate quads and
    triangles, and absent agents (all-zero corners)."""
    rng = np.random.RandomState(seed)
    quads = rng.uniform(-40, 170, (b, q, 4, 2)).astype(np.float32)
    if q:
        quads[:, :, 2] = quads[:, :, 1] + quads[:, :, 3] - quads[:, :, 0]
    if degenerate and q > 2:
        quads[:, 1] = quads[:, 1, 0:1]
    tris = rng.uniform(-40, 170, (b, t, 3, 2)).astype(np.float32)
    if degenerate and t > 2:
        tris[:, 2, 2] = tris[:, 2, 0]                    # zero-area triangle
    if q > 4 and ties:
        # equal top rows: the stable sort keeps index order among them
        quads[:, 3, :, 0] += quads[:, 4, :, 0].min(-1, keepdims=True) \
            - quads[:, 3, :, 0].min(-1, keepdims=True)
    if absent:
        quads[:, -absent:] = 0.0
        tris[:, -absent:] = 0.0
    z = lambda n: (np.round(rng.uniform(0, 3, (b, n))) if ties
                   else rng.uniform(0, 3, (b, n))).astype(np.float32)
    return (quads, z(q), rng.rand(b, q, 3).astype(np.float32),
            tris, z(t), rng.rand(b, t, 3).astype(np.float32))


@pytest.mark.parametrize('q,t,res,degenerate,absent', [
    (44, 24, 128, True, 0),      # 44 quads and 24 triangles, padded to 48, 24
    (44, 24, 128, False, 5),     # absent agents' all-zero prims
    (44, 24, 64, True, 3),
    (13, 3, 96, True, 0),
])
def test_prep_matches_jax(q, t, res, degenerate, absent):
    scene = _scene(q * 31 + t + res, 3, q, t, degenerate=degenerate,
                   absent=absent)
    n_bands = n_bands_for(res)
    assert band_rows(res) == pallas_rasterize.band_rows(res)
    want = [np.asarray(x) for x in
            jax_prep(*map(jnp.asarray, scene), res, CAP, n_bands)]
    got = [x.numpy() for x in
           prep_sorted_prim_coefs(*map(torch.from_numpy, scene), res, CAP, n_bands)]
    names = ['qcoef', 'qpk', 'qmask', 'tcoef', 'tpk', 'tmask']
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.endswith('coef'):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # the scenes exercise what they claim: live prims and sentinel packs
    assert (got[1] != 0x7FFFFFFF).any() and (got[1] == 0x7FFFFFFF).any()


def test_prep_over_cap_returns_none():
    scene = _scene(7, 2, CAP + 4, 8)
    assert prep_sorted_prim_coefs(*map(torch.from_numpy, scene), 128, CAP,
                                  n_bands_for(128)) is None
