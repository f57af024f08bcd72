"""
The port's CUDA kernels against their plain PyTorch versions on a CUDA card
(skips without one): the fused render, the bilinear background warp and the
soft raster's forward and backward. Imports neither JAX nor the JAX package,
so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The fused render and the warp must match their plain versions exactly (the
same operations, each rounded on its own). The soft raster is judged
through its plain version in float64: the kernel's error may exceed the
plain version's by at most 1e-5 (forward) or 1e-4 relative plus 1e-6 of
the largest value (backward), since its per-face sums run in another order.
"""
import numpy as np
import pytest
import torch

from torchdrivesim_tpu_torch.ops import fused, soft, warp
from torchdrivesim_tpu_torch.ops.rasterize import n_bands_for, prep_sorted_prim_coefs
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


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('res,packed', [(128, False), (128, True), (64, False),
                                        (32, True), (96, False)])
def test_kernel_matches_plain_version(cuda, res, packed):
    mip, ops = _operands(res + packed, 8, res, cuda)
    before = fused.LAUNCHES
    got = fused.render_coefs_fused(mip, *ops, res, packed)
    want = fused.render_coefs_fused_reference(mip, *ops, res, packed)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    assert int((got != want).sum()) == 0


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('res,b', [(64, 16), (128, 8), (32, 4)])
def test_warp_kernel_matches_plain_version(cuda, res, b):
    mip, ops = _operands(res + 1, b, res, cuda)
    fcoef, icoef = ops[:2]
    assert (icoef[:, 0, 2] == 1).any() and (icoef[:, 0, 2] == 0).any()
    before = warp.LAUNCHES
    got = warp.warp_view_bilinear(mip.data, fcoef, icoef, res)
    want = warp.warp_view_bilinear_reference(mip.data, fcoef, icoef, res)
    torch.cuda.synchronize()
    assert warp.LAUNCHES == before + 1
    assert int((got != want).sum()) == 0


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
def test_soft_backward_is_deterministic(cuda):
    ops, g = _soft_operands(3, 4, 128, 64, cuda)
    first = soft.soft_raster_bwd(*ops, g)
    second = soft.soft_raster_bwd(*ops, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
