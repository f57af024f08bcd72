"""
The fused render kernel against its plain PyTorch version on a CUDA card
(skips without one). Imports neither JAX nor the JAX package, so it also
runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from torchdrivesim_tpu_torch.ops import fused
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
