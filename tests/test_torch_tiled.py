"""
The sub-camera tiling of textured primitive views above 128 pixels
(``Renderer.render_prims_chw`` through ``fused_frame_operands``): a view of
``size`` pixels renders as n x n sub-views of ``size / n`` pixels, each
recentred on its tile and with its own prim sort, cap and band masks, in one
fused launch, and the tiles are stitched back row-major.

Held to the JAX package's tiled fused render (``jax_renderer.py``'s
``_expand_subcameras`` / ``_assemble_quadrants``) with its Pallas kernel in
interpret mode, on the synthetic scene and smooth texture of
``tests/test_render_tiled.py``: at least 99.9% of the pixels identical, as
often at the tile seams as elsewhere (a misplaced tile or a wrong sub-camera
centre moves the background by tens of texels). The sub-camera centres
equal the reference's in float32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdrivesim_tpu_torch import tracing
from torchdrivesim_tpu_torch.ops import fused
from torchdrivesim_tpu_torch.ops.grids import Grid2D
from torchdrivesim_tpu_torch.rendering import renderer as R
from torchdrivesim_tpu_torch.rendering.base import Cameras, RendererConfig
from torchdrivesim_tpu_torch.utils import Resolution


def launches(kernel: str) -> int:
    """The launches so far of the hand-written ``kernel`` (B1 ... HF)."""
    return tracing.counts().get(f'launch.{kernel}', 0)


torch.set_num_threads(1)

#: size -> (fov, tiles per side): the fov keeps the view on a mip level
CASES = {192: (60.0, 2), 144: (45.0, 3)}


def _scene(seed=0, b=2, q=24, t=10, extent=20.0):
    """``tests/test_render_tiled.py``'s scene recipe, as numpy."""
    rng = np.random.RandomState(seed)
    c0 = rng.rand(b, q, 2) * 2 * extent - extent
    e1 = rng.randn(b, q, 2) * 5
    e2 = rng.randn(b, q, 2) * 5
    f32 = lambda a: np.asarray(a, np.float32)
    quads = f32(np.stack([c0, c0 + e1, c0 + e1 + e2, c0 + e2], axis=2))
    tris = f32(rng.rand(b, t, 3, 2) * 2 * extent - extent)
    qz, tz = f32(rng.rand(b, q)), f32(rng.rand(b, t))
    qc = f32(rng.uniform(0.2, 1.0, (b, q, 3)))
    tc = f32(rng.uniform(0.2, 1.0, (b, t, 3)))
    ang = rng.rand(b) * 2 * np.pi
    cam_xy = f32(rng.rand(b, 2) * 20 - 10)
    cam_sc = f32(np.stack([np.sin(ang), np.cos(ang)], -1))
    return (quads, qz, qc, tris, tz, tc), cam_xy, cam_sc


def _texture_data():
    """``tests/test_render_tiled.py``'s smooth texture (a misplaced tile
    shows as an intensity error of ~50 there)."""
    y, x = np.mgrid[0:512, 0:512] / 512.0
    return np.stack([0.5 + 0.45 * np.sin(2 * np.pi * 2 * x),
                     0.5 + 0.45 * np.sin(2 * np.pi * 2 * y + 1.0),
                     0.5 + 0.45 * np.sin(2 * np.pi * 1.5 * (x + y))],
                    -1).astype(np.float32)


ORIGIN, CELL = np.asarray([-128.0, -128.0], np.float32), 0.5


@pytest.fixture(scope='module')
def renderers():
    """(JAX renderer on its TPU path, every pallas_call in interpret mode,
    for as long as the module's tests run; the port's renderer), both over
    the smooth texture."""
    import torchdrivesim_tpu.ops.pallas_fused as F
    import torchdrivesim_tpu.ops.pallas_rasterize as PR
    import torchdrivesim_tpu.ops.pallas_warp as W
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from torchdrivesim_tpu.ops.grids import Grid2D as JaxGrid
    from torchdrivesim_tpu.rendering.base import JaxRendererConfig
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jr, '_on_tpu', lambda: True)
        for mod in (W, PR, F):
            m.setattr(mod.pl, 'pallas_call',
                      functools.partial(mod.pl.pallas_call, interpret=True))
        jax_r = jr.JaxRenderer(JaxRendererConfig(cull_max_faces=0))
        jax_r.background_texture = JaxGrid(data=jnp.asarray(_texture_data()),
                                           origin=jnp.asarray(ORIGIN), cell_size=CELL)
        port = R.Renderer(RendererConfig(cull_max_faces=0), 'cpu')
        port.background_texture = Grid2D(data=_texture_data(), origin=ORIGIN,
                                         cell_size=CELL)
        yield jax_r, port


def _render_both(renderers, size, packed, seed=0):
    from torchdrivesim_tpu.rendering.base import Cameras as JaxCameras
    from torchdrivesim_tpu.utils import Resolution as JaxResolution
    jax_r, port = renderers
    fov, n = CASES[size]
    scene, xy, sc = _scene(seed, extent=0.35 * fov)
    assert jax_r._tiled_mip(2.0 / fov, size)[2] == n
    want = np.asarray(jax.jit(lambda *a: jax_r.render_prims_chw(
        *a[:6], JaxResolution(size, size), JaxCameras(a[6], a[7], 2.0 / fov),
        packed=packed))(*scene, xy, sc))
    before = launches('B1')
    got = port.render_prims_chw(*map(torch.from_numpy, scene), Resolution(size, size),
                                Cameras(torch.from_numpy(xy), torch.from_numpy(sc),
                                        2.0 / fov), packed=packed).numpy()
    assert launches('B1') == before          # the CPU runs the plain version
    assert got.shape == want.shape and got.dtype == want.dtype
    return got, want


@pytest.mark.parametrize('packed', [False, True], ids=['float', 'packed'])
@pytest.mark.parametrize('size', list(CASES))
def test_tiled_render_matches_jax(renderers, size, packed):
    got, want = _render_both(renderers, size, packed)
    same = (got == want).all(axis=1) if got.ndim == 4 else got == want
    print(f'res {size} packed={packed}: {int(same.sum())} of {same.size} pixels identical')
    assert same.mean() >= 0.999
    # the seams (two pixels either side of each tile boundary) agree as
    # often as the rest of the image
    n = CASES[size][1]
    edges = [k * size // n + d for k in range(1, n) for d in (-2, -1, 0, 1)]
    seams = np.concatenate([same[:, edges, :].reshape(-1), same[:, :, edges].reshape(-1)])
    assert seams.mean() >= 0.999
    flat = got.reshape(-1) if packed else got.transpose(1, 0, 2, 3).reshape(3, -1).T
    assert len(np.unique(flat, axis=0)) >= 4


@pytest.mark.parametrize('left_handed', [False, True])
@pytest.mark.parametrize('size', [144, 192, 256, 384, 512])
def test_subcamera_centers_equal_jax(size, left_handed):
    """The sub-views' prims and camera centres equal the reference's
    ``_expand_subcameras`` (run op by op) bit for bit, for every tile
    count."""
    from torchdrivesim_tpu.rendering.jax_renderer import _expand_subcameras as jax_expand
    port = R.Renderer(RendererConfig(left_handed_coordinates=left_handed), 'cpu')
    port.background_texture = Grid2D(data=_texture_data(), origin=ORIGIN, cell_size=CELL)
    fov = size / 3.2
    scale = 2.0 / fov
    _, sub, n = port._tiled_mip(scale, size)
    assert n == {144: 3, 192: 2, 256: 2, 384: 3, 512: 4}[size] and sub == size // n
    (quads, qz, qc, tris, tz, tc), xy, sc = _scene(size, extent=fov)
    xy = xy * 40 + 300                     # map-scale centres
    sq, st = port.screen_prims(torch.from_numpy(quads), torch.from_numpy(tris), size,
                               Cameras(torch.from_numpy(xy), torch.from_numpy(sc), scale))
    want = jax_expand(jnp.asarray(sq.numpy()), jnp.asarray(st.numpy()), qz, qc, tz, tc,
                      jnp.asarray(xy), jnp.asarray(sc), size, sub, scale,
                      left_handed, n=n)
    offs, off_fl = port.subcamera_offsets(size, sub, scale, n)
    got = R._expand_subcameras(sq, st, *map(torch.from_numpy, (qz, qc, tz, tc, xy, sc)),
                               offs, off_fl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tiles_are_their_subcamera_views():
    """Each tile of a res-256 render equals the 128-pixel render of its
    sub-camera (centre shifted by the rotated tile offset, same pixels per
    meter), in float and packed output; the tiled frame is one launch's
    worth of sub-views."""
    port = R.Renderer(RendererConfig(left_handed_coordinates=True), 'cpu')
    port.background_texture = Grid2D(data=_texture_data(), origin=ORIGIN, cell_size=CELL)
    size, fov = 256, 80.0
    scene, xy, sc = _scene(7, extent=28.0)
    scene = [torch.from_numpy(a) for a in scene]
    cams = Cameras(torch.from_numpy(xy), torch.from_numpy(sc), 2.0 / fov)
    mip, ops, sub, n, _ = port.fused_frame_operands(*scene, size, cams)
    assert (sub, n) == (128, 2) and ops[0].shape[0] == 2 * 4
    for packed in (False, True):
        image = port.render_prims_chw(*scene, Resolution(size, size), cams, packed=packed)
        offs, off_fl = port.subcamera_offsets(size, sub, cams.scale, n)
        sq, st = port.screen_prims(scene[0], scene[3], size, cams)
        sub_xy = R._expand_subcameras(sq, st, *scene[1:3], *scene[4:6], cams.xy, cams.sc,
                                      offs, off_fl)[6]
        for k in range(n * n):
            i, j = divmod(k, n)
            view = port.render_prims_chw(
                *scene, Resolution(sub, sub),
                Cameras(sub_xy[k::n * n], cams.sc, cams.scale * size / sub), packed=packed)
            tile = image[..., i * sub:(i + 1) * sub, j * sub:(j + 1) * sub]
            same = float((tile == view).float().mean())
            assert same >= 0.999, (packed, k, same)


def test_camera_limit_counts_subviews():
    """B1's 65,535 cameras a launch count the sub-views: past it the render
    raises rather than splitting the batch."""
    port = R.Renderer(RendererConfig(), 'cpu')
    port.background_texture = Grid2D(data=_texture_data(), origin=ORIGIN, cell_size=CELL)
    b = fused.MAX_CAMERAS // 4 + 1
    quads = torch.zeros((b, 1, 4, 2))
    tris = torch.zeros((b, 1, 3, 2))
    z, c = torch.zeros((b, 1)), torch.zeros((b, 1, 3))
    cams = Cameras(torch.zeros((b, 2)), torch.tensor([[0.0, 1.0]]).expand(b, 2), 2.0 / 80.0)
    with pytest.raises(ValueError, match='sub-views'):
        port.render_prims_chw(quads, z, c, tris, z, c, Resolution(256, 256), cams)
