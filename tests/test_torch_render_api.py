"""
The rest of the render API on the CPU, against the JAX package on inputs
made with numpy from a seed:

* ``rendering.renderer_from_config`` over the reference's matrix of
  configurations and dicts: the renderer class (the port's ``Renderer``
  where the reference builds a ``JaxRenderer``) and every field of the
  lifted configuration; the renderer class shims; a ``Simulator`` built
  from each (a ``DummyRendererConfig`` one stepping and rendering black
  frames, the reference shims and ``{'backend': 'jax'}`` rendering the
  default's images bit for bit); ``use_pallas=False`` giving the same image;
* ``ops.grids.bilinear_sample``, ``ops.rasterize.sample_background``,
  ``pack_texture_rgb8_quad`` and ``sample_background_quad``: values to 1e-5
  and pose gradients to 1e-4 of the largest (relative);
* the painter's blend ``rasterize_soft``: values to 1e-5, vertex gradients
  to 1e-4 of the largest;
* ``Renderer.render_rgb_mesh_chw``: with ``diff_fast_background=False``
  and textured differentiable at res 256 (both over the full-resolution
  bilinear sample, against the reference's CPU path, which takes
  ``sample_background_quad`` under its plain softmax raster), with an
  explicit ``background_texture=`` (soft, and hard against the
  reference's TPU path: ``_on_tpu`` patched, ``pallas_call`` in interpret
  mode), and with ``soft_blend='painter'``: values and pose and vertex
  gradients;
* teacher-forced behaviour cloning: the loss and the policy gradients
  against ``jax.grad`` of the reference example's loss with
  ``teacher_forcing=True``, and the example's first losses;
* the traffic-light methods (``from_json``, ``duration``, ``set_to``,
  ``state_per_machine``, ``time_remaining``, ...) against the reference's.
"""
import dataclasses
import functools
import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdrivesim_tpu.rendering as JR
import torchdrivesim_tpu_torch.rendering as PR
from torchdrivesim_tpu.ops import rasterize as jrast
from torchdrivesim_tpu.ops.grids import Grid2D as JaxGrid, bilinear_sample as jax_bilinear
from torchdrivesim_tpu_torch.ops import rasterize as prast
from torchdrivesim_tpu_torch.ops.grids import Grid2D, bilinear_sample
from torchdrivesim_tpu_torch.utils import Resolution

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BG = np.asarray([0.1, 0.2, 0.3], np.float32)

# --- renderer_from_config ------------------------------------------------------

#: (name, reference configuration, the port's); dicts are shared
CONFIGS = {
    'cv2': (JR.CV2RendererConfig(), PR.CV2RendererConfig()),
    'nvdiffrast': (JR.NvdiffrastRendererConfig(antialias=True),
                   PR.NvdiffrastRendererConfig(antialias=True)),
    'pytorch3d': (JR.Pytorch3DRendererConfig(), PR.Pytorch3DRendererConfig()),
    'pytorch3d_hard': (JR.Pytorch3DRendererConfig(differentiable_rendering='hard'),
                       PR.Pytorch3DRendererConfig(differentiable_rendering='hard')),
    'pytorch3d_sigmoid': (JR.Pytorch3DRendererConfig(differentiable_rendering='sigmoid'),
                          PR.Pytorch3DRendererConfig(differentiable_rendering='sigmoid')),
    'pytorch3d_blend_enum': (
        JR.Pytorch3DRendererConfig(differentiable_rendering=JR.RenderingBlend.soft),
        PR.Pytorch3DRendererConfig(differentiable_rendering=PR.RenderingBlend.soft)),
    'dummy': (JR.DummyRendererConfig(), PR.DummyRendererConfig()),
    'jax_fields': (JR.JaxRendererConfig(differentiable=True, soft_blend='painter',
                                        cull_max_faces=32, left_handed_coordinates=True),
                   PR.JaxRendererConfig(differentiable=True, soft_blend='painter',
                                        cull_max_faces=32, left_handed_coordinates=True)),
    'base_lifted': (JR.RendererConfig(render_agent_direction=False,
                                      left_handed_coordinates=True),
                    PR.BirdviewRendererConfig(render_agent_direction=False,
                                              left_handed_coordinates=True)),
    'dict_cv2': ({'backend': 'cv2'},) * 2,
    'dict_dummy': ({'backend': 'dummy'},) * 2,
    'dict_jax_differentiable': ({'backend': 'jax', 'differentiable': True},) * 2,
    'dict_pytorch3d': ({'backend': 'pytorch3d', 'soft_sigma': 0.25},) * 2,
    'dict_unknown_backend': ({'backend': 'opengl', 'band_budget': 40},) * 2,
    'dict_no_backend': ({'cull_max_faces': 0, 'not_a_field': 1},) * 2,
}
CLASS_NAMES = {'JaxRenderer': 'Renderer', 'DummyRenderer': 'DummyRenderer'}


@pytest.mark.parametrize('name', list(CONFIGS))
def test_renderer_from_config_matches_jax(name):
    jcfg, pcfg = CONFIGS[name]
    want = JR.renderer_from_config(dict(jcfg) if isinstance(jcfg, dict) else jcfg)
    got = PR.renderer_from_config(dict(pcfg) if isinstance(pcfg, dict) else pcfg,
                                  device='cpu')
    assert type(got).__name__ == CLASS_NAMES[type(want).__name__]
    assert type(got.cfg).__name__ == {'JaxRendererConfig': 'RendererConfig'}.get(
        type(want.cfg).__name__, type(want.cfg).__name__)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert got.device == torch.device('cpu')


def test_config_classes_have_the_reference_fields():
    for name in ('DummyRendererConfig', 'CV2RendererConfig', 'Pytorch3DRendererConfig',
                 'NvdiffrastRendererConfig', 'JaxRendererConfig'):
        want, got = getattr(JR, name)(), getattr(PR, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert list(PR.RendererConfig.__dataclass_fields__) == \
        list(JR.JaxRendererConfig.__dataclass_fields__)
    assert PR.JaxRendererConfig is PR.RendererConfig


def test_factory_passes_view_and_device():
    colors = dict(PR.get_default_color_map(), background=(10, 20, 30))
    levels = dict(PR.get_default_rendering_levels(), vehicle=1)
    r = PR.renderer_from_config(PR.RendererConfig(device='cpu'), res=Resolution(48, 48),
                                fov=20.0, color_map=colors, rendering_levels=levels)
    assert r.device == torch.device('cpu') and r.res == Resolution(48, 48)
    assert r.scale == 2.0 / 20.0 and r.get_color('background') == (10, 20, 30)
    assert r.rendering_levels['vehicle'] == 1
    np.testing.assert_allclose(r._background_color.numpy(), np.asarray([10, 20, 30]) / 255)
    d = PR.renderer_from_config({'backend': 'dummy', 'device': 'cpu'}, res=Resolution(8, 8))
    assert isinstance(d, PR.DummyRenderer) and d.res == Resolution(8, 8)


def test_renderer_class_shims():
    for cls in (PR.CV2Renderer, PR.Pytorch3DRenderer, PR.NvdiffrastRenderer):
        assert issubclass(cls, PR.Renderer)
        r = cls(PR.JaxRendererConfig(), 'cpu')
        assert hasattr(r, 'render_frame') and hasattr(r, 'render_prims_chw')
    assert PR.JaxRenderer is PR.Renderer
    assert PR.RenderingBlend('soft') is PR.RenderingBlend.soft
    assert [b.value for b in PR.RenderingBlend] == [b.value for b in JR.RenderingBlend]
    assert issubclass(PR.Pytorch3DNotFound, ImportError)
    assert issubclass(PR.NvdiffrastNotFound, ImportError)


def _port_mesh(seed, b, f, span, device='cpu'):
    """A random RGB mesh of ``f`` triangles around the origin, z on the
    renderer's levels, in both packages' mesh classes."""
    from torchdrivesim_tpu.mesh import RGBMesh as JaxMesh
    from torchdrivesim_tpu_torch.mesh import RGBMesh
    rng = np.random.RandomState(seed)
    center = rng.uniform(-span, span, (b, f, 1, 2))
    verts = (center + rng.uniform(-0.2, 0.2, (b, f, 3, 2)) * span).reshape(b, 3 * f, 2)
    z = np.repeat(rng.choice([2.0, 3.0, 4.0, 11.0], (b, f)), 3, axis=1)[..., None]
    verts = np.concatenate([verts, z], -1).astype(np.float32)
    faces = np.arange(3 * f, dtype=np.int32).reshape(1, f, 3).repeat(b, 0)
    attrs = np.repeat(rng.rand(b, f, 3), 3, axis=1).astype(np.float32)
    return (JaxMesh(verts=jnp.asarray(verts), faces=jnp.asarray(faces),
                    attrs=jnp.asarray(attrs)),
            RGBMesh(torch.from_numpy(verts).to(device), torch.from_numpy(faces).long().to(device),
                    torch.from_numpy(attrs).to(device)))


def _texture(seed, h=48, w=64, cell=0.5, origin=(-16.0, -12.0)):
    """An RGB8-representable texture in both packages' grids."""
    data = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.float32) / 255
    origin = np.asarray(origin, np.float32)
    return (JaxGrid(data=jnp.asarray(data), origin=jnp.asarray(origin), cell_size=cell),
            Grid2D(data=data, origin=origin, cell_size=cell))


def _poses(seed, b, spread=6.0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-spread, spread, (b, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, b)
    return xy, np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)


@pytest.mark.parametrize('textured', [False, True])
@pytest.mark.parametrize('differentiable', [False, True])
def test_use_pallas_false_gives_the_same_image(textured, differentiable):
    _, mesh = _port_mesh(0, 2, 20, 8.0)
    xy, sc = _poses(1, 2)
    images = []
    for use_pallas in (True, False):
        r = PR.Renderer(PR.RendererConfig(use_pallas=use_pallas,
                                          differentiable=differentiable), 'cpu')
        if textured:
            r.background_texture = _texture(2)[1]
        images.append(r.render_frame(mesh, torch.from_numpy(xy), torch.from_numpy(sc),
                                     res=Resolution(32, 32), fov=20.0))
    torch.testing.assert_close(images[0], images[1], rtol=0, atol=0)
    assert float(images[0].std()) > 0


def test_dummy_renderer_frames():
    r = PR.DummyRenderer(PR.DummyRendererConfig(), 'cpu', res=Resolution(24, 24))
    _, mesh = _port_mesh(0, 3, 4, 5.0)
    frames = r.render_frame(mesh, torch.zeros(3, 2), torch.tensor([[0.0, 1.0]] * 3))
    assert frames.shape == (3, 3, 24, 24) and not frames.any()
    assert r.render_rgb_mesh(mesh, Resolution(8, 8), PR.Cameras(
        torch.zeros(3, 2), torch.zeros(3, 2), 0.1)).shape == (3, 8, 8, 3)


def _sim(renderer_cfg):
    """The shared facade world of ``tests/test_torch_simulator.py`` with
    ``cfg.renderer`` replaced, on the CPU."""
    from tests.test_torch_simulator import port_simulator, world_arrays
    return port_simulator(world_arrays(), renderer_config=renderer_cfg)


def test_simulators_from_reference_configs():
    """The primitive route from each shim (the mesh route of a shim is
    the default's ``Renderer.render_frame``)."""
    from tests.test_torch_simulator import A, B, FOV, RES
    want = _sim(PR.RendererConfig()).render_egocentric(fov=FOV)
    for cfg in (PR.CV2RendererConfig(), {'backend': 'jax'}):
        sim = _sim(cfg)
        assert type(sim.renderer) is PR.Renderer and not sim.renderer.cfg.differentiable
        torch.testing.assert_close(sim.render_egocentric(fov=FOV), want, rtol=0, atol=0)
    sim = _sim(PR.Pytorch3DRendererConfig())
    assert sim.renderer.cfg.differentiable
    image = sim.render_egocentric(fov=FOV)
    assert image.shape == (B, A, 3, RES, RES) and torch.isfinite(image).all()


def test_builders_leave_the_callers_renderer_config_alone():
    """``build_benchmark_scenario`` sets its background downsample on a
    lifted copy, and ``Simulator`` its handedness on a copy of a dict."""
    from torchdrivesim_tpu_torch.benchmark import build_benchmark_scenario
    cfg = PR.RendererConfig()
    scenario = build_benchmark_scenario(batch_size=1, agent_count=1, use_texture=False,
                                        renderer_config=cfg, device='cpu')
    assert cfg.background_downsample == 1
    assert scenario.sim.renderer.cfg.background_downsample == 2
    shim = build_benchmark_scenario(batch_size=1, agent_count=1, use_texture=False,
                                    renderer_config=PR.Pytorch3DRendererConfig(),
                                    device='cpu').sim.renderer.cfg
    assert shim.differentiable and shim.background_downsample == 2
    d = {'backend': 'jax', 'left_handed_coordinates': True}
    sim = _sim(d)
    assert d == {'backend': 'jax', 'left_handed_coordinates': True}
    assert sim.renderer.cfg.left_handed_coordinates == sim.cfg.left_handed_coordinates


@pytest.mark.parametrize('cfg', [PR.DummyRendererConfig(), {'backend': 'dummy'}],
                         ids=['config', 'dict'])
def test_dummy_simulator_steps_and_renders_black(cfg):
    from tests.test_torch_simulator import A, B, FOV, RES
    sim = _sim(cfg)
    assert isinstance(sim.renderer, PR.DummyRenderer)
    before = sim.get_state().clone()
    for _ in range(2):
        frames = sim.render_egocentric(fov=FOV)
        assert frames.shape == (B, A, 3, RES, RES) and not frames.any()
        sim.step(torch.full((B, A, 2), 0.1))
    assert not torch.equal(sim.get_state(), before)
    frames = sim.render(sim.get_state()[:, :2, :2], sim.get_state()[:, :2, 2:3],
                        res=Resolution(16, 16), custom_agent_colors=torch.rand(B, 2, A + 1, 3))
    assert frames.shape == (B, 2, 3, 16, 16) and not frames.any()
    assert isinstance(sim.copy().renderer, PR.DummyRenderer)


# --- the background samplers ---------------------------------------------------

def _pose_grads(fn, xy, sc):
    """fn(xy, sc) on tensors that need gradients: (value, d/dxy, d/dsc)."""
    txy = torch.from_numpy(xy).requires_grad_()
    tsc = torch.from_numpy(sc).requires_grad_()
    out = fn(txy, tsc)
    weights = torch.linspace(0, 1, out.numel()).reshape(out.shape)
    gxy, gsc = torch.autograd.grad((out * weights).sum(), (txy, tsc))
    return out.detach().numpy(), gxy.numpy(), gsc.numpy()


def _jax_pose_grads(fn, xy, sc):
    def loss(a, b):
        out = fn(a, b)
        return jnp.sum(out * jnp.linspace(0, 1, out.size).reshape(out.shape))
    out = fn(jnp.asarray(xy), jnp.asarray(sc))
    gxy, gsc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xy), jnp.asarray(sc))
    return np.asarray(out), np.asarray(gxy), np.asarray(gsc)


def _close_grads(got, want, rtol=1e-4):
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        assert scale > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale)


SAMPLER_CASES = {
    'inside': dict(seed=3, b=3, res=32, fov=8.0, spread=4.0),
    'past_the_edge': dict(seed=4, b=4, res=24, fov=30.0, spread=14.0),
    'left_handed': dict(seed=5, b=2, res=16, fov=12.0, spread=6.0, left_handed=True),
}


@pytest.mark.parametrize('case', list(SAMPLER_CASES))
def test_bilinear_sample_matches_jax(case):
    kw = SAMPLER_CASES[case]
    jtex, tex = _texture(kw['seed'])
    pts = np.random.RandomState(kw['seed']).uniform(-20, 20, (kw['b'], 50, 2)
                                                    ).astype(np.float32)
    want = np.asarray(jax_bilinear(jtex, jnp.asarray(pts), fill_value=-1.0))
    t = torch.from_numpy(pts).requires_grad_()
    got = bilinear_sample(tex, t, fill_value=-1.0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    assert (want == -1).any() and (want >= 0).any()
    (g,) = torch.autograd.grad(got.sum(), t)
    jg = np.asarray(jax.grad(lambda p: jnp.sum(jax_bilinear(jtex, p, fill_value=-1.0)))(
        jnp.asarray(pts)))
    _close_grads([g.numpy()], [jg])


@pytest.mark.parametrize('case', list(SAMPLER_CASES))
def test_sample_background_matches_jax(case):
    kw = SAMPLER_CASES[case]
    lh = kw.get('left_handed', False)
    jtex, tex = _texture(kw['seed'])
    xy, sc = _poses(kw['seed'], kw['b'], kw['spread'])
    scale, res = 2.0 / kw['fov'], kw['res']
    want = _jax_pose_grads(lambda a, b: jnp.transpose(jrast.sample_background(
        jtex, a, b, scale, res, jnp.asarray(BG), left_handed=lh), (0, 3, 1, 2)), xy, sc)
    got = _pose_grads(lambda a, b: prast.sample_background(
        tex, a, b, scale, res, torch.from_numpy(BG), left_handed=lh), xy, sc)
    assert got[0].shape == (kw['b'], 3, res, res)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    _close_grads(got[1:], want[1:])


def test_pack_texture_rgb8_quad_matches_jax():
    jtex, tex = _texture(6, h=20, w=30)
    want = np.asarray(jrast.pack_texture_rgb8_quad(jtex).data)
    got = prast.pack_texture_rgb8_quad(tex.data)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('case', list(SAMPLER_CASES))
def test_sample_background_quad_matches_jax(case):
    kw = SAMPLER_CASES[case]
    lh = kw.get('left_handed', False)
    jtex, tex = _texture(kw['seed'])
    jquad = jrast.pack_texture_rgb8_quad(jtex)
    quad = torch.from_numpy(prast.pack_texture_rgb8_quad(tex.data))
    xy, sc = _poses(kw['seed'], kw['b'], kw['spread'])
    scale, res = 2.0 / kw['fov'], kw['res']
    want = _jax_pose_grads(lambda a, b: jnp.transpose(jrast.sample_background_quad(
        jquad, a, b, scale, res, jnp.asarray(BG), left_handed=lh), (0, 3, 1, 2)), xy, sc)
    got = _pose_grads(lambda a, b: prast.sample_background_quad(
        quad, tex.origin, tex.cell_size, a, b, scale, res, torch.from_numpy(BG),
        left_handed=lh), xy, sc)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    _close_grads(got[1:], want[1:])
    if case == 'past_the_edge':
        off = (got[0] == BG[None, :, None, None]).all(axis=1)
        assert off.any() and not off.all()


# --- the painter's blend -------------------------------------------------------

def _screen_scene(seed, b, f, res):
    """Random screen-space faces (row, col, z): ties in z, both windings,
    a degenerate face, faces past the view's edge."""
    rng = np.random.RandomState(seed)
    center = rng.uniform(0, res, (b, f, 1, 2))
    corners = center + rng.uniform(-0.35, 0.35, (b, f, 3, 2)) * res
    corners[:, 0, 2] = corners[:, 0, 0]
    z = np.repeat(rng.choice([2.0, 4.0, 11.0], (b, f)), 3, axis=1)[..., None]
    verts = np.concatenate([corners.reshape(b, 3 * f, 2), z], -1).astype(np.float32)
    faces = np.arange(3 * f, dtype=np.int32).reshape(1, f, 3).repeat(b, 0)
    attrs = rng.rand(b, 3 * f, 3).astype(np.float32)
    bg = rng.rand(b, res, res, 3).astype(np.float32)
    return verts, faces, attrs, bg


@pytest.mark.parametrize('seed,b,f,res,sigma', [(0, 2, 7, 16, 0.5), (1, 1, 24, 32, 0.5),
                                                (2, 2, 20, 24, 1.5)])
def test_rasterize_soft_matches_jax(seed, b, f, res, sigma):
    verts, faces, attrs, bg = _screen_scene(seed, b, f, res)
    w = np.random.RandomState(seed + 10).rand(b, res, res, 3).astype(np.float32)

    def jloss(v):
        return jnp.sum(jnp.asarray(w) * jrast.rasterize_soft(
            v, jnp.asarray(faces), jnp.asarray(attrs), res, jnp.asarray(bg), sigma=sigma))
    want = np.asarray(jrast.rasterize_soft(jnp.asarray(verts), jnp.asarray(faces),
                                           jnp.asarray(attrs), res, jnp.asarray(bg),
                                           sigma=sigma))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(verts)))
    tv = torch.from_numpy(verts).requires_grad_()
    got = prast.rasterize_soft(tv, torch.from_numpy(faces), torch.from_numpy(attrs), res,
                               torch.from_numpy(bg), sigma=sigma)
    (g,) = torch.autograd.grad((torch.from_numpy(w) * got).sum(), tv)
    assert got.shape == (b, res, res, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    assert float(np.abs(want - bg).max()) > 0.1
    _close_grads([g.numpy()[..., :2]], [jgrad[..., :2]])


# --- the mesh render's backgrounds and blends -----------------------------------

def _renderers(tpu=False, **cfg):
    """(JAX renderer, port renderer), both with the same texture; the JAX
    one on its CPU path (``tpu`` False) or its TPU path (``_on_tpu``
    patched while it is built and used)."""
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    jtex, tex = _texture(8, h=96, w=112, cell=0.25, origin=(-14.0, -12.0))
    jren = jr.JaxRenderer(JR.JaxRendererConfig(**cfg), background_texture=jtex)
    pren = PR.Renderer(PR.RendererConfig(**cfg), 'cpu')
    pren.background_texture = tex
    return jren, pren, (jtex, tex)


def _render_both(jren, pren, mesh_seed, b, f, res, fov, textures=None, grads=False):
    """Both renderers' images (and, with ``grads``, the gradients of a
    weighted sum with respect to the mesh vertices, the camera centers and
    headings); without ``grads`` also the port's render as a function."""
    from torchdrivesim_tpu.rendering.base import Cameras as JCams
    jmesh, pmesh = _port_mesh(mesh_seed, b, f, 0.3 * fov)
    xy, sc = _poses(mesh_seed + 1, b, 0.1 * fov)
    w = np.random.RandomState(mesh_seed + 2).rand(b, 3, res, res).astype(np.float32)
    jt, pt = textures if textures is not None else (None, None)

    def jrender(v, a, s):
        return jren.render_rgb_mesh_chw(dataclasses.replace(jmesh, verts=v),
                                        Resolution(res, res), JCams(a, s, 2.0 / fov),
                                        background_texture=jt)
    args = (jmesh.verts, jnp.asarray(xy), jnp.asarray(sc))
    want = np.asarray(jrender(*args))
    tv, txy, tsc = (torch.from_numpy(np.asarray(x)).requires_grad_(grads) for x in args)
    from torchdrivesim_tpu_torch.mesh import RGBMesh

    def prender():
        return pren.render_rgb_mesh_chw(RGBMesh(tv, pmesh.faces, pmesh.attrs),
                                        Resolution(res, res), PR.Cameras(txy, tsc, 2.0 / fov),
                                        background_texture=pt)
    got = prender()
    if not grads:
        return got.detach().numpy(), want, lambda: prender().numpy()
    jg = jax.grad(lambda *x: jnp.sum(jnp.asarray(w) * jrender(*x)), argnums=(0, 1, 2))(*args)
    pg = torch.autograd.grad((torch.from_numpy(w) * got).sum(), (tv, txy, tsc))
    return got.detach().numpy(), want, [g.numpy() for g in pg], [np.asarray(g) for g in jg]


#: the differentiable renders against the reference's CPU path, which is the
#: port's semantics there: the full-resolution bilinear background of
#: sample_background_quad under the plain softmax raster (rasterize_softmax)
DIFF_CASES = {
    'diff_fast_background_off_res64': dict(res=64, fov=24.0, b=1, f=24,
                                           cfg=dict(diff_fast_background=False)),
    'textured_res256': dict(res=256, fov=24.0, b=1, f=24, cfg={}),
    'painter_res32': dict(res=32, fov=16.0, b=2, f=24,
                          cfg=dict(soft_blend='painter', diff_fast_background=False)),
    'painter_untextured_res32': dict(res=32, fov=16.0, b=2, f=24, textured=False,
                                     cfg=dict(soft_blend='painter')),
}


@pytest.mark.parametrize('case', list(DIFF_CASES))
def test_differentiable_render_backgrounds_match_jax(case):
    kw = DIFF_CASES[case]
    jren, pren, _ = _renderers(differentiable=True, **kw['cfg'])
    if not kw.get('textured', True):
        jren.background_texture = None
        pren.background_texture = None
    got, want, pg, jg = _render_both(jren, pren, 20, kw['b'], kw['f'], kw['res'], kw['fov'],
                                     grads=True)
    assert got.shape == want.shape == (kw['b'], 3, kw['res'], kw['res'])
    # the image in [0, 255]: 1e-5 of the range; above 128 pixels the port
    # sums the faces by groups (B5a's plain version), whose float32 sums of
    # z-weighted sigmoid tails land a few ulp of 1 apart (the JAX package
    # holds its own grouped path to 2e-3)
    atol = 1e-4 if kw['res'] > 128 else 1e-5
    np.testing.assert_allclose(got / 255, want / 255, rtol=0, atol=atol)
    _close_grads(pg, jg, rtol=1e-3)


@pytest.mark.parametrize('differentiable', [False, True])
def test_explicit_background_texture_matches_jax(differentiable):
    import torchdrivesim_tpu.ops.pallas_rasterize as R
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from tests.test_torch_warp_nearest import judge_roundings
    with pytest.MonkeyPatch.context() as m:
        if not differentiable:
            # the reference's hard render on its TPU path (the CPU path's
            # plain raster has other semantics): B6a over the sample
            m.setattr(jr, '_on_tpu', lambda: True)
            m.setattr(R.pl, 'pallas_call',
                      functools.partial(R.pl.pallas_call, interpret=True))
        jren, pren, _ = _renderers(differentiable=differentiable)
        textures = _texture(9, h=40, w=56, cell=0.5, origin=(-15.0, -10.0))
        if differentiable:
            got, want, pg, jg = _render_both(jren, pren, 30, 2, 24, 48, 24.0, textures,
                                             grads=True)
            np.testing.assert_allclose(got / 255, want / 255, rtol=0, atol=1e-5)
            _close_grads(pg, jg, rtol=1e-3)
        else:
            _, want, render = _render_both(jren, pren, 30, 2, 90, 48, 24.0, textures)
            assert judge_roundings(render, want, 'explicit texture') == 0
    # the explicit texture replaced the renderer's own
    own = pren.render_rgb_mesh_chw(_port_mesh(30, 2, 90, 7.2)[1], Resolution(48, 48),
                                   PR.Cameras(torch.zeros(2, 2), torch.tensor([[0., 1.]] * 2),
                                              2.0 / 24))
    assert not np.array_equal(own.detach().numpy(), want)


# --- teacher forcing -------------------------------------------------------------

def _jax_example():
    sys.path.insert(0, os.path.join(ROOT, 'examples'))
    try:
        import imitation_learning
    finally:
        sys.path.pop(0)
    return imitation_learning


def test_teacher_forced_bc_matches_jax():
    """The port's teacher-forced BC loss and its policy gradients against
    ``jax.grad`` of the reference example's loss (its ``loss_fn`` body with
    ``teacher_forcing=True``) on the synthetic road at res 32, then the
    example's first three training steps."""
    import optax
    import torchdrivesim_tpu.kinematic as JK
    from tests.test_torch_il import _flax_policy, _port_policy
    from torchdrivesim_tpu.rendering.base import Cameras as JCams
    from torchdrivesim_tpu.simulator import Simulator as JSim, TorchDriveConfig as JConfig
    from torchdrivesim_tpu_torch.imitation import (
        build_synthetic_batch, build_synthetic_simulator, make_bc_loss_fn,
        make_bc_train_step, make_optimizer)
    batch, horizon, res = 3, 4, 32
    road, states0, expert = build_synthetic_batch(batch, horizon, device='cpu')
    # an expert that the policy cannot match from its own states alone
    expert = expert + torch.tensor([0.0, 0.5, 0.0, 0.0])
    sim = build_synthetic_simulator(road, states0, res=res)
    fpolicy, params = _flax_policy(4, (4, 8), res)
    policy = _port_policy(4, (4, 8), params)
    loss = make_bc_loss_fn(sim, policy, res, teacher_forcing=True)(sim.state, expert)
    grads = torch.autograd.grad(loss, list(policy.parameters()))
    free = make_bc_loss_fn(sim, policy, res)(sim.state, expert)

    ex = _jax_example()
    jroad, jstates0, _ = ex.build_synthetic_batch(batch, horizon)
    jexpert = jnp.asarray(expert.numpy())
    kin = JK.SimpleKinematicModel(dt=0.1)
    kin.set_state(jstates0)
    cfg = JConfig()
    cfg.renderer = JR.JaxRendererConfig(differentiable=True)
    jsim = JSim(road_mesh=jroad, kinematic_model=kin,
                agent_size=jnp.tile(jnp.asarray([[[4.6, 2.0]]]), (batch, 1, 1)),
                initial_present_mask=jnp.ones((batch, 1), dtype=bool), cfg=cfg)
    jsim.renderer.res = Resolution(res, res)
    jsim.renderer.scale = 2.0 / 35

    def jloss(p):
        # examples/imitation_learning.py:make_bc_train_step's loss_fn body
        def body(state, target):
            all_state = jnp.concatenate([state.agent_state, state.npc_state], -2)
            present = jnp.concatenate([state.present_mask, state.npc_present_mask], -1)
            mesh = jsim.birdview_mesh_generator.generate(
                1, agent_state=all_state[:, None], present_mask=present[:, None],
                include_background=True)
            ego = state.agent_state[:, 0]
            image = jsim.renderer.render_rgb_mesh_chw(
                mesh, Resolution(res, res), JCams(ego[:, :2], jnp.stack(
                    [jnp.sin(ego[:, 2]), jnp.cos(ego[:, 2])], -1), jsim.renderer.scale))
            state = jsim.functional_step(state, fpolicy.apply(p, image)[:, None, :])
            pred = state.agent_state
            return state.replace(agent_state=target), pred
        _, preds = jax.lax.scan(body, jsim.state, jexpert)
        return jnp.mean((preds[..., :2] - jexpert[..., :2]) ** 2)

    want, jgrads = jax.value_and_grad(jloss)(params)
    loss = loss.detach()
    print(f'teacher-forced BC loss: port {float(loss)!r}, reference {float(want)!r}, '
          f'free-running {float(free)!r}')
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    assert abs(float(free) - float(loss)) > 1e-3 * float(loss)
    # the reference's gradients carried into the port's layout as its
    # weights are
    sd = _port_policy(4, (4, 8), jax.tree.map(np.asarray, jgrads)).state_dict()
    for (name, _), g in zip(policy.named_parameters(), grads):
        w = sd[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * scale, err_msg=name)

    # the example's first training steps, teacher-forced, from the same weights
    train_step = make_bc_train_step(sim, policy, make_optimizer(policy), res,
                                    teacher_forcing=True)
    losses = [float(train_step(sim.state, expert)) for _ in range(3)]
    tx = optax.adam(3e-4)
    step, opt_state = ex.make_bc_train_step(jsim, fpolicy, tx, res, teacher_forcing=True), \
        tx.init(params)
    ref = []
    for _ in range(3):
        params, opt_state, jl = step(params, opt_state, jsim.state, jexpert)
        ref.append(float(jl))
    np.testing.assert_allclose(losses, ref, rtol=1e-3)


def test_imitation_example_runs_teacher_forced():
    from torchdrivesim_tpu_torch.examples import imitation_learning
    losses = imitation_learning.main(['--batch', '2', '--horizon', '2', '--res', '16',
                                      '--steps', '2', '--teacher-forcing',
                                      '--device', 'cpu'])
    assert len(losses) == 2 and np.all(np.isfinite(losses))


# --- the traffic-light methods ---------------------------------------------------

def _light_json():
    from torchdrivesim_tpu_torch.map import find_map_config
    return find_map_config('carla_Town02').traffic_light_controller_path


def test_light_state_machine_methods_match_jax():
    from torchdrivesim_tpu.traffic_lights import TrafficLightStateMachine as JFsm
    from torchdrivesim_tpu_torch.traffic_lights import TrafficLightStateMachine
    import json
    import tempfile
    with open(_light_json()) as f:
        groups = json.load(f)
    with tempfile.NamedTemporaryFile('w', suffix='.json', delete=False) as f:
        json.dump(groups[0], f)
        path = f.name
    try:
        random.seed(5)
        want = JFsm.from_json(path)
        got = TrafficLightStateMachine.from_json(path, random.Random(5))
    finally:
        os.unlink(path)
    assert got.to_json() == want.to_json()
    for dt in (0.1, 0.5, 3.0, 0.1, 7.0, 30.0, 0.05):
        for fsm in (got, want):
            fsm.tick(dt)
        assert got.current_state.sequence_number == want.current_state.sequence_number
        assert got.duration == want.duration
        assert got.time_remaining == pytest.approx(want.time_remaining, abs=1e-9)
    for fsm in (got, want):
        fsm.set_to(1, 2.5)
    assert (got.duration, got.time_remaining) == (want.duration, want.time_remaining)


def test_light_controller_methods_match_jax():
    from torchdrivesim_tpu.traffic_lights import TrafficLightController as JController
    from torchdrivesim_tpu_torch.traffic_lights import TrafficLightController
    random.seed(11)
    want = JController.from_json(_light_json())
    got = TrafficLightController.from_json(_light_json(), random.Random(11))
    n = got.get_number_of_light_groups()
    assert n == want.get_number_of_light_groups() > 1

    def names(states):
        return {k: v.name for k, v in states.items()}

    def same():
        assert names(got.current_state) == names(want.current_state)
        assert got.current_state_with_name == want.current_state_with_name
        assert got.state_per_machine == want.state_per_machine
        np.testing.assert_allclose(got.time_remaining, want.time_remaining, atol=1e-9)
        assert names(got.collect_all_current_light_states()) == \
            names(want.collect_all_current_light_states())
    same()
    for dt in (0.1, 2.0, 13.0, 0.3, 45.0):
        got.tick(dt)
        want.tick(dt)
        same()
    states = [[i % 3, 1.5 + i] for i in range(n)]
    got.set_to(states)
    want.set_to(states)
    same()
    for c in (got, want):
        c.traffic_fsms[0].tick(100.0)
        c.update_current_state_and_time()
    same()
