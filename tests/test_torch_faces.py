"""
The face-soup render on the CPU against the JAX package:

* ``BirdviewRGBMeshGenerator.generate_faces`` against the reference's on
  the same numpy inputs (absent agents, traffic lights, waypoint discs with
  their mask, several cameras in the ``b * Nc + cam`` layout, no direction
  markers, another disc from ``initialize_waypoint_mesh``): shapes, z and
  colors exact, the masked faces all-zero in both, the corners to 1e-5 m
  (the two packages' float32 sin and cos may round apart); ``expand`` and
  ``to``;
* ``Renderer.render_faces_chw`` against the reference's on its TPU path
  (``jax_renderer._on_tpu`` patched to True before the texture is set,
  every ``pallas_call`` in interpret mode), on the faces of the shared
  Town02 world (``tests/test_torch_simulator.py``): over the texture (the
  nearest mip warp B2 under the packed hard raster B6a), untextured (B6a
  over the color, culled to 64 faces), padded (res 100) and a wide view
  that no mip level covers (the full-resolution nearest background), and
  a differentiable renderer's (B6a over that background; the reference
  runs its plain raster there, whose float colors B6a's RGB8 decode
  meets within one float32 rounding, so that case compares the 8-bit
  images): the port under the three roundings of ``warp.affine``
  (``judge_roundings``), 0 pixels off beyond the rounding;
* the face soup against the mesh render of the same frame (as the
  reference's own test).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_simulator import A, B, FOV, port_simulator, world_arrays
from tests.test_torch_warp_nearest import judge_roundings
from torchdrivesim_tpu_torch.rendering.base import Cameras
from torchdrivesim_tpu_torch.utils import Resolution

torch.set_num_threads(1)


def _generators(b, a, nl, direction=True, on_device=False):
    """The reference's and the port's generators with the same actor and
    light templates (numpy seed 4), and the inputs of a frame; the
    reference's templates as device arrays with ``on_device`` (its
    ``expand`` repeats only those)."""
    from torchdrivesim_tpu.mesh import BaseMesh as JBaseMesh, BirdviewMesh as JMesh
    from torchdrivesim_tpu.rendering.base import (
        get_default_color_map, get_default_rendering_levels)
    from torchdrivesim_tpu.scene_mesh import BirdviewRGBMeshGenerator as JGen
    from torchdrivesim_tpu.traffic_controls import TrafficLightControl as JLight
    from torchdrivesim_tpu_torch.scene_mesh import BirdviewRGBMeshGenerator
    from torchdrivesim_tpu_torch.traffic_controls import TrafficLightControl
    rng = np.random.RandomState(4)
    lenwid = rng.uniform(1.5, 5.0, (b, a, 2)).astype(np.float32)
    types = rng.randint(0, 2, (b, a)).astype(np.int32)
    pos = np.concatenate([rng.uniform(-40, 40, (b, nl, 2)), rng.uniform(1, 6, (b, nl, 2)),
                          rng.uniform(-3, 3, (b, nl, 1))], -1).astype(np.float32)
    road = JMesh.set_properties(JBaseMesh(verts=np.zeros((b, 3, 2), np.float32),
                                          faces=np.zeros((b, 1, 3), np.int32)), 'road')
    names = ['vehicle', 'pedestrian']
    jgen = JGen(road, get_default_color_map(), get_default_rendering_levels(),
                render_agent_direction=direction)
    dev = jnp.asarray if on_device else np.asarray
    jgen.initialize_actors_mesh(dev(lenwid), dev(types), names, direction)
    gen = BirdviewRGBMeshGenerator(get_default_color_map(), get_default_rendering_levels(),
                                   render_agent_direction=direction)
    gen.initialize_actors_mesh(torch.from_numpy(lenwid), torch.from_numpy(types), names)
    if nl:
        jgen.initialize_traffic_controls_mesh({'traffic_light': JLight(pos)})
        gen.initialize_traffic_controls_mesh(
            {'traffic_light': TrafficLightControl(pos, device='cpu')})
    return jgen, gen, rng


FACE_CASES = {
    'one_camera': dict(b=3, a=5, nl=4, nc=1, m=2),
    'three_cameras': dict(b=2, a=4, nl=3, nc=3, m=3),
    'no_direction_no_lights': dict(b=2, a=6, nl=0, nc=1, m=0, direction=False),
    'other_disc': dict(b=2, a=3, nl=2, nc=2, m=2, disc=(3.5, 6)),
}


@pytest.mark.parametrize('case', list(FACE_CASES))
def test_generate_faces_matches_jax(case):
    kw = FACE_CASES[case]
    b, a, nl, nc, m = kw['b'], kw['a'], kw['nl'], kw['nc'], kw['m']
    jgen, gen, rng = _generators(b, a, nl, kw.get('direction', True))
    if 'disc' in kw:
        jgen.initialize_waypoint_mesh(*kw['disc'])
        gen.initialize_waypoint_mesh(*kw['disc'])
        assert gen.waypoint_template_faces.shape[0] == kw['disc'][1]
    bc = b * nc
    state = np.concatenate([rng.uniform(-40, 40, (bc, a, 2)), rng.uniform(-3, 3, (bc, a, 2))],
                           -1).astype(np.float32)
    present = rng.rand(bc, a) > 0.3
    lights = rng.randint(0, 3, (bc, nl)).astype(np.int32) if nl else None
    wps = rng.uniform(-30, 30, (bc, m, 2)).astype(np.float32) if m else None
    wmask = rng.rand(bc, m) > 0.4 if m else None
    j = lambda x: None if x is None else jnp.asarray(x)
    t = lambda x: None if x is None else torch.from_numpy(x)
    want = jgen.generate_faces(j(state), present_mask=j(present), traffic_light_state=j(lights),
                               waypoints=j(wps), waypoints_rendering_mask=j(wmask))
    got = gen.generate_faces(t(state), present_mask=t(present), traffic_light_state=t(lights),
                             waypoints=t(wps), waypoints_rendering_mask=t(wmask))
    for g, w, name in zip(got, want, ('corners', 'z', 'colors')):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        if name == 'corners':
            np.testing.assert_array_equal(g.numpy() == 0, w == 0)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    fpa = 3 if kw.get('direction', True) else 2
    absent = ~present.repeat(fpa, axis=1)
    assert absent.any() and not got[0][:, :a * fpa][torch.from_numpy(absent)].any()
    if m:
        fd = gen.waypoint_template_faces.shape[0]
        hidden = ~wmask.repeat(fd, axis=1)
        assert not got[0][:, -m * fd:][torch.from_numpy(hidden)].any()


def test_generator_expand_and_to():
    jgen, gen, _ = _generators(2, 3, 2, on_device=True)
    jwide, wide = jgen.expand(3), gen.expand(3)
    assert gen.to('cpu') is gen
    np.testing.assert_array_equal(wide.actor_z.numpy(), np.asarray(jwide.actor_z))
    np.testing.assert_array_equal(wide.actor_attrs.numpy(), np.asarray(jwide.actor_attrs))
    np.testing.assert_allclose(wide.actor_verts.numpy(), np.asarray(jwide.actor_verts),
                               rtol=0, atol=0)
    # the reference's expand repeats its device arrays only, and its light
    # corners stay on the host here: repeated as they would be
    np.testing.assert_allclose(wide.light_quads[:, :, [0, 1, 3, 2]].numpy(),
                               np.repeat(np.asarray(jgen.light_verts), 3, axis=0),
                               rtol=0, atol=1e-4)
    assert gen.actor_verts.shape[0] == 2 and wide.actor_verts.shape[0] == 6


@pytest.fixture(scope='module')
def worlds():
    """(arrays, JAX facade, port facade) of the shared Town02 world, the
    JAX renderer on its TPU path with its kernels in interpret mode for
    the module's tests."""
    import torchdrivesim_tpu.ops.pallas_fused as F
    import torchdrivesim_tpu.ops.pallas_rasterize as R
    import torchdrivesim_tpu.ops.pallas_warp as W
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from tests.test_torch_observation_noise import jax_simulator
    a = world_arrays()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jr, '_on_tpu', lambda: True)
        for mod in (W, R, F):
            m.setattr(mod.pl, 'pallas_call',
                      functools.partial(mod.pl.pallas_call, interpret=True))
        yield a, jax_simulator(a, m), port_simulator(a)


def _frame(sim, a, nc=2):
    """The face soup of ``nc`` cameras per environment (on agents 0 and 3),
    with the lights and each camera's two waypoint discs: (corners, z,
    colors, cameras' xy (B Nc, 2), sc (B Nc, 2))."""
    n_all = sim.agent_count + sim.npc_count
    state = sim.get_all_agent_state()
    present = sim.get_all_agent_present_mask()
    rep = lambda x: torch.repeat_interleave(x, nc, dim=0)
    wps = torch.from_numpy(np.random.RandomState(6).uniform(
        -25, 25, (B * nc, 2, 2)).astype(np.float32)) + rep(state[:, :1, :2])
    faces = sim.birdview_mesh_generator.generate_faces(
        rep(state), present_mask=rep(present),
        traffic_light_state=rep(sim.get_traffic_light_state()), waypoints=wps,
        waypoints_rendering_mask=torch.tensor([[True, False], [True, True]] * (B * nc // 2)))
    xy = state[:, [0, 3], :2].reshape(-1, 2)
    psi = state[:, [0, 3], 2]
    sc = torch.stack([torch.sin(psi), torch.cos(psi)], -1).reshape(-1, 2)
    assert faces[0].shape[1] == n_all * 3 + 2 * sim.traffic_controls[
        'traffic_light'].corners.shape[1] + 2 * 10
    return faces, xy, sc


RENDER_CASES = {
    'textured_res64': dict(res=64, fov=FOV),
    'untextured_res64': dict(res=64, fov=FOV, textured=False),
    'textured_padded_res100': dict(res=100, fov=FOV),
    'wide_view_res32': dict(res=32, fov=400.0),
    # a differentiable renderer: B6a over the full-resolution nearest
    # sample (the reference's plain raster over the same background)
    'differentiable_res64': dict(res=64, fov=FOV, differentiable=True),
}


@pytest.mark.parametrize('case', list(RENDER_CASES))
def test_render_faces_matches_jax(worlds, case):
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from torchdrivesim_tpu.rendering import JaxRendererConfig
    from torchdrivesim_tpu.rendering.base import Cameras as JCams
    kw = RENDER_CASES[case]
    a, jsim, psim = worlds
    jren, pren = jsim.renderer, psim.renderer
    if not kw.get('textured', True):
        jren = jr.JaxRenderer(JaxRendererConfig())
        pren = type(pren)(pren.cfg, 'cpu')
    if kw.get('differentiable'):
        jren = jr.JaxRenderer(JaxRendererConfig(differentiable=True),
                              background_texture=jren.background_texture)
        texture, pren = pren.background_texture, type(pren)(
            dataclasses.replace(pren.cfg, differentiable=True), 'cpu')
        pren.background_texture = texture
    (corners, z, colors), xy, sc = _frame(psim, a)
    res, scale = Resolution(kw['res'], kw['res']), 2.0 / kw['fov']
    # jitted, as the reference renders: its full-resolution background's
    # ``x / 255.0`` compiles to a product by float32(1/255), as the port's
    want = np.asarray(jax.jit(lambda c, zz, col, cxy, csc: jren.render_faces_chw(
        c, zz, col, res, JCams(cxy, csc, scale)))(
        *(jnp.asarray(x.numpy()) for x in (corners, z, colors, xy, sc))))
    render = lambda: pren.render_faces_chw(corners, z, colors, res,
                                           Cameras(xy, sc, scale)).numpy()
    if kw.get('differentiable'):
        # the reference's differentiable route is its plain raster, which
        # carries the generator's float colors; the port's B6a decodes them
        # from RGB8 as c8 * (1/255): the same 8-bit image, each pixel within
        # that one float32 rounding
        np.testing.assert_allclose(render(), want, rtol=0, atol=255 * 2.0 ** -23)
        want, render = np.round(want), (lambda exact=render: np.round(exact()))
    assert judge_roundings(render, want, case) == 0
    got = render()
    assert got.shape == (B * 2, 3, kw['res'], kw['res'])
    if kw['res'] == 64:
        # each camera's own vehicle at the center of its view
        vehicle = np.asarray(pren.color_map['vehicle'], np.float32)
        centre = got[:, :, 30:34, 30:34]
        assert (np.abs(centre - vehicle[None, :, None, None]).max(axis=1) < 0.5).any(
            axis=(1, 2)).sum() >= B


def test_differentiable_face_soup_takes_the_hard_kernel(worlds, monkeypatch):
    """A differentiable renderer's face soup goes through ``ops.hard.raster``
    (B6a on the card) once, never through the plain
    ``rasterize_hard_faces``."""
    import torchdrivesim_tpu_torch.rendering.renderer as R
    a, _, psim = worlds
    pren = type(psim.renderer)(dataclasses.replace(psim.renderer.cfg, differentiable=True),
                               'cpu')
    pren.background_texture = psim.renderer.background_texture
    (corners, z, colors), xy, sc = _frame(psim, a)
    calls, raster = [], R.raster

    def counted(*args):
        calls.append(len(args[0]))
        return raster(*args)

    def plain(*args, **kw):
        raise AssertionError('the plain hard raster ran')
    monkeypatch.setattr(R, 'raster', counted)
    monkeypatch.setattr(R, 'rasterize_hard_faces', plain)
    image = pren.render_faces_chw(corners, z, colors, Resolution(64, 64),
                                  Cameras(xy, sc, 2.0 / FOV))
    assert calls == [2] and torch.isfinite(image).all()


def test_render_faces_culls_untextured_views_to_the_budget(worlds):
    a, _, psim = worlds
    (corners, z, colors), xy, sc = _frame(psim, a)
    pren = type(psim.renderer)(psim.renderer.cfg, 'cpu')
    bg, (c, zz, col), warp = pren.face_frame_operands(corners, z, colors, 64,
                                                      Cameras(xy, sc, 2.0 / FOV))
    assert corners.shape[1] > 64 and c.shape[1] == 64 and warp is None
    _, faces, warp = psim.renderer.face_frame_operands(corners, z, colors, 64,
                                                       Cameras(xy, sc, 2.0 / FOV))
    assert faces[0].shape[1] == 64 and warp is not None


def test_faces_match_the_mesh_render(worlds):
    """The face soup and the frame's mesh (``generate``, the same dynamic
    content) render the same picture over the texture: both cull to 64
    faces and run the packed hard raster."""
    a, _, psim = worlds
    sim = psim
    n_all = sim.agent_count + sim.npc_count
    state, present = sim.get_all_agent_state(), sim.get_all_agent_present_mask()
    lights = sim.get_traffic_light_state()
    ego = state[:, 0]
    cams = Cameras(ego[:, :2], torch.stack([torch.sin(ego[:, 2]), torch.cos(ego[:, 2])], -1),
                   2.0 / FOV)
    res = Resolution(64, 64)
    mesh = sim.birdview_mesh_generator.generate(1, state[:, None], present[:, None],
                                                traffic_light_state=lights,
                                                include_background=False)
    want = sim.renderer.render_rgb_mesh_chw(mesh, res, cams).numpy()
    faces = sim.birdview_mesh_generator.generate_faces(state, present_mask=present,
                                                       traffic_light_state=lights)
    assert faces[0].shape[1] == n_all * 3 + 2 * lights.shape[1]
    got = sim.renderer.render_faces_chw(*faces, res, cams).numpy()
    same = (got == want).all(axis=1).mean()
    assert same > 0.999, same
    assert got.max() > 0 and A > 0


# --- the two examples ------------------------------------------------------------

def test_lanelet2_to_birdview_mesh_example_matches_jax(tmp_path, monkeypatch):
    """The port's example writes the JAX example's mesh JSON for Town02's
    .osm: the same keys, categories and faces, vertices to 1e-4 m."""
    import json
    import os
    import sys
    from torchdrivesim_tpu_torch.examples import lanelet2_to_birdview_mesh
    from torchdrivesim_tpu_torch.map import find_map_config
    osm = find_map_config('carla_Town02').lanelet_path
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(os.path.join(root, 'examples'))
    import importlib
    reference = importlib.import_module('lanelet2_to_birdview_mesh')
    monkeypatch.setattr(sys, 'argv', ['x', '--osm', osm, '--out', str(tmp_path / 'jax.json'),
                                      '--origin', '1', '-2'])
    reference.main()
    mesh = lanelet2_to_birdview_mesh.main(['--osm', osm, '--out', str(tmp_path / 'port.json'),
                                           '--origin', '1', '-2'])
    want, got = (json.load(open(tmp_path / n)) for n in ('jax.json', 'port.json'))
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], list) and want[key] and not isinstance(want[key][0], str):
            np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                       np.asarray(want[key], np.float64), rtol=0, atol=1e-4,
                                       err_msg=key)
        else:
            assert got[key] == want[key], key
    assert mesh.faces_count > 1000


def test_initialize_simulation_example(tmp_path, monkeypatch):
    """The heuristic branch on the CPU at 64 px (the whole Town02 mesh in
    one view, the plain chunked raster), its agents placed as the
    reference's initializer places them from the same seed; the ``iai``
    branch against a mock client."""
    from tests.test_torch_gym_env import _mock_invertedai
    import torchdrivesim_tpu_torch.behavior.iai as iai
    from torchdrivesim_tpu.behavior.heuristic import heuristic_initialize as jax_init
    from torchdrivesim_tpu.map import find_map_config as jax_find
    from torchdrivesim_tpu_torch.examples import initialize_simulation as ex
    monkeypatch.setattr(ex, 'RES', 64)
    import random
    random.seed(3)
    want_attrs, want_states = jax_init(jax_find('carla_Town02').lanelet_map, 6)
    args = ex.parse_args(['--agents', '6', '--seed', '3', '--device', 'cpu',
                          '--out', str(tmp_path / 'h.npz')])
    sim = ex.build_simulator(args)
    np.testing.assert_allclose(sim.get_state().numpy(), np.asarray(want_states), atol=1e-6)
    np.testing.assert_allclose(sim.get_agent_size().numpy(), np.asarray(want_attrs)[..., :2])
    frame = ex.main(['--agents', '6', '--seed', '3', '--device', 'cpu',
                     '--out', str(tmp_path / 'h.npz')])
    assert frame.shape == (64, 64, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(np.load(tmp_path / 'h.npz')['frame'], frame)
    road = np.asarray(sim.renderer.color_map['road'], np.uint8)
    assert (frame == road).all(axis=-1).sum() > 100
    monkeypatch.setattr(iai, 'invertedai', _mock_invertedai())
    frame = ex.main(['--method', 'iai', '--agents', '3', '--device', 'cpu',
                     '--out', str(tmp_path / 'i.npz')])
    assert frame.shape == (64, 64, 3) and frame.any()
