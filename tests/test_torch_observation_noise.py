"""
The port's observation noise (``torchdrivesim_tpu_torch/observation_noise.py``)
and the facade's noisy render against the JAX package, on the CPU.

* The noise models on a stub simulator built from one set of numpy arrays
  (B = 2, 5 agents in a row and 2 NPCs, entities from 0.3 m to 150 m from
  each ego, so every deviation tier and occlusion both ways occur): the
  exact views, the deviation tiers and the perturbed state exactly, given
  the same normal draw in both packages (``jax.random.normal`` and the
  port's ``normal`` both patched to return it); the occlusion present mask
  exactly; ``MapObservationNoiseFromLog`` indexed by the step and its color
  fill; the factory.
* The facade: ``render(noisy_perception=True, custom_agent_colors=...)`` on
  the Town02 world of ``test_torch_simulator`` (B = 2, 4 agents, 1 NPC),
  textured (the nearest warp under the packed hard raster, 64 faces culled
  per camera, res 64) and untextured (the road mesh trimmed to 40 m about
  the cameras, the chunked hard raster, res 48) with logged lane features
  drawn as markers: the port's plain versions under the three roundings of
  ``warp.affine``, the reference's kernels in Pallas interpret mode (its
  TPU path, ``_on_tpu`` patched before the texture is set); 0 pixels off
  beyond the rounding (``judge_roundings``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_simulator import A, B, FOV, RES, port_simulator, world_arrays
from tests.test_torch_warp_nearest import judge_roundings

torch.set_num_threads(1)


def stub_arrays():
    """Entities in a row along x at 0, 0.3, 10, 30, 60 (agents) and 150,
    -40 (NPCs) m, jittered across the row per environment; widths 2 m, so
    the nearer ones hide the farther ones from agent 0."""
    rng = np.random.RandomState(5)
    xs = np.asarray([0.0, 0.3, 10.0, 30.0, 60.0, 150.0, -40.0], np.float32)
    states = np.zeros((B, 7, 4), np.float32)
    states[..., 0] = xs + 400.0
    states[..., 1] = rng.uniform(-0.4, 0.4, (B, 7)) + 300.0
    states[..., 2] = rng.uniform(-np.pi, np.pi, (B, 7))
    states[..., 3] = rng.uniform(0, 5, (B, 7))
    states[1, 3, 1] += 5.0                    # out of the row in env 1
    sizes = np.stack([rng.uniform(3, 5, (B, 7)), np.full((B, 7), 2.0)],
                     -1).astype(np.float32)
    present = np.ones((B, 7), bool)
    present[1, 6] = False
    return dict(state=states[:, :5], npc_state=states[:, 5:], size=sizes[:, :5],
                npc_size=sizes[:, 5:], present=present[:, :5], npc_present=present[:, 5:])


class Stub:
    """What the noise models read of a simulator, as arrays of one package."""
    def __init__(self, arrays, asarray, t=0, lane_features=None, generator=None):
        self.a = {k: asarray(v) for k, v in arrays.items()}
        self.batch_size, self.agent_count = arrays['state'].shape[:2]
        self.npc_count = arrays['npc_state'].shape[1]
        self.internal_time = t
        self.lane_features = lane_features
        self.birdview_mesh_generator = generator
        self.traffic_controls = {'traffic_light': 'own'}
        self.road_mesh = 'own road'

    def get_state(self):
        return self.a['state']

    def get_npc_state(self):
        return self.a['npc_state']

    def get_agent_size(self):
        return self.a['size']

    def get_npc_size(self):
        return self.a['npc_size']

    def get_present_mask(self):
        return self.a['present']

    def get_npc_present_mask(self):
        return self.a['npc_present']


def _pair():
    a = stub_arrays()
    return Stub(a, jnp.asarray), Stub(a, torch.from_numpy)


def test_exact_views_match_jax():
    from torchdrivesim_tpu import observation_noise as J
    from torchdrivesim_tpu_torch import observation_noise as P
    js, ps = _pair()
    jm, pm = J.ObservationNoise(J.ObservationNoiseConfig()), \
        P.ObservationNoise(P.ObservationNoiseConfig())
    for name in ('get_noisy_state', 'get_noisy_present_mask', 'get_noisy_agent_size'):
        want = np.asarray(getattr(jm, name)(js))
        got = getattr(pm, name)(ps).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert pm.get_noisy_traffic_controls(ps) is ps.traffic_controls
    assert pm.get_noisy_road_mesh(ps) is ps.road_mesh


def test_deviation_tiers_and_perturbed_state_match_jax(monkeypatch):
    """Exact (0 ulp), given the same standard normal draw."""
    from torchdrivesim_tpu import observation_noise as J
    from torchdrivesim_tpu_torch import observation_noise as P
    js, ps = _pair()
    draw = np.random.RandomState(9).standard_normal((B, 5, 7, 4)).astype(np.float32)
    monkeypatch.setattr(jax.random, 'normal', lambda key, shape, dtype: jnp.asarray(draw))
    jm = J.StandardSensingObservationNoise(J.StandardSensingObservationNoiseConfig())
    pm = P.StandardSensingObservationNoise(P.StandardSensingObservationNoiseConfig(),
                                           device='cpu')
    monkeypatch.setattr(pm, 'normal', lambda shape, dtype: torch.from_numpy(draw))
    dev = pm.deviation(ps).numpy()
    assert set(np.unique(dev).tolist()) == {0.0, np.float32(0.19), np.float32(1.6),
                                            np.float32(3.2), np.float32(3.83)}
    want = np.asarray(jm.get_noisy_state(js))
    got = pm.get_noisy_state(ps).numpy()
    np.testing.assert_array_equal(got, want)
    # the tiers themselves: the reference's state minus its exact view
    exact = np.asarray(J.ObservationNoise.get_noisy_state(jm, js))
    np.testing.assert_array_equal(dev[..., 0] != 0, (want != exact).any(-1))


def test_generator_draws_are_seeded_and_advance():
    from torchdrivesim_tpu_torch import observation_noise as P
    _, ps = _pair()
    cfg = P.StandardSensingObservationNoiseConfig()
    one, two = (P.StandardSensingObservationNoise(cfg, seed=3, device='cpu')
                for _ in range(2))
    first = one.get_noisy_state(ps)
    assert torch.equal(first, two.get_noisy_state(ps))
    assert not torch.equal(first, one.get_noisy_state(ps))
    state = torch.get_rng_state()
    P.StandardSensingObservationNoise(cfg, device='cpu').get_noisy_state(ps)
    assert torch.equal(state, torch.get_rng_state())     # not the global generator


def test_occlusion_present_mask_matches_jax():
    from torchdrivesim_tpu import observation_noise as J
    from torchdrivesim_tpu_torch import observation_noise as P
    js, ps = _pair()
    want = np.asarray(J.StandardSensingObservationNoise(
        J.StandardSensingObservationNoiseConfig()).get_noisy_present_mask(js))
    got = P.StandardSensingObservationNoise(
        P.StandardSensingObservationNoiseConfig(), device='cpu').get_noisy_present_mask(ps)
    np.testing.assert_array_equal(got.numpy(), want)
    base = P.ObservationNoise(P.ObservationNoiseConfig()).get_noisy_present_mask(ps)
    assert int((base & ~got).sum()) > 0


def _lane_features(pkg, asarray, shift):
    return pkg.LaneFeatures(dense_lane_features=asarray(np.full((B, 3, 4), shift, np.float32)),
                            dense_lane_features_mask=asarray(np.ones((B, 3), bool)))


def test_map_noise_from_log_indexes_by_step_and_fills_colors():
    from torchdrivesim_tpu import lanelet2 as JL, observation_noise as J
    from torchdrivesim_tpu.mesh import BaseMesh as JBase, BirdviewMesh as JBVM
    from torchdrivesim_tpu_torch import lanelet2 as PL, observation_noise as P
    from torchdrivesim_tpu_torch.mesh import BaseMesh as PBase, BirdviewMesh as PBVM
    from torchdrivesim_tpu_torch.rendering.base import (
        get_default_color_map, get_default_rendering_levels)

    class Gen:
        color_map = get_default_color_map()
        rendering_levels = get_default_rendering_levels()
        background_mesh = 'own background'

    verts = np.random.RandomState(1).rand(1, 6, 2).astype(np.float32)
    faces = np.asarray([[[0, 1, 2], [3, 4, 5]]], np.int32)
    meshes = {}
    for name, pkg, base, bvm, lanes, asarray in (
            ('jax', J, JBase, JBVM, JL, jnp.asarray),
            ('port', P, PBase, PBVM, PL, torch.from_numpy)):
        logged = bvm.set_properties(base(verts=verts, faces=faces), 'road', z=7.0)
        model = pkg.MapObservationNoiseFromLog(
            pkg.MapObservationNoiseFromLogConfig(),
            noisy_lane_features=[_lane_features(lanes, asarray, s) for s in (1.0, 2.0)],
            noisy_background_mesh=[logged],
            noisy_traffic_controls=[{'stop_sign': 'logged'}],
            noisy_crosswalk_features=[('cross',)])
        for t in range(3):
            sim = Stub(stub_arrays(), asarray, t=t, generator=Gen(),
                       lane_features=_lane_features(lanes, asarray, -1.0))
            lf = model.get_noisy_lane_features(sim)
            assert float(np.asarray(lf.dense_lane_features).max()) == [1.0, 2.0, -1.0][t]
            mesh = model.get_noisy_background_mesh(sim)
            road = model.get_noisy_road_mesh(sim)
            controls = model.get_noisy_traffic_controls(sim)
            if t == 0:
                meshes[name] = mesh
                assert road is logged and controls == {'stop_sign': 'logged'}
                assert model.get_noisy_crosswalk_features(sim) == ('cross',)
            else:
                assert mesh == 'own background' and road == 'own road'
                assert controls is sim.traffic_controls
                assert model.get_noisy_crosswalk_features(sim) is None
    got, want = meshes['port'], meshes['jax']
    assert got.zs == want.zs == {'road': 7.0}
    np.testing.assert_array_equal(np.asarray(got.colors['road']),
                                  np.asarray(want.colors['road']))


def test_factory_matches_jax():
    from torchdrivesim_tpu import observation_noise as J
    from torchdrivesim_tpu_torch import observation_noise as P
    for cfg in ('ObservationNoiseConfig', 'StandardSensingObservationNoiseConfig',
                'MapObservationNoiseFromLogConfig'):
        want = type(J.observation_noise_from_config(getattr(J, cfg)())).__name__
        got = P.observation_noise_from_config(getattr(P, cfg)(), device='cpu')
        assert type(got).__name__ == want
        assert got.cfg._type_ == getattr(J, cfg)()._type_


# --- the facade's noisy, recolored render ------------------------------------

TRIM = 40.0      # m about the untextured case's camera


def lane_marker_log(a, center):
    """Two steps of logged dense lane features about ``center``: 6 markers
    (x, y, psi, width) per environment, the last absent."""
    rng = np.random.RandomState(11)
    feats = np.zeros((2, B, 6, 4), np.float32)
    feats[..., :2] = center + rng.uniform(-12, 12, (2, B, 6, 2))
    feats[..., 2] = rng.uniform(-np.pi, np.pi, (2, B, 6))
    feats[..., 3] = rng.uniform(1.0, 3.0, (2, B, 6))
    mask = np.ones((2, B, 6), bool)
    mask[:, :, -1] = False
    return feats, mask


def jax_simulator(a, m):
    """The JAX facade on ``world_arrays()``'s world, its texture set with
    ``_on_tpu`` already patched (``m``), so the mip pyramid is built."""
    import torchdrivesim_tpu.kinematic as JK
    from torchdrivesim_tpu.benchmark import load_or_bake_texture
    from torchdrivesim_tpu.goals import WaypointGoal
    from torchdrivesim_tpu.map import find_map_config
    from torchdrivesim_tpu.rendering import JaxRendererConfig
    from torchdrivesim_tpu.simulator import NPCController, Simulator, TorchDriveConfig
    from torchdrivesim_tpu.traffic_controls import TrafficLightControl
    from torchdrivesim_tpu.utils import Resolution
    cfg_map = find_map_config('carla_Town02')
    kin = JK.KinematicBicycle(dt=0.1)
    kin.set_params(lr=jnp.asarray(a['lr']))
    kin.set_state(jnp.asarray(a['agent_state']))
    cfg = TorchDriveConfig()
    cfg.renderer = JaxRendererConfig()
    sim = Simulator(
        road_mesh=cfg_map.road_mesh.expand(B), kinematic_model=kin,
        agent_size=a['agent_size'], initial_present_mask=np.ones((B, A), bool),
        cfg=cfg, traffic_controls={'traffic_light': TrafficLightControl(
            a['light_pos'], replay_states=a['light_replay'])},
        waypoint_goals=WaypointGoal(a['waypoints']), agent_types=a['agent_types'],
        agent_type_names=['vehicle', 'pedestrian'], agent_lr=a['agent_lr'],
        npc_controller=NPCController(a['npc_size'], a['npc_state']))
    sim.renderer.res = Resolution(RES, RES)
    sim.renderer.scale = 2.0 / FOV
    sim.renderer.background_texture = load_or_bake_texture(
        cfg_map, sim.renderer.color_map, sim.renderer.rendering_levels)
    return sim


@pytest.fixture(scope='module')
def worlds():
    """(arrays, JAX facade, port facade), the JAX kernels in interpret mode
    for the module's tests."""
    import torchdrivesim_tpu.ops.pallas_fused as F
    import torchdrivesim_tpu.ops.pallas_rasterize as R
    import torchdrivesim_tpu.ops.pallas_warp as W
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    a = world_arrays()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jr, '_on_tpu', lambda: True)
        for mod in (W, R, F):
            m.setattr(mod.pl, 'pallas_call',
                      functools.partial(mod.pl.pallas_call, interpret=True))
        yield a, jax_simulator(a, m), port_simulator(a)


def _colors(n_cameras):
    return np.random.RandomState(4).uniform(
        0, 1, (B, n_cameras, A + 1, 3)).astype(np.float32)


def _cameras(a):
    """One camera per environment on its agent 0, and a second on agent 3."""
    xy = a['agent_state'][:, [0, 3], :2]
    psi = a['agent_state'][:, [0, 3], 2:3]
    return xy, psi


def test_textured_noisy_render_matches_jax(worlds):
    """Standard sensing: the render is of the map and the exact agents (the
    noise reaches the getters, not the picture), recolored boxes over the
    texture: B2 under B6a."""
    from torchdrivesim_tpu import observation_noise as J
    from torchdrivesim_tpu_torch import observation_noise as P
    a, jsim, psim = worlds
    jsim.observation_noise_model = J.StandardSensingObservationNoise(
        J.StandardSensingObservationNoiseConfig())
    psim.observation_noise_model = P.StandardSensingObservationNoise(
        P.StandardSensingObservationNoiseConfig(), device='cpu')
    xy, psi = _cameras(a)
    colors = _colors(2)
    want = np.asarray(jsim.render(jnp.asarray(xy), jnp.asarray(psi), fov=FOV,
                                  custom_agent_colors=jnp.asarray(colors),
                                  noisy_perception=True))
    render = lambda: psim.render(torch.from_numpy(xy), torch.from_numpy(psi), fov=FOV,
                                 custom_agent_colors=torch.from_numpy(colors),
                                 noisy_perception=True).numpy()
    assert judge_roundings(render, want, 'textured noisy render') == 0
    # the recolored boxes show: a custom color is drawn
    got = render()
    box = np.round(colors[0, 0, 0] * 255)
    assert (np.abs(got[0, 0] - box[:, None, None]).max(axis=0) < 1).any()
    # noise off: the same picture as without noisy perception on the mesh path
    np.testing.assert_array_equal(
        got, psim.render(torch.from_numpy(xy), torch.from_numpy(psi), fov=FOV,
                         custom_agent_colors=torch.from_numpy(colors)).numpy())


def test_untextured_noisy_render_with_lane_markers_matches_jax(worlds):
    """Logged lane features at step 0 become 'stop_sign' markers added to
    the (trimmed) road mesh; the chunked hard raster over the color."""
    from torchdrivesim_tpu import lanelet2 as JL, observation_noise as J
    from torchdrivesim_tpu.map import find_map_config as jfind
    from torchdrivesim_tpu_torch import lanelet2 as PL, observation_noise as P
    from torchdrivesim_tpu_torch.map import find_map_config
    from torchdrivesim_tpu_torch.utils import Resolution
    a, jsim, psim = worlds
    center = a['agent_state'][0, 0, :2]
    box = np.asarray([center + [-TRIM, -TRIM], center + [TRIM, -TRIM],
                      center + [TRIM, TRIM], center + [-TRIM, TRIM]], np.float32)
    feats, mask = lane_marker_log(a, center)
    pmesh = find_map_config('carla_Town02').road_mesh.trim(box)
    jmesh = jfind('carla_Town02').road_mesh.trim(jnp.asarray(box))
    xy = np.repeat(center[None, None], B, axis=0)
    psi = np.full((B, 1, 1), 0.7, np.float32)
    colors = _colors(1)
    jsim = jsim.copy()
    psim = psim.copy()
    jsim.renderer.background_texture = None
    psim.renderer.background_texture = None
    jsim.birdview_mesh_generator.initialize_background_mesh(jmesh.expand(B))
    psim.birdview_mesh_generator.initialize_background_mesh(pmesh)
    jsim.observation_noise_model = J.MapObservationNoiseFromLog(
        J.MapObservationNoiseFromLogConfig(), noisy_lane_features=[
            JL.LaneFeatures(jnp.asarray(f), jnp.asarray(k)) for f, k in zip(feats, mask)])
    psim.observation_noise_model = P.MapObservationNoiseFromLog(
        P.MapObservationNoiseFromLogConfig(), noisy_lane_features=[
            PL.LaneFeatures(torch.from_numpy(f), torch.from_numpy(k))
            for f, k in zip(feats, mask)])
    res = Resolution(48, 48)
    want = np.asarray(jsim.render(jnp.asarray(xy), jnp.asarray(psi), res=res, fov=FOV,
                                  custom_agent_colors=jnp.asarray(colors),
                                  noisy_perception=True))
    render = lambda: psim.render(torch.from_numpy(xy), torch.from_numpy(psi), res=res,
                                 fov=FOV, custom_agent_colors=torch.from_numpy(colors),
                                 noisy_perception=True).numpy()
    assert judge_roundings(render, want, 'untextured noisy render') == 0
    # the markers are drawn in the stop sign's color, and only when noisy
    sign = np.asarray(psim.renderer.color_map['stop_sign'], np.float32)
    marked = lambda img: int((np.abs(img - sign[:, None, None]).max(axis=-3) < 1).sum())
    assert marked(render()) > 0
    assert marked(psim.render(torch.from_numpy(xy), torch.from_numpy(psi), res=res,
                              fov=FOV).numpy()) == 0


def test_noisy_getters_match_jax(worlds):
    """The facade's ``get_noisy_*`` under the exact model, and the relative
    views under standard sensing given the same draw."""
    from torchdrivesim_tpu import observation_noise as J
    from torchdrivesim_tpu_torch import observation_noise as P
    a, jsim, psim = worlds
    jsim = jsim.copy()
    psim = psim.copy()
    jsim.observation_noise_model = J.ObservationNoise(J.ObservationNoiseConfig())
    psim.observation_noise_model = P.ObservationNoise(P.ObservationNoiseConfig())
    for name in ('get_noisy_state', 'get_noisy_agent_size', 'get_noisy_present_mask',
                 'get_noisy_all_agents_absolute', 'get_noisy_all_agents_relative'):
        want = np.asarray(getattr(jsim, name)())
        got = getattr(psim, name)().numpy()
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    rel = psim.get_noisy_all_agents_relative(exclude_self=False).numpy()
    np.testing.assert_allclose(rel, np.asarray(
        jsim.get_noisy_all_agents_relative(exclude_self=False)), rtol=1e-5, atol=1e-5)
    assert psim.get_noisy_lane_features() is None
    assert psim.get_noisy_road_mesh() is psim.road_mesh
    assert psim.get_noisy_background_mesh() is psim.birdview_mesh_generator.background_mesh
    assert psim.get_noisy_traffic_controls() is psim.traffic_controls
