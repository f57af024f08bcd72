"""
The port's plain modules of the env step against their JAX counterparts on
the same numpy inputs: kinematics, traffic lights and controls, primitive
generation (typed primitives and the per-camera RGB mesh), camera
transform, map-grid losses, collisions, red-light violations and the
heuristic initializer.
"""
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdrivesim_tpu.kinematic as JK
import torchdrivesim_tpu_torch.kinematic as K
from torchdrivesim_tpu.infractions import compute_collision_matrix as jax_collisions
from torchdrivesim_tpu.map import find_map_config as jax_find_map
from torchdrivesim_tpu.map_grids import (
    offroad_loss_from_grid as jax_offroad, wrong_way_loss_from_grid as jax_wrong_way)
from torchdrivesim_tpu.ops.rasterize import camera_rows_cols as jax_rows_cols
from torchdrivesim_tpu.traffic_controls import (
    TrafficLightControl as JaxLightControl, red_light_violations as jax_red_light)
from torchdrivesim_tpu.traffic_lights import (
    BakedLightSchedule as JaxSchedule, TrafficLightController as JaxController)
from torchdrivesim_tpu_torch.infractions import compute_collision_matrix
from torchdrivesim_tpu_torch.map import find_map_config
from torchdrivesim_tpu_torch.map_grids import (
    offroad_loss_from_grid, wrong_way_loss_from_grid)
from torchdrivesim_tpu_torch.ops.rasterize import camera_rows_cols
from torchdrivesim_tpu_torch.scene_mesh import BirdviewRGBMeshGenerator
from torchdrivesim_tpu_torch.traffic_controls import (
    TrafficLightControl, red_light_violations)
from torchdrivesim_tpu_torch.traffic_lights import (
    BakedLightSchedule, TrafficLightController)

torch.set_num_threads(1)

MAP = 'carla_Town02'


@pytest.fixture(scope='module')
def maps():
    """Both packages' Town02 configs, lanelet maps and grids, parsed once."""
    jcfg, cfg = jax_find_map(MAP), find_map_config(MAP)
    return dict(jcfg=jcfg, cfg=cfg, jlanelets=jcfg.lanelet_map,
                lanelets=cfg.lanelet_map, jgrids=jcfg.grids(), grids=cfg.grids(device='cpu'))


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize('left_handed', [False, True])
def test_bicycle_rollout_matches(left_handed):
    rng = np.random.RandomState(3)
    b, a = 4, 6
    state = np.concatenate([rng.randn(b, a, 2) * 5, rng.uniform(-3, 3, (b, a, 1)),
                            rng.uniform(0, 8, (b, a, 1))], -1).astype(np.float32)
    lr = rng.uniform(1.0, 2.0, (b, a)).astype(np.float32)
    lr[0, 0] = np.nan                                   # sanitized to 1
    actions = rng.uniform(-1, 1, (40, b, a, 2)).astype(np.float32)
    jparams = JK.KinematicParams(lr=jnp.asarray(lr), dt=0.1, left_handed=left_handed)
    params = K.KinematicParams(lr=_t(lr), dt=0.1, left_handed=left_handed)
    js, s = jnp.asarray(state), _t(state)
    for act in actions:
        js = JK.step(js, jnp.asarray(act), jparams, single_model=JK.BICYCLE)
        s = K.step(s, _t(act), params)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5, rtol=0)


def test_simple_rollout_matches():
    """The behaviour-cloning example's simple model: 2-wide actions padded
    to the 4-wide buffer, and full 4-wide actions."""
    rng = np.random.RandomState(5)
    state = rng.uniform(-10, 10, (3, 2, 4)).astype(np.float32)
    jparams = JK.KinematicParams(dt=0.1, max_dx=20.0, max_dpsi=10 * np.pi, max_dv=5.0)
    params = K.SimpleKinematicModel(device='cpu').params
    for width in (2, 4):
        actions = rng.uniform(-1, 1, (10, 3, 2, width)).astype(np.float32)
        js, s = jnp.asarray(state), _t(state)
        for act in actions:
            js = JK.step(js, jnp.asarray(act), jparams, single_model=JK.SIMPLE)
            s = K.step(s, _t(act), params, single_model=K.SIMPLE)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5, rtol=0)


def test_light_schedule_and_control_advance_match(maps):
    jcfg, cfg = maps['jcfg'], maps['cfg']
    ids = [sl.actor_id for sl in cfg.stoplines if sl.agent_type == 'traffic_light']
    saved = random.getstate()
    try:
        random.seed(11)
        jsched = JaxSchedule(JaxController.from_json(jcfg.traffic_light_controller_path), ids)
    finally:
        random.setstate(saved)
    sched = BakedLightSchedule(TrafficLightController.from_json(
        cfg.traffic_light_controller_path, random.Random(11)), ids, device='cpu')
    for name in ('durations_cum', 'colors', 'tail_end', 'period', 'offset',
                 'light_fsm', 'n_rows'):
        np.testing.assert_array_equal(getattr(sched, name).numpy(),
                                      np.asarray(getattr(jsched, name)), err_msg=name)
    pos = np.asarray([[[sl.x, sl.y, sl.length, sl.width, sl.orientation]
                       for sl in cfg.stoplines]], np.float32)
    jctl, ctl = JaxLightControl(np.repeat(pos, 2, 0)), TrafficLightControl(np.repeat(pos, 2, 0), device='cpu')
    jctl.set_schedule(jsched, dt=0.1)
    ctl.set_schedule(sched, dt=0.1)
    js, s = jctl.state, ctl.state
    seen = set()
    for step in range(1, 1500, 7):
        js = jctl.advance(js, jnp.asarray(step, jnp.int32))
        s = ctl.advance(s, torch.tensor(step, dtype=torch.int32))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        seen.update(np.unique(s.numpy()).tolist())
    assert seen == {0, 1, 2}


def test_generate_prims_match():
    from torchdrivesim_tpu.mesh import BaseMesh as JBaseMesh, BirdviewMesh as JMesh
    from torchdrivesim_tpu.scene_mesh import BirdviewRGBMeshGenerator as JGen
    from torchdrivesim_tpu.rendering.base import (
        get_default_color_map, get_default_rendering_levels)
    rng = np.random.RandomState(4)
    b, a, nl = 3, 5, 4
    lenwid = rng.uniform(1.5, 5.0, (b, a, 2)).astype(np.float32)
    state = np.concatenate([rng.uniform(-40, 40, (b, a, 2)), rng.uniform(-3, 3, (b, a, 2))],
                           -1).astype(np.float32)
    present = rng.rand(b, a) > 0.3
    pos = np.concatenate([rng.uniform(-40, 40, (b, nl, 2)), rng.uniform(1, 6, (b, nl, 2)),
                          rng.uniform(-3, 3, (b, nl, 1))], -1).astype(np.float32)
    lights = rng.randint(0, 3, (b, nl)).astype(np.int32)

    road = JMesh.set_properties(JBaseMesh(verts=np.zeros((b, 3, 2), np.float32),
                                          faces=np.zeros((b, 1, 3), np.int32)), 'road')
    jgen = JGen(road, get_default_color_map(), get_default_rendering_levels())
    jgen.initialize_actors_mesh(lenwid, np.zeros((b, a), np.int32), ['vehicle'])
    jgen.initialize_traffic_controls_mesh({'traffic_light': JaxLightControl(pos)})
    want = jgen.generate_prims(jnp.asarray(state), present_mask=jnp.asarray(present),
                               traffic_light_state=jnp.asarray(lights))

    gen = BirdviewRGBMeshGenerator(get_default_color_map(), get_default_rendering_levels())
    gen.initialize_actors_mesh(_t(lenwid), torch.zeros((b, a), dtype=torch.int64),
                               ['vehicle'])
    gen.initialize_traffic_controls_mesh({'traffic_light': TrafficLightControl(pos, device='cpu')})
    got = gen.generate_prims(_t(state), present_mask=_t(present, torch.bool),
                             traffic_light_state=_t(lights, torch.int32))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def _jax_example():
    """The JAX package's behaviour-cloning example module."""
    import importlib
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, 'examples'))
    try:
        return importlib.import_module('imitation_learning')
    finally:
        sys.path.pop(0)


def test_generate_mesh_matches():
    """The per-camera RGB mesh of the differentiable render, two cameras per
    environment: the example's synthetic road (triangulated from its
    lanelets and collated), actors with absent ones collapsed, traffic
    lights by state and waypoint discs with a rendering mask."""
    from torchdrivesim_tpu.rendering.base import (
        get_default_color_map, get_default_rendering_levels)
    from torchdrivesim_tpu.scene_mesh import BirdviewRGBMeshGenerator as JGen
    from torchdrivesim_tpu_torch.imitation import build_synthetic_batch
    b, nc, a, nl, m = 2, 2, 3, 2, 3
    jroad = _jax_example().build_synthetic_batch(b, 1)[0]
    road = build_synthetic_batch(b, 1, device='cpu')[0]
    for name in ('verts', 'faces', 'vert_category'):
        np.testing.assert_array_equal(getattr(road, name),
                                      np.asarray(getattr(jroad, name)), err_msg=name)
    assert road.categories == jroad.categories

    rng = np.random.RandomState(6)
    lenwid = rng.uniform(1.5, 5.0, (b, a, 2)).astype(np.float32)
    state = np.concatenate([rng.uniform(-40, 40, (b, nc, a, 2)),
                            rng.uniform(-3, 3, (b, nc, a, 2))], -1).astype(np.float32)
    present = rng.rand(b, nc, a) > 0.3
    pos = np.concatenate([rng.uniform(-40, 40, (b, nl, 2)), rng.uniform(1, 6, (b, nl, 2)),
                          rng.uniform(-3, 3, (b, nl, 1))], -1).astype(np.float32)
    lights = rng.randint(0, 3, (b, nl)).astype(np.int32)
    waypoints = rng.uniform(-40, 40, (b, nc, m, 2)).astype(np.float32)
    wmask = rng.rand(b, nc, m) > 0.4
    cmap, levels = get_default_color_map(), get_default_rendering_levels()

    jgen = JGen(jroad, cmap, levels)
    jgen.initialize_actors_mesh(lenwid, np.zeros((b, a), np.int32), ['vehicle'])
    jgen.initialize_traffic_controls_mesh({'traffic_light': JaxLightControl(pos)})
    want = jgen.generate(nc, jnp.asarray(state), jnp.asarray(present),
                         jnp.asarray(lights), jnp.asarray(waypoints), jnp.asarray(wmask))
    gen = BirdviewRGBMeshGenerator(cmap, levels, background_mesh=road)
    gen.initialize_actors_mesh(_t(lenwid), torch.zeros((b, a), dtype=torch.int64),
                               ['vehicle'])
    gen.initialize_traffic_controls_mesh(
        {'traffic_light': TrafficLightControl(pos, device='cpu')})
    got = gen.generate(nc, _t(state), _t(present, torch.bool), _t(lights, torch.int32),
                       _t(waypoints), _t(wmask, torch.bool))
    for name in ('verts', 'faces', 'attrs'):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize('left_handed', [False, True])
def test_camera_rows_cols_match(left_handed):
    rng = np.random.RandomState(5)
    pts = rng.uniform(-60, 60, (3, 40, 2)).astype(np.float32)
    cam = rng.uniform(-10, 10, (3, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 3)
    sc = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    want = jax_rows_cols(jnp.asarray(pts), jnp.asarray(cam), jnp.asarray(sc),
                         2.0 / 70.0, 128, left_handed=left_handed)
    got = camera_rows_cols(_t(pts), _t(cam), _t(sc), 2.0 / 70.0, 128,
                           left_handed=left_handed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_map_grid_losses_match(maps):
    rng = np.random.RandomState(6)
    # agents around the map, some off the road and some off the grid
    xy = np.concatenate([rng.uniform(-20, 220, (4, 30, 2)),
                         rng.uniform(-400, 600, (4, 2, 2))], 1)
    state = np.concatenate([xy, rng.uniform(-np.pi, np.pi, (4, 32, 1)),
                            rng.uniform(0, 5, (4, 32, 1))], -1).astype(np.float32)
    lenwid = rng.uniform(2, 5, (4, 32, 2)).astype(np.float32)
    want_off = jax_offroad(maps['jgrids'], jnp.asarray(state), jnp.asarray(lenwid), 0.5)
    want_ww = jax_wrong_way(maps['jgrids'], jnp.asarray(state))
    got_off = offroad_loss_from_grid(maps['grids'], _t(state), _t(lenwid), 0.5)
    got_ww = wrong_way_loss_from_grid(maps['grids'], _t(state))
    np.testing.assert_allclose(got_off.numpy(), np.asarray(want_off), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(got_ww.numpy(), np.asarray(want_ww), atol=1e-5, rtol=0)
    assert (got_off.numpy() > 0).any() and (got_ww.numpy() > 0).any()


def test_collisions_and_red_lights_match(maps):
    rng = np.random.RandomState(7)
    b, a = 4, 12
    stop = np.asarray([[sl.x, sl.y, sl.length, sl.width, sl.orientation]
                       for sl in maps['cfg'].stoplines], np.float32)[None]
    # cars around the first stoplines so some overlap them and each other
    centers = np.repeat(stop[:, :6, :2], 2, axis=1)
    xy = centers + rng.randn(b, a, 2).astype(np.float32) * 3
    boxes = np.concatenate([xy, np.broadcast_to(np.asarray([4.97, 2.04], np.float32),
                                                (b, a, 2)),
                            rng.uniform(-np.pi, np.pi, (b, a, 1))], -1).astype(np.float32)
    present = rng.rand(b, a) > 0.2
    want = jax_collisions(jnp.asarray(boxes), jnp.asarray(present))
    got = compute_collision_matrix(_t(boxes), _t(present, torch.bool))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)
    assert (got.numpy() > 0).any()

    jctl = JaxLightControl(np.repeat(stop, b, 0))
    ctl = TrafficLightControl(np.repeat(stop, b, 0), device='cpu')
    lights = rng.randint(0, 3, (b, stop.shape[1])).astype(np.int32)
    want = jax_red_light(jnp.asarray(boxes), jctl.corners, jnp.asarray(lights), 0)
    got = red_light_violations(_t(boxes), ctl.corners, _t(lights, torch.int32), 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().any()


def test_heuristic_initialize_matches(maps):
    from torchdrivesim_tpu.behavior.heuristic import heuristic_initialize as jax_init
    from torchdrivesim_tpu_torch.behavior.heuristic import heuristic_initialize
    saved = random.getstate()
    try:
        random.seed(0)
        want = [jax_init(maps['jlanelets'], 20, min_speed=1, max_speed=8)
                for _ in range(2)]
    finally:
        random.setstate(saved)
    rng = random.Random(0)
    got = [heuristic_initialize(maps['lanelets'], 20, rng, min_speed=1, max_speed=8)
           for _ in range(2)]
    for (ga, gs), (wa, ws) in zip(got, want):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gs, ws)


def test_port_imports_no_jax():
    """The port and its entry points load without JAX or the JAX package."""
    import subprocess
    import sys
    code = ('import sys, torchdrivesim_tpu_torch.benchmark, '
            'torchdrivesim_tpu_torch.convert, torchdrivesim_tpu_torch.imitation, '
            'torchdrivesim_tpu_torch.models, torchdrivesim_tpu_torch.ops.soft, '
            'torchdrivesim_tpu_torch.ops.warp, torchdrivesim_tpu_torch.ops.fused, '
            'torchdrivesim_tpu_torch.ops.hard, torchdrivesim_tpu_torch.gym_env, '
            'torchdrivesim_tpu_torch.rl, torchdrivesim_tpu_torch.examples.simulate, '
            'torchdrivesim_tpu_torch.ops.point_mesh, '
            'torchdrivesim_tpu_torch.behavior.replay, '
            'torchdrivesim_tpu_torch.behavior.interaction, '
            'torchdrivesim_tpu_torch.behavior.iai, '
            'torchdrivesim_tpu_torch.examples.replay, '
            'torchdrivesim_tpu_torch.examples.imitation_learning, '
            'torchdrivesim_tpu_torch.observation_noise, '
            'torchdrivesim_tpu_torch.checkpoint, torchdrivesim_tpu_torch.validation, '
            'torchdrivesim_tpu_torch.iou_utils, torchdrivesim_tpu_torch.ops.hard_faces, '
            'torchdrivesim_tpu_torch.native, torchdrivesim_tpu_torch.map_grids, '
            'torchdrivesim_tpu_torch.examples.show_map, '
            'torchdrivesim_tpu_torch.examples.check_map_alignment; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "optax", "orbax", "torchdrivesim_tpu", '
            '"pandas", "imageio", "invertedai")]; '
            'assert not bad, bad')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, '-c', code], cwd=root, check=True,
                   timeout=120)


def test_entry_points_default_to_the_card():
    """The entry points build on the card unless the caller asks for the
    CPU; the constructors below them take the device from their inputs or
    from an argument without a default."""
    import inspect

    from torchdrivesim_tpu_torch import (
        benchmark, checkpoint, convert, gym_env, imitation, observation_noise, rl)
    from torchdrivesim_tpu_torch.behavior import iai
    from torchdrivesim_tpu_torch.behavior.interaction import INTERACTIONDataset
    from torchdrivesim_tpu_torch.behavior.replay import interaction_replay
    from torchdrivesim_tpu_torch.examples import imitation_learning, replay
    from torchdrivesim_tpu_torch.traffic_lights import (
        current_light_state_tensor_from_controller)
    from torchdrivesim_tpu_torch.rendering.renderer import Renderer
    from torchdrivesim_tpu_torch.traffic_controls import BaseTrafficControl
    for fn in (benchmark.build_benchmark_scenario, benchmark.build_il_scenario,
               convert.scenario_from_arrays, imitation.build_synthetic_batch,
               benchmark.build_rl_env, gym_env.build_gym_sim,
               gym_env.gym_sim_from_arrays, gym_env.VectorizedGymEnv, rl.build,
               imitation.build_dataset_batch, gym_env.GymEnv, gym_env.IAIGymEnv,
               interaction_replay, INTERACTIONDataset.collate, iai.iai_initialize,
               current_light_state_tensor_from_controller,
               observation_noise.StandardSensingObservationNoise,
               observation_noise.observation_noise_from_config,
               checkpoint.restore_checkpoint):
        assert inspect.signature(fn).parameters['device'].default == 'cuda', fn
    assert "device='cuda'" in inspect.getsource(rl.main)
    assert replay.parse_args(['--dataset-path', '.']).device == 'cuda'
    assert imitation_learning.parse_args([]).device == 'cuda'
    for fn in (K.KinematicBicycle, K.SimpleKinematicModel, K.BicycleNoReversing,
               Renderer, BaseTrafficControl, BakedLightSchedule):
        default = inspect.signature(fn).parameters['device'].default
        assert default is inspect.Parameter.empty, fn
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            imitation.build_synthetic_batch(2, 2)


def test_schedule_matches_host_ticking(maps):
    """The baked schedule reproduces ticking the host FSMs (dt keeps every
    tick >= 1e-4 s off Town02's whole-second phase boundaries, where the
    float64 host clock and the float32 lookup may fall on either side)."""
    from torchdrivesim_tpu_torch.traffic_lights import CONTROL_STATE_INDEX
    cfg = maps['cfg']
    ids = [sl.actor_id for sl in cfg.stoplines if sl.agent_type == 'traffic_light']
    ctrl = TrafficLightController.from_json(cfg.traffic_light_controller_path,
                                            random.Random(3))
    sched = BakedLightSchedule(ctrl, ids, device='cpu')
    dt = 0.3713
    for step in range(300):
        want = [CONTROL_STATE_INDEX[ctrl.current_state[str(i)].name] for i in ids]
        got = sched.states_at(torch.tensor(step * dt, dtype=torch.float32))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f't={step * dt}')
        ctrl.tick(dt)
