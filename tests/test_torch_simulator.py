"""
The port's stateful ``Simulator`` facade against the JAX package's, on one
small Town02 world built from the same numpy arrays: B = 2 environments of
4 agents (one a pedestrian with a NaN ``agent_lr``, one turned against its
lane, one pushed off the road) and 1 NPC overlapping agent 0, replayed
traffic lights, waypoint goals of 6 collections of 2 waypoints, the baked
grids, the road mesh, the lanelet map and the texture.

The port's facade steps 5 times under seeded actions beside the JAX
package's step function (``functional_step``, which its facade's ``step``
runs; jitted, as are its getters and metrics, since eager JAX compiles
every small op); the states, the
waypoint state, every getter and the four ``compute_*`` metrics (collision
under all four metrics; offroad by grid and by the exact mesh distance;
wrong-way by grid and by host lanelet queries) agree to 1e-4 absolute plus
1e-4 relative after every step. ``render_egocentric`` agrees on at least
99.9% of the pixels at ``n_subsequent_waypoints`` 1 (30 triangles per
camera) and 5 (110 triangles: past the per-type cap of 56, the fused
render's sort route), the JAX package on its TPU path (``_on_tpu``
patched before the texture is set, ``pallas_call`` in interpret mode, the
render jitted).
"""
import functools
import logging
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

B, A, N_COLL, M_WP, RES, FOV, STEPS = 2, 4, 6, 2, 64, 70.0, 5
TYPES = ['vehicle', 'pedestrian']


def world_arrays():
    """The shared world as numpy arrays."""
    from torchdrivesim_tpu_torch.behavior.heuristic import heuristic_initialize
    from torchdrivesim_tpu_torch.map import find_map_config
    cfg = find_map_config('carla_Town02')
    rng = random.Random(3)
    layouts = [heuristic_initialize(cfg.lanelet_map, A, rng, min_speed=1, max_speed=8)
               for _ in range(B)]
    attrs = np.concatenate([a for a, _ in layouts]).astype(np.float32)
    states = np.concatenate([s for _, s in layouts]).astype(np.float32)
    states[:, 2, 2] += np.pi                       # against its lane
    psi = states[:, 3, 2]
    states[:, 3, 0] -= 7.0 * np.sin(psi)           # off the road
    states[:, 3, 1] += 7.0 * np.cos(psi)
    head = np.stack([np.cos(states[..., 2]), np.sin(states[..., 2])], -1)
    npc_state = states[:, :1].copy()               # overlapping agent 0
    npc_state[..., :2] += 1.5 * head[:, :1]
    npc_state[..., 2] += 0.3
    states[:, 1, :2] = states[:, 2, :2] + 1.2 * head[:, 2]   # over agent 2
    nrng = np.random.RandomState(0)
    dist = np.sort(nrng.uniform(10, 60, (B, A, N_COLL, M_WP)), axis=2)
    dist[:, 0, 0, 0] = 1.0                         # reached at the first step
    waypoints = states[:, :, None, None, :2] + dist[..., None] * head[:, :, None, None]
    lr = attrs[..., 2].copy()
    agent_lr = lr.copy()
    agent_lr[:, 1] = np.nan                        # the pedestrian's
    rows = [[sl.x, sl.y, sl.length, sl.width, sl.orientation] for sl in cfg.stoplines
            if sl.agent_type == 'traffic_light']
    light_pos = np.repeat(np.asarray(rows, np.float32)[None], B, axis=0)
    replay = nrng.randint(0, 3, (B, len(rows), 4)).astype(np.int32)
    return dict(
        agent_state=states, agent_size=attrs[..., :2], lr=lr, agent_lr=agent_lr,
        agent_types=np.asarray([[0, 1, 0, 0]] * B, np.int32),
        npc_state=npc_state.astype(np.float32),
        npc_size=np.full((B, 1, 2), [4.0, 2.0], np.float32),
        waypoints=waypoints.astype(np.float32), light_pos=light_pos,
        light_replay=replay)


def port_simulator(a, collision_metric='discs', renderer_config=None):
    import torchdrivesim_tpu_torch.kinematic as K
    from torchdrivesim_tpu_torch.benchmark import load_or_bake_texture
    from torchdrivesim_tpu_torch.goals import WaypointGoal
    from torchdrivesim_tpu_torch.map import find_map_config
    from torchdrivesim_tpu_torch.simulator import (
        CollisionMetric, NPCController, Simulator, TorchDriveConfig)
    from torchdrivesim_tpu_torch.traffic_controls import TrafficLightControl
    from torchdrivesim_tpu_torch.utils import Resolution
    cfg_map = find_map_config('carla_Town02')
    kin = K.KinematicBicycle(dt=0.1, device='cpu')
    kin.set_params(lr=a['lr'])
    kin.set_state(a['agent_state'])
    cfg = TorchDriveConfig(collision_metric=CollisionMetric(collision_metric))
    if renderer_config is not None:
        cfg.renderer = renderer_config
    sim = Simulator(
        road_mesh=cfg_map.road_mesh, kinematic_model=kin, agent_size=a['agent_size'],
        initial_present_mask=np.ones((B, A), bool), cfg=cfg,
        lanelet_map=[cfg_map.lanelet_map] * B,
        traffic_controls={'traffic_light': TrafficLightControl(
            a['light_pos'], replay_states=a['light_replay'], device='cpu')},
        waypoint_goals=WaypointGoal(a['waypoints']), agent_types=a['agent_types'],
        agent_type_names=TYPES, agent_lr=a['agent_lr'],
        npc_controller=NPCController(torch.from_numpy(a['npc_size']),
                                     torch.from_numpy(a['npc_state'])),
        map_grids=cfg_map.grids(device='cpu'))
    sim.renderer.res = Resolution(RES, RES)
    sim.renderer.scale = 2.0 / FOV
    sim.renderer.background_texture = load_or_bake_texture(cfg_map)
    return sim


@pytest.fixture(scope='module')
def jax_sim():
    """The JAX facade on the same world, its render in interpret mode with
    the mip pyramid built (as on a TPU), and jitted egocentric renders."""
    import torchdrivesim_tpu.kinematic as JK
    import torchdrivesim_tpu.ops.pallas_fused as F
    import torchdrivesim_tpu.ops.pallas_rasterize as R
    import torchdrivesim_tpu.ops.pallas_warp as W
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from torchdrivesim_tpu.benchmark import load_or_bake_texture
    from torchdrivesim_tpu.goals import WaypointGoal
    from torchdrivesim_tpu.map import find_map_config
    from torchdrivesim_tpu.rendering import JaxRendererConfig
    from torchdrivesim_tpu.simulator import NPCController, Simulator, TorchDriveConfig
    from torchdrivesim_tpu.traffic_controls import TrafficLightControl
    from torchdrivesim_tpu.utils import Resolution
    a = world_arrays()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jr, '_on_tpu', lambda: True)
        for mod in (W, R, F):
            m.setattr(mod.pl, 'pallas_call',
                      functools.partial(mod.pl.pallas_call, interpret=True))
        cfg_map = find_map_config('carla_Town02')
        kin = JK.KinematicBicycle(dt=0.1)
        kin.set_params(lr=jnp.asarray(a['lr']))
        kin.set_state(jnp.asarray(a['agent_state']))
        cfg = TorchDriveConfig()
        cfg.renderer = JaxRendererConfig()
        sim = Simulator(
            road_mesh=cfg_map.road_mesh.expand(B), kinematic_model=kin,
            agent_size=a['agent_size'], initial_present_mask=np.ones((B, A), bool),
            cfg=cfg, lanelet_map=[cfg_map.lanelet_map] * B,
            traffic_controls={'traffic_light': TrafficLightControl(
                a['light_pos'], replay_states=a['light_replay'])},
            waypoint_goals=WaypointGoal(a['waypoints']), agent_types=a['agent_types'],
            agent_type_names=TYPES, agent_lr=a['agent_lr'],
            npc_controller=NPCController(a['npc_size'], a['npc_state']),
            map_grids=cfg_map.grids())
        sim.renderer.res = Resolution(RES, RES)
        sim.renderer.scale = 2.0 / FOV
        sim.renderer.background_texture = load_or_bake_texture(
            cfg_map, sim.renderer.color_map, sim.renderer.rendering_levels)

        def with_state(fn):
            def run(state):
                saved = sim.state
                sim.state = state
                try:
                    return fn()
                finally:
                    sim.state = saved
            return run

        from torchdrivesim_tpu.simulator import CollisionMetric
        renders = {count: jax.jit(with_state(functools.partial(
            sim.render_egocentric, fov=FOV, n_subsequent_waypoints=count)))
            for count in (1, 5)}
        device_metrics = jax.jit(with_state(lambda: metrics(sim, CollisionMetric)))
        host_metrics = with_state(lambda: host_side_metrics(sim))
        yield (a, sim, renders, jax.jit(sim.functional_step),
               lambda state: {**device_metrics(state), **host_metrics(state)})


def close(got, want, name):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                               atol=1e-4, rtol=1e-4, err_msg=name)


GETTERS = ('get_state', 'get_waypoints_state', 'get_agent_size', 'get_agent_type',
           'get_agent_lr', 'get_present_mask', 'get_npc_state', 'get_npc_size',
           'get_npc_present_mask', 'get_npc_types', 'get_all_agent_state',
           'get_all_agent_size', 'get_all_agent_present_mask', 'get_all_agent_type',
           'get_all_agents_absolute', 'get_traffic_light_state', 'get_world_center')
COLLISIONS = ('discs', 'iou', 'nograd', 'nograd-pytorch3d')


def metrics(sim, metric_enum):
    """The facade's getters and metrics that run on the device, by name."""
    out = {g: getattr(sim, g)() for g in GETTERS}
    out.update(waypoints=sim.get_waypoints(count=2),
               waypoints_mask=sim.get_waypoints_mask(count=2),
               relative=sim.get_all_agents_relative(),
               relative_with_self=sim.get_all_agents_relative(exclude_self=False),
               offroad_grid=sim.compute_offroad(),
               wrong_way_grid=sim.compute_wrong_way(),
               red_light=sim.compute_traffic_lights_violations())
    for name in COLLISIONS:
        sim.cfg.collision_metric = metric_enum(name)
        out[f'collision_{name}'] = sim.compute_collision()
        if name in ('discs', 'iou'):
            out[f'collision_{name}_vehicles'] = sim.compute_collision(
                agent_types=['vehicle'])
    sim.cfg.collision_metric = metric_enum('discs')
    grids, sim.map_grids = sim.map_grids, None
    out['offroad_exact'] = sim.compute_offroad()
    sim.map_grids = grids
    return out


def host_side_metrics(sim):
    """The wrong-way loss by host lanelet queries and the world center."""
    grids, sim.map_grids = sim.map_grids, None
    out = {'wrong_way_lanelets': sim.compute_wrong_way(),
           'get_world_center': sim.get_world_center()}
    sim.map_grids = grids
    return out


def test_facade_steps_match_jax(jax_sim):
    """Five steps of the port's facade (``step``) against the JAX
    package's step function (``functional_step``, which its ``step``
    runs), every getter and metric compared after each."""
    from torchdrivesim_tpu_torch.simulator import CollisionMetric
    a, jsim, _, jstep, jmetrics = jax_sim
    sim = port_simulator(a)
    jstate = jsim.state
    rng = np.random.RandomState(1)
    seen = {}
    for step in range(STEPS + 1):
        if step:
            act = rng.uniform(-1, 1, (B, A, 2)).astype(np.float32)
            jstate = jstep(jstate, jnp.asarray(act))
            sim.step(torch.from_numpy(act))
        got = {**metrics(sim, CollisionMetric), **host_side_metrics(sim)}
        want = jmetrics(jstate)
        assert set(got) == set(want)
        for name, w in want.items():
            close(got[name], w, f'step {step}: {name}')
            seen[name] = seen.get(name, 0.0) + float(np.abs(np.nan_to_num(
                np.asarray(w, np.float64))).sum())
    # the world exercises every metric: each is nonzero at some step
    for name in ('offroad_grid', 'offroad_exact', 'wrong_way_grid',
                 'wrong_way_lanelets', 'red_light', 'collision_discs',
                 'collision_iou', 'collision_nograd', 'collision_nograd-pytorch3d'):
        assert seen[name] > 0, name
    assert int(sim.get_waypoints_state()[0, 0, 0]) == 1
    assert sim.internal_time == STEPS
    # the pedestrian's NaN lr stays in get_agent_lr
    for name in ('get_all_agents_absolute', 'get_all_agent_state'):
        assert torch.isfinite(getattr(sim, name)()).all(), name
    assert torch.isfinite(sim.fit_action(sim.get_state())).all()


@pytest.mark.parametrize('count', [1, 5])
def test_render_egocentric_matches_jax(jax_sim, count):
    a, jsim, renders, _, _ = jax_sim
    sim = port_simulator(a)
    prims, _ = sim.egocentric_prim_frame(fov=FOV, n_subsequent_waypoints=count)
    n_tris = prims[4].shape[1]
    assert n_tris == A + 1 + count * M_WP * 10
    assert (n_tris > sim.renderer._prim_cap) == (count == 5)
    want = np.asarray(renders[count](jsim.state))
    got = sim.render_egocentric(fov=FOV, n_subsequent_waypoints=count).numpy()
    assert got.shape == want.shape == (B, A, 3, RES, RES)
    same = (got == want).all(axis=2)
    print(f'M = {count}: {int(same.sum())} of {same.size} pixels identical')
    assert same.mean() >= 0.999
    waypoint = np.asarray(sim.renderer.color_map['goal_waypoint'], np.float32)
    assert ((got - waypoint[:, None, None]) == 0).all(axis=2).any()


def test_fused_routes_are_bit_equal_under_the_cap():
    """A frame under the cap gives the same image through the prep route
    and, forced, through the sort route."""
    from torchdrivesim_tpu_torch.ops.fused import render_coefs_fused
    sim = port_simulator(world_arrays())
    prims, cams = sim.egocentric_prim_frame(fov=FOV)
    images = []
    for force in (False, True):
        mip, ops, size, n, _ = sim.renderer.fused_frame_operands(
            *prims, RES, cams, force_sort=force)
        images.append(render_coefs_fused(mip, *ops, size))
    assert torch.equal(images[0], images[1])


def test_sort_route_warns_once(caplog):
    sim = port_simulator(world_arrays())
    with caplog.at_level(logging.WARNING, 'torchdrivesim_tpu_torch.rendering.renderer'):
        sim.render_egocentric(fov=FOV, n_subsequent_waypoints=5)
        sim.render_egocentric(fov=FOV, n_subsequent_waypoints=5)
    assert sum('sorts and caps' in r.message for r in caplog.records) == 1


def test_single_agent_rendering_shows_own_agent_and_npcs():
    a = world_arrays()
    sim = port_simulator(a)
    sim.cfg.single_agent_rendering = True
    got = sim.render_egocentric(fov=FOV)
    sim.cfg.single_agent_rendering = False
    own = torch.cat([torch.eye(A, dtype=torch.bool), torch.ones((A, 1), dtype=torch.bool)],
                    dim=-1)
    want = sim.render_egocentric(fov=FOV, visibility_matrix=own[None].expand(B, A, A + 1))
    assert torch.equal(got, want)
    assert not torch.equal(got, sim.render_egocentric(fov=FOV))


def test_set_state_with_mask_and_present_mask():
    sim = port_simulator(world_arrays())
    before = sim.get_state().clone()
    mask = torch.tensor([[True, False, True, False]] * B)
    sim.set_state(torch.zeros((B, A, 3)), mask=mask)
    s = sim.get_state()
    assert torch.equal(s[mask][:, :3], torch.zeros((int(mask.sum()), 3)))
    assert torch.equal(s[mask][:, 3], before[mask][:, 3])      # speed kept
    assert torch.equal(s[~mask], before[~mask])
    assert torch.equal(sim.kinematic_model.get_state(), s)
    present = torch.tensor([[True, True, False, True]] * B)
    sim.update_present_mask(present)
    assert torch.equal(sim.get_present_mask(), present)
    assert (sim.compute_offroad()[:, 2] == 0).all()
    with pytest.raises(AssertionError):
        sim.update_present_mask(torch.ones((B, A + 1), dtype=torch.bool))


def test_copy_is_independent():
    sim = port_simulator(world_arrays())
    other = sim.copy()
    state = sim.get_state().clone()
    lights = sim.get_traffic_light_state().clone()
    for _ in range(3):
        other.step(torch.ones((B, A, 2)))
    assert torch.equal(sim.get_state(), state)
    assert torch.equal(sim.get_traffic_light_state(), lights)
    assert torch.equal(sim.kinematic_model.get_state(), state)
    assert int(sim.get_waypoints_state().sum()) == 0
    assert not torch.equal(other.get_state(), state)
    other.extend(2)
    assert sim.batch_size == B and other.batch_size == 2 * B
    assert sim.traffic_controls['traffic_light'].pos.shape[0] == B


def test_extend_select_getitem():
    sim = port_simulator(world_arrays())
    sim.step(torch.full((B, A, 2), 0.3))
    big = sim.extend(3, in_place=False)
    assert sim.batch_size == B and big.batch_size == 3 * B
    assert len(big.lanelet_map) == 3 * B
    for name in GETTERS:
        got, want = getattr(big, name)(), getattr(sim, name)()
        torch.testing.assert_close(got, torch.repeat_interleave(want, 3, dim=0),
                                   equal_nan=True, msg=name)
    pick = big[[5, 0]]
    assert pick.batch_size == 2 and big.batch_size == 3 * B
    assert torch.equal(pick.get_state(), sim.get_state()[[1, 0]])
    big.select_batch_elements(torch.tensor([3]))
    assert big.batch_size == 1
    act = torch.full((1, A, 2), -0.5)
    big.step(act)
    alone = sim[1]
    alone.step(act)
    assert torch.equal(big.get_state(), alone.get_state())
    assert big.render_egocentric(fov=FOV, n_subsequent_waypoints=5).shape == \
        (1, A, 3, RES, RES)
    for name in ('compute_offroad', 'compute_wrong_way', 'compute_collision',
                 'compute_traffic_lights_violations', 'get_all_agents_relative'):
        torch.testing.assert_close(getattr(big, name)(), getattr(alone, name)(),
                                   msg=name)


def test_check_prim_budget_warns_and_raises(caplog):
    sim = port_simulator(world_arrays())
    gen = sim.birdview_mesh_generator
    q, t = gen.worst_case_prim_counts(A)
    assert (q, t) == (A + 1 + sim.traffic_controls['traffic_light'].pos.shape[1],
                      A + 1 + A * 10)
    with caplog.at_level(logging.WARNING, 'torchdrivesim_tpu_torch.simulator'):
        sim.check_prim_budget()
    assert not any('prim budget' in r.message for r in caplog.records)
    sim.renderer.cfg.band_budget = 8
    with caplog.at_level(logging.WARNING, 'torchdrivesim_tpu_torch.simulator'):
        sim.check_prim_budget(waypoint_count=A)
    assert any('prim budget' in r.message for r in caplog.records)
    with pytest.raises(ValueError, match='prim budget'):
        sim.check_prim_budget(waypoint_count=A, strict=True)


def test_prim_budget_guard_fires_at_construction(caplog):
    import torchdrivesim_tpu_torch.kinematic as K
    from torchdrivesim_tpu_torch.simulator import Simulator, TorchDriveConfig
    n = 60
    kin = K.KinematicBicycle(dt=0.1, device='cpu')
    kin.set_state(np.zeros((1, n, 4), np.float32))
    with caplog.at_level(logging.WARNING, 'torchdrivesim_tpu_torch.simulator'):
        Simulator(road_mesh=None, kinematic_model=kin, agent_size=np.ones((1, n, 2)),
                  initial_present_mask=np.ones((1, n), bool), cfg=TorchDriveConfig())
    assert any('prim budget' in r.message for r in caplog.records)


def test_unported_options_raise(jax_sim):
    """The options that raised until they were ported now run and match the
    JAX package: a simulator built with lane features and an observation
    noise model (the exact world) gives the reference's ``get_noisy_*``
    views (1e-4), and ``render_egocentric(noisy_perception=True)`` (the mesh
    path over the texture) >= 99.9% of the reference's pixels."""
    import torchdrivesim_tpu_torch.kinematic as K
    from torchdrivesim_tpu_torch.lanelet2 import LaneFeatures
    from torchdrivesim_tpu_torch.observation_noise import (
        ObservationNoise, ObservationNoiseConfig)
    from torchdrivesim_tpu_torch.simulator import Simulator, TorchDriveConfig
    a, jsim, _, _, _ = jax_sim
    sim = port_simulator(a)
    lanes = LaneFeatures(torch.zeros((B, 3, 4)), torch.ones((B, 3), dtype=torch.bool))
    model = ObservationNoise(ObservationNoiseConfig())
    kin = K.KinematicBicycle(dt=0.1, device='cpu')
    kin.set_state(a['agent_state'])
    built = Simulator(road_mesh=None, kinematic_model=kin, agent_size=a['agent_size'],
                      initial_present_mask=np.ones((B, A), bool), cfg=TorchDriveConfig(),
                      lane_features=lanes, observation_noise_model=model)
    assert built.lane_features is lanes and built.observation_noise_model is model
    assert built.get_noisy_lane_features() is lanes
    sim.lane_features, sim.observation_noise_model = lanes, model
    for name in ('get_noisy_state', 'get_noisy_agent_size', 'get_noisy_present_mask',
                 'get_noisy_all_agents_absolute', 'get_noisy_all_agents_relative'):
        close(getattr(sim, name)(), getattr(jsim, name)(), name)
    want = np.asarray(jax.jit(functools.partial(
        jsim.render_egocentric, fov=FOV, noisy_perception=True))())
    got = sim.render_egocentric(fov=FOV, noisy_perception=True).numpy()
    assert got.shape == want.shape == (B, A, 3, RES, RES)
    same = (got == want).all(axis=2)
    print(f'noisy perception: {int(same.sum())} of {same.size} pixels identical')
    assert same.mean() >= 0.999


def test_host_wrong_way_warns_above_64_agents(caplog):
    sim = port_simulator(world_arrays())
    sim.map_grids = None
    with caplog.at_level(logging.WARNING, 'torchdrivesim_tpu_torch.simulator'):
        sim.compute_wrong_way()
    assert not any('host lanelet path' in r.message for r in caplog.records)
    big = sim.extend(9, in_place=False)          # 18 x 4 = 72 agents
    with caplog.at_level(logging.WARNING, 'torchdrivesim_tpu_torch.simulator'):
        big.compute_wrong_way()
        big.compute_wrong_way()
    assert sum('host lanelet path' in r.message for r in caplog.records) == 1


def test_example_runs_on_the_cpu(tmp_path, capsys):
    from torchdrivesim_tpu_torch.examples import simulate
    out = tmp_path / 'frames.npz'
    simulate.main(['--device', 'cpu', '--steps', '3', '--res', '64', '--agents', '3',
                   '--out', str(out)])
    with np.load(out) as data:
        frames = data['frames']
    assert frames.shape == (3, 64, 64, 3) and frames.dtype == np.uint8
    printed = capsys.readouterr().out
    assert 't=0: offroad=' in printed and 'collision=' in printed


def test_example_needs_a_card_by_default():
    from torchdrivesim_tpu_torch.examples import simulate
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='--device cpu'):
        simulate.main(['--steps', '1'])
