"""
The port's NPC controllers against the JAX package's: ``SpawnController``
(despawning outside the exit boundary, timed spawns), ``ReplayController``
(the table indexed at (time + start) mod T), ``CompoundNPCController``
(per-slot routing), ``Simulator.functional_step`` with each, the facade's
``advance_npcs`` and ``spawn_despawn_npcs``, ``copy``, ``extend`` and
``select_batch_elements`` of the controllers and of a simulator holding
them, and ``behavior.replay.interaction_replay`` on a written recording
(track ids out of order), all on seeded numpy inputs. States to 1e-4,
masks exactly; loaded recordings exactly but for one float32 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

B, A, N, T = 2, 2, 3, 4
TYPES = ['vehicle', 'pedestrian']


def _tables(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        size=rng.uniform(1, 5, (B, N, 2)).astype(np.float32),
        state=rng.uniform(-10, 10, (B, N, 4)).astype(np.float32),
        states=rng.uniform(-10, 10, (B, N, T, 4)).astype(np.float32),
        masks=rng.rand(B, N, T) > 0.3,
        boundary=np.asarray([[[-6., -6.], [6., -6.], [6., 6.], [-6., 6.]]] * B,
                            np.float32),
        spawn_states=rng.uniform(-3, 3, (B, N, T, 4)).astype(np.float32),
        spawn_masks=rng.rand(B, N, T) > 0.5,
        indices=np.asarray([[0, 1, 2], [2, 2, 0]]),
        types=np.asarray([[0, 1, 0], [1, 0, 0]], np.int32))


def _controllers(mod, d, as_array):
    """The controllers of module ``mod`` (either package's ``simulator``)
    on the tables ``d``, their arrays made by ``as_array``."""
    a = {k: as_array(v) for k, v in d.items()}
    spawn = lambda: mod.SpawnController(exit_boundary=a['boundary'],
                                        spawn_states=a['spawn_states'],
                                        spawn_masks=a['spawn_masks'])
    static = mod.NPCController(a['size'], a['state'], npc_types=a['types'],
                               spawn_controller=spawn())
    replay = mod.ReplayController(a['size'], a['states'], a['masks'], time=1)
    spawned_replay = mod.ReplayController(a['size'] * 2, a['states'] * 0.5, time=3,
                                          spawn_controller=spawn())
    return {'static': static, 'replay': replay, 'spawned_replay': spawned_replay,
            'compound': mod.CompoundNPCController([static, replay, spawned_replay],
                                                  a['indices'])}


def _port(d):
    import torchdrivesim_tpu_torch.simulator as S
    return _controllers(S, d, torch.as_tensor)


def _jax(d):
    import torchdrivesim_tpu.simulator as S
    return _controllers(S, d, jnp.asarray)


def close(got, want, name):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=name)


def test_spawn_controller_matches_jax():
    from torchdrivesim_tpu.simulator import SpawnController as JaxSpawn
    from torchdrivesim_tpu_torch.simulator import SpawnController
    d = _tables()
    got = SpawnController(d['boundary'], d['spawn_states'], d['spawn_masks'])
    want = JaxSpawn(jnp.asarray(d['boundary']), jnp.asarray(d['spawn_states']),
                    jnp.asarray(d['spawn_masks']))
    mask = np.ones((B, N), bool)
    mask[0, 0] = False
    outside = 0
    for t in range(T + 2):       # past the table's end, time clamps
        s, m = got.apply(torch.from_numpy(d['state']), torch.from_numpy(mask),
                         torch.tensor(t))
        ws, wm = want.apply(jnp.asarray(d['state']), jnp.asarray(mask), t)
        close(s, ws, f't={t} state')
        close(m, wm, f't={t} mask')
        outside += int((~np.asarray(wm) & mask).sum())
    assert outside > 0                       # some NPC despawned
    despawn = SpawnController(exit_boundary=d['boundary'])
    _, m = despawn.apply(torch.from_numpy(d['state']), torch.ones((B, N), dtype=torch.bool),
                         0)
    inside = (np.abs(d['state'][..., :2]) <= 6).all(-1)
    np.testing.assert_array_equal(m.numpy(), inside)


@pytest.mark.parametrize('kind', ['static', 'replay', 'spawned_replay', 'compound'])
def test_controller_advance_matches_jax(kind):
    """Each controller's advance over times 0..2T+1 (the replay wraps
    twice), from the initial states, against the JAX package's."""
    d = _tables()
    got, want = _port(d)[kind], _jax(d)[kind]
    close(got.initial_npc_state, want.initial_npc_state, 'initial state')
    close(got.initial_npc_present_mask, want.initial_npc_present_mask, 'initial mask')
    close(got.npc_size, want.npc_size, 'size')
    close(got.npc_types, want.npc_types, 'types')
    for t in range(2 * T + 2):
        s, m = got.advance(got.initial_npc_state, got.initial_npc_present_mask,
                           torch.tensor(t, dtype=torch.int32))
        ws, wm = want.advance(want.initial_npc_state, want.initial_npc_present_mask,
                              jnp.asarray(t, jnp.int32))
        close(s, ws, f'{kind} t={t} state')
        close(m, wm, f'{kind} t={t} mask')


def test_replay_wraps_around():
    from torchdrivesim_tpu_torch.simulator import ReplayController
    states = torch.tensor([[[[0., 0, 0, 0], [1, 0, 0, 0], [2, 0, 0, 0]]]])
    rc = ReplayController(torch.full((1, 1, 2), 2.0), states, time=1)
    assert float(rc.initial_npc_state[0, 0, 0]) == 1.0
    seen = [float(rc.advance(None, None, torch.tensor(t))[0][0, 0, 0]) for t in range(5)]
    assert seen == [1.0, 2.0, 0.0, 1.0, 2.0]


def _simulators(d, kind):
    """The port's and the JAX package's simulators of B environments of A
    bicycles with the controller ``kind`` of the tables ``d``."""
    import torchdrivesim_tpu.kinematic as JK
    import torchdrivesim_tpu_torch.kinematic as K
    from torchdrivesim_tpu.rendering import DummyRendererConfig
    from torchdrivesim_tpu.simulator import Simulator as JaxSimulator
    from torchdrivesim_tpu.simulator import TorchDriveConfig as JaxConfig
    from torchdrivesim_tpu_torch.simulator import Simulator, TorchDriveConfig
    import torchdrivesim_tpu.mesh as JM
    import torchdrivesim_tpu_torch.mesh as PM
    rng = np.random.RandomState(5)
    agents = rng.uniform(-5, 5, (B, A, 4)).astype(np.float32)
    square = (np.asarray([[-20., -20.], [20., -20.], [20., 20.], [-20., 20.]], np.float32),
              np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))
    road = lambda M: M.BirdviewMesh.set_properties(M.BaseMesh(*square), 'road').expand(B)
    size = np.full((B, A, 2), [4.0, 2.0], np.float32)
    kin = K.KinematicBicycle(dt=0.1, device='cpu')
    kin.set_state(agents)
    sim = Simulator(road_mesh=road(PM), kinematic_model=kin, agent_size=size,
                    initial_present_mask=np.ones((B, A), bool), cfg=TorchDriveConfig(),
                    npc_controller=_port(d)[kind], agent_type_names=TYPES)
    jkin = JK.KinematicBicycle(dt=0.1)
    jkin.set_state(jnp.asarray(agents))
    cfg = JaxConfig()
    cfg.renderer = DummyRendererConfig()
    jsim = JaxSimulator(road_mesh=road(JM), kinematic_model=jkin, agent_size=size,
                        initial_present_mask=np.ones((B, A), bool), cfg=cfg,
                        npc_controller=_jax(d)[kind], agent_type_names=TYPES)
    return sim, jsim


def _compare_states(sim, jstate, name):
    for field in ('agent_state', 'npc_state', 'npc_present_mask', 'npc_time', 'time'):
        close(getattr(sim.state, field), getattr(jstate, field), f'{name} {field}')


@pytest.mark.parametrize('kind', ['static', 'replay', 'spawned_replay', 'compound'])
def test_functional_step_with_each_controller(kind):
    """Six facade steps (``step``, which runs ``functional_step``) under
    seeded actions against the JAX package's jitted ``functional_step``."""
    d = _tables()
    sim, jsim = _simulators(d, kind)
    jstep = jax.jit(jsim.functional_step)
    jstate = jsim.state
    rng = np.random.RandomState(2)
    for step in range(6):
        act = rng.uniform(-1, 1, (B, A, 2)).astype(np.float32)
        sim.step(torch.from_numpy(act))
        jstate = jstep(jstate, jnp.asarray(act))
        _compare_states(sim, jstate, f'{kind} step {step}')
    close(sim.get_all_agent_state(), jnp.concatenate(
        [jstate.agent_state, jstate.npc_state], axis=-2), 'all agents')


def test_facade_npc_conveniences_match_jax():
    """``advance_npcs`` (the controller clock and the NPCs one step on) and
    ``spawn_despawn_npcs`` on the facade's state."""
    d = _tables()
    sim, jsim = _simulators(d, 'compound')
    for i in range(3):
        sim.npc_controller.advance_npcs(sim)
        jsim.npc_controller.advance_npcs(jsim)
        _compare_states(sim, jsim.state, f'advance_npcs {i}')
    sim.npc_controller.controllers[0].spawn_despawn_npcs(sim)
    jsim.npc_controller.controllers[0].spawn_despawn_npcs(jsim)
    _compare_states(sim, jsim.state, 'spawn_despawn_npcs')


@pytest.mark.parametrize('kind', ['static', 'replay', 'spawned_replay', 'compound'])
def test_batch_operations_carry_the_tables(kind):
    """``copy``, ``extend`` and ``select_batch_elements`` of each controller
    and of a simulator holding it, against the JAX package's: the advance
    of the result over a wrap of the tables, and the copy's independence."""
    d = _tables()
    got, want = _port(d)[kind], _jax(d)[kind]
    for name, g, w in (
            ('copy', got.copy(), want.copy()),
            ('extend', got.extend(3, in_place=False), want.extend(3, in_place=False)),
            ('select', got.extend(2, in_place=False).select_batch_elements(
                [3, 0, 0], in_place=False),
             want.extend(2, in_place=False).select_batch_elements(
                 np.asarray([3, 0, 0]), in_place=False))):
        close(g.initial_npc_state, w.initial_npc_state, f'{kind} {name} initial')
        for t in range(T + 1):
            s, m = g.advance(g.initial_npc_state, g.initial_npc_present_mask,
                             torch.tensor(t))
            ws, wm = w.advance(w.initial_npc_state, w.initial_npc_present_mask, t)
            close(s, ws, f'{kind} {name} t={t} state')
            close(m, wm, f'{kind} {name} t={t} mask')
    assert got.initial_npc_state.shape[0] == B            # in_place=False kept it

    sim, jsim = _simulators(d, kind)
    big = sim.extend(2, in_place=False)
    jbig = jsim.extend(2, in_place=False)
    pick = big[[3, 1]]
    jpick = jbig.select_batch_elements(np.asarray([3, 1]), in_place=False)
    other = pick.copy()
    act = np.full((2, A, 2), 0.3, np.float32)
    for step in range(T + 1):
        pick.step(torch.from_numpy(act))
        jpick.step(jnp.asarray(act))
        _compare_states(pick, jpick.state, f'{kind} selected step {step}')
    assert int(other.state.npc_time) == 0 and sim.batch_size == B


def _write_recording(path, seed=0):
    """A vehicle_tracks CSV in the INTERACTION layout with track ids and
    rows out of order, three decimals as the dataset writes them."""
    import csv
    rng = np.random.RandomState(seed)
    rows = []
    for track_id, first, count in ((7, 1, 12), (3, 2, 8), (12, 1, 12), (5, 4, 5)):
        x0, y0 = rng.uniform(-50, 50, 2)
        vx, vy = rng.uniform(-5, 5, 2)
        length, width = rng.uniform(3, 5), rng.uniform(1.5, 2.2)
        for f in range(first, first + count):
            rows.append([track_id, f, f * 100, 'car', f'{x0 + 0.1 * vx * f:.3f}',
                         f'{y0 + 0.1 * vy * f:.3f}', f'{vx:.3f}', f'{vy:.3f}',
                         f'{np.arctan2(vy, vx):.3f}', f'{length + 0.01 * f:.3f}',
                         f'{width:.3f}'])
    order = rng.permutation(len(rows))
    with open(path, 'w', newline='') as f:
        out = csv.writer(f)
        out.writerow(['track_id', 'frame_id', 'timestamp_ms', 'agent_type', 'x', 'y',
                      'vx', 'vy', 'psi_rad', 'length', 'width'])
        out.writerows(rows[i] for i in order)


def test_interaction_replay_matches_jax(tmp_path):
    from torchdrivesim_tpu.behavior.replay import interaction_replay as jax_replay
    from torchdrivesim_tpu_torch.behavior.common import InitializationFailedError
    from torchdrivesim_tpu_torch.behavior.replay import interaction_replay
    folder = tmp_path / 'recorded_trackfiles' / 'loc'
    folder.mkdir(parents=True)
    _write_recording(folder / 'vehicle_tracks_002.csv')
    for first, length in ((1, 10), (2, 11), (3, 4)):
        got = interaction_replay('loc', str(tmp_path), first, length, recording=2,
                                 device='cpu')
        want = jax_replay('loc', str(tmp_path), first, length, recording=2)
        for g, w, name in zip(got, want, ('attributes', 'states', 'present')):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if name == 'present':
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_array_max_ulp(g, w, maxulp=1)
    assert got[0].shape == (1, 4, 3) and not got[2].all()
    with pytest.raises(InitializationFailedError):
        interaction_replay('loc', str(tmp_path), 5, 20, recording=2, device='cpu')


def test_replay_example_runs_on_the_cpu(tmp_path):
    """``examples/replay.py`` at ``--device cpu`` on a written recording,
    with the Town02 mesh and without a mesh: the ego teleports along its
    track, the other agents are replayed."""
    from torchdrivesim_tpu_torch.examples import replay
    from torchdrivesim_tpu_torch.map import find_map_config
    folder = tmp_path / 'recorded_trackfiles' / 'loc'
    folder.mkdir(parents=True)
    _write_recording(folder / 'vehicle_tracks_000.csv')
    base = ['--dataset-path', str(tmp_path), '--location', 'loc', '--segment-length',
            '3', '--device', 'cpu']
    for extra in (['--res', '48', '--map-mesh',
                   find_map_config('carla_Town02').mesh_path], ['--res', '32']):
        out = str(tmp_path / 'replay.npz')
        replay.main(base + extra + ['--out', out])
        frames = np.load(out)['frames']
        res = int(extra[1])
        assert frames.shape == (2, res, res, 3) and frames.dtype == np.uint8
    args = replay.parse_args(base)
    sim, states = replay.build_simulator(args)
    for t in range(2):
        sim.step(states[:, :1, t + 1])
    torch.testing.assert_close(sim.get_state(), states[:, :1, 2])
    torch.testing.assert_close(sim.get_npc_state(), states[:, 1:, 2])


def test_light_state_tensor_from_controller_matches_jax():
    """``current_light_state_tensor_from_controller`` on Town02's light
    controller (the port's drawing from ``random.Random(7)``, the JAX
    package's from the global ``random`` seeded 7: the same draws) while
    both tick."""
    import random
    import torchdrivesim_tpu.traffic_lights as JT
    import torchdrivesim_tpu_torch.traffic_lights as PT
    from torchdrivesim_tpu_torch.map import find_map_config
    cfg = find_map_config('carla_Town02')
    ids = [sl.actor_id for sl in cfg.stoplines if sl.agent_type == 'traffic_light']
    got = PT.TrafficLightController.from_json(cfg.traffic_light_controller_path,
                                              random.Random(7))
    random.seed(7)
    want = JT.TrafficLightController.from_json(cfg.traffic_light_controller_path)
    seen = set()
    for _ in range(40):
        g = PT.current_light_state_tensor_from_controller(got, ids, device='cpu')
        w = JT.current_light_state_tensor_from_controller(want, ids)
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got.current_state_with_name == want.current_state_with_name
        seen |= set(g.tolist())
        got.tick(0.7)
        want.tick(0.7)
    assert len(seen) >= 2
