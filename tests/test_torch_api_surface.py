"""
The port's API surface beside the facade, on the CPU, against the JAX
package where it has the same function:

* ``lanelet2.LaneFeatures`` through ``copy``, ``extend`` and
  ``select_batch_elements`` (alone and carried by a simulator);
* ``TrafficLightStateMachine.to_json`` and ``TrafficLightController.to_json``:
  the reference's JSON strings, and round trips through ``from_json``;
* ``validation``: shape checks and finiteness checks that raise;
* ``checkpoint``: a nest with zero-size leaves, and a stepped simulator's
  state, bit for bit after restore (stepping on from it too);
* ``iou_utils``, function by function, and ``infractions``'
  ``point_mesh_face_distance``, ``point_to_mesh_distance_pt`` and
  ``get_all_intersections``, at map-scale coordinates (x ~ 400 m): masks,
  counts and orderings exact, values to 1e-4 relative (areas, distances)
  or as stated.
"""
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_simulator import A, B, port_simulator, world_arrays

torch.set_num_threads(1)


def _lanes(asarray, pkg, b=3):
    rng = np.random.RandomState(2)
    return pkg.LaneFeatures(
        dense_lane_features=asarray(rng.rand(b, 5, 4).astype(np.float32)),
        dense_lane_features_mask=asarray(rng.rand(b, 5) > 0.3),
        sparse_lane_features=asarray(rng.rand(b, 2, 6).astype(np.float32)),
        sparse_lane_features_mask=None)


def _fields(lf):
    return [None if x is None else np.asarray(x) for x in (
        lf.dense_lane_features, lf.dense_lane_features_mask,
        lf.sparse_lane_features, lf.sparse_lane_features_mask)]


def test_lane_features_copy_extend_select_match_jax():
    from torchdrivesim_tpu import lanelet2 as JL
    from torchdrivesim_tpu_torch import lanelet2 as PL
    jl, pl = _lanes(jnp.asarray, JL), _lanes(torch.from_numpy, PL)
    for op in (lambda x: x.copy(), lambda x: x.extend(2),
               lambda x: x.select_batch_elements([2, 0, 2]),
               lambda x: x.select_batch_elements(np.asarray([1]))):
        for got, want in zip(_fields(op(pl)), _fields(op(jl))):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
    assert issubclass(PL.Lanelet2NotFound, ImportError)


def test_simulator_carries_lane_features():
    from torchdrivesim_tpu_torch.lanelet2 import LaneFeatures
    a = world_arrays()
    sim = port_simulator(a)
    lanes = _lanes(torch.from_numpy, __import__('torchdrivesim_tpu_torch.lanelet2',
                                                fromlist=['LaneFeatures']), b=B)
    assert isinstance(lanes, LaneFeatures)
    sim.lane_features = lanes
    assert sim.copy().lane_features.dense_lane_features is lanes.dense_lane_features
    big = sim.extend(3, in_place=False)
    np.testing.assert_array_equal(big.lane_features.dense_lane_features.numpy(),
                                  np.repeat(_fields(lanes)[0], 3, axis=0))
    sel = sim.select_batch_elements([1], in_place=False)
    np.testing.assert_array_equal(sel.lane_features.dense_lane_features_mask.numpy(),
                                  _fields(lanes)[1][[1]])
    assert sel.lane_features.sparse_lane_features_mask is None


def test_traffic_light_to_json_matches_jax_and_round_trips(tmp_path):
    from torchdrivesim_tpu.traffic_lights import (
        TrafficLightController as JController, TrafficLightStateMachine as JMachine)
    from torchdrivesim_tpu_torch.map import find_map_config
    from torchdrivesim_tpu_torch.traffic_lights import (
        TrafficLightController, TrafficLightStateMachine)
    path = find_map_config('carla_Town10HD').traffic_light_controller_path
    got = TrafficLightController.from_json(path, random.Random(0))
    want = JController.from_json(path)
    assert got.to_json() == want.to_json()
    again = tmp_path / 'controller.json'
    again.write_text(got.to_json())
    back = TrafficLightController.from_json(str(again), random.Random(0))
    assert back.to_json() == got.to_json()
    assert [f.states for f in back.traffic_fsms] == [f.states for f in got.traffic_fsms]
    # the loaded file's numbers come back as the reference writes them
    assert len(json.loads(got.to_json())) == len(json.load(open(path)))
    fsm = got.traffic_fsms[0]
    assert fsm.to_json() == JMachine(want.traffic_fsms[0].states).to_json()
    one = tmp_path / 'fsm.json'
    one.write_text(fsm.to_json())
    assert [TrafficLightStateMachine(s.states, random.Random(1)).to_json() for s in
            [JMachine.from_json(str(one))]] == [fsm.to_json()]


def test_validation_checks_raise():
    from torchdrivesim_tpu_torch.validation import (
        CheckError, check_finite_state, checked, validate_state_shapes)
    sim = port_simulator(world_arrays())
    validate_state_shapes(sim.state, agent_count=A, batch_size=B)
    for kw in (dict(agent_count=A + 1, batch_size=B), dict(agent_count=A, batch_size=B + 1)):
        with pytest.raises(ValueError, match='simulator state'):
            validate_state_shapes(sim.state, **kw)

    def guarded_step(state, action):
        state = sim.functional_step(state, action)
        check_finite_state(state)
        return state

    step = checked(guarded_step)
    out = step(sim.state, torch.zeros((B, A, 2)))
    assert torch.isfinite(out.agent_state).all()
    with pytest.raises(CheckError, match='non-finite agent state'):
        step(sim.state, torch.full((B, A, 2), float('nan')))
    with pytest.raises(CheckError, match='NaN'):
        checked(lambda x: {'y': [x / 0.0 * 0.0]})(torch.ones(2))


def test_checkpoint_tree_round_trip_with_empty_leaves(tmp_path):
    from torchdrivesim_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
    tree = {'a': torch.arange(12).reshape(3, 4), 'b': {'c': torch.rand(5, dtype=torch.float64)},
            'empty': torch.zeros((2, 0, 4)), 'list': [torch.tensor(3), 'tag']}
    path = os.path.join(tmp_path, 'ckpt.pt')
    save_checkpoint(path, tree)
    with pytest.raises(FileExistsError):
        save_checkpoint(path, tree, force=False)
    target = {'a': torch.zeros((3, 4), dtype=torch.int64),
              'b': {'c': torch.zeros(5, dtype=torch.float64)},
              'empty': torch.zeros((2, 0, 4)), 'list': [torch.tensor(0), 'tag']}
    back = restore_checkpoint(path, target)
    assert torch.equal(back['a'], tree['a']) and torch.equal(back['b']['c'], tree['b']['c'])
    assert back['empty'] is target['empty'] and back['list'][1] == 'tag'
    assert int(back['list'][0]) == 3
    flat = restore_checkpoint(path, device='cpu')
    assert sorted(flat) == ['a', 'b/c', 'list/0']
    with pytest.raises(ValueError, match='checkpoint holds'):
        restore_checkpoint(path, {'a': torch.zeros((4, 3), dtype=torch.int64)})


def test_checkpoint_simulator_round_trip_is_bit_equal(tmp_path):
    from torchdrivesim_tpu_torch.checkpoint import restore_simulator, save_simulator
    sim = port_simulator(world_arrays())
    actions = torch.from_numpy(np.random.RandomState(3).uniform(
        -0.3, 0.3, (6, B, A, 2)).astype(np.float32))
    for t in range(3):
        sim.step(actions[t])
    path = os.path.join(tmp_path, 'sim.pt')
    save_simulator(path, sim)
    saved = sim.copy()
    for t in range(3, 6):
        sim.step(actions[t])
    assert not torch.equal(sim.get_state(), saved.get_state())
    restore_simulator(path, sim)
    for name in ('agent_state', 'present_mask', 'npc_state', 'npc_present_mask', 'time',
                 'npc_time'):
        assert torch.equal(getattr(sim.state, name), getattr(saved.state, name)), name
    assert torch.equal(sim.state.waypoint_state.state, saved.state.waypoint_state.state)
    assert torch.equal(sim.state.traffic_control_state['traffic_light'],
                       saved.state.traffic_control_state['traffic_light'])
    assert torch.equal(sim.kinematic_model.get_state(), saved.get_state())
    for t in range(3, 6):
        sim.step(actions[t])
        saved.step(actions[t])
    assert torch.equal(sim.get_state(), saved.get_state())


# --- iou_utils and the infractions helpers, at map scale ---------------------

def _random_boxes(seed, b=3, n=8, scale=400.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-scale, scale, size=(b, n, 2)).astype(np.float32)
    wh = rng.uniform(1.0, 6.0, size=(b, n, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, size=(b, n, 1)).astype(np.float32)
    return np.concatenate([xy, wh, ang], axis=-1)


def _overlapping_pairs(seed, b=3, n=16):
    """box2 = box1 moved a little: most pairs overlap."""
    rng = np.random.default_rng(seed)
    box1 = _random_boxes(seed, b, n)
    box2 = box1.copy()
    box2[..., :2] += rng.uniform(-2.0, 2.0, size=(b, n, 2)).astype(np.float32)
    box2[..., 4:] += rng.uniform(-0.8, 0.8, size=(b, n, 1)).astype(np.float32)
    return box1, box2


def _corners(box):
    from torchdrivesim_tpu import iou_utils as J
    return np.asarray(J.box2corners_th(jnp.asarray(box)))


def test_iou_utils_match_jax_function_by_function():
    from torchdrivesim_tpu import iou_utils as J
    from torchdrivesim_tpu_torch import iou_utils as P
    box1, box2 = _overlapping_pairs(1)
    np.testing.assert_allclose(P.box2corners_th(torch.from_numpy(box1)).numpy(),
                               _corners(box1), rtol=0, atol=1e-4)
    c1, c2 = _corners(box1), _corners(box2)
    jc1, jc2, pc1, pc2 = jnp.asarray(c1), jnp.asarray(c2), torch.from_numpy(c1), \
        torch.from_numpy(c2)
    (ji, jm), (pi, pm) = J.box_intersection_th(jc1, jc2), P.box_intersection_th(pc1, pc2)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=0, atol=5e-3)
    for got, want in zip(P.box_in_box_th(pc1, pc2), J.box_in_box_th(jc1, jc2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    (jv, jmask), (pv, pmask) = (
        J.build_vertices(jc1, jc2, *J.box_in_box_th(jc1, jc2), ji, jm),
        P.build_vertices(pc1, pc2, *P.box_in_box_th(pc1, pc2), pi, pm))
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    # the same vertices into both sorts: the same ring
    idx = P.sort_indices(torch.from_numpy(np.asarray(jv)), pmask)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(J.sort_indices(jv, jmask)))
    (ja, _), (pa, _) = (J.oriented_box_intersection_2d(jc1, jc2),
                        P.oriented_box_intersection_2d(pc1, pc2))
    assert float(np.asarray(ja).min()) >= 0 and (np.asarray(ja) > 0).mean() > 0.5
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-3)
    jiou = np.asarray(J.iou_differentiable_fast(jnp.asarray(box1), jnp.asarray(box2)))
    piou = P.iou_differentiable_fast(torch.from_numpy(box1), torch.from_numpy(box2))
    np.testing.assert_allclose(piou.numpy(), jiou, rtol=1e-4, atol=1e-4)
    assert P.precision_rounding(torch.tensor([0.1234565])).item() == \
        float(J.precision_rounding(jnp.asarray([0.1234565]))[0])


def test_iou_differentiable_fast_has_a_gradient():
    from torchdrivesim_tpu_torch import iou_utils as P
    box1, box2 = _overlapping_pairs(3, b=1, n=6)
    b1 = torch.from_numpy(box1).requires_grad_(True)
    P.iou_differentiable_fast(b1, torch.from_numpy(box2)).sum().backward()
    assert torch.isfinite(b1.grad).all() and float(b1.grad.abs().max()) > 0


def test_point_mesh_face_distance_matches_jax_at_map_scale():
    from torchdrivesim_tpu.infractions import point_mesh_face_distance as jfn
    from torchdrivesim_tpu.mesh import BaseMesh as JBase
    from torchdrivesim_tpu_torch.infractions import point_mesh_face_distance
    from torchdrivesim_tpu_torch.map import find_map_config
    road = find_map_config('carla_Town02').road_mesh
    verts = (np.asarray(road.verts, np.float32) + [300.0, 200.0]).astype(np.float32)
    faces = np.asarray(road.faces, np.int32)
    rng = np.random.RandomState(4)
    points = (verts[0, rng.randint(0, verts.shape[1], (2, 40))]
              + rng.uniform(-6, 6, (2, 40, 2))).astype(np.float32)
    pmesh = __import__('torchdrivesim_tpu_torch.mesh', fromlist=['BaseMesh']).BaseMesh(
        verts=np.repeat(verts, 2, 0), faces=np.repeat(faces, 2, 0))
    jmesh = JBase(verts=jnp.asarray(np.repeat(verts, 2, 0)),
                  faces=jnp.asarray(np.repeat(faces, 2, 0)))
    for kw in (dict(reduction='none'), dict(), dict(reduction='mean', weighted=True),
               dict(reduction='max', threshold=1.0), dict(reduction='min')):
        want = np.asarray(jfn(jmesh, jnp.asarray(points), **kw))
        got = point_mesh_face_distance(pmesh, torch.from_numpy(points), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=str(kw))
    d = point_mesh_face_distance(pmesh, torch.from_numpy(points), reduction='none')
    assert int((d == 0).sum()) > 0 and int((d > 1).sum()) > 0
    with pytest.raises(ValueError, match='reduction'):
        point_mesh_face_distance(pmesh, torch.from_numpy(points), reduction='median')


def test_point_to_mesh_distance_pt_matches_jax_at_map_scale():
    from torchdrivesim_tpu.infractions import point_to_mesh_distance_pt as jfn
    from torchdrivesim_tpu_torch.infractions import (
        point_mesh_face_distance, point_to_mesh_distance_pt)
    from torchdrivesim_tpu_torch.mesh import BaseMesh
    rng = np.random.RandomState(0)
    points = np.concatenate([rng.uniform(350, 450, (6, 2)), rng.uniform(-1, 1, (6, 1))],
                            -1).astype(np.float32)
    tris = np.concatenate([rng.uniform(350, 450, (6, 10, 3, 2)),
                           rng.uniform(-1, 1, (6, 10, 3, 1))], -1).astype(np.float32)
    tris[0, 0] = [[300, 300, 0], [500, 300, 0], [400, 500, 0]]   # point 0 above it
    tris[1, 1, 1] = tris[1, 1, 0]                                # a degenerate face
    want = np.asarray(jfn(jnp.asarray(points), jnp.asarray(tris)))
    got = point_to_mesh_distance_pt(torch.from_numpy(points), torch.from_numpy(tris))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    thr = float(np.median(want)) + 1e-3
    got_t = point_to_mesh_distance_pt(torch.from_numpy(points), torch.from_numpy(tris),
                                      threshold=thr).numpy()
    np.testing.assert_array_equal(got_t == 0, np.asarray(
        jfn(jnp.asarray(points), jnp.asarray(tris), threshold=thr)) == 0)
    # 3D points through point_mesh_face_distance: one triangle per batch
    mesh = BaseMesh(verts=tris[:, 0], faces=np.zeros((6, 1, 3), np.int32) + [0, 1, 2])
    d = point_mesh_face_distance(mesh, torch.from_numpy(points[:, None]), reduction='none')
    np.testing.assert_allclose(d[:, 0].numpy(), np.asarray(
        jfn(jnp.asarray(points), jnp.asarray(tris[:, :1])))[:, 0], rtol=1e-4, atol=1e-3)


def test_get_all_intersections_matches_jax_at_map_scale():
    from torchdrivesim_tpu.infractions import get_all_intersections as jfn
    from torchdrivesim_tpu_torch.infractions import get_all_intersections
    rects = _random_boxes(7, b=1, n=30, scale=6.0)[0] + [400.0, -250.0, 0, 0, 0]
    rects = rects.astype(np.float32)
    want = jfn(rects)
    got = get_all_intersections(rects)
    assert got.dtype == np.float64 and got.shape == (30, 30)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 30 * 29 / 2 and not np.tril(got).any()
    for ego in (0, 17, 29):
        np.testing.assert_array_equal(get_all_intersections(rects, ego_idx=ego),
                                      jfn(rects, ego_idx=ego))
