"""
The port's INTERACTION data path against the JAX package's: the dataset
(``behavior/interaction.py``) on a two-location fixture whose case, track
and row order is shuffled (pandas keeps ids in the order they first
appear, and so must the port), the lane-marking mesh of Town02's lanelet
map, the mesh surface (``mesh.py``), and the dataset imitation-learning
loss and policy gradients (``imitation.build_dataset_batch``, replayed NPCs
drawn in every frame) at B = 2, horizon 3, res 32 through the grouped soft
raster with ``MAX_FACES`` patched to 16 in both packages.

Loaded arrays match exactly, except float fields, which may differ by one
float32 ulp (pandas' float parser and ``float`` may differ in the last bit
of a float64).
"""
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdrivesim_tpu_torch.lanelet2 as PL
from tests.test_torch_grouped_soft import jax_grouped  # noqa: F401

torch.set_num_threads(1)

M_PER_DEG = 111319.49
FLOAT_KEYS = ('agent_attributes', 'agent_states')
#: the strip half-width of the lane markings (``lanelet_map_to_lane_mesh``)
LANE_WIDTH = inspect.signature(PL.lanelet_map_to_lane_mesh).parameters[
    'lane_boundary_width'].default


def _write_osm(path, y_left=4.0, y_right=-4.0):
    nodes, ways = [], []
    nid = 1
    for wid, ys in ((100, y_left), (200, y_right)):
        refs = []
        for i, x in enumerate(range(0, 60, 10)):
            nodes.append(
                f'<node id="{nid}" lat="{ys / M_PER_DEG:.10f}" '
                f'lon="{x / M_PER_DEG:.10f}"/>')
            refs.append(f'<nd ref="{nid}"/>')
            nid += 1
        ways.append(f'<way id="{wid}">{"".join(refs)}</way>')
    rel = ('<relation id="1"><tag k="type" v="lanelet"/>'
           '<member type="way" role="left" ref="100"/>'
           '<member type="way" role="right" ref="200"/></relation>')
    with open(path, 'w') as f:
        f.write('<?xml version="1.0"?><osm>'
                + ''.join(nodes) + ''.join(ways) + rel + '</osm>')


def _write_case_rows(rows, case_id, track_id, agent_type, n_frames,
                     x0=10.0, psi=0.1, missing_cols=False, first_frame=1):
    for f in range(first_frame, first_frame + n_frames):
        rows.append({
            'case_id': case_id, 'track_id': track_id, 'frame_id': f,
            'timestamp_ms': f * 100, 'agent_type': agent_type,
            'x': x0 + 0.3 * f, 'y': 1.0 * track_id + 0.01 * f,
            'vx': 3.0 + 0.1 * track_id, 'vy': 4.0 - 0.01 * f,
            'psi_rad': '' if missing_cols else psi,
            'length': '' if missing_cols else 4.6,
            'width': '' if missing_cols else 2.0,
        })


def _shuffled_csv(rows, path, seed):
    """The rows in an order shuffled by ``seed``: ids appear out of order."""
    import pandas as pd
    order = np.random.RandomState(seed).permutation(len(rows))
    pd.DataFrame([rows[i] for i in order]).to_csv(path, index=False)


@pytest.fixture(scope='module')
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('interaction')
    os.makedirs(root / 'maps')
    os.makedirs(root / 'train')
    _write_osm(root / 'maps' / 'locA.osm')
    _write_osm(root / 'maps' / 'locB.osm', y_left=5.0, y_right=-3.0)
    rows = []
    # locA case 7: full vehicles 9 and 2 ('car'), a partial pedestrian 3,
    # full vehicle 5, a short vehicle 4 (not ego-eligible)
    _write_case_rows(rows, 7, 9, 'vehicle', 40)
    _write_case_rows(rows, 7, 2, 'car', 40, x0=20.0)
    _write_case_rows(rows, 7, 3, 'pedestrian/bicycle', 25, missing_cols=True,
                     first_frame=6)
    _write_case_rows(rows, 7, 5, 'vehicle', 40, x0=30.0, psi=-0.2)
    _write_case_rows(rows, 7, 4, 'vehicle', 12, x0=15.0)
    # locA case 1: one full vehicle and two pedestrians
    _write_case_rows(rows, 1, 8, 'vehicle', 40)
    _write_case_rows(rows, 1, 6, 'pedestrian/bicycle', 25, missing_cols=True)
    _write_case_rows(rows, 1, 1, 'pedestrian/bicycle', 30, missing_cols=True)
    _shuffled_csv(rows, root / 'train' / 'locA_train.csv', 0)
    rows = []
    _write_case_rows(rows, 3, 7, 'car', 40)
    _write_case_rows(rows, 3, 11, 'vehicle', 40, x0=40.0)
    _shuffled_csv(rows, root / 'train' / 'locB_train.csv', 1)
    return str(root)


def _compare_item(got, want, name):
    for key in ('agent_attributes', 'agent_states', 'present_mask', 'agent_types'):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype, (name, key)
        if key in FLOAT_KEYS:
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f'{name} {key}')
    assert got['location'] == want['location']


def _compare_mesh(got, want, name, lane=False):
    """Categories, faces and vertex categories exact; vertices exact, but
    for a lane mesh (``lane``) whose strip offsets may take either rounding
    (:func:`_check_lane_verts`)."""
    assert list(got.categories) == list(want.categories), name
    np.testing.assert_array_equal(got.faces, np.asarray(want.faces), err_msg=name)
    np.testing.assert_array_equal(got.vert_category, np.asarray(want.vert_category),
                                  err_msg=name)
    if lane:
        _check_lane_verts(np.asarray(got.verts), np.asarray(want.verts), name)
    else:
        np.testing.assert_array_equal(got.verts, np.asarray(want.verts), err_msg=name)


def _check_lane_verts(got, want, name, width=LANE_WIDTH, eps=1e-6):
    """``line_segments_to_mesh``'s 6 vertices per segment: the endpoints
    (slots 2 and 3) exact; the offsets ``points +- d_perp * width`` (slots 0,
    1 and 4, 5) equal to one of the values the two places where the
    reference's compiled CPU code may contract a product into a sum give:
    the norm's ``x * x + y * y`` (as the port rounds it, or as ``fma(y, y,
    x * x)``) and the offset itself (product and sum rounded apart, or
    once). The port's own value is the first of both."""
    b = got.shape[0]
    g, w = got.reshape(b, -1, 6, 2), want.reshape(b, -1, 6, 2)
    np.testing.assert_array_equal(g[:, :, 2:4], w[:, :, 2:4], err_msg=name)
    points = g[:, :, 2:4]
    d = points[:, :, 1] - points[:, :, 0]
    x, y = d[..., 0:1].astype(np.float64), d[..., 1:2].astype(np.float64)
    norms = (np.linalg.norm(d, axis=-1, keepdims=True),
             np.sqrt((y * y + (x * x).astype(np.float32)).astype(np.float32)))
    ok = np.zeros(w.shape[:2] + (4, 2), bool)
    for norm in norms:
        d_hat = d / (norm.astype(np.float32) + np.float32(eps))
        d_perp = np.stack([-d_hat[..., 1], d_hat[..., 0]], axis=-1)[:, :, None]
        step = d_perp * np.float32(width)
        fused = d_perp.astype(np.float64) * np.float64(np.float32(width))
        for sign, slots, cols in ((1, slice(0, 2), slice(0, 2)),
                                  (-1, slice(4, 6), slice(2, 4))):
            for value in (points + sign * step,
                          (points.astype(np.float64) + sign * fused).astype(np.float32)):
                ok[:, :, cols] |= w[:, :, slots] == value
    assert ok.all(), f'{name}: {int((~ok).sum())} offset coordinates off every rounding'
    print(f'{name}: {int((w != g).any(-1).sum())} of {g.shape[1] * 6} vertices take '
          'another rounding')


def test_dataset_matches_jax(dataset_root):
    """Locations, segments (first-appearance order of cases and tracks),
    every item and its meshes, against the JAX package's dataset."""
    from torchdrivesim_tpu.behavior.interaction import INTERACTIONDataset as JaxDataset
    from torchdrivesim_tpu_torch.behavior.interaction import INTERACTIONDataset
    got, want = INTERACTIONDataset(dataset_root), JaxDataset(dataset_root)
    assert got.location_names == want.location_names == ['locA', 'locB']
    assert len(got) == len(want) == 6
    for g, w in zip(got.idx2segment, want.idx2segment):
        assert g == w
    # the shuffled rows put the segments out of sorted order
    order = [(s['location'], s['case_id'], s['ego_track_id']) for s in got.idx2segment]
    assert order != sorted(order)
    for i in range(len(got)):
        _compare_item(got[i], want[i], f'item {i}')
    item = got[1]
    np.testing.assert_array_equal(item['agent_types'], [0, 0, 0, 0, 1])
    np.testing.assert_allclose(item['agent_attributes'][-1], [1.5, 1.5])
    assert item['present_mask'][-1].sum() == 25
    for loc in got.location_names:
        _compare_mesh(got.road_meshes[loc], want.road_meshes[loc], f'{loc} road')
        _compare_mesh(got.lane_meshes[loc], want.lane_meshes[loc], f'{loc} lanes',
                      lane=True)


def test_collate_and_subsample_match_jax(dataset_root):
    from torchdrivesim_tpu.behavior.interaction import INTERACTIONDataset as JaxDataset
    from torchdrivesim_tpu_torch.behavior.interaction import INTERACTIONDataset
    got = INTERACTIONDataset(dataset_root).subsample(4, seed=3)
    want = JaxDataset(dataset_root).subsample(4, seed=3)
    assert got.idx2segment == want.idx2segment
    gb = INTERACTIONDataset.collate([got[i] for i in range(len(got))], device='cpu')
    wb = JaxDataset.collate([want[i] for i in range(len(want))])
    for key in ('agent_attributes', 'agent_states', 'present_mask', 'agent_types'):
        assert isinstance(gb[key], torch.Tensor)
    _compare_item({k: v.numpy() if torch.is_tensor(v) else v for k, v in gb.items()},
                  wb, 'batch')
    for key in ('road_mesh', 'lane_mesh'):
        _compare_mesh(gb[key], wb[key], key, lane=key == 'lane_mesh')
    assert gb['location'] == wb['location']


def test_town02_lane_mesh_matches_jax():
    """The lane-marking mesh of Town02's lanelet map: faces, categories and
    segment endpoints exact, strip offsets to either rounding of
    ``points +- d_perp * width`` (:func:`_check_lane_verts`); also the lane mesh of
    twelve lanelets with a join threshold that finds joint segments,
    right- and left-handed."""
    import torchdrivesim_tpu.lanelet2 as JL
    import torchdrivesim_tpu_torch.lanelet2 as PL
    from torchdrivesim_tpu_torch.map import find_map_config
    path = find_map_config('carla_Town02').lanelet_path
    got = PL.lanelet_map_to_lane_mesh(PL.load_lanelet_map(path))
    want = JL.lanelet_map_to_lane_mesh(JL.load_lanelet_map(path))
    assert got.faces.shape[1] > 10000
    _compare_mesh(got, want, 'Town02 lanes', lane=True)
    for left_handed in (False, True):
        g = PL.lanelet_map_to_lane_mesh(PL.load_lanelet_map(path), lanelets=[
            ll.id for ll in PL.load_lanelet_map(path).laneletLayer][:12],
            left_handed=left_handed, left_right_marking_join_threshold=2.0)
        w = JL.lanelet_map_to_lane_mesh(JL.load_lanelet_map(path), lanelets=[
            ll.id for ll in JL.load_lanelet_map(path).laneletLayer][:12],
            left_handed=left_handed, left_right_marking_join_threshold=2.0)
        _compare_mesh(g, w, f'Town02 12 lanelets, left_handed {left_handed}', lane=True)
        assert 'joint_lane' in g.categories


def _meshes(mod, rng):
    """A two-element BirdviewMesh of two categories and an AttributeMesh of
    the given package, from seeded numpy."""
    verts = rng.uniform(-5, 5, (2, 9, 2)).astype(np.float32)
    faces = rng.randint(0, 9, (2, 7, 3)).astype(np.int32)
    cats = rng.randint(0, 2, (2, 9)).astype(np.int32)
    attrs = rng.rand(2, 9, 3).astype(np.float32)
    bv = mod.BirdviewMesh(verts=verts, faces=faces, categories=['road', 'lane'],
                          colors={'road': np.asarray([0.1, 0.2, 0.3], np.float32)},
                          zs={'road': 1.0}, vert_category=cats)
    return bv, mod.AttributeMesh(verts=verts, faces=faces, attrs=attrs)


POLYGON = np.asarray([[[-2., -3.], [3., -3.], [3., 2.], [-2., 2.]]] * 2, np.float32)
MESH_OPS = {
    'translate': lambda m, M: m.translate(np.asarray([[1., 2.], [-3., 0.5]], np.float32)),
    'offset': lambda m, M: m.offset(np.asarray([1.5], np.float32)),
    'pad': lambda m, M: m.pad(2),
    'expand': lambda m, M: m.expand(2),
    'concat': lambda m, M: type(m).concat([m, m.translate(
        np.asarray([[1., 1.], [1., 1.]], np.float32))]),
    'merge': lambda m, M: m.merge(m),
    'trim': lambda m, M: m.trim(POLYGON),
    'trim_face_only': lambda m, M: m.trim(POLYGON, trim_face_only=True),
    'serialize': lambda m, M: type(m).deserialize(m.serialize()),
    'separate': lambda m, M: m.separate_by_category() if hasattr(
        m, 'separate_by_category') else m.center,
}


def _as_np(x):
    if isinstance(x, dict):
        return {k: _as_np(v) for k, v in x.items()}
    if hasattr(x, 'verts'):
        return {k: np.asarray(v) for k, v in vars(x).items()
                if isinstance(v, (np.ndarray, jnp.ndarray))}
    return np.asarray(x)


def _assert_same(got, want, name):
    if isinstance(want, dict):
        assert set(got) == set(want), name
        for k in want:
            _assert_same(got[k], want[k], f'{name}.{k}')
        return
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                               rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize('op', sorted(MESH_OPS))
def test_mesh_surface_matches_jax(op):
    """Each mesh operation on a BirdviewMesh and an AttributeMesh of both
    packages (the cases of ``tests/test_mesh.py`` on seeded meshes)."""
    import torchdrivesim_tpu.mesh as JM
    import torchdrivesim_tpu_torch.mesh as PM
    for i, (g, w) in enumerate(zip(_meshes(PM, np.random.RandomState(0)),
                                   _meshes(JM, np.random.RandomState(0)))):
        got, want = MESH_OPS[op](g, PM), MESH_OPS[op](w, JM)
        _assert_same(_as_np(got), _as_np(want), f'{op} mesh {i}')
        if hasattr(want, 'categories'):
            assert list(got.categories) == list(want.categories)


def test_mesh_constructors_match_jax(tmp_path):
    import torchdrivesim_tpu.mesh as JM
    import torchdrivesim_tpu_torch.mesh as PM
    rng = np.random.RandomState(1)
    points = rng.uniform(-10, 10, (2, 5, 3)).astype(np.float32)
    polygon = rng.uniform(-4, 4, (6, 2)).astype(np.float32)
    boxes = rng.uniform(-3, 3, (2, 4, 4, 2)).astype(np.float32)
    for name, got, want in (
            ('trajectory', PM.generate_trajectory_mesh(points, 'trajectory'),
             JM.generate_trajectory_mesh(jnp.asarray(points), 'trajectory')),
            ('annulus', PM.generate_annulus_polygon_mesh(polygon, 1.5, [0.5, 1.0], 'ring'),
             JM.generate_annulus_polygon_mesh(polygon, 1.5, jnp.asarray([0.5, 1.0]),
                                              'ring')),
            ('empty', PM.BirdviewMesh.empty(batch_size=2),
             JM.BirdviewMesh.empty(batch_size=2)),
            ('attributes', PM.AttributeMesh.set_attr(PM.BaseMesh(points[..., :2],
                                                                 np.zeros((2, 1, 3), np.int32)),
                                                     [1.0, 2.0]),
             JM.AttributeMesh.set_attr(JM.BaseMesh(jnp.asarray(points[..., :2]),
                                                   jnp.zeros((2, 1, 3), jnp.int32)),
                                       jnp.asarray([1.0, 2.0])))):
        _assert_same(_as_np(got), _as_np(want), name)
    rgb = PM.RGBMesh.set_color(PM.BaseMesh(points[..., :2], np.zeros((2, 1, 3), np.int32)),
                               (255, 0, 51))
    want = JM.RGBMesh.set_color(JM.BaseMesh(jnp.asarray(points[..., :2]),
                                            jnp.zeros((2, 1, 3), jnp.int32)), (255, 0, 51))
    np.testing.assert_allclose(rgb.attrs, np.asarray(want.attrs), rtol=1e-7)
    for got, want in zip(PM.build_verts_faces_from_bounding_box(boxes),
                         JM.build_verts_faces_from_bounding_box(jnp.asarray(boxes))):
        np.testing.assert_array_equal(got, np.asarray(want))
    tv, tf = PM.build_verts_faces_from_bounding_box(torch.from_numpy(boxes))
    assert torch.is_tensor(tf) and np.array_equal(tf.numpy(), got)
    bv, _ = _meshes(PM, np.random.RandomState(0))
    bv.save(str(tmp_path / 'm.json'))
    loaded = JM.BirdviewMesh.load(str(tmp_path / 'm.json'))
    _assert_same(_as_np(PM.BirdviewMesh.load(str(tmp_path / 'm.json'))), _as_np(loaded),
                 'saved by the port, loaded by both')


def test_dataset_bc_gradient_matches_jax(dataset_root, jax_grouped, monkeypatch):
    """The example's dataset branch: B = 2 segments (``subsample(2,
    seed=0)``), horizon 3, res 32; the ego's expert is its recorded track
    and the other agents are replayed and drawn, through the grouped soft
    raster in 16-face groups in both packages. Loss to 1e-4, every policy
    gradient to rtol 2e-3 (atol 1e-7)."""
    import torchdrivesim_tpu.kinematic as JK
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from tests.test_torch_grouped_soft import _counting
    from tests.test_torch_il import _flax_policy, _port_policy
    from torchdrivesim_tpu.behavior.interaction import INTERACTIONDataset as JaxDataset
    from torchdrivesim_tpu.rendering import JaxRendererConfig
    from torchdrivesim_tpu.rendering.base import Cameras as JaxCameras
    from torchdrivesim_tpu.simulator import ReplayController as JaxReplay
    from torchdrivesim_tpu.simulator import Simulator as JaxSimulator
    from torchdrivesim_tpu.simulator import TorchDriveConfig as JaxConfig
    from torchdrivesim_tpu.utils import Resolution as JaxResolution
    from torchdrivesim_tpu_torch.imitation import (
        build_dataset_batch, build_synthetic_simulator, make_bc_loss_fn)
    jax_grouped(16)
    monkeypatch.setattr(jr, '_on_tpu', lambda: True)
    batch, horizon, res, features = 2, 3, 32, (4, 8)
    road, states0, expert, npc = build_dataset_batch(dataset_root, 'locA', batch,
                                                     horizon, device='cpu')
    assert expert.shape == (horizon, batch, 1, 4) and npc.npc_size.shape[1] >= 3
    sim = build_synthetic_simulator(road, states0, res=res, npc_controller=npc)
    fpolicy, params = _flax_policy(4, features, res)
    policy = _port_policy(4, features, params)
    calls = _counting(monkeypatch, 'soft_accum_bwd_reference')
    loss = make_bc_loss_fn(sim, policy, res)(sim.state, expert)
    grads = torch.autograd.grad(loss, list(policy.parameters()))
    assert len(calls) == horizon - 1 and calls[0] >= 2 * 16   # several groups

    # the JAX example's dataset branch (examples/imitation_learning.py)
    ds = JaxDataset(dataset_root, location_names=['locA'])
    ds.subsample(num_segments=batch, seed=0)
    data = JaxDataset.collate([ds[i] for i in range(len(ds))])
    gt, present = data['agent_states'], data['present_mask']
    jexpert = jnp.transpose(gt[:, 0, 1:horizon + 1], (1, 0, 2))[:, :, None]
    jnpc = JaxReplay(npc_size=data['agent_attributes'][:, 1:, :2], npc_states=gt[:, 1:],
                     npc_present_masks=present[:, 1:])
    kin = JK.SimpleKinematicModel(dt=0.1)
    kin.set_state(gt[:, :1, 0])
    cfg = JaxConfig()
    cfg.renderer = JaxRendererConfig(differentiable=True)
    jsim = JaxSimulator(road_mesh=data['road_mesh'], kinematic_model=kin,
                        agent_size=jnp.tile(jnp.asarray([[[4.6, 2.0]]]), (batch, 1, 1)),
                        initial_present_mask=jnp.ones((batch, 1), dtype=bool), cfg=cfg,
                        npc_controller=jnpc)
    np.testing.assert_array_equal(expert.numpy(), np.asarray(jexpert))
    gen, renderer = jsim.birdview_mesh_generator, jsim.renderer

    def jloss(params):
        state, preds = jsim.state, []
        for _ in range(horizon):
            all_state = jnp.concatenate([state.agent_state, state.npc_state], -2)
            shown = jnp.concatenate([state.present_mask, state.npc_present_mask], -1)
            mesh = gen.generate(1, agent_state=all_state[:, None],
                                present_mask=shown[:, None], include_background=True)
            ego = state.agent_state[:, 0]
            cams = JaxCameras(ego[:, :2], jnp.stack([jnp.sin(ego[:, 2]),
                                                     jnp.cos(ego[:, 2])], -1), 2.0 / 35)
            image = renderer.render_rgb_mesh_chw(mesh, JaxResolution(res, res), cams)
            state = jsim.functional_step(state, fpolicy.apply(params, image)[:, None, :])
            preds.append(state.agent_state)
        preds = jnp.stack(preds)
        return jnp.mean((preds[..., :2] - jexpert[..., :2]) ** 2)

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    print(f'loss: port {float(loss.detach())!r}, reference {float(want_loss)!r}')
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    from torchdrivesim_tpu_torch.convert import policy_state_dict_from_flax
    want = policy_state_dict_from_flax(jax.tree.map(np.asarray, want_grads))
    for (name, _), g in zip(policy.named_parameters(), grads):
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-3, atol=1e-7, err_msg=name)


def test_imitation_example_on_the_dataset(dataset_root):
    """``examples/imitation_learning.py --dataset-path`` on the CPU, free
    running and with ``--teacher-forcing`` (each step from the recorded
    ego state)."""
    from torchdrivesim_tpu_torch.examples import imitation_learning
    losses = imitation_learning.main([
        '--dataset-path', dataset_root, '--location', 'locB', '--batch', '2',
        '--horizon', '2', '--res', '32', '--steps', '2', '--device', 'cpu'])
    assert len(losses) == 2 and all(np.isfinite(losses))
    forced = imitation_learning.main([
        '--dataset-path', dataset_root, '--location', 'locB', '--batch', '2',
        '--horizon', '2', '--res', '32', '--steps', '2', '--device', 'cpu',
        '--teacher-forcing'])
    assert len(forced) == 2 and all(np.isfinite(forced))
