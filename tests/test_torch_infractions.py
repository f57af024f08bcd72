"""
The port's infraction metrics and the geometry under them against the JAX
package's, on the same seeded numpy inputs: oriented-box intersection
area, IoU (and its gradient) and the separating-axis test at map scale
(x ~ 400 m), with identical, touching and zero-size boxes and with no
agents; the exact collision counts; the chunked point-to-mesh distance and
the exact offroad loss over Town02's road mesh; the host wrong-way loss by
lanelet queries; and the waypoint goals, traffic controls, utilities and
mesh batch selection the simulator facade is built on. Values agree to
1e-4 absolute plus 1e-4 relative (gradients 1e-3 relative), booleans and
counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def close(got, want, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                               **(tol or TOL))


def map_scale_boxes(seed: int, b: int = 3, n: int = 6) -> np.ndarray:
    """(b, n, 5) boxes around x ~ 400 m, y ~ 300 m, close enough to
    overlap; box 1 equals box 0, box 2 touches box 0 edge to edge, box 3
    has zero size."""
    rng = np.random.RandomState(seed)
    boxes = np.stack([
        400 + rng.uniform(-4, 4, (b, n)), 300 + rng.uniform(-4, 4, (b, n)),
        rng.uniform(2, 5, (b, n)), rng.uniform(1, 2.5, (b, n)),
        rng.uniform(-np.pi, np.pi, (b, n))], axis=-1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]
    boxes[:, 2] = boxes[:, 0]
    boxes[:, 2, 0] += boxes[:, 0, 2] * np.cos(boxes[:, 0, 4])
    boxes[:, 2, 1] += boxes[:, 0, 2] * np.sin(boxes[:, 0, 4])
    boxes[:, 3, 2:4] = 0.0
    return boxes


@pytest.mark.parametrize('seed', [0, 1])
def test_iou_and_area_match_jax_at_map_scale(seed):
    from torchdrivesim_tpu.ops import box as J
    from torchdrivesim_tpu_torch.ops import box as P
    boxes = map_scale_boxes(seed)
    want = np.asarray(jax.jit(J.iou_non_differentiable)(jnp.asarray(boxes)))
    got = P.iou_non_differentiable(t(boxes))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    close(torch.nan_to_num(got, nan=0.0), np.nan_to_num(want, nan=0.0))
    assert np.allclose(got.numpy()[:, 0, 1], 1.0, atol=1e-5)    # identical boxes
    assert np.isnan(got.numpy()[:, 3, 3]).all()                   # zero size: 0/0
    c1, c2 = P.box2corners(t(boxes[:, :, None])), P.box2corners(t(boxes[:, None]))
    shape = (boxes.shape[0], boxes.shape[1], boxes.shape[1], 4, 2)
    area = P.oriented_box_intersection_area(c1.expand(shape), c2.expand(shape))
    jc1 = J.box2corners(jnp.asarray(boxes[:, :, None]))
    jc2 = J.box2corners(jnp.asarray(boxes[:, None]))
    close(area, jax.jit(J.oriented_box_intersection_area)(
        jnp.broadcast_to(jc1, shape), jnp.broadcast_to(jc2, shape)))


def test_iou_gradient_matches_jax():
    from torchdrivesim_tpu.ops import box as J
    from torchdrivesim_tpu_torch.ops import box as P
    rng = np.random.RandomState(3)
    b1 = np.concatenate([400 + rng.uniform(-1, 1, (8, 2)), rng.uniform(2, 4, (8, 2)),
                         rng.uniform(-3, 3, (8, 1))], -1).astype(np.float32)
    b2 = b1 + np.concatenate([rng.uniform(-1, 1, (8, 2)), np.zeros((8, 2)),
                              rng.uniform(-0.5, 0.5, (8, 1))], -1).astype(np.float32)
    want = jax.jit(jax.grad(lambda x, y: J.iou_differentiable(x, y).sum(),
                            argnums=(0, 1)))(jnp.asarray(b1), jnp.asarray(b2))
    x, y = t(b1).requires_grad_(), t(b2).requires_grad_()
    P.iou_differentiable(x, y).sum().backward()
    for g, w in zip((x.grad, y.grad), want):
        close(g, w, atol=1e-4, rtol=1e-3)


def test_sat_matches_jax_and_area():
    from torchdrivesim_tpu.ops import box as J
    from torchdrivesim_tpu_torch.ops import box as P
    boxes = map_scale_boxes(4, b=4, n=8)
    c = P.box2corners(t(boxes))
    n = boxes.shape[1]
    shape = (boxes.shape[0], n, n, 4, 2)
    c1, c2 = c[:, :, None].expand(shape), c[:, None].expand(shape)
    got = P.boxes_overlap_sat(c1, c2)
    jc = J.box2corners(jnp.asarray(boxes))
    want = J.boxes_overlap_sat(jnp.broadcast_to(jc[:, :, None], shape),
                               jnp.broadcast_to(jc[:, None], shape))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # SAT overlap is intersection area > 0 away from the degenerate pairs:
    # the zero-size box 3, and box 2, which touches boxes 0 and 1 only up
    # to the float32 rounding of corners at x ~ 400 m
    area = P.oriented_box_intersection_area(c1, c2)
    real = torch.ones((n,), dtype=torch.bool)
    real[2:4] = False
    pairs = real[:, None] & real[None]
    assert torch.equal(got[:, pairs], area[:, pairs] > 1e-3)
    assert got[:, pairs].sum() > got.shape[0] * int(real.sum())   # some overlap
    assert torch.equal(P.boxes_overlap_sat_cross(c, c), got)


def test_zero_agents():
    from torchdrivesim_tpu_torch import infractions as I
    from torchdrivesim_tpu_torch.mesh import BaseMesh
    from torchdrivesim_tpu_torch.ops import box as P
    empty = torch.zeros((2, 0, 5))
    assert P.iou_non_differentiable(empty).shape == (2, 0, 0)
    mask = torch.zeros((2, 0), dtype=torch.bool)
    for out in (I.compute_agent_collisions_metric(empty, mask, mask),
                I.compute_agent_collisions_metric_pytorch3d(empty, mask),
                I.compute_collision_matrix(empty, mask, metric='iou'),
                I.compute_collision_matrix(empty, mask, metric='discs')):
        assert out.shape == (2, 0)
    mesh = BaseMesh(verts=np.zeros((1, 3, 2), np.float32),
                    faces=np.asarray([[[0, 1, 2]]], np.int32))
    assert I.offroad_infraction_loss(torch.zeros((2, 0, 4)), torch.zeros((2, 0, 2)),
                                     mesh).shape == (2, 0)


@pytest.mark.parametrize('metric', ['discs', 'iou'])
def test_collision_metrics_match_jax(metric):
    from torchdrivesim_tpu import infractions as JI
    from torchdrivesim_tpu_torch import infractions as I
    boxes = map_scale_boxes(7, b=3, n=7)
    mask = np.random.RandomState(7).rand(3, 7) > 0.2
    want = jax.jit(JI.compute_collision_matrix, static_argnames='metric')(
        jnp.asarray(boxes), jnp.asarray(mask), metric=metric)
    close(I.compute_collision_matrix(t(boxes), t(mask, torch.bool), metric=metric), want)
    if metric == 'iou':
        # the exact counts are (IoU > 0): a zero-size box inside another has
        # IoU 0 here and float noise (~1e-9) in the reference, so they are
        # held on boxes of nonzero size
        boxes = boxes[:, [0, 1, 2, 4, 5, 6]]
        mask = mask[:, [0, 1, 2, 4, 5, 6]]
        cmask = np.random.RandomState(8).rand(3, 6) > 0.3
        want = jax.jit(JI.compute_agent_collisions_metric)(
            jnp.asarray(boxes), jnp.asarray(cmask), jnp.asarray(mask))
        got = I.compute_agent_collisions_metric(t(boxes), t(cmask, torch.bool),
                                                t(mask, torch.bool))
        close(got, want, atol=0, rtol=0)
        want = jax.jit(JI.compute_agent_collisions_metric_pytorch3d)(
            jnp.asarray(boxes), jnp.asarray(mask))
        got = I.compute_agent_collisions_metric_pytorch3d(t(boxes), t(mask, torch.bool))
        close(got, want, atol=0, rtol=0)
        assert float(got.sum()) > 0


def test_rectangle_vertices_match_jax():
    from torchdrivesim_tpu import infractions as JI
    from torchdrivesim_tpu_torch import infractions as I
    x = np.random.RandomState(2).uniform(-1, 1, (5, 5)).astype(np.float32) * [400, 300, 4, 2, 3]
    cols = [x[:, i:i + 1] for i in range(5)]
    close(I.rectangle_vertices(*[t(c) for c in cols]),
          JI.rectangle_vertices(*[jnp.asarray(c) for c in cols]))


@pytest.fixture(scope='module')
def town02():
    from torchdrivesim_tpu.map import find_map_config as jax_find
    from torchdrivesim_tpu_torch.map import find_map_config
    return find_map_config('carla_Town02'), jax_find('carla_Town02')


def agents_on_town02(seed: int, b: int = 2, a: int = 5) -> np.ndarray:
    """(b, a, 4) states around the Town02 road, some off it."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-10, 200, (b, a)), rng.uniform(100, 320, (b, a)),
                     rng.uniform(-np.pi, np.pi, (b, a)), rng.uniform(0, 5, (b, a))],
                    -1).astype(np.float32)


def test_offroad_exact_matches_jax_at_map_scale(town02):
    """The exact offroad loss over Town02's ~17,000 faces (the chunked
    distance, 2,048 faces a chunk), the mesh and the agents shifted by
    +300 m so the boxes sit at x ~ 400 m."""
    import dataclasses
    from torchdrivesim_tpu import infractions as JI
    from torchdrivesim_tpu_torch import infractions as I
    cfg, jcfg = town02
    road, jroad = cfg.road_mesh, jcfg.road_mesh
    assert road.faces.shape[-2] > 2048
    shift = np.asarray([300.0, 0.0], np.float32)
    road = dataclasses.replace(road, verts=road.verts + shift)
    jroad = dataclasses.replace(jroad.expand(2), verts=jnp.asarray(
        np.asarray(jroad.verts) + shift).repeat(2, axis=0))
    states = agents_on_town02(5)
    states[..., 0] += 300.0
    sizes = np.broadcast_to(np.asarray([4.5, 2.0], np.float32), states.shape[:2] + (2,))
    want = jax.jit(JI.offroad_infraction_loss, static_argnames='threshold')(
        jnp.asarray(states), jnp.asarray(sizes), jroad, threshold=0.5)
    got = I.offroad_infraction_loss(t(states), t(sizes), road, threshold=0.5)
    close(got, want)
    assert float(got.sum()) > 0 and float((got == 0).sum()) > 0


def test_point_to_mesh_distance_matches_jax(town02):
    from torchdrivesim_tpu.ops import point_mesh as J
    from torchdrivesim_tpu_torch.ops import point_mesh as P
    cfg, _ = town02
    verts = np.asarray(cfg.road_mesh.verts)[0, :, :2]
    tris = verts[np.asarray(cfg.road_mesh.faces)[0]][None]      # (1, F, 3, 2)
    points = agents_on_town02(6)[..., :2].reshape(1, -1, 2)
    want = jax.jit(J.point_to_triangles_distance_sq_chunked)(
        jnp.asarray(points), jnp.asarray(tris))
    close(P.point_to_triangles_distance_sq_chunked(t(points), t(tris)), want)


def test_lanelet_wrong_way_matches_jax(town02):
    from torchdrivesim_tpu import infractions as JI
    from torchdrivesim_tpu_torch import infractions as I
    cfg, jcfg = town02
    states = agents_on_town02(8, a=6)
    offset = np.asarray([[0.5, -0.5], [-1.0, 1.0]], np.float32)
    want = JI.lanelet_orientation_loss([jcfg.lanelet_map] * 2, jnp.asarray(states),
                                       jnp.asarray(offset))
    got = I.lanelet_orientation_loss([cfg.lanelet_map] * 2, t(states), t(offset))
    close(got, want)
    want = JI.lanelet_orientation_loss([jcfg.lanelet_map, None], jnp.asarray(states))
    close(I.lanelet_orientation_loss([cfg.lanelet_map, None], t(states)), want)


def test_lanelet_queries_match_jax(town02):
    from torchdrivesim_tpu import lanelet2 as JL
    from torchdrivesim_tpu_torch import lanelet2 as L
    cfg, jcfg = town02
    for x, y, _, _ in agents_on_town02(9, b=1, a=8)[0]:
        got = [ll.id for ll in L.lanelets_containing(cfg.lanelet_map, x, y, 1.0)]
        want = [ll.id for ll in JL.lanelets_containing(jcfg.lanelet_map, x, y, 1.0)]
        assert got == want
        try:
            want = JL.find_lanelet_directions(jcfg.lanelet_map, x, y, ['parking'])
        except JL.LaneletError:
            with pytest.raises(L.LaneletError):
                L.find_lanelet_directions(cfg.lanelet_map, x, y, ['parking'])
            continue
        assert L.find_lanelet_directions(cfg.lanelet_map, x, y, ['parking']) == want


def test_waypoint_goal_matches_jax():
    from torchdrivesim_tpu.goals import WaypointGoal as JaxGoal
    from torchdrivesim_tpu_torch.goals import WaypointGoal
    rng = np.random.RandomState(4)
    wp = rng.uniform(0, 10, (2, 3, 4, 2, 2)).astype(np.float32)
    mask = rng.rand(2, 3, 4, 2) > 0.2
    jg, g = JaxGoal(jnp.asarray(wp), jnp.asarray(mask)), WaypointGoal(wp, mask)
    for i in range(4):
        states = rng.uniform(0, 10, (2, 3, 4)).astype(np.float32)
        jg.step(jnp.asarray(states), threshold=4.0)
        g.step(t(states), threshold=4.0)
        close(g.state, jg.state, atol=0, rtol=0)
        close(g.mask, jg.mask, atol=0, rtol=0)
        for count in (1, 3):
            close(g.get_waypoints(count), jg.get_waypoints(count))
            close(g.get_masks(count), jg.get_masks(count), atol=0, rtol=0)
    other = g.copy()
    other.step(t(np.zeros((2, 3, 4), np.float32)), threshold=100.0)
    close(g.state, jg.state, atol=0, rtol=0)
    big, jbig = g.extend(2, in_place=False), jg.extend(2, in_place=False)
    close(big.get_waypoints(2), jbig.get_waypoints(2))
    sel = big.select_batch_elements([3, 0], in_place=False)
    jsel = jbig.select_batch_elements(np.asarray([3, 0]), in_place=False)
    close(sel.get_masks(2), jsel.get_masks(2), atol=0, rtol=0)
    assert g.waypoints.shape[0] == 2


def test_traffic_controls_match_jax():
    from torchdrivesim_tpu import traffic_controls as JT
    from torchdrivesim_tpu_torch import traffic_controls as T
    rng = np.random.RandomState(5)
    pos = np.concatenate([400 + rng.uniform(-5, 5, (2, 3, 2)), rng.uniform(1, 4, (2, 3, 2)),
                          rng.uniform(-3, 3, (2, 3, 1))], -1).astype(np.float32)
    replay = rng.randint(0, 3, (2, 3, 3)).astype(np.int32)
    jc = JT.TrafficLightControl(pos, replay_states=replay)
    c = T.TrafficLightControl(pos, replay_states=replay, device='cpu')
    c.actor_ids = [1, 2, 3]
    agents = np.concatenate([400 + rng.uniform(-5, 5, (2, 8, 2)),
                             np.broadcast_to([4.5, 2.0], (2, 8, 2)),
                             rng.uniform(-3, 3, (2, 8, 1))], -1).astype(np.float32)
    for time in range(5):
        jc.step(time)
        c.step(time)
        close(c.state, jc.state, atol=0, rtol=0)
        close(c.compute_violation(t(agents)), jc.compute_violation(jnp.asarray(agents)),
              atol=0, rtol=0)
    copied = c.copy()
    assert copied.actor_ids == [1, 2, 3]
    copied.step(0)
    close(c.state, jc.state, atol=0, rtol=0)
    big = c.extend(3, in_place=False)
    jbig = jc.extend(3, in_place=False)
    assert c.pos.shape[0] == 2 and big.actor_ids == [1, 2, 3]
    for name in ('pos', 'corners', 'mask', 'replay_states', 'state'):
        close(getattr(big, name), getattr(jbig, name))
        sel = big.select_batch_elements([5, 1], in_place=False)
        close(getattr(sel, name), getattr(jbig.select_batch_elements(
            np.asarray([5, 1]), in_place=False), name))
    assert not T.StopSignControl(pos, device='cpu').compute_violation(t(agents)).any()
    assert T.YieldControl(pos, device='cpu').total_replay_time == 0


def test_utils_match_jax():
    from torchdrivesim_tpu import utils as JU
    from torchdrivesim_tpu_torch import utils as U
    rng = np.random.RandomState(6)
    o, p = rng.uniform(-400, 400, (4, 2)), rng.uniform(-400, 400, (4, 2))
    opsi, ppsi = rng.uniform(-4, 4, (4, 1)), rng.uniform(-4, 4, (4, 1))
    for g, w in zip(U.relative(t(o), t(opsi), t(p), t(ppsi)),
                    JU.relative(*[jnp.asarray(x, jnp.float32) for x in (o, opsi, p, ppsi)])):
        close(g, w)
    pts = rng.uniform(-3, 3, (4, 5, 2)).astype(np.float32)
    pose = np.concatenate([o, opsi], -1).astype(np.float32)
    close(U.transform(t(pts), t(pose)), JU.transform(jnp.asarray(pts), jnp.asarray(pose)))
    square = np.asarray([[[0, 0], [2, 0], [2, 2], [0, 2]]] * 4, np.float32)
    close(U.is_inside_polygon(t(pts), t(square)),
          JU.is_inside_polygon(jnp.asarray(pts), jnp.asarray(square)), atol=0, rtol=0)
    close(U.isin(t([1, 2, 3], torch.int32), t([2, 5], torch.int32)), [False, True, False],
          atol=0, rtol=0)
    assert U.as_batch_index(3).tolist() == [3]
    assert U.host_repeat(t([[1.0], [2.0]]), 2).flatten().tolist() == [1, 1, 2, 2]


def test_mesh_batch_selection():
    from torchdrivesim_tpu_torch.mesh import BirdviewMesh
    verts = np.arange(3 * 4 * 2, dtype=np.float32).reshape(3, 4, 2)
    mesh = BirdviewMesh(verts=verts, faces=np.zeros((3, 2, 3), np.int32),
                        categories=['road'], vert_category=np.arange(12).reshape(3, 4))
    sel = mesh[torch.tensor([2, 0])]
    np.testing.assert_array_equal(sel.verts, verts[[2, 0]])
    np.testing.assert_array_equal(sel.vert_category, np.arange(12).reshape(3, 4)[[2, 0]])
    shared = BirdviewMesh(verts=verts[:1], faces=np.zeros((1, 2, 3), np.int32),
                          vert_category=np.zeros((1, 4), np.int32))
    assert shared.select_batch_elements([0, 0, 0]) is shared
