"""
The port's ``parallel`` module and the renderer's batch split, on an
8-entry CPU mesh (the counterpart of the JAX package's 8 virtual CPU
devices), mirroring ``tests/test_parallel.py``: placement against the JAX
package's shardings, the sharded rollout against the JAX package's sharded
rollout, every split render against the unsharded one (bit for bit, the
plain kernel called once per slice), the gradients of the differentiable
render, a replicated policy's Adam step; and the two faults closed with it:
``MapConfig.road_mesh`` triangulating the Lanelet2 map without a mesh file,
``Simulator.to`` returning the simulator for any device.
"""
import dataclasses
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdrivesim_tpu_torch import parallel as P

torch.set_num_threads(1)

CPU8 = [torch.device('cpu')] * 8
B, A = 2, 2


def port_simulator(with_npcs=False):
    """``tests/test_simulator._build_simulator`` in the port: the straight
    synthetic lanelet map, 2 environments of 2 bicycles, one replayed
    light, two waypoint collections per agent, optionally one NPC."""
    import torchdrivesim_tpu_torch.kinematic as K
    from tests.test_lanelet2_and_map import _straight_lanelet_map
    from tests.test_torch_bake import _port_lanelet_map
    from torchdrivesim_tpu_torch.goals import WaypointGoal
    from torchdrivesim_tpu_torch.lanelet2 import road_mesh_from_lanelet_map
    from torchdrivesim_tpu_torch.mesh import BirdviewMesh
    from torchdrivesim_tpu_torch.simulator import (
        NPCController, Simulator, TorchDriveConfig)
    from torchdrivesim_tpu_torch.traffic_controls import TrafficLightControl
    m = _port_lanelet_map(_straight_lanelet_map())
    road = BirdviewMesh.set_properties(road_mesh_from_lanelet_map(m), 'road')
    road = BirdviewMesh.collate([road] * B)
    kin = K.KinematicBicycle(dt=0.1, device='cpu')
    kin.set_params(lr=torch.full((B, A), 1.0))
    kin.set_state(torch.tensor([[[5., 0., 0., 2.], [15., 0.5, 0., 3.]]] * B))
    controls = {'traffic_light': TrafficLightControl(
        torch.tensor([[[30., 0., 1., 4., 0.]]] * B),
        replay_states=torch.tensor([[[0, 2, 2]]] * B), device='cpu')}
    waypoints = torch.tensor([[[[[10., 0.]], [[20., 0.]]],
                               [[[25., 0.5]], [[40., 0.5]]]]] * B)
    npc = NPCController(torch.full((B, 1, 2), 2.0),
                        torch.tensor([[[35., -0.5, np.pi, 1.]]] * B)) if with_npcs else None
    return Simulator(road_mesh=road, kinematic_model=kin,
                     agent_size=torch.tensor([[[4.0, 2.0], [4.5, 2.1]]] * B),
                     initial_present_mask=torch.ones((B, A), dtype=torch.bool),
                     cfg=TorchDriveConfig(), lanelet_map=[m] * B,
                     traffic_controls=controls, waypoint_goals=WaypointGoal(waypoints),
                     npc_controller=npc)


def random_texture():
    """The reference test's texture: 256 x 256 uniform colors (numpy seed
    0) over [-40, 152] m at 0.75 m per texel."""
    from torchdrivesim_tpu_torch.ops.grids import Grid2D
    rng = np.random.RandomState(0)
    return Grid2D(data=np.asarray(rng.rand(256, 256, 3), np.float32),
                  origin=np.asarray([-40.0, -40.0], np.float32), cell_size=0.75)


def ego_cameras(state, fov):
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    ego = state.agent_state[:, 0]
    return Cameras(ego[:, :2], torch.stack([torch.sin(ego[:, 2]), torch.cos(ego[:, 2])],
                                           dim=-1), 2.0 / fov)


def prims_rollout(sim, res=64, steps=3, fov=40.0, packed=False):
    """``steps`` zero-action steps, each rendered by ``render_prims_chw``
    from the egos (the reference test's ``_prims_rollout``): (final state,
    (steps, B, ...) images)."""
    from torchdrivesim_tpu_torch.utils import Resolution
    gen, state, images = sim.birdview_mesh_generator, sim.state, []
    for _ in range(steps):
        state = sim.functional_step(
            state, torch.zeros((sim.batch_size, sim.agent_count, 2)))
        prims = gen.generate_prims(
            torch.cat([state.agent_state, state.npc_state], dim=-2),
            present_mask=torch.cat([state.present_mask, state.npc_present_mask], dim=-1),
            traffic_light_state=state.traffic_control_state['traffic_light'])
        images.append(sim.renderer.render_prims_chw(
            *prims, Resolution(res, res), ego_cameras(state, fov), packed=packed))
    return state, torch.stack(images)


def count_calls(monkeypatch, module, name):
    """Counts the calls of ``module.name`` from now on: a one-entry list."""
    calls = [0]
    original = getattr(module, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@dataclasses.dataclass
class _Pair:
    first: torch.Tensor
    second: object


def test_shard_batched_tree_placement_matches_jax():
    """The reference test's tree plus a rank-0 tensor, an empty batch,
    None and nested containers: which leaves are batch-sharded equals the
    JAX package's ``not is_fully_replicated`` on its 8-device mesh, every
    tensor lands on the mesh's first device with its value, the containers
    keep their types."""
    from torchdrivesim_tpu import parallel as J
    rng = np.random.RandomState(0)
    leaves = {'batched': rng.randn(16, 3), 'scalar': np.float32(1.0),
              'odd': rng.randn(3, 2), 'rank0': np.asarray(2.5, np.float32),
              'empty': np.zeros((0, 2), np.float32), 'eight': rng.randn(8)}
    leaves = {k: np.asarray(v, np.float32) for k, v in leaves.items()}
    jmesh = J.make_mesh(8)
    jplaced = J.shard_batched_tree({k: jnp.asarray(v) for k, v in leaves.items()}, jmesh)
    mesh = P.make_mesh(devices=CPU8)
    tree = {k: torch.from_numpy(v) for k, v in leaves.items()}
    tree.update(none=None, label='x', nested=(
        [tree['eight'], None], _Pair(tree['odd'], {'b': tree['batched']})))
    placed = P.shard_batched_tree(tree, mesh)
    for k, v in leaves.items():
        sharded = P.leaf_sharding(tree[k], mesh).spec == (P.BATCH_AXIS,)
        assert sharded == (not jplaced[k].sharding.is_fully_replicated), k
        assert placed[k].device == mesh.devices[0]
        np.testing.assert_array_equal(placed[k].numpy(), np.asarray(jplaced[k]))
    assert placed['none'] is None and placed['label'] == 'x'
    (lst, pair) = placed['nested']
    assert isinstance(lst, list) and lst[1] is None and isinstance(pair, _Pair)
    assert torch.equal(pair.second['b'], tree['batched'])
    replicated = P.replicate_tree(tree, mesh)
    assert torch.equal(replicated['odd'], tree['odd'])
    assert P.batch_sharding(mesh) == (mesh, ('batch',))
    assert P.replicated_sharding(mesh) == (mesh, ())


def test_make_mesh(monkeypatch):
    """Without a card ``make_mesh()`` raises (never a CPU fallback);
    ``make_mesh(n, devices=...)`` takes the first n entries."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        P.make_mesh()
    mesh = P.make_mesh(4, devices=CPU8)
    assert mesh.size == 4 and mesh.devices == (torch.device('cpu'),) * 4
    assert mesh.axis_names == (P.BATCH_AXIS,) == ('batch',)
    assert P.make_mesh(devices=['cpu', 'cpu']).size == 2


def test_shard_simulator_indivisible_batch_raises_as_the_reference():
    from tests.test_simulator import _build_simulator
    from torchdrivesim_tpu import parallel as J
    with pytest.raises(ValueError) as want:
        J.shard_simulator(_build_simulator(), J.make_mesh(8))
    with pytest.raises(ValueError) as got:
        P.shard_simulator(port_simulator(), P.make_mesh(devices=CPU8))
    assert str(got.value) == str(want.value)


def test_sharded_rollout_matches_jax():
    """12 seeded steps of the reference test's scene at batch 8, each
    package sharded 8 ways: trajectories within 1e-5."""
    from tests.test_simulator import _build_simulator
    from torchdrivesim_tpu import parallel as J
    actions = np.random.RandomState(0).uniform(-0.3, 0.3, (12, 8, 2, 2)).astype(np.float32)

    jsim = _build_simulator().extend(4, in_place=False)
    jmesh = J.make_mesh(8)

    def rollout(state, actions):
        def body(s, a):
            s = jsim.functional_step(s, a)
            return s, s.agent_state
        return jax.lax.scan(body, state, actions)

    jactions = jax.device_put(jnp.asarray(actions), jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec(None, J.BATCH_AXIS)))
    _, want = jax.jit(rollout)(J.shard_batched_tree(jsim.state, jmesh), jactions)

    sim = P.shard_simulator(port_simulator().extend(4, in_place=False),
                            P.make_mesh(devices=CPU8))
    assert sim.batch_size == 8 and sim.renderer.shard_mesh.size == 8
    got = []
    for a in torch.from_numpy(actions):
        sim.step(a)
        got.append(sim.state.agent_state)
    np.testing.assert_allclose(torch.stack(got).numpy(), np.asarray(want), atol=1e-5)


def _sharded_against_plain(monkeypatch, sim, counted, **kwargs):
    """The rollout unsharded, then sharded 8 ways through
    ``shard_simulator``: both results, the plain kernel's calls per frame of
    each."""
    from torchdrivesim_tpu_torch.ops import fused, prims
    module = fused if counted == 'fused' else prims
    name = 'render_coefs_fused_reference' if counted == 'fused' else 'raster_prims_reference'
    calls = count_calls(monkeypatch, module, name)
    steps = kwargs.get('steps', 3)
    plain = prims_rollout(sim, **kwargs)
    per_frame_plain, calls[0] = calls[0] / steps, 0
    mesh = P.make_mesh(devices=CPU8)
    sim = P.shard_simulator(sim, mesh)
    assert sim.renderer.shard_mesh is mesh
    sharded = prims_rollout(sim, **kwargs)
    return plain, sharded, (per_frame_plain, calls[0] / steps)


@pytest.mark.parametrize('textured', [False, True], ids=['banded', 'fused_warp'])
def test_sharded_prim_render_matches_unsharded(monkeypatch, textured):
    """The primitive render (the banded raster, B7, untextured; the fused
    render, B1, over the texture) split 8 ways gives the unsharded images
    bit for bit, its plain kernel called 8 times a frame against once."""
    sim = port_simulator(with_npcs=True).extend(4, in_place=False)
    if textured:
        sim.renderer.background_texture = random_texture()
    (final_plain, plain), (final_shard, sharded), calls = _sharded_against_plain(
        monkeypatch, sim, 'fused' if textured else 'banded')
    assert calls == (1, 8)
    assert plain.max() > 0
    assert sharded.device == torch.device('cpu')
    assert torch.equal(sharded, plain)
    np.testing.assert_allclose(final_shard.agent_state.numpy(),
                               final_plain.agent_state.numpy(), atol=1e-6)


@pytest.mark.parametrize('variant', ['tiled_192', 'packed_rgb8'])
def test_sharded_prim_render_variants_match_unsharded(monkeypatch, variant):
    """The n x n sub-camera tiling at res 192 (2 x 2 sub-views of 96 per
    camera, stitched per slice) and the packed output, split 8 ways: bit
    for bit."""
    sim = port_simulator(with_npcs=True).extend(4, in_place=False)
    sim.renderer.background_texture = random_texture()
    res = 192 if variant == 'tiled_192' else 64
    packed = variant == 'packed_rgb8'
    if variant == 'tiled_192':
        assert sim.renderer._tiled_mip(2.0 / 40.0, res) is not None
    (_, plain), (_, sharded), calls = _sharded_against_plain(
        monkeypatch, sim, 'fused', res=res, steps=2, packed=packed)
    assert calls == (1, 8)
    assert plain.abs().max() > 0
    if packed:
        assert sharded.dtype == torch.int32 and sharded.shape == (2, 8, res, res)
    assert torch.equal(sharded, plain)


def test_nondivisible_render_batch_warns_and_renders_whole(monkeypatch, caplog):
    """A batch of 6 on the 8-entry mesh: one warning that says 'not
    divisible', one plain call a frame, the unsharded image."""
    from torchdrivesim_tpu_torch.ops import prims
    sim = port_simulator(with_npcs=True).extend(3, in_place=False)
    assert sim.batch_size == 6
    _, plain = prims_rollout(sim, steps=1)
    calls = count_calls(monkeypatch, prims, 'raster_prims_reference')
    sim.renderer.shard_mesh = P.make_mesh(devices=CPU8)   # past shard_simulator's check
    with caplog.at_level(logging.WARNING, logger='torchdrivesim_tpu_torch.rendering.renderer'):
        _, whole = prims_rollout(sim, steps=2)
    assert sum('not divisible' in m for m in caplog.messages) == 1
    assert calls[0] == 2
    assert torch.equal(whole[:1], plain)


def test_sharded_diff_render_gradients_match_unsharded(monkeypatch):
    """The differentiable mesh render (the bilinear warp B3 and its VJP,
    the soft raster B4a / B4b, all plain here) through 3 steps, split 8
    ways: the loss and its gradient to the agent states within the
    reference test's tolerances, each kernel's plain version called 8
    times a frame."""
    from torchdrivesim_tpu_torch.ops import soft, warp
    from torchdrivesim_tpu_torch.utils import Resolution
    sim = port_simulator(with_npcs=True).extend(4, in_place=False)
    res = 64
    sim.renderer.cfg.differentiable = True
    sim.renderer.cfg.soft_blend = 'softmax'
    sim.renderer.background_texture = random_texture()
    assert sim.renderer.cfg.diff_fast_background
    gen, renderer = sim.birdview_mesh_generator, sim.renderer
    b, a = sim.batch_size, sim.agent_count
    ramp = torch.arange(res, dtype=torch.float32) / res

    def loss_fn(agent_state):
        s = dataclasses.replace(sim.state, agent_state=agent_state)
        total = 0.0
        for _ in range(3):
            mesh = gen.generate(
                1, agent_state=torch.cat([s.agent_state, s.npc_state], dim=-2)[:, None],
                present_mask=torch.cat([s.present_mask, s.npc_present_mask], dim=-1)[:, None],
                include_background=False)
            img = renderer.render_rgb_mesh_chw(mesh, Resolution(res, res),
                                               ego_cameras(s, 40.0))
            act = torch.mean(img * ramp[None, None, None, :], dim=(1, 2, 3))
            action = torch.zeros((b, a, 2)).index_put(
                (torch.arange(b), torch.zeros(b, dtype=torch.long),
                 torch.zeros(b, dtype=torch.long)), act * 1e-3)
            s = sim.functional_step(s, action)
            total = total + torch.sum(act)
        return total + torch.sum(s.agent_state[:, :, :2] ** 2) * 1e-3

    def value_and_grad():
        x = sim.state.agent_state.clone().requires_grad_(True)
        loss = loss_fn(x)
        grad, = torch.autograd.grad(loss, x)
        return loss.item(), grad.numpy()

    names = ((warp, 'warp_background_bilinear_reference'), (warp, 'warp_bilinear_vjp_reference'),
             (soft, 'soft_raster_fwd_reference'), (soft, 'soft_raster_bwd_reference'))
    calls = [count_calls(monkeypatch, m, n) for m, n in names]
    loss_plain, grad_plain = value_and_grad()
    assert [c[0] for c in calls] == [3, 3, 3, 3]
    assert np.isfinite(loss_plain) and np.abs(grad_plain).max() > 0
    for c in calls:
        c[0] = 0
    mesh = P.make_mesh(devices=CPU8)
    P.shard_simulator(sim, mesh)
    assert sim.renderer.shard_mesh is mesh
    loss_shard, grad_shard = value_and_grad()
    assert [c[0] for c in calls] == [24, 24, 24, 24]
    np.testing.assert_allclose(loss_shard, loss_plain, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad_shard, grad_plain, rtol=3e-4, atol=2e-6)


def test_sharded_faces_and_mesh_renders_match_unsharded():
    """The face soup (``render_faces_chw``: B2 under B6a) and the hard mesh
    render (``render_rgb_mesh_chw``: B6a) split 8 ways: bit for bit."""
    from torchdrivesim_tpu_torch.utils import Resolution
    sim = port_simulator(with_npcs=True).extend(4, in_place=False)
    sim.renderer.background_texture = random_texture()
    s, gen = sim.state, sim.birdview_mesh_generator
    all_state = torch.cat([s.agent_state, s.npc_state], dim=-2)
    present = torch.cat([s.present_mask, s.npc_present_mask], dim=-1)
    faces = gen.generate_faces(all_state, present_mask=present,
                               traffic_light_state=s.traffic_control_state['traffic_light'])
    mesh = gen.generate(1, agent_state=all_state[:, None], present_mask=present[:, None],
                        include_background=False)
    cams = ego_cameras(s, 40.0)

    def frames():
        return (sim.renderer.render_faces_chw(*faces, Resolution(64, 64), cams),
                sim.renderer.render_rgb_mesh_chw(mesh, Resolution(64, 64), cams))

    plain = frames()
    P.shard_simulator(sim, P.make_mesh(devices=CPU8))
    for got, want in zip(frames(), plain):
        assert want.max() > 0
        assert torch.equal(got, want)


def test_replicated_policy_adam_step_matches_unsharded():
    """One Adam step of a ``BirdviewCNNPolicy`` whose parameters went
    through ``replicate_tree`` on a batch that went through
    ``shard_batched_tree``: the parameters after it equal the unsharded
    step's to 1e-5."""
    from torchdrivesim_tpu_torch.models import BirdviewCNNPolicy
    rng = np.random.RandomState(0)
    obs = torch.from_numpy(rng.rand(16, 3, 16, 16).astype(np.float32))
    target = torch.from_numpy(rng.uniform(-0.5, 0.5, (16, 2)).astype(np.float32))
    mesh = P.make_mesh(devices=CPU8)

    def stepped(sharded):
        torch.manual_seed(0)
        policy = BirdviewCNNPolicy(action_size=2, features=(4,))
        x, y = obs, target
        if sharded:
            policy.load_state_dict(P.replicate_tree(policy.state_dict(), mesh))
            x, y = P.shard_batched_tree((obs, target), mesh)
        opt = torch.optim.Adam(policy.parameters(), lr=1e-2)
        loss = torch.mean((policy(x) - y) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return [p.detach().numpy() for p in policy.parameters()]

    for got, want in zip(stepped(True), stepped(False)):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_renderer_copy_keeps_shard_mesh():
    sim = port_simulator()
    mesh = P.make_mesh(devices=CPU8[:2])
    sim.renderer.shard_mesh = mesh
    assert sim.renderer.copy().shard_mesh is mesh
    assert sim.copy().renderer.shard_mesh is mesh


def test_per_device_tables_are_built_once_per_device():
    """A shard device other than the renderer's own gets the renderer's
    tables moved there at its first use, kept for the next, and dropped
    when the texture changes (the meta device stands in for a second
    card)."""
    renderer = port_simulator().renderer
    renderer.background_texture = random_texture()
    assert renderer._on_device(torch.device('cpu')) is renderer
    meta = torch.device('meta')
    view = renderer._on_device(meta)
    assert view is renderer._on_device(meta) and view.shard_mesh is None
    assert view.device == meta and view._background_color.device == meta
    assert all(level.data.device == meta for level in view._mip_pyramid)
    assert view._packed_texture.data.device == meta
    assert view._packed_texture.origin.device == meta
    offs, off_fl = view.subcamera_offsets(192, 96, 2.0 / 40.0, 2)
    assert offs.device == meta and off_fl.device == meta
    assert len(renderer._mip_pyramid) == len(view._mip_pyramid)
    renderer.background_texture = None
    assert renderer._on_device(meta) is not view


def test_road_mesh_triangulates_the_lanelet_map():
    """Town02 without its mesh file: the lane markings merged over the
    road surface, as the JAX package builds it (25,452 vertices, 16,920
    faces); faces, categories and the road's vertices exact, the lane
    strips' offsets as ``tests/test_torch_interaction._check_lane_verts``
    holds them (the reference's compiled CPU code may fuse two products
    there)."""
    from tests.test_torch_interaction import _check_lane_verts
    from torchdrivesim_tpu.map import find_map_config as jax_find
    from torchdrivesim_tpu_torch.map import find_map_config
    got = dataclasses.replace(find_map_config('carla_Town02'), mesh_path=None).road_mesh
    want = dataclasses.replace(jax_find('carla_Town02'), mesh_path=None).road_mesh
    assert got.verts.shape == (1, 25452, 2) and got.faces.shape == (1, 16920, 3)
    np.testing.assert_array_equal(got.faces, np.asarray(want.faces))
    np.testing.assert_array_equal(got.vert_category, np.asarray(want.vert_category))
    assert list(got.categories) == list(want.categories) == ['left_lane', 'right_lane', 'road']
    n_lane = int(np.asarray(want.verts).shape[1]) - 5148
    np.testing.assert_array_equal(got.verts[:, n_lane:], np.asarray(want.verts)[:, n_lane:])
    _check_lane_verts(got.verts[:, :n_lane], np.asarray(want.verts)[:, :n_lane],
                      'Town02 road mesh')
    assert got.colors.keys() == want.colors.keys() and got.zs == want.zs
    for cat in got.colors:
        np.testing.assert_array_equal(np.asarray(got.colors[cat]), np.asarray(want.colors[cat]))
    cfg = find_map_config('carla_Town02')
    assert dataclasses.replace(cfg, mesh_path=None, lanelet_path=None).road_mesh is None


@pytest.mark.parametrize('device', ['cpu', 'meta', None])
def test_simulator_to_returns_itself(device):
    """``Simulator.to`` returns the simulator for any device and leaves
    its next step as it was."""
    sim, twin = port_simulator(with_npcs=True), port_simulator(with_npcs=True)
    action = torch.full((B, A, 2), 0.2)
    assert sim.to(device) is sim
    sim.step(action)
    twin.step(action)
    assert sim.state.agent_state.device == torch.device('cpu')
    assert torch.equal(sim.state.agent_state, twin.state.agent_state)


def test_parallel_imports_neither_jax_nor_distributed():
    """The module and the renderer load without JAX, the JAX package or a
    ``torch.distributed`` module that ``import torch`` did not load."""
    code = ('import sys, torch; before = set(sys.modules); '
            'import torchdrivesim_tpu_torch.parallel, '
            'torchdrivesim_tpu_torch.rendering.renderer; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "torchdrivesim_tpu") '
            'or (m.startswith("torch.distributed") and m not in before)]; '
            'assert not bad, bad')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, '-c', code], cwd=root, check=True, timeout=120)
