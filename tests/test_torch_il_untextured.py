"""
The imitation-learning path over an untextured road mesh as a whole,
against the JAX package, through the grouped soft raster:

* the behaviour-cloning rollout gradient over the examples' synthetic road
  (its road mesh plus the actor, ~50 faces per camera; B = 2, horizon 3,
  res 32) with ``MAX_FACES`` patched to 16 in both packages, so that the
  frames take the grouped path in several groups: the reference renders
  with its Pallas kernels in interpret mode (``jax_renderer._on_tpu``
  patched to True), each group's kernel call jitted. Loss to 1e-4 and every
  policy gradient to rtol 2e-3 (atol 1e-7), the tolerance of
  ``tests/test_torch_il.py``;
* one frame of the Town02 road mesh (~17,000 faces, B = 1, res 32) as the
  untextured IL scenario renders it, against the reference's plain XLA
  ``rasterize_softmax`` (its grouped Pallas path in interpret mode would
  take minutes at 133 groups), to that function's own tolerance against
  the grouped path;
* the differentiable render's pad-and-crop at a size that is not a
  multiple of 16, against the reference's renderer.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_grouped_soft import _counting, jax_grouped  # noqa: F401

torch.set_num_threads(1)


def test_bc_rollout_gradient_over_the_road_matches_jax(jax_grouped, monkeypatch):
    """The slice: the behaviour-cloning loss over 3 steps of the synthetic
    road (B = 2, res 32; road mesh and actor through the grouped path with
    16-face groups in both packages) and its gradient with respect to every
    policy parameter: loss to 1e-4, gradients to rtol 2e-3 (atol 1e-7), the
    tolerance of ``tests/test_torch_il.py``."""
    import torchdrivesim_tpu.kinematic as JK
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from tests.test_torch_il import _flax_policy, _port_policy
    from torchdrivesim_tpu.rendering import JaxRendererConfig
    from torchdrivesim_tpu.rendering.base import Cameras as JaxCameras
    from torchdrivesim_tpu.simulator import Simulator as JaxSimulator
    from torchdrivesim_tpu.simulator import TorchDriveConfig as JaxConfig
    from torchdrivesim_tpu.utils import Resolution as JaxResolution
    from torchdrivesim_tpu_torch.imitation import (
        build_synthetic_batch, build_synthetic_simulator, make_bc_loss_fn)
    jax_grouped(16)
    monkeypatch.setattr(jr, '_on_tpu', lambda: True)
    batch, horizon, res, features = 2, 3, 32, (4, 8)
    road, states0, expert = build_synthetic_batch(batch, horizon, device='cpu')
    sim = build_synthetic_simulator(road, states0, res=res)
    fpolicy, params = _flax_policy(4, features, res)
    policy = _port_policy(4, features, params)
    calls = _counting(monkeypatch, 'soft_accum_bwd_reference')
    loss = make_bc_loss_fn(sim, policy, res)(sim.state, expert)
    grads = torch.autograd.grad(loss, list(policy.parameters()))
    assert len(calls) == horizon - 1 and calls[0] >= 3 * 16   # several groups

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'examples'))
    try:
        from imitation_learning import build_synthetic_batch as jax_batch
    finally:
        sys.path.pop(0)
    jroad, jstates0, jexpert = jax_batch(batch, horizon)
    kin = JK.SimpleKinematicModel(dt=0.1)
    kin.set_state(jstates0)
    cfg = JaxConfig()
    cfg.renderer = JaxRendererConfig(differentiable=True)
    jsim = JaxSimulator(road_mesh=jroad, kinematic_model=kin,
                        agent_size=jnp.tile(jnp.asarray([[[4.6, 2.0]]]), (batch, 1, 1)),
                        initial_present_mask=jnp.ones((batch, 1), dtype=bool), cfg=cfg)
    gen, renderer = jsim.birdview_mesh_generator, jsim.renderer

    def jloss(params):
        # the example's loss (examples/imitation_learning.py:loss_fn), its
        # scan written out
        state, preds = jsim.state, []
        for t in range(horizon):
            all_state = jnp.concatenate([state.agent_state, state.npc_state], -2)
            present = jnp.concatenate([state.present_mask, state.npc_present_mask], -1)
            mesh = gen.generate(1, agent_state=all_state[:, None],
                                present_mask=present[:, None], include_background=True)
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
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    from torchdrivesim_tpu_torch.convert import policy_state_dict_from_flax
    want = policy_state_dict_from_flax(jax.tree.map(np.asarray, want_grads))
    for (name, _), g in zip(policy.named_parameters(), grads):
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-3, atol=1e-7, err_msg=name)


def test_town02_road_frame_matches_xla():
    """One frame of the Town02 road mesh (~17,000 faces, B = 1, res 32) as
    the untextured IL scenario renders it, against the reference's plain
    XLA ``rasterize_softmax`` on the same screen-space mesh, to that
    function's own tolerance against the grouped path
    (``tests/test_pallas_soft.py:127-128``)."""
    from torchdrivesim_tpu.ops.rasterize import rasterize_softmax
    from torchdrivesim_tpu_torch.benchmark import build_il_scenario, il_view
    from torchdrivesim_tpu_torch.ops.rasterize import camera_rows_cols
    res = 32
    scn = build_il_scenario(batch_size=1, res=res, use_texture=False, device='cpu')
    renderer = scn.sim.renderer
    mesh, cams = il_view(scn, scn.sim.state)
    assert mesh.faces.shape[1] > 16000
    with torch.no_grad():
        got = renderer.render_rgb_mesh_chw(mesh, renderer.res, cams).numpy() / 255.0
    rc = camera_rows_cols(mesh.verts[..., :2], cams.xy, cams.sc, cams.scale, res,
                          left_handed=renderer.cfg.left_handed_coordinates)
    sv = torch.cat([rc, mesh.verts[..., 2:3]], dim=-1).numpy()
    bg = np.broadcast_to(renderer._background_color.numpy(), (1, res, res, 3))
    want = np.asarray(jax.jit(lambda v, a: rasterize_softmax(
        v, jnp.asarray(mesh.faces.numpy()), a, res, jnp.asarray(bg)))(
        sv, mesh.attrs.numpy()))
    np.testing.assert_allclose(got, np.transpose(want, (0, 3, 1, 2)), rtol=1e-4, atol=2e-3)
    assert (got > 0.05).any(axis=1).mean() > 0.5     # the frame shows the map


def test_differentiable_render_pads_and_crops(jax_grouped, monkeypatch):
    """A differentiable render at a size that is not a multiple of 16
    (res 100, 200 faces: the grouped path, 16-face groups in both packages)
    renders at 112 with the cameras moved, at the same pixels per meter,
    and returns the top-left crop, as the reference's ``_pad_res_target``
    does: against ``JaxRenderer(differentiable=True).render_rgb_mesh_chw``
    on its TPU path (``_on_tpu`` patched, the kernels in interpret mode),
    in float64 to 1e-9 and in float32 as ``tests/test_torch_soft.py``
    judges; gradients reach the vertices."""
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from tests.test_torch_soft import _f64, _judge, float64_jax
    from torchdrivesim_tpu.mesh import RGBMesh as JaxMesh
    from torchdrivesim_tpu.ops import pallas_soft as PS
    from torchdrivesim_tpu.rendering import JaxRendererConfig
    from torchdrivesim_tpu.rendering.base import Cameras as JaxCameras
    from torchdrivesim_tpu.utils import Resolution as JaxResolution
    from torchdrivesim_tpu_torch.mesh import RGBMesh
    from torchdrivesim_tpu_torch.rendering.base import Cameras, RendererConfig
    from torchdrivesim_tpu_torch.rendering.renderer import Renderer
    from torchdrivesim_tpu_torch.utils import Resolution
    jax_grouped(16)
    monkeypatch.setattr(jr, '_on_tpu', lambda: True)
    res, fov, b, n_faces = 100, 40.0, 2, 200
    rng = np.random.RandomState(3)
    xy = rng.uniform(-50, 50, (b, 2)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, b)
    sc = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    corners = xy[:, None, None] + rng.uniform(-0.6, 0.6, (b, n_faces, 1, 2)) * fov \
        + rng.uniform(-0.15, 0.15, (b, n_faces, 3, 2)) * fov
    z = np.repeat(rng.randint(2, 6, (b, n_faces, 1)), 3, axis=2)
    verts = np.concatenate([corners, z[..., None]], -1).reshape(
        b, n_faces * 3, 3).astype(np.float32)
    faces = np.tile(np.arange(n_faces * 3).reshape(1, n_faces, 3), (b, 1, 1))
    attrs = np.repeat(rng.rand(b, n_faces, 1, 3), 3, axis=2).reshape(
        b, n_faces * 3, 3).astype(np.float32)

    jren = jr.JaxRenderer(JaxRendererConfig(differentiable=True))

    def reference(v, a, cam_xy, cam_sc):
        return np.asarray(jren.render_rgb_mesh_chw(
            JaxMesh(v, jnp.asarray(faces), a), JaxResolution(res, res),
            JaxCameras(cam_xy, cam_sc, 2.0 / fov)))

    want = reference(*map(jnp.asarray, (verts, attrs, xy, sc)))
    with float64_jax(PS):
        exact = reference(*_f64(verts, attrs, xy, sc))

    renderer = Renderer(RendererConfig(differentiable=True), 'cpu')
    calls = _counting(monkeypatch, 'soft_accum_fwd')

    def port(dtype):
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)
        leaf = t(verts).requires_grad_(True)
        image = renderer.render_rgb_mesh_chw(
            RGBMesh(leaf, torch.from_numpy(faces), t(attrs)), Resolution(res, res),
            Cameras(t(xy), t(sc), 2.0 / fov))
        image.sum().backward()
        assert torch.isfinite(leaf.grad).all() and leaf.grad.abs().max() > 0
        return image.detach().numpy()

    got, got64 = port(torch.float32), port(torch.float64)
    assert got.shape == (b, 3, res, res) and calls == [208, 208]
    _judge(got / 255.0, got64 / 255.0, want / 255.0, exact / 255.0, 'padded image')
