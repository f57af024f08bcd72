"""
The imitation-learning gradient path as a whole, against the JAX package:

* the config-4 gradient (the reference's ``tools/bench_suite.py:
  config4_il_gradients`` at B = 2, 4 vehicles, res 64, horizon 3, policy
  features (4, 8) in float32): the JAX scenario is built with its Pallas
  kernels in interpret mode and the mip pyramid (as on a TPU, so its render
  runs the bilinear warp and the soft-raster kernels), the port's scenario
  from the same data (``convert.py``), and the flax parameters carried
  across. Loss to 1e-4 relative; every parameter gradient to rtol 2e-3,
  atol 1e-7, the JAX package's own tolerance between two of its remat
  schedules (``tests/test_imitation_learning.py``);
* the behaviour-cloning loop (``examples/imitation_learning.py``) on the
  synthetic road at res 32: the port drives the loss down at least 3x in
  25 Adam steps, and its first three losses equal the JAX example's with
  the same float32 parameters to 1e-3 relative (the reference renders
  through its plain XLA soft raster on the CPU; sums in another order).
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slice import _arrays
from torchdrivesim_tpu_torch.benchmark import make_il_grad_fn
from torchdrivesim_tpu_torch.convert import policy_state_dict_from_flax, scenario_from_arrays
from torchdrivesim_tpu_torch.imitation import (
    build_synthetic_batch, build_synthetic_simulator, make_bc_train_step, make_optimizer,
)
from torchdrivesim_tpu_torch.models import BirdviewCNNPolicy

torch.set_num_threads(1)

B, AGENTS, RES, HORIZON, FEATURES = 2, 4, 64, 3, (4, 8)


def _flax_policy(action_size, features, res):
    from torchdrivesim_tpu.models import BirdviewCNNPolicy as FlaxPolicy
    policy = FlaxPolicy(action_size=action_size, features=features, dtype=jnp.float32)
    params = policy.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, res, res)))
    return policy, params


def _port_policy(action_size, features, params):
    port = BirdviewCNNPolicy(action_size, features, dtype=torch.float32)
    port.load_state_dict(policy_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    return port


@pytest.fixture(scope='module')
def jax_il():
    """The JAX config-4 scenario, built and differentiated with the warp and
    soft kernels in interpret mode, and its loss and gradient at the flax
    policy's parameters."""
    import random

    import torchdrivesim_tpu.ops.pallas_fused as F
    import torchdrivesim_tpu.ops.pallas_rasterize as R
    import torchdrivesim_tpu.ops.pallas_soft as PS
    import torchdrivesim_tpu.ops.pallas_warp as W
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from torchdrivesim_tpu.benchmark import build_benchmark_scenario
    from torchdrivesim_tpu.rendering.base import Cameras
    from torchdrivesim_tpu.traffic_controls import BaseTrafficControl
    from torchdrivesim_tpu.utils import Resolution
    copy = BaseTrafficControl.copy

    def copy_keeping_ids(self):
        other = copy(self)
        if hasattr(self, 'actor_ids'):
            other.actor_ids = self.actor_ids
        return other

    saved = random.getstate()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(BaseTrafficControl, 'copy', copy_keeping_ids)
        m.setattr(jr, '_on_tpu', lambda: True)
        for mod in (W, R, F, PS):
            m.setattr(mod.pl, 'pallas_call',
                      functools.partial(mod.pl.pallas_call, interpret=True))
        try:
            scn = build_benchmark_scenario(batch_size=B, agent_count=AGENTS, res=RES)
        finally:
            random.setstate(saved)
        sim = scn.sim
        sim.renderer.cfg.differentiable = True
        gen, renderer = sim.birdview_mesh_generator, sim.renderer
        policy, params = _flax_policy(2, FEATURES, RES)

        def loss_fn(params, state):
            def body(s, _):
                all_state = jnp.concatenate([s.agent_state, s.npc_state], -2)
                present = jnp.concatenate([s.present_mask, s.npc_present_mask], -1)
                mesh = gen.generate(1, all_state[:, None], present[:, None],
                                    include_background=False)
                ego = s.agent_state[:, 0]
                cams = Cameras(ego[:, :2], jnp.stack([jnp.sin(ego[:, 2]),
                                                      jnp.cos(ego[:, 2])], -1),
                               2.0 / scn.fov)
                image = renderer.render_rgb_mesh_chw(mesh, Resolution(RES, RES), cams)
                act = policy.apply(params, image)
                action = jnp.zeros((B, AGENTS, 2)).at[:, 0].set(act)
                return sim.functional_step(s, action), None
            final, _ = jax.lax.scan(body, state, None, length=HORIZON)
            return jnp.mean(final.agent_state[:, 0, :2] ** 2)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, sim.state)
    # the patches end here: later tests run the JAX package as it ships
    return scn, params, float(loss), grads


def test_config4_gradient_matches_jax(jax_il):
    scn, params, want_loss, want_grads = jax_il
    port = scenario_from_arrays(_arrays(scn), device='cpu')
    port.sim.renderer.cfg.differentiable = True
    policy = _port_policy(2, FEATURES, params)
    loss, grads = make_il_grad_fn(port, policy, horizon=HORIZON)(port.sim.state)
    print(f'loss: port {float(loss)!r}, reference {want_loss!r}')
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
    want = policy_state_dict_from_flax(jax.tree.map(np.asarray, want_grads))
    names = [n for n, _ in policy.named_parameters()]
    assert len(names) == len(grads) == len(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-3, atol=1e-7, err_msg=name)


def test_config4_render_launches_one_of_each_per_step(jax_il, monkeypatch):
    """One gradient step calls the bilinear warp and the soft-raster forward
    once per rollout step and renders nothing again on the backward sweep.
    The warp's pose VJP and the soft-raster backward run once per step but
    the first: the first frame is drawn from the given state, which nothing
    differentiates, so autograd needs no gradient of its operands (the
    reference's scan runs that backward all the same and discards it)."""
    from torchdrivesim_tpu_torch.ops import soft, warp
    calls = {'warp': 0, 'vjp': 0, 'fwd': 0, 'bwd': 0}

    def counting(fn, key):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(warp, 'warp_background_bilinear',
                        counting(warp.warp_background_bilinear, 'warp'))
    monkeypatch.setattr(warp, 'warp_bilinear_vjp',
                        counting(warp.warp_bilinear_vjp, 'vjp'))
    monkeypatch.setattr(soft, 'soft_raster_fwd', counting(soft.soft_raster_fwd, 'fwd'))
    monkeypatch.setattr(soft, 'soft_raster_bwd', counting(soft.soft_raster_bwd, 'bwd'))
    scn, params = jax_il[:2]
    port = scenario_from_arrays(_arrays(scn), device='cpu')
    port.sim.renderer.cfg.differentiable = True
    make_il_grad_fn(port, _port_policy(2, FEATURES, params), horizon=3)(port.sim.state)
    assert calls == {'warp': 3, 'vjp': 2, 'fwd': 3, 'bwd': 2}


def test_bc_loop_learns_and_matches_jax_example():
    batch, horizon, res, steps = 4, 6, 32, 25
    road, states0, expert = build_synthetic_batch(batch, horizon, device='cpu')
    sim = build_synthetic_simulator(road, states0, res=res)
    fpolicy, params = _flax_policy(4, (16, 32), res)
    policy = _port_policy(4, (16, 32), params)
    train_step = make_bc_train_step(sim, policy, make_optimizer(policy), res)
    losses = [float(train_step(sim.state, expert)) for _ in range(steps)]
    assert np.all(np.isfinite(losses)), losses
    initial, final = losses[0], float(np.mean(losses[-3:]))
    assert final < initial / 3.0, losses
    assert float(np.mean(losses[-5:])) < float(np.mean(losses[:5])), losses

    # the JAX example's first three steps from the same parameters
    import optax
    import torchdrivesim_tpu.kinematic as K
    from torchdrivesim_tpu.rendering import JaxRendererConfig
    from torchdrivesim_tpu.simulator import Simulator, TorchDriveConfig
    from torchdrivesim_tpu.utils import Resolution
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'examples'))
    try:
        from imitation_learning import build_synthetic_batch as jax_batch
        from imitation_learning import make_bc_train_step as jax_train_step
    finally:
        sys.path.pop(0)
    jroad, jstates0, jexpert = jax_batch(batch, horizon)
    np.testing.assert_array_equal(np.asarray(jstates0), states0.numpy())
    np.testing.assert_array_equal(np.asarray(jexpert), expert.numpy())
    kin = K.SimpleKinematicModel(dt=0.1)
    kin.set_state(jstates0)
    cfg = TorchDriveConfig()
    cfg.renderer = JaxRendererConfig(differentiable=True)
    jsim = Simulator(road_mesh=jroad, kinematic_model=kin,
                     agent_size=jnp.tile(jnp.asarray([[[4.6, 2.0]]]), (batch, 1, 1)),
                     initial_present_mask=jnp.ones((batch, 1), dtype=bool), cfg=cfg)
    jsim.renderer.res = Resolution(res, res)
    jsim.renderer.scale = 2.0 / 35
    tx = optax.adam(3e-4)
    opt_state = tx.init(params)
    step = jax_train_step(jsim, fpolicy, tx, res)
    want = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, jsim.state, jexpert)
        want.append(float(loss))
    print(f'first losses: port {losses[:3]}, reference {want}')
    np.testing.assert_allclose(losses[:3], want, rtol=1e-3)
