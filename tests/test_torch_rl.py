"""
The RL path (BASELINE config 5, ``examples/rl_example.py`` over
``examples/gym_env.py:VectorizedGymEnv``) against the JAX package:

* the environment: the JAX package's vectorized environment is built with
  its renderer on the TPU path (``jax_renderer._on_tpu`` patched to True
  BEFORE the texture is set, or no mip pyramid is built, and every
  ``pallas_call`` in interpret mode), so its step renders through the
  nearest warp (B2) and the hard raster (B6a, or B6b without the texture);
  the port's environment starts from the same agents
  (``gym_env.gym_sim_from_arrays``). States, rewards and ``done`` agree to
  1e-5; observations are exact except at pixels whose value hangs on the
  rounding of an ``a*x + b*y + c`` (the reference's compiled CPU code fuses
  some into FMAs): the port renders under the three roundings, the
  reference's value must be one of them everywhere and the port's own
  value wherever they agree;
* ``ActorCritic`` with the flax parameters carried across: 1e-5 in float32,
  2e-2 (of the value's scale for the value head) in bfloat16, as
  ``tests/test_torch_policy.py`` holds the CNN policy;
* ``gae`` to 1e-6; the PPO loss's gradients against ``jax.grad`` of a copy
  of the example's loss (the example's ``ppo_update`` is local to its
  ``main``), relative to each gradient's largest value: 1e-4 in float32;
  in bfloat16 no further from the float32 gradient than the reference's
  bfloat16 gradient, beyond 1e-2; one Adam step against ``optax.adam`` to
  1e-6;
* ``collect`` at B = 2, T = 3 against a copy of the example's, fed the
  noise the port's seeded CPU generator draws, in the same order.
"""
import functools
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_warp_nearest import judge_roundings
from torchdrivesim_tpu_torch import rl, tracing
from torchdrivesim_tpu_torch.convert import actor_critic_state_dict_from_flax
from torchdrivesim_tpu_torch.gym_env import (
    GymEnvConfig, VectorizedGymEnv, gym_sim_from_arrays, initial_arrays,
)
from torchdrivesim_tpu_torch.models import ActorCritic


def launches(kernel: str) -> int:
    """The launches so far of the hand-written ``kernel`` (B1 ... HF)."""
    return tracing.counts().get(f'launch.{kernel}', 0)


torch.set_num_threads(1)

B, AGENTS, RES, STEPS, T = 2, 4, 64, 3, 3
FEATURES = (4, 8)


def _examples():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        'examples')
    if path not in sys.path:
        sys.path.insert(0, path)


def _jax_venv(cfg, batch):
    """The JAX package's vectorized environment on its TPU render path (see
    the module docstring) and its jitted step."""
    import torchdrivesim_tpu.ops.pallas_rasterize as R
    import torchdrivesim_tpu.ops.pallas_warp as W
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    _examples()
    from gym_env import GymEnvConfig as JaxConfig, VectorizedGymEnv as JaxEnv
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jr, '_on_tpu', lambda: True)
        for mod in (W, R):
            m.setattr(mod.pl, 'pallas_call',
                      functools.partial(mod.pl.pallas_call, interpret=True))
        venv = JaxEnv(JaxConfig(**vars(cfg)), batch_size=batch)
        step = jax.jit(venv.make_step_fn())
        yield venv, step


UNTEXTURED = GymEnvConfig(agent_count=AGENTS, res=32, use_background_texture=False)


@pytest.fixture(scope='module')
def textured():
    yield from _jax_venv(GymEnvConfig(agent_count=AGENTS, res=RES), B)


@pytest.fixture(scope='module')
def untextured():
    yield from _jax_venv(UNTEXTURED, B)


def _port_venv(jvenv, cfg, device='cpu'):
    sim = jvenv.sim
    arrays = dict(agent_state=np.asarray(sim.state.agent_state)[:1],
                  agent_size=np.asarray(sim.agent_size)[:1],
                  lr=np.asarray(sim.kinematic_model.params.lr)[:1])
    return VectorizedGymEnv(cfg, batch_size=jvenv.batch_size, device=device,
                            sim=gym_sim_from_arrays(cfg, arrays, device))


def _step_both(jvenv, jstep, venv, n_steps, seed):
    step = venv.make_step_fn()
    rng = np.random.RandomState(seed)
    jstate, state = jvenv.initial_state, venv.initial_state
    for i in range(n_steps):
        act = rng.uniform(-1, 1, (jvenv.batch_size, 2)).astype(np.float32)
        jstate, jobs, jreward, jdone = jstep(jstate, jnp.asarray(act))
        judge_roundings(lambda: step(state, torch.from_numpy(act))[1].numpy(),
                        np.asarray(jobs), f'step {i}')
        state, obs, reward, done = step(state, torch.from_numpy(act))
        np.testing.assert_allclose(state.agent_state.numpy(),
                                   np.asarray(jstate.agent_state), atol=1e-5, rtol=0)
        np.testing.assert_allclose(reward.numpy(), np.asarray(jreward), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        assert np.isfinite(np.asarray(jobs)).all()


def test_env_steps_match_with_texture(textured):
    """B2 + B6a: 12 faces per camera over the nearest warp of the texture."""
    jvenv, jstep = textured
    cfg = GymEnvConfig(agent_count=AGENTS, res=RES)
    venv = _port_venv(jvenv, cfg)
    # the batch extend repeats the scenario as the reference's does
    np.testing.assert_array_equal(venv.initial_state.agent_state.numpy(),
                                  np.asarray(jvenv.initial_state.agent_state))
    np.testing.assert_array_equal(
        venv.initial_state.traffic_control_state['traffic_light'].numpy(),
        np.asarray(jvenv.initial_state.traffic_control_state['traffic_light']))
    _step_both(jvenv, jstep, venv, STEPS, seed=0)


def test_env_step_matches_without_texture(untextured):
    """B6b: the whole Town02 road mesh (16,920 faces) and the 12 actor faces
    over the background color, at res 32."""
    jvenv, jstep = untextured
    venv = _port_venv(jvenv, UNTEXTURED)
    before = launches('B6b')
    _step_both(jvenv, jstep, venv, 1, seed=1)
    assert launches('B6b') == before          # the CPU runs no kernel


@pytest.mark.parametrize('textured_sim', [False, True])
def test_simulator_render_matches_jax(textured_sim):
    """``Simulator.render`` of the environment's one-scenario simulator
    from two cameras: without a texture the mesh branch (map mesh, actors
    and the traffic lights by state, the hard raster); with one the
    primitive path (the fused render). The reference's frames at >= 99.9%
    identical pixels (the port builds the stoplines' corners itself, which
    may differ from the reference's by an ulp). Both render the
    environment's simulator before the batch ``extend``: the reference's
    ``render`` of its extended simulator fails to broadcast a batch-1
    template (ROADMAP section C)."""
    import torchdrivesim_tpu.ops.pallas_fused as F
    import torchdrivesim_tpu.ops.pallas_rasterize as R
    import torchdrivesim_tpu.ops.pallas_warp as W
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from torchdrivesim_tpu.utils import Resolution as JaxResolution
    from torchdrivesim_tpu_torch.utils import Resolution
    _examples()
    from gym_env import GymEnv, GymEnvConfig as JaxConfig
    cfg = GymEnvConfig(agent_count=AGENTS, res=RES) if textured_sim else UNTEXTURED
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jr, '_on_tpu', lambda: True)
        for mod in (W, R, F):
            m.setattr(mod.pl, 'pallas_call',
                      functools.partial(mod.pl.pallas_call, interpret=True))
        jsim = GymEnv(JaxConfig(**vars(cfg)))._build_sim()
        ego = np.asarray(jsim.state.agent_state)[:, 0]
        xy = np.stack([ego[:, :2], ego[:, :2] + 3.0], axis=1).astype(np.float32)
        psi = np.stack([ego[:, 2:3], ego[:, 2:3] + 0.5], axis=1).astype(np.float32)
        want = np.asarray(jsim.render(jnp.asarray(xy), jnp.asarray(psi),
                                      res=JaxResolution(32, 32)))
    sim = gym_sim_from_arrays(cfg, dict(
        agent_state=np.asarray(jsim.state.agent_state),
        agent_size=np.asarray(jsim.agent_size),
        lr=np.asarray(jsim.kinematic_model.params.lr)), 'cpu')
    got = sim.render(torch.from_numpy(xy), torch.from_numpy(psi),
                     res=Resolution(32, 32)).numpy()
    assert got.shape == want.shape == (1, 2, 3, 32, 32)
    same = (got == want).all(axis=2)
    print(f'render textured={textured_sim}: {int(same.sum())} of {same.size} '
          'pixels identical')
    assert same.mean() >= 0.999
    assert (got != got[:, :, :, :1, :1]).any()        # the frames show something
    # the port's extended simulator renders every copy the same
    rep = lambda a: torch.from_numpy(np.repeat(a, 2, axis=0))
    both = sim.extend(2, in_place=False).render(rep(xy), rep(psi), res=Resolution(32, 32))
    np.testing.assert_array_equal(both.numpy(), np.repeat(got, 2, axis=0))


def test_port_build_equals_jax_build(textured):
    """The port's own build, seeded like the reference, places the same
    agents."""
    jvenv = textured[0]
    a = initial_arrays(GymEnvConfig(agent_count=AGENTS, res=RES))
    np.testing.assert_array_equal(a['agent_state'],
                                  np.asarray(jvenv.sim.state.agent_state)[:1])
    np.testing.assert_array_equal(a['agent_size'], np.asarray(jvenv.sim.agent_size)[:1])
    np.testing.assert_array_equal(a['lr'],
                                  np.asarray(jvenv.sim.kinematic_model.params.lr)[:1])


def test_bicycle_no_reversing_matches_jax():
    import torchdrivesim_tpu.kinematic as JK
    from torchdrivesim_tpu_torch import kinematic as K
    rng = np.random.RandomState(3)
    state = rng.uniform(-3, 3, (5, 4, 4)).astype(np.float32)
    state[..., 3] = rng.uniform(0, 2, (5, 4))
    action = rng.uniform(-1, 1, (5, 4, 2)).astype(np.float32)
    lr = rng.uniform(1, 2, (5, 4)).astype(np.float32)
    for lh in (False, True):
        want = JK.step(jnp.asarray(state), jnp.asarray(action),
                       JK.KinematicParams(lr=jnp.asarray(lr), left_handed=lh),
                       single_model=JK.BICYCLE_NO_REVERSING)
        kin = K.BicycleNoReversing(left_handed=lh, device='cpu')
        kin.set_params(lr=lr)
        got = K.step(torch.from_numpy(state), torch.from_numpy(action), kin.params,
                     single_model=kin.model_id)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
        assert (got[..., 3] >= 0).all()          # it stops rather than reversing


# --- the policy and PPO ------------------------------------------------------

def _actor_critic(dtype, res=RES, seed=0):
    from torchdrivesim_tpu.models import ActorCritic as FlaxAC
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    flax = FlaxAC(action_size=2, features=FEATURES, dtype=jdtype)
    params = jax.tree.map(np.asarray, flax.init(jax.random.PRNGKey(seed),
                                                jnp.zeros((1, 3, res, res))))
    # a larger mean head moves the actions off tanh's linear middle
    params['params']['Dense_1']['kernel'] = params['params']['Dense_1']['kernel'] * 30
    port = ActorCritic(2, FEATURES, dtype=dtype)
    port.load_state_dict(actor_critic_state_dict_from_flax(params))
    return flax, params, port


def _images(seed, b, res=RES):
    return np.random.RandomState(seed).uniform(0, 255, (b, 3, res, res)).astype(np.float32)


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_actor_critic_matches_flax(dtype, tol):
    flax, params, port = _actor_critic(dtype)
    images = _images(1, 4)
    want = [np.asarray(x) for x in flax.apply(params, jnp.asarray(images))]
    got = [x.detach().numpy() for x in port(torch.from_numpy(images))]
    names = ('mean', 'log_std', 'value')
    for name, g, w in zip(names, got, want):
        assert g.dtype == np.float32 and g.shape == w.shape, name
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        print(f'{dtype} {name}: max abs difference {err:.3g} (scale {scale:.3g})')
        assert err <= tol * scale, name
    assert np.abs(want[0]).max() > 0.3              # the comparison has signal
    assert set(actor_critic_state_dict_from_flax(params)) == set(port.state_dict())


def test_gae_matches_jax():
    _examples()
    from rl_example import gae as jax_gae
    rng = np.random.RandomState(4)
    rewards, values = rng.randn(16, 8).astype(np.float32), rng.randn(16, 8).astype(np.float32)
    dones = (rng.rand(16, 8) < 0.2).astype(np.float32)
    last = rng.randn(8).astype(np.float32)
    want = np.asarray(jax_gae(*map(jnp.asarray, (rewards, values, dones, last))))
    got = rl.gae(*map(torch.from_numpy, (rewards, values, dones, last))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _jax_ppo_loss(model, clip=0.2):
    """A copy of the example's PPO loss (``rl_example.py:96-116``)."""
    def loss_fn(params, batch):
        obs, actions, logps_old, advs, returns = batch
        t, b_ = obs.shape[0], obs.shape[1]
        flat = lambda x: x.reshape((t * b_,) + x.shape[2:])
        obs, actions = flat(obs), flat(actions)
        logps_old, advs, returns = flat(logps_old), flat(advs), flat(returns)
        advs = (advs - advs.mean()) / (advs.std() + 1e-8)
        mean, log_std, value = model.apply(params, obs)
        std = jnp.exp(log_std)
        logp = jnp.sum(-0.5 * ((actions - mean) / std) ** 2
                       - log_std - 0.5 * np.log(2 * np.pi), axis=-1)
        ratio = jnp.exp(logp - logps_old)
        pg = -jnp.mean(jnp.minimum(ratio * advs,
                                   jnp.clip(ratio, 1 - clip, 1 + clip) * advs))
        v_loss = jnp.mean((value - returns) ** 2)
        entropy = jnp.mean(jnp.sum(log_std + 0.5 * np.log(2 * np.pi * np.e), axis=-1))
        return pg + 0.5 * v_loss - 0.01 * entropy
    return loss_fn


def _ppo_batch(seed, t=3, b=4):
    rng = np.random.RandomState(seed)
    return (_images(seed, t * b).reshape(t, b, 3, RES, RES),
            rng.uniform(-1.5, 1.5, (t, b, 2)).astype(np.float32),
            rng.uniform(-3, -1, (t, b)).astype(np.float32),
            rng.randn(t, b).astype(np.float32),
            rng.randn(t, b).astype(np.float32))


def _ppo_grads(dtype, batch):
    """(port's, reference's) PPO-loss gradients at the same parameters, as
    state dicts of numpy arrays, and the losses."""
    flax, params, port = _actor_critic(dtype)
    want_loss, want = jax.value_and_grad(_jax_ppo_loss(flax))(
        params, tuple(map(jnp.asarray, batch)))
    loss, _, _ = rl.ppo_loss(port, tuple(map(torch.from_numpy, batch)))
    loss.backward()
    want = actor_critic_state_dict_from_flax(jax.tree.map(np.asarray, want))
    got = {name: p.grad.numpy() for name, p in port.named_parameters()}
    return got, {k: v.numpy() for k, v in want.items()}, float(loss.detach()), float(want_loss)


def test_ppo_gradients_match_jax():
    """float32: every gradient to 1e-4 of its largest value. bfloat16: the
    exact value is the float32 gradient at the same parameters; the port's
    error from it may exceed the reference's by at most 1e-2 of its largest
    value. (The reference sums a convolution bias's gradient in bfloat16:
    at this batch its second bias gradient is 18% of the largest value off
    the float32 one, the port's 1.5%.)"""
    batch = _ppo_batch(5)
    got, want, loss, want_loss = _ppo_grads(torch.float32, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for name, w in want.items():
        assert np.abs(w).max() > 0, name
        err = float(np.abs(got[name] - w).max() / np.abs(w).max())
        print(f'float32 {name}: max difference {err:.3g} of the largest value')
        assert err <= 1e-4, name
    exact = want
    got, want, loss, want_loss = _ppo_grads(torch.bfloat16, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=2e-2)
    for name, e in exact.items():
        scale = np.abs(e).max()
        err, ref_err = (float(np.abs(x[name] - e).max() / scale) for x in (got, want))
        print(f'bfloat16 {name}: {err:.3g} of the largest value off the float32 '
              f'gradient, the reference {ref_err:.3g}')
        assert err <= ref_err + 1e-2, name


def test_adam_step_matches_optax():
    import optax
    _, params, port = _actor_critic(torch.float32)
    rng = np.random.RandomState(6)
    grads = jax.tree.map(lambda x: rng.randn(*np.shape(x)).astype(np.float32), params)
    tx = optax.adam(3e-4)
    opt_state = tx.init(params)
    want = params
    optimizer = rl.make_optimizer(port, 3e-4)
    tgrads = actor_critic_state_dict_from_flax(grads)
    for _ in range(2):
        updates, opt_state = tx.update(grads, opt_state)
        want = optax.apply_updates(want, updates)
        for name, p in port.named_parameters():
            p.grad = tgrads[name].clone()
        optimizer.step()
    want = actor_critic_state_dict_from_flax(jax.tree.map(np.asarray, want))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_collect_matches_jax_copy(textured):
    """The port's collect against a copy of the example's (``rl_example.py:
    66-93``) stepping the JAX environment, with float32 policies carrying
    the same parameters and the port generator's noise."""
    jvenv, jstep = textured
    flax, params, port = _actor_critic(torch.float32)
    venv = _port_venv(jvenv, GymEnvConfig(agent_count=AGENTS, res=RES))
    generator = torch.Generator().manual_seed(7)
    state, batch = rl.collect(port, venv.make_step_fn(), venv.initial_state, T, generator)
    replay = torch.Generator().manual_seed(7)
    noise = [torch.randn((B, 2), generator=replay).numpy() for _ in range(T)]

    apply = jax.jit(flax.apply)
    _examples()
    from rl_example import gae as jax_gae
    jstate, traj = jvenv.initial_state, []
    zero = jnp.zeros((B, 2))
    for t in range(T):
        _, obs, _, _ = jstep(jstate, zero)
        mean, log_std, value = apply(params, obs)
        std = jnp.exp(log_std)
        action = mean + std * jnp.asarray(noise[t])
        logp = jnp.sum(-0.5 * ((action - mean) / std) ** 2
                       - log_std - 0.5 * np.log(2 * np.pi), axis=-1)
        jstate, _, reward, done = jstep(jstate, jnp.tanh(action))
        traj.append((obs, action, logp, value, reward, done.astype(jnp.float32)))
    obs, actions, logps, values, rewards, dones = (jnp.stack(x) for x in zip(*traj))
    _, last_obs, _, _ = jstep(jstate, zero)
    advs = jax_gae(rewards, values, dones, apply(params, last_obs)[2])
    want = (obs, actions, logps, advs, advs + values)

    np.testing.assert_allclose(state.agent_state.numpy(), np.asarray(jstate.agent_state),
                               atol=1e-4, rtol=0)
    same = (batch[0].numpy() == np.asarray(want[0])).all(axis=2)
    print(f'collect: {int(same.sum())} of {same.size} observation pixels identical')
    assert same.mean() >= 0.999
    for name, g, w in zip(('actions', 'logps', 'advantages', 'returns'), batch[1:],
                          want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_ppo_update_runs_and_moves_the_loss():
    """Two PPO epochs on a fixed rollout lower the loss of that rollout."""
    torch.manual_seed(0)
    model = ActorCritic(2, FEATURES)
    optimizer = rl.make_optimizer(model, 1e-3)
    batch = tuple(map(torch.from_numpy, _ppo_batch(8)))
    first = rl.ppo_update(model, optimizer, batch)[0]
    for _ in range(5):
        last = rl.ppo_update(model, optimizer, batch)[0]
    assert math.isfinite(float(first)) and float(last) < float(first)
