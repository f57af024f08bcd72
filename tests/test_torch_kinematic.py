"""
The port's kinematic models (``torchdrivesim_tpu_torch/kinematic.py``)
against the JAX package's on the same seeded numpy inputs: each of the seven
models' step, fit_action, normalize_action and denormalize_action (at map
scale, x ~ 400 m, and on reversing targets) to 1e-5 relative; the
per-agent dispatch over a mixed assignment; the compound model's extend and
batch selection; the gradient of a 10-step compound rollout with NaN-``lr``
simple agents against ``jax.grad``; and zero agents.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdrivesim_tpu.kinematic as JK
import torchdrivesim_tpu_torch.kinematic as K

torch.set_num_threads(1)

MODELS = list(range(K.NUM_MODELS))
ATOL = 1e-6


def _states(seed, b=4, a=8):
    """Map-scale states (x, y ~ 400 m, headings all round, speeds from
    reversing to fast), and targets near them, a quarter of them behind
    the agent (the reversing fits)."""
    rng = np.random.RandomState(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    state = f32(np.concatenate([rng.uniform(380, 420, (b, a, 2)),
                                rng.uniform(-np.pi, np.pi, (b, a, 1)),
                                rng.uniform(-2, 8, (b, a, 1))], -1))
    psi = state[..., 2]
    ahead = rng.uniform(0.2, 1.5, (b, a)) * np.where(rng.rand(b, a) < 0.25, -1, 1)
    side = rng.uniform(-0.3, 0.3, (b, a))
    future = state.copy()
    future[..., 0] += ahead * np.cos(psi) - side * np.sin(psi)
    future[..., 1] += ahead * np.sin(psi) + side * np.cos(psi)
    future[..., 2:] += rng.randn(b, a, 2) * 0.1
    lr = f32(rng.uniform(1.0, 2.0, (b, a)))
    return state, f32(future), lr


def _params(lr, left_handed):
    return (JK.KinematicParams(lr=jnp.asarray(lr), left_handed=left_handed),
            K.KinematicParams(lr=torch.from_numpy(lr), left_handed=left_handed))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize('left_handed', [False, True])
@pytest.mark.parametrize('model', MODELS)
def test_model_matches_jax(model, left_handed):
    state, future, lr = _states(model)
    jp, p = _params(lr, left_handed)
    rng = np.random.RandomState(10 + model)
    width = K.MODEL_ACTION_SIZE[model]
    assert width == JK.MODEL_ACTION_SIZE[model]
    for w in sorted({width, K.ACTION_BUF}):
        action = rng.uniform(-1, 1, state.shape[:-1] + (w,)).astype(np.float32)
        _close(K.step(torch.from_numpy(state), torch.from_numpy(action), p,
                      single_model=model).numpy(),
               JK.step(jnp.asarray(state), jnp.asarray(action), jp, single_model=model))
    got = K.fit_action(torch.from_numpy(future), torch.from_numpy(state), p,
                       single_model=model).numpy()
    want = np.asarray(JK.fit_action(jnp.asarray(future), jnp.asarray(state), jp,
                                    single_model=model))
    _close(got, want)
    raw = rng.uniform(-3, 3, state.shape[:-1] + (width,)).astype(np.float32)
    _close(K.normalize_action(model, torch.from_numpy(raw), p).numpy(),
           JK.normalize_action(model, jnp.asarray(raw), jp))
    _close(K.denormalize_action(model, torch.from_numpy(raw), p).numpy(),
           JK.denormalize_action(model, jnp.asarray(raw), jp))
    if model in (K.BICYCLE, K.BICYCLE_NO_REVERSING):
        # the targets behind the agent fit as reversing: negative speed
        accel = want[..., 0] * p.max_acceleration * p.dt + state[..., 3]
        behind = ((future - state)[..., 0] * np.cos(state[..., 2])
                  + (future - state)[..., 1] * np.sin(state[..., 2])) < 0
        assert behind.any() and (accel[behind] < 0).all()


def test_facade_classes_match_jax():
    """The facade classes step, fit, normalize and take parameters as the
    reference's do; the displacement models' ``step_from_xy`` ignores any
    channel past the first two."""
    state, future, lr = _states(3, b=2, a=3)
    pairs = [
        (JK.TeleportingKinematicModel(), K.TeleportingKinematicModel(device='cpu')),
        (JK.SimpleKinematicModel(), K.SimpleKinematicModel(device='cpu')),
        (JK.OrientedKinematicModel(), K.OrientedKinematicModel(device='cpu')),
        (JK.KinematicBicycle(left_handed=True), K.KinematicBicycle(left_handed=True,
                                                                   device='cpu')),
        (JK.BicycleNoReversing(), K.BicycleNoReversing(device='cpu')),
        (JK.BicycleByDisplacement(), K.BicycleByDisplacement(device='cpu')),
        (JK.BicycleByOrientedDisplacement(), K.BicycleByOrientedDisplacement(device='cpu')),
    ]
    rng = np.random.RandomState(4)
    for jm, m in pairs:
        assert m.model_id == jm.model_id and m.action_size == jm.action_size
        if 'lr' in jm.get_params():
            jm.set_params(lr=jnp.asarray(lr))
            m.set_params(lr=lr)
        with pytest.raises(ValueError):
            m.set_params(lr=lr, not_a_param=1.0)
        jm.set_state(jnp.asarray(state))
        m.set_state(state)
        _close(m.fit_action(future).numpy(), jm.fit_action(jnp.asarray(future)))
        action = rng.uniform(-1, 1, state.shape[:-1] + (4,)).astype(np.float32)
        jm.step(jnp.asarray(action[..., :m.action_size]))
        m.step(action[..., :m.action_size])
        _close(m.get_state().numpy(), jm.get_state())
        if hasattr(jm, 'step_from_xy'):
            jm.step_from_xy(jnp.asarray(action))
            m.step_from_xy(action)
            _close(m.get_state().numpy(), jm.get_state())
        raw = torch.from_numpy(action[..., :m.action_size])
        _close(m.denormalize_action(m.normalize_action(raw)).numpy(), raw.numpy())
    base = K.KinematicModel(K.KinematicParams(lr=torch.ones(())), 'cpu')
    with pytest.raises(ValueError, match='unknown_param'):
        base.set_params(unknown_param=1.0)
    assert base.get_params() == {}


def _mixed_ids(seed, b, a, models=MODELS):
    rng = np.random.RandomState(seed)
    ids = rng.choice(models, size=(b, a))
    ids.reshape(-1)[:len(models)] = models          # every model in use
    return ids


@pytest.mark.parametrize('left_handed', [False, True])
def test_compound_dispatch_matches_jax(left_handed):
    """Every model on a mixed assignment: the step and the fit through the
    per-agent dispatch (the models in use given, or every model) equal the
    reference's dispatch and each agent's own model."""
    state, future, lr = _states(21)
    ids = _mixed_ids(22, *state.shape[:2])
    jp, p = _params(lr, left_handed)
    action = np.random.RandomState(23).uniform(-1, 1, state.shape).astype(np.float32)
    t = torch.from_numpy
    want = np.asarray(JK.step(jnp.asarray(state), jnp.asarray(action), jp,
                              model_ids=jnp.asarray(ids)))
    want_fit = np.asarray(JK.fit_action(jnp.asarray(future), jnp.asarray(state), jp,
                                        model_ids=jnp.asarray(ids)))
    for models in (sorted(set(ids.reshape(-1).tolist())), None):
        got = K.step(t(state), t(action), p, model_ids=t(ids), models=models).numpy()
        _close(got, want)
        fit = K.fit_action(t(future), t(state), p, model_ids=t(ids), models=models).numpy()
        _close(fit, want_fit)
    for mid in MODELS:
        own = K.step(t(state), t(action), p, single_model=mid).numpy()
        np.testing.assert_array_equal(got[ids == mid], own[ids == mid])
    compound = K.CompoundKinematicModel(ids, params=p, device='cpu')
    assert compound.models_in_use == tuple(MODELS) and compound.action_size == 4
    compound.set_state(state)
    compound.step(action)
    np.testing.assert_array_equal(compound.get_state().numpy(), got)
    np.testing.assert_array_equal(compound.fit_action(future, state).numpy(), fit)
    # one model in use: its result for every agent
    single = K.CompoundKinematicModel(np.full(ids.shape, K.SIMPLE), params=p, device='cpu')
    single.set_state(state)
    single.step(action)
    np.testing.assert_array_equal(single.get_state().numpy(), K.step(
        t(state), t(action), p, single_model=K.SIMPLE).numpy())


def test_compound_extend_and_select_match_jax():
    """``extend`` repeats each environment contiguously (state, ``lr`` and
    assignments); ``select_batch_elements`` indexes all three and recomputes
    the models in use on the host."""
    state, _, lr = _states(31, b=3, a=4)
    ids = np.asarray([[K.BICYCLE, K.SIMPLE, K.BICYCLE, K.BICYCLE],
                      [K.BICYCLE_NO_REVERSING] * 4,
                      [K.SIMPLE, K.SIMPLE, K.BICYCLE, K.SIMPLE]])
    jm = JK.CompoundKinematicModel(jnp.asarray(ids), JK.KinematicParams(lr=jnp.asarray(lr)))
    m = K.CompoundKinematicModel(ids, K.KinematicParams(lr=torch.from_numpy(lr)),
                                 device='cpu')
    jm.set_state(jnp.asarray(state))
    m.set_state(state)
    copy = m.copy()
    jm.extend(2)
    m.extend(2)
    assert copy.get_state().shape == (3, 4, 4)          # the copy is untouched
    np.testing.assert_array_equal(m.model_assignments.numpy(), np.asarray(jm.model_assignments))
    np.testing.assert_array_equal(m.params.lr.numpy(), np.asarray(jm.params.lr))
    np.testing.assert_array_equal(m.get_state().numpy(), np.asarray(jm.get_state()))
    assert m.models_in_use == (K.SIMPLE, K.BICYCLE, K.BICYCLE_NO_REVERSING)
    for idx in ([2, 3], torch.tensor([5, 0])):
        sel = m.copy()
        jsel = JK.CompoundKinematicModel(jm.model_assignments, jm.params)
        jsel.set_state(jm.get_state())
        sel.select_batch_elements(idx)
        jsel.select_batch_elements(np.asarray(idx))
        np.testing.assert_array_equal(sel.model_assignments.numpy(),
                                      np.asarray(jsel.model_assignments))
        np.testing.assert_array_equal(sel.params.lr.numpy(), np.asarray(jsel.params.lr))
        np.testing.assert_array_equal(sel.get_state().numpy(), np.asarray(jsel.get_state()))
        assert sel.models_in_use == tuple(np.unique(np.asarray(jsel.model_assignments)))
    action = np.random.RandomState(32).uniform(-1, 1, (6, 4, 4)).astype(np.float32)
    jm.step(jnp.asarray(action))
    m.step(action)
    _close(m.get_state().numpy(), jm.get_state())


def test_compound_rollout_gradient_matches_jax_grad():
    """The gradient of a 10-step rollout of config 3's three models (the
    simple agents carry NaN ``lr``, as pedestrians do) with respect to the
    actions and the initial states: finite, and within 1e-4 of ``jax.grad``
    of the reference's rollout."""
    state, _, lr = _states(41, b=3, a=8)
    state[..., :2] -= 400.0                   # positions near the origin
    ids = _mixed_ids(42, 3, 8, [K.BICYCLE, K.SIMPLE, K.BICYCLE_NO_REVERSING])
    lr[ids == K.SIMPLE] = np.nan
    actions = np.random.RandomState(43).uniform(-1, 1, (10, 3, 8, 4)).astype(np.float32)
    jp = JK.KinematicParams(lr=jnp.asarray(lr), left_handed=True)
    p = K.KinematicParams(lr=torch.from_numpy(lr), left_handed=True)
    models = tuple(np.unique(ids))

    def jax_loss(s, acts):
        for a in acts:
            s = JK.step(s, a, jp, model_ids=jnp.asarray(ids))
        return jnp.sum(s[..., :3] ** 2) + jnp.sum(s[..., 3])

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(state), jnp.asarray(actions))
    s0 = torch.tensor(state, requires_grad=True)
    acts = torch.tensor(actions, requires_grad=True)
    s = s0
    for a in acts:
        s = K.step(s, a, p, model_ids=torch.from_numpy(ids), models=models)
    loss = torch.sum(s[..., :3] ** 2) + torch.sum(s[..., 3])
    got = torch.autograd.grad(loss, (s0, acts))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    assert float(got[1].abs().sum()) > 0


@pytest.mark.parametrize('model', MODELS)
def test_zero_agents(model):
    """An empty agent dimension steps and fits, for each model and through
    the per-agent dispatch."""
    p = K.KinematicParams(lr=torch.ones((2, 0)))
    state = torch.zeros((2, 0, 4))
    for width in (K.MODEL_ACTION_SIZE[model], 4):
        assert K.step(state, torch.zeros((2, 0, width)), p, single_model=model).shape \
            == (2, 0, 4)
    assert K.fit_action(state, state, p, single_model=model).shape == (2, 0, 4)
    ids = torch.zeros((2, 0), dtype=torch.int64)
    assert K.step(state, torch.zeros((2, 0, 4)), p, model_ids=ids).shape == (2, 0, 4)
    compound = K.CompoundKinematicModel(np.zeros((2, 0), np.int64), params=p, device='cpu')
    assert compound.models_in_use == ()
    compound.set_state(state)
    compound.step(torch.zeros((2, 0, 4)))
    assert compound.get_state().shape == (2, 0, 4)
