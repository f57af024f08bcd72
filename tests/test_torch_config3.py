"""
BASELINE config 3 (heterogeneous agents on carla_Town10HD) as a whole: the
JAX package's world, built as ``tools/bench_suite.py``'s config 3 builds it
(bicycle, simple and no-reversing bicycle agents drawn by
``np.random.RandomState(0)``, a ``CompoundKinematicModel`` over the
bicycle's parameters) at B = 2, res 64, with its Pallas kernel in interpret
mode and the light schedule attached as in ``tests/test_torch_slice.py``,
against the port's world built from the same data by ``scenario_from_arrays``
with ``model_assignments``, stepped 5 times with seeded 4-wide actions:
states to 1e-4, metrics to 1e-4 absolute plus 1e-4 relative, images at
least 99.9% identical. The port's own builder
(``benchmark.build_config3_scenario``) starts from the same world.
"""
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdrivesim_tpu_torch.kinematic as K
from torchdrivesim_tpu_torch.benchmark import (
    CONFIG3_MODELS, CONFIG3_SHARES, build_config3_scenario,
)
from torchdrivesim_tpu_torch.convert import scenario_from_arrays
from tests.test_torch_slice import _arrays

torch.set_num_threads(1)

B, AGENTS, RES, STEPS = 2, 20, 64, 5


@pytest.fixture(scope='module')
def jax_config3():
    """The JAX config-3 scenario (fused kernel in interpret mode, mip
    pyramid built as on a TPU, light controls keeping their ids), its
    model ids and its jitted step."""
    import torchdrivesim_tpu.kinematic as JK
    import torchdrivesim_tpu.ops.pallas_fused as F
    import torchdrivesim_tpu.ops.pallas_rasterize as R
    import torchdrivesim_tpu.ops.pallas_warp as W
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from torchdrivesim_tpu.benchmark import build_benchmark_scenario as jax_build
    from torchdrivesim_tpu.traffic_controls import BaseTrafficControl
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
        for mod in (W, R, F):
            m.setattr(mod.pl, 'pallas_call',
                      functools.partial(mod.pl.pallas_call, interpret=True))
        try:
            scn = jax_build(map_name='carla_Town10HD', batch_size=B,
                            agent_count=AGENTS, res=RES)
        finally:
            random.setstate(saved)
        assert scn.schedule is not None
        sim = scn.sim
        ids = np.random.RandomState(0).choice(
            [JK.BICYCLE, JK.SIMPLE, JK.BICYCLE_NO_REVERSING], size=(B, AGENTS),
            p=[0.6, 0.2, 0.2])
        compound = JK.CompoundKinematicModel(
            model_assignments=ids.astype(np.int32), params=sim.kinematic_model.params)
        compound.set_state(sim.kinematic_model.get_state())
        sim.kinematic_model = compound
        yield scn, ids, jax.jit(scn.make_step_fn(render=True, metrics=True))


def _port(jax_config3):
    scn, ids, _ = jax_config3
    return scenario_from_arrays(dict(_arrays(scn), model_assignments=ids), device='cpu')


@pytest.mark.parametrize('actions', ['random', 'zero'])
def test_config3_steps_match(jax_config3, actions):
    scn, ids, jstep = jax_config3
    port = _port(jax_config3)
    assert isinstance(port.sim.kinematic_model, K.CompoundKinematicModel)
    assert port.sim.action_size == 4
    assert set(np.unique(ids)) == set(CONFIG3_MODELS)
    step = port.make_step_fn(render=True, metrics=True)
    rng = np.random.RandomState(3)
    jstate, state = scn.sim.state, port.sim.state
    for i in range(STEPS):
        act = (np.zeros((B, AGENTS, 4), np.float32) if actions == 'zero'
               else rng.uniform(-1, 1, (B, AGENTS, 4)).astype(np.float32))
        jstate, jout = jstep(jstate, jnp.asarray(act))
        state, out = step(state, torch.from_numpy(act))
        np.testing.assert_allclose(state.agent_state.numpy(),
                                   np.asarray(jstate.agent_state), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(
            state.traffic_control_state['traffic_light'].numpy(),
            np.asarray(jstate.traffic_control_state['traffic_light']))
        assert set(out) == set(jout)
        for k in out:
            got, want = out[k].numpy(), np.asarray(jout[k])
            assert got.shape == want.shape, k
            if k == 'image':
                same = (got == want).all(axis=1)
                print(f'{actions} step {i}: {int(same.sum())} of {same.size} '
                      'pixels identical')
                assert same.mean() >= 0.999
            else:
                np.testing.assert_allclose(got.astype(np.float32),
                                           want.astype(np.float32),
                                           atol=1e-4, rtol=1e-4, err_msg=k)
    moved = np.abs(state.agent_state.numpy() - port.sim.state.agent_state.numpy())
    simple = ids == K.SIMPLE
    if actions == 'zero':      # zero actions freeze the simple agents
        assert (moved[simple] == 0).all() and (moved[~simple] > 0).any()
    else:
        assert (moved[simple].max(axis=-1) > 0).all()


def test_config3_fit_action_and_extend(jax_config3):
    """``Simulator.fit_action`` dispatches per agent as the reference's;
    ``extend`` repeats the assignments with the states, so the extended
    world steps as the repeated one."""
    scn, ids, _ = jax_config3
    port = _port(jax_config3)
    rng = np.random.RandomState(5)
    future = port.sim.state.agent_state.numpy() + rng.randn(B, AGENTS, 4).astype(
        np.float32) * np.asarray([0.5, 0.5, 0.05, 0.3], np.float32)
    want = np.asarray(scn.sim.fit_action(jnp.asarray(future)))
    got = port.sim.fit_action(torch.from_numpy(future)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    big = port.sim.extend(3, in_place=False)
    np.testing.assert_array_equal(big.kinematic_model.model_assignments.numpy(),
                                  np.repeat(ids, 3, axis=0))
    assert big.kinematic_model.models_in_use == port.sim.kinematic_model.models_in_use
    act = torch.from_numpy(rng.uniform(-1, 1, (B, AGENTS, 4)).astype(np.float32))
    one = port.sim.functional_step(port.sim.state, act).agent_state
    three = big.functional_step(big.state, torch.repeat_interleave(act, 3, 0)).agent_state
    np.testing.assert_array_equal(three.numpy(), torch.repeat_interleave(one, 3, 0).numpy())


def test_port_config3_builder_equals_jax_world(jax_config3):
    """The port's config-3 builder starts from the reference's world: the
    placements, sizes, ``lr``, model ids and light states."""
    want = dict(_arrays(jax_config3[0]), model_assignments=jax_config3[1])
    got = build_config3_scenario(batch_size=B, agent_count=AGENTS, res=RES, device='cpu')
    sim = got.sim
    assert CONFIG3_SHARES == (0.6, 0.2, 0.2)
    assert sim.cfg.left_handed_coordinates and sim.kinematic_model.params.left_handed
    np.testing.assert_array_equal(sim.state.agent_state.numpy(), want['agent_state'])
    np.testing.assert_array_equal(sim.kinematic_model.params.lr.numpy(), want['lr'])
    np.testing.assert_array_equal(sim.agent_size.numpy(), want['agent_size'])
    np.testing.assert_array_equal(sim.kinematic_model.model_assignments.numpy(),
                                  want['model_assignments'])
    np.testing.assert_array_equal(
        sim.state.traffic_control_state['traffic_light'].numpy(),
        want['traffic_light_state'])
    assert sim.traffic_controls['traffic_light'].corners.shape[1] == 30
