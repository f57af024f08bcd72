"""
The headline env step as a whole: the JAX package's benchmark scenario
(carla_Town02, 20 vehicles, FSM lights, textured render, all metrics) at a
small batch and resolution, with its Pallas kernel in interpret mode, and
the port's scenario built from the same data (``convert.py``), stepped side
by side. States agree to 1e-4 and metrics to 1e-4 absolute plus 1e-4
relative (the offroad loss is a squared distance that reaches ~10 m^2 once
a car leaves the road, where ulp-level state differences scale by its
gradient); images agree on at least 99.9% of pixels (camera sin/cos and
the screen transform may differ by an ulp between XLA and PyTorch, which
can flip a pixel on a primitive's edge).

The reference's ``build_benchmark_scenario`` means to drive the lights from
the baked FSM schedule, but the batch ``extend`` copies the light control
without its ``actor_ids``, so it never attaches the schedule and every
light stays red. The port attaches it; the fixture lets the reference's
control copies keep ``actor_ids`` so both packages run the scheduled lights.
"""
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdrivesim_tpu_torch.benchmark import build_benchmark_scenario
from torchdrivesim_tpu_torch.convert import scenario_from_arrays

torch.set_num_threads(1)

B, AGENTS, RES, STEPS = 2, 20, 64, 5


@pytest.fixture(scope='module')
def jax_scenario():
    """The JAX scenario with the fused kernel in interpret mode and the
    mip pyramid built (as on a TPU), and its jitted step."""
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
            scn = jax_build(batch_size=B, agent_count=AGENTS, res=RES)
        finally:
            random.setstate(saved)
        assert scn.schedule is not None
        yield scn, jax.jit(scn.make_step_fn(render=True, metrics=True))


def _arrays(scn):
    """The JAX scenario's data as numpy, in the layout of ``convert.py``."""
    sim, st, sched = scn.sim, scn.sim.state, scn.schedule
    control = sim.traffic_controls['traffic_light']
    grids, tex = sim.map_grids, sim.renderer.background_texture
    a = dict(
        agent_state=st.agent_state, present_mask=st.present_mask,
        npc_state=st.npc_state, npc_present_mask=st.npc_present_mask,
        traffic_light_state=st.traffic_control_state['traffic_light'],
        time=int(st.time), npc_time=int(st.npc_time),
        lr=sim.kinematic_model.params.lr, agent_size=sim.agent_size,
        npc_size=sim.npc_controller.npc_size, light_pos=control.pos,
        light_corners=control.corners,
        light_allowed_states=list(control.allowed_states),
        light_ids=list(control.actor_ids),
        distance=grids.distance.data, distance_origin=grids.distance.origin,
        distance_cell=grids.distance.cell_size, direction=grids.direction.data,
        direction_origin=grids.direction.origin,
        direction_cell=grids.direction.cell_size, texture=tex.data,
        texture_origin=tex.origin, texture_cell=tex.cell_size, dt=scn.dt,
        res=scn.res, fov=scn.fov,
        left_handed=bool(sim.cfg.left_handed_coordinates))
    for name in ('durations_cum', 'colors', 'tail_end', 'period', 'offset',
                 'light_fsm', 'n_rows'):
        a['schedule_' + name] = getattr(sched, name)
    return {k: (np.asarray(v) if hasattr(v, 'shape') else v) for k, v in a.items()}


@pytest.mark.parametrize('actions', ['zero', 'random'])
def test_slice_steps_match(jax_scenario, actions):
    scn, jstep = jax_scenario
    port = scenario_from_arrays(_arrays(scn), device='cpu')
    step = port.make_step_fn(render=True, metrics=True)
    rng = np.random.RandomState(1)
    jstate, state = scn.sim.state, port.sim.state
    for i in range(STEPS):
        act = (np.zeros((B, AGENTS, 2), np.float32) if actions == 'zero'
               else rng.uniform(-1, 1, (B, AGENTS, 2)).astype(np.float32))
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


def test_packed_image_step_matches_float_image(jax_scenario):
    """``make_step_fn(packed_image=True)`` gives the same frames, packed
    0x00BBGGRR, and the same metrics."""
    port = scenario_from_arrays(_arrays(jax_scenario[0]), device='cpu')
    act = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (B, AGENTS, 2)).astype(np.float32))
    _, out = port.make_step_fn()(port.sim.state, act)
    _, packed = port.make_step_fn(packed_image=True)(port.sim.state, act)
    assert packed['image'].dtype == torch.int32
    assert packed['image'].shape == (B, RES, RES)
    rgb = torch.stack([(packed['image'] >> s) & 255 for s in (0, 8, 16)], dim=1)
    np.testing.assert_array_equal(rgb.numpy(), out['image'].round().numpy())
    for k in out:
        if k != 'image':
            torch.testing.assert_close(packed[k], out[k], atol=0, rtol=0)


def test_port_scenario_equals_jax_scenario(jax_scenario):
    """The port's own build, seeded like the reference, starts from the
    same world: placements, sizes, lr, light states and schedule."""
    want = _arrays(jax_scenario[0])
    got = build_benchmark_scenario(batch_size=B, agent_count=AGENTS, res=RES, seed=0,
                                   device='cpu')
    sim = got.sim
    np.testing.assert_array_equal(sim.state.agent_state.numpy(), want['agent_state'])
    np.testing.assert_array_equal(sim.state.present_mask.numpy(), want['present_mask'])
    np.testing.assert_array_equal(sim.kinematic_model.params.lr.numpy(), want['lr'])
    np.testing.assert_array_equal(sim.agent_size.numpy(), want['agent_size'])
    np.testing.assert_array_equal(
        sim.state.traffic_control_state['traffic_light'].numpy(),
        want['traffic_light_state'])
    for name in ('durations_cum', 'colors', 'offset', 'n_rows'):
        np.testing.assert_array_equal(getattr(got.schedule, name).numpy(),
                                      want['schedule_' + name])
    np.testing.assert_allclose(sim.traffic_controls['traffic_light'].corners.numpy(),
                               want['light_corners'], atol=1e-4, rtol=0)
