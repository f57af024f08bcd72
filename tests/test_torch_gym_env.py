"""
The port's single-ego environments against the JAX package's
(``examples/gym_env.py``):

* a ``GymEnv`` episode (carla_Town02, 4 agents, textured, res 64) beside
  the reference's, its egocentric render on the reference's TPU path
  (``jax_renderer._on_tpu`` patched before the texture is set,
  ``pallas_call`` in interpret mode, jitted): observations >= 99.9%
  identical pixels, rewards and infos to 1e-4;
* ``IAIGymEnv`` and ``SingleAgentWrapper`` against a mock ``invertedai``
  module (INITIALIZE places a line of cars, DRIVE moves each 0.5 m), the
  NPC states, rewards and infos to 1e-4 beside the reference's with the
  same mock; the client's absence raises;
* ``main`` under SIGTERM.
"""
import functools
import os
import signal
import sys
import types

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        'examples')


class _Point:
    def __init__(self, x, y):
        self.x, self.y = x, y


class _AgentState:
    def __init__(self, center, orientation, speed):
        self.center, self.orientation, self.speed = center, orientation, speed


class _AgentAttributes:
    def __init__(self, length, width, rear_axis_offset):
        self.length, self.width = length, width
        self.rear_axis_offset = rear_axis_offset


def _mock_invertedai(drift=0.5):
    """A stub invertedai module: INITIALIZE spawns a line of cars near the
    location of interest; DRIVE advances every car forward by ``drift``
    meters along x."""
    mod = types.ModuleType('invertedai_mock')
    mod.common = types.SimpleNamespace(
        Point=_Point, AgentState=_AgentState, AgentAttributes=_AgentAttributes)

    class _Err(Exception):
        pass

    mod.error = types.SimpleNamespace(InvertedAIError=_Err)
    mod.calls = []

    def initialize(location, agent_count, location_of_interest=(0, 0),
                   traffic_light_state_history=None):
        cx, cy = location_of_interest
        resp = types.SimpleNamespace()
        resp.agent_attributes = [_AgentAttributes(4.6, 2.0, 1.4)
                                 for _ in range(agent_count)]
        resp.agent_states = [_AgentState(_Point(cx + 8.0 * i, cy), 0.0, 2.0)
                             for i in range(agent_count)]
        resp.recurrent_states = ['rs0'] * agent_count
        return resp

    def drive(location, agent_states, agent_attributes, recurrent_states,
              traffic_lights_states=None):
        mod.calls.append(len(agent_states))
        resp = types.SimpleNamespace()
        resp.agent_states = [_AgentState(_Point(s.center.x + drift, s.center.y),
                                         s.orientation, s.speed) for s in agent_states]
        resp.recurrent_states = ['rs1'] * len(agent_states)
        return resp

    mod.api = types.SimpleNamespace(initialize=initialize, drive=drive)
    mod.large_drive = drive
    return mod


def _reference_gym_env():
    sys.path.insert(0, EXAMPLES)
    try:
        import gym_env
    finally:
        sys.path.pop(0)
    return gym_env


@pytest.fixture
def mock_iai(monkeypatch):
    import torchdrivesim_tpu.behavior.iai as jiai
    import torchdrivesim_tpu_torch.behavior.iai as iai
    mod = _mock_invertedai()
    monkeypatch.setattr(iai, 'invertedai', mod)
    monkeypatch.setattr(jiai, 'invertedai', mod)
    monkeypatch.setattr(jiai, 'is_available', True)
    return mod


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=1e-4, rtol=1e-4, err_msg=name)


def _same_pixels(got, want, name):
    assert got.shape == want.shape, name
    same = float((got == want).all(axis=0).mean())
    print(f'{name}: {same * 100:.3f}% of pixels identical')
    assert same >= 0.999, name


def test_gym_env_episode_matches_jax():
    """Reset and four steps, the last past ``max_steps`` (truncated), then
    a second reset: observations, rewards and infos beside the
    reference's."""
    import torchdrivesim_tpu.ops.pallas_fused as F
    import torchdrivesim_tpu.ops.pallas_rasterize as R
    import torchdrivesim_tpu.ops.pallas_warp as W
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from torchdrivesim_tpu_torch.gym_env import GymEnv, GymEnvConfig
    ref = _reference_gym_env()
    cfg = dict(agent_count=4, res=64, max_steps=4)
    env = GymEnv(GymEnvConfig(**cfg), device='cpu')
    actions = np.random.RandomState(0).uniform(-1, 1, (5, 2)).astype(np.float32)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jr, '_on_tpu', lambda: True)
        for mod in (W, R, F):
            m.setattr(mod.pl, 'pallas_call',
                      functools.partial(mod.pl.pallas_call, interpret=True))
        jenv = ref.GymEnv(ref.GymEnvConfig(**cfg))
        template = jenv._sim_template

        def render(state):
            saved, template.state = template.state, state
            try:
                return template.render_egocentric()
            finally:
                template.state = saved
        render = jax.jit(render)
        # the reference's observation, its render jitted (the copies of the
        # template share every static parameter)
        jenv._observe = lambda: np.asarray(render(jenv.sim.state))[0, 0]

        obs, info = env.reset()
        jobs, jinfo = jenv.reset()
        assert isinstance(obs, np.ndarray) and obs.shape == (3, 64, 64)
        _same_pixels(obs, jobs, 'reset')
        for i, action in enumerate(actions):
            if i == cfg['max_steps']:
                env.reset()
                jenv.reset()
            got = env.step(action)
            want = jenv.step(action)
            _same_pixels(got[0], want[0], f'step {i}')
            _close(got[1], want[1], f'step {i} reward')
            assert got[2:4] == want[2:4], f'step {i} terminated, truncated'
            assert set(got[4]) == set(want[4])
            for k in want[4]:
                _close(got[4][k], want[4][k], f'step {i} {k}')
            if i == cfg['max_steps'] - 1:
                assert got[3]                         # truncated
    np.testing.assert_allclose(env.sim.get_state().numpy(),
                               np.asarray(jenv.sim.get_state()), atol=1e-4, rtol=1e-4)
    assert env.render().shape == (3, 64, 64)
    env.close()
    assert env.sim is None


def test_iai_gym_env_matches_jax_with_mock_client(mock_iai):
    """The ego is the simulator's only agent, the other vehicles NPCs that
    the mock DRIVE moves 0.5 m a step; DRIVE sees the NPCs and the ego."""
    from torchdrivesim_tpu_torch.gym_env import GymEnvConfig, IAIGymEnv
    ref = _reference_gym_env()
    env = IAIGymEnv(GymEnvConfig(agent_count=4, res=64), device='cpu')
    jenv = ref.IAIGymEnv(ref.GymEnvConfig(agent_count=4, res=64,
                                          use_background_texture=False))
    jenv._observe = lambda: np.zeros((3, 64, 64), np.float32)   # not compared
    obs, _ = env.reset()
    jenv.reset()
    assert obs.shape == (3, 64, 64) and env.sim.agent_count == 1
    assert env.sim.npc_count == 3
    before = env.sim.get_npc_state().clone()
    actions = np.random.RandomState(1).uniform(-1, 1, (3, 2)).astype(np.float32)
    for i, action in enumerate(actions):
        got, want = env.step(action), jenv.step(action)
        _close(env.sim.get_npc_state().numpy(), np.asarray(jenv.sim.state.npc_state),
               f'step {i} NPC states')
        _close(env.sim.get_state().numpy(), np.asarray(jenv.sim.get_state()),
               f'step {i} ego')
        _close(got[1], want[1], f'step {i} reward')
        for k in want[4]:
            _close(got[4][k], want[4][k], f'step {i} {k}')
    moved = (env.sim.get_npc_state() - before).numpy()
    np.testing.assert_allclose(moved[0, :, 0], 1.5, atol=1e-5)
    np.testing.assert_allclose(moved[0, :, 1], 0.0, atol=1e-5)
    assert mock_iai.calls[:3] == [4, 4, 4]                  # 3 NPCs + the ego
    copied = env.sim.npc_controller.copy()
    assert copied.location == env.sim.npc_controller.location
    assert copied.recurrent_states == env.sim.npc_controller.recurrent_states
    env.close()


def test_single_agent_wrapper(mock_iai):
    from torchdrivesim_tpu_torch.gym_env import GymEnvConfig, IAIGymEnv, SingleAgentWrapper
    env = SingleAgentWrapper(IAIGymEnv(GymEnvConfig(agent_count=3, res=64),
                                       device='cpu'))
    obs, info = env.reset()
    assert obs.shape == (3, 64, 64) and info == {}
    obs, reward, terminated, truncated, info = env.step([1.0, 0.0])
    assert isinstance(reward, float) and -10 <= reward <= 10
    assert isinstance(terminated, bool) and isinstance(truncated, bool)
    assert isinstance(info['speed'], float)
    assert env.render().shape == (3, 64, 64)
    sq = SingleAgentWrapper._squeeze
    assert sq(np.zeros((1, 1, 3, 4))).shape == (3, 4)
    assert sq(torch.zeros((1, 3, 4))).shape == (3, 4)
    assert sq(np.zeros((3, 64, 64))).shape == (3, 64, 64)
    assert sq({'a': np.zeros((1, 1, 2))})['a'].shape == (2,)
    assert sq(5) == 5
    env.close()


def test_iai_needs_the_client(monkeypatch):
    import torchdrivesim_tpu_torch.behavior.iai as iai
    monkeypatch.setattr(iai, 'invertedai', None)
    monkeypatch.setitem(sys.modules, 'invertedai', None)
    with pytest.raises(ImportError, match='invertedai'):
        iai.iai_initialize('carla:Town02', 3, device='cpu')
    attrs = iai.unpack_attributes(_AgentAttributes(4.0, 2.0, 1.5))
    assert attrs.tolist() == [4.0, 2.0, 1.5]
    props = iai.agent_attributes_to_basic_agent_properties(attrs)
    assert iai.agent_properties_to_agent_attributes(props).tolist() == [4.0, 2.0, 1.5]


def test_main_handles_sigterm():
    """``main`` installs a SIGTERM handler that raises for a graceful
    shutdown, and runs its two episodes on the CPU."""
    from torchdrivesim_tpu_torch import gym_env
    calls = {}
    orig = signal.signal

    def capture(sig, handler):
        calls[sig] = handler
        return orig(sig, signal.SIG_DFL) if sig == signal.SIGTERM else orig(sig, handler)

    old = signal.getsignal(signal.SIGTERM)
    try:
        signal.signal = capture
        gym_env.main(['--agents', '3', '--steps', '1', '--res', '64', '--device', 'cpu'])
    finally:
        signal.signal = orig
        orig(signal.SIGTERM, old)
    handler = calls.get(signal.SIGTERM)
    assert handler is not None, "main() must install a SIGTERM handler"
    with pytest.raises(InterruptedError):
        handler(signal.SIGTERM, None)
