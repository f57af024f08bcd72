"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (a CPU run at a tiny size), the rest of
the run is the cell's own. And the control (the reference in bfloat16 in
the program's place) fails the cell's limits."""
import time

import pytest
import torch

from gpubench import control, harness

from test_gpubench_reference import IL, ROLLOUT, SEED


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(4)


def run(cell, overrides):
    return harness.run_cell(cell, SEED, 0.0, False, device='cpu',
                            t_start=time.perf_counter(), overrides=overrides)


def state_unchanged(monkeypatch):
    """The step returns its state unchanged (still a function of the action,
    so that a gradient exists)."""
    import dataclasses
    from torchdrivesim_tpu_torch.simulator import Simulator

    def functional_step(self, state, action):
        return dataclasses.replace(state, agent_state=state.agent_state
                                   + 0.0 * action.sum())
    monkeypatch.setattr(Simulator, 'functional_step', functional_step)


def rollout_output_altered(key, alter):
    def fault(monkeypatch):
        from torchdrivesim_tpu_torch.benchmark import BenchmarkScenario
        make = BenchmarkScenario.make_step_fn

        def make_step_fn(self, *args, **kwargs):
            step = make(self, *args, **kwargs)

            def altered(state, action):
                state, out = step(state, action)
                return state, dict(out, **{key: alter(out[key])})
            return altered
        monkeypatch.setattr(BenchmarkScenario, 'make_step_fn', make_step_fn)
    return fault


def il_half_batch(monkeypatch):
    import torchdrivesim_tpu_torch.benchmark as B

    def make_il_loss_fn(scenario, policy, horizon=40):
        rollout = B.make_il_rollout_fn(scenario, policy, horizon)

        def loss_fn(state):
            final = rollout(state).agent_state
            return torch.mean(final[: final.shape[0] // 2, 0, :2] ** 2)
        return loss_fn
    monkeypatch.setattr(B, 'make_il_loss_fn', make_il_loss_fn)


def il_gradient_altered(monkeypatch):
    import torchdrivesim_tpu_torch.benchmark as B
    make = B.make_il_grad_fn

    def make_il_grad_fn(*args, **kwargs):
        grad_fn = make(*args, **kwargs)

        def altered(state):
            loss, grads = grad_fn(state)
            return loss, grads[:-1] + [-grads[-1]]
        return altered
    monkeypatch.setattr(B, 'make_il_grad_fn', make_il_grad_fn)


@pytest.mark.parametrize('fault', [
    state_unchanged,
    rollout_output_altered('collision', lambda x: x + 0.5),
    rollout_output_altered('image', lambda x: x.flip(1)),
], ids=['state_unchanged', 'collision_altered', 'image_altered'])
def test_rollout_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not run('rollout_untextured', ROLLOUT)['correct']


@pytest.mark.parametrize('fault', [state_unchanged, il_half_batch, il_gradient_altered],
                         ids=['state_unchanged', 'half_batch', 'gradient_altered'])
def test_il_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not run('il_untextured', IL)['correct']


@pytest.mark.parametrize('cell,overrides', [
    ('rollout_untextured', {k: v for k, v in ROLLOUT.items() if k != 'warmup_steps'}),
    ('il_untextured', IL)])
def test_control_fails_the_limits(cell, overrides):
    values, limits = control.readings(cell, SEED, 'cpu', overrides)
    assert any(not values[k] <= limits[k] for k in limits), values
