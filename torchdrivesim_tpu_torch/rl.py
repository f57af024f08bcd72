"""
PPO on the vectorized driving environment (counterpart of
``examples/rl_example.py``): roll the policy through the environment for T
steps (:func:`collect`), estimate advantages (:func:`gae`) and take PPO
epochs on the rollout (:func:`ppo_update`), all on the card.

    python -m torchdrivesim_tpu_torch.rl --envs 1024 --iterations 2

The environment is ``benchmark.build_rl_env``'s
:class:`~torchdrivesim_tpu_torch.gym_env.VectorizedGymEnv` with 4 agents;
the policy :class:`~torchdrivesim_tpu_torch.models.ActorCritic` with
features (16, 32) in bfloat16; the optimizer ``torch.optim.Adam`` (optax's
defaults). Each rollout step renders twice, as the reference's
does: once to observe the current state (a step with a zero action whose
state is discarded) and once after the sampled action.
"""
import argparse
import math
import time
from typing import Callable, Tuple

import torch

from torchdrivesim_tpu_torch.benchmark import build_rl_env
from torchdrivesim_tpu_torch.models import ActorCritic

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_LOG_2PI = math.log(2 * math.pi)


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor, gamma: float = 0.99, lam: float = 0.95
        ) -> torch.Tensor:
    """Generalized advantage estimation over a T-major rollout ((T, B)
    rewards, values and float dones; (B,) bootstrap value), by a reverse
    loop. Returns (T, B) advantages."""
    adv = torch.zeros_like(last_value)
    value_next = last_value
    advs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        not_done = 1.0 - dones[t]
        delta = rewards[t] + gamma * value_next * not_done - values[t]
        adv = delta + gamma * lam * not_done * adv
        value_next = values[t]
        advs.append(adv)
    return torch.stack(advs[::-1])


def log_prob(action: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor
             ) -> torch.Tensor:
    """Diagonal Gaussian log-density, summed over the action dims."""
    std = torch.exp(log_std)
    return torch.sum(-0.5 * ((action - mean) / std) ** 2 - log_std - 0.5 * _LOG_2PI,
                     dim=-1)


def collect(model: ActorCritic, step_fn: Callable, state, rollout: int,
            generator: torch.Generator):
    """
    Roll the policy through the environment for ``rollout`` steps.

    Each step observes the current state (``step_fn`` with a zero action),
    samples ``mean + std * noise`` with standard normal noise drawn from
    ``generator`` (shape (B, 2), one draw per step, on the generator's
    device), and steps the environment with ``tanh`` of the action.

    Returns:
        (final state, (obs (T, B, 3, H, W), actions (T, B, 2), logps (T, B),
        advantages (T, B), returns (T, B))).
    """
    b = state.agent_state.shape[0]
    device = state.agent_state.device
    zero = torch.zeros((b, 2), device=device)
    obs_l, act_l, logp_l, value_l, reward_l, done_l = [], [], [], [], [], []
    with torch.no_grad():
        for _ in range(rollout):
            _, obs, _, _ = step_fn(state, zero)
            mean, log_std, value = model(obs)
            noise = torch.randn(mean.shape, generator=generator,
                                device=generator.device).to(device)
            action = mean + torch.exp(log_std) * noise
            state, _, reward, done = step_fn(state, torch.tanh(action))
            obs_l.append(obs)
            act_l.append(action)
            logp_l.append(log_prob(action, mean, log_std))
            value_l.append(value)
            reward_l.append(reward)
            done_l.append(done.to(torch.float32))
        _, last_obs, _, _ = step_fn(state, zero)
        last_value = model(last_obs)[2]
        values, rewards = torch.stack(value_l), torch.stack(reward_l)
        advs = gae(rewards, values, torch.stack(done_l), last_value)
    return state, (torch.stack(obs_l), torch.stack(act_l), torch.stack(logp_l),
                   advs, advs + values)


def ppo_loss(model: ActorCritic, batch: Batch, clip: float = 0.2):
    """The clipped PPO objective on a T-major rollout, advantages
    normalized by their mean and population std: ``pg + 0.5 v_loss -
    0.01 entropy``. Returns (loss, pg, v_loss)."""
    obs, actions, logps_old, advs, returns = batch
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    obs, actions = flat(obs), flat(actions)
    logps_old, advs, returns = flat(logps_old), flat(advs), flat(returns)
    advs = (advs - advs.mean()) / (advs.std(unbiased=False) + 1e-8)
    mean, log_std, value = model(obs)
    ratio = torch.exp(log_prob(actions, mean, log_std) - logps_old)
    pg = -torch.mean(torch.minimum(ratio * advs,
                                   torch.clamp(ratio, 1 - clip, 1 + clip) * advs))
    v_loss = torch.mean((value - returns) ** 2)
    entropy = torch.mean(torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e),
                                   dim=-1))
    return pg + 0.5 * v_loss - 0.01 * entropy, pg, v_loss


def make_optimizer(model: ActorCritic, lr: float = 3e-4) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8 outside
    the square root)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def ppo_update(model: ActorCritic, optimizer: torch.optim.Optimizer,
               batch: Batch, clip: float = 0.2):
    """One gradient step of :func:`ppo_loss`; returns the detached
    (loss, pg, v_loss) before the step."""
    optimizer.zero_grad(set_to_none=True)
    loss, pg, v_loss = ppo_loss(model, batch, clip)
    loss.backward()
    optimizer.step()
    return loss.detach(), pg.detach(), v_loss.detach()


def build(envs: int, res: int = 64, map_name: str = 'carla_Town02',
          lr: float = 3e-4, device='cuda'):
    """The example's environment (``benchmark.build_rl_env``: 4 agents),
    model and optimizer on ``device``; the model's weights are drawn from
    seed 0, as the example draws them from ``PRNGKey(0)``."""
    venv = build_rl_env(batch_size=envs, map_name=map_name, res=res, device=device)
    torch.manual_seed(0)
    model = ActorCritic(action_size=2, features=(16, 32)).to(venv.device)
    return venv, model, make_optimizer(model, lr)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--envs', type=int, default=16)
    parser.add_argument('--rollout', type=int, default=16)
    parser.add_argument('--iterations', type=int, default=10)
    parser.add_argument('--epochs', type=int, default=2)
    parser.add_argument('--res', type=int, default=64)
    parser.add_argument('--lr', type=float, default=3e-4)
    parser.add_argument('--clip', type=float, default=0.2)
    parser.add_argument('--map', default='carla_Town02')
    args = parser.parse_args(argv)

    venv, model, optimizer = build(args.envs, args.res, args.map, args.lr,
                                   device='cuda')
    step_fn = venv.make_step_fn()
    generator = torch.Generator(device=venv.device).manual_seed(0)
    state = venv.initial_state
    for it in range(args.iterations):
        t0 = time.perf_counter()
        state, batch = collect(model, step_fn, state, args.rollout, generator)
        mean_reward = float(batch[4].mean())  # returns
        for _ in range(args.epochs):
            loss, _, _ = ppo_update(model, optimizer, batch, args.clip)
        steps = args.envs * args.rollout
        dt = time.perf_counter() - t0
        print(f"iter {it}: return {mean_reward:.3f} loss {float(loss):.3f} "
              f"({steps/dt:.0f} env-steps/s)")
    print("done")


if __name__ == '__main__':
    main()
