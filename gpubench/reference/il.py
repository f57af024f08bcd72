"""
The imitation-learning gradient, plainly: ``horizon`` steps in which each
environment's first agent is driven by a CNN policy on its differentiable
view (:class:`gpubench.reference.soft.Frame`), the other agents hold zero
action, and the bicycle moves every agent; the loss is the mean squared
final position of the first agent, differentiated with respect to every
policy parameter.

The policy (TorchDriveSim's ``BirdviewCNNPolicy``): the image over 255 in
the torso's type, strided 3 x 3 convolutions with 'SAME' padding (flax's
rule) and ReLU, a spatial mean accumulated in float32 and rounded to the
torso's type, a dense layer with ReLU in that type, then the head in
float32 and ``tanh``. Parameters are float32, in the order convolution
weights and biases, dense weights and biases, head weight and bias.
"""
from typing import List

import torch
import torch.nn.functional as F

from gpubench.reference import sim


def _same_pad(size: int, kernel: int = 3, stride: int = 2):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def policy(params: List[torch.Tensor], image: torch.Tensor,
           torso=torch.bfloat16, head=torch.float32) -> torch.Tensor:
    """(B, 3, H, W) image in [0, 255] -> (B, actions) in [-1, 1]."""
    *convs, w0, b0, w1, b1 = params
    x = (image / 255.0).to(torso)
    for w, b in zip(convs[0::2], convs[1::2]):
        ph, pw = _same_pad(x.shape[-2]), _same_pad(x.shape[-1])
        x = F.pad(x, (*pw, *ph))
        x = F.relu(F.conv2d(x, w.to(torso), b.to(torso), stride=2))
    x = x.float().mean(dim=(2, 3)).to(torso)
    x = F.relu(F.linear(x, w0.to(torso), b0.to(torso)))
    return torch.tanh(F.linear(x.to(head), w1.to(head), b1.to(head)))


def loss_and_grads(frame, params: List[torch.Tensor], state: torch.Tensor,
                   size: torch.Tensor, lr: torch.Tensor, dt: float, left_handed: bool,
                   horizon: int, dtype=torch.float32, torso=torch.bfloat16):
    """(loss, [d loss / d p for p in params], states (horizon + 1, B, A, 4))
    of the rollout from ``state``, dynamics and render in ``dtype``."""
    params = [p.detach().clone().requires_grad_(True) for p in params]
    state = state.to(dtype)
    size, lr = size.to(dtype), lr.to(dtype)
    states = [state.detach()]
    for _ in range(horizon):
        act = policy(params, frame(state, size), torso=torso, head=dtype).to(dtype)
        action = torch.cat([act[:, None], act.new_zeros(
            (act.shape[0], state.shape[1] - 1, act.shape[1]))], dim=1)
        state = sim.bicycle_step(state, action, lr, dt, left_handed)
        states.append(state.detach())
    loss = torch.mean(state[:, 0, :2].float() ** 2)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), [g.float() for g in grads], torch.stack(states)
