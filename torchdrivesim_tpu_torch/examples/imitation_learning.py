"""
Behaviour cloning through the differentiable simulator (counterpart of the
JAX package's ``examples/imitation_learning.py``): the loss is the mean
squared error between expert trajectories and the states of rolling the
policy through the simulator, its gradient flowing through every
kinematic step and every soft bird's-eye-view render of the rollout.

Without ``--dataset-path`` the scenario is the synthetic straight road
with a lane-keeping expert. With it, INTERACTION v1.2 cases are read
from the dataset root (``maps/{location}.osm`` and
``train/{location}_train.csv``): each ego is a recorded vehicle track and
the case's other agents are replayed as NPCs, drawn in every frame over
the road mesh triangulated from the location's lanelet map.

Runs on the CUDA card by default and raises without one, unless
``--device cpu`` is given:

    python -m torchdrivesim_tpu_torch.examples.imitation_learning \\
        --dataset-path /path/to/INTERACTION --location DR_USA_Intersection_MA
"""
import argparse
import time
from typing import List, Optional

import torch

from torchdrivesim_tpu_torch.imitation import (
    build_dataset_batch, build_synthetic_batch, build_synthetic_simulator,
    make_bc_train_step, make_optimizer,
)
from torchdrivesim_tpu_torch.models import BirdviewCNNPolicy


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--synthetic', action='store_true', default=True)
    parser.add_argument('--dataset-path', default=None,
                        help='INTERACTION dataset root (uses real replays)')
    parser.add_argument('--location', default='DR_USA_Intersection_MA')
    parser.add_argument('--batch', type=int, default=8)
    parser.add_argument('--horizon', type=int, default=10)
    parser.add_argument('--res', type=int, default=64)
    parser.add_argument('--steps', type=int, default=30)
    parser.add_argument('--lr', type=float, default=3e-4)
    parser.add_argument('--teacher-forcing', action='store_true',
                        help='start each step from the expert\'s frame')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Train for ``--steps`` steps; returns the losses."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass --device cpu to run on the CPU')
    npc = None
    if args.dataset_path:
        road, states0, expert, npc = build_dataset_batch(
            args.dataset_path, args.location, args.batch, args.horizon, device)
    else:
        road, states0, expert = build_synthetic_batch(args.batch, args.horizon,
                                                      device=device)
    sim = build_synthetic_simulator(road, states0, res=args.res, npc_controller=npc)
    torch.manual_seed(0)
    policy = BirdviewCNNPolicy(action_size=4, features=(16, 32)).to(device)
    train_step = make_bc_train_step(sim, policy, make_optimizer(policy, args.lr),
                                    args.res, teacher_forcing=args.teacher_forcing)
    print(f'{states0.shape[0]} environments, {sim.npc_count} NPCs each, horizon '
          f'{expert.shape[0]}, road mesh of {road.faces.shape[-2]} faces')
    losses = []
    for step in range(args.steps):
        t0 = time.perf_counter()
        losses.append(float(train_step(sim.state, expert)))
        if step % 5 == 0 or step == args.steps - 1:
            print(f'step {step}: BC loss {losses[-1]:.4f} '
                  f'({(time.perf_counter() - t0) * 1000:.0f} ms)')
    print('done')
    return losses


if __name__ == '__main__':
    main()
