"""
Scenario rollout demo (counterpart of the JAX package's
``examples/simulate.py``): place vehicles on a CARLA town with the
heuristic initializer, drive the lights by the map's baked FSM schedule,
roll the :class:`~torchdrivesim_tpu_torch.simulator.Simulator` facade
forward with mild steering noise, and print the offroad and collision
totals every 20 steps.

The first agent's egocentric bird's-eye view of every step is written as
one ``.npz`` file: ``frames``, a (steps, res, res, 3) uint8 array (no GIF
writer is needed). Views above 128 pixels render as n x n sub-views
through the fused render in one launch.

Runs on the CUDA card by default and raises without one, unless
``--device cpu`` is given:

    python -m torchdrivesim_tpu_torch.examples.simulate --map carla_Town02 \\
        --agents 8 --steps 80 --out simulate.npz
"""
import argparse
import random
from typing import List, Optional

import numpy as np
import torch

import torchdrivesim_tpu_torch.kinematic as K
from torchdrivesim_tpu_torch.behavior.heuristic import heuristic_initialize
from torchdrivesim_tpu_torch.benchmark import load_or_bake_texture
from torchdrivesim_tpu_torch.map import find_map_config, traffic_controls_from_map_config
from torchdrivesim_tpu_torch.simulator import Simulator, TorchDriveConfig
from torchdrivesim_tpu_torch.traffic_lights import BakedLightSchedule
from torchdrivesim_tpu_torch.utils import Resolution


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--map', default='carla_Town02')
    parser.add_argument('--agents', type=int, default=8)
    parser.add_argument('--steps', type=int, default=80)
    parser.add_argument('--res', type=int, default=256)
    parser.add_argument('--fov', type=float, default=80.0)
    parser.add_argument('--out', default='simulate.npz')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def build_simulator(args: argparse.Namespace) -> Simulator:
    """One environment of ``args.agents`` vehicles on ``args.map``."""
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass --device cpu to run on the CPU')
    rng = random.Random(args.seed)
    cfg_map = find_map_config(args.map)
    if cfg_map is None:
        raise SystemExit(f"map {args.map} not found")
    lanelet_map = cfg_map.lanelet_map
    if lanelet_map is None:
        raise SystemExit(f"map {args.map} has no OSM data for initialization")
    controls = traffic_controls_from_map_config(cfg_map, device=device)
    attrs, states = heuristic_initialize(lanelet_map, args.agents, rng,
                                         min_speed=1, max_speed=7)
    left_handed = bool(cfg_map.left_handed_coordinates)
    kin = K.KinematicBicycle(dt=0.1, left_handed=left_handed, device=device)
    kin.set_params(lr=attrs[..., 2])
    kin.set_state(states)
    sim = Simulator(road_mesh=cfg_map.road_mesh, kinematic_model=kin,
                    agent_size=attrs[..., :2],
                    initial_present_mask=np.ones((1, args.agents), dtype=bool),
                    cfg=TorchDriveConfig(left_handed_coordinates=left_handed),
                    traffic_controls=controls, map_grids=cfg_map.grids(device=device),
                    lanelet_map=[lanelet_map])
    sim.renderer.res = Resolution(args.res, args.res)
    sim.renderer.scale = 2.0 / args.fov
    sim.renderer.background_texture = load_or_bake_texture(cfg_map)
    controller = cfg_map.traffic_light_controller(rng)
    if controller is not None and 'traffic_light' in controls:
        sim.set_light_schedule(BakedLightSchedule(
            controller, controls['traffic_light'].actor_ids, device=device))
    return sim


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    sim = build_simulator(args)
    frames = []
    for t in range(args.steps):
        img = sim.render_egocentric()
        frames.append(img[0, 0].permute(1, 2, 0))
        # steady cruising with mild steering noise
        action = torch.as_tensor(
            np.random.RandomState(t).uniform(-0.02, 0.02, (1, args.agents, 2)),
            dtype=torch.float32, device=sim.device)
        sim.step(action)
        if t % 20 == 0:
            off = float(sim.compute_offroad().sum())
            col = float(sim.compute_collision().sum())
            print(f"t={t}: offroad={off:.2f} collision={col:.2f}")
    video = torch.stack(frames).to(torch.uint8).cpu().numpy()
    np.savez(args.out, frames=video)
    print(f"wrote {len(frames)} frames to {args.out}")


if __name__ == '__main__':
    main()
