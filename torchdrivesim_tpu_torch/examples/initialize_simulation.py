"""
Scenario initialization demo (counterpart of the JAX package's
``examples/initialize_simulation.py``): place agents on a map with the
heuristic initializer (or the Inverted AI INITIALIZE endpoint, which needs
the ``invertedai`` client) and render the initial frame: one camera over
the map's center, fov 250 m at 512 x 512, the whole map mesh drawn (no
texture). The frame is written as ``frame``, a (512, 512, 3) uint8 array,
in one ``.npz`` file.

Runs on the CUDA card by default and raises without one, unless
``--device cpu`` is given:

    python -m torchdrivesim_tpu_torch.examples.initialize_simulation \\
        --map carla_Town02 --agents 10 --out initialized.npz
"""
import argparse
import random
from typing import List, Optional

import numpy as np
import torch

import torchdrivesim_tpu_torch.kinematic as K
from torchdrivesim_tpu_torch.map import find_map_config, traffic_controls_from_map_config
from torchdrivesim_tpu_torch.rendering import RendererConfig
from torchdrivesim_tpu_torch.simulator import Simulator, TorchDriveConfig
from torchdrivesim_tpu_torch.utils import Resolution

RES, FOV = 512, 250.0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--map', default='carla_Town02')
    parser.add_argument('--agents', type=int, default=10)
    parser.add_argument('--method', choices=['heuristic', 'iai'], default='heuristic')
    parser.add_argument('--out', default='initialized.npz')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def build_simulator(args: argparse.Namespace) -> Simulator:
    """One environment of ``args.agents`` agents on ``args.map``, placed by
    ``args.method``."""
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass --device cpu to run on the CPU')
    cfg_map = find_map_config(args.map)
    if cfg_map is None:
        raise SystemExit(f"map {args.map} not found")
    if args.method == 'iai':
        from torchdrivesim_tpu_torch.behavior.iai import iai_initialize
        attrs, states, _ = iai_initialize(cfg_map.iai_location_name, args.agents,
                                          center=cfg_map.center or (0, 0), device=device)
    else:
        from torchdrivesim_tpu_torch.behavior.heuristic import heuristic_initialize
        attrs, states = heuristic_initialize(cfg_map.lanelet_map, args.agents,
                                             random.Random(args.seed))
    left_handed = bool(cfg_map.left_handed_coordinates)
    kin = K.KinematicBicycle(dt=0.1, left_handed=left_handed, device=device)
    kin.set_params(lr=attrs[..., 2])
    kin.set_state(states)
    cfg = TorchDriveConfig(left_handed_coordinates=left_handed,
                           renderer=RendererConfig(left_handed_coordinates=left_handed))
    sim = Simulator(road_mesh=cfg_map.road_mesh, kinematic_model=kin,
                    agent_size=attrs[..., :2],
                    initial_present_mask=np.ones((1, args.agents), dtype=bool), cfg=cfg,
                    traffic_controls=traffic_controls_from_map_config(cfg_map,
                                                                      device=device))
    sim.renderer.res = Resolution(RES, RES)
    return sim


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Initialize, render and write the frame; returns it (uint8)."""
    args = parse_args(argv)
    sim = build_simulator(args)
    center = sim.get_world_center().reshape(1, 2)
    image = sim.render(center, torch.zeros((1, 1), device=sim.device), fov=FOV,
                       res=Resolution(RES, RES))
    frame = image[0, 0].permute(1, 2, 0).to(torch.uint8).cpu().numpy()
    np.savez(args.out, frame=frame)
    print(f"initialized {args.agents} agents; wrote {args.out}")
    return frame


if __name__ == '__main__':
    main()
