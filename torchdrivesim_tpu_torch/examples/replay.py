"""
Replay an INTERACTION recording through the simulator (counterpart of the
JAX package's ``examples/replay.py``): the first recorded agent is the
ego, a teleporting agent that follows its own track; every other agent is
an NPC replayed from the recording. The ego's view (res 256, fov 100 m)
of every frame is written as one ``.npz`` file: ``frames``, a (frames,
res, res, 3) uint8 array (no GIF writer is needed).

Runs on the CUDA card by default and raises without one, unless
``--device cpu`` is given:

    python -m torchdrivesim_tpu_torch.examples.replay \\
        --dataset-path /path/to/INTERACTION --location DR_USA_Intersection_MA \\
        --map-mesh /path/to/mesh.json --out replay.npz
"""
import argparse
import os
from typing import List, Optional

import numpy as np
import torch

import torchdrivesim_tpu_torch.kinematic as K
from torchdrivesim_tpu_torch.behavior.replay import ReplayController, interaction_replay
from torchdrivesim_tpu_torch.mesh import BirdviewMesh
from torchdrivesim_tpu_torch.simulator import Simulator, TorchDriveConfig
from torchdrivesim_tpu_torch.utils import Resolution

FOV = 100.0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--dataset-path', required=True)
    parser.add_argument('--location', default='DR_USA_Intersection_MA')
    parser.add_argument('--map-mesh', default=None,
                        help='serialized BirdviewMesh JSON for the location')
    parser.add_argument('--segment-length', type=int, default=40)
    parser.add_argument('--initial-frame', type=int, default=1)
    parser.add_argument('--res', type=int, default=256)
    parser.add_argument('--out', default='replay.npz')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def build_simulator(args: argparse.Namespace):
    """(the replay's simulator, the recorded states (1, A, T, 4))."""
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass --device cpu to run on the CPU')
    attrs, states, present = interaction_replay(
        args.location, args.dataset_path, initial_frame=args.initial_frame,
        segment_length=args.segment_length, device=device)
    print(f"loaded {attrs.shape[1]} agents, {states.shape[2]} frames")
    kin = K.TeleportingKinematicModel(dt=0.1, device=device)
    kin.set_state(states[:, :1, 0])
    npc = ReplayController(npc_size=attrs[:, 1:, :2], npc_states=states[:, 1:],
                           npc_present_masks=present[:, 1:])
    if args.map_mesh and os.path.exists(args.map_mesh):
        road = BirdviewMesh.load(args.map_mesh)
    else:
        road = BirdviewMesh.empty(batch_size=1)
        print("no map mesh provided; rendering agents on a blank background")
    sim = Simulator(road_mesh=road, kinematic_model=kin, agent_size=attrs[:, :1, :2],
                    initial_present_mask=present[:, :1, 0], cfg=TorchDriveConfig(),
                    npc_controller=npc)
    sim.renderer.res = Resolution(args.res, args.res)
    sim.renderer.scale = 2.0 / FOV
    return sim, states


def main(argv: Optional[List[str]] = None) -> Simulator:
    """Replay the segment, write its frames; returns the simulator, at the
    segment's last frame."""
    args = parse_args(argv)
    sim, states = build_simulator(args)
    frames = []
    for t in range(args.segment_length - 1):
        img = sim.render_egocentric()
        frames.append(img[0, 0].permute(1, 2, 0))
        # the ego follows its own recording by teleport actions
        sim.step(states[:, :1, t + 1])
    video = torch.stack(frames).to(torch.uint8).cpu().numpy()
    np.savez(args.out, frames=video)
    print(f"wrote {len(frames)} frames to {args.out}")
    return sim


if __name__ == '__main__':
    main()
