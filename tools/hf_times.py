"""
Time HF, the float-color hard raster of the PyTorch port
(``torchdrivesim_tpu_torch/ops/hard_faces.py``), by CUDA-graph replay on its
main paths' operands: the ``Pytorch3DRendererConfig()`` facade frame (1,280
cameras, ~94 faces each) at 64 and 128 px, the differentiable face soup (256
cameras of 128 px, 64 faces, on the first frame of ``chip_smoke``'s face-soup
world) and the strips of the Town02 texture bake (4 px/m).

    python tools/hf_times.py [--root DIR] [--reps N]

``--root`` imports the port and ``chip_smoke.py`` from DIR, another checkout
(say the parent commit unpacked by ``git archive``), so that two versions are
timed one after the other on one card: run parent, change, change, parent.
Needs a CUDA card. Prints the card's name and power limit, one line a path,
then one JSON object {"root": ..., "card": ..., "ms": {path: ms}}. With
``--profile``, each path's device time by kernel (``torch.profiler`` over
``--reps`` eager calls) follows its line.
"""
import argparse
import dataclasses
import json
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help='checkout to import the port from')
    parser.add_argument('--reps', type=int, default=20, help='calls per graph replay')
    parser.add_argument('--profile', action='store_true',
                        help='also print the device time by kernel')
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print('hf_times: no CUDA device', file=sys.stderr)
        return 1
    import chip_smoke as C
    from torchdrivesim_tpu_torch.ops import hard_faces
    if not os.path.abspath(hard_faces.__file__).startswith(root + os.sep):
        raise RuntimeError(f'imported {hard_faces.__file__}, not from {root}')
    device = torch.device('cuda', 0)
    card = C.card_label()
    print(card)
    operands = main_path_operands(device)
    times = {}
    for name, ops in operands.items():
        b, f = ops[1].shape
        h, w = ops[3].shape[-2:]
        times[name] = C.graph_ms(lambda: hard_faces.hard_faces(*ops), args.reps)
        print(f'{name}: HF B={b} F={f} {h}x{w}: {times[name]:.4f} ms (device, graph replay '
              f'of {args.reps} calls) [{card}]')
        if args.profile:
            for kernel, calls, us in kernel_times(lambda: hard_faces.hard_faces(*ops),
                                                  args.reps):
                print(f'  {kernel}: {calls} calls, {us:.2f} us each (device, profiler)')
    print(json.dumps({'root': root, 'card': card, 'ms': times}))
    return 0


def main_path_operands(device):
    """HF's operands on its main paths, by name: the facade frames, the
    face soup's first frame and the Town02 bake's strips (see above)."""
    import torch
    import chip_smoke as C
    from torchdrivesim_tpu_torch import benchmark
    from torchdrivesim_tpu_torch.map import find_map_config
    from torchdrivesim_tpu_torch.ops import rasterize
    from torchdrivesim_tpu_torch.rendering import Pytorch3DRendererConfig, Renderer
    operands = {}
    sim = C.facade_world(C.FACADE_BATCH, device, renderer_config=Pytorch3DRendererConfig())
    for res in (64, 128):
        prims, cams = sim.egocentric_prim_frame(fov=C.FOV)
        operands[f'facade_res{res}'] = tuple(t.detach().contiguous() for t in
                                             sim.renderer.prims_plain_operands(
                                                 *prims, res, cams))
    scenario, wps, mask = C.faces_world(C.BATCH, device)
    faces, cams = C.faces_frame(scenario, scenario.sim.state, wps, mask)
    renderer = Renderer(dataclasses.replace(scenario.sim.renderer.cfg, differentiable=True),
                        device)
    renderer.background_texture = scenario.sim.renderer.background_texture
    bg, ops, _ = renderer.face_frame_operands(*faces, C.RES, cams)
    operands['face_soup'] = tuple(t.contiguous() for t in (*ops, bg))
    # the bake's strips, captured at the call (the bake itself not run)
    strips, real = [], rasterize._hard_faces.hard_faces

    def capture(corners, z, color, background):
        strips.append(tuple(t.contiguous() for t in (corners, z, color, background)))
        b, _, h, w = background.shape
        return (background.new_zeros(background.shape),
                torch.zeros((b, h, w), dtype=torch.int32, device=background.device))
    rasterize._hard_faces.hard_faces = capture
    saved_path = benchmark.texture_cache_path
    benchmark.texture_cache_path = lambda cfg, ppm: None
    try:
        benchmark.load_or_bake_texture(find_map_config('carla_Town02'), device=device)
    finally:
        rasterize._hard_faces.hard_faces = real
        benchmark.texture_cache_path = saved_path
    for i, strip in enumerate(strips):
        operands[f'town02_strip{i}'] = strip
    return operands


def kernel_times(fn, reps: int):
    """(kernel name, calls, mean device microseconds) of every kernel and
    memset that ``reps`` eager calls of ``fn`` run, by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for event in prof.key_averages():
        total = getattr(event, 'self_device_time_total', 0)
        if event.device_type.name == 'CUDA' and total > 0:
            rows.append((event.key[:60], event.count, total / event.count))
    return rows


if __name__ == '__main__':
    sys.exit(main())
