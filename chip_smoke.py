"""
Smoke run of the PyTorch port on one CUDA card: builds the fused render
kernel from the checkout, holds it against its plain PyTorch version,
drives the headline env step (carla_Town02, 256 environments, 20 vehicles,
128 x 128 render plus all metrics) through the port's benchmark entry
points, compares its first steps with the CPU path, and times the kernel,
its plain version and the step.

    python3 chip_smoke.py

Exits non-zero without printing a result when no CUDA card is present or
any phase fails. The line before the last is a JSON object describing each
kernel of the path; the last line is ``{"ok": true, "device": ...}``.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

SOURCE = 'torchdrivesim_tpu_torch/csrc/fused_render.cu'
REPLACES = 'torchdrivesim_tpu/ops/pallas_fused.py:69'
BATCH, AGENTS, RES, FOV = 256, 20, 128, 70.0
MAIN_STEPS = 200
COMPARE_BATCH, COMPARE_STEPS = 4, 3


def card_label() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def step_operands(scenario, state):
    """The fused render's operands for the frame of ``state``, built the
    way the renderer builds them."""
    from torchdrivesim_tpu_torch.ops.rasterize import (
        camera_rows_cols, n_bands_for, prep_sorted_prim_coefs)
    from torchdrivesim_tpu_torch.ops.warp import warp_coefficients
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    sim = scenario.sim
    renderer = sim.renderer
    all_state = torch.cat([state.agent_state, state.npc_state], dim=-2)
    present = torch.cat([state.present_mask, state.npc_present_mask], dim=-1)
    ego = state.agent_state[:, 0]
    cams = Cameras(ego[:, :2], torch.stack([torch.sin(ego[:, 2]),
                                            torch.cos(ego[:, 2])], -1),
                   2.0 / scenario.fov)
    quads, qz, qc, tris, tz, tc = sim.birdview_mesh_generator.generate_prims(
        all_state, present_mask=present,
        traffic_light_state=state.traffic_control_state['traffic_light'])
    b, q, t = qz.shape[0], qz.shape[1], tz.shape[1]
    lh = renderer.cfg.left_handed_coordinates
    sq = camera_rows_cols(quads.reshape(b, q * 4, 2), cams.xy, cams.sc,
                          cams.scale, scenario.res, lh).reshape(b, q, 4, 2)
    st = camera_rows_cols(tris.reshape(b, t * 3, 2), cams.xy, cams.sc,
                          cams.scale, scenario.res, lh).reshape(b, t, 3, 2)
    qcoef, qpk, qmask, tcoef, tpk, tmask = prep_sorted_prim_coefs(
        sq, qz, qc, st, tz, tc, scenario.res, 56, n_bands_for(scenario.res))
    mip = renderer._warp_mip(cams.scale, scenario.res)
    fcoef, icoef = warp_coefficients(mip, cams.xy, cams.sc, cams.scale,
                                     renderer._background_color,
                                     left_handed=lh, res=scenario.res)
    return mip, (fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask)


def random_operands(seed: int, b: int, res: int, device):
    """Random screen-space scene over a random texture, half the cameras on
    the transposed-window branch (headings near 0 / 180 degrees)."""
    from torchdrivesim_tpu_torch.ops.rasterize import (
        n_bands_for, prep_sorted_prim_coefs)
    from torchdrivesim_tpu_torch.ops.warp import (
        build_mip_pyramid, select_mip, warp_coefficients)
    rng = np.random.RandomState(seed)
    tex = rng.rand(300, 300, 3).astype(np.float32)
    mip = select_mip(build_mip_pyramid(tex, np.zeros(2), 0.5), fov=40.0).to(device)
    ang = rng.rand(b) * 2 * np.pi
    ang[::2] = np.deg2rad(rng.uniform(-5, 5, ang[::2].shape) + 180 * (rng.rand(ang[::2].size) > 0.5))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    xy = t(rng.rand(b, 2) * 120 + 10)
    sc = t(np.stack([np.sin(ang), np.cos(ang)], -1))
    c0 = rng.rand(b, 30, 2) * 140 - 6
    e1, e2 = rng.randn(b, 30, 2) * 6, rng.randn(b, 30, 2) * 6
    quads = t(np.stack([c0, c0 + e1, c0 + e1 + e2, c0 + e2], axis=2))
    tris = t(rng.rand(b, 12, 3, 2) * 140 - 6)
    qcoef, qpk, qmask, tcoef, tpk, tmask = prep_sorted_prim_coefs(
        quads, t(rng.rand(b, 30)), t(rng.rand(b, 30, 3)), tris,
        t(rng.rand(b, 12)), t(rng.rand(b, 12, 3)), res, 56, n_bands_for(res))
    fcoef, icoef = warp_coefficients(mip, xy, sc, 2.0 / 40.0,
                                     t([0.1, 0.2, 0.3]), res=res)
    assert int((icoef[:, 0, 2] == 1).sum()) > 0, 'no camera on the flip branch'
    return mip, (fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask)


def compare_kernel(fused, mip, ops, label):
    """Kernel against plain version in both output modes; returns the
    largest absolute difference of the float output."""
    worst = 0.0
    for packed in (False, True):
        got = fused.render_coefs_fused(mip, *ops, RES, packed)
        want = fused.render_coefs_fused_reference(mip, *ops, RES, packed)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        print(f'{label} packed={packed}: {mismatches} mismatching values of '
              f'{got.numel()}')
        if mismatches:
            raise AssertionError(f'{label}: kernel disagrees with its plain version')
        if not packed:
            worst = max(worst, float((got - want).abs().max()))
    return worst


def compare_with_cpu(build, label):
    """The first steps of the B = 4 scenario on the card against the CPU
    path: states and metrics to 1e-4, images >= 99.9% identical pixels."""
    runs = {}
    for dev in ('cuda', 'cpu'):
        scn = build(batch_size=COMPARE_BATCH, device=dev)
        step = scn.make_step_fn(render=True, metrics=True)
        state = scn.sim.state
        action = torch.zeros((COMPARE_BATCH, AGENTS, 2), device=dev)
        outs = []
        for _ in range(COMPARE_STEPS):
            state, out = step(state, action)
            outs.append((state.agent_state.cpu(),
                         {k: v.cpu() for k, v in out.items()}))
        runs[dev] = outs
    for i, ((sg, og), (sc, oc)) in enumerate(zip(runs['cuda'], runs['cpu'])):
        torch.testing.assert_close(sg, sc, atol=1e-4, rtol=0)
        for k in oc:
            if k == 'image':
                same = float((og[k] == oc[k]).all(dim=1).float().mean())
                print(f'{label} step {i}: {same * 100:.4f}% of pixels identical '
                      'on the card and the CPU')
                if same < 0.999:
                    raise AssertionError(f'step {i}: images differ')
            else:
                torch.testing.assert_close(og[k].float(), oc[k].float(),
                                           atol=1e-4, rtol=0)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from torchdrivesim_tpu_torch.benchmark import (
        build_benchmark_scenario, run_benchmark)
    from torchdrivesim_tpu_torch.ops import fused

    device = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    card = card_label()
    print(f'device: {name}')
    print(card)                  # name, power.limit as nvidia-smi gives them
    print(f'fused_render build: {fused.timed_build():.2f} s (nvcc sm_90a)')

    # 1. kernel against plain version at the headline operands
    scenario = build_benchmark_scenario(batch_size=BATCH, agent_count=AGENTS,
                                        res=RES, fov=FOV, device=device)
    mip, ops = step_operands(scenario, scenario.sim.state)
    print(f'headline operands: qcoef {tuple(ops[2].shape)}, tcoef '
          f'{tuple(ops[4].shape)}, qmask {tuple(ops[6].shape)}, '
          f'tmask {tuple(ops[7].shape)}, texture {tuple(mip.data.shape)}')
    max_err = compare_kernel(fused, mip, ops, 'headline')
    compare_kernel(fused, *random_operands(5, 64, RES, device), 'random scene')

    # 2. the first steps on the card against the CPU path
    compare_with_cpu(build_benchmark_scenario, 'compare')

    # 3. the main path: 200 headline steps, counting kernel launches
    step = scenario.make_step_fn(render=True, metrics=True)
    state = scenario.sim.state
    action = torch.zeros((BATCH, AGENTS, 2), device=device)
    fused.LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(MAIN_STEPS):
        state, out = step(state, action)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = fused.LAUNCHES
    print(f'main path: {MAIN_STEPS} steps at B={BATCH} in {main_s:.2f} s, '
          f'fused_render launches {launches}')
    if launches != MAIN_STEPS:
        raise AssertionError(f'expected {MAIN_STEPS} kernel launches, got {launches}')
    for k, v in out.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f'{k}: non-finite values')
    image = out['image']
    if image.shape != (BATCH, 3, RES, RES):
        raise AssertionError(f'image shape {tuple(image.shape)}')
    # every view shows at least its own vehicle (the ego sits at the center)
    vehicle = torch.tensor(scenario.sim.renderer.color_map['vehicle'],
                           dtype=torch.float32, device=device)
    on_car = ((image - vehicle[None, :, None, None]).abs() < 0.5).all(dim=1)
    with_car = float((on_car.sum(dim=(1, 2)) >= 10).float().mean())
    print(f'{with_car * 100:.1f}% of views show vehicle pixels')
    if with_car < 0.9:
        raise AssertionError('images do not show the vehicles')

    # 4. times, on this card
    mip, ops = step_operands(scenario, state)
    kernel_ms = cuda_ms(lambda: fused.render_coefs_fused(mip, *ops, RES), 50)
    plain_ms = cuda_ms(lambda: fused.render_coefs_fused_reference(mip, *ops, RES), 5)
    packed_ms = cuda_ms(lambda: fused.render_coefs_fused(mip, *ops, RES, True), 50)
    print(f'fused_render kernel B={BATCH} res={RES} float out: {kernel_ms:.4f} ms, '
          f'packed out: {packed_ms:.4f} ms; plain version: {plain_ms:.3f} ms '
          f'[{card}]')
    bench = run_benchmark(scenario, steps_per_chunk=100, n_chunks=3)
    print(f'env step B={BATCH} res={RES} render+metrics: '
          f'{bench["env_steps_per_sec_median"]:.1f} env-steps/s median of '
          f'chunks {[round(r, 1) for r in bench["chunk_rates"]]} [{card}]')

    print(json.dumps({'kernels': [{
        'name': 'fused_render', 'route': 'cuda', 'source': SOURCE,
        'replaces': REPLACES, 'launches': launches, 'max_abs_err': max_err,
        'ms': kernel_ms, 'plain_ms': plain_ms}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
