"""
Smoke run of the PyTorch port on one CUDA card. Builds every kernel from the
checkout (one ``nvcc`` per source, all at once), then drives two paths:

* the headline env step (carla_Town02, 256 environments, 20 vehicles,
  128 x 128 render plus all metrics): the fused render kernel against its
  plain PyTorch version, the first steps against the CPU path, 200 steps
  counting launches, times;
* the imitation-learning gradient step (the same town, 16 environments,
  8 vehicles, 64 x 64 differentiable render, a 40-step rollout through the
  bilinear background warp and the soft raster, a CNN policy): the three
  kernels against their plain versions, a small gradient step against the
  CPU path, one full-width gradient step counting launches with a
  directional finite-difference check of its gradient, three steps of the
  behaviour-cloning loop, times and peak memory.

    python3 chip_smoke.py

Exits non-zero without printing a result when no CUDA card is present or
any phase fails. The line before the last is a JSON object describing each
kernel; the last line is ``{"ok": true, "device": ...}``.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, AGENTS, RES, FOV = 256, 20, 128, 70.0
MAIN_STEPS = 200
COMPARE_BATCH, COMPARE_STEPS = 4, 3
IL_BATCH, IL_AGENTS, IL_RES, IL_HORIZON, IL_FEATURES = 16, 8, 64, 40, (16, 32)

#: the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
#: at 3.35 TB/s; float32 at 67 TFLOP/s outside the tensor cores, which
#: counts a fused multiply-add as two operations. The kernels here forbid
#: contraction (round-to-nearest intrinsics), so each add, multiply, min or
#: compare issues on its own, at half that rate. exp and reciprocals run on
#: the special-function units: 16 results per SM and clock, 132 SMs at the
#: 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
SFU_OPS_PER_S = 132 * 16 * 1.98e9

#: float32 operations per (pixel, face) of the soft raster, counted from
#: csrc/soft_raster.cu, as (ALU, SFU): the forward evaluates 3 edge values
#: (4 each), 3 logistics (clamp 2, add; exp and reciprocal on the SFU), their
#: product and minimum (4), window (3), alpha, weight, 3 colour sums (6),
#: den and transparency (3); the backward repeats the forward, evaluates the
#: face terms again (25 + 6 SFU) and forms and sums 13 gradient terms (~50)
SOFT_FWD_OPS, SOFT_FWD_SFU = 39, 6
SOFT_BWD_OPS, SOFT_BWD_SFU = 39 + 25 + 50, 12
#: per pixel of the bilinear warp: 3 positions (4 each), 2 pass-1 taps of
#: 4 + 6 and 3 lerps (3 each), the final 3 lerps and the validity test (4)
WARP_OPS = 12 + 2 * (10 + 9) + 9 + 4
#: per pixel of the fused render: the warp index arithmetic and the texel
#: (~20), and per live 8-primitive chunk 8 quads x 11 or 8 triangles x 15
FUSED_PIXEL_OPS, FUSED_QUAD_OPS, FUSED_TRI_OPS = 20, 8 * 11, 8 * 15


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


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls captured in
    one CUDA graph and replayed: the kernels' time without the host's cost
    of issuing them through their wrappers."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, n_sfu: float = 0.0):
    """(bound ms, 'bytes' or 'operations'): the largest of the times of the
    bytes over HBM, the float32 ALU operations and the special-function
    operations (the two units issue side by side)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_ops / FP32_INSTR_PER_S, n_sfu / SFU_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def texel_bytes(mip, b: int, fov: float) -> float:
    """Texel bytes the views need: each camera's view covers about
    (fov / cell + 1)^2 texels of the mip level."""
    return b * (fov / mip.cell_size + 1) ** 2 * 4


# --- the headline step -------------------------------------------------------

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
    mip, fcoef, icoef = random_warp_operands(seed, b, res, device)
    rng = np.random.RandomState(seed + 1)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    c0 = rng.rand(b, 30, 2) * 140 - 6
    e1, e2 = rng.randn(b, 30, 2) * 6, rng.randn(b, 30, 2) * 6
    quads = t(np.stack([c0, c0 + e1, c0 + e1 + e2, c0 + e2], axis=2))
    tris = t(rng.rand(b, 12, 3, 2) * 140 - 6)
    qcoef, qpk, qmask, tcoef, tpk, tmask = prep_sorted_prim_coefs(
        quads, t(rng.rand(b, 30)), t(rng.rand(b, 30, 3)), tris,
        t(rng.rand(b, 12)), t(rng.rand(b, 12, 3)), res, 56, n_bands_for(res))
    return mip, (fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask)


def random_warp_operands(seed: int, b: int, res: int, device):
    """A random texture's mip level and warp coefficients of ``b`` cameras,
    half of them on the transposed-window branch."""
    from torchdrivesim_tpu_torch.ops.warp import (
        build_mip_pyramid, select_mip, warp_coefficients)
    rng = np.random.RandomState(seed)
    tex = rng.rand(300, 300, 3).astype(np.float32)
    mip = select_mip(build_mip_pyramid(tex, np.zeros(2), 0.5), fov=40.0).to(device)
    ang = rng.rand(b) * 2 * np.pi
    ang[::2] = np.deg2rad(rng.uniform(-5, 5, ang[::2].shape)
                          + 180 * (rng.rand(ang[::2].size) > 0.5))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    fcoef, icoef = warp_coefficients(mip, t(rng.rand(b, 2) * 120 + 10),
                                     t(np.stack([np.sin(ang), np.cos(ang)], -1)),
                                     2.0 / 40.0, t([0.1, 0.2, 0.3]), res=res)
    assert int((icoef[:, 0, 2] == 1).sum()) > 0, 'no camera on the flip branch'
    return mip, fcoef, icoef


def compare_fused(fused, mip, ops, label):
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


def fused_bound(mip, ops, res, fov):
    fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask = ops
    b, n_bands = qmask.shape[0], qmask.shape[1]
    band_pixels = res // n_bands * res
    live_q = (qmask != 0).sum(dim=(2, 3)).double()          # (B, bands)
    live_t = (tmask != 0).sum(dim=(2, 3)).double()
    ops_n = float((band_pixels * (FUSED_PIXEL_OPS + FUSED_QUAD_OPS * live_q
                                  + FUSED_TRI_OPS * live_t)).sum())
    out_bytes = b * 3 * res * res * 4
    in_bytes = nbytes(fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask) \
        + texel_bytes(mip, b, fov)
    return bound(out_bytes + in_bytes, ops_n)


def headline(device, card):
    """The headline phases; returns the fused kernel's JSON entry."""
    from torchdrivesim_tpu_torch.benchmark import (
        build_benchmark_scenario, run_benchmark)
    from torchdrivesim_tpu_torch.ops import fused

    # 1. kernel against plain version at the headline operands
    scenario = build_benchmark_scenario(batch_size=BATCH, agent_count=AGENTS,
                                        res=RES, fov=FOV, device=device)
    mip, ops = step_operands(scenario, scenario.sim.state)
    print(f'headline operands: qcoef {tuple(ops[2].shape)}, tcoef '
          f'{tuple(ops[4].shape)}, qmask {tuple(ops[6].shape)}, '
          f'tmask {tuple(ops[7].shape)}, texture {tuple(mip.data.shape)}')
    max_err = compare_fused(fused, mip, ops, 'headline')
    compare_fused(fused, *random_operands(5, 64, RES, device), 'random scene')

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
    kernel_ms = graph_ms(lambda: fused.render_coefs_fused(mip, *ops, RES), 50)
    call_ms = cuda_ms(lambda: fused.render_coefs_fused(mip, *ops, RES), 50)
    plain_ms = cuda_ms(lambda: fused.render_coefs_fused_reference(mip, *ops, RES), 5)
    packed_ms = graph_ms(lambda: fused.render_coefs_fused(mip, *ops, RES, True), 50)
    bound_ms, bound_by = fused_bound(mip, ops, RES, FOV)
    print(f'fused_render kernel B={BATCH} res={RES} float out: {kernel_ms:.4f} ms, '
          f'packed out: {packed_ms:.4f} ms (device, graph replay); eager call '
          f'{call_ms:.4f} ms; plain version: {plain_ms:.3f} ms; '
          f'bound {bound_ms * 1e3:.2f} us by {bound_by} [{card}]')
    bench = run_benchmark(scenario, steps_per_chunk=100, n_chunks=3)
    print(f'env step B={BATCH} res={RES} render+metrics: '
          f'{bench["env_steps_per_sec_median"]:.1f} env-steps/s median of '
          f'chunks {[round(r, 1) for r in bench["chunk_rates"]]} [{card}]')
    return {'name': 'fused_render', 'route': 'cuda',
            'source': 'torchdrivesim_tpu_torch/csrc/fused_render.cu',
            'replaces': 'torchdrivesim_tpu/ops/pallas_fused.py:69',
            'launches': launches, 'max_abs_err': max_err, 'ms': kernel_ms,
            'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': None}


# --- the imitation-learning gradient step ------------------------------------

def il_frame_operands(scenario, state):
    """The bilinear warp's and the soft raster's operands for the frame of
    ``state``, built the way ``render_rgb_mesh_chw`` builds them."""
    from torchdrivesim_tpu_torch.ops import soft, warp
    from torchdrivesim_tpu_torch.ops.rasterize import camera_rows_cols
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    sim, res = scenario.sim, scenario.res
    renderer = sim.renderer
    all_state = torch.cat([state.agent_state, state.npc_state], dim=-2)
    present = torch.cat([state.present_mask, state.npc_present_mask], dim=-1)
    mesh = sim.birdview_mesh_generator.generate(
        1, agent_state=all_state[:, None], present_mask=present[:, None],
        include_background=False)
    ego = state.agent_state[:, 0]
    cams = Cameras(ego[:, :2], torch.stack([torch.sin(ego[:, 2]),
                                            torch.cos(ego[:, 2])], -1),
                   2.0 / scenario.fov)
    lh = renderer.cfg.left_handed_coordinates
    mip = renderer._warp_mip(cams.scale, res)
    fcoef, icoef = warp.warp_coefficients(mip, cams.xy, cams.sc, cams.scale,
                                          renderer._background_color,
                                          left_handed=lh, res=res)
    bg = warp.warp_view_bilinear_reference(mip.data, fcoef, icoef, res)
    rc = camera_rows_cols(mesh.verts[..., :2], cams.xy, cams.sc, cams.scale,
                          res, left_handed=lh)
    sv = torch.cat([rc, mesh.verts[..., 2:3]], dim=-1)
    coef, zw, color = soft.soft_coefficients(sv, mesh.faces, mesh.attrs,
                                             renderer.cfg.soft_sigma, 0.5)
    return (mip, fcoef, icoef), (coef, zw[:, None, :].contiguous(), color, bg)


def random_soft_operands(seed: int, b: int, n_faces: int, res: int, device):
    """Random faces (row, col, z at the renderer's priority levels) with
    one covering the whole view and one degenerate, over a random
    background, and a random output cotangent."""
    from torchdrivesim_tpu_torch.ops import soft
    rng = np.random.RandomState(seed)
    verts = np.concatenate([rng.uniform(-8, res + 8, (b, n_faces * 3, 2)),
                            rng.uniform(2, 15, (b, n_faces * 3, 1))], axis=-1)
    verts[:, 0:3, :2] = [[-3 * res, -3 * res], [5 * res, -3 * res], [-3 * res, 5 * res]]
    verts[:, 0:3, 2] = 15.0
    verts[:, -3:] = 0.0
    verts[:, :, 2] = np.repeat(verts[:, ::3, 2], 3, axis=1)
    faces = np.tile(np.arange(n_faces * 3).reshape(1, n_faces, 3), (b, 1, 1))
    attrs = np.repeat(rng.rand(b, n_faces, 1, 3), 3, axis=2).reshape(b, n_faces * 3, 3)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    coef, zw, color = soft.soft_coefficients(t(verts), torch.as_tensor(faces, device=device),
                                             t(attrs), 0.5, 0.5)
    bg = t(rng.rand(b, 3, res, res))
    g = t(rng.uniform(-1, 1, (b, 3, res, res)))
    return (coef, zw[:, None, :].contiguous(), color, bg), g


def judge(got, plain, exact, name, rtol, atol=None):
    """The kernel's error from the exact (float64) value may exceed the
    plain version's by at most atol + rtol * |exact|, atol defaulting to
    1e-6 x max|exact|: two float32 sums in another order agree only as far
    as their conditioning allows. Returns (max |kernel - plain|, values over
    tolerance)."""
    got, plain, exact = got.double(), plain.double(), exact.double()
    if atol is None:
        atol = 1e-6 * float(exact.abs().max())
    tol = atol + rtol * exact.abs()
    over = int(((got - exact).abs() > (plain - exact).abs() + tol).sum())
    diff = float((got - plain).abs().max())
    print(f'  {name}: max |kernel - plain| {diff:.3g}, {over} of {got.numel()} '
          'values over tolerance')
    return diff, over


def compare_warp(warp, mip, fcoef, icoef, res, label):
    got = warp.warp_view_bilinear(mip.data, fcoef, icoef, res)
    want = warp.warp_view_bilinear_reference(mip.data, fcoef, icoef, res)
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    over = int(((got - want).abs() > 1e-6).sum())
    print(f'{label} warp_bilinear: max |kernel - plain| {diff:.3g}, {over} of '
          f'{got.numel()} values over 1e-6')
    return diff, over


def compare_soft(soft, ops, g, label):
    """Forward (1e-5 absolute) and backward (rtol 1e-4) of the soft raster's
    kernels against the plain versions, both judged through float64."""
    coef, zw, color, bg = ops
    print(f'{label} soft raster, {coef.shape[1]} faces, B={coef.shape[0]}, '
          f'res {bg.shape[-1]}:')
    exact_in = [x.double() for x in ops]
    fwd = judge(soft.soft_raster_fwd(*ops), soft.soft_raster_fwd_reference(*ops),
                soft.soft_raster_fwd_reference(*exact_in), 'forward', 0.0, 1e-5)
    got = soft.soft_raster_bwd(*ops, g)
    plain = soft.soft_raster_bwd_reference(*ops, g)
    exact = soft.soft_raster_bwd_reference(*exact_in, g.double())
    torch.cuda.synchronize()
    bwd = [judge(a, b, c, name, 1e-4) for name, a, b, c in
           zip(('gcoef', 'gzw', 'gcolor', 'gbg'), got, plain, exact)]
    return fwd, bwd


def il_policy(features, dtype, device, action_size=2, seed=0):
    from torchdrivesim_tpu_torch.models import BirdviewCNNPolicy
    torch.manual_seed(seed)
    return BirdviewCNNPolicy(action_size, features, dtype=dtype).to(device)


def il_compare_with_cpu(device):
    """The config-4 gradient step at B = 2, horizon 3, float32 policy (and
    cuDNN without TF32), on the card and on the CPU: losses and gradients to
    rtol 1e-3 (atol 1e-6 x max|grad|)."""
    from torchdrivesim_tpu_torch.benchmark import build_il_scenario, make_il_grad_fn
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = {}
        for dev in (device, torch.device('cpu')):
            scn = build_il_scenario(batch_size=2, agent_count=IL_AGENTS,
                                    res=IL_RES, device=dev)
            policy = il_policy(IL_FEATURES, torch.float32, dev)
            loss, grads = make_il_grad_fn(scn, policy, horizon=3)(scn.sim.state)
            runs[dev.type] = (loss.cpu(), [x.cpu() for x in grads])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (lg, gg), (lc, gc) = runs['cuda'], runs['cpu']
    print(f'IL compare B=2 horizon 3: loss card {float(lg)!r}, CPU {float(lc)!r}')
    torch.testing.assert_close(lg, lc, rtol=1e-3, atol=0)
    worst = 0.0
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6 * float(b.abs().max()))
        worst = max(worst, float(((a - b).abs() / b.abs().max()).max()))
    print(f'IL compare: {len(gg)} gradients agree, max difference '
          f'{worst:.3g} of each gradient\'s largest value')


def directional_gradcheck(loss_fn, params, grads, state):
    """The reference's on-device check: the derivative of the loss along
    the gradient direction, by central differences at three step sizes,
    against |g|. Returns (relative errors, |g|)."""
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    saved = [p.detach().clone() for p in params]
    rels = []
    with torch.no_grad():
        for eps in (3e-3, 1e-2, 3e-2):
            scale = eps / max(gnorm, 1e-12)
            losses = []
            for sign in (1.0, -1.0):
                for p, p0, g in zip(params, saved, grads):
                    p.copy_(p0 + sign * scale * g)
                losses.append(float(loss_fn(state)))
            fd = (losses[0] - losses[1]) / (2 * eps)
            rels.append(abs(fd - gnorm) / max(gnorm, 1e-12))
        for p, p0 in zip(params, saved):
            p.copy_(p0)
    return rels, gnorm


def profile_step(fn, label, card):
    """One call of ``fn`` under ``torch.profiler``: device operations, their
    summed device time, its share of the (profiled) wall time, and the
    kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    if not device:
        print(f'{label} profile: no device events traced; busy share not measured')
        return
    totals = {}
    for e in device:
        totals[e.name] = totals.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:6]
    print(f'{label} profile: {len(device)} device operations, {busy_us / 1e3:.3f} ms '
          f'device time in {wall_us / 1e3:.3f} ms wall under the profiler '
          f'(busy {100 * busy_us / wall_us:.1f}%) [{card}]')
    for name, us in top:
        print(f'  {us / 1e3:9.3f} ms  {name[:100]}')


def il_path(device, card):
    """The imitation-learning phases; returns the JSON entries of its
    three kernels."""
    from torchdrivesim_tpu_torch.benchmark import (
        build_il_scenario, make_il_grad_fn, make_il_loss_fn, run_il_benchmark)
    from torchdrivesim_tpu_torch.imitation import (
        build_synthetic_batch, build_synthetic_simulator, make_bc_train_step,
        make_optimizer)
    from torchdrivesim_tpu_torch.ops import soft, warp

    # 1. the kernels against their plain versions
    scenario = build_il_scenario(batch_size=IL_BATCH, agent_count=IL_AGENTS,
                                 res=IL_RES, device=device)
    (mip, fcoef, icoef), sops = il_frame_operands(scenario, scenario.sim.state)
    print(f'IL operands: {sops[0].shape[1]} faces per camera, texture '
          f'{tuple(mip.data.shape)} at {mip.cell_size} m, flip branch on '
          f'{int((icoef[:, 0, 2] == 1).sum())} of {IL_BATCH} cameras')
    g = torch.empty_like(sops[3]).uniform_(-1, 1)
    errs = {'warp': [], 'fwd': [], 'bwd': []}
    over = 0
    for label, ops in (('IL', (mip, fcoef, icoef, IL_RES)),
                       ('random flip', (*random_warp_operands(3, 64, 64, device), 64)),
                       ('random flip res 128', (*random_warp_operands(4, 16, 128, device),
                                                128))):
        d, o = compare_warp(warp, *ops, label)
        errs['warp'].append(d)
        over += o
    for label, (ops, gg) in (('IL', (sops, g)),
                             ('random F=128', random_soft_operands(6, 4, 128, 64, device)),
                             ('random F=45 res 32', random_soft_operands(7, 8, 45, 32, device))):
        (fd, fo), bwd = compare_soft(soft, ops, gg, label)
        errs['fwd'].append(fd)
        errs['bwd'] += [d for d, _ in bwd]
        over += fo + sum(o for _, o in bwd)
    if over:
        raise AssertionError(f'{over} values over tolerance: the kernels disagree '
                             'with their plain versions')

    # 2. a small gradient step on the card against the CPU
    il_compare_with_cpu(device)

    # 3. the main path: one full-width gradient step, counting launches
    policy = il_policy(IL_FEATURES, torch.bfloat16, device)
    params = list(policy.parameters())
    grad_fn = make_il_grad_fn(scenario, policy, horizon=IL_HORIZON)
    state = scenario.sim.state
    warp.LAUNCHES = soft.FWD_LAUNCHES = soft.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    loss, grads = grad_fn(state)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {'warp': warp.LAUNCHES, 'fwd': soft.FWD_LAUNCHES,
                'bwd': soft.BWD_LAUNCHES}
    print(f'IL main path: one gradient step, B={IL_BATCH}, {IL_AGENTS} vehicles, '
          f'res {IL_RES}, horizon {IL_HORIZON}, in {step_s:.2f} s; loss '
          f'{float(loss)!r}; launches warp_bilinear {launches["warp"]}, '
          f'soft_raster_fwd {launches["fwd"]}, soft_raster_bwd {launches["bwd"]}')
    # the first frame is drawn from the given state, which nothing
    # differentiates, so autograd runs no soft-raster backward for it
    want = {'warp': IL_HORIZON, 'fwd': IL_HORIZON, 'bwd': IL_HORIZON - 1}
    if launches != want:
        raise AssertionError(f'launches {launches}, expected {want}')
    if not torch.isfinite(loss) or not all(torch.isfinite(x).all() for x in grads):
        raise AssertionError('non-finite loss or gradient')
    if not all(float(x.abs().max()) > 0 for x in grads):
        raise AssertionError('a parameter gradient is zero')
    rels, gnorm = directional_gradcheck(
        make_il_loss_fn(scenario, policy, IL_HORIZON), params, grads, state)
    median_rel = statistics.median(rels)
    print(f'IL directional gradcheck: |g| {gnorm:.6g}, relative errors '
          f'{[round(r, 5) for r in rels]} at eps 3e-3 / 1e-2 / 3e-2, median '
          f'{median_rel:.5f}')
    if not median_rel < 0.05:
        raise AssertionError(f'directional gradcheck median {median_rel}')

    # 4. the behaviour-cloning loop at the example's defaults
    road, states0, expert = build_synthetic_batch(8, 10, device=device)
    bc_sim = build_synthetic_simulator(road, states0, res=64)
    bc_policy = il_policy(IL_FEATURES, torch.bfloat16, device, action_size=4)
    train_step = make_bc_train_step(bc_sim, bc_policy, make_optimizer(bc_policy), 64)
    bc_losses = [float(train_step(bc_sim.state, expert)) for _ in range(3)]
    print(f'BC loop B=8 horizon 10 res 64: losses {bc_losses}')
    if not np.all(np.isfinite(bc_losses)):
        raise AssertionError('BC losses are not finite')

    # 5. times, on this card, at the IL operands
    coef, zw, color, bg = sops
    b, n_faces = coef.shape[0], coef.shape[1]
    face_pixels = b * n_faces * IL_RES * IL_RES
    pixels = b * IL_RES * IL_RES
    entries = []
    for name, fn, plain, reps, plain_reps, n_bytes, n_ops, n_sfu, source, replaces, \
            err, n in (
            ('warp_bilinear',
             lambda: warp.warp_view_bilinear(mip.data, fcoef, icoef, IL_RES),
             lambda: warp.warp_view_bilinear_reference(mip.data, fcoef, icoef, IL_RES),
             200, 10, nbytes(fcoef, icoef) + texel_bytes(mip, b, scenario.fov)
             + pixels * 3 * 4, pixels * WARP_OPS, 0,
             'torchdrivesim_tpu_torch/csrc/warp_bilinear.cu',
             'torchdrivesim_tpu/ops/pallas_warp.py:306', max(errs['warp']),
             launches['warp']),
            ('soft_raster_fwd',
             lambda: soft.soft_raster_fwd(*sops),
             lambda: soft.soft_raster_fwd_reference(*sops),
             200, 5, nbytes(*sops) + nbytes(bg), face_pixels * SOFT_FWD_OPS,
             face_pixels * SOFT_FWD_SFU,
             'torchdrivesim_tpu_torch/csrc/soft_raster.cu',
             'torchdrivesim_tpu/ops/pallas_soft.py:177', max(errs['fwd']),
             launches['fwd']),
            ('soft_raster_bwd',
             lambda: soft.soft_raster_bwd(*sops, g),
             lambda: soft.soft_raster_bwd_reference(*sops, g),
             100, 2, nbytes(*sops, g) + nbytes(coef, zw, color, bg),
             face_pixels * SOFT_BWD_OPS, face_pixels * SOFT_BWD_SFU,
             'torchdrivesim_tpu_torch/csrc/soft_raster.cu',
             'torchdrivesim_tpu/ops/pallas_soft.py:199', max(errs['bwd']),
             launches['bwd'])):
        ms, call_ms = graph_ms(fn, reps), cuda_ms(fn, reps)
        plain_ms = cuda_ms(plain, plain_reps)
        bound_ms, bound_by = bound(n_bytes, n_ops, n_sfu)
        print(f'{name} kernel B={b} res={IL_RES} F={n_faces}: {ms:.4f} ms (device, '
              f'graph replay); eager call {call_ms:.4f} ms; plain version '
              f'{plain_ms:.3f} ms; bound {bound_ms * 1e3:.3f} us by {bound_by} '
              f'({n_bytes / 1e6:.3f} MB, {n_ops / 1e6:.1f} M float32 ALU and '
              f'{n_sfu / 1e6:.1f} M SFU operations) '
              f'[{card}]')
        entries.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': n, 'max_abs_err': err,
                        'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                        'bound_by': bound_by, 'library_ms': None})
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    grad_fn(state)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    print(f'IL gradient step peak memory above the resident scenario: '
          f'{peak / 2**20:.1f} MiB [{card}]')
    profile_step(lambda: grad_fn(state), 'IL gradient step', card)
    bench = run_il_benchmark(scenario, policy, horizon=IL_HORIZON,
                             rollouts_per_chunk=2, n_chunks=3)
    print(f'IL gradient step B={IL_BATCH} horizon {IL_HORIZON}: '
          f'{bench["grad_rollouts_per_sec_median"]:.3f} grad-rollouts/s, '
          f'{bench["env_steps_per_sec_median"]:.1f} env-steps/s median of chunks '
          f'{[round(r, 3) for r in bench["chunk_rollout_rates"]]} rollouts/s [{card}]')
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from torchdrivesim_tpu_torch.ops import fused, soft, warp
    from torchdrivesim_tpu_torch.ops.build import build_all

    device = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    card = card_label()
    print(f'device: {name}')
    print(card)                  # name, power.limit as nvidia-smi gives them
    secs = build_all([fused.LIBRARY, warp.LIBRARY, soft.LIBRARY])
    print(f'kernel build (fused_render, warp_bilinear, soft_raster in parallel): '
          f'{secs:.2f} s (nvcc sm_90a)')

    kernels = [headline(device, card)]
    kernels += il_path(device, card)

    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
