"""
Smoke run of the PyTorch port on one CUDA card. Builds every kernel from the
checkout (one ``nvcc`` per source, all at once), then drives twenty-one paths:

* the headline env step (carla_Town02, 256 environments, 20 vehicles,
  128 x 128 render plus all metrics): the fused render kernel against its
  plain PyTorch version (also on scenes that stress its per-tile
  primitive cull), the first steps against the CPU path, 200 steps
  counting launches, times, the cull's listed pairs per tile and the
  kernel's registers and blocks per SM;
* the imitation-learning gradient step (the same town, 16 environments,
  8 vehicles, 64 x 64 differentiable render, a 40-step rollout through the
  bilinear background warp and the soft raster, a CNN policy): the four
  kernels against their plain versions (the warp from the camera poses and
  its pose VJP also left-handed and at the texture's corner and edge, the
  soft raster also on operands that stress its per-tile face cull), a
  small gradient step against the CPU path, one full-width gradient step
  counting launches with a directional finite-difference check of its
  gradient, three steps of the behaviour-cloning loop, times, the warp's
  and the soft raster's floors, device operations and peak memory;
* the imitation-learning gradient step over the untextured map (config 4's
  widths without the texture: every frame draws the Town02 road mesh,
  ~17,000 faces per camera, through the grouped soft raster): its two
  kernels against their plain versions, and their per-tile face lists
  against the plain cull, on random, boundary and road-like operands and
  on the frame of the state the full-width rollout returns, a small
  gradient step against the CPU path, one full-width gradient rollout
  counting launches and peak memory, a directional finite-difference
  check at small size, times, bounds and grad-rollouts/s;
* the RL path (BASELINE config 5: PPO over 1024 vectorized environments of
  the same town, 4 vehicles, 64 x 64 hard mesh render, rollout 16, 2
  epochs): the nearest background warp and the hard raster's packed and
  chunked kernels against their plain versions on random operands, a
  small RL step against the CPU path, two full-width PPO iterations
  counting launches per rollout collection, the kernels again on the
  frame those iterations ended on, the hard raster's two kernels on scenes
  that stress their per-tile face cull (z ties across chunks, ragged
  tiles, faces touching a tile at a corner, hand-made edges), three steps
  of the untextured environment (the whole map mesh, the chunked kernel)
  and the chunked kernel on its last frame, one untextured rollout
  collection at B = 16 counting the chunked kernel's launches (which the
  JSON line reports), times, listed faces per tile, device profiles and
  peak memory;
* the primitive raster (the headline scenario without its texture, and
  its wide view): the banded and unbanded kernels against their plain
  versions on random scenes, on scenes that stress the per-tile primitive
  cull (boundary, parallelogram, near-degenerate and larger-than-view
  prims, and hand-made flat, non-finite and subnormal edges) and on the
  headline's frame, a small run of
  both renders against the CPU path, 100 untextured steps at B = 256,
  res 128 counting launches, ``Simulator.render`` of a 400 m view at
  res 64 (the full-resolution background), the unbanded kernel at full
  width, times and bounds;
* BASELINE config 3 (carla_Town10HD, 64 environments, 20 agents, each
  stepped by its own kinematic model: bicycle, simple or no-reversing
  bicycle, through the compound model's per-agent dispatch; 128 x 128
  render plus all metrics): the fused render kernel against its plain
  version on the Town10HD frames (first and last), the first steps
  against the CPU path with seeded 4-wide actions, 200 steps with zero
  actions counting launches, one compound kinematic step captured in a
  CUDA graph against the eager step, times, device operations and
  env-steps/s;
* the res-256 headline (carla_Town02, 256 environments, 256 x 256
  render): every view as 2 x 2 sub-camera views of 128 pixels, all 1,024
  in one fused launch; the kernel against its plain version on those
  operands (first and last frame), the first steps against the CPU path,
  200 steps counting launches, times, bound and env-steps/s;
* the stateful ``Simulator`` facade (Town02, 64 environments, 20 agents,
  FSM lights, texture, waypoint goals): 100 iterations of
  ``render_egocentric`` (one 128 x 128 camera per agent, 1,280 per frame),
  ``step`` and the grid offroad, grid wrong-way, red-light and
  disc-collision metrics counting launches; the fused render kernel
  against its plain version on the first and the last frame and on a
  frame with five waypoint discs per camera (70 triangles, past the
  per-type cap of 56: the sort route), the sort route bit-equal to the
  prep route under the cap; the first iterations and the fallback frame
  against the CPU; the IoU and exact-count collisions and the exact
  offroad on the last state against the CPU; the port's
  ``examples/simulate.py`` for 20 steps; times, bound, device operations
  and iterations/s.
* the facade with noisy perception (BASELINE config 3's world: Town10HD,
  64 environments, 20 agents, 30 FSM lights, 2 stop signs and 1 yield
  sign, texture; standard-sensing observation noise from a seeded
  generator on the card, lane features from the map's centerlines): 20
  iterations of ``render_egocentric(noisy_perception=True,
  custom_agent_colors=...)`` (1,280 cameras through the nearest warp
  under the packed hard raster), ``step``, the four metrics and the
  noisy getters, then one untextured frame of 4 cameras on the signs
  (the chunked hard raster over the whole map mesh and the lane markers),
  counting launches; the three kernels against their plain versions on
  the first and the last frame, the signs drawn, the first iterations
  against the CPU, times, bounds, device operations and iterations/s.
* NPC replay (``examples/replay.py`` on INTERACTION-layout data written
  at run time from the bundled Town02 map: case 1, the first agent a
  teleporting ego, 19 replayed NPCs, 39 frames of ``render_egocentric`` at
  256 x 256, fov 100 m, over the untextured Town02 mesh, ~17,000 faces):
  the hard raster's chunked kernel against its plain version on the first
  and the last frame, 3 frames against the CPU, the example counting
  launches, a replayed step captured in a CUDA graph against the eager
  one, times, bound and frames/s;
* imitation learning on INTERACTION cases (the example's dataset branch:
  16 segments of the written data, the ego a simple-model agent, 19
  replayed NPCs drawn in every frame, horizon 39, 64 x 64 over the road
  mesh triangulated from Town02's .osm, ~3,400 faces): the grouped soft
  raster's two kernels against their plain versions and their tile lists
  against the plain cull on the first and the last frame, a small
  gradient step against the CPU, the example's training steps counting
  launches, times, bounds and grad-rollouts/s;
* the single-ego ``GymEnv`` (Town02, 6 agents, textured, 64 x 64 through
  ``SingleAgentWrapper``): the fused render kernel against its plain
  version on the first and the last frame, 3 steps against the CPU, an
  episode of 100 steps counting launches, times, bound and env steps/s;
* the face-soup render (the headline world, 256 environments, two waypoint
  discs per camera: ``generate_faces`` -> ``render_faces_chw`` at 128 x
  128): the nearest warp and the packed hard raster against their plain
  versions on the first and the last frame, the first frames against the
  CPU, 100 steps counting launches, one untextured frame (one packed
  hard raster launch) and one of a differentiable renderer (one
  float-color hard raster launch, HF), each held to its plain version,
  times, bounds and frames/s;
* the reference's renderer configurations (the facade world at 64
  environments built from ``CV2RendererConfig()``, ``{'backend': 'jax'}``,
  ``DummyRendererConfig()`` and ``Pytorch3DRendererConfig()`` through
  ``renderer_from_config``): the same frames and launches as the default
  configuration, black frames without a launch, a differentiable
  egocentric frame (one HF launch), a differentiable mesh frame with its
  gradient to the agent states, its bilinear warp, the warp's VJP and the
  soft raster's two kernels held to their plain versions;
* the full-resolution bilinear backgrounds (config 4's world): a gradient
  rollout with ``diff_fast_background=False`` (the quad background under
  the soft raster's two kernels) counting launches, its kernels against
  their plain versions and its gradient against the CPU; a 256 x 256
  textured differentiable frame (the grouped kernels), against their plain
  versions and the CPU; a frame over an explicit ``background_texture``,
  its soft raster kernels against their plain versions;
* the painter's blend on config 4's frame, card against CPU, forward and
  backward, ms per frame;
* teacher-forced behaviour cloning on config 4's world, horizon 40,
  counting launches, against the CPU, grad-rollouts/s;
* the examples ``initialize_simulation`` (512 x 512, the whole Town02 mesh:
  the chunked hard raster, held to its plain version on the frame's
  operands) and ``lanelet2_to_birdview_mesh`` (Town02's .osm);
* the float-color hard raster HF (the reference's plain
  ``rasterize_hard_faces``, which its differentiable primitive render,
  differentiable face soup and texture baker run) against its plain
  version bit for bit on random, pixel-centred, sliver and tile-grazing
  faces and its gradients, and on the differentiable primitive frames of
  ``Pytorch3DRendererConfig()`` (the facade world, 1,280 cameras at 64
  and 128 px, one HF launch each);
* the map bakers, into copies of the maps' files: Town02's and
  Town10HD's textures at 4 px/m (one HF launch per 512-row strip) and
  Town02's distance and direction grids at 0.4 m (the native direction
  baker), each against the cache bundled with the map;
* the examples ``show_map`` and ``check_map_alignment`` on Town02.

    python3 chip_smoke.py
    python3 chip_smoke.py grouped-check-timing   # the grouped plain check's
                                                 # seconds, face by face and listed

Exits non-zero without printing a result when no CUDA card is present or
any phase fails. The line before the last is a JSON object describing each
kernel; the last line is ``{"ok": true, "device": ...}``.
"""
import contextlib
import dataclasses
import json
import math
import os
import re
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
RL_BATCH, RL_RES, RL_ROLLOUT, RL_EPOCHS, RL_ITERATIONS = 1024, 64, 16, 2, 2
RL_UNTEXTURED_BATCH, RL_UNTEXTURED_STEPS = 16, 3
UNTEXTURED_STEPS, WIDE_RES, WIDE_FOV = 100, 64, 400.0
C3_BATCH = 64
TILED_BATCH, TILED_RES = 256, 256
FACADE_BATCH, FACADE_ITERATIONS, FACADE_WAYPOINTS, FACADE_FALLBACK_COUNT = 64, 100, 6, 5
FACADE_EXAMPLE_STEPS = 20

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
#: per (pixel, face) of the grouped backward (csrc/soft_accum.cu): pass 1 and
#: the prefix pass each evaluate the face terms and the group's product
#: (~29), the descending pass is the single-group backward's second pass
SOFT_ACCUM_BWD_OPS, SOFT_ACCUM_BWD_SFU = 2 * 29 + 25 + 50, 18
#: per pixel of the bilinear warp: 3 positions (4 each), 2 pass-1 taps of
#: 4 + 6 and 3 lerps (3 each), the final 3 lerps and the validity test (4)
WARP_OPS = 12 + 2 * (10 + 9) + 9 + 4
#: per camera of the bilinear warp's coefficients (csrc/warp_coef.cuh): the
#: affine terms (16), the window origins (12), the branch and its selects
#: (12), the pass-1 coefficients (9, divisions counted once each), the
#: packed background (15), about 70
WARP_COEF_OPS = 70
#: per pixel of its pose VJP: per channel two central differences (4), the
#: two texel-space derivatives (8) and their products and sums with g (4);
#: the texture coordinates (8), the validity test (4) and its products (2);
#: six float64 sums and four products (10)
WARP_VJP_OPS = 3 * (4 + 8 + 4) + 8 + 4 + 2 + 10
#: per (pixel, primitive) of the primitive winner (csrc/prim_winner.cuh): a
#: quad's two affine values (4 each), their two bounds tests and the
#: minimum; a triangle's three edge values, three tests and the minimum
PRIM_QUAD_OPS, PRIM_TRI_OPS = 11, 15
#: per pixel of the prim raster (csrc/prim_raster.cu) beside its prims:
#: the covered test, three channel unpacks (shift, mask) and products
PRIM_PIXEL_OPS = 1 + 3 * 3
#: per pixel of the nearest warp (csrc/warp_index.cuh, warp_nearest.cu): the
#: row and column indices (affine 4, round 2, clamp 2 each), the texture
#: coordinates (2 x 4), the validity test (4) and the unpack (3)
NEAREST_PIXEL_OPS = 8 + 8 + 8 + 4 + 3
#: per pixel of the fused render beside its prims: the nearest warp's and
#: the prim raster's composite
FUSED_PIXEL_OPS = NEAREST_PIXEL_OPS + PRIM_PIXEL_OPS
#: per (pixel, face) of the hard raster (csrc/hard_raster.cu): three edge
#: values (4 each), three compares and the minimum (packed) or the z
#: compares (chunked)
HARD_FACE_OPS, HARD_CHUNKED_FACE_OPS = 12 + 3 + 1, 12 + 3 + 2
#: pixels per side of the tiles in which the bounds of the hard and
#: primitive rasters count the faces a pixel must test
BOUND_TILE = 16


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


def graph_replay(fn):
    """``fn``'s output from one CUDA graph capture of it, replayed once:
    the capture fails if ``fn`` waits on the device (a host sync)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


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
    (fov / cell + 1)^2 texels of the mip level, and all the views together
    at most the whole level, read once."""
    return min(b * (fov / mip.cell_size + 1) ** 2 * 4, nbytes(mip.data))


# --- the headline step -------------------------------------------------------

def fused_frame(scenario, state):
    """The fused render's operands for the frame of ``state`` from
    ``Renderer.fused_frame_operands``, the code the step runs: (mip,
    operands, pixels of each (sub-)view, tiles per side, the views'
    screen-space quads and triangles, (quads, triangles) per camera)."""
    (quads, qz, qc, tris, tz, tc), cams = prim_frame(scenario, state, scenario.fov)
    mip, ops, res, n, screen = scenario.sim.renderer.fused_frame_operands(
        quads, qz, qc, tris, tz, tc, scenario.res, cams)
    return mip, ops, res, n, screen, (qz.shape[1], tz.shape[1])


def prim_frame(scenario, state, fov):
    """The frame of ``state`` from the egos' cameras, as the step builds
    it: (world-space prims of ``generate_prims``, cameras at ``fov``)."""
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    all_state = torch.cat([state.agent_state, state.npc_state], dim=-2)
    present = torch.cat([state.present_mask, state.npc_present_mask], dim=-1)
    ego = state.agent_state[:, 0]
    cams = Cameras(ego[:, :2], torch.stack([torch.sin(ego[:, 2]),
                                            torch.cos(ego[:, 2])], -1), 2.0 / fov)
    prims = scenario.sim.birdview_mesh_generator.generate_prims(
        all_state, present_mask=present,
        traffic_light_state=state.traffic_control_state['traffic_light'])
    return prims, cams


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


def random_poses(seed: int, b: int, device, cam_xy=None):
    """A random texture's mip level and the poses (xy, sc) of ``b`` cameras,
    half of them on the transposed-window branch; ``cam_xy`` (b, 2) places
    the cameras instead."""
    from torchdrivesim_tpu_torch.ops.warp import build_mip_pyramid, select_mip
    rng = np.random.RandomState(seed)
    tex = rng.rand(300, 300, 3).astype(np.float32)
    mip = select_mip(build_mip_pyramid(tex, np.zeros(2), 0.5), fov=40.0).to(device)
    ang = rng.rand(b) * 2 * np.pi
    ang[::2] = np.deg2rad(rng.uniform(-5, 5, ang[::2].shape)
                          + 180 * (rng.rand(ang[::2].size) > 0.5))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    xy = rng.rand(b, 2) * 120 + 10
    return mip, t(xy if cam_xy is None else cam_xy), t(np.stack([np.sin(ang), np.cos(ang)], -1))


def random_warp_operands(seed: int, b: int, res: int, device):
    """A random texture's mip level and warp coefficients of ``b`` cameras,
    half of them on the transposed-window branch."""
    from torchdrivesim_tpu_torch.ops.warp import warp_coefficients
    mip, xy, sc = random_poses(seed, b, device)
    fcoef, icoef = warp_coefficients(mip, xy, sc, 2.0 / 40.0,
                                     torch.tensor([0.1, 0.2, 0.3], device=device), res=res)
    assert int((icoef[:, 0, 2] == 1).sum()) > 0, 'no camera on the flip branch'
    return mip, fcoef, icoef


def edge_warp_case(device, res=64):
    """The bilinear warp's arguments for four cameras of
    :func:`random_poses`' texture (cell 0.5 m, 300 x 300 texels) at fov
    40 m, res 64, heading exactly 0 or 90 degrees and placed so that row or
    column 31 of the view lies exactly on the texture's first or last texel
    row and column (ty or tx exactly 0 or 300): the validity test decides
    on the bound itself."""
    mip, _, _ = random_poses(0, 4, device)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    xy = t([[-0.3125, -0.3125], [149.6875, 149.6875], [0.3125, -0.3125],
            [150.3125, 149.6875]])
    sc = t([[0.0, 1.0], [0.0, 1.0], [1.0, 0.0], [1.0, 0.0]])
    wargs = (mip, xy, sc, 2.0 / 40.0, t([0.1, 0.2, 0.3]), False)
    from torchdrivesim_tpu_torch.ops.warp import sample_positions
    ty, tx = sample_positions(mip, xy, sc, 2.0 / 40.0, res=res)
    for v, hi in ((ty, mip.valid_shape[0]), (tx, mip.valid_shape[1])):
        assert bool((v == 0).any()) and bool((v == hi).any()), 'no pixel on the bound'
    return wargs


def bilinear_warp_case(seed: int, b: int, device, left_handed=False, cam_xy=None):
    """The bilinear warp's arguments (mip, cam_xy, cam_sc, scale, background
    colour, left_handed) for :func:`random_poses`' cameras at fov 40 m."""
    mip, xy, sc = random_poses(seed, b, device, cam_xy)
    return (mip, xy, sc, 2.0 / 40.0, torch.tensor([0.1, 0.2, 0.3], device=device),
            left_handed)


def compare_fused(fused, mip, ops, label, res=RES):
    """Kernel against plain version in both output modes; returns the
    largest absolute difference of the float output."""
    errs = [compare_exact(fused.render_coefs_fused(mip, *ops, res, packed),
                          fused.render_coefs_fused_reference(mip, *ops, res, packed),
                          f'{label} packed={packed}') for packed in (False, True)]
    return errs[0]


def cull_fused_operands(kind, seed: int, b: int, res: int, device):
    """The fused render's operands of :func:`prim_cull_scene`'s scene over
    :func:`random_warp_operands`' texture and cameras."""
    from torchdrivesim_tpu_torch.ops.rasterize import (
        n_bands_for, prep_sorted_prim_coefs)
    mip, fcoef, icoef = random_warp_operands(seed, b, res, device)
    scene = prim_cull_scene(kind, seed, b, res, device)
    qcoef, qpk, qmask, tcoef, tpk, tmask = prep_sorted_prim_coefs(
        *scene[:6], res, 56, n_bands_for(res))
    return mip, (fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask)


def listed_pairs(ops, qmask, tmask, res):
    """(listed quads, listed triangles) per 16 x 16 tile: the (tile,
    primitive) pairs the winner's cull keeps (``prim_tile_keep_reference``)
    on the prepared ``ops`` (qcoef, qpk, tcoef, tpk)."""
    from torchdrivesim_tpu_torch.ops import prims as P
    keep = P.prim_tile_keep_reference(*ops, qmask, tmask, res)
    qp = ops[1].shape[1]
    n_tiles = keep.shape[0] * keep.shape[1]
    return (float(keep[..., :qp].sum()) / n_tiles, float(keep[..., qp:].sum()) / n_tiles)


def occupancy_line(name, occupancy, qp, tp, n_blocks):
    """The kernel's registers, resident blocks per SM and waves of its grid
    of ``n_blocks`` blocks on this card."""
    regs, per_sm, spill = occupancy(qp, tp)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f'{name}: {regs} registers per thread, {spill} spill bytes, {per_sm} blocks '
            f'per SM, {n_blocks} blocks = {n_blocks / (per_sm * sms):.2f} waves on {sms} SMs')


def compare_exact(got, want, label):
    """Kernel against plain version: the count of mismatching values (must
    be 0); returns the largest absolute difference."""
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    print(f'{label}: {mismatches} mismatching values of {got.numel()}')
    if mismatches:
        raise AssertionError(f'{label}: kernel disagrees with its plain version')
    return float((got - want).abs().max())


def compare_with_cpu(build, label, seeded=False, rtol=0.0):
    """The first steps of the B = 4 scenario on the card against the CPU
    path: states and metrics to 1e-4 (metrics plus ``rtol`` relative),
    images >= 99.9% identical pixels. The actions are as wide as the
    kinematic model's, zero or, with ``seeded``, uniform in [-1, 1] from
    a seeded generator."""
    runs = {}
    for dev in ('cuda', 'cpu'):
        scn = build(batch_size=COMPARE_BATCH, device=dev)
        step = scn.make_step_fn(render=True, metrics=True)
        state = scn.sim.state
        shape = (COMPARE_BATCH, scn.sim.agent_count, scn.sim.action_size)
        rng = np.random.RandomState(0)
        outs = []
        for _ in range(COMPARE_STEPS):
            action = torch.as_tensor(rng.uniform(-1, 1, shape) if seeded else np.zeros(shape),
                                     dtype=torch.float32, device=dev)
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
                                           atol=1e-4, rtol=rtol)


def fused_bound(mip, ops, screen, res, fov):
    """Bound of the fused render: the image written, the operands and the
    texels the views need read; per pixel the warp and the composite, and
    each quad's or triangle's test only in the tiles its bounding box
    overlaps (:func:`tile_pairs` of the ``screen`` quads and triangles), as
    :func:`prim_bound` counts B7's."""
    fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask = ops
    b = qmask.shape[0]
    q_pairs, t_pairs = (tile_pairs(c, prim_valid(c), res) for c in screen)
    ops_n = b * res * res * FUSED_PIXEL_OPS \
        + BOUND_TILE ** 2 * (PRIM_QUAD_OPS * q_pairs + PRIM_TRI_OPS * t_pairs)
    out_bytes = b * 3 * res * res * 4
    in_bytes = nbytes(fcoef, icoef, qcoef, qpk, tcoef, tpk, qmask, tmask) \
        + texel_bytes(mip, b, fov)
    return bound(out_bytes + in_bytes, ops_n)


def headline(device, card):
    """The headline phases; returns the fused kernel's JSON entry, the
    scenario and the state its main path ended on."""
    from torchdrivesim_tpu_torch.benchmark import (
        build_benchmark_scenario, run_benchmark)
    from torchdrivesim_tpu_torch.ops import fused

    # 1. kernel against plain version at the headline operands
    scenario = build_benchmark_scenario(batch_size=BATCH, agent_count=AGENTS,
                                        res=RES, fov=FOV, device=device)
    mip, ops, _, _, _, _ = fused_frame(scenario, scenario.sim.state)
    print(f'headline operands: qcoef {tuple(ops[2].shape)}, tcoef '
          f'{tuple(ops[4].shape)}, qmask {tuple(ops[6].shape)}, '
          f'tmask {tuple(ops[7].shape)}, texture {tuple(mip.data.shape)}')
    max_err = compare_fused(fused, mip, ops, 'headline')
    compare_fused(fused, *random_operands(5, 64, RES, device), 'random scene')
    for i, kind in enumerate(PRIM_CULL_KINDS):
        for res in (RES, 80):
            compare_fused(fused, *cull_fused_operands(kind, 40 + i, 16, res, device),
                          f'{kind} scene res {res}', res)

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
    mip, ops, _, _, screen, _ = fused_frame(scenario, state)
    kernel_ms = graph_ms(lambda: fused.render_coefs_fused(mip, *ops, RES), 50)
    call_ms = cuda_ms(lambda: fused.render_coefs_fused(mip, *ops, RES), 50)
    plain_ms = cuda_ms(lambda: fused.render_coefs_fused_reference(mip, *ops, RES), 5)
    packed_ms = graph_ms(lambda: fused.render_coefs_fused(mip, *ops, RES, True), 50)
    # no primitive tested: what the warp, the composite and the write cost
    floor_ms = graph_ms(lambda: fused.render_coefs_fused(
        mip, *ops[:6], torch.zeros_like(ops[6]), torch.zeros_like(ops[7]), RES), 50)
    bound_ms, bound_by = fused_bound(mip, ops, screen, RES, FOV)
    n_tiles = BATCH * (RES // BOUND_TILE) ** 2
    box_q, box_t = (tile_pairs(c, prim_valid(c), RES) / n_tiles for c in screen)
    listed_q, listed_t = listed_pairs(ops[2:6], ops[6], ops[7], RES)
    print(f'fused_render, plain cull (prim_tile_keep_reference) on the last frame: '
          f'{listed_q:.3f} quads and '
          f'{listed_t:.3f} triangles listed per {BOUND_TILE} x {BOUND_TILE} tile of '
          f'{ops[3].shape[1]} + {ops[5].shape[1]} slots; {box_q:.3f} and {box_t:.3f} '
          'overlap it by bounding box (tile_pairs)')
    print(occupancy_line('fused_render', fused.occupancy, ops[3].shape[1],
                         ops[5].shape[1], BATCH * (RES // BOUND_TILE) ** 2 // 8))
    print(f'fused_render kernel B={BATCH} res={RES} float out: {kernel_ms:.4f} ms, '
          f'packed out: {packed_ms:.4f} ms (device, graph replay); eager call '
          f'{call_ms:.4f} ms; plain version: {plain_ms:.3f} ms; '
          f'bound {bound_ms * 1e3:.2f} us by {bound_by}; float out with both masks '
          f'zeroed {floor_ms:.4f} ms [{card}]')
    print(f'headline: {device_ops(lambda: step(state, action))} device ops per env '
          f'step [{card}]')
    bench = run_benchmark(scenario, steps_per_chunk=100, n_chunks=3)
    print(f'env step B={BATCH} res={RES} render+metrics: '
          f'{bench["env_steps_per_sec_median"]:.1f} env-steps/s median of '
          f'chunks {[round(r, 1) for r in bench["chunk_rates"]]} [{card}]')
    entry = {'name': 'fused_render', 'route': 'cuda',
             'source': 'torchdrivesim_tpu_torch/csrc/fused_render.cu',
             'replaces': 'torchdrivesim_tpu/ops/pallas_fused.py:69',
             'launches': launches, 'max_abs_err': max_err, 'ms': kernel_ms,
             'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
             'library_ms': None}
    return entry, scenario, state


# --- the imitation-learning gradient step ------------------------------------

def il_frame_operands(scenario, state):
    """The bilinear warp's arguments (mip, cam_xy, cam_sc, scale, background
    colour, left_handed) and the soft raster's operands for the frame of
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
    wargs = (mip, cams.xy, cams.sc, cams.scale, renderer._background_color, lh)
    bg = warp.warp_background_bilinear_reference(*wargs, res)
    rc = camera_rows_cols(mesh.verts[..., :2], cams.xy, cams.sc, cams.scale,
                          res, left_handed=lh)
    sv = torch.cat([rc, mesh.verts[..., 2:3]], dim=-1)
    coef, zw, color = soft.soft_coefficients(sv, mesh.faces, mesh.attrs,
                                             renderer.cfg.soft_sigma, 0.5)
    return wargs, (coef, zw[:, None, :].contiguous(), color, bg)


def random_soft_operands(seed: int, b: int, n_faces: int, res: int, device):
    """Random faces (row, col, z at the renderer's priority levels) with
    one covering the whole view and one degenerate, over a random
    background, and a random output cotangent."""
    rng = np.random.RandomState(seed)
    verts = np.concatenate([rng.uniform(-8, res + 8, (b, n_faces * 3, 2)),
                            rng.uniform(2, 15, (b, n_faces * 3, 1))], axis=-1)
    verts[:, 0:3, :2] = [[-3 * res, -3 * res], [5 * res, -3 * res], [-3 * res, 5 * res]]
    verts[:, 0:3, 2] = 15.0
    verts[:, -3:] = 0.0
    verts[:, :, 2] = np.repeat(verts[:, ::3, 2], 3, axis=1)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    ops = face_operands(verts, rng, device)
    return (*ops, t(rng.rand(b, 3, res, res))), t(rng.uniform(-1, 1, (b, 3, res, res)))


def soft_case_operands(kind: str, seed: int, b: int, n_faces: int, res: int, device):
    """The single-group soft raster's operands ((coef, zw, color, bg), g)
    of one kind, F <= 128: ``random`` (:func:`random_soft_operands`: a face
    covering the view, a degenerate one), ``boundary``
    (:func:`accum_boundary_operands` with its slack faces: ``n_faces``
    random faces beside three per 16 x 16 tile whose one edge peaks at
    nextafter(-4, 0), -4 or -4.001 at a tile corner, and one per inner tile
    that only the cull's slack keeps; :func:`boundary_extra` counts them) or
    ``road`` (:func:`accum_road_operands`, most faces off-view); the last
    two padded to 128 faces with the padding face (alpha exactly 0) where
    they fall short. A random output cotangent g."""
    if kind == 'random':
        return random_soft_operands(seed, b, n_faces, res, device)
    if kind == 'boundary':
        (coef, zw, color), bg = accum_boundary_operands(seed, b, n_faces, res, device,
                                                        slack_faces=True)
    else:
        (coef, zw, color), bg = accum_road_operands(seed, b, n_faces, res, device)
    if coef.shape[1] > 128:
        raise ValueError(f'{kind}: {coef.shape[1]} faces, more than one group')
    rng = np.random.RandomState(seed + 2)
    g = torch.as_tensor(rng.uniform(-1, 1, tuple(bg.shape)).astype(np.float32),
                        device=device)
    return (coef, zw, color, bg), g


def face_operands(verts, rng, device):
    """The soft raster's (coef, zw (B, 1, F), color) of the triangles
    ``verts`` (B, 3F, 3): (row, col, z), z constant per face, a random color
    each."""
    from torchdrivesim_tpu_torch.ops import soft
    b, n_faces = verts.shape[0], verts.shape[1] // 3
    faces = np.tile(np.arange(n_faces * 3).reshape(1, n_faces, 3), (b, 1, 1))
    attrs = np.repeat(rng.rand(b, n_faces, 1, 3), 3, axis=2).reshape(b, n_faces * 3, 3)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    coef, zw, color = soft.soft_coefficients(t(verts), torch.as_tensor(faces, device=device),
                                             t(attrs), 0.5, 0.5)
    return coef, zw[:, None, :].contiguous(), color


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


def compare_warp(warp, wargs, res, label):
    """B3 from the poses against its plain version (``warp_coefficients``
    and ``warp_view_bilinear_reference``): returns (max difference, values
    off in any bit)."""
    got = warp.warp_background_bilinear(*wargs, res)
    want = warp.warp_background_bilinear_reference(*wargs, res)
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    bits = int((got != want).sum())
    print(f'{label} warp_bilinear B={wargs[1].shape[0]} res {res}: max |kernel - plain| '
          f'{diff:.3g}, {bits} of {got.numel()} values off in any bit')
    return diff, bits


def autograd_warp_vjp(warp, mip, out, g, cam_xy, cam_sc, scale, left_handed, res):
    """The bilinear warp's pose VJP as the port's backward computed it
    before its kernel (and as the reference's ``warp_background_diff``
    spells it): the central differences through the inverse Jacobian, then
    autograd through ``sample_positions``. The second oracle of the VJP
    kernel and of its plain closed form."""
    lh = -1.0 if left_handed else 1.0
    m = 1.0 / (scale * (res / 2.0) * float(mip.cell_size))
    h_tex, w_tex = float(mip.valid_shape[0]), float(mip.valid_shape[1])
    d_dr = warp._central_differences(out, 2)
    d_dc = warp._central_differences(out, 3)
    sin = cam_sc[:, 0, None, None, None]
    cos = cam_sc[:, 1, None, None, None]
    a_y, b_y = -sin * m, -lh * cos * m
    a_x, b_x = -cos * m, lh * sin * m
    det = a_y * b_x - a_x * b_y
    d_dty = (d_dr * b_x - d_dc * a_x) / det
    d_dtx = (d_dc * a_y - d_dr * b_y) / det
    with torch.enable_grad():
        cxy = cam_xy.detach().requires_grad_(True)
        csc = cam_sc.detach().requires_grad_(True)
        ty, tx = warp.sample_positions(mip, cxy, csc, scale, res=res,
                                       left_handed=left_handed)
        ok = ((ty >= 0) & (ty < h_tex) & (tx >= 0) & (tx < w_tex)).to(out.dtype)
        cot_ty = torch.sum(g * d_dty, dim=1) * ok
        cot_tx = torch.sum(g * d_dtx, dim=1) * ok
        return torch.autograd.grad((ty, tx), (cxy, csc), (cot_ty, cot_tx))


def judge_vjp(got, want, rtol=1e-4):
    """Values of (gxy, gsc) ``got`` over rtol * |want| + 1e-6 * max|want| of
    ``want``, and the largest difference."""
    over, diff = 0, 0.0
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        tol = rtol * b.abs() + 1e-6 * float(b.abs().max())
        over += int(((a - b).abs() > tol).sum())
        diff = max(diff, float((a - b).abs().max()))
    return diff, over


def compare_warp_vjp(warp, wargs, res, seed, label):
    """The pose-VJP kernel on B3's view of ``wargs`` and a random cotangent
    against its plain closed form (rtol 1e-5: the per-pixel float32 terms
    are the same operations, only the float64 sums run in another order)
    and against the autograd chain (rtol 1e-4, as the reference's own
    gradients are held); a second launch must repeat the first bit for
    bit. Returns (max |kernel - plain|, values over tolerance or differing
    between the two launches)."""
    mip, xy, sc, scale, _, lh = wargs
    out = warp.warp_background_bilinear_reference(*wargs, res)
    gen = torch.Generator(device=out.device).manual_seed(seed)
    g = torch.rand(out.shape, generator=gen, device=out.device) * 2 - 1
    got = warp.warp_bilinear_vjp(mip, out, g, xy, sc, scale, lh, res)
    again = warp.warp_bilinear_vjp(mip, out, g, xy, sc, scale, lh, res)
    plain = warp.warp_bilinear_vjp_reference(mip, out, g, xy, sc, scale, lh, res)
    chain = autograd_warp_vjp(warp, mip, out, g, xy, sc, scale, lh, res)
    torch.cuda.synchronize()
    diff, over_plain = judge_vjp(got, plain, 1e-5)
    diff_chain, over_chain = judge_vjp(got, chain)
    repeat = sum(int((a != b).sum()) for a, b in zip(got, again))
    print(f'{label} warp_bilinear_vjp: max |kernel - plain| {diff:.3g}, {over_plain} of '
          f'{4 * xy.shape[0]} values over rtol 1e-5; against the autograd chain '
          f'{diff_chain:.3g}, {over_chain} over rtol 1e-4; {repeat} values differ '
          'between two launches')
    return diff, over_plain + over_chain + repeat


def compare_soft(soft, ops, g, label):
    """Forward (1e-5 absolute) and backward (rtol 1e-4) of the soft raster's
    kernels against the plain versions, both judged through float64.
    Returns ((forward max difference, over), [(backward max difference,
    over)] per output, forward values that differ from the plain version in
    any bit): the faces a tile's cull drops add exactly 0 there, so 0."""
    coef, zw, color, bg = ops
    print(f'{label} soft raster, {coef.shape[1]} faces, B={coef.shape[0]}, '
          f'res {bg.shape[-1]}:')
    exact_in = [x.double() for x in ops]
    got, plain = soft.soft_raster_fwd(*ops), soft.soft_raster_fwd_reference(*ops)
    torch.cuda.synchronize()
    bits = int((got != plain).sum())
    print(f'  forward: {bits} values differ from the plain version in any bit')
    fwd = judge(got, plain, soft.soft_raster_fwd_reference(*exact_in), 'forward',
                0.0, 1e-5)
    got = soft.soft_raster_bwd(*ops, g)
    plain = soft.soft_raster_bwd_reference(*ops, g)
    exact = soft.soft_raster_bwd_reference(*exact_in, g.double())
    torch.cuda.synchronize()
    bwd = [judge(a, b, c, name, 1e-4) for name, a, b, c in
           zip(('gcoef', 'gzw', 'gcolor', 'gbg'), got, plain, exact)]
    return fwd, bwd, bits


#: the plain pieces of the bilinear warp and its VJP, which the textured
#: IL path must not run on the card
PLAIN_WARP = ('warp_coefficients', 'warp_view_bilinear_reference',
              'warp_bilinear_vjp_reference', 'sample_positions')


@contextlib.contextmanager
def count_calls(module, names):
    """Count the calls of the functions ``names`` of ``module`` (looked up
    there at call time) while the block runs; yields {name: calls}."""
    calls = {name: 0 for name in names}
    saved = {name: getattr(module, name) for name in names}

    def counting(name):
        def wrapped(*args, **kw):
            calls[name] += 1
            return saved[name](*args, **kw)
        return wrapped

    for name in names:
        setattr(module, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def il_policy(features, dtype, device, action_size=2, seed=0):
    from torchdrivesim_tpu_torch.models import BirdviewCNNPolicy
    torch.manual_seed(seed)
    return BirdviewCNNPolicy(action_size, features, dtype=dtype).to(device)


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


def profile_step(fn, label, card, count=()):
    """One call of ``fn`` under ``torch.profiler``: device operations, their
    summed device time, its share of the (profiled) wall time, the kernels
    that take the most device time and the launches of the kernels whose
    names contain each of ``count``. Returns (device operations, busy
    share) or None when the profiler traced no device events."""
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
    if count:
        print(f'{label} profile: launches ' + ', '.join(
            f'{c} {sum(1 for e in device if c in e.name)}' for c in count))
    return len(device), busy_us / wall_us


def soft_bwd_partial(soft, ops, g):
    """B4b's C entry point without its counters (its last blocks sum
    nothing), the sum over the tiles and the output views done in PyTorch
    instead: how the backward would run with the cross-tile sum left to the
    wrapper."""
    from torchdrivesim_tpu_torch.ops.build import check_launch
    coef, zw, color, bg = ops
    b, n_faces, res = coef.shape[0], coef.shape[1], bg.shape[-1]
    partial = coef.new_empty((b, soft.accum_tiles(res), n_faces, 13))
    gbg = torch.empty_like(bg)
    check_launch(soft.LIBRARY.load().tds_soft_raster_bwd(
        coef.data_ptr(), zw.data_ptr(), color.data_ptr(), bg.data_ptr(), g.data_ptr(),
        b, n_faces, res, partial.data_ptr(), gbg.data_ptr(), None, None, None, None,
        torch.cuda.current_stream().cuda_stream), 'soft raster backward')
    return partial, gbg


def soft_floor(soft, ops, g, card):
    """B4a's and B4b's floors at the IL operands, by graph replay: a
    ``fill_`` of B4a's output; B4b without its in-kernel cross-tile sum,
    alone and followed by that sum in PyTorch (the partial summed over the
    tiles, gcolor copied out), held against the kernel's own sum; and both
    kernels' registers, blocks per SM, spills and shared memory."""
    out = torch.empty_like(ops[3])
    fill_ms = graph_ms(lambda: out.fill_(0.0), 200)

    def summed():
        partial, gbg = soft_bwd_partial(soft, ops, g)
        sums = partial.sum(dim=1)
        return sums[..., :9].reshape(-1, sums.shape[1], 3, 3), sums[..., 9:10], \
            sums[..., 10:13].contiguous(), gbg

    alone_ms = graph_ms(lambda: soft_bwd_partial(soft, ops, g), 100)
    summed_ms = graph_ms(summed, 100)
    got, want = soft.soft_raster_bwd(*ops, g), summed()
    torch.cuda.synchronize()
    diff = max(float((a.reshape(-1) - w.reshape(-1)).abs().max()) for a, w in zip(got, want))
    print(f'soft raster floors B={ops[0].shape[0]} res={ops[3].shape[-1]} '
          f'F={ops[0].shape[1]}: fill_ of the forward\'s output {fill_ms:.4f} ms; '
          f'backward without its in-kernel tile sum {alone_ms:.4f} ms, with the sum '
          f'in PyTorch {summed_ms:.4f} ms (the sum adds {summed_ms - alone_ms:.4f} ms); '
          f'in-kernel and PyTorch sums differ by at most {diff:.3g} [{card}]')
    for n_faces in sorted({ops[0].shape[1], 128}):
        (fr, fb, fs, fm), (br, bb, bs, bm) = soft.occupancy(n_faces)
        print(f'  F={n_faces}: forward {fr} registers, {fb} blocks of 256 per SM, '
              f'{fs} spill bytes, {fm} shared bytes; backward {br} registers, {bb} '
              f'blocks per SM, {bs} spill bytes, {bm} shared bytes')


def device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) of one call of ``fn``
    under ``torch.profiler``, after one call that warms up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def warp_floor(warp, wargs, vjp_args, card):
    """What each textured IL frame's background cost before and after B3
    took its coefficients and its VJP took the backward's chain: a
    ``fill_`` of B3's output; the device operations of one call of each of
    ``warp_coefficients``, B3, the backward's autograd chain, its plain
    closed form and the VJP kernel; the two plain backwards' times, eager
    and by graph replay."""
    res = vjp_args[-1]
    out = torch.empty_like(vjp_args[1])
    fill_ms = graph_ms(lambda: out.fill_(0.0), 200)
    mip, xy, sc, scale, bgc, lh = wargs
    ops = {'warp_coefficients': lambda: warp.warp_coefficients(
               mip, xy, sc, scale, bgc, lh, res=res),
           'B3': lambda: warp.warp_background_bilinear(*wargs, res),
           'autograd chain': lambda: autograd_warp_vjp(warp, *vjp_args),
           'plain closed form': lambda: warp.warp_bilinear_vjp_reference(*vjp_args),
           'VJP kernel': lambda: warp.warp_bilinear_vjp(*vjp_args)}
    counts = {name: device_ops(fn) for name, fn in ops.items()}
    times = {name: f'{cuda_ms(ops[name], 20):.4f} ms eager, '
                   f'{graph_ms(ops[name], 20):.4f} ms by graph replay'
             for name in ('autograd chain', 'plain closed form')}
    print(f'bilinear warp floors B={xy.shape[0]} res={res}: fill_ of B3\'s output '
          f'{fill_ms:.4f} ms; device operations per call {counts}; the backward\'s '
          f'autograd chain {times["autograd chain"]}; its plain closed form '
          f'{times["plain closed form"]} [{card}]')


def il_path(device, card):
    """The imitation-learning phases; returns the JSON entries of its
    four kernels."""
    from torchdrivesim_tpu_torch.benchmark import (
        build_il_scenario, make_il_grad_fn, make_il_loss_fn, run_il_benchmark)
    from torchdrivesim_tpu_torch.imitation import (
        build_synthetic_batch, build_synthetic_simulator, make_bc_train_step,
        make_optimizer)
    from torchdrivesim_tpu_torch.ops import soft, warp

    # 1. the kernels against their plain versions
    scenario = build_il_scenario(batch_size=IL_BATCH, agent_count=IL_AGENTS,
                                 res=IL_RES, device=device)
    wargs, sops = il_frame_operands(scenario, scenario.sim.state)
    mip, sc = wargs[0], wargs[2]
    print(f'IL operands: {sops[0].shape[1]} faces per camera, texture '
          f'{tuple(mip.data.shape)} at {mip.cell_size} m, flip branch on '
          f'{int((sc[:, 0].abs() < sc[:, 1].abs()).sum())} of {IL_BATCH} cameras')
    g = torch.empty_like(sops[3]).uniform_(-1, 1)
    errs = {'warp': [], 'vjp': [], 'fwd': [], 'bwd': []}
    over = 0
    for i, (label, args, res) in enumerate((
            ('IL', wargs, IL_RES),
            ('random flip', bilinear_warp_case(3, 64, device), 64),
            ('random flip res 128', bilinear_warp_case(4, 16, device), 128),
            ('left-handed', bilinear_warp_case(5, 16, device, left_handed=True), 64),
            ('texture corner', bilinear_warp_case(
                6, 4, device, cam_xy=[[3.0, 4.0], [146.0, 2.0], [2.0, 147.0],
                                      [148.0, 149.0]]), 64),
            ('texture edge', edge_warp_case(device), 64))):
        d, o = compare_warp(warp, args, res, label)
        errs['warp'].append(d)
        d, o2 = compare_warp_vjp(warp, args, res, 100 + i, label)
        errs['vjp'].append(d)
        over += o + o2
    for label, (ops, gg) in (
            ('IL', (sops, g)),
            ('random F=128', random_soft_operands(6, 4, 128, 64, device)),
            ('random F=45 res 32', random_soft_operands(7, 8, 45, 32, device)),
            ('random F=128 res 128', random_soft_operands(8, 2, 128, 128, device)),
            ('boundary res 64', soft_case_operands('boundary', 14, 4, 71, 64, device)),
            ('boundary res 40', soft_case_operands('boundary', 15, 4, 97, 40, device)),
            ('road F=120', soft_case_operands('road', 16, 8, 120, 64, device))):
        (fd, fo), bwd, bits = compare_soft(soft, ops, gg, label)
        errs['fwd'].append(fd)
        errs['bwd'] += [d for d, _ in bwd]
        over += fo + sum(o for _, o in bwd) + bits
    if over:
        raise AssertionError(f'{over} values over tolerance or forward values off in '
                             'any bit: the kernels disagree with their plain versions')
    per_tile = soft.soft_tile_lists_reference(sops[0], IL_RES).sum(dim=-1).double()
    print(f'IL frame: the cull lists {float(per_tile.mean()):.3f} faces per 16 x 16 '
          f'tile (max {int(per_tile.max())}) of {sops[0].shape[1]}; '
          f'{soft_tile_pairs(sops[0], IL_RES)} (camera, face, tile) triples can '
          f'contribute of {per_tile.numel() * sops[0].shape[1]} (soft_tile_pairs)')

    # 2. a small gradient step on the card against the CPU
    il_grad_compare_with_cpu(device, lambda scn: None, 'IL')

    # 3. the main path: one full-width gradient step, counting launches
    policy = il_policy(IL_FEATURES, torch.bfloat16, device)
    params = list(policy.parameters())
    grad_fn = make_il_grad_fn(scenario, policy, horizon=IL_HORIZON)
    state = scenario.sim.state
    warp.LAUNCHES = warp.VJP_LAUNCHES = soft.FWD_LAUNCHES = soft.BWD_LAUNCHES = 0
    with count_calls(warp, PLAIN_WARP) as plain_calls:
        t0 = time.perf_counter()
        loss, grads = grad_fn(state)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    launches = {'warp': warp.LAUNCHES, 'vjp': warp.VJP_LAUNCHES,
                'fwd': soft.FWD_LAUNCHES, 'bwd': soft.BWD_LAUNCHES}
    print(f'IL main path: one gradient step, B={IL_BATCH}, {IL_AGENTS} vehicles, '
          f'res {IL_RES}, horizon {IL_HORIZON}, in {step_s:.2f} s; loss '
          f'{float(loss)!r}; launches warp_bilinear {launches["warp"]}, '
          f'warp_bilinear_vjp {launches["vjp"]}, soft_raster_fwd {launches["fwd"]}, '
          f'soft_raster_bwd {launches["bwd"]}; calls of the plain warp pieces '
          f'{plain_calls}')
    # the first frame is drawn from the given state, which nothing
    # differentiates, so autograd runs no backward for it
    want = {'warp': IL_HORIZON, 'vjp': IL_HORIZON - 1, 'fwd': IL_HORIZON,
            'bwd': IL_HORIZON - 1}
    if launches != want:
        raise AssertionError(f'launches {launches}, expected {want}')
    if any(plain_calls.values()):
        raise AssertionError(f'the plain warp ran on the card: {plain_calls}')
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

    # 5. times, on this card, at the IL operands; B4a's and B4b's bounds
    # count the (pixel, face) pairs of the tiles each face can reach, with
    # the count of every pair beside them
    coef, zw, color, bg = sops
    b, n_faces = coef.shape[0], coef.shape[1]
    face_pixels = soft_tile_pairs(coef, IL_RES) * BOUND_TILE * BOUND_TILE
    all_pairs = b * n_faces * IL_RES * IL_RES
    pixels = b * IL_RES * IL_RES
    entries = []
    _, xy, sc, scale, bgc, lh = wargs
    vjp_args = (mip, bg, g, xy, sc, scale, lh, IL_RES)
    for name, fn, plain, reps, plain_reps, n_bytes, n_ops, n_sfu, source, replaces, \
            err, n in (
            ('warp_bilinear',
             lambda: warp.warp_background_bilinear(*wargs, IL_RES),
             lambda: warp.warp_background_bilinear_reference(*wargs, IL_RES),
             200, 10, nbytes(xy, sc, bgc) + texel_bytes(mip, b, scenario.fov)
             + pixels * 3 * 4, pixels * WARP_OPS + b * WARP_COEF_OPS, 0,
             'torchdrivesim_tpu_torch/csrc/warp_bilinear.cu',
             'torchdrivesim_tpu/ops/pallas_warp.py:306', max(errs['warp']),
             launches['warp']),
            ('warp_bilinear_vjp',
             lambda: warp.warp_bilinear_vjp(*vjp_args),
             lambda: warp.warp_bilinear_vjp_reference(*vjp_args),
             200, 10, nbytes(bg, g, xy, sc) + 2 * b * 2 * 4,
             pixels * WARP_VJP_OPS, 0,
             'torchdrivesim_tpu_torch/csrc/warp_bilinear.cu',
             'torchdrivesim_tpu/ops/pallas_warp.py:638', max(errs['vjp']),
             launches['vjp']),
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
              f'({n_bytes / 1e6:.3f} MB, {n_ops / 1e6:.3f} M float32 ALU and '
              f'{n_sfu / 1e6:.3f} M SFU operations) '
              f'[{card}]')
        if name.startswith('soft'):
            scale = all_pairs / face_pixels
            old_ms, old_by = bound(n_bytes, n_ops * scale, n_sfu * scale)
            print(f'  {name} bound counting every (pixel, face) pair: '
                  f'{old_ms * 1e3:.3f} us by {old_by} ({all_pairs / 1e6:.3f} M pairs, '
                  f'{face_pixels / 1e6:.3f} M in reachable tiles)')
        entries.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': n, 'max_abs_err': err,
                        'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                        'bound_by': bound_by, 'library_ms': None})
    warp_floor(warp, wargs, vjp_args, card)
    soft_floor(soft, sops, g, card)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    grad_fn(state)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    print(f'IL gradient step peak memory above the resident scenario: '
          f'{peak / 2**20:.1f} MiB [{card}]')
    profile_step(lambda: grad_fn(state), 'IL gradient step', card,
                 count=('warp_bilinear_kernel', 'warp_bilinear_vjp_kernel'))
    bench = run_il_benchmark(scenario, policy, horizon=IL_HORIZON,
                             rollouts_per_chunk=2, n_chunks=3)
    print(f'IL gradient step B={IL_BATCH} horizon {IL_HORIZON}: '
          f'{bench["grad_rollouts_per_sec_median"]:.3f} grad-rollouts/s, '
          f'{bench["env_steps_per_sec_median"]:.1f} env-steps/s median of chunks '
          f'{[round(r, 3) for r in bench["chunk_rollout_rates"]]} rollouts/s [{card}]')
    return entries


# --- the grouped soft raster: IL gradients over the untextured map ----------

def accum_random_operands(seed: int, b: int, n_faces: int, res: int, device):
    """:func:`random_soft_operands` padded to whole groups, and its random
    background."""
    from torchdrivesim_tpu_torch.ops import soft
    (coef, zw, color, bg), _ = random_soft_operands(seed, b, n_faces, res, device)
    return soft.pad_to_groups(coef, zw, color), bg


def accum_road_operands(seed: int, b: int, n_faces: int, res: int, device):
    """Faces like the untextured frame's road mesh, most far off-view: a
    tenth centred around the view, the rest over 17 x 17 views around it,
    corners a twelfth of the view apart, z at the road's levels (15, 14)
    with a few actors (2); padded to whole groups, and a random
    background."""
    from torchdrivesim_tpu_torch.ops import soft
    rng = np.random.RandomState(seed)
    near = rng.rand(b, n_faces, 1) < 0.1
    centre = np.where(near, rng.uniform(-0.25 * res, 1.25 * res, (b, n_faces, 2)),
                      rng.uniform(-8 * res, 9 * res, (b, n_faces, 2)))
    corners = centre[:, :, None, :] + rng.randn(b, n_faces, 3, 2) * res / 12
    z = rng.choice([15.0, 14.0, 2.0], size=(b, n_faces, 1, 1), p=[0.6, 0.35, 0.05])
    verts = np.concatenate([corners, np.broadcast_to(z, (b, n_faces, 3, 1))], axis=-1)
    ops = face_operands(verts.reshape(b, n_faces * 3, 3), rng, device)
    bg = torch.as_tensor(rng.rand(b, 3, res, res).astype(np.float32), device=device)
    return soft.pad_to_groups(*ops), bg


def boundary_edge(rng, x: float, y: float, target):
    """Float32 (A, B, C), 0.002 <= |A|, |B| <= 0.02 with the signs of x and
    y, such that the port's float32 edge value (A*x + B*y) + C is exactly
    ``target`` at the pixel centre (x, y); with x and y the signs, that
    pixel is the edge's largest value over any tile whose extreme corner it
    is."""
    f32 = np.float32
    for _ in range(200):
        a = f32(np.sign(x) * rng.uniform(0.002, 0.02))
        b = f32(np.sign(y) * rng.uniform(0.002, 0.02))
        s = f32(a * f32(abs(x))) + f32(b * f32(abs(y)))
        c = f32(float(target) - float(s))
        for _ in range(8):
            got = f32(s + c)
            if got == target:
                return a, b, c
            c = np.nextafter(c, f32(np.inf) if got < target else f32(-np.inf))
    raise RuntimeError(f'no edge through {target!r} at ({x}, {y})')


def slack_edge(rng, x: float, y: float):
    """Float32 (A, B, C), A and B negative with |A x| and |B y| in [2, 4),
    whose port's float32 edge value at the pixel centre (|x|, |y|), its
    largest over a tile whose first pixel that is (x, y < 0, as in
    :func:`boundary_edge`), is nextafter(-4, 0), while its exact value,
    which the cull's float64 test computes, is at most -4: without the
    cull's slack such a face would be dropped from a tile where its window
    ramp is nonzero."""
    f32 = np.float32
    target = np.nextafter(f32(-4), f32(0))
    for _ in range(20000):
        a = f32(-rng.uniform(2, 4) / abs(x))
        b = f32(-rng.uniform(2, 4) / abs(y))
        s = f32(f32(a * f32(abs(x))) + f32(b * f32(abs(y))))
        c = f32(float(target) - float(s))
        if f32(s + c) == target \
                and (float(a) * abs(x) + float(b) * abs(y)) + float(c) <= -4.0:
            return a, b, c
    raise RuntimeError(f'no edge below -4 in float64 at ({x}, {y})')


def boundary_extra(res: int, slack_faces: bool = False) -> int:
    """The faces :func:`accum_boundary_operands` adds per camera."""
    per = -(-res // BOUND_TILE)
    return 3 * per * per + (slack_faces and (per - 1) ** 2)


def accum_boundary_operands(seed: int, b: int, n_faces: int, res: int, device,
                            slack_faces: bool = False):
    """:func:`random_soft_operands`' faces and, for every 16 x 16 tile of
    every camera, three boundary faces: one soft edge (|A|, |B| <= 0.02)
    whose float32 value at one of the tile's corner pixels, its largest
    there, is nextafter(-4, 0) (the face reaches that pixel: the cull must
    keep it), exactly -4 (it adds 0 in the tile: the cull may drop it) or
    -4.001 (the cull drops it); its other two edges are 0 everywhere. With
    ``slack_faces``, also for every tile off the first row and column a
    face of :func:`slack_edge` at the tile's first pixel, at the nearest z
    (the largest weight): only the cull's slack keeps it there. The faces
    are shuffled together, padded to whole groups; and the random
    background."""
    from torchdrivesim_tpu_torch.ops import soft
    (coef, zw, color, bg), _ = random_soft_operands(seed, b, n_faces, res, 'cpu')
    rng = np.random.RandomState(seed + 1)
    tile = soft.ACCUM_TILE
    targets = (np.nextafter(np.float32(-4), np.float32(0)), np.float32(-4),
               np.float32(-4.001))
    edges = []
    for _ in range(b):
        cam, slack_rows = [], []
        for row in range(0, res, tile):
            for col in range(0, res, tile):
                for target in targets:
                    # the corner: +x for the tile's last row, -x for its first
                    x = (min(row + tile, res) - 0.5) if rng.rand() < 0.5 else -(row + 0.5)
                    y = (min(col + tile, res) - 0.5) if rng.rand() < 0.5 else -(col + 0.5)
                    a, b_, c = boundary_edge(rng, x, y, target)
                    cam.append([[a, b_, c], [0, 0, 0], [0, 0, 0]])
                if slack_faces and row and col:
                    a, b_, c = slack_edge(rng, -(row + 0.5), -(col + 0.5))
                    cam.append([[a, b_, c], [0, 0, 0], [0, 0, 0]])
                    slack_rows.append(len(cam) - 1)
        edges.append(cam)
    extra = np.asarray(edges, np.float32)                       # (B, K, 3, 3)
    k = extra.shape[1]
    order = torch.as_tensor(rng.permutation(n_faces + k))
    z = rng.uniform(2, 15, (b, 1, k))
    z[:, :, slack_rows] = 2.0
    coef = torch.cat([coef, torch.as_tensor(extra)], dim=1)[:, order]
    zw = torch.cat([zw, torch.as_tensor(np.exp((20 - z) / 0.5).astype(np.float32))],
                   dim=2)[:, :, order]
    color = torch.cat([color, torch.as_tensor(rng.rand(b, k, 3).astype(np.float32))],
                      dim=1)[:, order]
    ops = soft.pad_to_groups(coef, zw.contiguous(), color)
    return tuple(x.to(device) for x in ops), bg.to(device)


def kernel_tile_lists(soft, ops, res, cot):
    """The per-tile face lists and counts that B5a and B5b write on ``ops``
    (and the cotangents ``cot`` for B5b): each C entry point called as its
    wrapper calls it, with buffers of this function's own. Returns
    [(lists (B, tiles, F), counts (B, tiles)) of the forward, of the
    backward]."""
    from torchdrivesim_tpu_torch.ops.build import check_launch
    coef, zw, color = ops
    gnum, gden, gtransp = cot
    b, n_faces = coef.shape[:2]
    lib = soft.ACCUM_LIBRARY.load()
    stream = torch.cuda.current_stream().cuda_stream
    fwd, bwd = (soft._tile_lists(b, n_faces, res, coef.device) for _ in range(2))
    totals = [coef.new_empty(s) for s in ((b, 3, res, res), (b, res, res), (b, res, res))]
    check_launch(lib.tds_soft_accum_fwd(
        coef.data_ptr(), zw.data_ptr(), color.data_ptr(), b, n_faces, soft.MAX_FACES,
        res, fwd[0].data_ptr(), fwd[1].data_ptr(), *(x.data_ptr() for x in totals),
        stream), 'grouped soft raster forward')
    scratch = coef.new_empty((b, n_faces // soft.MAX_FACES, res, res))
    partial = coef.new_zeros((b, soft.accum_tiles(res), n_faces, 13))
    check_launch(lib.tds_soft_accum_bwd(
        coef.data_ptr(), zw.data_ptr(), color.data_ptr(), gnum.data_ptr(),
        gden.data_ptr(), gtransp.data_ptr(), b, n_faces, soft.MAX_FACES, res,
        bwd[0].data_ptr(), bwd[1].data_ptr(), scratch.data_ptr(), partial.data_ptr(),
        stream), 'grouped soft raster backward')
    torch.cuda.synchronize()
    return [fwd, bwd]


def compare_tile_lists(soft, ops, res, cot, label):
    """B5a's and B5b's per-tile lists (:func:`kernel_tile_lists`) against
    ``soft.soft_tile_lists_reference``: each count equal, each list the
    kept faces in ascending order. Prints the listed share of (camera,
    tile, face) triples beside :func:`soft_tile_pairs`' share (the gap is
    the cull's slack). Returns (mismatched counts, mismatched list entries,
    listed share)."""
    keep = soft.soft_tile_lists_reference(ops[0], res)           # (B, tiles, F)
    want_counts = keep.sum(dim=-1).to(torch.int32)
    # the kept faces first, ascending (a stable sort of the dropped flags)
    want = torch.sort((~keep).to(torch.int8), dim=-1, stable=True).indices
    inside = torch.arange(keep.shape[-1], device=keep.device) < want_counts[..., None]
    bad_counts = bad_entries = 0
    for lists, counts in kernel_tile_lists(soft, ops, res, cot):
        bad_counts += int((counts != want_counts).sum())
        bad_entries += int(((lists.long() != want) & inside).sum())
    share = float(keep.double().mean())
    reach = soft_tile_pairs(ops[0], res) / keep.numel()
    per_tile = want_counts.double()
    print(f'  {label} tile lists: {bad_counts} counts and {bad_entries} entries differ '
          f'from the plain cull; listed {share * 100:.3f}% of (camera, tile, face), '
          f'{reach * 100:.3f}% by soft_tile_pairs; faces per tile: mean '
          f'{float(per_tile.mean()):.1f}, max {int(per_tile.max())}, min '
          f'{int(per_tile.min())}')
    return bad_counts, bad_entries, share


def composite_cotangents(soft, totals, background, seed: int):
    """The cotangents (gnum, gden, gtransp) that the grouped path's
    composite (``soft.composite``) sends to the totals for a random image
    cotangent: gnum = g * cover / den and so on, the scale at which each
    face's z weight meets them in the backward."""
    rng = np.random.RandomState(seed)
    g = torch.as_tensor(rng.uniform(-1, 1, tuple(background.shape)).astype(np.float32),
                        device=background.device)
    leaves = [x.detach().requires_grad_(True) for x in totals]
    with torch.enable_grad():
        image = soft.composite(*leaves, background)
        return torch.autograd.grad(image, leaves, g)


def accum_rows(grads) -> torch.Tensor:
    """B5b's output (gcoef, gzw, gcolor) as 13 values per face, (B, F, 13)."""
    gcoef, gzw, gcolor = grads
    b, n_faces = gcoef.shape[:2]
    return torch.cat([gcoef.reshape(b, n_faces, 9), gzw.reshape(b, n_faces, 1), gcolor],
                     dim=-1)


def judge_rows(got, plain, exact, name, rtol=1e-4):
    """B5b's gradients face by face: the kernel's error from the exact
    (float64) value may be at most twice the plain version's largest
    float32 error on the same face, plus rtol * |exact| + 1e-6 x the largest
    of that face's 13 exact values. A face's z weight (e^10 for the road, up
    to e^36 for the actors) scales all its terms, so a tolerance scaled by
    the whole tensor's largest value would pass any value of a face of lower
    weight. Each value is a float32 sum over the pixels, which can cancel to
    a small part of its terms: the plain version's error shows how far
    rounding goes on that face, and the kernel sums in another order (256
    pixels a block, then over the blocks), so its error is of that size
    but not bounded by it. Returns (max |kernel - plain|, values over
    tolerance)."""
    got, plain, exact = (accum_rows(x).double() for x in (got, plain, exact))
    scale = exact.abs().amax(dim=-1, keepdim=True)
    noise = (plain - exact).abs().amax(dim=-1, keepdim=True)
    margin = 1e-6 * scale + rtol * exact.abs()
    tol = 2.0 * noise + margin
    err = (got - exact).abs()
    over = int((err > tol).sum())
    print(f'  {name}: max |kernel - plain| {float((got - plain).abs().max()):.3g}, '
          f'{int((scale > 0).sum())} faces with a gradient, {over} of {got.numel()} '
          f'values over tolerance')
    # the value worst against this tolerance, and the one worst against the
    # plain version's error at the same value alone
    for label, slack in (('tolerance', tol),
                         ('own plain error', (plain - exact).abs() + margin)):
        ratio = torch.where(err > 0, err / slack, torch.zeros_like(err))
        worst = int(ratio.argmax())
        b, f, k = (int(i) for i in np.unravel_index(worst, tuple(ratio.shape)))
        print(f'    worst against {label}: {float(ratio[b, f, k]):.3g} (camera {b}, face '
              f'{f}, term {k}: exact {float(exact[b, f, k]):.9g}, kernel '
              f'{float(got[b, f, k]):.9g}, plain {float(plain[b, f, k]):.9g}; face scale '
              f'{float(scale[b, f, 0]):.3g}, plain error up to {float(noise[b, f, 0]):.3g})')
    return float((got - plain).abs().max()), over


def accum_bwd_transp_fault(soft, ops, gnum, gden, gtransp):
    """The plain grouped backward with a planted fault: every group's transp
    receives ``gtransp`` itself instead of ``P_g * S_g`` (each group run as
    if it were the only one), for showing that :func:`judge_rows` sees it."""
    coef, zw, color = ops
    parts = [soft.soft_accum_bwd_reference(coef[:, lo:lo + soft.MAX_FACES],
                                           zw[:, :, lo:lo + soft.MAX_FACES],
                                           color[:, lo:lo + soft.MAX_FACES],
                                           gnum, gden, gtransp)
             for lo in range(0, coef.shape[1], soft.MAX_FACES)]
    return tuple(torch.cat([p[i] for p in parts], dim=d)
                 for i, d in ((0, 1), (1, 2), (2, 1)))


def cuda_ms_once(fn):
    """(result, milliseconds) of one call of ``fn``, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def compare_accum(soft, ops, background, res, seed, label):
    """B5a (1e-5 absolute) and B5b (:func:`judge_rows`) against their plain
    versions, judged through float64. B5b is judged twice: for the
    cotangents the composite over ``background`` sends to the totals, and
    for those with gnum = gden = 0, where only the transp chain flows; in
    each, the planted fault of :func:`accum_bwd_transp_fault` must come out
    over tolerance wherever it changes a value (it cannot where a single
    group holds every face that reaches a pixel). Returns ((forward max
    difference, over), (backward max difference, over), forward bit
    mismatches, (plain forward ms, plain backward ms of the composite's
    cotangents), those cotangents, the planted fault's values over
    tolerance for each set)."""
    b, n_faces = ops[0].shape[:2]
    print(f'{label} grouped soft raster, {n_faces} faces ({n_faces // soft.MAX_FACES} '
          f'groups), B={b}, res {res}:')
    exact_in = [x.double() for x in ops]
    got = soft.soft_accum_fwd(*ops, res)
    plain, fwd_ms = cuda_ms_once(lambda: soft.soft_accum_fwd_reference(*ops, res))
    exact = soft.soft_accum_fwd_reference(*exact_in, res)
    torch.cuda.synchronize()
    bits = sum(int((a != p).sum()) for a, p in zip(got, plain))
    print(f'  forward: {bits} values differ from the plain version in any bit')
    fwd = [judge(a, p, e, name, 0.0, 1e-5) for name, a, p, e in
           zip(('num', 'den', 'transp'), got, plain, exact)]
    grads = composite_cotangents(soft, plain, background, seed)
    bwd, bwd_ms, caught = [], None, []
    for kind, cot in (('composite', grads),
                      ('transp only', (torch.zeros_like(grads[0]),
                                       torch.zeros_like(grads[1]), grads[2]))):
        got = soft.soft_accum_bwd(*ops, *cot)
        plain, ms = cuda_ms_once(lambda: soft.soft_accum_bwd_reference(*ops, *cot))
        bwd_ms = ms if bwd_ms is None else bwd_ms
        exact = soft.soft_accum_bwd_reference(*exact_in, *(g.double() for g in cot))
        torch.cuda.synchronize()
        bwd.append(judge_rows(got, plain, exact, f'backward, {kind} cotangents'))
        moved, over = judge_rows(accum_bwd_transp_fault(soft, ops, *cot), plain, exact,
                                 f'planted fault (gtransp for every group), {kind}')
        if moved > 0 and not over:
            raise AssertionError(f'{label}: the backward check does not see a fault in '
                                 'the transp chain')
        caught.append(over)
    worst = lambda parts: (max(d for d, _ in parts), sum(o for _, o in parts))
    return worst(fwd), worst(bwd), bits, (fwd_ms, bwd_ms), grads, caught


def soft_tile_pairs(coef, res) -> int:
    """(camera, face, tile) triples of the BOUND_TILE x BOUND_TILE pixel
    tiles in which a face can contribute: where one of its edge values is at
    most -4 at all four extreme pixel centres of a tile (the values are
    affine in the pixel, so then at every pixel of it), min_e t_e <= -4 puts
    its window ramp, hence its alpha and all it adds, at exactly 0. A ragged
    last tile ends at the image's last pixel."""
    coef = coef.double()
    first = torch.arange(0, res, BOUND_TILE, dtype=torch.float64,
                         device=coef.device) + 0.5
    ends = torch.stack([first, torch.clamp(first + BOUND_TILE - 1, max=res - 0.5)])
    a, b, c = coef[..., 0, None], coef[..., 1, None], coef[..., 2]
    row = torch.maximum(a * ends[0], a * ends[1])                # (B, F, 3, tiles)
    col = torch.maximum(b * ends[0], b * ends[1])
    top = row[..., :, None] + col[..., None, :] + c[..., None, None]
    return int((top > -4.0).all(dim=2).sum())


def accum_bound(ops, res, backward: bool):
    """B5a's or B5b's bound on one frame: each input read once, each output
    written once, and the operations of the (pixel, face) pairs in which the
    face can contribute (:func:`soft_tile_pairs`)."""
    coef, zw, color = ops
    b = coef.shape[0]
    pairs = soft_tile_pairs(coef, res) * BOUND_TILE * BOUND_TILE
    faces = nbytes(coef, zw, color)
    if backward:
        n_bytes = 2 * faces + b * 5 * res * res * 4
        return bound(n_bytes, pairs * SOFT_ACCUM_BWD_OPS, pairs * SOFT_ACCUM_BWD_SFU), pairs
    n_bytes = faces + b * 5 * res * res * 4
    return bound(n_bytes, pairs * SOFT_FWD_OPS, pairs * SOFT_FWD_SFU), pairs


def grouped_check_timing(device, card):
    """The card's plain check of B5a/B5b (``compare_accum``) on the first
    frame of the untextured config-4 rollout (B = 16, 17,024 faces, res 64),
    first with the plain versions the check had until they folded only the
    listed faces (``soft_accum_*_facewise``: every face over every pixel,
    each gradient term summed by ``torch.sum``), then twice with the listed
    folds: the seconds of each; the forward totals of the two forms must be
    equal bit for bit (the backward's sums differ in order: its largest
    difference is printed). ``python3 chip_smoke.py grouped-check-timing``
    runs it alone."""
    from torchdrivesim_tpu_torch.benchmark import build_il_scenario, il_view
    from torchdrivesim_tpu_torch.ops import soft
    scenario = build_il_scenario(batch_size=IL_BATCH, agent_count=IL_AGENTS, res=IL_RES,
                                 use_texture=False, n_layouts=IL_BATCH, device=device)
    mesh, cams = il_view(scenario, scenario.sim.state)
    background, frame = scenario.sim.renderer.soft_frame_operands(mesh, IL_RES, cams)
    frame = [x.contiguous() for x in soft.pad_to_groups(*frame)]
    listed = (soft.soft_accum_fwd_reference, soft.soft_accum_bwd_reference,
              soft._pixel_total)
    facewise = (soft.soft_accum_fwd_facewise, soft.soft_accum_bwd_facewise,
                lambda x, res: x.sum(dim=(-2, -1)))
    results = {}
    for label, form in (('face by face', facewise), ('listed', listed),
                        ('listed again', listed)):
        soft.soft_accum_fwd_reference, soft.soft_accum_bwd_reference, \
            soft._pixel_total = form
        try:
            t0 = time.perf_counter()
            out = compare_accum(soft, frame, background, IL_RES, 21, f'timing, {label}')
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            results[label] = (secs, soft.soft_accum_fwd_reference(*frame, IL_RES),
                              soft.soft_accum_bwd_reference(*frame, *out[4]))
        finally:
            soft.soft_accum_fwd_reference, soft.soft_accum_bwd_reference, \
                soft._pixel_total = listed
        print(f'grouped plain check ({label}): {secs:.1f} s [{card}]')
    (a, fa, ba), (b, fb, bb) = results['face by face'], results['listed']
    bits = sum(int((x != y).sum()) for x, y in zip(fa, fb))
    rel = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(ba, bb))
    print(f'grouped plain check: face by face {a:.1f} s, listed {b:.1f} / '
          f'{results["listed again"][0]:.1f} s, {a / b:.1f}x; forward totals: {bits} '
          f'values differ in any bit; gradients: at most {rel:.3g} of the largest apart '
          f'(the sums\' order) [{card}]')
    if bits:
        raise AssertionError('the listed forward differs from the face-by-face forward')


def il_untextured_compare_with_cpu(device):
    """The untextured IL gradient step at B = 2, horizon 3, res 32, float32
    policy (cuDNN without TF32), on the card and on the CPU: losses and
    gradients to rtol 1e-3 (atol 1e-6 x max|grad|)."""
    from torchdrivesim_tpu_torch.benchmark import build_il_scenario, make_il_grad_fn
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = {}
        for dev in (device, torch.device('cpu')):
            scn = build_il_scenario(batch_size=2, agent_count=IL_AGENTS, res=32,
                                    use_texture=False, device=dev)
            policy = il_policy(IL_FEATURES, torch.float32, dev)
            loss, grads = make_il_grad_fn(scn, policy, horizon=3)(scn.sim.state)
            runs[dev.type] = (loss.cpu(), [x.cpu() for x in grads])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (lg, gg), (lc, gc) = runs['cuda'], runs['cpu']
    print(f'untextured IL compare B=2 horizon 3 res 32: loss card {float(lg)!r}, '
          f'CPU {float(lc)!r}')
    torch.testing.assert_close(lg, lc, rtol=1e-3, atol=0)
    worst = 0.0
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6 * float(b.abs().max()))
        worst = max(worst, float(((a - b).abs() / b.abs().max()).max()))
    print(f'untextured IL compare: {len(gg)} gradients agree, max difference '
          f'{worst:.3g} of each gradient\'s largest value')


def grouped_soft_path(device, card):
    """The grouped soft raster's phases (IL gradients over the untextured
    Town02 road mesh); returns the JSON entries of B5a and B5b."""
    from torchdrivesim_tpu_torch.benchmark import (
        build_il_scenario, il_view, make_il_grad_fn, make_il_loss_fn,
        make_il_rollout_fn, run_il_benchmark)
    from torchdrivesim_tpu_torch.ops import soft, warp

    # 1. the kernels against their plain versions and their per-tile lists
    # against the plain cull: on random operands (a partial last group and a
    # degenerate face in each), on boundary faces and on road-like faces,
    # most far off-view
    errs, over, bits, bad_lists = {'fwd': [], 'bwd': []}, 0, 0, 0
    for kind, make, seed, b, n_faces, res in (
            ('random', accum_random_operands, 11, 4, 129, 64),
            ('random', accum_random_operands, 12, 2, 300, 128),
            ('random', accum_random_operands, 13, 1, 2000, 256),
            ('boundary', accum_boundary_operands, 14, 2, 200, 64),
            ('boundary', accum_boundary_operands, 15, 1, 100, 40),
            ('road', accum_road_operands, 16, 2, 4500, 64)):
        ops, bg = make(seed, b, n_faces, res, device)
        label = f'{kind} F={n_faces}'
        (fd, fo), (bd, bo), nb, _, grads, _ = compare_accum(soft, ops, bg, res, seed + 1,
                                                            label)
        bad_counts, bad_entries, _ = compare_tile_lists(soft, ops, res, grads, label)
        errs['fwd'].append(fd)
        errs['bwd'].append(bd)
        over, bits = over + fo + bo, bits + nb
        bad_lists += bad_counts + bad_entries
    # B4a and B4b again, beside the header they now share
    for label, (ops, g) in (('random F=128', random_soft_operands(6, 4, 128, 64, device)),
                            ('random F=45 res 32', random_soft_operands(7, 8, 45, 32, device))):
        (_, fo), bwd, nb = compare_soft(soft, ops, g, label)
        over += fo + sum(o for _, o in bwd) + nb
    if over:
        raise AssertionError(f'{over} values over tolerance (or B4a values off in any '
                             'bit): the soft kernels disagree with their plain versions')

    # 2. a small gradient step on the card against the CPU
    il_untextured_compare_with_cpu(device)

    # 3. the main path: one full-width gradient rollout over the road mesh
    # a layout per environment: the last frame's check then sees 16 distinct
    # views
    scenario = build_il_scenario(batch_size=IL_BATCH, agent_count=IL_AGENTS, res=IL_RES,
                                 use_texture=False, n_layouts=IL_BATCH, device=device)
    policy = il_policy(IL_FEATURES, torch.bfloat16, device)
    grad_fn = make_il_grad_fn(scenario, policy, horizon=IL_HORIZON)
    state = scenario.sim.state
    mesh, _ = il_view(scenario, state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device)
    warp.LAUNCHES = warp.VJP_LAUNCHES = soft.FWD_LAUNCHES = soft.BWD_LAUNCHES = 0
    soft.ACCUM_FWD_LAUNCHES = soft.ACCUM_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    loss, grads = grad_fn(state)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {'warp_bilinear': warp.LAUNCHES, 'warp_bilinear_vjp': warp.VJP_LAUNCHES,
                'soft_raster_fwd': soft.FWD_LAUNCHES,
                'soft_raster_bwd': soft.BWD_LAUNCHES,
                'soft_accum_fwd': soft.ACCUM_FWD_LAUNCHES,
                'soft_accum_bwd': soft.ACCUM_BWD_LAUNCHES}
    peak = torch.cuda.max_memory_allocated(device)
    total = torch.cuda.get_device_properties(device).total_memory
    print(f'untextured IL main path: one gradient rollout, B={IL_BATCH}, {IL_AGENTS} '
          f'vehicles, res {IL_RES}, horizon {IL_HORIZON}, {mesh.faces.shape[1]} faces '
          f'per camera ({-(-mesh.faces.shape[1] // soft.MAX_FACES)} groups), in '
          f'{step_s:.2f} s; loss {float(loss)!r}; launches {launches}')
    print(f'untextured IL peak memory: {peak / 2**30:.3f} GiB '
          f'({(peak - resident) / 2**30:.3f} GiB above the resident scenario) of '
          f'{total / 2**30:.1f} GiB [{card}]')
    want = {'warp_bilinear': 0, 'warp_bilinear_vjp': 0, 'soft_raster_fwd': 0,
            'soft_raster_bwd': 0,
            'soft_accum_fwd': IL_HORIZON, 'soft_accum_bwd': IL_HORIZON - 1}
    if launches != want:
        raise AssertionError(f'launches {launches}, expected {want}')
    if not torch.isfinite(loss) or not all(torch.isfinite(x).all() for x in grads):
        raise AssertionError('non-finite loss or gradient')
    if not all(float(x.abs().max()) > 0 for x in grads):
        raise AssertionError('a parameter gradient is zero')

    # the kernels on the frame of the state the full-width rollout returns
    with torch.no_grad():
        last = make_il_rollout_fn(scenario, policy, IL_HORIZON)(state)
    mesh, cams = il_view(scenario, last)
    background, frame = scenario.sim.renderer.soft_frame_operands(mesh, IL_RES, cams)
    frame = [x.contiguous() for x in soft.pad_to_groups(*frame)]
    poses = len(torch.unique(torch.round(cams.xy * 100), dim=0))
    image = scenario.sim.renderer.render_rgb_mesh_chw(
        mesh, scenario.sim.renderer.res, cams).detach()
    drawn = float((image > 0.5).any(dim=1).float().mean())
    print(f'last frame: {IL_BATCH} cameras at {poses} distinct positions, '
          f'{drawn * 100:.1f}% of pixels drawn over the black background')
    if not torch.isfinite(image).all() or not drawn > 0.5:
        raise AssertionError('the last frame does not show the map')
    if poses != IL_BATCH:
        raise AssertionError(f'{poses} distinct camera positions, expected {IL_BATCH}')
    # the plain versions' times are those of this comparison's float32 runs
    t0 = time.perf_counter()
    (fd, fo), (bd, bo), nb, plain_times, frame_grads, caught = compare_accum(
        soft, frame, background, IL_RES, 21, 'last frame')
    print(f'last frame: the plain check (compare_accum, the listed folds) took '
          f'{time.perf_counter() - t0:.1f} s [{card}]')
    errs['fwd'].append(fd)
    errs['bwd'].append(bd)
    if fo + bo:
        raise AssertionError(f'{fo + bo} values over tolerance on the last frame')
    if not all(caught):
        raise AssertionError(f'the planted fault went unseen on the last frame: {caught}')
    bad_counts, bad_entries, listed = compare_tile_lists(soft, frame, IL_RES, frame_grads,
                                                         'last frame')
    bad_lists += bad_counts + bad_entries
    print(f'grouped forward: {bits + nb} values differ from the plain version in any '
          f'bit, over all cases; {bad_lists} tile-list counts and entries differ from '
          'the plain cull')
    if bits + nb or bad_lists:
        raise AssertionError(f'{bits + nb} forward values differ in some bit, '
                             f'{bad_lists} tile-list counts and entries differ')

    # 4. the directional finite-difference check at small size
    small = build_il_scenario(batch_size=4, agent_count=IL_AGENTS, res=IL_RES,
                              use_texture=False, device=device)
    small_policy = il_policy(IL_FEATURES, torch.float32, device)
    small_params = list(small_policy.parameters())
    _, small_grads = make_il_grad_fn(small, small_policy, horizon=5)(small.sim.state)
    rels, gnorm = directional_gradcheck(make_il_loss_fn(small, small_policy, 5),
                                        small_params, small_grads, small.sim.state)
    median_rel = statistics.median(rels)
    print(f'untextured IL directional gradcheck (B=4, horizon 5, float32 policy): '
          f'|g| {gnorm:.6g}, relative errors {[round(r, 5) for r in rels]} at eps '
          f'3e-3 / 1e-2 / 3e-2, median {median_rel:.5f}')
    if not median_rel < 0.05:
        raise AssertionError(f'directional gradcheck median {median_rel}')

    # 5. times, on this card, at the last frame
    entries = []
    for name, fn, plain_ms, reps, backward, source, replaces, err, n in (
            ('soft_accum_fwd', lambda: soft.soft_accum_fwd(*frame, IL_RES),
             plain_times[0], 20, False,
             'torchdrivesim_tpu_torch/csrc/soft_accum.cu',
             'torchdrivesim_tpu/ops/pallas_soft.py:393', max(errs['fwd']),
             launches['soft_accum_fwd']),
            ('soft_accum_bwd', lambda: soft.soft_accum_bwd(*frame, *frame_grads),
             plain_times[1], 5, True,
             'torchdrivesim_tpu_torch/csrc/soft_accum.cu',
             'torchdrivesim_tpu/ops/pallas_soft.py:414', max(errs['bwd']),
             launches['soft_accum_bwd'])):
        ms, call_ms = graph_ms(fn, reps), cuda_ms(fn, reps)
        (bound_ms, bound_by), pairs = accum_bound(frame, IL_RES, backward)
        all_pairs = IL_BATCH * frame[0].shape[1] * IL_RES * IL_RES
        print(f'{name} kernel B={IL_BATCH} res={IL_RES} F={frame[0].shape[1]}: '
              f'{ms:.4f} ms (device, graph replay); eager call {call_ms:.4f} ms; '
              f'plain version {plain_ms:.3f} ms (one call); bound {bound_ms * 1e3:.3f} us '
              f'by {bound_by} ({pairs} of {all_pairs} (pixel, face) pairs can '
              f'contribute; the cull lists {listed * 100:.3f}%) [{card}]')
        entries.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': n, 'max_abs_err': err,
                        'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                        'bound_by': bound_by, 'library_ms': None})
    profile_step(lambda: grad_fn(state), 'untextured IL gradient step', card)
    bench = run_il_benchmark(scenario, policy, horizon=IL_HORIZON,
                             rollouts_per_chunk=2, n_chunks=3)
    print(f'untextured IL gradient step B={IL_BATCH} horizon {IL_HORIZON}: '
          f'{bench["grad_rollouts_per_sec_median"]:.3f} grad-rollouts/s, '
          f'{bench["env_steps_per_sec_median"]:.1f} env-steps/s median of chunks '
          f'{[round(r, 3) for r in bench["chunk_rollout_rates"]]} rollouts/s [{card}]')
    return entries


# --- the RL path (BASELINE config 5) -----------------------------------------

def rl_frame(venv, state):
    """The operands of the frame of ``state`` from the renderer's own
    preparation, ``((background, hard operands, warp operands or None),
    (mesh, cameras))``."""
    mesh, cams = venv.view(state)
    return (venv.sim.renderer.hard_frame_operands(mesh, venv.cfg.res, cams),
            (mesh, cams))


def compare_nearest(warp, mip, fcoef, icoef, res, label):
    flip = int((icoef[:, 0, 2] == 1).sum())
    return compare_exact(warp.warp_view_nearest(mip.data, fcoef, icoef, res),
                         warp.warp_view_nearest_reference(mip.data, fcoef, icoef, res),
                         f'{label} warp_nearest B={fcoef.shape[0]} res {res} '
                         f'({flip} cameras on the flip branch)')


def compare_hard(hard, ops, bg, res, label):
    """Returns the kernel's name and its largest difference."""
    kind = 'hard_raster_packed' if len(ops) == 2 else 'hard_raster_chunked'
    return kind, compare_exact(hard.raster(ops, bg, res),
                               hard.raster_reference(ops, bg, res),
                               f'{label} {kind} F={ops[1].shape[1]} B={bg.shape[0]}')


def tile_pairs(corners, valid, res) -> int:
    """(primitive, tile) pairs of a raster that tests a primitive only in
    the BOUND_TILE x BOUND_TILE pixel tiles its bounding box overlaps: the
    primitives the view needs. ``corners`` (B, N, K, 2) in screen space;
    ``valid`` (B, N) excludes the degenerate ones, which never win."""
    corners = torch.nan_to_num(corners, nan=-1e9)
    # the first and last pixel row (col) whose center the box covers
    lo = torch.ceil(corners.amin(dim=2) - 0.5).clamp(0, res).long()
    hi = torch.floor(corners.amax(dim=2) - 0.5).clamp(-1, res - 1).long()
    tiles = torch.where(lo <= hi, hi // BOUND_TILE - lo // BOUND_TILE + 1, 0).prod(dim=-1)
    return int((tiles * valid).sum())


def hard_tile_pairs(renderer, mesh, cams, valid, res) -> int:
    """:func:`tile_pairs` of the hard raster's faces."""
    from torchdrivesim_tpu_torch.ops.rasterize import camera_rows_cols, face_arrays
    rc = camera_rows_cols(mesh.verts[..., :2], cams.xy, cams.sc, cams.scale, res,
                          left_handed=renderer.cfg.left_handed_coordinates)
    corners, _, _ = face_arrays(torch.cat([rc, mesh.verts[..., 2:3]], dim=-1),
                                mesh.faces, mesh.attrs)
    return tile_pairs(corners, valid, res)


def hard_tie_operands(seed: int, b: int, n_faces: int, res: int, device):
    """
    Chunked operands whose z ties decide pixels: ``hard_operands`` of
    ``hard.random_faces``, then around every multiple k of ``FACE_CHUNK``
    below ``n_faces`` the valid faces k - 2 .. k + 1 get one z below every
    other face's, and RGB8 colors that fall as the index rises. At a pixel
    inside several of them the reference's winner is the smallest color
    among the inside tie faces of the earliest chunk that has one: a fold
    face by face with a plain ``<`` (the first inside face) or the smallest
    color over all chunks gives another. Returns ((coef, zbits, rgb),
    background) on ``device``.
    """
    from torchdrivesim_tpu_torch.ops import hard
    corners, z, colors, bg = hard.random_faces(seed, b, n_faces, res, device)
    coef, zbits, rgb = hard.hard_operands(corners, z, colors)
    ties = torch.tensor([k + d for k in range(hard.FACE_CHUNK, n_faces, hard.FACE_CHUNK)
                         for d in (-2, -1, 0, 1) if k + d < n_faces], device=device)
    tie_z = int(np.float32(0.5).view(np.int32))
    valid = zbits[:, ties] != hard.Z_SENTINEL
    zbits[:, ties] = torch.where(valid, tie_z, zbits[:, ties])
    rgb[:, ties] = (0xE00000 - ties * 0x101).to(torch.int32)
    return (coef, zbits, rgb), bg


def hard_boundary_faces(seed: int, b: int, n_faces: int, res: int, device):
    """
    Faces touching a 16 x 16 tile only at its corner pixel centre
    (:func:`_boundary_prims`' triangles: an edge value exactly 0 there, or
    inside in float32 while the float64 value is outside, the rounding the
    cull's slack covers), z on four levels, random colors and background.
    ``hard_operands`` computes the triangles' coefficients as ``prep_prims``
    does, so the same values. Returns (corners, z, colors, background) as
    ``hard.random_faces`` does.
    """
    from torchdrivesim_tpu_torch.ops import prims as P
    rng = np.random.RandomState(seed)
    corners = np.stack([_boundary_prims(P, rng, res, False, n_faces) for _ in range(b)])
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return (f(corners), f(rng.randint(0, 4, (b, n_faces)) * 2.0 + 3.0),
            f(rng.rand(b, n_faces, 3)), f(rng.rand(b, 3, res, res)))


def hard_edge_operands(device):
    """
    Hand-made operands at res 40 (one camera, 8 faces; the last tile row
    and column ragged) that the hard raster's per-tile cull must keep where
    they count, as (coef (1, 3, 8, 3), packed (1, 8), zbits (1, 8), rgb
    (1, 8)); z-bits order the faces as the packs do. Faces that win:

    * 0 (pack 5 << 24): edge 0 all zero (value 0 everywhere: only the
      strict inequality keeps it), inside rows 0-10;
    * 1 (2 << 24): px - 39.5, exactly 0 on the last row's centres (the
      clamped centre of the ragged tile row);
    * 2 (3 << 24): py - 39.5, the last column;
    * 3 (4 << 24): edge 2^-149 px - 16 * 2^-149 (subnormal products, kept
      only by delta's underflow term), inside rows 15-20;
    * 4 (7 << 24): an infinite coefficient (delta infinite, kept), inside
      rows 0-30;
    * 5 (8 << 24): all three edges zero, inside everywhere.

    Face 6 has a NaN coefficient (kept, never inside) and face 7 all-zero
    coefficients with the sentinel key, as ``hard_operands`` gives a face
    of zero area (dropped).
    """
    from torchdrivesim_tpu_torch.ops import hard
    coef = np.zeros((1, 3, 8, 3), np.float32)
    coef[0, :, :6, 2] = 1.0                          # edges inside everywhere
    coef[0, 0, 0] = 0.0
    coef[0, 1, 0] = [-1, 0, 10.5]
    coef[0, 0, 1] = [1, 0, -39.5]
    coef[0, 0, 2] = [0, 1, -39.5]
    coef[0, 0, 3] = [2.0 ** -149, 0, -16 * 2.0 ** -149]
    coef[0, 1, 3] = [-1, 0, 20.5]
    coef[0, 0, 4] = [np.inf, 0, 0]
    coef[0, 1, 4] = [-1, 0, 30.5]
    coef[0, :, 5] = 0.0
    coef[0, :, 6] = [np.nan, 0, 1]
    rank = np.array([5, 2, 3, 4, 7, 8, 1, 0])
    color = np.array([0x102030, 0x405060, 0x708090, 0xA0B0C0, 0xD0E0F0, 0x0F1F2F,
                      0x3F4F5F, 0])
    packed = (rank << 24) | color
    packed[7] = hard.PACKED_SENTINEL
    zbits = (rank + 1).astype(np.float32).view(np.int32)
    zbits[7] = hard.Z_SENTINEL
    t = lambda x: torch.as_tensor(np.asarray(x), device=device)
    return (t(coef), t(packed.astype(np.int32)[None]), t(zbits[None]),
            t(color.astype(np.int32)[None]))


def rl_compare_with_cpu(device):
    """Three steps of the RL environment at B = 2 on the card and on the
    CPU: states and rewards to 1e-4, observations >= 99.9% identical."""
    from torchdrivesim_tpu_torch.benchmark import build_rl_env
    runs = []
    rng = np.random.RandomState(0)
    actions = [torch.from_numpy(rng.uniform(-1, 1, (2, 2)).astype(np.float32))
               for _ in range(COMPARE_STEPS)]
    for dev in (device, torch.device('cpu')):
        venv = build_rl_env(batch_size=2, res=RL_RES, device=dev)
        step = venv.make_step_fn()
        state, outs = venv.initial_state, []
        for act in actions:
            state, obs, reward, done = step(state, act.to(dev))
            outs.append((state.agent_state.cpu(), obs.cpu(), reward.cpu(), done.cpu()))
        runs.append(outs)
    for i, (g, c) in enumerate(zip(*runs)):
        torch.testing.assert_close(g[0], c[0], atol=1e-4, rtol=0)
        torch.testing.assert_close(g[2], c[2], atol=1e-4, rtol=0)
        if not torch.equal(g[3], c[3]):
            raise AssertionError(f'RL step {i}: done differs')
        same = float((g[1] == c[1]).all(dim=1).float().mean())
        print(f'RL compare step {i}: {same * 100:.4f}% of observation pixels identical '
              'on the card and the CPU; states and rewards agree to 1e-4')
        if same < 0.999:
            raise AssertionError(f'RL step {i}: observations differ')


def rl_counts(warp, hard):
    return {'warp_nearest': warp.NEAREST_LAUNCHES,
            'hard_raster_packed': hard.PACKED_LAUNCHES,
            'hard_raster_chunked': hard.CHUNKED_LAUNCHES}


def rl_zero_counts(warp, hard):
    warp.NEAREST_LAUNCHES = hard.PACKED_LAUNCHES = hard.CHUNKED_LAUNCHES = 0


def rl_path(device, card):
    """The RL phases; returns the JSON entries of its three kernels."""
    from torchdrivesim_tpu_torch import rl
    from torchdrivesim_tpu_torch.benchmark import build_rl_env, run_rl_benchmark
    from torchdrivesim_tpu_torch.ops import hard, warp

    # 1. the kernels against their plain versions on random operands
    errs = {'warp_nearest': [], 'hard_raster_packed': [], 'hard_raster_chunked': []}
    for label, (m, f, i), res in (
            ('random', random_warp_operands(8, 64, 32, device), 32),
            ('random', random_warp_operands(9, 16, 128, device), 128)):
        assert int((i[:, 0, 2] == 0).sum()) > 0, 'no camera on the standard branch'
        errs['warp_nearest'].append(compare_nearest(warp, m, f, i, res, label))
    for n_faces, b in ((1, 8), (12, RL_BATCH), (127, 8), (128, 8), (129, 8), (300, 8)):
        corners, z, colors, bg = hard.random_faces(10 + n_faces, b, n_faces, RL_RES,
                                                   device)
        kind, err = compare_hard(hard, hard.hard_operands(corners, z, colors), bg,
                                 RL_RES, 'random')
        errs[kind].append(err)
    # scenes that stress the per-tile face cull: z ties across the chunk
    # boundaries, ragged last tiles, faces touching a tile only at its
    # corner pixel centre, hand-made edges
    ops, bg = hard_tie_operands(11, 2, 17000, RL_RES, device)
    kind, err = compare_hard(hard, ops, bg, RL_RES, 'cross-chunk ties')
    errs[kind].append(err)
    for (label, make), res, n_faces in (
            *((('ragged', hard.random_faces), res, n) for res in (40, 72)
              for n in (12, 300)),
            (('boundary', hard_boundary_faces), RL_RES, 48),
            (('boundary', hard_boundary_faces), 80, 300)):
        *faces, bg = make(res + n_faces, 4, n_faces, res, device)
        kind, err = compare_hard(hard, hard.hard_operands(*faces), bg, res,
                                 f'{label} res {res}')
        errs[kind].append(err)
    coef, packed, zbits, rgb = hard_edge_operands(device)
    bg = torch.rand((1, 3, 40, 40), device=device)
    for ops in ((coef, packed), (coef, zbits, rgb)):
        kind, err = compare_hard(hard, ops, bg, 40, 'hand-made edges res 40')
        errs[kind].append(err)

    # 2. a small RL step on the card against the CPU
    rl_compare_with_cpu(device)

    # 3. the main path: two full-width PPO iterations, counting launches
    venv, model, optimizer = rl.build(RL_BATCH, res=RL_RES, device=device)
    step_fn = venv.make_step_fn()
    generator = torch.Generator(device=device).manual_seed(0)
    state = venv.initial_state
    want = {'warp_nearest': 2 * RL_ROLLOUT + 1, 'hard_raster_packed': 2 * RL_ROLLOUT + 1,
            'hard_raster_chunked': 0}
    launches = None
    for it in range(RL_ITERATIONS):
        torch.cuda.synchronize()
        rl_zero_counts(warp, hard)
        t0 = time.perf_counter()
        state, batch = rl.collect(model, step_fn, state, RL_ROLLOUT, generator)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = rl_counts(warp, hard)
        for _ in range(RL_EPOCHS):
            loss, pg, v_loss = rl.ppo_update(model, optimizer, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f'RL iteration {it}: B={RL_BATCH} rollout {RL_ROLLOUT}: collect '
              f'{t1 - t0:.3f} s ({RL_BATCH * RL_ROLLOUT / (t1 - t0):.1f} env-steps/s), '
              f'{RL_EPOCHS} PPO updates {(t2 - t1) * 1e3:.1f} ms; return '
              f'{float(batch[4].mean()):.4f}, loss {float(loss):.5f} (pg '
              f'{float(pg):.5f}, value {float(v_loss):.5f}); launches per collect '
              f'{counts} [{card}]')
        if counts != want:
            raise AssertionError(f'launches per collect {counts}, expected {want}')
        if not all(math.isfinite(float(x)) for x in (loss, pg, v_loss)):
            raise AssertionError('non-finite PPO loss')
        obs = batch[0]
        if obs.shape != (RL_ROLLOUT, RL_BATCH, 3, RL_RES, RL_RES) or \
                not torch.isfinite(obs).all():
            raise AssertionError(f'observations {tuple(obs.shape)} not finite or '
                                 'of the wrong shape')
        launches = counts
    # every view shows its own car (the ego sits at the center)
    vehicle = torch.tensor(venv.sim.renderer.color_map['vehicle'],
                           dtype=torch.float32, device=device)
    on_car = ((obs[-1] - vehicle[None, :, None, None]).abs() < 0.5).all(dim=1)
    with_car = float((on_car.sum(dim=(1, 2)) >= 10).float().mean())
    print(f'{with_car * 100:.1f}% of RL views show vehicle pixels')
    if with_car < 0.9:
        raise AssertionError('RL observations do not show the vehicles')

    # 4. the kernels against their plain versions on the frame the main path
    # ended on: the sampled actions have spread the 1024 copies of the scenario
    (bg, hops, (mip, fcoef, icoef)), (mesh, cams) = rl_frame(venv, state)
    distinct = int(torch.unique(torch.cat([cams.xy, cams.sc], dim=-1), dim=0).shape[0])
    print(f'RL operands after {RL_ITERATIONS} iterations: B={RL_BATCH}, {distinct} '
          f'distinct cameras, {hops[1].shape[1]} faces per camera, texture '
          f'{tuple(mip.data.shape)} at {mip.cell_size} m')
    if distinct < RL_BATCH // 2:
        raise AssertionError(f'only {distinct} distinct cameras')
    errs['warp_nearest'].append(compare_nearest(warp, mip, fcoef, icoef, RL_RES, 'RL'))
    kind, err = compare_hard(hard, hops, bg, RL_RES, 'RL')
    errs[kind].append(err)

    # 5. the untextured environment: the whole map mesh, the chunked kernel,
    # stepped with random actions
    untextured = build_rl_env(batch_size=RL_UNTEXTURED_BATCH, res=RL_RES,
                              use_background_texture=False, device=device)
    step_u = untextured.make_step_fn()
    gen_u = torch.Generator(device=device).manual_seed(1)
    actions = [torch.rand((RL_UNTEXTURED_BATCH, 2), generator=gen_u, device=device) * 2 - 1
               for _ in range(RL_UNTEXTURED_STEPS + 1)]
    state_u, obs_u, _, _ = step_u(untextured.initial_state, actions[0])
    torch.cuda.synchronize()
    rl_zero_counts(warp, hard)
    t0 = time.perf_counter()
    for act in actions[1:]:
        state_u, obs_u, reward_u, _ = step_u(state_u, act)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / RL_UNTEXTURED_STEPS
    counts_u = rl_counts(warp, hard)
    (town_bg, town_ops, _), (town_mesh, town_cams) = rl_frame(untextured, state_u)
    print(f'untextured RL env B={RL_UNTEXTURED_BATCH}: {town_ops[1].shape[1]} faces per '
          f'camera, {step_ms:.2f} ms per step; launches over {RL_UNTEXTURED_STEPS} '
          f'steps {counts_u} [{card}]')
    if counts_u != {'warp_nearest': 0, 'hard_raster_packed': 0,
                    'hard_raster_chunked': RL_UNTEXTURED_STEPS}:
        raise AssertionError(f'untextured launches {counts_u}')
    if not torch.isfinite(obs_u).all() or not torch.isfinite(reward_u).all():
        raise AssertionError('untextured step: non-finite output')
    kind, err = compare_hard(hard, town_ops, town_bg, RL_RES, 'Town02 untextured')
    errs[kind].append(err)

    # 6. B6b's main path: one untextured collect with the RL model (after
    # one that warms up), 2 x rollout + 1 renders, counting launches
    gen_c = torch.Generator(device=device).manual_seed(2)
    state_c, _ = rl.collect(model, step_u, untextured.initial_state, RL_ROLLOUT, gen_c)
    torch.cuda.synchronize()
    rl_zero_counts(warp, hard)
    t0 = time.perf_counter()
    state_c, batch_u = rl.collect(model, step_u, state_c, RL_ROLLOUT, gen_c)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    counts_c = rl_counts(warp, hard)
    print(f'untextured RL collect B={RL_UNTEXTURED_BATCH} rollout {RL_ROLLOUT}: '
          f'{collect_s:.3f} s ({RL_UNTEXTURED_BATCH * RL_ROLLOUT / collect_s:.1f} '
          f'env-steps/s); launches per collect {counts_c} [{card}]')
    want_c = {'warp_nearest': 0, 'hard_raster_packed': 0,
              'hard_raster_chunked': 2 * RL_ROLLOUT + 1}
    if counts_c != want_c:
        raise AssertionError(f'untextured launches per collect {counts_c}, expected {want_c}')
    obs_c = batch_u[0]
    if obs_c.shape != (RL_ROLLOUT, RL_UNTEXTURED_BATCH, 3, RL_RES, RL_RES) or \
            not all(torch.isfinite(x).all() for x in batch_u):
        raise AssertionError(f'untextured collect: observations {tuple(obs_c.shape)} '
                             'or returns not finite or of the wrong shape')
    (last_bg, last_ops, _), _ = rl_frame(untextured, state_c)
    kind, err = compare_hard(hard, last_ops, last_bg, RL_RES, 'Town02 untextured collect')
    errs[kind].append(err)
    prof = profile_step(lambda: rl.collect(model, step_u, state_c, RL_ROLLOUT, gen_c),
                        'untextured RL collect', card)
    if prof is not None:
        print(f'untextured RL collect: {prof[0] / RL_ROLLOUT:.1f} device operations per '
              f'rollout step, busy {prof[1] * 100:.1f}% [{card}]')
    launches = {**launches, 'hard_raster_chunked': counts_c['hard_raster_chunked']}

    # 7. times, on this card, at the main path's operands; the bounds count
    # each face only in the tiles its bounding box overlaps
    coef, pk = hops
    b, n_faces = pk.shape
    pixels = b * RL_RES * RL_RES
    image_bytes = pixels * 3 * 4
    tcoef, tz, trgb = town_ops
    tb, tf = tz.shape
    tiles = hard.hard_tiles(RL_RES)
    pairs_a = hard_tile_pairs(venv.sim.renderer, mesh, cams, pk != hard.PACKED_SENTINEL,
                              RL_RES)
    pairs = hard_tile_pairs(untextured.sim.renderer, town_mesh, town_cams,
                            tz != hard.Z_SENTINEL, RL_RES)
    listed_a = hard.hard_tile_keep_reference(coef, pk, hard.PACKED_SENTINEL, RL_RES)
    listed = hard.hard_tile_keep_reference(tcoef, tz, hard.Z_SENTINEL, RL_RES)
    for label, n_pairs, keep, nb, nf in (('RL view', pairs_a, listed_a, b, n_faces),
                                         ('untextured view', pairs, listed, tb, tf)):
        print(f'{label}: {n_pairs / (nb * tiles):.1f} of {nf} faces per {BOUND_TILE} x '
              f'{BOUND_TILE} tile overlap it by bounding box; the plain cull '
              f'(hard_tile_keep_reference) lists {int(keep.sum()) / (nb * tiles):.1f}, '
              f'{int(keep.sum(dim=-1).max())} in the busiest tile')
    entries = []
    for name, fn, plain, reps, plain_reps, n_bytes, n_ops, source, replaces in (
            ('warp_nearest',
             lambda: warp.warp_view_nearest(mip.data, fcoef, icoef, RL_RES),
             lambda: warp.warp_view_nearest_reference(mip.data, fcoef, icoef, RL_RES),
             200, 10, nbytes(fcoef, icoef) + texel_bytes(mip, b, venv.cfg.fov)
             + image_bytes, pixels * NEAREST_PIXEL_OPS,
             'torchdrivesim_tpu_torch/csrc/warp_nearest.cu',
             'torchdrivesim_tpu/ops/pallas_warp.py:373'),
            ('hard_raster_packed',
             lambda: hard.raster_packed(coef, pk, bg, RL_RES),
             lambda: hard.raster_packed_reference(coef, pk, bg, RL_RES),
             200, 10, nbytes(coef, pk) + 2 * image_bytes,
             pairs_a * BOUND_TILE ** 2 * HARD_FACE_OPS,
             'torchdrivesim_tpu_torch/csrc/hard_raster.cu',
             'torchdrivesim_tpu/ops/pallas_rasterize.py:134'),
            ('hard_raster_chunked',
             lambda: hard.raster_chunked(tcoef, tz, trgb, town_bg, RL_RES),
             lambda: hard.raster_chunked_reference(tcoef, tz, trgb, town_bg, RL_RES),
             20, 2, nbytes(tcoef, tz, trgb) + 2 * tb * RL_RES * RL_RES * 3 * 4,
             pairs * BOUND_TILE ** 2 * HARD_CHUNKED_FACE_OPS,
             'torchdrivesim_tpu_torch/csrc/hard_raster.cu',
             'torchdrivesim_tpu/ops/pallas_rasterize.py:152')):
        ms, call_ms = graph_ms(fn, reps), cuda_ms(fn, reps)
        plain_ms = cuda_ms(plain, plain_reps)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        print(f'{name} kernel: {ms:.4f} ms (device, graph replay); eager call '
              f'{call_ms:.4f} ms; plain version {plain_ms:.3f} ms; bound '
              f'{bound_ms * 1e3:.3f} us by {bound_by} ({n_bytes / 1e6:.3f} MB, '
              f'{n_ops / 1e6:.1f} M float32 ALU operations) [{card}]')
        entries.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': launches[name],
                        'max_abs_err': max(errs[name]), 'ms': ms, 'plain_ms': plain_ms,
                        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None})
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    state, batch = rl.collect(model, step_fn, state, RL_ROLLOUT, generator)
    for _ in range(RL_EPOCHS):
        rl.ppo_update(model, optimizer, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    print(f'RL iteration peak memory above the resident environment: '
          f'{peak / 2**20:.1f} MiB [{card}]')
    del batch
    prof = profile_step(lambda: rl.collect(model, step_fn, venv.initial_state,
                                           RL_ROLLOUT, generator), 'RL collect', card)
    if prof is not None:
        n_ops, busy = prof
        print(f'RL collect: {n_ops / RL_ROLLOUT:.1f} device operations per rollout step '
              f'({n_ops / (2 * RL_ROLLOUT + 1):.1f} per environment step call), busy '
              f'{busy * 100:.1f}% [{card}]')
    bench = run_rl_benchmark(venv, model, optimizer, rollout=RL_ROLLOUT,
                             epochs=RL_EPOCHS, n_chunks=3)
    print(f'RL B={RL_BATCH} rollout {RL_ROLLOUT}: collect '
          f'{bench["collect_env_steps_per_sec_median"]:.1f} env-steps/s median of chunks '
          f'{[round(r, 1) for r in bench["chunk_collect_rates"]]}; PPO update '
          f'{bench["ppo_update_ms_median"]:.2f} ms median, iteration updates '
          f'{[round(r, 2) for r in bench["chunk_ppo_iteration_ms"]]} ms [{card}]')
    return entries



# --- the primitive raster: untextured and wide-view renders ------------------

def untextured_renderer(scenario, device):
    """A renderer like the scenario's, without its texture."""
    from torchdrivesim_tpu_torch.rendering.renderer import Renderer
    r = scenario.sim.renderer
    return Renderer(r.cfg, device, color_map=r.color_map,
                    rendering_levels=r.rendering_levels, res=r.res,
                    fov=2.0 / r.scale)


def prim_compare_with_cpu(device):
    """At B = 4 on the card and on the CPU: three steps of the untextured
    primitive render at res 128 and the wide view of ``Simulator.render``
    at res 64, fov 400 m; images >= 99.9% identical pixels."""
    from torchdrivesim_tpu_torch.benchmark import build_benchmark_scenario
    from torchdrivesim_tpu_torch.utils import Resolution
    runs = {}
    for dev in (device, torch.device('cpu')):
        scn = build_benchmark_scenario(batch_size=COMPARE_BATCH, agent_count=AGENTS,
                                       res=RES, fov=FOV, device=dev)
        plain = untextured_renderer(scn, dev)
        step = scn.make_step_fn(render=False, metrics=False)
        state = scn.sim.state
        action = torch.zeros((COMPARE_BATCH, AGENTS, 2), device=dev)
        images = []
        for _ in range(COMPARE_STEPS):
            state, _ = step(state, action)
            prims, cams = prim_frame(scn, state, FOV)
            images.append(plain.render_prims_chw(*prims, Resolution(RES, RES), cams).cpu())
        ego = scn.sim.state.agent_state[:, 0]
        images.append(scn.sim.render(ego[:, :2], ego[:, 2:3], res=Resolution(WIDE_RES, WIDE_RES),
                                     fov=WIDE_FOV)[:, 0].cpu())
        runs[dev.type] = images
    for i, (g, c) in enumerate(zip(runs['cuda'], runs['cpu'])):
        label = f'untextured step {i}' if i < COMPARE_STEPS else 'wide view'
        same = float((g == c).all(dim=1).float().mean())
        print(f'prim compare {label}: {same * 100:.4f}% of pixels identical on the '
              'card and the CPU')
        if same < 0.999:
            raise AssertionError(f'prim compare {label}: images differ')


def prim_valid(corners):
    """(B, N): the prep's degenerate test on screen-space corners."""
    e1 = corners[:, :, 1] - corners[:, :, 0]
    e2 = corners[:, :, -1] - corners[:, :, 0]
    return (e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]).abs() > 1e-9


def prim_bound(ops, scene, res, background_bytes):
    """Bound of the prim raster on the screen-space ``scene``: the image
    written, the background and the operands ``ops`` read; per pixel the
    composite, and each quad's or triangle's test only in the tiles its
    bounding box overlaps (:func:`tile_pairs`), with or without masks."""
    quads, tris = scene[0], scene[3]
    b = quads.shape[0]
    tile = BOUND_TILE ** 2
    q_pairs = tile_pairs(quads, prim_valid(quads), res)
    t_pairs = tile_pairs(tris, prim_valid(tris), res)
    n_ops = b * res * res * PRIM_PIXEL_OPS \
        + tile * (PRIM_QUAD_OPS * q_pairs + PRIM_TRI_OPS * t_pairs)
    n_bytes = b * 3 * res * res * 4 + background_bytes + nbytes(*ops)
    n_tiles = b * (res // BOUND_TILE) ** 2
    print(f'  bound: {q_pairs / n_tiles:.2f} quads and {t_pairs / n_tiles:.2f} triangles '
          f'per {BOUND_TILE} x {BOUND_TILE} tile overlap it by bounding box; '
          f'{n_bytes / 1e6:.3f} MB, {n_ops / 1e6:.1f} M float32 ALU operations')
    return bound(n_bytes, n_ops)


#: scenes that stress the primitive winner's per-tile cull (``prim_cull_scene``)
PRIM_CULL_KINDS = ('boundary', 'parallelogram', 'near_degenerate', 'larger_than_view')


def _boundary_candidates(rng, res, quad, n):
    """``n`` candidate prims that touch one 16 x 16 tile only at its corner
    pixel centre P: (corners (n, K, 2), P (2,), the tile's first row and
    column). A triangle has its apex on P and one edge along a line that
    meets the tile only at P; a parallelogram has P as its corner 0 (its
    first coordinate -0.5 there) or as the corner opposite (+0.5), with the
    same line as its side. Candidate 0 has dyadic sides from P exactly,
    so its value at P is exactly 0 or +-0.5; the others have random sides
    and P moved by up to 3 ulp, so the float32 value at P lands on either
    side of the float64 one."""
    per = res // 16
    if rng.rand() < 0.25:                   # near the origin: fine float32 steps
        r0 = c0 = 0
        sx = sy = -1.0
    else:
        r0, c0 = rng.randint(per) * 16, rng.randint(per) * 16
        sx, sy = rng.choice([-1.0, 1.0], 2)
    p = np.array([r0 + (15.5 if sx > 0 else 0.5), c0 + (15.5 if sy > 0 else 0.5)],
                 np.float32)
    out = np.array([sx, sy])                # away from the tile, both axes
    side = np.array([sx, -sy])              # the line through P alone
    dyadic = np.arange(n) == 0
    j = np.where(dyadic, 2.0 ** rng.randint(1, 4, n), rng.uniform(3, 30, n))[:, None]
    k = np.where(dyadic, 2.0 ** rng.randint(1, 4, n), rng.uniform(3, 30, n))[:, None]
    turn = np.where(dyadic[:, None], 1.0, rng.uniform(0.3, 1.0, (n, 2)))
    u = out * turn                          # outward
    v = side * np.where(dyadic[:, None], 1.0, rng.uniform(0.3, 1.0, (n, 2)))
    steps = np.where(dyadic[:, None], 0, rng.randint(-3, 4, (n, 2)))
    p32 = (p + steps * np.spacing(p)).astype(np.float32)     # exact: a few ulp
    if quad:
        far = rng.rand(n) < 0.5             # P is the corner opposite corner 0
        q0 = np.where(far[:, None], p32 + j * u, p32)
        e1 = np.where(far[:, None], -j * u, j * u)
        e2 = k * v
        corners = np.stack([q0, q0 + e1, q0 + e1 + e2, q0 + e2], axis=1)
    else:
        corners = np.stack([p32, p32 + k * v, p32 + j * u], axis=1)
    return corners.astype(np.float32), p, (r0, c0)


def _critical(prims_mod, corners, p, tile, quad):
    """Per candidate: inside at P by the plain float32 arithmetic while one
    affine value is outside over the whole tile by float64 with no slack
    (the cull would drop it without delta), and the float32 values at P."""
    from torchdrivesim_tpu_torch.ops import warp
    n = corners.shape[0]
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    ones = lambda *shape: t(np.ones((n, 1) + shape))
    c = t(corners[:, None])
    quads, tris = (c, t(np.zeros((n, 1, 3, 2)))) if quad else (t(np.zeros((n, 1, 4, 2))), c)
    qcoef, qpk, tcoef, tpk = prims_mod.prep_prims(quads, ones(), ones(3), tris, ones(),
                                                  ones(3))
    coef = (qcoef if quad else tcoef)[:, :, 0]              # (n, E, 3)
    valid = ((qpk if quad else tpk)[:, 0, 0] != prims_mod.SENTINEL).numpy()
    px, py = t(p[0]), t(p[1])
    e32 = warp.affine(coef[..., 0], px, coef[..., 1], py, coef[..., 2])
    inside = ((e32.abs() <= 0.5) if quad else (e32 >= 0)).all(dim=1).numpy()
    a, b, k = (coef[..., j].double() for j in range(3))
    x = torch.tensor([float(tile[0]) + 0.5, float(tile[0]) + 15.5], dtype=torch.float64)
    y = torch.tensor([float(tile[1]) + 0.5, float(tile[1]) + 15.5], dtype=torch.float64)
    top = (torch.maximum(a * x[0], a * x[1]) + torch.maximum(b * y[0], b * y[1])) + k
    bottom = (torch.minimum(a * x[0], a * x[1]) + torch.minimum(b * y[0], b * y[1])) + k
    out = ((top < -0.5) | (bottom > 0.5)) if quad else (top < 0)
    return inside & valid & out.any(dim=1).numpy(), e32.numpy()


def _boundary_prims(prims_mod, rng, res, quad, count, candidates=24):
    """(count, K, 2) corners of boundary prims (see
    :func:`_boundary_candidates`): a third the dyadic candidate, the rest a
    candidate that is inside at P in float32 and outside over the tile in
    float64 without the slack (one whose float32 value at P is
    nextafter(+-0.5, 0) first), where one exists."""
    picked = []
    for _ in range(count):
        corners, p, tile = _boundary_candidates(rng, res, quad, candidates)
        crit, e32 = _critical(prims_mod, corners, p, tile, quad)
        after = (np.abs(e32) == np.nextafter(np.float32(0.5), np.float32(0))).any(axis=1)
        if rng.rand() < 1 / 3 or not crit.any():
            picked.append(corners[0])
        else:
            picked.append(corners[int(np.argmax(crit & after if quad and (crit & after).any()
                                                else crit))])
    return np.stack(picked)


def prim_cull_scene(kind: str, seed: int, b: int, res: int, device, q: int = 24,
                    t: int = 24):
    """
    A screen-space scene of ``b`` cameras, ``q`` quads and ``t`` triangles
    each (as ``ops.prims.random_prims`` gives one, z on 4 levels, a random
    background), made from numpy with ``seed``, that stresses the
    primitive winner's per-tile cull:

    * ``boundary``: prims touching a 16 x 16 tile only at its corner pixel
      centre, where an affine value is exactly 0 or +-0.5 (dyadic sides),
      or nextafter(+-0.5, 0), or lands inside in float32 while the float64
      value is outside (the rounding the cull's slack covers);
    * ``parallelogram``: half the quads with corner 2 far from c1 + c3 -
      c0, so the accepted region (the parallelogram on corners 0, 1 and 3)
      leaves the corners' bounding box and the band masks built from it;
    * ``near_degenerate``: half the prims tiny, at pixel centres, with
      |cross| a few times 1e-9 (coefficients up to ~1e8);
    * ``larger_than_view``: a quarter of the prims reaching far beyond the
      view on every side.

    Outside ``boundary`` the rest are ``random_prims``' prims, whose z,
    colors and background every kind takes. Returns (quads, qz, qcolors,
    tris, tz, tcolors, background) float32 on ``device``.
    """
    from torchdrivesim_tpu_torch.ops import prims as P
    rng = np.random.RandomState(seed)
    *scene, bg = P.random_prims(seed + 1, b, q, t, res, 'cpu')
    quads, tris = scene[0].numpy().copy(), scene[3].numpy().copy()
    if kind == 'boundary':
        quads = np.stack([_boundary_prims(P, rng, res, True, q) for _ in range(b)])
        tris = np.stack([_boundary_prims(P, rng, res, False, t) for _ in range(b)])
    elif kind == 'parallelogram':
        h = q // 2
        quads[:, :h, 2] = quads[:, :h, 0] + rng.uniform(-0.5, 0.5, (b, h, 2)) * res
    elif kind == 'near_degenerate':
        for arr, n in ((quads, q // 2), (tris, t // 2)):
            c0 = (rng.randint(0, res, (b, n, 2)) + 0.5
                  + rng.uniform(-0.3, 0.3, (b, n, 2))).astype(np.float32)
            c0[:, : n // 2] %= 16.0           # near the origin: finer float32 steps
            ang = rng.uniform(0, 2 * np.pi, (b, n))
            u = np.stack([np.cos(ang), np.sin(ang)], -1)
            w = np.stack([-u[..., 1], u[..., 0]], -1)
            r1 = rng.uniform(1e-3, 1e-2, (b, n, 1))
            r2 = rng.uniform(2e-9, 8e-9, (b, n, 1)) / r1
            if arr.shape[2] == 4:
                arr[:, :n] = np.stack([c0, c0 + r1 * u, c0 + r1 * u + r2 * w,
                                       c0 + r2 * w], axis=2)
            else:
                arr[:, :n] = np.stack([c0, c0 + r1 * u, c0 + 0.5 * r1 * u + r2 * w],
                                      axis=2)
    elif kind == 'larger_than_view':
        for arr, n in ((quads, q // 4), (tris, t // 4)):
            ang = rng.uniform(0, 2 * np.pi, (b, n))
            u = np.stack([np.cos(ang), np.sin(ang)], -1) * res * rng.uniform(4, 8, (b, n, 1))
            w = np.stack([-u[..., 1], u[..., 0]], -1) * rng.uniform(0.5, 1.5, (b, n, 1))
            mid = rng.uniform(0, res, (b, n, 2))
            if arr.shape[2] == 4:
                c0 = mid - 0.5 * (u + w)
                arr[:, :n] = np.stack([c0, c0 + u, c0 + u + w, c0 + w], axis=2)
            else:
                arr[:, :n] = np.stack([mid - u, mid + u + w, mid + u - w], axis=2)
    else:
        raise ValueError(f'unknown scene kind {kind!r}')
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return (f(quads), scene[1].to(device), scene[2].to(device), f(tris),
            scene[4].to(device), scene[5].to(device), bg.to(device))


def prim_edge_operands(device):
    """
    Hand-made prepared operands at res 32 (one camera, 8 quad and 8
    triangle slots, the rest sentinel, no masks) that the primitive
    winner's per-tile cull must keep where they count:

    * triangle 0 (pack 5 << 24): edge 0 all zero (value 0 everywhere, so
      only the strict inequality keeps it), the others inside rows 0-10;
    * quad 0 (9 << 24): the constant coordinates +0.5 and -0.5, inside
      everywhere;
    * triangle 1 (1 << 24) with a NaN and quad 1 (2 << 24) with an infinite
      coefficient: kept, never winning;
    * triangle 2 (4 << 24): edge 0 = 2^-149 px - 16 * 2^-149, subnormal
      products: in float32 it is 0 at row 15 (15.5 * 2^-149 rounds to 16 *
      2^-149) and inside from there on, while its float64 maximum over rows
      0-15 is -2^-150 (only the underflow term of delta keeps it there).

    Returns (qcoef, qpk, tcoef, tpk) on ``device``.
    """
    f32 = np.float32
    qcoef = np.zeros((1, 2, 8, 3), f32)
    tcoef = np.zeros((1, 3, 8, 3), f32)
    qpk = np.full((1, 8, 1), 0x7FFFFFFF, np.int32)
    tpk = np.full((1, 8, 1), 0x7FFFFFFF, np.int32)
    tcoef[0, 1, 0] = [-1, 0, 10.5]
    tcoef[0, 2, 0] = [0, 0, 1]
    tpk[0, 0, 0] = 5 << 24
    qcoef[0, 0, 0] = [0, 0, 0.5]
    qcoef[0, 1, 0] = [0, 0, -0.5]
    qpk[0, 0, 0] = (9 << 24) | 0x102030
    tcoef[0, :, 1] = [np.nan, 0, 1]
    tpk[0, 1, 0] = 1 << 24
    qcoef[0, :, 1] = [np.inf, 0, 0]
    qpk[0, 1, 0] = 2 << 24
    tcoef[0, 0, 2] = [2.0 ** -149, 0, -16 * 2.0 ** -149]
    tcoef[0, 1:, 2] = [0, 0, 1]
    tpk[0, 2, 0] = (4 << 24) | 0x405060
    return tuple(torch.as_tensor(x, device=device) for x in (qcoef, qpk, tcoef, tpk))


def prim_cull_operands(scene, res):
    """The banded raster's operands of a screen-space scene: each type
    row-major sorted (cap 56) with its band masks, then ``prep_prims``;
    (qcoef, qpk, tcoef, tpk, qmask, tmask), the masks padded to the
    prepared chunks."""
    from torchdrivesim_tpu_torch.ops import prims as P
    from torchdrivesim_tpu_torch.ops.rasterize import (
        n_bands_for, sort_prims_rowmajor_with_masks)
    n_bands = n_bands_for(res)
    sq, sqz, sqc, qm = sort_prims_rowmajor_with_masks(*scene[:3], res, 56, n_bands)
    st, stz, stc, tm = sort_prims_rowmajor_with_masks(*scene[3:6], res, 56, n_bands)
    qcoef, qpk, tcoef, tpk = P.prep_prims(sq, sqz, sqc, st, stz, stc)
    return (qcoef, qpk, tcoef, tpk, P._pad_masks(qm, qpk.shape[1] // 8),
            P._pad_masks(tm, tpk.shape[1] // 8))


def compare_prims(prims_mod, scene, bg, res, label, masks_cover=True):
    """B7 on the scene row-major sorted with its masks and B8 on the scene
    as given, against the plain versions, and, where the band masks cover
    every prim (not so for parallelograms whose corner 2 is off), B8 on the
    sorted scene against B7; returns the largest differences (B7, B8)."""
    from torchdrivesim_tpu_torch.ops.rasterize import (
        n_bands_for, sort_prims_rowmajor_with_masks)
    n_bands = n_bands_for(res)
    sq, sqz, sqc, qm = sort_prims_rowmajor_with_masks(*scene[:3], res, 56, n_bands)
    st, stz, stc, tm = sort_prims_rowmajor_with_masks(*scene[3:], res, 56, n_bands)
    banded = (sq, sqz, sqc, st, stz, stc, res, bg, qm, tm)
    b7 = prims_mod.rasterize_hard_prims_banded(*banded)
    e7 = compare_exact(b7, prims_mod.rasterize_hard_prims_banded_reference(*banded),
                       f'{label} prim_raster_banded B={bg.shape[0]} res {res}')
    e8 = compare_exact(prims_mod.rasterize_hard_prims(*scene, res, bg),
                       prims_mod.rasterize_hard_prims_reference(*scene, res, bg),
                       f'{label} prim_raster B={bg.shape[0]} res {res}')
    if masks_cover:
        compare_exact(prims_mod.rasterize_hard_prims(*banded[:8]), b7,
                      f'{label} prim_raster on the sorted prims against prim_raster_banded')
    return e7, e8


def prim_path(device, card, scenario, state):
    """The primitive raster's phases on the headline scenario and the state
    its main path ended on; returns the JSON entries of B7 and B8."""
    from torchdrivesim_tpu_torch.ops import fused
    from torchdrivesim_tpu_torch.ops import prims as P
    from torchdrivesim_tpu_torch.ops.rasterize import n_bands_for
    from torchdrivesim_tpu_torch.utils import Resolution
    errs = {'b7': [], 'b8': []}

    def record(e):
        errs['b7'].append(e[0])
        errs['b8'].append(e[1])

    # 1. the kernels against their plain versions: random scenes (ties on
    # one z level, dense bands, an expanded color background), then the
    # headline's frame
    for res, b, q, t, kind in ((16, 8, 10, 6, 'random'), (64, 64, 30, 12, 'one z level'),
                               (128, 16, 44, 20, 'random'), (128, 8, 56, 8, 'dense band'),
                               (256, 4, 44, 20, 'color background')):
        *scene, bg = P.random_prims(res + q, b, q, t, res, device,
                                    z_levels=1 if kind == 'one z level' else 4,
                                    rows=(40.0, 52.0) if kind == 'dense band' else None)
        if kind == 'color background':
            bg = torch.rand(b, 3, device=device)[:, :, None, None].expand(b, 3, res, res)
        record(compare_prims(P, scene, bg, res, f'random ({kind})'))
    for i, kind in enumerate(PRIM_CULL_KINDS):
        for res in (80, 144):
            *scene, bg = prim_cull_scene(kind, 60 + i, 8, res, device)
            record(compare_prims(P, scene, bg, res, f'{kind} scene',
                                 masks_cover=kind != 'parallelogram'))
    edge = prim_edge_operands(device)
    edge_bg = torch.rand(1, 3, 32, 32, device=device)
    errs['b8'].append(compare_exact(P.raster_prims(*edge, edge_bg, 32),
                                    P.raster_prims_reference(*edge, edge_bg, 32),
                                    'hand-made edge prims (prim_edge_operands)'))
    plain = untextured_renderer(scenario, device)
    headline_world, headline_cams = prim_frame(scenario, state, FOV)
    quads, qz, qc, tris, tz, tc = headline_world
    sq, st = plain.screen_prims(quads, tris, RES, headline_cams)
    print(f'headline prims: {qz.shape[1]} quads, {tz.shape[1]} triangles per camera, '
          f'B={qz.shape[0]}')
    headline_scene = (sq, qz, qc, st, tz, tc)
    scene_h, bg, hqm, htm = plain.banded_frame_operands(*headline_world, RES,
                                                        headline_cams)
    record(compare_prims(P, headline_scene, bg, RES, 'headline frame'))

    # 2. a small run on the card against the CPU
    prim_compare_with_cpu(device)

    # 3. the untextured primitive render, 100 steps at full width
    step = scenario.make_step_fn(render=False, metrics=False)
    action = torch.zeros((BATCH, AGENTS, 2), device=device)
    st_u = scenario.sim.state
    stage_s = 0.0
    P.B7_LAUNCHES = P.B8_LAUNCHES = fused.LAUNCHES = 0
    for _ in range(UNTEXTURED_STEPS):
        st_u, _ = step(st_u, action)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        world, cams = prim_frame(scenario, st_u, FOV)
        image = plain.render_prims_chw(*world, Resolution(RES, RES), cams)
        torch.cuda.synchronize()
        stage_s += time.perf_counter() - t0
    launches_u = {'b7': P.B7_LAUNCHES, 'b8': P.B8_LAUNCHES, 'fused': fused.LAUNCHES}
    print(f'untextured prim render: {UNTEXTURED_STEPS} steps at B={BATCH} res {RES}, '
          f'generate_prims + render_prims_chw {stage_s * 1e3 / UNTEXTURED_STEPS:.3f} ms '
          f'per step (host clock between syncs); launches {launches_u} [{card}]')
    if launches_u != {'b7': UNTEXTURED_STEPS, 'b8': 0, 'fused': 0}:
        raise AssertionError(f'untextured launches {launches_u}')
    if image.shape != (BATCH, 3, RES, RES) or not torch.isfinite(image).all():
        raise AssertionError('untextured images not finite or of the wrong shape')
    vehicle = torch.tensor(plain.color_map['vehicle'], dtype=torch.float32, device=device)
    on_car = ((image - vehicle[None, :, None, None]).abs() < 0.5).all(dim=1)
    with_car = float((on_car.sum(dim=(1, 2)) >= 10).float().mean())
    print(f'{with_car * 100:.1f}% of untextured views show vehicle pixels')
    if with_car < 0.9:
        raise AssertionError('untextured images do not show the vehicles')

    # 4. the wide view through Simulator.render: full-resolution background
    sim = scenario.sim
    ego = sim.state.agent_state[:, 0]
    P.B7_LAUNCHES = P.B8_LAUNCHES = fused.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wide = sim.render(ego[:, :2], ego[:, 2:3], res=Resolution(WIDE_RES, WIDE_RES),
                      fov=WIDE_FOV)
    torch.cuda.synchronize()
    wide_ms = (time.perf_counter() - t0) * 1e3
    launches_w = {'b7': P.B7_LAUNCHES, 'b8': P.B8_LAUNCHES, 'fused': fused.LAUNCHES}
    color = torch.tensor(sim.renderer.get_color('background'), dtype=torch.float32,
                         device=device)
    bg_share = float((wide[:, 0] == color[None, :, None, None]).all(dim=1).float().mean())
    print(f'wide view Simulator.render B={BATCH} res {WIDE_RES} fov {WIDE_FOV:g} m: '
          f'{wide_ms:.3f} ms (host clock, first call); launches {launches_w}; '
          f'{bg_share * 100:.1f}% of pixels in the background color [{card}]')
    if launches_w != {'b7': 1, 'b8': 0, 'fused': 0}:
        raise AssertionError(f'wide-view launches {launches_w}')
    if not torch.isfinite(wide).all() or not 0.0 < bg_share < 1.0:
        raise AssertionError('wide view: non-finite, or all or none in the background color')

    # 5. B8 at full width on the headline's unsorted prims
    P.B7_LAUNCHES = P.B8_LAUNCHES = 0
    b8_image = P.rasterize_hard_prims(*headline_scene, RES, bg)
    torch.cuda.synchronize()
    launches_b8 = P.B8_LAUNCHES
    print(f'prim_raster on the headline frame: {launches_b8} launch')
    if launches_b8 != 1 or P.B7_LAUNCHES != 0 or not torch.isfinite(b8_image).all():
        raise AssertionError('B8 run')

    # 6. times and bounds, on this card
    # B7 at the last untextured step's frame, B8 at the headline frame
    scene_u, bg_u, qm, tm = plain.banded_frame_operands(*world, RES, cams)
    ops7 = P.prep_prims(*scene_u) + (qm, tm)
    ops8 = P.prep_prims(*headline_scene)
    wide_world, wide_cams = prim_frame(scenario, sim.state, WIDE_FOV)
    wide_scene, wide_bg, wqm, wtm = sim.renderer.banded_frame_operands(
        *wide_world, WIDE_RES, wide_cams)
    ops_w = P.prep_prims(*wide_scene) + (wqm, wtm)
    live = float(((qm != 0).sum() + (tm != 0).sum()) / qm.shape[0] / qm.shape[1])
    print(f'untextured frame: {n_bands_for(RES)} bands, {live:.2f} live chunks per band '
          f'of {qm.shape[3] + tm.shape[3]}')
    print(occupancy_line('prim_raster', P.occupancy, ops7[1].shape[1], ops7[3].shape[1],
                         BATCH * (RES // BOUND_TILE) ** 2 // 8))
    entries = []
    for name, fn, plain_fn, ops, scene, bg_bytes, source, replaces, err, n in (
            ('prim_raster_banded',
             lambda: P.raster_prims(*ops7[:4], bg_u, RES, *ops7[4:]),
             lambda: P.raster_prims_reference(*ops7[:4], bg_u, RES, *ops7[4:]),
             ops7, scene_u, BATCH * 3 * 4,
             'torchdrivesim_tpu_torch/csrc/prim_raster.cu',
             'torchdrivesim_tpu/ops/pallas_rasterize.py:336', max(errs['b7']),
             launches_u['b7']),
            ('prim_raster',
             lambda: P.raster_prims(*ops8, bg, RES),
             lambda: P.raster_prims_reference(*ops8, bg, RES),
             ops8, headline_scene, BATCH * 3 * 4,
             'torchdrivesim_tpu_torch/csrc/prim_raster.cu',
             'torchdrivesim_tpu/ops/pallas_rasterize.py:303', max(errs['b8']),
             launches_b8)):
        ms, call_ms = graph_ms(fn, 50), cuda_ms(fn, 50)
        plain_ms = cuda_ms(plain_fn, 5)
        bound_ms, bound_by = prim_bound(ops, scene, RES, bg_bytes)
        listed_q, listed_t = listed_pairs(ops[:4], *(ops[4:] or (None, None)), RES)
        print(f'  plain cull: {listed_q:.3f} quads and {listed_t:.3f} triangles listed per tile')
        print(f'{name} kernel B={BATCH} res={RES}: {ms:.4f} ms (device, graph replay); '
              f'eager call {call_ms:.4f} ms; plain version {plain_ms:.3f} ms; bound '
              f'{bound_ms * 1e3:.3f} us by {bound_by} [{card}]')
        entries.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': n, 'max_abs_err': err,
                        'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                        'bound_by': bound_by, 'library_ms': None})
    # B7 on the headline frame, whose fused render (B1) headline() timed,
    # and on the wide view
    ops_h = P.prep_prims(*scene_h) + (hqm, htm)
    floor_ms = graph_ms(lambda: P.raster_prims(*ops_h[:4], bg, RES, torch.zeros_like(hqm),
                                               torch.zeros_like(htm)), 50)
    out = torch.empty((BATCH, 3, RES, RES), device=device)
    fill_ms = graph_ms(lambda: out.fill_(0.5), 50)
    print(f'prim_raster_banded on the headline frame with both masks zeroed (no '
          f'primitive tested): {floor_ms:.4f} ms; fill_ of its float32 output '
          f'{fill_ms:.4f} ms (device, graph replay) [{card}]')
    for label, ops, scene, res, bgx, bg_bytes in (
            ('the headline frame', ops_h, scene_h, RES, bg, BATCH * 3 * 4),
            ('the wide view', ops_w, wide_scene, WIDE_RES, wide_bg, nbytes(wide_bg))):
        ms = graph_ms(lambda: P.raster_prims(*ops[:4], bgx, res, *ops[4:]), 50)
        bound_ms, bound_by = prim_bound(ops, scene, res, bg_bytes)
        live = float(((ops[4] != 0).sum() + (ops[5] != 0).sum()) / BATCH / ops[4].shape[1])
        listed_q, listed_t = listed_pairs(ops[:4], ops[4], ops[5], res)
        print(f'prim_raster_banded on {label} B={BATCH} res {res}: {ms:.4f} ms (device, '
              f'graph replay), {live:.2f} live chunks per band, {listed_q:.3f} quads and '
              f'{listed_t:.3f} triangles listed per tile by the plain cull; bound '
              f'{bound_ms * 1e3:.3f} us by {bound_by} [{card}]')
    return entries


# --- BASELINE config 3 and the res-256 headline ------------------------------

def check_frames(out, renderer, b, res, label):
    """The main path's last outputs: finite, images of the right shape, and
    at least 90% of the views show vehicle pixels."""
    for k, v in out.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f'{label} {k}: non-finite values')
    image = out['image']
    if image.shape != (b, 3, res, res):
        raise AssertionError(f'{label}: image shape {tuple(image.shape)}')
    vehicle = torch.tensor(renderer.color_map['vehicle'], dtype=torch.float32,
                           device=image.device)
    on_car = ((image - vehicle[None, :, None, None]).abs() < 0.5).all(dim=1)
    with_car = float((on_car.sum(dim=(1, 2)) >= 10).float().mean())
    print(f'{label}: {with_car * 100:.1f}% of views show vehicle pixels')
    if with_car < 0.9:
        raise AssertionError(f'{label}: images do not show the vehicles')


def fused_main_path(scenario, label, card):
    """``MAIN_STEPS`` steps of the scenario with zero actions, counting
    B1's launches (one per step required); returns (launches, the state
    the path ended on, the step function, the action)."""
    from torchdrivesim_tpu_torch.ops import fused
    sim = scenario.sim
    step = scenario.make_step_fn(render=True, metrics=True)
    action = torch.zeros((sim.batch_size, sim.agent_count, sim.action_size),
                         device=sim.device)
    state = sim.state
    fused.LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(MAIN_STEPS):
        state, out = step(state, action)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = fused.LAUNCHES
    print(f'{label} main path: {MAIN_STEPS} steps at B={sim.batch_size} in {main_s:.2f} s, '
          f'fused_render launches {launches} [{card}]')
    if launches != MAIN_STEPS:
        raise AssertionError(f'{label}: expected {MAIN_STEPS} kernel launches, got {launches}')
    check_frames(out, sim.renderer, sim.batch_size, scenario.res, label)
    return launches, state, step, action


def fused_numbers(scenario, state, step, action, label, entry_name, errs, launches,
                  card):
    """B1's time (graph replay), eager call, plain version and bound on the
    frame of ``state``, the step's device operations, and
    ``run_benchmark``'s env-steps/s; returns B1's JSON entry."""
    from torchdrivesim_tpu_torch.benchmark import run_benchmark
    from torchdrivesim_tpu_torch.ops import fused
    mip, ops, res, n, screen, _ = fused_frame(scenario, state)
    b = ops[0].shape[0]
    kernel_ms = graph_ms(lambda: fused.render_coefs_fused(mip, *ops, res), 50)
    call_ms = cuda_ms(lambda: fused.render_coefs_fused(mip, *ops, res), 50)
    plain_ms = cuda_ms(lambda: fused.render_coefs_fused_reference(mip, *ops, res), 5)
    packed_ms = graph_ms(lambda: fused.render_coefs_fused(mip, *ops, res, True), 50)
    bound_ms, bound_by = fused_bound(mip, ops, screen, res, scenario.fov / n)
    listed_q, listed_t = listed_pairs(ops[2:6], ops[6], ops[7], res)
    step_ops = device_ops(lambda: step(state, action))
    print(f'{label}: fused_render kernel {b} views of {res} px ({n} x {n} per camera): '
          f'float out {kernel_ms:.4f} ms, packed out {packed_ms:.4f} ms (device, graph '
          f'replay); eager call {call_ms:.4f} ms; plain version {plain_ms:.3f} ms; bound '
          f'{bound_ms * 1e3:.2f} us by {bound_by}; plain cull lists {listed_q:.3f} quads '
          f'and {listed_t:.3f} triangles per {BOUND_TILE} x {BOUND_TILE} tile; '
          f'{step_ops} device ops per env step [{card}]')
    bench = run_benchmark(scenario, steps_per_chunk=100, n_chunks=3)
    print(f'{label} env step B={scenario.sim.batch_size} res={scenario.res} '
          f'render+metrics: {bench["env_steps_per_sec_median"]:.1f} env-steps/s median '
          f'of chunks {[round(r, 1) for r in bench["chunk_rates"]]} [{card}]')
    return {'name': entry_name, 'route': 'cuda',
            'source': 'torchdrivesim_tpu_torch/csrc/fused_render.cu',
            'replaces': 'torchdrivesim_tpu/ops/pallas_fused.py:69',
            'launches': launches, 'max_abs_err': max(errs), 'ms': kernel_ms,
            'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': None}


def config3_path(device, card):
    """BASELINE config 3 (Town10HD, B = 64, 20 agents of three kinematic
    models, res 128, textured, all metrics): B1 against its plain version on
    the first and the last frame, the first steps against the CPU with
    seeded 4-wide actions, ``MAIN_STEPS`` steps with zero actions (the
    simple agents stay put) counting B1's launches, one compound kinematic
    step captured in a CUDA graph (it fails on a host sync) and replayed
    against the eager step, times and env-steps/s; returns B1's JSON entry
    on this path."""
    from torchdrivesim_tpu_torch import kinematic as K
    from torchdrivesim_tpu_torch.benchmark import build_config3_scenario
    from torchdrivesim_tpu_torch.ops import fused

    # 1. B1 against its plain version on the first frame
    scenario = build_config3_scenario(batch_size=C3_BATCH, agent_count=AGENTS, res=RES,
                                      fov=FOV, device=device)
    sim = scenario.sim
    km = sim.kinematic_model
    ids = km.model_assignments
    shares = {mid: float((ids == mid).float().mean()) for mid in km.models_in_use}
    print(f'config 3: carla_Town10HD B={C3_BATCH}, models in use {km.models_in_use} '
          f'with shares {shares}, action width {sim.action_size}')
    mip, ops, res, n, _, (n_quads, n_tris) = fused_frame(scenario, sim.state)
    print(f'config 3 frame: {n_quads} quads and {n_tris} triangles per camera (per-type '
          f'cap {sim.renderer._prim_cap}); qcoef {tuple(ops[2].shape)}, tcoef '
          f'{tuple(ops[4].shape)}, texture {tuple(mip.data.shape)} at {mip.cell_size} m')
    if n != 1 or res != RES:
        raise AssertionError(f'config 3 frame rendered as {n} x {n} views of {res}')
    errs = [compare_fused(fused, mip, ops, 'config 3 first frame', res)]

    # 2. the first steps on the card against the CPU, seeded 4-wide actions
    compare_with_cpu(build_config3_scenario, 'config 3 compare', seeded=True, rtol=1e-4)

    # 3. the main path with zero actions
    launches, state, step, action = fused_main_path(scenario, 'config 3', card)
    moved = (state.agent_state - sim.state.agent_state).abs().amax(dim=-1) > 0
    simple = ids == K.SIMPLE
    print(f'config 3: {int(moved[~simple].sum())} of {int((~simple).sum())} bicycle-family '
          f'agents moved, {int(moved[simple].sum())} of {int(simple.sum())} simple agents')
    if moved[simple].any() or not moved[~simple].any():
        raise AssertionError('config 3: zero actions must hold the simple agents only')
    mip, ops, res, _, _, _ = fused_frame(scenario, state)
    errs.append(compare_fused(fused, mip, ops, 'config 3 last frame', res))

    # 4. one compound kinematic step in a CUDA graph against the eager step
    rng = np.random.RandomState(1)
    act = torch.as_tensor(rng.uniform(-1, 1, (C3_BATCH, AGENTS, K.ACTION_BUF)),
                          dtype=torch.float32, device=device)
    kin_step = lambda: K.step(state.agent_state, act, km.params,
                              model_ids=km.model_assignments, models=km.models_in_use)
    eager = kin_step()
    compare_exact(graph_replay(kin_step), eager,
                  'compound kinematic step, CUDA graph replay against eager')
    kin_ms = graph_ms(kin_step, 50)
    print(f'compound kinematic step B={C3_BATCH}: {device_ops(kin_step)} device ops, '
          f'{kin_ms:.4f} ms (device, graph replay) [{card}]')

    # 5. times and rates
    return fused_numbers(scenario, state, step, action, 'config 3', 'fused_render_config3',
                         errs, launches, card)


def tiled_path(device, card):
    """The res-256 headline (Town02, B = 256, res 256, fov 70 m, textured,
    all metrics): each view renders as 2 x 2 sub-views of 128 pixels, all
    1,024 in one B1 launch. B1 against its plain version on the tiled
    operands of the first and the last frame, the first steps against the
    CPU, ``MAIN_STEPS`` steps counting B1's launches, times and
    env-steps/s; returns B1's JSON entry on this path."""
    import functools
    from torchdrivesim_tpu_torch.benchmark import build_benchmark_scenario
    from torchdrivesim_tpu_torch.ops import fused
    build = functools.partial(build_benchmark_scenario, agent_count=AGENTS,
                              res=TILED_RES, fov=FOV)
    scenario = build(batch_size=TILED_BATCH, device=device)
    mip, ops, res, n, _, (n_quads, n_tris) = fused_frame(scenario, scenario.sim.state)
    print(f'res-256 frame: {n} x {n} sub-views of {res} px per camera, '
          f'{ops[0].shape[0]} in one launch; {n_quads} quads and {n_tris} triangles '
          f'per camera; texture {tuple(mip.data.shape)} at {mip.cell_size} m')
    if (n, res, ops[0].shape[0]) != (2, RES, TILED_BATCH * 4):
        raise AssertionError('res-256 frame: not 2 x 2 sub-views of 128 in one launch')
    errs = [compare_fused(fused, mip, ops, 'res-256 first frame (tiled operands)', res)]
    compare_with_cpu(build, 'res-256 compare')
    launches, state, step, action = fused_main_path(scenario, 'res-256', card)
    mip, ops, res, _, _, _ = fused_frame(scenario, state)
    errs.append(compare_fused(fused, mip, ops, 'res-256 last frame (tiled operands)', res))
    return fused_numbers(scenario, state, step, action, 'res-256', 'fused_render_tiled256',
                         errs, launches, card)


# --- the Simulator facade ------------------------------------------------------

def facade_world(batch: int, device, renderer_config=None):
    """The facade phase's world: the headline's Town02 scenario (4 layouts
    tiled over ``batch``, 20 agents, FSM lights, texture) with a
    ``WaypointGoal`` of ``FACADE_WAYPOINTS`` collections of one waypoint
    per agent, drawn with numpy from seed 0 at 10-60 m along each agent's
    heading (the same waypoints on every device); its renderer built from
    ``renderer_config`` when one is given."""
    from torchdrivesim_tpu_torch.benchmark import build_benchmark_scenario
    from torchdrivesim_tpu_torch.goals import WaypointGoal
    scenario = build_benchmark_scenario(batch_size=batch, agent_count=AGENTS, res=RES,
                                        fov=FOV, renderer_config=renderer_config,
                                        device=device)
    sim = scenario.sim
    state = sim.get_state().cpu().numpy()
    dist = np.random.RandomState(0).uniform(10, 60, (batch, AGENTS, FACADE_WAYPOINTS))
    head = np.stack([np.cos(state[..., 2]), np.sin(state[..., 2])], axis=-1)
    waypoints = state[:, :, None, :2] + dist[..., None] * head[:, :, None]
    sim.waypoint_goals = WaypointGoal(waypoints[:, :, :, None].astype(np.float32),
                                      device=device)
    sim.state = dataclasses.replace(sim.state,
                                    waypoint_state=sim.waypoint_goals._state)
    return sim


def facade_actions(batch: int, n: int, device) -> torch.Tensor:
    """(n, batch, AGENTS, 2) steering noise, as the example drives."""
    return torch.as_tensor(np.random.RandomState(1).uniform(
        -0.02, 0.02, (n, batch, AGENTS, 2)), dtype=torch.float32, device=device)


def facade_iteration(sim, action):
    """One iteration of the facade loop: the egocentric views (one camera
    per agent), the step, and the grid offroad, grid wrong-way, red-light
    and disc-collision metrics."""
    from torchdrivesim_tpu_torch.utils import Resolution
    image = sim.render_egocentric(res=Resolution(RES, RES), fov=FOV)
    sim.step(action)
    return {'image': image, 'state': sim.get_state(),
            'waypoints_state': sim.get_waypoints_state(),
            'offroad': sim.compute_offroad(), 'wrong_way': sim.compute_wrong_way(),
            'light_violation': sim.compute_traffic_lights_violations(),
            'collision': sim.compute_collision()}


def facade_frame(sim, count: int):
    """B1's operands for ``render_egocentric``'s frame at
    ``n_subsequent_waypoints=count``: (mip, operands, pixels, tiles per
    side, screen-space prims, (quads, triangles) per camera)."""
    prims, cams = sim.egocentric_prim_frame(fov=FOV, n_subsequent_waypoints=count)
    mip, ops, res, n, screen = sim.renderer.fused_frame_operands(*prims, RES, cams)
    return mip, ops, res, n, screen, (prims[1].shape[1], prims[4].shape[1])


def facade_compare_with_cpu(device):
    """The facade loop's first ``COMPARE_STEPS`` iterations at B = 4 on the
    card against the CPU (states and metrics to 1e-4 + 1e-4 relative,
    images >= 99.9% identical pixels), then the fallback frame
    (``n_subsequent_waypoints=5``)."""
    from torchdrivesim_tpu_torch.utils import Resolution
    def run(dev):
        sim = facade_world(COMPARE_BATCH, dev)
        outs = [{k: v.cpu() for k, v in facade_iteration(sim, a).items()}
                for a in facade_actions(COMPARE_BATCH, COMPARE_STEPS, dev)]
        outs.append({'image': sim.render_egocentric(
            res=Resolution(RES, RES), fov=FOV,
            n_subsequent_waypoints=FACADE_FALLBACK_COUNT).cpu()})
        return outs

    card, cpu = (run(dev) for dev in ('cuda', 'cpu'))
    for i, (og, oc) in enumerate(zip(card, cpu)):
        label = f'iteration {i}' if i < COMPARE_STEPS else 'fallback frame'
        for k in oc:
            if k == 'image':
                same = float((og[k] == oc[k]).all(dim=2).float().mean())
                print(f'facade compare {label}: {same * 100:.4f}% of pixels identical '
                      'on the card and the CPU')
                if same < 0.999:
                    raise AssertionError(f'facade {label}: images differ')
            else:
                torch.testing.assert_close(og[k].float(), oc[k].float(),
                                           atol=1e-4, rtol=1e-4, msg=k)


def facade_exact_metrics_against_cpu(sim):
    """The IoU and exact-count collisions and the exact (mesh) offroad on
    the card's last state against the same state on the CPU, to 1e-4 +
    1e-4 relative."""
    from torchdrivesim_tpu_torch.simulator import CollisionMetric
    cpu = facade_world(sim.batch_size, 'cpu')
    cpu.set_state(sim.get_state().cpu())
    for name in ('iou', 'nograd'):
        values = []
        for s in (sim, cpu):
            s.cfg.collision_metric = CollisionMetric(name)
            values.append(s.compute_collision().cpu())
            s.cfg.collision_metric = CollisionMetric.discs
        torch.testing.assert_close(values[0], values[1], atol=1e-4, rtol=1e-4, msg=name)
        print(f'facade {name} collisions on the last state: card and CPU agree '
              f'(total {float(values[0].sum()):.4f})')
    values = []
    for s in (sim, cpu):
        grids, s.map_grids = s.map_grids, None
        values.append(s.compute_offroad().cpu())
        s.map_grids = grids
    torch.testing.assert_close(values[0], values[1], atol=1e-4, rtol=1e-4,
                               msg='exact offroad')
    print(f'facade exact offroad on the last state: card and CPU agree (total '
          f'{float(values[0].sum()):.4f}, {int((values[0] > 0).sum())} agents off road)')


def facade_path(device, card):
    """The stateful ``Simulator`` facade (Town02, B = 64, 20 agents, FSM
    lights, texture, waypoint goals): ``FACADE_ITERATIONS`` iterations of
    ``render_egocentric`` (res 128, fov 70 m: 1,280 cameras per frame),
    ``step`` and the grid offroad, grid wrong-way, red-light and
    disc-collision metrics, pinned at one B1 launch per iteration and no
    call of its plain version; B1 against its plain version on the first
    and the last frame and on a frame at ``n_subsequent_waypoints=5`` (70
    triangles per camera, past the cap of 56: the sort route), which also
    launches B1 once; the first iterations and the fallback frame against
    the CPU; IoU, exact counts and exact offroad on the last state against
    the CPU; one iteration's views, step and grid metrics captured in a
    CUDA graph (the capture fails on a host sync) and replayed against the
    eager ones; the example at ``FACADE_EXAMPLE_STEPS`` steps; times,
    bound, device ops and steps/s. Returns B1's JSON entry on this path."""
    from torchdrivesim_tpu_torch.examples import simulate
    from torchdrivesim_tpu_torch.ops import fused
    from torchdrivesim_tpu_torch.utils import Resolution
    t_phase = time.perf_counter()
    sim = facade_world(FACADE_BATCH, device)
    cap = sim.renderer._prim_cap

    # 1. B1 against its plain version on the first frame and the fallback frame
    mip, ops, res, n, _, (n_quads, n_tris) = facade_frame(sim, 1)
    print(f'facade frame: {ops[0].shape[0]} cameras (B={FACADE_BATCH} x {AGENTS} agents), '
          f'{n_quads} quads and {n_tris} triangles per camera (per-type cap {cap}), '
          f'qcoef {tuple(ops[2].shape)}, tcoef {tuple(ops[4].shape)}')
    if (n, res, ops[0].shape[0]) != (1, RES, FACADE_BATCH * AGENTS) or n_tris > cap:
        raise AssertionError('facade frame: not one 128 px view per agent under the cap')
    errs = [compare_fused(fused, mip, ops, 'facade first frame', res)]
    fb_mip, fb_ops, _, _, fb_screen, (_, fb_tris) = facade_frame(sim, FACADE_FALLBACK_COUNT)
    if fb_tris <= cap:
        raise AssertionError(f'fallback frame: {fb_tris} triangles do not pass the cap')
    print(f'facade fallback frame (n_subsequent_waypoints={FACADE_FALLBACK_COUNT}): '
          f'{fb_tris} triangles per camera, sorted and capped to '
          f'{fb_ops[5].shape[1]} slots')
    errs.append(compare_fused(fused, fb_mip, fb_ops, 'facade fallback frame', res))
    prims, cams = sim.egocentric_prim_frame(fov=FOV)
    forced = sim.renderer.fused_frame_operands(*prims, RES, cams, force_sort=True)
    compare_exact(fused.render_coefs_fused(forced[0], *forced[1], res),
                  fused.render_coefs_fused(mip, *ops, res),
                  'facade first frame: sort route against prep route (bits)')
    fused.LAUNCHES = 0
    sim.render_egocentric(res=Resolution(RES, RES), fov=FOV,
                          n_subsequent_waypoints=FACADE_FALLBACK_COUNT)
    torch.cuda.synchronize()
    if fused.LAUNCHES != 1:
        raise AssertionError(f'fallback frame: {fused.LAUNCHES} B1 launches, expected 1')
    print('facade fallback frame: 1 fused_render launch')

    # 2. the first iterations and the fallback frame against the CPU
    facade_compare_with_cpu(device)

    # 3. the main path: the facade loop, counting launches
    actions = facade_actions(FACADE_BATCH, FACADE_ITERATIONS, device)
    fused.LAUNCHES = 0
    with count_calls(fused, ['render_coefs_fused_reference']) as plain:
        t0 = time.perf_counter()
        for action in actions:
            out = facade_iteration(sim, action)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    launches = fused.LAUNCHES
    print(f'facade main path: {FACADE_ITERATIONS} iterations at B={FACADE_BATCH} in '
          f'{loop_s:.2f} s ({FACADE_ITERATIONS / loop_s:.1f} iterations/s, '
          f'{FACADE_ITERATIONS * FACADE_BATCH / loop_s:.1f} env-steps/s), fused_render '
          f'launches {launches}, plain fused calls '
          f'{plain["render_coefs_fused_reference"]} [{card}]')
    if launches != FACADE_ITERATIONS or plain['render_coefs_fused_reference']:
        raise AssertionError('facade: expected one B1 launch per iteration and no '
                             'plain fused call')
    for k, v in out.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f'facade {k}: non-finite values')
    if out['image'].shape != (FACADE_BATCH, AGENTS, 3, RES, RES):
        raise AssertionError(f'facade image shape {tuple(out["image"].shape)}')
    check_frames({'image': out['image'].flatten(0, 1)}, sim.renderer,
                 FACADE_BATCH * AGENTS, RES, 'facade')
    advanced = int((out['waypoints_state'] > 0).sum())
    print(f'facade: {advanced} of {FACADE_BATCH * AGENTS} agents reached a waypoint; '
          f'totals offroad {float(out["offroad"].sum()):.2f}, wrong-way '
          f'{float(out["wrong_way"].sum()):.2f}, red-light '
          f'{int(out["light_violation"].sum())}, collision '
          f'{float(out["collision"].sum()):.2f}')
    mip, ops, res, _, screen, _ = facade_frame(sim, 1)
    errs.append(compare_fused(fused, mip, ops, 'facade last frame', res))
    facade_exact_metrics_against_cpu(sim)

    # 4. no host sync: the egocentric views, the step and the grid metrics
    # of one iteration captured in a CUDA graph, replayed, equal the eager ones
    probe = facade_actions(FACADE_BATCH, 1, device)[0]

    def pure_iteration():
        state = sim.functional_step(sim.state, probe)
        return (sim.render_egocentric(res=Resolution(RES, RES), fov=FOV),
                state.agent_state, state.waypoint_state.state, sim.compute_offroad(),
                sim.compute_wrong_way(), sim.compute_traffic_lights_violations(),
                sim.compute_collision())

    eager = pure_iteration()
    for name, got, want in zip(('image', 'state', 'waypoints', 'offroad', 'wrong-way',
                                'red-light', 'collision'), graph_replay(pure_iteration),
                               eager):
        compare_exact(got.float(), want.float(),
                      f'facade iteration {name}, CUDA graph replay against eager')

    # 5. times, bound, device ops
    kernel_ms = graph_ms(lambda: fused.render_coefs_fused(mip, *ops, res), 50)
    plain_ms = cuda_ms(lambda: fused.render_coefs_fused_reference(mip, *ops, res), 3)
    bound_ms, bound_by = fused_bound(mip, ops, screen, res, FOV)
    fb_ms = graph_ms(lambda: fused.render_coefs_fused(fb_mip, *fb_ops, res), 50)
    fb_bound_ms, fb_bound_by = fused_bound(fb_mip, fb_ops, fb_screen, res, FOV)
    print(f'facade: fused_render kernel {ops[0].shape[0]} cameras of {res} px: '
          f'{kernel_ms:.4f} ms (device, graph replay); plain version {plain_ms:.3f} ms; '
          f'bound {bound_ms * 1e3:.2f} us by {bound_by}; fallback frame '
          f'{fb_ms:.4f} ms, bound {fb_bound_ms * 1e3:.2f} us by {fb_bound_by} [{card}]')
    profile_step(pure_iteration, 'facade iteration', card, count=('fused',))
    eager_ms = cuda_ms(pure_iteration, 20)
    replay_ms = graph_ms(pure_iteration, 10)
    print(f'facade iteration: {device_ops(pure_iteration)} device ops; {eager_ms:.3f} ms '
          f'eager (CUDA events), {replay_ms:.3f} ms replayed from one CUDA graph: the '
          f'device busy {100 * replay_ms / eager_ms:.1f}% of the eager iteration [{card}]')

    # 6. the example, on the card by default
    fused.LAUNCHES = 0
    simulate.main(['--steps', str(FACADE_EXAMPLE_STEPS), '--out',
                   'build/simulate_example.npz'])
    torch.cuda.synchronize()
    print(f'example (res 256, 2 x 2 sub-views): {FACADE_EXAMPLE_STEPS} steps, '
          f'fused_render launches {fused.LAUNCHES}')
    if fused.LAUNCHES != FACADE_EXAMPLE_STEPS:
        raise AssertionError('example: expected one B1 launch per step')
    print(f'facade phase: {time.perf_counter() - t_phase:.1f} s')
    return {'name': 'fused_render_facade', 'route': 'cuda',
            'source': 'torchdrivesim_tpu_torch/csrc/fused_render.cu',
            'replaces': 'torchdrivesim_tpu/ops/pallas_fused.py:69',
            'launches': launches, 'max_abs_err': max(errs), 'ms': kernel_ms,
            'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': None}


# --- the facade's noisy, recolored render (Town10HD, config 3's world) ------

NOISY_BATCH, NOISY_ITERATIONS, NOISY_SIGN_FOV = 64, 20, 20.0
#: the getters a noisy-perception user reads every iteration
NOISY_GETTERS = ('get_noisy_state', 'get_noisy_agent_size', 'get_noisy_present_mask',
                 'get_noisy_all_agents_absolute', 'get_noisy_all_agents_relative')


def lane_markers(cfg_map, batch: int, device):
    """Dense lane features from the map's lanelet centerlines (no file is
    fetched): one (x, y, psi, width 1.5 m) marker at each centerline vertex
    but the last, heading to the next; the same for every environment."""
    from torchdrivesim_tpu_torch.lanelet2 import LaneFeatures
    rows = []
    for lanelet in cfg_map.lanelet_map.laneletLayer:
        c = lanelet.centerline.coords()
        d = c[1:] - c[:-1]
        rows.append(np.concatenate([c[:-1], np.arctan2(d[:, 1:], d[:, :1]),
                                    np.full((len(d), 1), 1.5)], axis=-1))
    feats = torch.as_tensor(np.concatenate(rows).astype(np.float32), device=device)
    feats = feats[None].expand(batch, -1, 4).contiguous()
    return LaneFeatures(feats, torch.ones(feats.shape[:2], dtype=torch.bool, device=device))


def noisy_world(batch: int, device):
    """Config 3's world (Town10HD, left-handed, its texture, 20 agents of
    three kinematic models by ``np.random.RandomState(0)``, 30 FSM lights,
    2 stop signs and 1 yield sign) with the centerline markers as its lane
    features and standard-sensing noise from a generator on ``device``
    seeded with 0; (simulator, per-camera agent colors (B, A, A, 3) from
    numpy seed 2)."""
    from torchdrivesim_tpu_torch.benchmark import build_config3_scenario
    from torchdrivesim_tpu_torch.map import find_map_config
    from torchdrivesim_tpu_torch.observation_noise import (
        StandardSensingObservationNoise, StandardSensingObservationNoiseConfig)
    sim = build_config3_scenario(batch_size=batch, agent_count=AGENTS, res=RES, fov=FOV,
                                 device=device).sim
    sim.lane_features = lane_markers(find_map_config('carla_Town10HD'), batch, device)
    sim.observation_noise_model = StandardSensingObservationNoise(
        StandardSensingObservationNoiseConfig(), seed=0, device=device)
    colors = torch.as_tensor(np.random.RandomState(2).uniform(
        0, 1, (batch, AGENTS, AGENTS, 3)).astype(np.float32), device=device)
    return sim, colors


def noisy_actions(sim, n: int) -> torch.Tensor:
    """(n, B, A, action width) small seeded actions."""
    return torch.as_tensor(np.random.RandomState(3).uniform(
        -0.02, 0.02, (n, sim.batch_size, AGENTS, sim.action_size)),
        dtype=torch.float32, device=sim.device)


def noisy_iteration(sim, colors, action):
    """One iteration of the noisy facade loop: the noisy, recolored
    egocentric views, the step, the four metrics and the noisy getters."""
    from torchdrivesim_tpu_torch.utils import Resolution
    out = {'image': sim.render_egocentric(res=Resolution(RES, RES), fov=FOV,
                                          noisy_perception=True, custom_agent_colors=colors)}
    sim.step(action)
    out.update(state=sim.get_state(), offroad=sim.compute_offroad(),
               wrong_way=sim.compute_wrong_way(),
               light_violation=sim.compute_traffic_lights_violations(),
               collision=sim.compute_collision())
    out.update({name: getattr(sim, name)() for name in NOISY_GETTERS})
    lanes, road, background, controls = (sim.get_noisy_lane_features(),
                                         sim.get_noisy_road_mesh(),
                                         sim.get_noisy_background_mesh(),
                                         sim.get_noisy_traffic_controls())
    if lanes is None or road is None or background is None or controls is None:
        raise AssertionError('noisy facade: a noisy map getter returned nothing')
    return out


def noisy_frame(sim, colors):
    """The operands of the noisy textured frame from the renderer's own
    preparation: (background, hard operands, (mip, fcoef, icoef)), (mesh,
    cameras)."""
    mesh, cams = sim.egocentric_mesh_frame(fov=FOV, noisy_perception=True,
                                           custom_agent_colors=colors)
    return sim.renderer.hard_frame_operands(mesh, RES, cams), (mesh, cams)


def sign_world(sim):
    """Environment 0 of ``sim`` without the texture (the whole Town10HD
    mesh under every frame) and with a ``MapObservationNoiseFromLog`` whose
    logged lane features, one per step, are the centerline markers; four
    cameras on the signs (the two stop signs, the yield sign, and the yield
    sign turned a quarter): (simulator, camera xy (1, 4, 2), psi (1, 4, 1),
    each camera's sign kind)."""
    from torchdrivesim_tpu_torch.map import find_map_config
    from torchdrivesim_tpu_torch.observation_noise import (
        MapObservationNoiseFromLog, MapObservationNoiseFromLogConfig)
    one = sim.select_batch_elements([0], in_place=False)
    one.renderer.background_texture = None
    one.observation_noise_model = MapObservationNoiseFromLog(
        MapObservationNoiseFromLogConfig(),
        noisy_lane_features=[one.lane_features] * (NOISY_ITERATIONS + 1))
    signs = [sl for sl in find_map_config('carla_Town10HD').stoplines
             if sl.agent_type in ('stop_sign', 'yield_sign')]
    signs = sorted(signs, key=lambda sl: sl.agent_type) + [signs[0]]
    xy = torch.tensor([[[sl.x, sl.y] for sl in signs]], device=sim.device)
    psi = torch.tensor([[[sl.orientation] for sl in signs[:-1]]
                        + [[signs[-1].orientation + np.pi / 2]]], device=sim.device)
    return one, xy, psi, [sl.agent_type for sl in signs]


def sign_frame(one, xy, psi):
    """B6b's operands of the untextured sign frame: (background, operands),
    (mesh, cameras)."""
    mesh, cams = one.mesh_frame(xy, psi, fov=NOISY_SIGN_FOV, noisy_perception=True)
    bg, ops, _ = one.renderer.hard_frame_operands(mesh, RES, cams)
    return (bg, ops), (mesh, cams)


def check_sign_pixels(image, renderer, kinds, label):
    """Each camera's central 16 x 16 pixels show its sign's color."""
    half = RES // 2
    for cam, kind in enumerate(kinds):
        color = torch.tensor(renderer.color_map[kind], dtype=torch.float32,
                             device=image.device)
        centre = image[cam, :, half - 8:half + 8, half - 8:half + 8]
        n = int(((centre - color[:, None, None]).abs() < 0.5).all(dim=0).sum())
        print(f'{label}: camera {cam} on a {kind}: {n} of 256 central pixels in its color')
        if n == 0:
            raise AssertionError(f'{label}: the {kind} is not drawn')


def culled_tile_pairs(renderer, mesh, cams, valid, res) -> int:
    """:func:`tile_pairs` of the hard raster's faces after the cull to
    ``cfg.cull_max_faces`` that the textured render makes."""
    from torchdrivesim_tpu_torch.ops.rasterize import (
        camera_rows_cols, cull_faces_to_view, face_arrays)
    rc = camera_rows_cols(mesh.verts[..., :2], cams.xy, cams.sc, cams.scale, res,
                          left_handed=renderer.cfg.left_handed_coordinates)
    corners, z, color = face_arrays(torch.cat([rc, mesh.verts[..., 2:3]], dim=-1),
                                    mesh.faces, mesh.attrs)
    corners, _, _ = cull_faces_to_view(corners, z, color, res, renderer.cfg.cull_max_faces)
    return tile_pairs(corners, valid, res)


def noisy_compare_with_cpu(device):
    """The noisy loop's first ``COMPARE_STEPS`` iterations at B = 4 on the
    card against the CPU: images >= 99.9% identical pixels, the occlusion
    present mask exact, states and metrics to 1e-4 + 1e-4 relative (the
    noisy states draw from each device's own generator and are not
    compared)."""
    def run(dev):
        sim, colors = noisy_world(COMPARE_BATCH, dev)
        return [{k: v.cpu() for k, v in noisy_iteration(sim, colors, a).items()}
                for a in noisy_actions(sim, COMPARE_STEPS)]

    card, cpu = (run(dev) for dev in ('cuda', 'cpu'))
    for i, (og, oc) in enumerate(zip(card, cpu)):
        same = float((og['image'] == oc['image']).all(dim=2).float().mean())
        hidden = int((~oc['get_noisy_present_mask']).sum())
        print(f'noisy facade compare iteration {i}: {same * 100:.4f}% of pixels identical '
              f'on the card and the CPU; present mask {hidden} hidden entries on the CPU, '
              f'{int((og["get_noisy_present_mask"] != oc["get_noisy_present_mask"]).sum())} '
              'differ')
        if same < 0.999:
            raise AssertionError(f'noisy facade iteration {i}: images differ')
        if not torch.equal(og['get_noisy_present_mask'], oc['get_noisy_present_mask']):
            raise AssertionError(f'noisy facade iteration {i}: present masks differ')
        for k in ('state', 'offroad', 'wrong_way', 'light_violation', 'collision',
                  'get_noisy_agent_size'):
            torch.testing.assert_close(og[k].float(), oc[k].float(), atol=1e-4,
                                       rtol=1e-4, msg=k)


def noisy_facade_path(device, card):
    """The facade with noisy perception on config 3's world (Town10HD, B =
    64, 20 agents, 30 FSM lights, 2 stop signs, 1 yield sign, texture;
    standard-sensing noise, centerline lane markers): ``NOISY_ITERATIONS``
    iterations of ``render_egocentric(noisy_perception=True,
    custom_agent_colors=...)`` (1,280 cameras of 128 px: the mesh path, B2
    under B6a), ``step``, the four metrics and the noisy getters, then one
    untextured frame of 4 cameras on the signs (B6b over the whole map mesh,
    the markers from a ``MapObservationNoiseFromLog``), pinned at one B2
    and one B6a launch per iteration and one B6b, no plain call and no B1;
    B2, B6a and B6b against their plain versions on the first and the last
    frame; the signs drawn; the first iterations against the CPU; times,
    bounds, device ops and iterations/s. Returns the JSON entries of B2, B6a
    and B6b on this path."""
    from torchdrivesim_tpu_torch.ops import fused, hard, warp
    t_phase = time.perf_counter()
    sim, colors = noisy_world(NOISY_BATCH, device)
    print(f'noisy facade: carla_Town10HD B={NOISY_BATCH}, {AGENTS} agents, controls '
          f'{ {k: v.corners.shape[1] for k, v in sim.traffic_controls.items()} }, '
          f'{sim.lane_features.dense_lane_features.shape[1]} centerline markers, '
          f'{type(sim.observation_noise_model).__name__}')

    # 1. B2, B6a and B6b against their plain versions on the first frames
    (bg, ops, (mip, fcoef, icoef)), (mesh, cams) = noisy_frame(sim, colors)
    if len(ops) != 2:
        raise AssertionError('noisy facade frame: not the packed kernel')
    print(f'noisy facade frame: {fcoef.shape[0]} cameras, {mesh.faces.shape[1]} faces per '
          f'camera culled to {ops[1].shape[1]}, texture level {tuple(mip.data.shape)}')
    errs = {'warp_nearest': [compare_nearest(warp, mip, fcoef, icoef, RES,
                                             'noisy facade first')],
            'hard_raster_packed': [compare_hard(hard, ops, bg, RES,
                                                'noisy facade first frame')[1]]}
    one, xy, psi, kinds = sign_world(sim)
    (sbg, sops), _ = sign_frame(one, xy, psi)
    if len(sops) != 3:
        raise AssertionError('sign frame: not the chunked kernel')
    errs['hard_raster_chunked'] = [compare_hard(hard, sops, sbg, RES, 'sign first frame')[1]]
    image = one.render(xy, psi, fov=NOISY_SIGN_FOV, noisy_perception=True)[0]
    check_sign_pixels(image, one.renderer, kinds, 'sign first frame')
    marker = torch.tensor(one.renderer.color_map['stop_sign'], dtype=torch.float32,
                          device=device)
    plain_image = one.render(xy, psi, fov=NOISY_SIGN_FOV)[0]
    marked = lambda img: int(((img - marker[:, None, None]).abs() < 0.5).all(dim=1).sum())
    print(f'sign first frame: {marked(image)} pixels in the marker color with noisy '
          f'perception, {marked(plain_image)} without')
    if not marked(image) > marked(plain_image):
        raise AssertionError('sign frame: the lane markers are not drawn')

    # 2. the first iterations against the CPU
    noisy_compare_with_cpu(device)

    # 3. the main path: the noisy facade loop, then the sign frame
    actions = noisy_actions(sim, NOISY_ITERATIONS)
    warp.NEAREST_LAUNCHES = hard.PACKED_LAUNCHES = hard.CHUNKED_LAUNCHES = 0
    fused.LAUNCHES = 0
    names = ['raster_packed_reference', 'raster_chunked_reference']
    with count_calls(hard, names) as plain, \
            count_calls(warp, ['warp_view_nearest_reference']) as plain_warp:
        t0 = time.perf_counter()
        for action in actions:
            out = noisy_iteration(sim, colors, action)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        one, xy, psi, kinds = sign_world(sim)
        image = one.render(xy, psi, fov=NOISY_SIGN_FOV, noisy_perception=True)[0]
        torch.cuda.synchronize()
    launches = {'warp_nearest': warp.NEAREST_LAUNCHES,
                'hard_raster_packed': hard.PACKED_LAUNCHES,
                'hard_raster_chunked': hard.CHUNKED_LAUNCHES, 'fused_render': fused.LAUNCHES}
    plain = {**plain, **plain_warp}
    print(f'noisy facade main path: {NOISY_ITERATIONS} iterations at B={NOISY_BATCH} in '
          f'{loop_s:.2f} s ({NOISY_ITERATIONS / loop_s:.2f} iterations/s, '
          f'{NOISY_ITERATIONS * NOISY_BATCH / loop_s:.1f} env-steps/s), then the sign '
          f'frame; launches {launches}, plain calls {plain} [{card}]')
    want = {'warp_nearest': NOISY_ITERATIONS, 'hard_raster_packed': NOISY_ITERATIONS,
            'hard_raster_chunked': 1, 'fused_render': 0}
    if launches != want or any(plain.values()):
        raise AssertionError(f'noisy facade: launches {launches}, expected {want}, '
                             'and no plain call')
    for k, v in out.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f'noisy facade {k}: non-finite values')
    if out['image'].shape != (NOISY_BATCH, AGENTS, 3, RES, RES):
        raise AssertionError(f'noisy facade image shape {tuple(out["image"].shape)}')
    painted = int(((out['image'].flatten(0, 1)[:, :, RES // 2, RES // 2] / 255.0)
                   - colors.diagonal(dim1=1, dim2=2).transpose(1, 2).flatten(0, 1)
                   ).abs().amax(dim=-1).lt(0.5 / 255 + 1e-6).sum())
    hidden = int((~out['get_noisy_present_mask']).sum())
    noise = (out['get_noisy_state'] - sim.get_all_agent_state()[:, None]).abs()
    print(f'noisy facade: {painted} of {NOISY_BATCH * AGENTS} views show their ego in '
          f'its custom color at the centre; {hidden} of '
          f'{out["get_noisy_present_mask"].numel()} (ego, entity) pairs occluded; noisy '
          f'state deviates up to {float(noise.max()):.3f}')
    if painted < 0.9 * NOISY_BATCH * AGENTS or hidden == 0 or not float(noise.max()) > 0:
        raise AssertionError('noisy facade: colors, occlusion or noise missing')
    check_sign_pixels(image, one.renderer, kinds, 'sign last frame')
    (bg, ops, (mip, fcoef, icoef)), (mesh, cams) = noisy_frame(sim, colors)
    errs['warp_nearest'].append(compare_nearest(warp, mip, fcoef, icoef, RES,
                                                'noisy facade last'))
    errs['hard_raster_packed'].append(compare_hard(hard, ops, bg, RES,
                                                   'noisy facade last frame')[1])
    (sbg, sops), (smesh, scams) = sign_frame(one, xy, psi)
    errs['hard_raster_chunked'].append(compare_hard(hard, sops, sbg, RES,
                                                    'sign last frame')[1])

    # 4. times, bounds, device ops
    coef, pk = ops
    b = pk.shape[0]
    pixels = b * RES * RES
    image_bytes = pixels * 3 * 4
    pairs_a = culled_tile_pairs(sim.renderer, mesh, cams, pk != hard.PACKED_SENTINEL, RES)
    scoef, sz, srgb = sops
    pairs = hard_tile_pairs(one.renderer, smesh, scams, sz != hard.Z_SENTINEL, RES)
    tiles = hard.hard_tiles(RES)
    for label, n_pairs, keep, nb, nf in (
            ('noisy facade view', pairs_a,
             hard.hard_tile_keep_reference(coef, pk, hard.PACKED_SENTINEL, RES), b,
             pk.shape[1]),
            ('sign view', pairs, hard.hard_tile_keep_reference(scoef, sz, hard.Z_SENTINEL,
                                                               RES), sz.shape[0],
             sz.shape[1])):
        print(f'{label}: {n_pairs / (nb * tiles):.1f} of {nf} faces per {BOUND_TILE} x '
              f'{BOUND_TILE} tile overlap it by bounding box; the plain cull lists '
              f'{int(keep.sum()) / (nb * tiles):.1f}')
    entries = []
    for name, key, fn, plain_fn, reps, plain_reps, n_bytes, n_ops, source, replaces in (
            ('warp_nearest_noisy_facade', 'warp_nearest',
             lambda: warp.warp_view_nearest(mip.data, fcoef, icoef, RES),
             lambda: warp.warp_view_nearest_reference(mip.data, fcoef, icoef, RES),
             100, 5, nbytes(fcoef, icoef) + texel_bytes(mip, b, FOV) + image_bytes,
             pixels * NEAREST_PIXEL_OPS,
             'torchdrivesim_tpu_torch/csrc/warp_nearest.cu',
             'torchdrivesim_tpu/ops/pallas_warp.py:373'),
            ('hard_raster_packed_noisy_facade', 'hard_raster_packed',
             lambda: hard.raster_packed(coef, pk, bg, RES),
             lambda: hard.raster_packed_reference(coef, pk, bg, RES),
             100, 5, nbytes(coef, pk) + 2 * image_bytes,
             pairs_a * BOUND_TILE ** 2 * HARD_FACE_OPS,
             'torchdrivesim_tpu_torch/csrc/hard_raster.cu',
             'torchdrivesim_tpu/ops/pallas_rasterize.py:134'),
            ('hard_raster_chunked_signs', 'hard_raster_chunked',
             lambda: hard.raster_chunked(scoef, sz, srgb, sbg, RES),
             lambda: hard.raster_chunked_reference(scoef, sz, srgb, sbg, RES),
             20, 2, nbytes(scoef, sz, srgb) + 2 * sz.shape[0] * RES * RES * 3 * 4,
             pairs * BOUND_TILE ** 2 * HARD_CHUNKED_FACE_OPS,
             'torchdrivesim_tpu_torch/csrc/hard_raster.cu',
             'torchdrivesim_tpu/ops/pallas_rasterize.py:152')):
        ms = graph_ms(fn, reps)
        plain_ms = cuda_ms(plain_fn, plain_reps)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        print(f'{name} kernel: {ms:.4f} ms (device, graph replay); plain version '
              f'{plain_ms:.3f} ms; bound {bound_ms * 1e3:.3f} us by {bound_by} '
              f'({n_bytes / 1e6:.3f} MB, {n_ops / 1e6:.1f} M float32 ALU operations) '
              f'[{card}]')
        entries.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': launches[key],
                        'max_abs_err': max(errs[key]),
                        'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                        'bound_by': bound_by, 'library_ms': None})
    probe = noisy_actions(sim, 1)[0]
    iteration = lambda: noisy_iteration(sim.copy(), colors, probe)
    profile_step(iteration, 'noisy facade iteration', card, count=('hard', 'warp'))
    print(f'noisy facade iteration: {device_ops(iteration)} device ops [{card}]')
    print(f'noisy facade phase: {time.perf_counter() - t_phase:.1f} s')
    return entries


# --- NPC replay, the INTERACTION data path and the single GymEnv -------------

#: the INTERACTION-layout data written at run time: cases of frames, each
#: with vehicles (half typed 'car') and pedestrians (present for
#: INTERACTION_PED_FRAMES frames, with empty psi, length and width)
INTERACTION_CASES, INTERACTION_FRAMES = 16, 40
INTERACTION_VEHICLES, INTERACTION_PEDESTRIANS, INTERACTION_PED_FRAMES = 16, 4, 25
INTERACTION_COLUMNS = ('case_id', 'track_id', 'frame_id', 'timestamp_ms', 'agent_type',
                       'x', 'y', 'vx', 'vy', 'psi_rad', 'length', 'width')


def interaction_rows(case_id: int, lanelet_map):
    """One case's rows in the INTERACTION v1.2 layout: vehicles placed by
    ``heuristic_initialize`` from ``random.Random(case_id)`` moving at
    their speed along their heading (dt 0.1 s), pedestrians beside the
    first vehicles walking at 1.2 m/s; track ids (vehicles 1..,
    pedestrians after them) written in an order shuffled by
    ``np.random.RandomState(case_id)``, each track's rows in frame order."""
    import random
    from torchdrivesim_tpu_torch.behavior.heuristic import heuristic_initialize
    attrs, states = heuristic_initialize(lanelet_map, INTERACTION_VEHICLES,
                                         random.Random(case_id), min_speed=1,
                                         max_speed=8)
    tracks = {}
    frames = np.arange(1, INTERACTION_FRAMES + 1)
    for i, (x, y, psi, v) in enumerate(states[0].astype(np.float64)):
        vx, vy = v * math.cos(psi), v * math.sin(psi)
        tracks[i + 1] = [['car' if i % 2 else 'vehicle', x + vx * 0.1 * (f - 1),
                          y + vy * 0.1 * (f - 1), vx, vy, psi, *attrs[0, i, :2]]
                         for f in frames]
    start = (INTERACTION_FRAMES - INTERACTION_PED_FRAMES) // 2
    for k in range(INTERACTION_PEDESTRIANS):
        x, y, psi, _ = states[0, k].astype(np.float64)
        px, py = x - 3.0 * math.sin(psi), y + 3.0 * math.cos(psi)
        tracks[INTERACTION_VEHICLES + k + 1] = [
            ['pedestrian/bicycle', px + 0.12 * (f - 1), py, 1.2, 0.0, '', '', '']
            for f in frames[start:start + INTERACTION_PED_FRAMES]]
    order = np.random.RandomState(case_id).permutation(sorted(tracks))
    rows = []
    for track_id in order:
        first = 1 + start if track_id > INTERACTION_VEHICLES else 1
        for f, (kind, x, y, vx, vy, psi, length, width) in enumerate(tracks[track_id],
                                                                     first):
            num = lambda value: value if value == '' else f'{value:.3f}'
            rows.append([case_id, int(track_id), f, f * 100, kind, num(x), num(y),
                         num(vx), num(vy), num(psi), num(length), num(width)])
    return rows


def write_interaction_data(root: str, cases: int = INTERACTION_CASES) -> str:
    """An INTERACTION-layout dataset root for carla_Town02 under ``root``:
    ``maps/carla_Town02.osm`` (a copy of the bundled map, origin (0, 0)),
    ``train/carla_Town02_train.csv`` (``cases`` cases of
    :func:`interaction_rows`) and
    ``recorded_trackfiles/carla_Town02/vehicle_tracks_000.csv`` (case 1's
    rows without ``case_id``). Returns ``root``."""
    import csv
    import os
    import shutil
    from torchdrivesim_tpu_torch.lanelet2 import load_lanelet_map
    from torchdrivesim_tpu_torch.map import find_map_config
    osm = find_map_config('carla_Town02').lanelet_path
    for sub in ('maps', 'train', 'recorded_trackfiles/carla_Town02'):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    shutil.copy(osm, os.path.join(root, 'maps', 'carla_Town02.osm'))
    lanelet_map = load_lanelet_map(osm)
    per_case = {c: interaction_rows(c, lanelet_map) for c in range(1, cases + 1)}
    with open(os.path.join(root, 'train', 'carla_Town02_train.csv'), 'w',
              newline='') as f:
        out = csv.writer(f)
        out.writerow(INTERACTION_COLUMNS)
        for c in per_case:
            out.writerows(per_case[c])
    path = os.path.join(root, 'recorded_trackfiles', 'carla_Town02',
                        'vehicle_tracks_000.csv')
    with open(path, 'w', newline='') as f:
        out = csv.writer(f)
        out.writerow(INTERACTION_COLUMNS[1:])
        out.writerows(row[1:] for row in per_case[1])
    return root


REPLAY_RES, REPLAY_COMPARE_RES, REPLAY_COMPARE_FRAMES = 256, 64, 3
DATASET_IL_BATCH, DATASET_IL_HORIZON, DATASET_IL_RES, DATASET_IL_STEPS = 16, 40, 64, 3
GYM_STEPS = 100


def replay_argv(root: str, device, res: int = REPLAY_RES,
                frames: int = INTERACTION_FRAMES):
    """The replay example's arguments: case 1 of :func:`write_interaction_data`
    under ``root`` over the Town02 mesh JSON."""
    from torchdrivesim_tpu_torch.map import find_map_config
    return ['--dataset-path', root, '--location', 'carla_Town02', '--map-mesh',
            find_map_config('carla_Town02').mesh_path, '--segment-length', str(frames),
            '--res', str(res), '--out', 'build/replay_example.npz', '--device',
            str(device)]


def replay_frame(sim):
    """B6's operands for ``render_egocentric``'s frame of the untextured
    simulator ``sim``, from ``Renderer.hard_frame_operands``: (background,
    operands, mesh, cameras)."""
    mesh, cams = sim.egocentric_mesh_frame()
    background, ops, _ = sim.renderer.hard_frame_operands(mesh, sim.renderer.res.width,
                                                          cams)
    return background, ops, mesh, cams


def replay_compare_with_cpu(root: str, device):
    """``REPLAY_COMPARE_FRAMES`` frames of the replay at res
    ``REPLAY_COMPARE_RES`` on the card and on the CPU: views >= 99.9%
    identical pixels, ego and NPC states and masks to 1e-4."""
    from torchdrivesim_tpu_torch.examples import replay
    runs = []
    for dev in (device, torch.device('cpu')):
        sim, states = replay.build_simulator(replay.parse_args(
            replay_argv(root, dev, REPLAY_COMPARE_RES)))
        out = []
        for t in range(REPLAY_COMPARE_FRAMES):
            out.append({'image': sim.render_egocentric().cpu(),
                        'agents': sim.get_all_agent_state().cpu(),
                        'present': sim.get_all_agent_present_mask().cpu()})
            sim.step(states[:, :1, t + 1])
        runs.append(out)
    for i, (og, oc) in enumerate(zip(*runs)):
        same = float((og['image'] == oc['image']).all(dim=2).float().mean())
        print(f'replay compare frame {i}: {same * 100:.4f}% of pixels identical on the '
              'card and the CPU')
        if same < 0.999:
            raise AssertionError(f'replay frame {i}: images differ')
        torch.testing.assert_close(og['agents'], oc['agents'], atol=1e-4, rtol=1e-4)
        if not torch.equal(og['present'], oc['present']):
            raise AssertionError(f'replay frame {i}: presence differs')


def replay_path(device, card, root: str):
    """NPC replay (``examples/replay.py``: case 1 of the written data, B =
    1, the first agent a teleporting ego, the other 19 replayed, 39 frames
    of ``render_egocentric`` at res 256, fov 100 m over the Town02 mesh
    JSON): B6b against its plain version on the first and the last frame,
    3 frames against the CPU, the example pinned at one B6b launch per
    frame and no plain call, a step with the replay controller captured in
    a CUDA graph against the eager one, times, bound and frames/s. Returns
    B6b's JSON entry on this path."""
    from torchdrivesim_tpu_torch.examples import replay
    from torchdrivesim_tpu_torch.ops import hard
    t_phase = time.perf_counter()
    sim, states = replay.build_simulator(replay.parse_args(replay_argv(root, device)))
    frames = INTERACTION_FRAMES - 1

    # 1. B6b against its plain version on the first frame
    bg, ops, _, _ = replay_frame(sim)
    print(f'replay frame: {sim.npc_count} replayed NPCs, {ops[1].shape[1]} faces per '
          f'camera, res {REPLAY_RES}')
    if len(ops) != 3:
        raise AssertionError('replay frame: not the chunked kernel')
    kind, err = compare_hard(hard, ops, bg, REPLAY_RES, 'replay first frame')
    errs = [err]

    # 2. the first frames against the CPU
    replay_compare_with_cpu(root, device)

    # 3. the main path: the example, one B6b launch per frame
    hard.PACKED_LAUNCHES = hard.CHUNKED_LAUNCHES = 0
    with count_calls(hard, ['raster_chunked_reference', 'raster_packed_reference']) as plain:
        t0 = time.perf_counter()
        sim = replay.main(replay_argv(root, device))
        torch.cuda.synchronize()
        example_s = time.perf_counter() - t0
    launches = {'hard_raster_packed': hard.PACKED_LAUNCHES,
                'hard_raster_chunked': hard.CHUNKED_LAUNCHES}
    print(f'replay main path: the example, {frames} frames in {example_s:.2f} s '
          f'(npz written), launches {launches}, plain calls {plain} [{card}]')
    if launches != {'hard_raster_packed': 0, 'hard_raster_chunked': frames} or \
            any(plain.values()):
        raise AssertionError('replay: expected one B6b launch per frame and no plain call')
    video = np.load('build/replay_example.npz')['frames']
    drawn = float((video.reshape(frames, -1, 3).max(axis=-1) > 0).mean())
    print(f'replay frames {video.shape} {video.dtype}, {drawn * 100:.1f}% of pixels drawn')
    if video.shape != (frames, REPLAY_RES, REPLAY_RES, 3) or not drawn > 0.05:
        raise AssertionError('replay: the frames do not show the map')
    torch.testing.assert_close(sim.get_npc_state(), states[:, 1:, frames])
    bg, ops, mesh, cams = replay_frame(sim)
    errs.append(compare_hard(hard, ops, bg, REPLAY_RES, 'replay last frame')[1])

    # 4. no host sync in the replayed step: captured in a CUDA graph
    action = states[:, :1, 1]
    step = lambda: sim.functional_step(sim.state, action)
    eager = step()
    replayed = graph_replay(step)
    for name in ('agent_state', 'npc_state', 'npc_present_mask', 'npc_time'):
        compare_exact(getattr(replayed, name).float(), getattr(eager, name).float(),
                      f'replay step {name}, CUDA graph replay against eager')

    # 5. times, bound, frames/s
    coef, zbits, rgb = ops
    kernel_ms = graph_ms(lambda: hard.raster(ops, bg, REPLAY_RES), 20)
    plain_ms = cuda_ms(lambda: hard.raster_reference(ops, bg, REPLAY_RES), 2)
    pairs = hard_tile_pairs(sim.renderer, mesh, cams, zbits != hard.Z_SENTINEL,
                            REPLAY_RES)
    listed = hard.hard_tile_keep_reference(coef, zbits, hard.Z_SENTINEL, REPLAY_RES)
    n_bytes = nbytes(coef, zbits, rgb) + 2 * REPLAY_RES * REPLAY_RES * 3 * 4
    bound_ms, bound_by = bound(n_bytes, pairs * BOUND_TILE ** 2 * HARD_CHUNKED_FACE_OPS)
    tiles = hard.hard_tiles(REPLAY_RES)
    print(f'replay: hard_raster_chunked kernel 1 camera of {REPLAY_RES} px, '
          f'{zbits.shape[1]} faces: {kernel_ms:.4f} ms (device, graph replay); plain '
          f'version {plain_ms:.3f} ms; bound {bound_ms * 1e3:.3f} us by {bound_by}; '
          f'{pairs / tiles:.1f} faces per {BOUND_TILE} x {BOUND_TILE} tile overlap it by '
          f'bounding box, the plain cull lists {int(listed.sum()) / tiles:.1f} [{card}]')
    sim, states = replay.build_simulator(replay.parse_args(replay_argv(root, device)))

    def frame(t):
        image = sim.render_egocentric()
        sim.step(states[:, :1, t + 1])
        return image

    frame(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(1, frames):
        frame(t)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    print(f'replay loop: {(frames - 1) / loop_s:.1f} frames/s (render_egocentric + '
          f'step, host clock); {device_ops(lambda: frame(0))} device ops per frame '
          f'[{card}]')
    profile_step(lambda: frame(0), 'replay frame', card, count=('hard',))
    print(f'replay phase: {time.perf_counter() - t_phase:.1f} s')
    return {'name': 'hard_raster_chunked_replay', 'route': 'cuda',
            'source': 'torchdrivesim_tpu_torch/csrc/hard_raster.cu',
            'replaces': 'torchdrivesim_tpu/ops/pallas_rasterize.py:152',
            'launches': launches['hard_raster_chunked'], 'max_abs_err': max(errs),
            'ms': kernel_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': None}


def dataset_il_world(root: str, batch: int, horizon: int, res: int, device,
                     dtype=torch.bfloat16):
    """The dataset imitation-learning scenario of the example's dataset
    branch on the written data: (simulator, expert (T, B, 1, 4), policy
    ``BirdviewCNNPolicy(4, (16, 32))`` in ``dtype`` from seed 0)."""
    from torchdrivesim_tpu_torch.imitation import (
        build_dataset_batch, build_synthetic_simulator)
    road, states0, expert, npc = build_dataset_batch(root, 'carla_Town02', batch,
                                                     horizon, device)
    sim = build_synthetic_simulator(road, states0, res=res, npc_controller=npc)
    return sim, expert, il_policy(IL_FEATURES, dtype, device, action_size=4)


def dataset_il_frame(sim, state):
    """B5's operands for the frame the rollout renders from ``state``
    (``imitation.ego_view``, ``Renderer.soft_frame_operands``,
    ``soft.pad_to_groups``): (background, (coef, zw, color))."""
    from torchdrivesim_tpu_torch.imitation import ego_view
    from torchdrivesim_tpu_torch.ops import soft
    mesh, cams = ego_view(sim, state, sim.renderer.scale)
    background, frame = sim.renderer.soft_frame_operands(mesh, sim.renderer.res.width,
                                                         cams)
    return background, tuple(x.contiguous() for x in soft.pad_to_groups(*frame))


def dataset_il_compare_with_cpu(root: str, device):
    """The dataset BC loss and its policy gradients at B = 2, horizon 3,
    res 32 (float32 policy, cuDNN without TF32) on the card and on the
    CPU: loss to 1e-4, gradients to rtol 2e-3 (atol 1e-6 of each
    gradient's largest value)."""
    from torchdrivesim_tpu_torch.imitation import make_bc_loss_fn
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = {}
        for dev in (device, torch.device('cpu')):
            sim, expert, policy = dataset_il_world(root, 2, 3, 32, dev, torch.float32)
            loss = make_bc_loss_fn(sim, policy, 32)(sim.state, expert)
            grads = torch.autograd.grad(loss, list(policy.parameters()))
            runs[dev.type] = (loss.detach().cpu(), [g.cpu() for g in grads])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (lg, gg), (lc, gc) = runs['cuda'], runs['cpu']
    print(f'dataset IL compare B=2 horizon 3 res 32: loss card {float(lg)!r}, CPU '
          f'{float(lc)!r}')
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=0)
    worst = 0.0
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=1e-6 * float(b.abs().max()))
        worst = max(worst, float(((a - b).abs() / b.abs().max()).max()))
    print(f'dataset IL compare: {len(gg)} gradients agree, max difference {worst:.3g} '
          'of each gradient\'s largest value')


def dataset_il_path(device, card, root: str):
    """Imitation learning on INTERACTION cases (the example's dataset
    branch on the written data: B = 16 segments, the ego a simple-model
    agent, 19 replayed NPCs drawn in every frame, horizon 39, res 64 over
    the road mesh triangulated from Town02's .osm): B5a against its plain
    version bit for bit, B5b face by face and both kernels' tile lists
    against the plain cull on the first and the last frame (on the first
    also B5b for the transp chain alone and a planted fault that must come
    out over tolerance), a small gradient step against the CPU, the
    example's training steps pinned at 39 B5a and 38 B5b launches per
    rollout and no plain call, times, bounds, device ops and
    grad-rollouts/s. Returns the JSON entries of B5a and B5b on this
    path."""
    from torchdrivesim_tpu_torch.examples import imitation_learning
    from torchdrivesim_tpu_torch.imitation import (
        make_bc_loss_fn, make_bc_train_step, make_optimizer, render_ego)
    from torchdrivesim_tpu_torch.ops import soft, warp
    t_phase = time.perf_counter()
    sim, expert, policy = dataset_il_world(root, DATASET_IL_BATCH, DATASET_IL_HORIZON,
                                           DATASET_IL_RES, device)
    horizon = expert.shape[0]
    print(f'dataset IL: B={sim.batch_size}, {sim.npc_count} replayed NPCs, horizon '
          f'{horizon}, road mesh of {sim.road_mesh.faces.shape[-2]} faces')
    if horizon != min(DATASET_IL_HORIZON, INTERACTION_FRAMES - 1):
        raise AssertionError(f'horizon {horizon}')

    # 1. the kernels on the first frame: B5a bit for bit, B5b face by face
    # for the composite's cotangents and for the transp chain alone, the
    # planted fault seen, the tile lists equal to the plain cull's
    background, frame = dataset_il_frame(sim, sim.state)
    (fd, fo), (bd, bo), bits, _, grads, caught = compare_accum(
        soft, frame, background, DATASET_IL_RES, 31, 'dataset IL first frame')
    bad = sum(compare_tile_lists(soft, frame, DATASET_IL_RES, grads,
                                 'dataset IL first frame')[:2])
    errs, over = {'fwd': [fd], 'bwd': [bd]}, fo + bo
    if not all(caught):
        raise AssertionError(f'the planted fault went unseen on the first frame: {caught}')

    # 2. a small gradient step against the CPU
    dataset_il_compare_with_cpu(root, device)

    # 3. the main path: the example's training steps, then one train step
    counters = ('LAUNCHES', 'VJP_LAUNCHES')
    soft_counters = ('FWD_LAUNCHES', 'BWD_LAUNCHES', 'ACCUM_FWD_LAUNCHES',
                     'ACCUM_BWD_LAUNCHES')
    for name in counters:
        setattr(warp, name, 0)
    for name in soft_counters:
        setattr(soft, name, 0)
    with count_calls(soft, ['soft_accum_fwd_reference', 'soft_accum_bwd_reference']) \
            as plain:
        t0 = time.perf_counter()
        losses = imitation_learning.main([
            '--dataset-path', root, '--location', 'carla_Town02', '--batch',
            str(DATASET_IL_BATCH), '--horizon', str(DATASET_IL_HORIZON), '--res',
            str(DATASET_IL_RES), '--steps', str(DATASET_IL_STEPS)])
        torch.cuda.synchronize()
        example_s = time.perf_counter() - t0
    launches = {**{f'warp.{n}': getattr(warp, n) for n in counters},
                **{f'soft.{n}': getattr(soft, n) for n in soft_counters}}
    print(f'dataset IL main path: the example, {DATASET_IL_STEPS} training steps in '
          f'{example_s:.2f} s, losses {[round(x, 4) for x in losses]}, launches '
          f'{launches}, plain calls {plain} [{card}]')
    want = {'warp.LAUNCHES': 0, 'warp.VJP_LAUNCHES': 0, 'soft.FWD_LAUNCHES': 0,
            'soft.BWD_LAUNCHES': 0, 'soft.ACCUM_FWD_LAUNCHES': DATASET_IL_STEPS * horizon,
            'soft.ACCUM_BWD_LAUNCHES': DATASET_IL_STEPS * (horizon - 1)}
    if launches != want or any(plain.values()):
        raise AssertionError(f'dataset IL launches {launches}, expected {want}, and no '
                             'plain call')
    if not all(np.isfinite(losses)):
        raise AssertionError('dataset IL: non-finite loss')

    # the kernels on the frame of the state the rollout ends on
    with torch.no_grad():
        state = sim.state
        for _ in range(horizon):
            image = render_ego(sim, state, DATASET_IL_RES)
            state = sim.functional_step(state, policy(image)[:, None, :])
    image = render_ego(sim, state, DATASET_IL_RES)
    poses = len(torch.unique(torch.round(state.agent_state[:, 0, :2] * 100), dim=0))
    shown = int((state.npc_present_mask.sum(dim=-1) > 0).sum())
    print(f'dataset IL last frame: {poses} distinct camera positions, NPCs present in '
          f'{shown} of {DATASET_IL_BATCH} environments')
    if not torch.isfinite(image).all() or poses != DATASET_IL_BATCH:
        raise AssertionError('dataset IL last frame: non-finite or repeated views')
    # on the last frame, B5a bit for bit and B5b face by face for the
    # composite's cotangents (the plain versions' calls timed)
    background, frame = dataset_il_frame(sim, state)
    plain_fwd, fwd_ms = cuda_ms_once(
        lambda: soft.soft_accum_fwd_reference(*frame, DATASET_IL_RES))
    got = soft.soft_accum_fwd(*frame, DATASET_IL_RES)
    torch.cuda.synchronize()
    last_bits = sum(int((a != p).sum()) for a, p in zip(got, plain_fwd))
    errs['fwd'].append(max(float((a - p).abs().max()) for a, p in zip(got, plain_fwd)))
    print(f'dataset IL last frame: forward {last_bits} values differ from the plain version '
          'in any bit')
    frame_grads = composite_cotangents(soft, plain_fwd, background, 32)
    got = soft.soft_accum_bwd(*frame, *frame_grads)
    plain_bwd, bwd_ms = cuda_ms_once(
        lambda: soft.soft_accum_bwd_reference(*frame, *frame_grads))
    exact = soft.soft_accum_bwd_reference(*(x.double() for x in frame),
                                          *(g.double() for g in frame_grads))
    torch.cuda.synchronize()
    diff, last_over = judge_rows(got, plain_bwd, exact,
                                 'last frame backward, composite cotangents')
    errs['bwd'].append(diff)
    bad += sum(compare_tile_lists(soft, frame, DATASET_IL_RES, frame_grads,
                                  'dataset IL last frame')[:2])
    over, bits = over + last_over, bits + last_bits
    print(f'dataset IL: {over} values over tolerance, {bits} forward values off in any '
          f'bit, {bad} tile-list counts and entries differ from the plain cull')
    if over or bits or bad:
        raise AssertionError('dataset IL: the grouped kernels disagree with their plain '
                             'versions')

    # 4. times, bounds, device ops, grad-rollouts/s
    entries = []
    for name, fn, plain_ms, reps, backward, replaces, err, n in (
            ('soft_accum_fwd_dataset', lambda: soft.soft_accum_fwd(*frame, DATASET_IL_RES),
             fwd_ms, 20, False, 'torchdrivesim_tpu/ops/pallas_soft.py:393',
             max(errs['fwd']), launches['soft.ACCUM_FWD_LAUNCHES']),
            ('soft_accum_bwd_dataset', lambda: soft.soft_accum_bwd(*frame, *frame_grads),
             bwd_ms, 10, True, 'torchdrivesim_tpu/ops/pallas_soft.py:414',
             max(errs['bwd']), launches['soft.ACCUM_BWD_LAUNCHES'])):
        ms = graph_ms(fn, reps)
        (bound_ms, bound_by), pairs = accum_bound(frame, DATASET_IL_RES, backward)
        print(f'{name} kernel B={DATASET_IL_BATCH} res={DATASET_IL_RES} '
              f'F={frame[0].shape[1]}: {ms:.4f} ms (device, graph replay); plain version '
              f'{plain_ms:.3f} ms (one call); bound {bound_ms * 1e3:.3f} us by {bound_by} '
              f'({pairs} (pixel, face) pairs can contribute) [{card}]')
        entries.append({'name': name, 'route': 'cuda',
                        'source': 'torchdrivesim_tpu_torch/csrc/soft_accum.cu',
                        'replaces': replaces, 'launches': n, 'max_abs_err': err,
                        'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                        'bound_by': bound_by, 'library_ms': None})
    train_step = make_bc_train_step(sim, policy, make_optimizer(policy), DATASET_IL_RES)
    train_step(sim.state, expert)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DATASET_IL_STEPS):
        train_step(sim.state, expert)
    torch.cuda.synchronize()
    rate = DATASET_IL_STEPS / (time.perf_counter() - t0)
    loss_fn = make_bc_loss_fn(sim, policy, DATASET_IL_RES)
    rollout = lambda: loss_fn(sim.state, expert).backward()
    print(f'dataset IL gradient step B={DATASET_IL_BATCH} horizon {horizon}: {rate:.3f} '
          f'grad-rollouts/s ({rate * DATASET_IL_BATCH * horizon:.1f} env-steps/s, host '
          f'clock over {DATASET_IL_STEPS} train steps) [{card}]')
    profile_step(rollout, 'dataset IL gradient rollout', card, count=('accum_',))
    print(f'dataset IL phase: {time.perf_counter() - t_phase:.1f} s')
    return entries


def gym_compare_with_cpu(device):
    """Three steps of ``GymEnv`` on the card and on the CPU: observations
    >= 99.9% identical pixels, rewards and infos to 1e-4."""
    from torchdrivesim_tpu_torch.gym_env import GymEnv, GymEnvConfig
    actions = np.random.RandomState(0).uniform(-1, 1, (COMPARE_STEPS, 2))
    runs = []
    for dev in (device, torch.device('cpu')):
        env = GymEnv(GymEnvConfig(), device=dev)
        runs.append([env.reset()[0]] + [env.step(a) for a in actions])
    for i, (og, oc) in enumerate(zip(*runs)):
        if i:
            for k in oc[4]:
                np.testing.assert_allclose(og[4][k], oc[4][k], atol=1e-4, rtol=1e-4,
                                           err_msg=k)
            np.testing.assert_allclose(og[1], oc[1], atol=1e-4, rtol=1e-4)
            og, oc = og[0], oc[0]
        same = float((og == oc).all(axis=0).mean())
        print(f'gym compare observation {i}: {same * 100:.4f}% of pixels identical on the '
              'card and the CPU')
        if same < 0.999:
            raise AssertionError(f'gym observation {i}: images differ')


def gym_env_path(device, card):
    """The single-ego ``GymEnv`` (carla_Town02, 6 agents, textured, res 64,
    fov 35 m; one camera per agent, the ego's view observed) through
    ``SingleAgentWrapper``: B1 against its plain version on the first and
    the last observation's frame, 3 steps against the CPU, an episode of
    ``GYM_STEPS`` steps pinned at one B1 launch per observation and no
    plain call, times, bound and env steps/s. Returns B1's JSON entry on
    this path."""
    from torchdrivesim_tpu_torch.gym_env import GymEnv, GymEnvConfig, SingleAgentWrapper
    from torchdrivesim_tpu_torch.ops import fused
    t_phase = time.perf_counter()
    cfg = GymEnvConfig(max_steps=GYM_STEPS)
    env = SingleAgentWrapper(GymEnv(cfg, device=device))
    env.reset()

    def frame():
        prims, cams = env.env.sim.egocentric_prim_frame()
        mip, ops, res, n, screen = env.env.sim.renderer.fused_frame_operands(
            *prims, cfg.res, cams)
        return mip, ops, res, screen

    mip, ops, res, _ = frame()
    print(f'gym frame: {ops[0].shape[0]} cameras of {res} px (one per agent), qcoef '
          f'{tuple(ops[2].shape)}, tcoef {tuple(ops[4].shape)}')
    errs = [compare_fused(fused, mip, ops, 'gym first frame', res)]
    gym_compare_with_cpu(device)

    # the main path: reset and an episode, one B1 launch per observation
    actions = np.random.RandomState(2).uniform(-0.3, 0.3, (GYM_STEPS, 2))
    fused.LAUNCHES = 0
    with count_calls(fused, ['render_coefs_fused_reference']) as plain:
        t0 = time.perf_counter()
        obs, _ = env.reset()
        steps = 0
        for action in actions:
            obs, reward, terminated, truncated, info = env.step(action)
            steps += 1
            if terminated or truncated:
                break
        loop_s = time.perf_counter() - t0
    launches = fused.LAUNCHES
    print(f'gym main path: reset and {steps} steps in {loop_s:.2f} s ({steps / loop_s:.1f} '
          f'env steps/s, host clock, observations read back), fused_render launches '
          f'{launches}, plain calls {plain["render_coefs_fused_reference"]}; last reward '
          f'{reward:.3f}, info {info} [{card}]')
    if launches != steps + 1 or plain['render_coefs_fused_reference']:
        raise AssertionError('gym: expected one B1 launch per observation, no plain call')
    if obs.shape != (3, cfg.res, cfg.res) or not np.isfinite(obs).all() or \
            not np.isfinite(reward):
        raise AssertionError('gym: bad observation or reward')
    mip, ops, res, screen = frame()
    errs.append(compare_fused(fused, mip, ops, 'gym last frame', res))

    kernel_ms = graph_ms(lambda: fused.render_coefs_fused(mip, *ops, res), 50)
    plain_ms = cuda_ms(lambda: fused.render_coefs_fused_reference(mip, *ops, res), 5)
    bound_ms, bound_by = fused_bound(mip, ops, screen, res, cfg.fov)
    step = lambda: env.step(actions[0])
    print(f'gym: fused_render kernel {ops[0].shape[0]} cameras of {res} px: '
          f'{kernel_ms:.4f} ms (device, graph replay); plain version {plain_ms:.3f} ms; '
          f'bound {bound_ms * 1e3:.3f} us by {bound_by}; {device_ops(step)} device ops '
          f'per env step [{card}]')
    profile_step(step, 'gym env step', card, count=('fused',))
    env.close()
    print(f'gym phase: {time.perf_counter() - t_phase:.1f} s')
    return {'name': 'fused_render_gym', 'route': 'cuda',
            'source': 'torchdrivesim_tpu_torch/csrc/fused_render.cu',
            'replaces': 'torchdrivesim_tpu/ops/pallas_fused.py:69',
            'launches': launches, 'max_abs_err': max(errs), 'ms': kernel_ms,
            'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': None}


# --- the rest of the render API -----------------------------------------------

#: the face-soup phase: frames of the headline world, two waypoint discs per
#: camera (numpy seed 5, one in four hidden)
FACES_FRAMES, FACES_WAYPOINTS = 100, 2
#: the textured differentiable view above 128 pixels
FULL_RES = 256


def faces_world(batch: int, device):
    """The headline world (Town02, 20 vehicles, the baked light schedule,
    texture) at ``batch`` environments and ``FACES_WAYPOINTS`` waypoint
    discs per camera, 10-60 m ahead of each ego (numpy seed 5, the same on
    every device), a quarter of them hidden: (scenario, waypoints (B, M,
    2), their mask (B, M))."""
    from torchdrivesim_tpu_torch.benchmark import build_benchmark_scenario
    scenario = build_benchmark_scenario(batch_size=batch, agent_count=AGENTS, res=RES,
                                        fov=FOV, device=device)
    ego = scenario.sim.get_state()[:, 0].cpu().numpy()
    rng = np.random.RandomState(5)
    dist = rng.uniform(10, 60, (batch, FACES_WAYPOINTS))
    head = np.stack([np.cos(ego[:, 2]), np.sin(ego[:, 2])], axis=-1)
    waypoints = ego[:, None, :2] + dist[..., None] * head[:, None]
    mask = rng.rand(batch, FACES_WAYPOINTS) > 0.25
    return (scenario, torch.as_tensor(waypoints.astype(np.float32), device=device),
            torch.as_tensor(mask, device=device))


def faces_frame(scenario, state, waypoints, mask):
    """The face soup of ``state`` (``generate_faces``: the agents, the
    lights in their scheduled state, the waypoint discs) and the egos'
    cameras."""
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    sim = scenario.sim
    faces = sim.birdview_mesh_generator.generate_faces(
        torch.cat([state.agent_state, state.npc_state], dim=-2),
        present_mask=torch.cat([state.present_mask, state.npc_present_mask], dim=-1),
        traffic_light_state=state.traffic_control_state['traffic_light'],
        waypoints=waypoints, waypoints_rendering_mask=mask)
    ego = state.agent_state[:, 0]
    cams = Cameras(ego[:, :2], torch.stack([torch.sin(ego[:, 2]), torch.cos(ego[:, 2])],
                                           dim=-1), 2.0 / FOV)
    return faces, cams


def faces_iteration(scenario, state, action, waypoints, mask):
    """One step of the world and the face-soup render of its frame:
    (state, (B, 3, RES, RES) image)."""
    from torchdrivesim_tpu_torch.utils import Resolution
    state = scenario.sim.functional_step(state, action)
    faces, cams = faces_frame(scenario, state, waypoints, mask)
    return state, scenario.sim.renderer.render_faces_chw(*faces, Resolution(RES, RES), cams)


def faces_operands(renderer, faces, cams):
    """B2's and B6a's operands of a face-soup frame from
    ``Renderer.face_frame_operands``: (background, hard operands, screen
    corners after the cull, (mip, fcoef, icoef) or None)."""
    from torchdrivesim_tpu_torch.ops.hard import hard_operands
    bg, (corners, z, colors), warp_ops = renderer.face_frame_operands(*faces, RES, cams)
    return bg, hard_operands(corners, z, colors), corners, warp_ops


def faces_compare_with_cpu(device):
    """``COMPARE_STEPS`` face-soup frames at B = 4 on the card against the
    CPU: >= 99.9% identical pixels."""
    def run(dev):
        scenario, wps, mask = faces_world(COMPARE_BATCH, dev)
        state = scenario.sim.state
        action = torch.zeros((COMPARE_BATCH, AGENTS, 2), device=dev)
        images = []
        for _ in range(COMPARE_STEPS):
            state, image = faces_iteration(scenario, state, action, wps, mask)
            images.append(image.cpu())
        return images

    for i, (og, oc) in enumerate(zip(run(device), run(torch.device('cpu')))):
        same = float((og == oc).all(dim=1).float().mean())
        print(f'face soup compare frame {i}: {same * 100:.4f}% of pixels identical on '
              'the card and the CPU')
        if same < 0.999:
            raise AssertionError(f'face soup frame {i}: images differ')


def faces_path(device, card):
    """The face-soup render on the headline world (Town02, B = 256, 20
    vehicles, the baked light schedule, two waypoint discs per camera):
    ``generate_faces`` -> ``render_faces_chw`` at res 128, fov 70 m over the
    texture (B2, then B6a over the faces culled to 64), ``FACES_FRAMES``
    steps pinned at one B2 and one B6a launch per frame, no B1, no B6b, no
    plain call; B2 and B6a against their plain versions on the first and
    the last frame; one untextured frame (B6a over the color, culled to 64
    faces) and one of a differentiable renderer (HF over the
    full-resolution nearest sample, no B6a, no plain call, HF held to its
    plain version there); the first frames against the CPU; times, bounds
    and frames/s.
    Returns the JSON entries of B2, B6a and HF on this path."""
    from torchdrivesim_tpu_torch.ops import fused, hard, warp
    from torchdrivesim_tpu_torch.rendering import Renderer
    from torchdrivesim_tpu_torch.utils import Resolution
    t_phase = time.perf_counter()
    scenario, wps, mask = faces_world(BATCH, device)
    sim = scenario.sim
    faces, cams = faces_frame(scenario, sim.state, wps, mask)
    bg, ops, corners, (mip, fcoef, icoef) = faces_operands(sim.renderer, faces, cams)
    print(f'face soup: carla_Town02 B={BATCH}, {faces[1].shape[1]} faces per camera '
          f'culled to {ops[1].shape[1]}, texture level {tuple(mip.data.shape)}')
    if len(ops) != 2 or ops[1].shape[1] != sim.renderer.cfg.cull_max_faces:
        raise AssertionError('face soup frame: not the packed kernel over 64 faces')
    errs = {'warp_nearest': [compare_nearest(warp, mip, fcoef, icoef, RES, 'face soup first')],
            'hard_raster_packed': [compare_hard(hard, ops, bg, RES, 'face soup first frame')[1]]}
    faces_compare_with_cpu(device)

    # the main path: steps and face-soup frames, counting launches
    action = torch.zeros((BATCH, AGENTS, 2), device=device)
    state = sim.state
    warp.NEAREST_LAUNCHES = hard.PACKED_LAUNCHES = hard.CHUNKED_LAUNCHES = 0
    fused.LAUNCHES = 0
    with count_calls(hard, ['raster_packed_reference', 'raster_chunked_reference']) as plain, \
            count_calls(warp, ['warp_view_nearest_reference']) as plain_warp:
        t0 = time.perf_counter()
        for _ in range(FACES_FRAMES):
            state, image = faces_iteration(scenario, state, action, wps, mask)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    launches = {'warp_nearest': warp.NEAREST_LAUNCHES,
                'hard_raster_packed': hard.PACKED_LAUNCHES,
                'hard_raster_chunked': hard.CHUNKED_LAUNCHES, 'fused_render': fused.LAUNCHES}
    plain = {**plain, **plain_warp}
    print(f'face soup main path: {FACES_FRAMES} steps and frames at B={BATCH} in '
          f'{loop_s:.2f} s ({FACES_FRAMES * BATCH / loop_s:.1f} frames/s); launches '
          f'{launches}, plain calls {plain} [{card}]')
    want = {'warp_nearest': FACES_FRAMES, 'hard_raster_packed': FACES_FRAMES,
            'hard_raster_chunked': 0, 'fused_render': 0}
    if launches != want or any(plain.values()):
        raise AssertionError(f'face soup: launches {launches}, expected {want}, and no '
                             'plain call')
    if image.shape != (BATCH, 3, RES, RES) or not torch.isfinite(image).all():
        raise AssertionError(f'face soup image: shape {tuple(image.shape)} or non-finite')
    vehicle = torch.tensor(sim.renderer.color_map['vehicle'], dtype=torch.float32,
                           device=device)
    on_car = ((image - vehicle[None, :, None, None]).abs() < 0.5).all(dim=1)
    with_car = float((on_car.sum(dim=(1, 2)) >= 10).float().mean())
    print(f'face soup: {with_car * 100:.1f}% of views show vehicle pixels')
    if with_car < 0.9:
        raise AssertionError('face soup images do not show the vehicles')
    faces, cams = faces_frame(scenario, state, wps, mask)
    bg, ops, corners, (mip, fcoef, icoef) = faces_operands(sim.renderer, faces, cams)
    errs['warp_nearest'].append(compare_nearest(warp, mip, fcoef, icoef, RES,
                                                'face soup last'))
    errs['hard_raster_packed'].append(compare_hard(hard, ops, bg, RES,
                                                   'face soup last frame')[1])

    # one untextured frame: B6a over the color, the faces culled all the same
    plain_renderer = Renderer(sim.renderer.cfg, device)
    ubg, uops, _, uwarp = faces_operands(plain_renderer, faces, cams)
    if uwarp is not None or len(uops) != 2 or uops[1].shape[1] != 64:
        raise AssertionError('untextured face soup: not B6a over 64 faces')
    compare_hard(hard, uops, ubg, RES, 'untextured face soup frame')
    before = (hard.PACKED_LAUNCHES, warp.NEAREST_LAUNCHES)
    uimage = plain_renderer.render_faces_chw(*faces, Resolution(RES, RES), cams)
    torch.cuda.synchronize()
    if (hard.PACKED_LAUNCHES - before[0], warp.NEAREST_LAUNCHES - before[1]) != (1, 0):
        raise AssertionError('untextured face soup: not one B6a launch and no B2')
    print(f'untextured face soup frame: one B6a launch; background pixels '
          f'{float((uimage == 0).all(dim=1).float().mean()) * 100:.1f}%')

    # one differentiable frame: HF over the full-resolution nearest sample
    from torchdrivesim_tpu_torch.ops import hard_faces
    diff_renderer = Renderer(dataclasses.replace(sim.renderer.cfg, differentiable=True),
                             device)
    diff_renderer.background_texture = sim.renderer.background_texture
    dbg, dfaces, dwarp = diff_renderer.face_frame_operands(*faces, RES, cams)
    if dwarp is not None or dfaces[1].shape[1] != 64:
        raise AssertionError('differentiable face soup: not 64 faces over the full-'
                             'resolution sample')
    hf_ops = tuple(t.contiguous() for t in (*dfaces, dbg))
    hf_err = compare_hf(hf_ops, 'differentiable face soup frame')
    before = count_kernels()
    with count_calls(hard, ['raster_packed_reference', 'raster_chunked_reference']) as plain, \
            count_calls(hard_faces, ['hard_faces_reference']) as plain_faces:
        dimage = diff_renderer.render_faces_chw(*faces, Resolution(RES, RES), cams)
        torch.cuda.synchronize()
    ran = launched_since(before)
    if ran != {'hard_faces': 1} or any({**plain, **plain_faces}.values()):
        raise AssertionError(f'differentiable face soup: launches {ran}, plain calls '
                             f'{plain} {plain_faces}; expected one HF and no plain call')
    if not torch.equal(dimage, hard_faces.hard_faces(*hf_ops)[0] * 255.0):
        raise AssertionError('differentiable face soup image: not HF\'s on its operands')
    print('differentiable face soup frame: one HF launch, no B6a, no plain call')
    hf_entry = hf_json_entry('hard_faces_face_soup', hf_ops, hf_err, ran['hard_faces'],
                             card, 'differentiable face soup')

    # times and bounds on the last frame
    coef, pk = ops
    b = pk.shape[0]
    pixels = b * RES * RES
    image_bytes = pixels * 3 * 4
    pairs = tile_pairs(corners, pk != hard.PACKED_SENTINEL, RES)
    keep = hard.hard_tile_keep_reference(coef, pk, hard.PACKED_SENTINEL, RES)
    tiles = hard.hard_tiles(RES)
    print(f'face soup view: {pairs / (b * tiles):.2f} of {pk.shape[1]} faces per '
          f'{BOUND_TILE} x {BOUND_TILE} tile overlap it by bounding box; the plain cull '
          f'lists {int(keep.sum()) / (b * tiles):.2f}')
    entries = []
    for name, key, fn, plain_fn, n_bytes, n_ops, source, replaces in (
            ('warp_nearest_face_soup', 'warp_nearest',
             lambda: warp.warp_view_nearest(mip.data, fcoef, icoef, RES),
             lambda: warp.warp_view_nearest_reference(mip.data, fcoef, icoef, RES),
             nbytes(fcoef, icoef) + texel_bytes(mip, b, FOV) + image_bytes,
             pixels * NEAREST_PIXEL_OPS, 'torchdrivesim_tpu_torch/csrc/warp_nearest.cu',
             'torchdrivesim_tpu/ops/pallas_warp.py:373'),
            ('hard_raster_packed_face_soup', 'hard_raster_packed',
             lambda: hard.raster_packed(coef, pk, bg, RES),
             lambda: hard.raster_packed_reference(coef, pk, bg, RES),
             nbytes(coef, pk) + 2 * image_bytes, pairs * BOUND_TILE ** 2 * HARD_FACE_OPS,
             'torchdrivesim_tpu_torch/csrc/hard_raster.cu',
             'torchdrivesim_tpu/ops/pallas_rasterize.py:134')):
        ms = graph_ms(fn, 100)
        plain_ms = cuda_ms(plain_fn, 5)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        print(f'{name} kernel B={b} res={RES}: {ms:.4f} ms (device, graph replay); plain '
              f'version {plain_ms:.3f} ms; bound {bound_ms * 1e3:.3f} us by {bound_by} '
              f'({n_bytes / 1e6:.3f} MB, {n_ops / 1e6:.1f} M float32 ALU operations) '
              f'[{card}]')
        entries.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': launches[key],
                        'max_abs_err': max(errs[key]), 'ms': ms, 'plain_ms': plain_ms,
                        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None})
    frame = lambda: sim.renderer.render_faces_chw(*faces_frame(scenario, state, wps, mask)[0],
                                                  Resolution(RES, RES), cams)
    print(f'face soup frame (generate_faces + render_faces_chw) B={BATCH}: '
          f'{cuda_ms(frame, 20):.4f} ms eager, {device_ops(frame)} device ops [{card}]')
    print(f'face soup phase: {time.perf_counter() - t_phase:.1f} s')
    return entries + [hf_entry]


def count_kernels():
    """Every kernel's launch counter, by name."""
    from torchdrivesim_tpu_torch.ops import fused, hard, hard_faces, prims, soft, warp
    return {'fused_render': fused.LAUNCHES, 'warp_bilinear': warp.LAUNCHES,
            'warp_bilinear_vjp': warp.VJP_LAUNCHES, 'warp_nearest': warp.NEAREST_LAUNCHES,
            'soft_raster_fwd': soft.FWD_LAUNCHES, 'soft_raster_bwd': soft.BWD_LAUNCHES,
            'soft_accum_fwd': soft.ACCUM_FWD_LAUNCHES,
            'soft_accum_bwd': soft.ACCUM_BWD_LAUNCHES,
            'hard_raster_packed': hard.PACKED_LAUNCHES,
            'hard_raster_chunked': hard.CHUNKED_LAUNCHES,
            'prim_raster_banded': prims.B7_LAUNCHES, 'prim_raster': prims.B8_LAUNCHES,
            'hard_faces': hard_faces.LAUNCHES}


def launched_since(before):
    """The kernels launched since ``before`` (a :func:`count_kernels`), and
    how often."""
    return {k: v - before[k] for k, v in count_kernels().items() if v != before[k]}


def reference_configs_path(device, card):
    """The facade world (Town02, B = 64, 20 agents, texture, waypoints)
    built from the reference's renderer configurations through
    ``renderer_from_config``: ``CV2RendererConfig()`` and ``{'backend':
    'jax'}`` render the default configuration's egocentric frame bit for
    bit with the same launches (one B1); ``DummyRendererConfig()`` renders
    black frames and launches nothing; ``Pytorch3DRendererConfig()`` gives
    a differentiable renderer: one ``render_egocentric`` (the prim route's
    plain fallback, one float-color hard raster HF) and one differentiable
    mesh frame of the
    same cameras at res 64 (B3 and B4a, their backwards for the gradient)
    whose gradient to the agent states is finite and not zero, and B3, its
    VJP, B4a and B4b against their plain versions on that frame's
    operands."""
    from torchdrivesim_tpu_torch.ops import soft, warp
    from torchdrivesim_tpu_torch.rendering import (
        CV2RendererConfig, DummyRenderer, DummyRendererConfig, Pytorch3DRendererConfig,
        Renderer)
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    from torchdrivesim_tpu_torch.utils import Resolution
    t_phase = time.perf_counter()
    frames = {}
    for label, cfg in (('default', None), ('CV2RendererConfig()', CV2RendererConfig()),
                       ("{'backend': 'jax'}", {'backend': 'jax'}),
                       ('DummyRendererConfig()', DummyRendererConfig())):
        sim = facade_world(FACADE_BATCH, device, renderer_config=cfg)
        before = count_kernels()
        image = sim.render_egocentric(res=Resolution(RES, RES), fov=FOV)
        torch.cuda.synchronize()
        frames[label] = (type(sim.renderer).__name__, image, launched_since(before))
        print(f'reference configs: {label} -> {type(sim.renderer).__name__}, frame '
              f'{tuple(image.shape)}, launches {frames[label][2]}')
    name, want, want_launches = frames['default']
    if name != 'Renderer' or want_launches != {'fused_render': 1}:
        raise AssertionError(f'default configuration: {name}, {want_launches}')
    for label in ('CV2RendererConfig()', "{'backend': 'jax'}"):
        name, image, got = frames[label]
        if name != 'Renderer' or not torch.equal(image, want) or got != want_launches:
            raise AssertionError(f'{label}: {name}, launches {got}, or the frame differs '
                                 'from the default configuration\'s')
    name, image, got = frames['DummyRendererConfig()']
    if name != DummyRenderer.__name__ or image.any() or got:
        raise AssertionError(f'DummyRendererConfig(): {name}, launches {got}, or a frame '
                             'that is not black')
    sim = facade_world(FACADE_BATCH, device, renderer_config=Pytorch3DRendererConfig())
    if type(sim.renderer) is not Renderer or not sim.renderer.cfg.differentiable:
        raise AssertionError('Pytorch3DRendererConfig(): not a differentiable Renderer')
    before = count_kernels()
    image = sim.render_egocentric(res=Resolution(64, 64), fov=FOV)
    torch.cuda.synchronize()
    ran = launched_since(before)
    print(f'reference configs: Pytorch3DRendererConfig() render_egocentric at res 64 '
          f'(the prim route\'s plain fallback): launches {ran}')
    if ran != {'hard_faces': 1}:
        raise AssertionError(f'Pytorch3D render_egocentric: launches {ran}, expected one HF')
    x = sim.get_state().detach().clone().requires_grad_()
    sim.state = dataclasses.replace(sim.state, agent_state=x)
    before = count_kernels()
    mesh, cams = sim.egocentric_mesh_frame(fov=FOV)
    frame = sim.renderer.render_rgb_mesh_chw(mesh, Resolution(64, 64), cams)
    w = torch.rand(frame.shape, generator=torch.Generator(device).manual_seed(0),
                   device=device)
    (grad,) = torch.autograd.grad((frame * w).sum(), x)
    torch.cuda.synchronize()
    got = launched_since(before)
    print(f'reference configs: Pytorch3DRendererConfig() differentiable mesh frame of '
          f'{cams.xy.shape[0]} cameras at res 64: launches {got}; gradient to the agent '
          f'states: max |g| {float(grad.abs().max()):.4g}')
    want = {'warp_bilinear': 1, 'warp_bilinear_vjp': 1, 'soft_raster_fwd': 1,
            'soft_raster_bwd': 1}
    if got != want or not torch.isfinite(grad).all() or not float(grad.abs().max()) > 0:
        raise AssertionError(f'differentiable frame: launches {got}, expected {want}, or '
                             'a gradient that is not finite or zero')
    # the frame's kernels against their plain versions on its own operands
    renderer = sim.renderer
    cams = Cameras(cams.xy.detach(), cams.sc.detach(), cams.scale)
    wargs = (renderer._warp_mip(cams.scale, 64), cams.xy, cams.sc, cams.scale,
             renderer._background_color, renderer.cfg.left_handed_coordinates)
    _, warp_bits = compare_warp(warp, wargs, 64, 'Pytorch3D frame')
    _, vjp_over = compare_warp_vjp(warp, wargs, 64, 11, 'Pytorch3D frame')
    bg, (coef, zw, color) = renderer.soft_frame_operands(mesh, 64, cams)
    ops = tuple(t.detach().contiguous() for t in (coef, zw, color, bg))
    g = torch.empty_like(ops[3]).uniform_(-1, 1)
    (_, fwd_over), bwd, bits = compare_soft(soft, ops, g, 'Pytorch3D frame')
    if warp_bits or vjp_over or fwd_over or bits or sum(o for _, o in bwd):
        raise AssertionError('Pytorch3D frame: B3, its VJP, B4a or B4b disagree with their '
                             'plain versions')
    print(f'reference configs phase: {time.perf_counter() - t_phase:.1f} s')


def il_grad_compare_with_cpu(device, configure, label, loss=None):
    """A small IL gradient (B = 2, horizon 3, float32 policy, cuDNN without
    TF32) of config 4's world with ``configure(scenario)`` applied, on the
    card and on the CPU: losses and gradients to rtol 1e-3 (atol 1e-6 x
    max|grad|). ``loss(scenario, policy)`` gives the loss function of a
    state (by default ``make_il_loss_fn``'s, horizon 3)."""
    from torchdrivesim_tpu_torch.benchmark import build_il_scenario, make_il_loss_fn
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for dev in (device, torch.device('cpu')):
            scn = build_il_scenario(batch_size=2, agent_count=IL_AGENTS, res=IL_RES,
                                    device=dev)
            configure(scn)
            policy = il_policy(IL_FEATURES, torch.float32, dev)
            fn = loss(scn, policy) if loss is not None else make_il_loss_fn(scn, policy, 3)
            value = fn(scn.sim.state)
            grads = torch.autograd.grad(value, list(policy.parameters()))
            runs.append((value.detach().cpu(), [g.cpu() for g in grads]))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (lg, gg), (lc, gc) = runs
    print(f'{label} compare B=2 horizon 3: loss card {float(lg)!r}, CPU {float(lc)!r}')
    torch.testing.assert_close(lg, lc, rtol=1e-3, atol=0)
    worst = 0.0
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6 * float(b.abs().max()))
        worst = max(worst, float(((a - b).abs() / b.abs().max()).max()))
    print(f'{label} compare: {len(gg)} gradients agree, max difference {worst:.3g} of '
          'each gradient\'s largest value')


def soft_entry(name, soft, ops, g, err, n, backward, card):
    """The JSON entry of B4a (or, with ``backward``, B4b) on ``ops`` =
    (coef, zw, color, background), timed by graph replay, its bound
    counting the (pixel, face) pairs of the tiles each face can reach."""
    coef, zw, color, bg = ops
    res = bg.shape[-1]
    face_pixels = soft_tile_pairs(coef, res) * BOUND_TILE * BOUND_TILE
    if backward:
        fn = lambda: soft.soft_raster_bwd(*ops, g)
        plain = lambda: soft.soft_raster_bwd_reference(*ops, g)
        n_bytes, n_ops, n_sfu = (nbytes(*ops, g) + nbytes(coef, zw, color, bg),
                                 face_pixels * SOFT_BWD_OPS, face_pixels * SOFT_BWD_SFU)
    else:
        fn = lambda: soft.soft_raster_fwd(*ops)
        plain = lambda: soft.soft_raster_fwd_reference(*ops)
        n_bytes, n_ops, n_sfu = (nbytes(*ops) + nbytes(bg), face_pixels * SOFT_FWD_OPS,
                                 face_pixels * SOFT_FWD_SFU)
    ms, plain_ms = graph_ms(fn, 100), cuda_ms(plain, 3)
    bound_ms, bound_by = bound(n_bytes, n_ops, n_sfu)
    print(f'{name} kernel B={coef.shape[0]} res={res} F={coef.shape[1]}: {ms:.4f} ms '
          f'(device, graph replay); plain version {plain_ms:.3f} ms; bound '
          f'{bound_ms * 1e3:.3f} us by {bound_by} [{card}]')
    return {'name': name, 'route': 'cuda', 'source': 'torchdrivesim_tpu_torch/csrc/soft_raster.cu',
            'replaces': 'torchdrivesim_tpu/ops/pallas_soft.py:199' if backward
            else 'torchdrivesim_tpu/ops/pallas_soft.py:177',
            'launches': n, 'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None}


def no_fast_background(scenario):
    scenario.sim.renderer.cfg.diff_fast_background = False


def full_background_path(device, card):
    """The full-resolution bilinear backgrounds on config 4's world (Town02,
    B = 16, 8 vehicles, res 64, fov 70 m, textured): one gradient rollout
    (horizon 40) with ``diff_fast_background=False`` (sample_background_quad
    under B4a / B4b: 40 / 39 launches, no B3), B4a and B4b against their
    plain versions on its first frame, its gradients against the CPU at
    rtol 1e-3; one textured differentiable frame at res 256 (the quad
    background under B5a / B5b), B5a and B5b against their plain versions,
    its forward against the CPU and its pose gradient finite; one frame with
    an explicit ``background_texture=`` (sample_background under B4a), B4a
    and B4b against their plain versions on its operands.
    Returns the JSON entries of B4a and B4b under the quad background and of
    B5a and B5b on the 256 px view."""
    from torchdrivesim_tpu_torch.benchmark import (
        build_il_scenario, il_view, load_or_bake_texture, make_il_grad_fn)
    from torchdrivesim_tpu_torch.map import find_map_config
    from torchdrivesim_tpu_torch.ops import soft, warp
    from torchdrivesim_tpu_torch.utils import Resolution
    t_phase = time.perf_counter()
    scenario = build_il_scenario(batch_size=IL_BATCH, agent_count=IL_AGENTS, res=IL_RES,
                                 device=device)
    no_fast_background(scenario)
    renderer = scenario.sim.renderer
    state = scenario.sim.state
    mesh, cams = il_view(scenario, state)
    bg, (coef, zw, color) = renderer.soft_frame_operands(mesh, IL_RES, cams)
    ops = (coef, zw.contiguous(), color, bg.contiguous())
    g = torch.empty_like(bg).uniform_(-1, 1)
    (fd, fo), bwd, bits = compare_soft(soft, ops, g, 'quad background first frame')
    if fo or bits or sum(o for _, o in bwd):
        raise AssertionError('quad background frame: B4a or B4b disagree with their plain '
                             'versions')
    il_grad_compare_with_cpu(device, no_fast_background, 'quad background IL')

    policy = il_policy(IL_FEATURES, torch.bfloat16, device)
    grad_fn = make_il_grad_fn(scenario, policy, horizon=IL_HORIZON)
    before = count_kernels()
    with count_calls(warp, PLAIN_WARP) as plain_calls:
        t0 = time.perf_counter()
        loss, grads = grad_fn(state)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    launches = launched_since(before)
    print(f'quad background main path: one gradient rollout, B={IL_BATCH}, res {IL_RES}, '
          f'horizon {IL_HORIZON}, in {step_s:.2f} s; loss {float(loss)!r}; launches '
          f'{launches}; plain warp calls {plain_calls} [{card}]')
    want = {'soft_raster_fwd': IL_HORIZON, 'soft_raster_bwd': IL_HORIZON - 1}
    if launches != want or any(plain_calls.values()):
        raise AssertionError(f'quad background: launches {launches}, expected {want}')
    if not torch.isfinite(loss) or not all(torch.isfinite(x).all() for x in grads):
        raise AssertionError('quad background: non-finite loss or gradient')
    entries = [soft_entry('soft_raster_fwd_quad_background', soft, ops, g, fd,
                          launches['soft_raster_fwd'], False, card),
               soft_entry('soft_raster_bwd_quad_background', soft, ops, g,
                          max(d for d, _ in bwd), launches['soft_raster_bwd'], True, card)]
    fwd_ms = cuda_ms(lambda: renderer.render_rgb_mesh_chw(mesh, Resolution(IL_RES, IL_RES),
                                                          cams), 20)
    print(f'quad background frame (sample_background_quad + B4a) B={IL_BATCH} res '
          f'{IL_RES}: {fwd_ms:.4f} ms eager [{card}]')

    # the textured differentiable view at res 256: the quad background under
    # the grouped kernels
    renderer.cfg.diff_fast_background = True
    x = state.agent_state.detach().clone().requires_grad_()
    view = dataclasses.replace(state, agent_state=x)
    mesh, cams = il_view(scenario, view)
    bg, frame = renderer.soft_frame_operands(mesh, FULL_RES, cams)
    frame = [t.detach().contiguous() for t in soft.pad_to_groups(*frame)]
    (afd, afo), (abd, abo), abits, _, _, _ = compare_accum(
        soft, frame, bg.detach(), FULL_RES, 7, f'res {FULL_RES} quad background')
    if afo or abits or abo:
        raise AssertionError(f'res {FULL_RES} view: B5a or B5b disagree with their plain '
                             'versions')
    before = count_kernels()
    image = renderer.render_rgb_mesh_chw(mesh, Resolution(FULL_RES, FULL_RES), cams)
    (gx,) = torch.autograd.grad(image.mean(), x)
    torch.cuda.synchronize()
    got = launched_since(before)
    print(f'res {FULL_RES} textured differentiable frame B={IL_BATCH}: launches {got}; '
          f'pose gradient max |g| {float(gx.abs().max()):.4g}')
    if got != {'soft_accum_fwd': 1, 'soft_accum_bwd': 1} or \
            not torch.isfinite(gx).all() or not float(gx.abs().max()) > 0:
        raise AssertionError(f'res {FULL_RES} frame: launches {got}, or a gradient that is '
                             'not finite or zero')
    cpu = build_il_scenario(batch_size=2, agent_count=IL_AGENTS, res=IL_RES, device='cpu')
    cpu_mesh, cpu_cams = il_view(cpu, cpu.sim.state)
    want_img = cpu.sim.renderer.render_rgb_mesh_chw(cpu_mesh, Resolution(FULL_RES, FULL_RES),
                                                    cpu_cams)
    diff = float((image[:2].detach().cpu() - want_img).abs().max()) / 255
    print(f'res {FULL_RES} frame, environments 0-1 card against the CPU: max difference '
          f'{diff:.3g} of the range')
    if not diff < 1e-4:
        raise AssertionError(f'res {FULL_RES} frame: card and CPU differ by {diff}')
    for name, backward, err in ((f'soft_accum_fwd_res{FULL_RES}', False, afd),
                                (f'soft_accum_bwd_res{FULL_RES}', True, abd)):
        (bound_ms, bound_by), _ = accum_bound(frame, FULL_RES, backward)
        if backward:
            cot = composite_cotangents(soft, soft.soft_accum_fwd(*frame, FULL_RES), bg.detach(), 7)
            fn = lambda: soft.soft_accum_bwd(*frame, *cot)
            plain_ms = cuda_ms_once(lambda: soft.soft_accum_bwd_reference(*frame, *cot))[1]
        else:
            fn = lambda: soft.soft_accum_fwd(*frame, FULL_RES)
            plain_ms = cuda_ms_once(lambda: soft.soft_accum_fwd_reference(*frame, FULL_RES))[1]
        ms = graph_ms(fn, 20)
        print(f'{name} kernel B={IL_BATCH} res={FULL_RES} F={frame[0].shape[1]}: {ms:.4f} ms '
              f'(device, graph replay); plain version {plain_ms:.3f} ms; bound '
              f'{bound_ms * 1e3:.3f} us by {bound_by} [{card}]')
        entries.append({'name': name, 'route': 'cuda',
                        'source': 'torchdrivesim_tpu_torch/csrc/soft_accum.cu',
                        'replaces': 'torchdrivesim_tpu/ops/pallas_soft.py:535' if backward
                        else 'torchdrivesim_tpu/ops/pallas_soft.py:482',
                        'launches': got['soft_accum_bwd' if backward else 'soft_accum_fwd'],
                        'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None})

    # an explicit background texture: its bilinear sample under B4a
    texture = load_or_bake_texture(find_map_config('carla_Town02'))
    mesh, cams = il_view(scenario, state)
    before = count_kernels()
    image = renderer.render_rgb_mesh_chw(mesh, Resolution(IL_RES, IL_RES), cams,
                                         background_texture=texture)
    torch.cuda.synchronize()
    got = launched_since(before)
    own = renderer.render_rgb_mesh_chw(mesh, Resolution(IL_RES, IL_RES), cams)
    diff = float((image - own).abs().max())
    print(f'explicit background_texture frame B={IL_BATCH} res {IL_RES}: launches {got}; '
          f'difference from the mip warp\'s frame max {diff:.3f}, mean '
          f'{float((image - own).abs().mean()):.3f} of 255')
    if got != {'soft_raster_fwd': 1} or not torch.isfinite(image).all():
        raise AssertionError(f'explicit texture frame: launches {got}')
    bg, (coef, zw, color) = renderer.soft_frame_operands(mesh, IL_RES, cams,
                                                         background_texture=texture)
    tops = (coef, zw.contiguous(), color, bg.contiguous())
    (_, fo), bwd, bits = compare_soft(soft, tops, torch.empty_like(bg).uniform_(-1, 1),
                                      'explicit texture frame')
    if fo or bits or sum(o for _, o in bwd):
        raise AssertionError('explicit texture frame: B4a or B4b disagree with their plain '
                             'versions')
    print(f'full-resolution background phase: {time.perf_counter() - t_phase:.1f} s')
    return entries


def painter_frame(scenario, x):
    """Config 4's frame of agent states ``x`` under the renderer's blend."""
    from torchdrivesim_tpu_torch.benchmark import il_view
    mesh, cams = il_view(scenario, dataclasses.replace(scenario.sim.state, agent_state=x))
    return scenario.sim.renderer.render_rgb_mesh_chw(mesh, scenario.sim.renderer.res, cams)


def painter_path(device, card):
    """The painter's blend (``soft_blend='painter'``) on config 4's frame
    (B = 16, res 64, the bilinear mip warp B3 under it): forward and the
    gradient to the agent states on the card against the CPU (values
    1e-5 of the range, gradients rtol 1e-3 of the largest), ms per frame
    forward and forward with backward."""
    from torchdrivesim_tpu_torch.benchmark import build_il_scenario
    t_phase = time.perf_counter()
    out = []
    for dev in (device, torch.device('cpu')):
        scenario = build_il_scenario(batch_size=IL_BATCH, agent_count=IL_AGENTS, res=IL_RES,
                                     device=dev)
        scenario.sim.renderer.cfg.soft_blend = 'painter'
        x = scenario.sim.get_state().detach().clone().requires_grad_()
        image = painter_frame(scenario, x)
        w = torch.linspace(0, 1, image.numel(), device=dev).reshape(image.shape)
        (g,) = torch.autograd.grad((image * w).sum(), x)
        out.append((image.detach().cpu(), g.cpu(), scenario, x))
    (ig, gg, scenario, x), (ic, gc, _, _) = out
    diff = float((ig - ic).abs().max()) / 255
    gdiff = float((gg - gc).abs().max()) / float(gc.abs().max())
    print(f'painter frame B={IL_BATCH} res {IL_RES}: card against the CPU, values max '
          f'difference {diff:.3g} of the range, gradient {gdiff:.3g} of its largest value')
    if not diff <= 1e-5 or not gdiff <= 1e-3 or not float(gc.abs().max()) > 0:
        raise AssertionError('painter frame: card and CPU differ')
    forward = lambda: painter_frame(scenario, x.detach())

    def both():
        image = painter_frame(scenario, x)
        torch.autograd.grad(image.sum(), x)
    print(f'painter frame B={IL_BATCH} res {IL_RES}: {cuda_ms(forward, 10):.3f} ms forward, '
          f'{cuda_ms(both, 10):.3f} ms forward and backward (eager) [{card}]')
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    both()
    print(f'painter frame forward and backward peak memory above the scenario: '
          f'{(torch.cuda.max_memory_allocated(device) - base) / 2**20:.1f} MiB [{card}]')
    print(f'painter phase: {time.perf_counter() - t_phase:.1f} s')


def expert_frames(scenario, horizon: int):
    """(T, B, A, 4) expert states: the scenario rolled forward with seeded
    small actions (numpy seed 8), no gradient."""
    sim, state = scenario.sim, scenario.sim.state
    rng = np.random.RandomState(8)
    frames = []
    with torch.no_grad():
        for _ in range(horizon):
            action = torch.as_tensor(rng.uniform(-0.3, 0.3, (sim.batch_size, sim.agent_count,
                                                            sim.action_size)),
                                     dtype=torch.float32, device=sim.device)
            state = sim.functional_step(state, action)
            frames.append(state.agent_state)
    return torch.stack(frames)


def teacher_forcing_path(device, card):
    """Teacher-forced behaviour cloning on config 4's world (Town02, B = 16,
    8 vehicles, res 64, textured; the first agent driven by the policy, the
    others holding zero action; the expert of :func:`expert_frames`): one
    ``make_bc_train_step(..., teacher_forcing=True)`` of horizon 40 pinned
    at 40 B3 and 40 B4a launches and no backward kernel (each frame is
    drawn from the expert's states, which the policy does not reach, so no
    gradient flows through a render), the loss and policy gradients at B =
    2, horizon 3 against the CPU at rtol 1e-3, grad-rollouts/s."""
    from torchdrivesim_tpu_torch.benchmark import build_il_scenario
    from torchdrivesim_tpu_torch.imitation import (
        make_bc_loss_fn, make_bc_train_step, make_optimizer)
    from torchdrivesim_tpu_torch.ops import warp
    t_phase = time.perf_counter()

    def teacher_loss(scn, policy):
        expert = expert_frames(scn, 3)
        fn = make_bc_loss_fn(scn.sim, policy, IL_RES, teacher_forcing=True)
        return lambda state: fn(state, expert)
    il_grad_compare_with_cpu(device, lambda scn: None, 'teacher-forced BC', teacher_loss)

    scenario = build_il_scenario(batch_size=IL_BATCH, agent_count=IL_AGENTS, res=IL_RES,
                                 device=device)
    expert = expert_frames(scenario, IL_HORIZON)
    policy = il_policy(IL_FEATURES, torch.bfloat16, device)
    train_step = make_bc_train_step(scenario.sim, policy, make_optimizer(policy), IL_RES,
                                    teacher_forcing=True)
    before = count_kernels()
    with count_calls(warp, PLAIN_WARP) as plain_calls:
        t0 = time.perf_counter()
        loss = train_step(scenario.sim.state, expert)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    launches = launched_since(before)
    print(f'teacher-forced BC main path: one train step, B={IL_BATCH}, res {IL_RES}, '
          f'horizon {IL_HORIZON}, in {step_s:.2f} s; loss {float(loss)!r}; launches '
          f'{launches}; plain warp calls {plain_calls} [{card}]')
    want = {'warp_bilinear': IL_HORIZON, 'soft_raster_fwd': IL_HORIZON}
    if launches != want or any(plain_calls.values()) or not torch.isfinite(loss):
        raise AssertionError(f'teacher forcing: launches {launches}, expected {want}, or '
                             'a loss that is not finite')
    if not all(p.grad is not None and torch.isfinite(p.grad).all()
               and float(p.grad.abs().max()) > 0 for p in policy.parameters()):
        raise AssertionError('teacher forcing: a parameter gradient is missing or zero')
    train_step(scenario.sim.state, expert)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        train_step(scenario.sim.state, expert)
    torch.cuda.synchronize()
    rate = 3 / (time.perf_counter() - t0)
    print(f'teacher-forced BC B={IL_BATCH} horizon {IL_HORIZON}: {rate:.3f} grad-rollouts/s, '
          f'{rate * IL_BATCH * IL_HORIZON:.1f} env-steps/s [{card}]')
    print(f'teacher forcing phase: {time.perf_counter() - t_phase:.1f} s')


def examples_path(device, card):
    """``examples/initialize_simulation.py`` (heuristic, one camera over
    Town02's center, res 512, fov 250 m, no texture: the whole map mesh),
    recording which kernels ran, with B6b against its plain version on the
    frame's operands and the written frame equal to B6b's there; and
    ``examples/lanelet2_to_birdview_mesh.py`` on Town02's .osm."""
    from torchdrivesim_tpu_torch.examples import initialize_simulation, lanelet2_to_birdview_mesh
    from torchdrivesim_tpu_torch.map import find_map_config
    from torchdrivesim_tpu_torch.ops import hard
    from torchdrivesim_tpu_torch.rendering import get_default_color_map
    t_phase = time.perf_counter()
    os.makedirs('build', exist_ok=True)
    before = count_kernels()
    with count_calls(hard, ['raster_packed_reference', 'raster_chunked_reference']) as plain:
        frame = initialize_simulation.main(['--out', 'build/initialized.npz',
                                            '--device', device.type])
    got = launched_since(before)
    road = np.asarray(get_default_color_map()['road'], np.uint8)
    on_road = float((frame == road).all(axis=-1).mean())
    print(f'initialize_simulation (heuristic, res {initialize_simulation.RES}, fov '
          f'{initialize_simulation.FOV} m): kernels '
          f'launched {got}, plain calls {plain}; {on_road * 100:.1f}% of pixels road')
    if got != {'hard_raster_chunked': 1} or any(plain.values()) or not on_road > 0.05:
        raise AssertionError(f'initialize_simulation: launches {got}, or no road drawn')
    # the example's frame again, its operands held to the plain B6b
    sim = initialize_simulation.build_simulator(
        initialize_simulation.parse_args(['--device', device.type]))
    center = sim.get_world_center().reshape(1, 2)
    mesh, cams = sim.mesh_frame(center, torch.zeros((1, 1), device=device),
                                fov=initialize_simulation.FOV)
    bg, ops, _ = sim.renderer.hard_frame_operands(mesh, initialize_simulation.RES, cams)
    if len(ops) != 3:
        raise AssertionError('initialize_simulation frame: not the chunked kernel')
    compare_hard(hard, ops, bg, initialize_simulation.RES, 'initialize_simulation frame')
    again = (hard.raster(ops, bg, initialize_simulation.RES) * 255.0)[0]
    if not np.array_equal(again.permute(1, 2, 0).to(torch.uint8).cpu().numpy(), frame):
        raise AssertionError('initialize_simulation: the written frame is not B6b\'s on '
                             'the frame\'s operands')
    mesh = lanelet2_to_birdview_mesh.main([
        '--osm', find_map_config('carla_Town02').lanelet_path,
        '--out', 'build/carla_Town02_lanelet_mesh.json'])
    print(f'lanelet2_to_birdview_mesh: {mesh.verts_count} verts, {mesh.faces_count} faces, '
          f'categories {mesh.categories}')
    if not mesh.faces_count > 1000:
        raise AssertionError('lanelet2_to_birdview_mesh: too few faces')
    print(f'examples phase: {time.perf_counter() - t_phase:.1f} s')


# --- the float-color hard raster (HF) and the map bakers ----------------------

#: float32 operations per (pixel, face) of HF's fold (csrc/hard_faces.cu):
#: three edge values (3 subtractions and products each), six compares,
#: the two coverage combinations and the z test
HF_FACE_OPS = 3 * 5 + 6 + 4 + 2
HF_RES = (64, 128)
TEXTURE_PPM = 4.0
GRID_CELL = 0.4


def hf_random_operands(kind: str, seed: int, b: int, n_faces: int, h: int, w: int,
                       device):
    """
    Operands for HF against its plain version on an h x w frame: 'random'
    faces over the frame and beyond (both windings, every fifth degenerate,
    z on four levels so ties decide pixels, some z at BIG_Z, +inf, NaN and
    -inf); 'centres' corners on pixel centres (edges through centres, e = 0
    exactly) and on tile boundaries, one z level in three; 'slivers' long
    thin faces (areas just above and below 1e-9, angles near zero) across
    tiles, two corners on pixel centres (the long edge through centres).
    The box-edge kinds test HF's conservative face boxes: 'ulps' corners a
    few ulps off pixel centres (tile boundaries among them), so box
    boundaries fall within rounding of a row or column of centres, and
    slivers along a row or column of centres; 'far' corners up to +-1e6
    (faces over the whole frame, wedges and spikes entering it); 'nonfinite'
    the random faces with +-inf and NaN corners among them; 'crowd' more
    faces in one tile than HF's per-tile list holds, so that tile overflows.
    Returns (corners, z, color, background) float32 on ``device``.
    """
    rng = np.random.RandomState(seed)
    span = max(h, w)
    if kind == 'ulps':
        centre = rng.randint(-2, span // 16 + 2, (b, n_faces, 1, 2)) * 16 \
            + rng.choice([-0.5, 0.5, 15.5], (b, n_faces, 1, 2))
        corners = (centre + rng.randint(-12, 13, (b, n_faces, 3, 2))).astype(np.float32)
        corners[:, 1::3, 1, 0] = corners[:, 1::3, 0, 0]      # slivers along a row
        corners[:, 2::3, 1, 1] = corners[:, 2::3, 0, 1]      # and along a column
        steps = rng.randint(-3, 4, corners.shape)
        for k in range(3):
            corners = np.where(steps > k, np.nextafter(corners, np.float32(np.inf)), corners)
            corners = np.where(steps < -k, np.nextafter(corners, np.float32(-np.inf)), corners)
        z = rng.randint(0, 3, (b, n_faces)) * 1.0
    elif kind == 'far':
        corners = rng.uniform(-1e6, 1e6, (b, n_faces, 3, 2))
        inside = rng.uniform(-4, span + 4, (b, n_faces, 3, 2))
        corners[:, 1::3, 0] = inside[:, 1::3, 0]                # wedges from the frame
        corners[:, 2::3, :2] = inside[:, 2::3, :2]              # spikes into it
        corners[:, 2::3, 2] = inside[:, 2::3, 2] + rng.choice([-1e6, 1e6], (b, n_faces, 2)) \
            [:, 2::3] * rng.uniform(0.01, 1, (b, n_faces, 2))[:, 2::3]
        z = rng.randint(0, 4, (b, n_faces)) * 1.0
    elif kind == 'nonfinite':
        corners = rng.uniform(-8, span + 8, (b, n_faces, 3, 2))
        corners[:, 3::7, 0, 0], corners[:, 5::7, 1, 1] = np.inf, -np.inf
        corners[:, 6::9, 2, 0], corners[:, 8::11, 0, :] = np.nan, np.inf
        z = rng.randint(0, 4, (b, n_faces)) * 1.0
    elif kind == 'crowd':
        corners = rng.uniform(0, 16, (b, n_faces, 3, 2))
        corners[:, ::5] = rng.uniform(-8, span + 8, (b, (n_faces + 4) // 5, 3, 2))
        z = rng.randint(0, 4, (b, n_faces)) * 1.0
    elif kind == 'random':
        corners = rng.uniform(-8, span + 8, (b, n_faces, 3, 2))
        corners[:, 4::5, 2] = corners[:, 4::5, 0]
        z = rng.randint(0, 4, (b, n_faces)) * 2.0 + 3.0
        z[:, 6::11], z[:, 9::13] = 1e9, np.nan
        z[:, 10::17], z[:, 12::19] = np.inf, -np.inf
    elif kind == 'centres':
        corners = rng.randint(-2, span + 2, (b, n_faces, 3, 2)) + 0.5
        corners[:, 1::4] = rng.randint(-1, span // 16 + 2, (b, (n_faces + 2) // 4, 3, 2)) \
            * 16.0 + rng.choice([-0.5, 0.0, 0.5], (b, (n_faces + 2) // 4, 3, 2))
        z = rng.randint(0, 3, (b, n_faces)) * 1.0
    else:
        a = rng.randint(0, span, (b, n_faces, 2)) + 0.5
        d = rng.randint(-span, span + 1, (b, n_faces, 2)) * 1.0
        d[..., 0] += (d[..., 0] == 0) & (d[..., 1] == 0)
        n = np.stack([-d[..., 1], d[..., 0]], -1) / np.linalg.norm(d, axis=-1, keepdims=True)
        t = 10.0 ** rng.uniform(-9, 0.5, (b, n_faces, 1))
        corners = np.stack([a, a + d, a + 0.5 * d + n * t], axis=2)
        z = rng.randint(0, 4, (b, n_faces)) * 1.0
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return (f32(corners), f32(z), f32(rng.rand(b, n_faces, 3)),
            f32(rng.rand(b, 3, h, w)))


def hf_grazing_operands(seed: int, b: int, n_faces: int, res: int, device):
    """
    Faces that graze a tile's corner pixel centre from outside: edge 0's
    line passes within rounding of the centre p, with p (and the tile) on
    its negative side in exact arithmetic, while the float32 edge value at p
    is >= 0, so the face covers p. The rest of the face lies beyond the
    tile's corner. A per-tile cull that tests the edges exactly, without the
    rounding's margin, drops such a face from the tile it covers a pixel of.
    Returns (corners, z, color, background) float32 on ``device``.
    """
    rng = np.random.RandomState(seed)
    f32, tiles, found = np.float32, max(res // 16, 1), []
    while sum(len(x) for x in found) < b * n_faces:
        m = 200000
        p = (rng.randint(0, tiles, (m, 2)) * 16 + 15.5).astype(np.float64)
        ang = rng.uniform(-0.6, 0.6, m) - np.pi / 4
        d = np.stack([np.cos(ang), np.sin(ang)], -1)
        s1, s2 = rng.uniform(0.3, 30, (2, m, 1))
        a = (p - s1 * d + rng.uniform(-1e-6, 1e-6, (m, 2))).astype(f32)
        bb = (p + s2 * d + rng.uniform(-1e-6, 1e-6, (m, 2))).astype(f32)
        c = (p + rng.uniform(3, 20, (m, 1)) * np.sqrt(0.5)).astype(f32)
        ex, ey = bb[:, 0] - a[:, 0], bb[:, 1] - a[:, 1]          # float32
        pf = p.astype(f32)
        rounded = ex * (pf[:, 1] - a[:, 1]) - ey * (pf[:, 0] - a[:, 0])
        exd, eyd = ex.astype(np.float64), ey.astype(np.float64)
        exact = exd * (p[:, 1] - a[:, 1]) - eyd * (p[:, 0] - a[:, 0])
        at_c = exd * (c[:, 1] - a[:, 1].astype(np.float64)) \
            - eyd * (c[:, 0] - a[:, 0].astype(np.float64))
        ok = (at_c > 0) & (exact < 0) & (rounded >= 0)
        found.append(np.stack([a, bb, c], 1)[ok])
    corners = np.concatenate(found)[:b * n_faces]
    corners = np.asarray(corners, np.float32).reshape(b, n_faces, 3, 2)
    z = rng.randint(0, 3, (b, n_faces)).astype(np.float32)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return (t(corners), t(z), t(rng.rand(b, n_faces, 3)), t(rng.rand(b, 3, res, res)))


def hf_kernel_lists(ops):
    """HF's per-tile lists and counts on ``ops`` (corners, z, color,
    background): the kernel's set-up and binning alone (the C entry point
    ``tds_hard_faces_bin``, called as ``hard_faces`` calls it, with buffers
    of this function's own). Returns (lists (B, tiles, capacity), counts
    (B, tiles)); a list's entries past its count are unset."""
    from torchdrivesim_tpu_torch.ops import hard_faces
    from torchdrivesim_tpu_torch.ops.build import check_launch
    corners, z = (t.contiguous() for t in ops[:2])
    b, f = z.shape
    h, w = ops[3].shape[-2:]
    tiles = -(-h // hard_faces.TILE) * -(-w // hard_faces.TILE)
    cap = hard_faces.list_capacity(f)
    records = corners.new_empty((b, f, 16))
    counts = torch.empty((b, tiles), dtype=torch.int32, device=corners.device)
    lists = torch.empty((b, tiles, cap), dtype=torch.int32, device=corners.device)
    check_launch(hard_faces.LIBRARY.load().tds_hard_faces_bin(
        corners.data_ptr(), z.data_ptr(), b, f, h, w, cap, records.data_ptr(),
        counts.data_ptr(), lists.data_ptr(), torch.cuda.current_stream().cuda_stream),
        'HF binning')
    torch.cuda.synchronize()
    return lists, counts


def compare_hf_lists(ops):
    """HF's per-tile lists (:func:`hf_kernel_lists`) against
    ``hard_faces_tile_lists_reference``: every count equal, every list that
    fits its capacity equal as a set, and an overflowed tile's listed faces
    all in its plain list. Returns (mismatched counts and entries,
    overflowed tiles, listed pairs, longest list)."""
    from torchdrivesim_tpu_torch.ops import hard_faces
    lists, counts = hf_kernel_lists(ops)
    h, w = ops[3].shape[-2:]
    want, want_counts = hard_faces.hard_faces_tile_lists_reference(ops[0], ops[1], h, w)
    cap = lists.shape[-1]
    fill = torch.iinfo(torch.int32).max
    slot = torch.arange(cap, device=lists.device)
    got = torch.where(slot < counts.clamp(max=cap)[..., None], lists, fill).sort(-1).values
    want = torch.where(want >= 0, want, fill)
    want = torch.nn.functional.pad(want, (0, max(cap - want.shape[-1], 0)), value=fill)
    over = counts > cap
    bad = int((counts != want_counts).sum())
    bad += int(((got != want[..., :cap]) & ~over[..., None]).sum())
    if over.any():
        inside = (got[over][..., None] == want[over][:, None, :]).any(-1)
        bad += int((~inside).sum())
    longest = int(want_counts.max()) if want_counts.numel() else 0
    return bad, int(over.sum()), int(want_counts.sum()), longest


def compare_hf(ops, label, overflow=False):
    """HF against its plain version on ``ops`` (corners, z, color,
    background): the mismatched pixels of the image (bits) and of the
    winner index must both be 0, and its per-tile lists must equal the
    plain ones (:func:`compare_hf_lists`), with overflowed tiles none
    (``overflow`` False), some (True) or any (None). Returns the largest
    difference."""
    from torchdrivesim_tpu_torch.ops import hard_faces
    image, winner = hard_faces.hard_faces(*ops)
    want, want_winner = hard_faces.hard_faces_reference(*ops)
    torch.cuda.synchronize()
    bad = int((image.view(torch.int32) != want.view(torch.int32)).any(dim=1).sum())
    bad_winner = int((winner != want_winner).sum())
    err = float((image - want).abs().max()) if image.numel() else 0.0
    won = float((want_winner >= 0).float().mean()) if want_winner.numel() else 0.0
    bad_lists, n_over, listed, longest = compare_hf_lists(ops)
    b, f = ops[1].shape
    h, w = image.shape[-2:]
    print(f'{label}: HF B={b} F={f} {(h, w)}: {bad} image and {bad_winner} winner '
          f'mismatches against the plain version ({won * 100:.1f}% of pixels won by a '
          f'face); tile lists: {bad_lists} mismatches against the plain lists, {listed} '
          f'listed pairs, longest {longest} of capacity {hard_faces.list_capacity(f)}, '
          f'{n_over} tiles overflowed; scratch '
          f'{hard_faces.scratch_bytes(b, f, h, w) / 1e6:.3f} MB')
    if bad or bad_winner or bad_lists:
        raise AssertionError(f'{label}: HF disagrees with its plain version')
    if overflow is not None and bool(n_over) != overflow:
        raise AssertionError(f'{label}: {n_over} tiles overflowed their lists')
    return err


def compare_hf_grad(ops, label):
    """The autograd.Function's gradients (colors, background) against
    autograd through the plain ``torch.where`` chain, on the same operands
    and a seeded cotangent: the largest difference over the largest value
    must stay below 1e-5 (each color's sum over the pixels it wins runs in
    another order, float32)."""
    from torchdrivesim_tpu_torch.ops import hard_faces
    corners, z, color, bg = ops
    g = torch.rand(bg.shape, generator=torch.Generator(bg.device).manual_seed(3),
                   device=bg.device)
    grads = []
    for fn in (lambda c, b: hard_faces.rasterize_hard_faces(corners, z, c, b),
               lambda c, b: hard_faces.hard_faces_reference(corners, z, c, b)[0]):
        c, b = color.clone().requires_grad_(), bg.clone().requires_grad_()
        grads.append(torch.autograd.grad((fn(c, b) * g).sum(), (c, b)))
    rel = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
              for x, y in zip(*grads))
    print(f'{label}: HF gradients (colors, background) against autograd through the '
          f'plain version: largest difference {rel:.3g} of the largest value')
    if not rel < 1e-5:
        raise AssertionError(f'{label}: HF gradients disagree')
    return rel


def hf_random_cases(device):
    """HF on the random, centres, sliver, box-edge (ulps, far, non-finite)
    and grazing operands, square and rectangular, one of them overflowing a
    tile's list, and its gradients on one of them."""
    from torchdrivesim_tpu_torch.ops import hard_faces
    errs = []
    for i, (kind, b, f, h, w) in enumerate((
            ('random', 4, 300, 64, 64), ('random', 2, 1000, 72, 40),
            ('centres', 4, 200, 48, 80), ('slivers', 4, 300, 64, 64),
            ('random', 3, 0, 32, 32), ('ulps', 4, 300, 64, 64), ('far', 2, 300, 72, 40),
            ('nonfinite', 4, 300, 64, 64), ('crowd', 2, 700, 48, 48))):
        ops = hf_random_operands(kind, i, b, f, h, w, device)
        overflow = True if kind == 'crowd' else None if f > hard_faces.LIST_CAP else False
        errs.append(compare_hf(ops, f'HF {kind} case {i}', overflow))
    errs.append(compare_hf(hf_grazing_operands(5, 4, 40, 64, device), 'HF grazing case'))
    compare_hf_grad(hf_random_operands('random', 7, 2, 100, 40, 56, device),
                    'HF random case 7')
    return max(errs)


def hf_tile_pairs(corners, z, height: int, width: int) -> int:
    """The (16 x 16 tile, face) pairs that HF's float64 edge test alone
    keeps (``hard_faces_tile_keep_reference``, the whole cull of HF's
    first design), counted in chunks of faces."""
    from torchdrivesim_tpu_torch.ops import hard_faces
    return sum(int(hard_faces.hard_faces_tile_keep_reference(
        corners[:, s:s + 2048], z[:, s:s + 2048], height, width).sum())
        for s in range(0, z.shape[1], 2048))


def hf_json_entry(name, ops, err, launches, card, label):
    """HF's times on ``ops`` (graph replay, its output first held equal to
    eager; its plain version by CUDA events), its bound (the operands read
    once, the image and winner written once; the fold's float32 operations
    over the (tile, face) pairs in which the face covers a pixel centre,
    ``hard_faces_cover_reference``, the work these inputs need whatever
    implements it) and its JSON entry. Prints beside the covering pairs the
    pairs the kernel lists and those the float64 edge test alone keeps."""
    from torchdrivesim_tpu_torch.ops import hard_faces
    corners, z, color, bg = ops
    b, f = z.shape
    h, w = bg.shape[-2:]
    if not torch.equal(graph_replay(lambda: hard_faces.hard_faces(*ops))[0],
                       hard_faces.hard_faces(*ops)[0]):
        raise AssertionError(f'{name}: HF replayed from a CUDA graph differs from eager')
    ms = graph_ms(lambda: hard_faces.hard_faces(*ops), 20)
    plain_ms = cuda_ms(lambda: hard_faces.hard_faces_reference(*ops), 1)
    cover = len(hard_faces.hard_faces_cover_reference(corners, z, h, w)[0])
    listed = int(hard_faces.hard_faces_tile_lists_reference(corners, z, h, w)[1].sum())
    kept = hf_tile_pairs(corners, z, h, w)
    n_bytes = nbytes(corners, z, color, bg) + b * h * w * (3 * 4 + 4)
    n_ops = cover * BOUND_TILE ** 2 * HF_FACE_OPS
    bound_ms, bound_by = bound(n_bytes, n_ops)
    tiles = b * -(-h // BOUND_TILE) * -(-w // BOUND_TILE)
    print(f'{name} kernel ({label}) B={b} F={f} {h}x{w}: {ms:.4f} ms (device, graph '
          f'replay); plain version {plain_ms:.3f} ms; bound {bound_ms * 1e3:.3f} us by '
          f'{bound_by} ({n_bytes / 1e6:.3f} MB, {n_ops / 1e6:.1f} M float32 operations over '
          f'{cover} covering (tile, face) pairs, {cover / tiles:.2f} a tile; listed '
          f'{listed}, {listed / tiles:.2f} a tile; the float64 edge test alone kept {kept}, '
          f'{kept / tiles:.2f} a tile); scratch '
          f'{hard_faces.scratch_bytes(b, f, h, w) / 1e6:.3f} MB [{card}]')
    return {'name': name, 'route': 'cuda',
            'source': 'torchdrivesim_tpu_torch/csrc/hard_faces.cu',
            'replaces': 'torchdrivesim_tpu/ops/rasterize.py:566', 'launches': launches,
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': None}


@contextlib.contextmanager
def capture_calls(module, name):
    """Record the arguments of every call of ``module.name`` while the
    block runs; yields the list."""
    calls, saved = [], getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(args)
        return saved(*args, **kw)
    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, saved)


def hard_faces_path(device, card):
    """
    HF (``csrc/hard_faces.cu``), the float-color hard raster: against its
    plain version bit for bit (image and winner index) on random faces of
    both windings, degenerate faces, z ties, z at BIG_Z, +-inf and NaN,
    corners on pixel centres, slivers, faces grazing a tile's corner, square
    and rectangular, and its gradients against autograd through the plain
    version; then the differentiable primitive render the reference's
    ``Pytorch3DRendererConfig()`` gives the facade world (B = 64, 20
    agents, 1,280 cameras): ``render_egocentric`` at res 64 and 128, each
    pinned at one HF launch, no other kernel and no plain call, HF against
    its plain version on the frame's operands and the frame equal to HF's
    there; times and bounds. Returns the JSON entries.
    """
    from torchdrivesim_tpu_torch.ops import hard, hard_faces
    from torchdrivesim_tpu_torch.rendering import Pytorch3DRendererConfig
    from torchdrivesim_tpu_torch.utils import Resolution
    t_phase = time.perf_counter()
    hf_random_cases(device)
    sim = facade_world(FACADE_BATCH, device, renderer_config=Pytorch3DRendererConfig())
    entries = []
    for res in HF_RES:
        before = count_kernels()
        with count_calls(hard_faces, ['hard_faces_reference']) as plain, \
                count_calls(hard, ['raster_packed_reference', 'raster_chunked_reference']) \
                as plain_hard:
            image = sim.render_egocentric(res=Resolution(res, res), fov=FOV)
            torch.cuda.synchronize()
        ran = launched_since(before)
        print(f'Pytorch3DRendererConfig() render_egocentric at res {res}: launches {ran}, '
              f'plain calls {plain} {plain_hard}')
        if ran != {'hard_faces': 1} or any({**plain, **plain_hard}.values()):
            raise AssertionError(f'differentiable primitive frame: launches {ran}; '
                                 'expected one HF and no plain call')
        prims, cams = sim.egocentric_prim_frame(fov=FOV)
        ops = tuple(t.detach().contiguous() for t in sim.renderer.prims_plain_operands(
            *prims, res, cams))
        err = compare_hf(ops, f'Pytorch3D facade frame res {res}')
        want = hard_faces.hard_faces(*ops)[0] * 255.0
        if not torch.equal(image.reshape(want.shape), want):
            raise AssertionError('differentiable primitive frame: not HF\'s on its operands')
        if res == HF_RES[0]:
            compare_hf_grad(ops, f'Pytorch3D facade frame res {res}')
        entries.append(hf_json_entry(f'hard_faces_prims_res{res}', ops, err,
                                     ran['hard_faces'], card,
                                     'differentiable primitive frame, Town02 facade'))
    print(f'hard faces phase: {time.perf_counter() - t_phase:.1f} s')
    return entries


def map_copy(name: str, root: str):
    """A copy of map ``name``'s source files (metadata, .osm, mesh,
    stoplines, lights; not its baked caches) under ``root``: (its
    MapConfig, the original's)."""
    import shutil
    from torchdrivesim_tpu_torch.map import find_map_config, load_map_config
    src = find_map_config(name)
    folder = os.path.dirname(src.mesh_path)
    dst = os.path.join(root, name)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.makedirs(dst)
    for f in os.listdir(folder):
        if '_tpu_' not in f:
            shutil.copy(os.path.join(folder, f), dst)
    return load_map_config(os.path.join(dst, 'metadata.json')), src


def map_bake_path(device, card, names=('carla_Town02', 'carla_Town10HD')):
    """
    Fresh bakes into copies of the maps' files under ``build/bake_maps``
    (never next to the bundled maps): the textures of ``names`` (Town02's
    and Town10HD's) at 4 px/m (``load_or_bake_texture``: one HF launch per
    512-row strip, no plain call) and the first map's grids at 0.4 m
    (``MapConfig.grids``: the
    distance field on the card, the direction field by the native baker),
    each held to the cache bundled with the map: the share of texels and of
    cells equal after float16 rounding (>= 99.9%), the largest distance
    difference; HF against its plain version on the first map's first
    strip, its tile lists against the plain lists on every strip (none
    overflowed); times. Returns HF's JSON entry on that strip.
    """
    from torchdrivesim_tpu_torch import map_grids
    from torchdrivesim_tpu_torch.benchmark import load_or_bake_texture, texture_cache_path
    from torchdrivesim_tpu_torch.ops import hard_faces
    t_phase = time.perf_counter()
    entry = None
    for name in names:
        cfg, src = map_copy(name, 'build/bake_maps')
        before = count_kernels()
        with count_calls(hard_faces, ['hard_faces_reference']) as plain, \
                capture_calls(hard_faces, 'hard_faces') as calls:
            t0 = time.perf_counter()
            texture = load_or_bake_texture(cfg, device=device)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        ran = launched_since(before)
        h, w = texture.data.shape[:2]
        strips = -(-h // 512)
        with np.load(texture_cache_path(cfg, 4.0)) as fresh, \
                np.load(texture_cache_path(src, 4.0)) as cached:
            new, old = fresh['data'], cached['data']
            same_origin = np.array_equal(fresh['origin'], cached['origin'])
        if new.shape != old.shape:
            raise AssertionError(f'{name} texture: {new.shape}, the cache {old.shape}')
        equal = float((new == old).all(axis=-1).mean())
        faces = calls[0][0].shape[1]
        print(f'{name} texture bake at 4 px/m: {w} x {h} texels, {faces} faces, {strips} '
              f'strips in {secs:.2f} s (host clock, mesh coloring included); launches '
              f'{ran}, plain calls {plain}; {equal * 100:.4f}% of texels equal to the '
              f'bundled cache after float16 rounding, origin equal: {same_origin} [{card}]')
        if ran != {'hard_faces': strips} or any(plain.values()):
            raise AssertionError(f'{name} texture bake: launches {ran}, expected {strips} HF')
        if not equal >= 0.999 or not same_origin:
            raise AssertionError(f'{name} texture: only {equal * 100:.4f}% equal to the cache')
        for i, strip in enumerate(calls):
            bad_lists, n_over, listed, longest = compare_hf_lists(strip)
            scratch = hard_faces.scratch_bytes(*strip[1].shape, *strip[3].shape[-2:])
            print(f'{name} texture strip {i}: HF tile lists {bad_lists} mismatches against '
                  f'the plain lists, {listed} listed pairs, longest {longest}, {n_over} tiles '
                  f'overflowed; scratch {scratch / 1e6:.3f} MB')
            if bad_lists or n_over:
                raise AssertionError(f'{name} texture strip {i}: HF tile lists disagree or '
                                     'overflow')
        if name != names[0]:
            continue
        ops = tuple(t.contiguous() for t in calls[0])
        err = compare_hf(ops, f'{name} texture strip 0')
        entry = hf_json_entry('hard_faces_texture', ops, err, ran['hard_faces'], card,
                              f'{name} texture bake, first strip')
        before_bakes = dict(map_grids.DIRECTION_BAKES)
        t0 = time.perf_counter()
        grids = cfg.grids(device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        bakes = {k: v - before_bakes[k] for k, v in map_grids.DIRECTION_BAKES.items()}
        with np.load(cfg.grids_cache_path()) as fresh, \
                np.load(src.grids_cache_path()) as cached:
            new = {k: fresh[k] for k in fresh.files}
            old = {k: cached[k] for k in cached.files}
        if new['distance'].shape != old['distance'].shape:
            raise AssertionError(f'{name} grids: {new["distance"].shape}, the cache '
                                 f'{old["distance"].shape}')
        d_equal = float((new['distance'] == old['distance']).mean())
        dir_equal = float((new['direction'] == old['direction']).mean())
        cells = float(((new['distance'] == old['distance'])
                       & (new['direction'] == old['direction'])).mean())
        diff = float(np.abs(new['distance'].astype(np.float32)
                            - old['distance'].astype(np.float32)).max())
        if grids.distance.data.shape != new['distance'].shape:
            raise AssertionError(f'{name} grids: the returned field is not the written one')
        print(f'{name} grid bake at 0.4 m: {new["distance"].shape[1]} x '
              f'{new["distance"].shape[0]} cells in {secs:.2f} s (host clock); direction '
              f'baked by {bakes}; distance equal after float16 rounding {d_equal * 100:.4f}%, '
              f'direction equal {dir_equal * 100:.4f}%, cells equal in both '
              f'{cells * 100:.4f}%; largest distance difference (float16) {diff:.3g} m '
              f'[{card}]')
        if bakes != {'native': 1, 'python': 0}:
            raise AssertionError(f'{name} grids: direction baked by {bakes}, not natively')
        if not min(d_equal, dir_equal) >= 0.999:
            raise AssertionError(f'{name} grids: under 99.9% equal to the cache')
        for key in ('distance_origin', 'direction_origin', 'distance_cell'):
            if not np.array_equal(new[key], old[key]):
                raise AssertionError(f'{name} grids: {key} differs from the cache')
    print(f'map bake phase: {time.perf_counter() - t_phase:.1f} s')
    return entry


def map_examples_path(device, card):
    """The examples ``show_map`` (Town02's texture from its cache) and
    ``check_map_alignment`` (Town02 baked at 2 px/m with its stoplines: one
    HF launch per strip, no plain call), each writing its ``.npz``; prints
    the count of wrong-way stoplines."""
    from torchdrivesim_tpu_torch.examples import check_map_alignment, show_map
    from torchdrivesim_tpu_torch.ops import hard_faces
    from torchdrivesim_tpu_torch.rendering import get_default_color_map
    t_phase = time.perf_counter()
    os.makedirs('build', exist_ok=True)
    before = count_kernels()
    img = show_map.main(['--map', 'carla_Town02', '--out', 'build/show_map.npz',
                         '--device', device.type])
    if launched_since(before) or img.dtype != np.uint8 or img.ndim != 3:
        raise AssertionError('show_map: a kernel ran on a cached texture, or a bad image')
    road = np.asarray(get_default_color_map()['road'], np.uint8)
    before = count_kernels()
    with count_calls(hard_faces, ['hard_faces_reference']) as plain:
        frame, wrong = check_map_alignment.main(['--map', 'carla_Town02', '--out',
                                                 'build/map_alignment.npz',
                                                 '--device', device.type])
        torch.cuda.synchronize()
    ran = launched_since(before)
    strips = -(-frame.shape[0] // 512)
    red = np.asarray(get_default_color_map()['traffic_light_red'], np.uint8)
    print(f'show_map: {img.shape[1]} x {img.shape[0]}, '
          f'{float((img == road).all(axis=-1).mean()) * 100:.1f}% road; '
          f'check_map_alignment: {frame.shape[1]} x {frame.shape[0]} at 2 px/m, launches '
          f'{ran}, plain calls {plain}, {int((frame == red).all(axis=-1).sum())} stopline '
          f'texels; {len(wrong)} wrong-way stoplines: {wrong}')
    if ran != {'hard_faces': strips} or any(plain.values()):
        raise AssertionError(f'check_map_alignment: launches {ran}, expected {strips} HF')
    for out in ('build/show_map.npz', 'build/map_alignment.npz'):
        with np.load(out) as data:
            if data['frame'].dtype != np.uint8:
                raise AssertionError(f'{out}: not a uint8 frame')
    print(f'map examples phase: {time.perf_counter() - t_phase:.1f} s')


def ptxas_usage(library):
    """Start ``nvcc -Xptxas -v`` on ``library``'s source, with the build's
    own flags, into a cubin under ``build/``; returns the process."""
    from torchdrivesim_tpu_torch.ops.build import NVCC_FLAGS, nvcc
    flags = [f for f in NVCC_FLAGS if f not in ('-shared', '-Xcompiler', '-fPIC')]
    os.makedirs('build', exist_ok=True)
    return subprocess.Popen([nvcc(), *flags, '-cubin', '-Xptxas', '-v', '-o',
                             f'build/{library.name}.cubin', library.source],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_report(proc):
    """The registers, shared memory and spills that ptxas reports for each
    kernel of a :func:`ptxas_usage` process, one line each."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc -Xptxas -v failed ({proc.returncode}):\n{out}\n{err}')
    lines, kernel = [], None
    for line in (out + err).splitlines():
        found = re.findall(r'[a-z]+(?:_[a-z]+)*_kernel', line) \
            if 'Compiling entry function' in line else None
        if found:
            kernel = found[-1]
        elif kernel and ('registers' in line or 'spill' in line):
            lines.append(f'{kernel}: {line.split("ptxas info", 1)[-1].lstrip(" :")}')
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from torchdrivesim_tpu_torch.ops import fused, hard, hard_faces, prims, soft, warp
    from torchdrivesim_tpu_torch.ops.build import build_all

    device = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    card = card_label()
    print(f'device: {name}')
    print(card)                  # name, power.limit as nvidia-smi gives them
    libraries = [fused.LIBRARY, warp.LIBRARY, soft.LIBRARY, soft.ACCUM_LIBRARY,
                 warp.NEAREST_LIBRARY, hard.LIBRARY, prims.LIBRARY, hard_faces.LIBRARY]
    usage = ptxas_usage(hard_faces.LIBRARY)
    secs = build_all(libraries)
    print(f'kernel build ({", ".join(lib.name for lib in libraries)} in parallel): '
          f'{secs:.2f} s (nvcc sm_90a)')
    for line in ptxas_report(usage):
        print(f'hard_faces.cu ptxas: {line}')

    if sys.argv[1:] == ['grouped-check-timing']:
        grouped_check_timing(device, card)
        return 0
    entry, scenario, state = headline(device, card)
    kernels = [entry]
    kernels += il_path(device, card)
    kernels += grouped_soft_path(device, card)
    kernels += rl_path(device, card)
    kernels += prim_path(device, card, scenario, state)
    kernels.append(config3_path(device, card))
    kernels.append(tiled_path(device, card))
    kernels.append(facade_path(device, card))
    kernels += noisy_facade_path(device, card)
    root = write_interaction_data('build/interaction_data')
    kernels.append(replay_path(device, card, root))
    kernels += dataset_il_path(device, card, root)
    kernels.append(gym_env_path(device, card))
    kernels += faces_path(device, card)
    reference_configs_path(device, card)
    kernels += full_background_path(device, card)
    painter_path(device, card)
    teacher_forcing_path(device, card)
    examples_path(device, card)
    kernels += hard_faces_path(device, card)
    kernels.append(map_bake_path(device, card))
    map_examples_path(device, card)

    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
