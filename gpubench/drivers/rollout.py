"""
Driver of the rollout cells: ``BenchmarkScenario.make_step_fn(render=True,
metrics=True)`` of the port over a batch of environments, every step's
outputs reduced to an on-device checksum, zero actions, episodes of
``episode_steps`` steps that start again from the seeded initial state.

Correctness: the outputs of ``check_steps`` steps of the window's first
episode (drawn from the seed) and of its last step, for ``check_envs``
environments drawn from the seed, against the plain reference run from the
same initial states: agent states, images (8-bit, as the port's float image
rounds) and the four metrics.
"""
import numpy as np
import torch

from gpubench import bounds, world
from gpubench import scenario as scenario_of
from gpubench.reference import metrics as ref_metrics
from gpubench.reference import render as ref_render
from gpubench.reference import scene as ref_scene
from gpubench.reference import sim as ref_sim

OUTPUTS = ('collision', 'offroad', 'wrong_way', 'light_violation')
#: an offroad value differs where it is off by more than this share of (1 +
#: the reference's value): the loss counts a corner only past a threshold,
#: so a distance within rounding of it flips the corner in or out
OFFROAD_TOL = 0.01


def stages(scenario):
    """``make_step_fn``'s three stages as separate calls, in its order and
    with its public functions: (dynamics(state, action) -> state,
    render(state) -> image, metrics(state) -> dict)."""
    from torchdrivesim_tpu_torch.infractions import compute_collision_matrix
    from torchdrivesim_tpu_torch.map_grids import (offroad_loss_from_grid,
                                                   wrong_way_loss_from_grid)
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    from torchdrivesim_tpu_torch.traffic_controls import red_light_violations
    from torchdrivesim_tpu_torch.utils import Resolution
    sim = scenario.sim
    gen, renderer, res = sim.birdview_mesh_generator, sim.renderer, scenario.res
    sizes = sim.get_all_agent_size()
    control = sim.traffic_controls['traffic_light']

    def gather(state):
        return (torch.cat([state.agent_state, state.npc_state], dim=-2),
                torch.cat([state.present_mask, state.npc_present_mask], dim=-1),
                state.traffic_control_state['traffic_light'])

    def render(state):
        all_state, present, light_state = gather(state)
        ego = state.agent_state[:, 0]
        cameras = Cameras(ego[:, :2], torch.stack(
            [torch.sin(ego[:, 2]), torch.cos(ego[:, 2])], dim=-1), 2.0 / scenario.fov)
        mesh = gen.generate(1, agent_state=all_state[:, None],
                            present_mask=present[:, None],
                            traffic_light_state=light_state, include_background=True)
        return renderer.render_rgb_mesh_chw(mesh, Resolution(res, res), cameras)

    def metrics(state):
        all_state, present, light_state = gather(state)
        boxes = torch.cat([all_state[..., :2], sizes, all_state[..., 2:3]], dim=-1)
        return {
            'collision': compute_collision_matrix(boxes, present)[:, :sim.agent_count],
            'offroad': offroad_loss_from_grid(sim.map_grids, state.agent_state,
                                              sim.agent_size,
                                              threshold=sim.cfg.offroad_threshold),
            'wrong_way': wrong_way_loss_from_grid(sim.map_grids, state.agent_state),
            'light_violation': red_light_violations(
                boxes[:, :sim.agent_count], control.corners, light_state,
                red_index=control.allowed_states.index('red'))}

    return sim.functional_step, render, metrics


def sample(state, out, envs):
    """The checked environments' outputs of one step, copied."""
    got = {'state': state.agent_state[envs].float().clone(),
           'image': out['image'][envs].clone()}
    for k in OUTPUTS:
        got[k] = out[k][envs].clone()
    return got


def checked(r, b):
    """(environments, window steps of the first episode) to check, drawn
    from the seed apart from the world's generator."""
    rng = np.random.default_rng([r.seed, 1])
    t = r.traffic
    envs = np.sort(rng.choice(b, size=min(int(t['check_envs']), b), replace=False))
    steps = np.sort(rng.choice(int(t['episode_steps']),
                               size=min(int(t['check_steps']), int(t['episode_steps'])),
                               replace=False))
    return envs, [int(s) for s in steps]


def run(r):
    cfg, t = r.config, r.traffic
    r.mark('imports')
    w = world.make_world(cfg, t, r.seed)
    r.mark('inputs')
    scenario = scenario_of.build(r, w)
    r.mark('program')
    sim = scenario.sim
    b, a = w['agent_state'].shape[:2]
    episode = int(t['episode_steps'])
    envs_np, check_at = checked(r, b)
    envs = torch.as_tensor(envs_np, device=r.device)
    step = scenario.make_step_fn(render=True, metrics=True)
    action = torch.zeros((b, a, sim.action_size), device=r.device)
    init = sim.state
    carry = {'state': init, 'checksum': torch.zeros((), device=r.device)}

    def one(i):
        if i % episode == 0:
            carry['state'] = init
        state, out = step(carry['state'], action)
        for v in out.values():
            carry['checksum'] = carry['checksum'] + v.sum(dtype=torch.float32)
        carry['state'], carry['out'] = state, out
        return state, out

    for i in range(int(t['warmup_steps'])):
        one(i)
    r.setup_done()

    recorded = {}

    def call(i):
        state, out = one(i)
        if i in check_at:
            recorded[i] = sample(state, out, envs)

    timing = r.window(call)
    recorded[timing['calls'] - 1] = sample(carry['state'], carry['out'], envs)
    r.e2e['env_steps_per_s'] = b * timing['calls'] / timing['seconds']
    from gpubench.harness import percentile
    r.e2e['step_ms_p95'] = percentile(timing['call_ms'], 95)
    r.read_memory()
    if not torch.isfinite(carry['checksum']):
        r.failed = timing['calls']

    if r.trace:
        traced(r, scenario, action, w, envs)
    del scenario, sim, step, init, carry
    if r.cuda:
        torch.cuda.empty_cache()
    check(r, w, envs_np, recorded)


def traced(r, scenario, action, w, envs):
    """Stage spans over ``trace_steps`` steps, then the same steps under the
    profiler, then the kernels' bounds on those frames."""
    n = int(r.traffic['trace_steps'])
    dynamics, render, metrics = stages(scenario)
    start = scenario.sim.state
    r.open_spans()
    state = start
    for _ in range(n):
        state = r.spanned('dynamics', dynamics, state, action)
        r.spanned('render', render, state)
        r.spanned('metrics', metrics, state)
    r.close_spans()

    def profiled():
        s = start
        for _ in range(n):
            with torch.profiler.record_function('gpubench.dynamics'):
                s = dynamics(s, action)
            with torch.profiler.record_function('gpubench.render'):
                render(s)
            with torch.profiler.record_function('gpubench.metrics'):
                metrics(s)

    r.profile(profiled)
    frame_bounds(r, scenario, action, w, start, n)


def frame_bounds(r, scenario, action, w, start, n):
    """B6b's bound on each traced frame, from the scene: the road mesh, the
    boxes, direction triangles and stoplines."""
    cfg = r.config
    res, scale = cfg['res'], 2.0 / cfg['fov']
    lights = torch.as_tensor(w['lights']['corners'], device=r.device)
    road = ref_scene.RoadMesh(*world.load_road_mesh(w['map']), device=r.device)
    size = torch.as_tensor(w['agent_size'], device=r.device)
    out, state = [], start
    for _ in range(n):
        state = scenario.sim.functional_step(state, action)
        s = state.agent_state
        cam_xy, cam_sc = s[:, 0, :2], torch.stack([torch.sin(s[:, 0, 2]),
                                                   torch.cos(s[:, 0, 2])], -1)
        light_state = state.traffic_control_state['traffic_light'][0].tolist()
        (quads, _, _), (tris, _, _) = ref_scene.prims(s, size, lights, light_state)
        to_screen = lambda p: ref_render.screen(
            p.reshape(p.shape[0], -1, 2), cam_xy, cam_sc, scale, res,
            w['left_handed']).reshape(p.shape)
        out.append(bounds.hard_bound_s(road.tris, to_screen(quads), to_screen(tris),
                                       cam_xy, cam_sc, scale, res, w['left_handed']))
    r.scenes['render_kernel_bound_s'] = float(np.mean(out))


def reference_run(r, w, envs_np, steps, dtype=torch.float32):
    """The plain reference over the checked environments: per episode step
    (0-based; the outputs after step + 1 steps) the states, images and
    metrics, in ``dtype``."""
    cfg = r.config
    dev = r.device
    res, scale, dt, lh = cfg['res'], 2.0 / cfg['fov'], cfg['dt'], w['left_handed']
    state = torch.as_tensor(w['agent_state'][envs_np], device=dev).to(dtype)
    size = torch.as_tensor(w['agent_size'][envs_np], device=dev).to(dtype)
    lr = torch.as_tensor(w['lr'][envs_np], device=dev).to(dtype)
    lights = torch.as_tensor(w['lights']['corners'], device=dev).to(dtype)
    action = torch.zeros(state.shape[:-1] + (2,), device=dev, dtype=dtype)
    road = ref_scene.RoadMesh(*world.load_road_mesh(w['map']), device=dev)
    road.tris = road.tris.to(dtype)
    out = {}
    for k in range(max(steps) + 1):
        state = ref_sim.bicycle_step(state, action, lr, dt, lh)
        if k not in steps:
            continue
        light_state = ref_sim.light_states(w['lights']['fsms'], w['lights']['ids'],
                                           k + 1, dt)
        ego = state[:, 0]
        cam_sc = torch.stack([torch.sin(ego[:, 2]), torch.cos(ego[:, 2])], -1)
        boxes = torch.cat([state[..., :2], size, state[..., 2:3]], dim=-1)
        out[k] = {
            'state': state.float(),
            'image': ref_render.frame(state, size, lights, light_state, ego[:, :2],
                                      cam_sc, scale, res, lh, road),
            'collision': ref_metrics.collision(boxes, torch.ones(boxes.shape[:2], dtype=torch.bool, device=dev)).float(),
            'offroad': ref_metrics.offroad(w['grids'], state, size).float(),
            'wrong_way': ref_metrics.wrong_way(w['grids'], state).float(),
            'light_violation': ref_metrics.red_light(boxes, lights, light_state)}
    return out


def compare(r, got: dict, want: dict):
    """The numbers compared, over every checked step: the largest state,
    collision and wrong-way gaps, the share of pixels whose 8-bit color
    differs, the share of offroad values that differ and the red-light flags
    that differ."""
    gaps = {k: 0.0 for k in ('state_gap', 'image_mismatch', 'collision_gap',
                             'offroad_mismatch', 'wrong_way_gap',
                             'light_violation_mismatch')}
    pixels = differing = off_n = values = 0
    for key, g in got.items():
        ref = want[key]
        gaps['state_gap'] = max(gaps['state_gap'],
                                float((g['state'] - ref['state']).abs().max()))
        img = torch.clamp(torch.round(g['image'].float()), 0, 255).to(torch.uint8)
        diff = (img.permute(0, 2, 3, 1) != ref['image']).any(-1)
        differing += int(diff.sum())
        pixels += diff.numel()
        gaps['collision_gap'] = max(gaps['collision_gap'], float(
            (g['collision'].float() - ref['collision']).abs().max()))
        off = (g['offroad'].float() - ref['offroad']).abs() > OFFROAD_TOL * (
            1.0 + ref['offroad'].abs())
        off_n += int(off.sum())
        values += off.numel()
        gaps['wrong_way_gap'] = max(gaps['wrong_way_gap'], float(
            (g['wrong_way'].float() - ref['wrong_way']).abs().max()))
        gaps['light_violation_mismatch'] += float(
            (g['light_violation'].bool() != ref['light_violation']).sum())
    gaps['image_mismatch'] = differing / max(pixels, 1)
    gaps['offroad_mismatch'] = off_n / max(values, 1)
    return gaps


def check(r, w, envs_np, recorded):
    episode = int(r.traffic['episode_steps'])
    steps = sorted({i % episode for i in recorded})
    want = reference_run(r, w, envs_np, steps)
    got = {i: recorded[i] for i in recorded}
    for name, value in compare(r, got, {i: want[i % episode] for i in recorded}).items():
        r.compare(name, value)
