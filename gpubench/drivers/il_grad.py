"""
Driver of the imitation-learning cells: ``benchmark.make_il_grad_fn`` of the
port (the loss of a ``horizon``-step rollout in which each environment's
first agent follows ``BirdviewCNNPolicy`` on its differentiable view, and
the gradient with respect to every policy parameter), every gradient
rollout from the seeded initial state. The policy takes ``weight_sets``
sets of weights in turn, one set a rollout, as a training loop's weights
change from step to step, in an order drawn from the seed: every run does
the same work, and the run seed picks which sets are checked.

Correctness: the loss and every parameter gradient of the window's last
gradient rollout and of the first rollout with the same weights against
the plain reference's (:mod:`gpubench.reference.il`) on the same initial
state and weights.
"""
import numpy as np
import torch

from gpubench import bounds, world
from gpubench import scenario as scenario_of
from gpubench.reference import il as ref_il
from gpubench.reference import scene as ref_scene
from gpubench.reference import soft as ref_soft


def policy_shapes(cfg):
    """The policy's parameter shapes, in ``parameters()`` order."""
    p = cfg['policy']
    chans = [3, *p['features']]
    shapes = []
    for cin, cout in zip(chans[:-1], chans[1:]):
        shapes += [(cout, cin, 3, 3), (cout,)]
    shapes += [(p['hidden'], chans[-1]), (p['hidden'],),
               (p['action_size'], p['hidden']), (p['action_size'],)]
    return shapes


def make_weights(cfg, device) -> list:
    """``weight_sets`` sets of the policy's float32 parameters from the
    configuration's ``weight_seed``, made on the device in one call: each
    uniform in +-1/sqrt(fan in), PyTorch's default bound."""
    shapes = policy_shapes(cfg)
    sizes = [int(np.prod(s)) for s in shapes]
    gen = torch.Generator(device=device).manual_seed(int(cfg['weight_seed']))
    flat = torch.rand((int(cfg['weight_sets']), sum(sizes)), generator=gen,
                      device=device) * 2.0 - 1.0
    sets = []
    for row in flat:
        out, i = [], 0
        for k, (shape, n) in enumerate(zip(shapes, sizes)):
            fan_in = int(np.prod(shapes[k - k % 2][1:]))
            out.append((row[i:i + n] / fan_in ** 0.5).reshape(shape))
            i += n
        sets.append(out)
    return sets


def set_order(r, n_sets: int) -> list:
    """The order in which a run's rollouts take the weight sets, drawn from
    the seed apart from the world's generator."""
    return [int(k) for k in np.random.default_rng([r.seed, 2]).permutation(n_sets)]


def build_program(r, w, weights):
    """The port's IL scenario (the untextured differentiable renderer over
    the road mesh) and its policy with ``weights``."""
    from torchdrivesim_tpu_torch.models import BirdviewCNNPolicy
    from torchdrivesim_tpu_torch.rendering.base import RendererConfig
    cfg = r.config
    scenario = scenario_of.build(
        r, w, renderer=RendererConfig(differentiable=True, soft_sigma=cfg['soft_sigma']),
        grids=False)
    p = cfg['policy']
    policy = BirdviewCNNPolicy(p['action_size'], tuple(p['features']),
                               dtype=getattr(torch, p['dtype'])).to(r.device)
    with torch.no_grad():
        for param, value in zip(policy.parameters(), weights):
            param.copy_(value)
    return scenario, policy


def run(r):
    from torchdrivesim_tpu_torch.benchmark import make_il_grad_fn, make_il_loss_fn
    cfg, t = r.config, r.traffic
    r.mark('imports')
    w = world.make_world(cfg, t, r.seed)
    weight_sets = make_weights(cfg, r.device)
    order = set_order(r, len(weight_sets))
    r.mark('inputs')
    scenario, policy = build_program(r, w, weight_sets[order[0]])
    r.mark('program')
    horizon = int(t.get('horizon', cfg['horizon']))
    grad_fn = make_il_grad_fn(scenario, policy, horizon)
    params = list(policy.parameters())
    init = scenario.sim.state
    b = w['agent_state'].shape[0]
    carry = {'checksum': torch.zeros((), device=r.device)}

    def one(i):
        k = order[i % len(order)]
        with torch.no_grad():
            for param, value in zip(params, weight_sets[k]):
                param.copy_(value)
        loss, grads = grad_fn(init)
        carry['checksum'] = carry['checksum'] + loss + sum(g.sum() for g in grads)
        return k, loss, grads

    for i in range(int(t['warmup_rollouts'])):
        one(i)
    r.setup_done()
    first = {}

    def call(i):
        k, loss, grads = one(i)
        if k not in first:
            first[k] = (loss.clone(), [g.clone() for g in grads])
        carry['last'] = (k, loss, grads)

    timing = r.window(call)
    r.e2e['grad_steps_per_s'] = b * horizon * timing['calls'] / timing['seconds']
    r.read_memory()
    if not torch.isfinite(carry['checksum']):
        r.failed = timing['calls']
    last, loss, grads = carry['last']
    recorded = [first[last], (loss, grads)]

    if r.trace:
        loss_fn = make_il_loss_fn(scenario, policy, horizon)
        r.open_spans()
        for _ in range(int(t['trace_rollouts'])):
            loss = r.spanned('il_forward', loss_fn, init)
            r.spanned('il_backward', torch.autograd.grad, loss, params)
        r.close_spans()

        def profiled():
            with torch.profiler.record_function('gpubench.il_forward'):
                loss = loss_fn(init)
            with torch.profiler.record_function('gpubench.il_backward'):
                torch.autograd.grad(loss, params)

        r.profile(profiled)
    del scenario, policy, params, grad_fn, init, carry
    if r.cuda:
        torch.cuda.empty_cache()
    check(r, w, weight_sets[last], recorded)


def reference(r, w, weights, dtype=torch.float32):
    """The reference's loss, gradients and states of the rollout."""
    cfg, dev = r.config, r.device
    road = ref_scene.RoadMesh(*world.load_road_mesh(w['map']), device=dev)
    frame = ref_soft.Frame(road, cfg['res'], cfg['fov'], w['left_handed'],
                           cfg['soft_sigma'], cfg['soft_gamma'],
                           block=int(r.traffic['reference_block']))
    as_t = lambda x: torch.as_tensor(x, device=dev)
    return ref_il.loss_and_grads(frame, weights, as_t(w['agent_state']),
                                 as_t(w['agent_size']), as_t(w['lr']), cfg['dt'],
                                 w['left_handed'], int(r.traffic.get('horizon', cfg['horizon'])),
                                 dtype=dtype)


def gaps(loss, grads, ref_loss, ref_grads) -> dict:
    """The numbers compared: the loss's relative gap, and by the worst
    leaf one minus the cosine between the program's gradient and the
    reference's (the direction). Beside them, not compared: by the worst
    leaf the gap of the gradient norms and the norm of the difference, each
    over the larger of the leaf's reference norm and the median leaf's."""
    norms = [float(g.norm()) for g in ref_grads]
    floor = float(np.median(norms))
    scale = [max(n, floor) for n in norms]
    cos = lambda a, b: float((a.double() * b.double()).sum()
                             / (a.double().norm() * b.double().norm()).clamp(min=1e-300))
    return {
        'loss_gap': abs(float(loss) - float(ref_loss)) / max(abs(float(ref_loss)), 1e-30),
        'grad_cos_gap': max(1.0 - cos(g.float(), rg) for g, rg in zip(grads, ref_grads)),
    }, {
        'grad_norm_gap': max(abs(float(g.norm()) - n) / s
                             for g, n, s in zip(grads, norms, scale)),
        'grad_diff': max(float((g.float() - rg).norm()) / s
                         for g, rg, s in zip(grads, ref_grads, scale)),
    }


def check(r, w, weights, recorded):
    import sys
    ref_loss, ref_grads, states = reference(r, w, weights)
    worst, seen = {}, {}
    for loss, grads in recorded:
        compared, beside = gaps(loss, grads, ref_loss, ref_grads)
        for k, v in compared.items():
            worst[k] = max(worst.get(k, 0.0), v)
        for k, v in beside.items():
            seen[k] = max(seen.get(k, 0.0), v)
    print('not compared: ' + ', '.join(f'{k} {v!r}' for k, v in seen.items()),
          file=sys.stderr)
    for k, v in worst.items():
        r.compare(k, v)
    if r.trace:
        frame_bounds(r, w, states)


def frame_bounds(r, w, states):
    """B5a's and B5b's bounds on a few frames of the rollout, from the
    scene: each frame's face coefficients worked out by the reference."""
    cfg = r.config
    road = ref_scene.RoadMesh(*world.load_road_mesh(w['map']), device=r.device)
    frame = ref_soft.Frame(road, cfg['res'], cfg['fov'], w['left_handed'],
                           cfg['soft_sigma'], cfg['soft_gamma'])
    size = torch.as_tensor(w['agent_size'], device=r.device)
    fwd, bwd = [], []
    horizon = states.shape[0] - 1
    for k in sorted({0, horizon // 3, 2 * horizon // 3, horizon - 1}):
        with torch.no_grad():
            coef, _, _ = frame.operands(states[k], size)
        shared = road.tris.shape[0]
        fwd.append(bounds.accum_bound_s(coef, cfg['res'], False, shared))
        bwd.append(bounds.accum_bound_s(coef, cfg['res'], True, shared))
    r.scenes['b5a_bound_s'] = float(np.mean(fwd))
    r.scenes['b5b_bound_s'] = float(np.mean(bwd))
