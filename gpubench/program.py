"""
The program's own spans and counters (``torchdrivesim_tpu_torch.tracing``)
over the function the cell's window runs, for the per-layer metrics that
read them. A traced run's first such metric calls :func:`measure`, which
keeps what it found on the run as ``run.program``; the others read it.

:func:`measure` reads the counters first (every kernel is loaded by the end
of the warm-up, and nothing after it loads one), then builds the cell's
function anew from the seeded start, as its driver builds it: the rollout
driver's ``make_step_fn`` step, or the IL driver's ``make_il_grad_fn``
taking the weight sets in the run's order. It runs that function twice,
over ``trace_steps`` steps or ``trace_rollouts`` rollouts each time:

(a) with spans on and no profiler: from ``tracing.collect()``, for each
    span name its stream ms (CUDA events) and host ms per step or rollout;
    the same calls with spans off give the spans' own cost;
(b) with spans on under :func:`gpubench.trace.profile`: the device's idle
    time inside each innermost ``tds.*`` range of the host, and inside the
    ``tds.render`` ranges with their children.

On the CPU, where runs are only rehearsals, a span's stream time is its
host time, as :meth:`gpubench.harness.Run.event` has it. A program without
the tracing module gives nothing: :func:`measure` returns None, and so do
the metrics.
"""
import sys
import time

from gpubench import harness, trace, world
from gpubench import scenario as scenario_of

#: the prefix of the program's spans in a profiler's trace
PREFIX = 'tds.'


def measure(run):
    """The program's spans and counters over the cell's function (see the
    module), kept on ``run.program``; None without the tracing module."""
    if not hasattr(run, 'program'):
        run.program = _measure(run)
    return run.program


def span_ms(run, name: str, device: bool = True):
    """Run (a)'s stream ms (or host ms) of the span ``name`` per call, or
    None where the program has no tracing module or no such span."""
    p = measure(run)
    return None if p is None else p['device_ms' if device else 'host_ms'].get(name)


def _measure(run):
    try:
        from torchdrivesim_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counts()
    call, n = _cell_function(run)
    call()                                   # its first call's allocations
    run.sync()

    tracing.enable(True)
    host, stream = _timed(run, call, n)
    tracing.enable(False)
    spans = tracing.collect()
    host_off, stream_off = _timed(run, call, n)
    tracing.enable(True)
    profiled = trace.profile(lambda: [call() for _ in range(n)], run.sync)
    tracing.enable(False)
    tracing.collect()

    out = {'counts': counts, 'per': n,
           'device_ms': _per_name(spans, n, device=True),
           'host_ms': _per_name(spans, n, device=False),
           'cost': {'on': {'host_ms': host / n, 'stream_ms': stream / n},
                    'off': {'host_ms': host_off / n, 'stream_ms': stream_off / n}}}
    out.update(_idle(profiled, n))
    _report(run, out)
    return out


def _cell_function(run):
    """(the cell's window function of no arguments from the seeded start,
    the calls to make), built as the cell's driver builds it."""
    import torch
    cfg, t = run.config, run.traffic
    w = world.make_world(cfg, t, run.seed)
    if run.cell['driver'] == 'rollout':
        scenario = scenario_of.build(run, w)
        sim = scenario.sim
        b, a = w['agent_state'].shape[:2]
        step = scenario.make_step_fn(render=True, metrics=True)
        action = torch.zeros((b, a, sim.action_size), device=run.device)
        carry = {'state': sim.state}

        def call():
            carry['state'], _ = step(carry['state'], action)
        return call, int(t['trace_steps'])

    from torchdrivesim_tpu_torch.benchmark import make_il_grad_fn
    driver = harness.load_module('drivers', run.cell['driver'])
    weight_sets = driver.make_weights(cfg, run.device)
    order = driver.set_order(run, len(weight_sets))
    scenario, policy = driver.build_program(run, w, weight_sets[order[0]])
    grad_fn = make_il_grad_fn(scenario, policy, int(t.get('horizon', cfg['horizon'])))
    params, init, done = list(policy.parameters()), scenario.sim.state, [0]

    def call():
        with torch.no_grad():
            for param, value in zip(params, weight_sets[order[done[0] % len(order)]]):
                param.copy_(value)
        done[0] += 1
        grad_fn(init)
    return call, int(t['trace_rollouts'])


def _timed(run, call, n):
    """(host ms to issue ``n`` calls, stream ms from before the first to
    after the last, read after a synchronisation)."""
    run.sync()
    a = run.event()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    host = (time.perf_counter() - t0) * 1e3
    b = run.event()
    run.sync()
    return host, run.elapsed_ms(a, b)


def _per_name(spans, n, device):
    """ms per call by span name, summed over the span's records; a record
    without events (the CPU) counts its host time as its stream time."""
    out = {}
    for s in spans:
        ms = s.host_ms if not device or s.device_ms is None else s.device_ms
        out[s.name] = out.get(s.name, 0.0) + ms / n
    return out


def _overlap(a, b):
    """Length of the intersection of two lists of disjoint (start, end)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _idle(p, n):
    """From run (b)'s trace: the device's idle ms per call inside each
    innermost ``tds.*`` range of the host and inside the ``tds.render``
    ranges with their children, and the innermost range around each of the
    host's stream synchronisations."""
    device = [op for op in p.device_ops if not op[0].startswith(PREFIX)]
    idle = trace.idle_gaps(device, p.t0_us, p.t1_us)
    ranges = sorted((r for r in p.host_ops if r[0].startswith(PREFIX)),
                    key=lambda r: (r[1], -r[2]))
    render = trace.merged([r for r in ranges if r[0] == PREFIX + 'render'])
    by_span = {}
    for k, (name, s, e) in enumerate(ranges):
        inner = trace.merged([r for r in ranges[k + 1:] if r[1] >= s and r[2] <= e])
        key = name[len(PREFIX):]
        by_span[key] = by_span.get(key, 0.0) \
            + _overlap(_subtract([(s, e)], inner), idle) / 1e3 / n
    syncs = {}
    for name, s, e in p.host_ops:
        if name == 'cudaStreamSynchronize':
            around = [r for r in ranges if r[1] <= s and r[2] >= e]
            key = around[-1][0][len(PREFIX):] if around else 'none'
            syncs[key] = syncs.get(key, 0) + 1
    return {'render_idle_ms': _overlap(render, idle) / 1e3 / n, 'idle_by_span': by_span,
            'syncs_by_span': {k: v / n for k, v in syncs.items()}}


def _subtract(outer, inner):
    """``outer`` (disjoint, sorted) less the disjoint sorted ``inner``."""
    out = []
    for s, e in outer:
        cursor = s
        for a, b in inner:
            if b <= cursor or a >= e:
                continue
            if a > cursor:
                out.append((cursor, a))
            cursor = max(cursor, b)
        if cursor < e:
            out.append((cursor, e))
    return out


def _report(run, out):
    unit = 'step' if run.cell['driver'] == 'rollout' else 'rollout'
    fmt = lambda d: ', '.join(f'{k} {v:.4f}' for k, v in sorted(d.items()))
    print(f'program spans per {unit} over {out["per"]}: stream ms {fmt(out["device_ms"])}; '
          f'host ms {fmt(out["host_ms"])}', file=sys.stderr)
    print(f'program idle ms per {unit} by innermost span: {fmt(out["idle_by_span"])}; '
          f'in render {out["render_idle_ms"]:.4f}; stream syncs per {unit} by '
          f'innermost span: {out["syncs_by_span"]}', file=sys.stderr)
    c = out['cost']
    print(f'program spans cost per {unit}: on host {c["on"]["host_ms"]:.4f} ms, stream '
          f'{c["on"]["stream_ms"]:.4f} ms; off host {c["off"]["host_ms"]:.4f} ms, '
          f'stream {c["off"]["stream_ms"]:.4f} ms', file=sys.stderr)
    print(f'program counters: {out["counts"]}', file=sys.stderr)
