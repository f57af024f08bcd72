"""
Run one cell several times, one process per run as a check runs it, and
summarise: each run's result line, and per metric the median and the spread
((Q3 - Q1) / median, by ``statistics.quantiles(values, n=4)``) of each set.

    python3 gpubench/measure.py --workload <cell> --seconds <s> \\
        --sets 2 --runs 6 [--trace 0|1] [--seed0 N] [--out results.jsonl]

Every set uses the same seeds (``seed0``, ``seed0 + 1``, ...). Results go to
``--out`` as JSON lines (the run's result, its seed, set, exit code and the
end of its standard error).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values):
    if len(values) < 2:
        return float('nan')
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float('nan')


def one(workload, seed, seconds, trace, timeout):
    cmd = [sys.executable, os.path.join(HERE, 'run.py'), '--workload', workload,
           '--seed', str(seed), '--seconds', str(seconds), '--trace', str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    lines = [l for l in p.stdout.splitlines() if l.strip()]
    result = None
    if p.returncode == 0 and lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            pass
    return {'seed': seed, 'rc': p.returncode, 'wall_s': time.perf_counter() - t0,
            'result': result, 'stderr_tail': p.stderr[-3000:]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--sets', type=int, default=1)
    ap.add_argument('--runs', type=int, default=3)
    ap.add_argument('--trace', type=int, default=0)
    ap.add_argument('--seed0', type=int, default=3_000_000_000)
    ap.add_argument('--seeds', type=str, default='')
    ap.add_argument('--timeout', type=float, default=1200)
    ap.add_argument('--out', default='')
    a = ap.parse_args()
    seeds = [int(s) for s in a.seeds.split(',')] if a.seeds else \
        [a.seed0 + i for i in range(a.runs)]
    out = open(a.out, 'a') if a.out else None
    sets = []
    for k in range(a.sets):
        runs = []
        for seed in seeds:
            rec = one(a.workload, seed, a.seconds, a.trace, a.timeout)
            rec['set'] = k
            rec['workload'] = a.workload
            runs.append(rec)
            if out:
                out.write(json.dumps(rec) + '\n')
                out.flush()
            res = rec['result'] or {}
            print(json.dumps({'set': k, 'seed': seed, 'rc': rec['rc'],
                              'wall_s': round(rec['wall_s'], 1),
                              'correct': res.get('correct'),
                              'metrics': {m: v['value'] for m, v in
                                          res.get('metrics', {}).items()},
                              'compared': {m: v['value'] for m, v in
                                           res.get('compared', {}).items()}}),
                  flush=True)
            if rec['rc'] != 0:
                print(rec['stderr_tail'][-2000:], flush=True)
        sets.append(runs)
    for k, runs in enumerate(sets):
        ok = [r['result'] for r in runs if r['result']]
        names = sorted({m for r in ok for m in r['metrics']})
        for m in names:
            vals = [r['metrics'][m]['value'] for r in ok if m in r['metrics']]
            print(f'set {k} {m}: median {statistics.median(vals)!r} spread '
                  f'{spread(vals)!r} n {len(vals)} values {vals}', flush=True)


if __name__ == '__main__':
    main()
