"""
The control of a cell's correctness check: the plain reference put in the
program's place and computed in the nearest precision below the one the
configuration states (bfloat16 for float32), compared with the reference
in that precision by the cell's own numbers. Its readings must fail the
cell's limits.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

With ``--faults 1`` an IL cell also reads the faults a gradient step can
have, planted in the reference put in the program's place. An IL cell
is read on the weight set that the seed's run takes first. It runs the
checks at the cell's own sizes (the environments and steps a
run checks, the whole batch and horizon of an IL cell) and prints one JSON
line per seed with the numbers and the limits.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def rollout_readings(driver, r):
    import torch
    from gpubench import world
    w = world.make_world(r.config, r.traffic, r.seed)
    b = w['agent_state'].shape[0]
    envs, steps = driver.checked(r, b)
    steps = sorted(set(steps) | {int(r.traffic['episode_steps']) - 1})
    want = driver.reference_run(r, w, envs, steps)
    low = driver.reference_run(r, w, envs, steps, dtype=torch.bfloat16)
    got = {k: dict(v, image=v['image'].permute(0, 3, 1, 2).float()) for k, v in low.items()}
    return driver.compare(r, got, want)


def il_readings(driver, r, faults: bool = False):
    """The control's numbers; with ``faults`` also those of the gradient
    step's faults planted in the reference put in the program's place: the
    step returns the state unchanged, half of the batch is left out (the
    mean over the rest), and an answer is altered where it is produced (the
    last leaf's gradient negated)."""
    import torch
    from gpubench import world
    from gpubench.reference import sim
    w = world.make_world(r.config, r.traffic, r.seed)
    sets = driver.make_weights(r.config, r.device)
    weights = sets[driver.set_order(r, len(sets))[0]]
    ref_loss, ref_grads, _ = driver.reference(r, w, weights)
    low_loss, low_grads, _ = driver.reference(r, w, weights, dtype=torch.bfloat16)
    compared, beside = driver.gaps(low_loss, low_grads, ref_loss, ref_grads)
    out = dict(compared, **{f'beside.{k}': v for k, v in beside.items()})
    if not faults:
        return out
    step = sim.bicycle_step
    try:
        sim.bicycle_step = lambda state, action, lr, dt, lh: state + 0.0 * action.sum()
        readings = {'state_unchanged': driver.reference(r, w, weights)}
    finally:
        sim.bicycle_step = step
    half = dict(w)
    for k in ('agent_state', 'agent_size', 'lr'):
        half[k] = w[k][: w[k].shape[0] // 2]
    readings['half_batch'] = driver.reference(r, half, weights)
    readings['answer_altered'] = (ref_loss, ref_grads[:-1] + [-ref_grads[-1]], None)
    for name, (loss, grads, _) in readings.items():
        compared, _ = driver.gaps(loss, grads, ref_loss, ref_grads)
        out.update({f'{name}.{k}': v for k, v in compared.items()})
    return out


def readings(cell: str, seed: int, device: str, overrides=None, faults=False) -> dict:
    """The control's numbers for one seed (and the planted faults')."""
    from gpubench import harness
    r = harness.Run(cell, seed, 0.0, False, device, time.perf_counter(), overrides)
    driver = harness.load_module('drivers', r.cell['driver'])
    if r.cell['driver'] == 'il_grad':
        return il_readings(driver, r, faults), r.limits
    return rollout_readings(driver, r), r.limits


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--faults', type=int, default=0)
    a = ap.parse_args()
    for seed in (int(s) for s in a.seeds.split(',')):
        t0 = time.perf_counter()
        values, limits = readings(a.workload, seed, a.device, faults=bool(a.faults))
        fails = [k for k, v in values.items() if k in limits and not v <= limits[k]]
        print(json.dumps({'workload': a.workload, 'seed': seed, 'readings': values,
                          'limits': limits, 'fails': fails,
                          'seconds': time.perf_counter() - t0}), flush=True)


if __name__ == '__main__':
    main()
