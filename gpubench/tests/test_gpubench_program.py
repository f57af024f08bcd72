"""The program's spans and counters as the traced run reads them
(:mod:`gpubench.program`): a traced CPU rehearsal of each cell at a tiny
size reports every per-layer metric that reads them, non-null; against a
program without the tracing module each of those metrics reads nothing and
the run still completes."""
import sys
import time

import pytest
import torch

from gpubench import harness

from test_gpubench_reference import SEED

TINY = {'rollout_untextured': {'batch': 2, 'check_envs': 2, 'check_steps': 2,
                               'episode_steps': 3, 'warmup_steps': 1, 'trace_steps': 2,
                               'config': {'res': 32}},
        'il_untextured': {'batch': 1, 'horizon': 2, 'warmup_rollouts': 0,
                          'trace_rollouts': 1, 'config': {'res': 16}}}


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(4)


def program_metrics(cell):
    """The cell's per-layer metrics whose readers use :mod:`gpubench.program`."""
    return [m['name'] for m in harness.metrics_for(harness.load_benchmark(), cell,
                                                    'per_layer')
            if 'gpubench import program' in open(
                f'{harness.HERE}/metrics/{m["name"]}.py').read()]


@pytest.mark.parametrize('cell', list(TINY))
def test_traced_rehearsal_reports_every_program_metric(cell):
    names = program_metrics(cell)
    assert len(names) == {'rollout_untextured': 8, 'il_untextured': 5}[cell]
    res = harness.run_cell(cell, SEED, 0.0, True, device='cpu',
                           t_start=time.perf_counter(), overrides=TINY[cell])
    got = {k: v['value'] for k, v in res['metrics'].items() if k in names}
    assert set(got) == set(names) and all(v is not None for v in got.values()), got
    assert all(v >= 0 for v in got.values())
    assert res['correct']


def test_a_program_without_tracing_reads_nothing(monkeypatch):
    import torchdrivesim_tpu_torch
    monkeypatch.delattr(torchdrivesim_tpu_torch, 'tracing')
    monkeypatch.setitem(sys.modules, 'torchdrivesim_tpu_torch.tracing', None)
    cell = 'rollout_untextured'
    res = harness.run_cell(cell, SEED, 0.0, True, device='cpu',
                           t_start=time.perf_counter(), overrides=TINY[cell])
    assert not set(program_metrics(cell)) & set(res['metrics'])
    assert 'render_ms.rollout' in res['metrics'] and res['correct']
