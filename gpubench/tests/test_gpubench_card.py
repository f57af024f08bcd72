"""Each cell of BENCHMARK.json as the check runs it, with a short window,
on the card: exit 0, the contract's last line, ``correct`` true. Skips
without a CUDA card (decided inside the test). On the card:
``python -m pytest --noconftest gpubench/tests/test_gpubench_card.py``."""
import json
import subprocess
import sys

import pytest

from gpubench import harness


@pytest.mark.depends_on_cuda
@pytest.mark.parametrize('cell', [w['name'] for w in harness.load_benchmark()['workloads']])
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    p = subprocess.run([sys.executable, 'gpubench/run.py', '--workload', cell, '--seed',
                        '4100000000', '--seconds', '3', '--trace', '0'],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == 'compared'
    assert result['device']['platform'] == 'gpu' and result['correct'], result['compared']
