"""The import guard (whole top-level names), the reference's independence
from the program, and the command's refusals."""
import os
import shutil
import subprocess
import sys

from gpubench import harness


def test_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(['torchdrivesim_tpu_torch',
                                      'torchdrivesim_tpu_torch.ops.soft']) == []
    assert harness.forbidden_modules(['torchdrivesim_tpu.ops.soft']) == ['torchdrivesim_tpu']
    assert harness.forbidden_modules(['jax.numpy', 'jaxlib.xla_client', 'flax.linen']) \
        == ['flax', 'jax', 'jaxlib']
    assert harness.forbidden_modules(['jaxtyping', 'flaxen', 'torchdrivesim_tpu_x']) == []


def test_guard_sees_a_forbidden_import_in_a_run(tmp_path, monkeypatch):
    root = tmp_path / 'gpubench'
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns('__pycache__'))
    (root / 'configs' / 'c.json').write_text('{}')
    (root / 'workloads' / 'w.json').write_text(
        '{"config": "c", "driver": "d", "chips": 1, "why": "w", "traffic": {}, '
        '"limits": {}}')
    (root / 'drivers' / 'd.py').write_text(
        'import sys, types\n'
        'def run(r):\n'
        '    sys.modules["torchdrivesim_tpu.fake"] = types.ModuleType("fake")\n'
        '    r.setup_done()\n')
    (tmp_path / 'BENCHMARK.json').write_text('{"end_to_end": [], "per_layer": []}')
    monkeypatch.setattr(harness, 'HERE', str(root))
    monkeypatch.setattr(harness, 'ROOT', str(tmp_path))
    try:
        harness.run_cell('w', 1, 0.0, False, device='cpu', t_start=0.0)
        raise AssertionError('the guard did not see torchdrivesim_tpu')
    except harness.ImportGuardError as e:
        assert e.found == ['torchdrivesim_tpu']
    finally:
        sys.modules.pop('torchdrivesim_tpu.fake', None)


def test_reference_imports_nothing_of_the_program():
    code = ('import sys; sys.path.insert(0, %r)\n'
            'import gpubench.reference.il, gpubench.reference.metrics, '
            'gpubench.reference.render, gpubench.reference.scene, '
            'gpubench.reference.sim, gpubench.reference.soft, gpubench.world, '
            'gpubench.bounds\n'
            'names = {m.split(".")[0] for m in sys.modules}\n'
            'print(sorted(names & {"torchdrivesim_tpu_torch", "torchdrivesim_tpu", '
            '"jax", "jaxlib", "flax"}))' % harness.ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, JAX_PLATFORMS='cpu'))
    assert out.stdout.strip() == '[]'


def run_command(cwd):
    return subprocess.run([sys.executable, 'gpubench/run.py', '--workload',
                           'rollout_untextured', '--seed', '5000000000', '--seconds', '1',
                           '--trace', '0'], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    p = run_command(harness.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ''


def test_command_fails_beside_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the run fails (there is no program to run) and prints nothing."""
    shutil.copytree(harness.HERE, tmp_path / 'gpubench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(harness.ROOT, 'BENCHMARK.json'), tmp_path)
    p = run_command(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ''
