"""BENCHMARK.json against the benchmark's contract, and the harness's
discovery of configurations, cells, drivers and metric readers by name."""
import json
import os
import re
import shutil

import pytest

from gpubench import harness

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
KEYS = {
    'top': {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end',
            'per_layer'},
    'config': {'name', 'source', 'file', 'reduced', 'why'},
    'workload': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}


@pytest.fixture(scope='module')
def bench():
    return harness.load_benchmark()


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS['top']
    assert os.path.getsize(os.path.join(harness.ROOT, 'BENCHMARK.json')) <= 64 * 1024
    assert 1 <= len(bench['command']) <= 32 and all(line(w) for w in bench['command'])
    assert bench['paths'] == ['gpubench']
    assert 1 <= bench['run_seconds'] <= 51
    for c in bench['configs']:
        assert set(c) == KEYS['config'] and NAME.match(c['name'])
        assert line(c['source']) and line(c['why']) and len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
    for w in bench['workloads']:
        assert set(w) == KEYS['workload'] and NAME.match(w['name'])
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        assert w['chips'] in (1, 4) and line(w['why'])
    for section in ('end_to_end', 'per_layer'):
        for m in bench[section]:
            assert set(m) - {'workloads'} == KEYS[section], m['name']
            assert NAME.match(m['name']) and UNIT.match(m['unit'])
            assert m['better'] in ('lower', 'higher')
    names = [x['name'] for s in ('configs', 'workloads', 'end_to_end', 'per_layer')
             for x in bench[s]]
    assert len(names) == len(set(names))


def test_bounds_and_sources(bench):
    e2e = {m['name']: m for m in bench['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in bench['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in bench['per_layer']:
        assert m['source'] in ('device_trace', 'program_span', 'program_counter',
                               'host_clock')
        assert line(m['layer'])


def test_every_name_resolves(bench):
    cells = {w['name']: w for w in bench['workloads']}
    configs = {c['name']: c for c in bench['configs']}
    files = [c['file'] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c['file'].startswith('gpubench/')
        assert os.path.exists(os.path.join(harness.ROOT, c['file']))
        assert any(w['config'] == c['name'] for w in cells.values())
    for name, w in cells.items():
        assert w['config'] in configs
        cell = harness.load_json(harness.cell_file(name))
        assert cell['config'] == w['config'] and cell['chips'] == w['chips']
        assert cell['traffic']['name'] == w['traffic'] and cell['why'] == w['why']
        assert os.path.exists(os.path.join(harness.HERE, 'drivers', cell['driver'] + '.py'))
        e2e = [m['name'] for m in harness.metrics_for(bench, name, 'end_to_end')]
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert harness.metrics_for(bench, name, 'per_layer')
    e2e = {m['name']: m for m in bench['end_to_end']}
    layers = {}
    for m in bench['per_layer']:
        assert m['moves'] in e2e
        assert os.path.exists(os.path.join(harness.HERE, 'metrics', m['name'] + '.py'))
        for cell in m.get('workloads', []):
            assert cell in cells
            reported = [x['name'] for x in harness.metrics_for(bench, cell, 'end_to_end')]
            assert m['moves'] in reported
        layers.setdefault(m['layer'].lower(), set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values())
    four = sum(1 for w in cells.values() if w['chips'] == 4)
    assert four <= max(1, len(cells) // 4)


def test_files_under_paths_are_named_from_names():
    allowed = re.compile(r'^[A-Za-z0-9_./\-]+$')
    for dirpath, _, filenames in os.walk(harness.HERE):
        if '__pycache__' in dirpath:
            continue
        for f in filenames:
            rel = os.path.relpath(os.path.join(dirpath, f), harness.ROOT)
            assert allowed.match(rel) and len(rel) <= 200, rel


def test_new_files_are_found_by_name_without_edits(tmp_path, monkeypatch):
    """A configuration, a cell, a driver and a metric reader dropped into
    their folders are found by name; no file that exists is touched."""
    root = tmp_path / 'gpubench'
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in root.rglob('*') if p.is_file()}
    (root / 'configs' / 'new_config.json').write_text(json.dumps({'map': 'm', 'x': 1}))
    (root / 'workloads' / 'new_cell.json').write_text(json.dumps({
        'config': 'new_config', 'driver': 'new_driver', 'chips': 1, 'why': 'w',
        'traffic': {'name': 'new_traffic', 'n': 3}, 'limits': {'gap': 0.5}}))
    (root / 'drivers' / 'new_driver.py').write_text(
        'def run(r):\n'
        '    r.setup_done()\n'
        '    r.window(lambda i: None)\n'
        '    r.e2e["things_per_s"] = 1.0\n'
        '    r.spans["s"] = [2.0]\n'
        '    r.compare("gap", 0.25)\n')
    (root / 'metrics' / 'new_metric.py').write_text(
        'def read(run):\n    return run.spans["s"][0]\n')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps({
        'end_to_end': [{'name': 'setup_s', 'unit': 's'},
                       {'name': 'things_per_s', 'unit': '1/s', 'workloads': ['new_cell']}],
        'per_layer': [{'name': 'new_metric', 'unit': 'ms', 'moves': 'things_per_s'}]}))
    monkeypatch.setattr(harness, 'HERE', str(root))
    monkeypatch.setattr(harness, 'ROOT', str(tmp_path))
    for trace, want in ((False, {'setup_s', 'things_per_s'}), (True, {'new_metric'})):
        res = harness.run_cell('new_cell', 1, 0.0, trace, device='cpu', t_start=0.0)
        assert set(res['metrics']) == want
        assert res['correct'] and res['compared'] == {'gap': {'value': 0.25, 'limit': 0.5}}
    assert all(p.read_bytes() == data for p, data in before.items())
