"""
The port's spans and counters (``torchdrivesim_tpu_torch.tracing``) on the
CPU: spans off record nothing and open no profiler range; spans on nest as
the step's layers (``step`` over ``dynamics``, ``scene``, ``render`` over
``render.operands`` and ``render.raster``, and ``metrics``), in the
records and in a profiler's trace around the step's operations; the
render's backward runs under no forward span; the counters count the sort
route and the kernel libraries' loads. Imports neither JAX nor the JAX
package.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from torchdrivesim_tpu_torch import parallel, tracing
from torchdrivesim_tpu_torch.ops import build
from torchdrivesim_tpu_torch.ops.grids import Grid2D
from torchdrivesim_tpu_torch.rendering.base import Cameras, RendererConfig
from torchdrivesim_tpu_torch.rendering.renderer import Renderer
from torchdrivesim_tpu_torch.utils import Resolution

STEP_LAYERS = {'dynamics': 'step', 'scene': 'step', 'render': 'step', 'metrics': 'step',
               'render.operands': 'render', 'render.raster': 'render'}


@pytest.fixture(autouse=True)
def spans_off():
    """Each test starts and ends with spans off and the store empty."""
    tracing.enable(False)
    tracing.collect()
    yield
    tracing.enable(False)
    tracing.collect()


@pytest.fixture(scope='module')
def rollout():
    """A tiny untextured scenario's step and its zero action (B = 1, 2 cars,
    res 32, the road mesh drawn every frame)."""
    from torchdrivesim_tpu_torch.benchmark import build_benchmark_scenario
    scenario = build_benchmark_scenario(batch_size=1, agent_count=2, res=32,
                                        use_texture=False, device='cpu')
    sim = scenario.sim
    action = torch.zeros((1, 2, sim.action_size))
    return scenario.make_step_fn(render=True, metrics=True), sim.state, action


def _by_id(records):
    return {r.id: r for r in records}


def test_spans_off_record_nothing_and_open_no_range(rollout):
    step, state, action = rollout
    assert tracing.span('step') is tracing.span('render')     # one shared object
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, action)
    assert tracing.collect() == []
    names = [e.name for e in prof.events()]
    assert any(n.startswith('aten::') for n in names)
    assert not any(n.startswith(tracing.PREFIX) for n in names)


def test_step_spans_nest_as_its_layers(rollout):
    step, state, action = rollout
    tracing.enable(True)
    step(state, action)
    records = tracing.collect()
    assert sorted(r.name for r in records) == sorted(['step', *STEP_LAYERS])
    by_id, named = _by_id(records), {r.name: r for r in records}
    assert named['step'].parent is None
    for name, parent in STEP_LAYERS.items():
        r, p = named[name], by_id[named[name].parent]
        assert p.name == parent
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        assert r.device_ms is None                # the CPU records no events
    layers = [named[n] for n in ('dynamics', 'scene', 'render', 'metrics')]
    assert all(a.end_ns <= b.start_ns for a, b in zip(layers, layers[1:]))


def test_step_spans_enclose_the_steps_operations_in_a_trace(rollout):
    step, state, action = rollout
    tracing.enable(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, action)
    assert len(tracing.collect()) == 1 + len(STEP_LAYERS)
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    ranges = {n[len(tracing.PREFIX):]: (s, e) for n, s, e in events
              if n.startswith(tracing.PREFIX)}
    assert set(ranges) == {'step', *STEP_LAYERS}
    for name, parent in STEP_LAYERS.items():
        assert ranges[parent][0] <= ranges[name][0] <= ranges[name][1] <= ranges[parent][1]
    s0, s1 = ranges['step']
    ops = [(s, e) for n, s, e in events if n.startswith('aten::')]
    assert ops and all(s0 <= s and e <= s1 for s, e in ops)
    r0, r1 = ranges['render.raster']
    assert any(r0 <= s and e <= r1 for s, e in ops)


def test_render_backward_runs_under_no_forward_span():
    from torchdrivesim_tpu_torch.benchmark import build_il_scenario, make_il_loss_fn
    from torchdrivesim_tpu_torch.models import BirdviewCNNPolicy
    torch.manual_seed(0)
    scenario = build_il_scenario(batch_size=1, agent_count=2, res=16, use_texture=False,
                                 device='cpu')
    policy = BirdviewCNNPolicy(2, (4, 8))
    tracing.enable(True)
    loss = make_il_loss_fn(scenario, policy, horizon=2)(scenario.sim.state)
    grads = torch.autograd.grad(loss, list(policy.parameters()))
    records = tracing.collect()
    names = [r.name for r in records]
    for name in ('scene', 'render', 'render.operands', 'render.raster', 'policy', 'dynamics'):
        assert names.count(name) == 2, (name, names)
    assert all(r.parent is None for r in records if r.name in ('render', 'policy', 'dynamics'))
    # the first frame is the start's, which no parameter moves: one backward
    backward = [r for r in records if r.name == 'render.backward']
    assert len(backward) == 1 and backward[0].parent is None
    assert all(torch.isfinite(g).all() for g in grads)


def _textured_renderer(cap):
    """A CPU renderer over a smooth 512 x 512 texture, ``cap`` primitives a
    type at most before the sort route."""
    y, x = np.mgrid[0:512, 0:512] / 512.0
    data = np.stack([0.5 + 0.4 * np.sin(6 * x), 0.5 + 0.4 * np.sin(6 * y), 0.5 + 0 * x],
                    -1).astype(np.float32)
    r = Renderer(RendererConfig(cull_max_faces=0, band_budget=cap), 'cpu')
    r.background_texture = Grid2D(data=data, origin=np.asarray([-128.0, -128.0], np.float32),
                                  cell_size=0.5)
    return r


def _prims(b, q, t, seed=0):
    rng = np.random.RandomState(seed)
    c = torch.as_tensor(rng.uniform(-15, 15, (b, q, 1, 2)), dtype=torch.float32)
    quads = c + torch.tensor([[0.0, 0.0], [2.0, 0.0], [2.0, 1.0], [0.0, 1.0]])
    tc = torch.as_tensor(rng.uniform(-15, 15, (b, t, 1, 2)), dtype=torch.float32)
    tris = tc + torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    col = lambda n: torch.as_tensor(rng.uniform(0.2, 1, (b, n, 3)), dtype=torch.float32)
    z = lambda n: torch.as_tensor(rng.rand(b, n), dtype=torch.float32)
    return quads, z(q), col(q), tris, z(t), col(t)


def _cameras(b):
    return Cameras(torch.zeros((b, 2)), torch.tensor([[0.0, 1.0]] * b), 2.0 / 40.0)


@pytest.mark.parametrize('q, routes', [(6, 0), (12, 1)])
def test_sort_route_counted_once_per_frame_past_the_cap(q, routes):
    renderer = _textured_renderer(cap=8)
    before = tracing.counts().get('render.sort_route', 0)
    image = renderer.render_prims_chw(*_prims(2, q, 4), Resolution(32, 32), _cameras(2))
    assert image.shape == (2, 3, 32, 32)
    assert tracing.counts().get('render.sort_route', 0) == before + routes


def test_padded_render_opens_one_render_span():
    """A size that is not a multiple of 16 renders padded: the re-entry
    opens no second ``render`` span."""
    renderer = _textured_renderer(cap=8)
    tracing.enable(True)
    image = renderer.render_prims_chw(*_prims(1, 4, 2), Resolution(20, 20), _cameras(1))
    assert image.shape == (1, 3, 20, 20)
    names = [r.name for r in tracing.collect()]
    assert sorted(names) == ['render', 'render.operands', 'render.raster']


def test_sharded_render_opens_its_parts_per_slice():
    """Over a mesh of two entries the render span holds each slice's
    operands and raster spans."""
    renderer = _textured_renderer(cap=8)
    renderer.shard_mesh = parallel.make_mesh(devices=['cpu', 'cpu'])
    tracing.enable(True)
    renderer.render_prims_chw(*_prims(2, 4, 2), Resolution(32, 32), _cameras(2))
    records = tracing.collect()
    by_id = _by_id(records)
    assert sorted(r.name for r in records) == ['render', 'render.operands',
                                               'render.operands', 'render.raster',
                                               'render.raster']
    assert all(by_id[r.parent].name == 'render' for r in records if r.name != 'render')


def test_collect_empties_the_store():
    tracing.enable(True)
    with tracing.span('outer'):
        with tracing.span('inner'):
            pass
    first = tracing.collect()
    assert [r.name for r in first] == ['outer', 'inner']
    assert first[1].parent == first[0].id and first[0].host_ms >= first[1].host_ms >= 0
    assert tracing.collect() == []
    tracing.enable(False)
    with tracing.span('off'):
        pass
    assert tracing.collect() == []


def test_counters_add_and_copy():
    before = tracing.counts().get('test.counter', 0)
    tracing.count('test.counter')
    tracing.count('test.counter', 2.5)
    counts = tracing.counts()
    assert counts['test.counter'] == before + 3.5
    counts['test.counter'] = -1
    assert tracing.counts()['test.counter'] == before + 3.5


def test_kernel_library_counts_its_build_and_load(tmp_path, monkeypatch):
    """A library built and loaded counts ``kernel.build``, ``kernel.load``
    and its seconds once; a second load counts nothing."""
    monkeypatch.setattr(build, 'BUILD_DIR', str(tmp_path))
    lib = build.KernelLibrary('fused_render.cu', lambda cdll: cdll)

    @dataclasses.dataclass
    class Done:
        returncode: int = 0

        def communicate(self):
            return '', ''

    def start():
        tmp = tmp_path / 'partial.so'
        tmp.write_bytes(b'')
        return Done(), str(tmp)
    monkeypatch.setattr(lib, '_start', start)
    monkeypatch.setattr(ctypes, 'CDLL', lambda path: object())
    keys = ('kernel.build', 'kernel.load', 'kernel.load_s')
    before = [tracing.counts().get(k, 0) for k in keys]
    lib.load()
    after = [tracing.counts().get(k, 0) for k in keys]
    assert after[0] == before[0] + 1 and after[1] == before[1] + 1 and after[2] > before[2]
    lib.load()
    assert [tracing.counts().get(k, 0) for k in keys] == after
