"""
The harness: finds a cell's files by name, checks the device and the
imports, times the window, gathers the metrics that ``BENCHMARK.json``
lists for the cell and prints the result.

A driver (``drivers/<name>.py``) defines ``run(r: Run)``, which:

1. builds the cell on ``r.device`` from ``r.config``, ``r.traffic`` and
   ``r.seed`` and warms up every shape it will use, then calls
   ``r.setup_done()``;
2. runs the measured window with :meth:`Run.window` and stores the
   end-to-end metrics it measured in ``r.e2e`` (after
   :meth:`Run.read_memory`);
3. with ``r.trace``, runs its traced segment (:meth:`Run.profile`, spans in
   ``r.spans``, scene data for the bounds in ``r.scenes``);
4. frees the program's state and compares what the window produced with the
   plain reference, calling :meth:`Run.compare` once per number compared.
"""
import importlib.util
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: top-level module names that must not be loaded in a run: JAX and the
#: JAX package the port was made from (compared as whole names)
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'torchdrivesim_tpu')


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names present in ``modules`` (default
    ``sys.modules``), each compared whole: ``torchdrivesim_tpu_torch`` is
    not ``torchdrivesim_tpu``."""
    names = {m.split('.')[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return load_json(os.path.join(ROOT, 'BENCHMARK.json'))


def cell_file(name: str) -> str:
    return os.path.join(HERE, 'workloads', f'{name}.json')


def config_file(name: str) -> str:
    return os.path.join(HERE, 'configs', f'{name}.json')


def load_module(kind: str, name: str):
    """``gpubench/<kind>/<name>.py`` as a module (kind: drivers, metrics)."""
    path = os.path.join(HERE, kind, f'{name}.py')
    if not os.path.exists(path):
        raise FileNotFoundError(f'no {kind[:-1]} named {name!r} ({path})')
    spec = importlib.util.spec_from_file_location(
        f'gpubench.{kind}.{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_for(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` ('end_to_end' or 'per_layer') that the
    cell reports: those that list it under ``workloads``; one without
    ``workloads`` is reported wherever its ``moves`` metric is (an
    end-to-end metric without it, everywhere)."""
    e2e_here = {m['name'] for m in metrics_for(bench, cell, 'end_to_end')} \
        if section == 'per_layer' else set()
    out = []
    for m in bench[section]:
        if 'workloads' in m:
            if cell in m['workloads']:
                out.append(m)
        elif section == 'end_to_end' or m['moves'] in e2e_here:
            out.append(m)
    return out


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Run:
    """One run of one cell: its files, the device and what it measured."""

    def __init__(self, cell_name: str, seed: int, seconds: float, trace: bool,
                 device, t_start: float, overrides: Optional[dict] = None):
        import torch
        self.torch = torch
        self.name = cell_name
        self.cell = load_json(cell_file(cell_name))
        overrides = dict(overrides or {})
        self.config = dict(load_json(config_file(self.cell['config'])),
                           **overrides.pop('config', {}))
        self.traffic = dict(self.cell['traffic'], **overrides)
        self.limits = self.cell['limits']
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == 'cuda'
        self.t_start = t_start
        self.setup_s: Optional[float] = None
        self.e2e: Dict[str, float] = {}
        self.spans: Dict[str, List[float]] = {}      # name -> ms per call
        self.scenes: Dict[str, object] = {}          # data for the bounds
        self.profiled = None                         # trace.Profile
        self.compared: Dict[str, Dict[str, float]] = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.marks: List = []                        # (set-up phase, s since start)

    # --- time ---------------------------------------------------------------

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def event(self):
        """A timing mark on the device stream (a host clock reading on the
        CPU, where runs are only rehearsals)."""
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def elapsed_ms(self, a, b) -> float:
        if self.cuda:
            return a.elapsed_time(b)
        return (b - a) * 1e3

    def mark(self, phase: str):
        """The end of a set-up phase, printed with the set-up's end."""
        self.sync()
        self.marks.append((phase, time.perf_counter() - self.t_start))

    def setup_done(self):
        """Set-up ends: everything is built and warmed up."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        phases = ', '.join(f'{p} {t:.2f}' for p, t in self.marks)
        print(f'set-up: {phases}, warm-up {self.setup_s:.2f} s since start',
              file=sys.stderr)

    def window(self, call: Callable[[int], None]) -> dict:
        """
        The measured window: ``call(i)`` for i = 0, 1, ... until
        ``self.seconds`` have passed on the host clock, then a
        synchronisation. Events are recorded on the device stream at every
        call boundary and read after the window.

        Returns:
            ``calls``, ``seconds`` (window start to the synchronisation after
            the last call) and ``call_ms`` (the stream time between
            consecutive boundaries, one per call).
        """
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)
        marks = [self.event()]
        t0 = time.perf_counter()
        i = 0
        while True:
            call(i)
            i += 1
            marks.append(self.event())
            if time.perf_counter() - t0 >= self.seconds:
                break
        self.sync()
        secs = time.perf_counter() - t0
        call_ms = [self.elapsed_ms(a, b) for a, b in zip(marks[:-1], marks[1:])]
        self.attempted = i
        return {'calls': i, 'seconds': secs, 'call_ms': call_ms}

    def read_memory(self):
        """The window's peak (``peak_mem_gib``) and the process's peak on the
        card (``memory_peak_bytes``), read before the reference runs."""
        if self.cuda:
            self.e2e['peak_mem_gib'] = \
                self.torch.cuda.max_memory_allocated(self.device) / 2 ** 30
            self.memory_peak_bytes = int(self.torch.cuda.max_memory_reserved(self.device))

    def spanned(self, name: str, fn, *args):
        """``fn(*args)`` between two device events; its time is appended to
        ``spans[name]`` when :meth:`close_spans` reads them."""
        a = self.event()
        out = fn(*args)
        b = self.event()
        self._pending.append((name, a, b))
        return out

    def open_spans(self):
        self._pending = []

    def close_spans(self, per: int = 1):
        """Read the pending span events (after a synchronisation) into
        ``spans``, each as ms per ``per`` calls of the span's unit."""
        self.sync()
        for name, a, b in self._pending:
            self.spans.setdefault(name, []).append(self.elapsed_ms(a, b) / per)
        self._pending = []

    def profile(self, fn):
        """``fn()`` under ``torch.profiler``; see :func:`gpubench.trace.profile`."""
        from gpubench import trace
        self.profiled = trace.profile(fn, self.sync)
        return self.profiled

    # --- correctness --------------------------------------------------------

    def compare(self, name: str, value: float):
        """One number compared against its limit from the cell's file."""
        self.compared[name] = {'value': float(value), 'limit': float(self.limits[name])}

    @property
    def correct(self) -> bool:
        missing = set(self.limits) - set(self.compared)
        return not missing and all(
            math.isfinite(c['value']) and c['value'] <= c['limit']
            for c in self.compared.values())


def device_block(r: Run) -> dict:
    torch = r.torch
    if r.cuda:
        block = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(r.device),
                 'count': int(r.cell['chips']),
                 'memory_peak_bytes': r.memory_peak_bytes}
    else:
        block = {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}
    if r.trace and r.profiled is not None:
        block['busy_s'] = r.profiled.busy_s
        block['window_s'] = r.profiled.window_s
    return block


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, device,
             t_start: float, overrides: Optional[dict] = None,
             patch: Optional[Callable] = None) -> dict:
    """
    Run one cell and return its result (the dict the last line prints). A
    run on the CPU is a rehearsal: the tests use it with small
    ``overrides`` of the traffic; ``patch(driver_module, run)`` may break
    the timed path underneath before the driver starts.
    """
    bench = load_benchmark()
    r = Run(cell_name, seed, seconds, trace, device, t_start, overrides)
    driver = load_module('drivers', r.cell['driver'])
    if patch is not None:
        patch(driver, r)
    driver.run(r)
    found = forbidden_modules()
    if found:
        raise ImportGuardError(found)
    e2e = metrics_for(bench, cell_name, 'end_to_end')
    r.e2e['setup_s'] = r.setup_s
    metrics = {}
    if not trace:
        for m in e2e:
            if m['name'] not in r.e2e:
                if r.cuda:
                    raise KeyError(f'the driver measured no {m["name"]}')
                continue        # a device reading, which a rehearsal has not
            metrics[m['name']] = {'value': r.e2e[m['name']], 'unit': m['unit']}
    else:
        for m in metrics_for(bench, cell_name, 'per_layer'):
            value = load_module('metrics', m['name']).read(r)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result = {'correct': r.correct, 'attempted': r.attempted, 'failed': r.failed,
              'metrics': metrics, 'device': device_block(r)}
    if trace and r.profiled is not None:
        result['breakdown'] = r.profiled.breakdown()
    result['compared'] = r.compared
    return result


class ImportGuardError(RuntimeError):
    def __init__(self, found):
        super().__init__('modules that must not load in a run: ' + ', '.join(found))
        self.found = found
