"""
Spans and counters of the port.

A span (:func:`span`) marks one layer of a call: the step, the dynamics,
the scene's mesh, the render and its parts, the metrics, the policy, the
render's backward. Spans are off until :func:`enable` turns them on. Off,
:func:`span` hands back one shared object that does nothing. On, each span
records its name, its parent (the innermost span open on the same thread:
autograd runs a CUDA backward on a thread of its own, so a backward span has
no forward parent), its host start and end, and, while CUDA is in use, a
pair of CUDA events on the current stream, read only by :func:`collect`.
It also opens ``torch.profiler.record_function('tds.<name>')``, so that a
profiler's trace holds every span on its own clock beside the device's
operations.

Counters (:func:`count`, :func:`counts`) are always on: ``launch.<kernel>``
for each launch of a hand-written kernel (B1 ... B8, B3-VJP, HF),
``render.sort_route`` for each frame whose primitives took the fused
render's sort route, and ``kernel.build``, ``kernel.load`` and
``kernel.load_s`` for the kernel libraries built, loaded and the seconds
that took.
"""
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

#: the prefix of a span's name in a profiler's trace
PREFIX = 'tds.'

_enabled = False
_local = threading.local()
_ids = itertools.count()
#: closed spans with their events, until :func:`collect`
_closed: list = []
#: free timing events by device index
_pool: Dict[int, list] = {}
_counts: Dict[str, float] = {}


@dataclass
class Span:
    """One closed span, as :func:`collect` returns it."""
    id: int
    name: str
    #: the id of the span that enclosed it on its thread, or None
    parent: Optional[int]
    start_ns: int
    end_ns: int
    #: stream time between its events; None without CUDA, or where the span
    #: enclosed a switch between devices
    device_ms: Optional[float] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event(device: int):
    free = _pool.setdefault(device, [])
    event = free.pop() if free else torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class _Open:
    __slots__ = ('name', 'id', 'parent', 'start_ns', 'device', 'events', 'profiled')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.profiled = torch.profiler.record_function(PREFIX + self.name)
        self.profiled.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.device = torch.cuda.current_device()
            self.events = (_event(self.device),)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events += (_event(self.device),)
        _stack().pop()
        self.profiled.__exit__(*exc)
        _closed.append((Span(self.id, self.name, self.parent, self.start_ns, end_ns),
                        self.device if self.events else None, self.events))
        return False


def enable(on: bool = True) -> None:
    """Turn spans on or off (off at import)."""
    global _enabled
    _enabled = bool(on)


def span(name: str):
    """A context manager that marks ``name`` as a layer of the call inside
    it while spans are on, and does nothing otherwise."""
    if not _enabled:
        return _NULL
    return _Open(name)


def host_only() -> None:
    """The spans open on this thread enclose a switch between devices: they
    record host time only (their events are given back unread)."""
    for frame in _stack():
        if frame.events is not None:
            _pool[frame.device].extend(frame.events)
            frame.events = None


def collect() -> List[Span]:
    """The spans closed since the last call, in the order they opened, each
    with its stream time read after a wait for its end event; the store is
    emptied."""
    global _closed
    taken, _closed = _closed, []
    out = []
    for record, device, events in taken:
        if events:
            start, end = events
            end.synchronize()
            record.device_ms = start.elapsed_time(end)
            _pool[device].extend(events)
        out.append(record)
    return sorted(out, key=lambda s: s.start_ns)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counts() -> Dict[str, float]:
    """A copy of every counter."""
    return dict(_counts)
