"""
The reduction of a ``torch.profiler`` trace to what the per-layer metrics
and the result's ``device`` and ``breakdown`` read: the device operations
with their intervals, the union of those intervals (busy time, overlap
counted once), the operations that took the most device time and the
longest idle gaps by what the host was doing.
"""
import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Profile:
    #: (name, start us, end us) of every device operation, by start
    device_ops: List[Tuple[str, float, float]]
    #: (name, start us, end us) of the host's operations
    host_ops: List[Tuple[str, float, float]]
    window_s: float
    t0_us: float = 0.0
    t1_us: float = 0.0
    busy_s: float = field(init=False)

    def __post_init__(self):
        self.busy_s = union_us(self.device_ops) / 1e6

    def kernel_us(self, names) -> List[float]:
        """Device times (us) of the launches whose name contains one of
        ``names``."""
        return [e - s for n, s, e in self.device_ops if any(k in n for k in names)]

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        totals: Dict[str, float] = {}
        for n, s, e in self.device_ops:
            totals[n] = totals.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        gaps: Dict[str, float] = {}
        host = sorted(self.host_ops, key=lambda x: x[1])
        starts = [s for _, s, _ in host]
        for start, end in idle_gaps(self.device_ops, self.t0_us, self.t1_us):
            label = host_label(host, starts, (start + end) / 2)
            gaps[label] = gaps.get(label, 0.0) + (end - start) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {'device_ops': [[n[:120], s] for n, s in ops],
                'idle_gaps': [[n[:120], s] for n, s in idle]}


def merged(intervals):
    """Intervals (name, start, end) merged into disjoint (start, end)."""
    out = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(intervals) -> float:
    """Length of the union of the intervals: overlapping operations (two
    streams, a copy beside a kernel) count once."""
    return sum(e - s for s, e in merged(intervals))


def idle_gaps(intervals, t0: float, t1: float):
    """The gaps in [t0, t1] that no device operation covers."""
    gaps, cursor = [], t0
    for s, e in merged(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, t1)))
        cursor = max(cursor, e)
    if t1 > cursor:
        gaps.append((cursor, t1))
    return [(s, e) for s, e in gaps if e > s]


def host_label(host_ops, starts, t: float) -> str:
    """The innermost host operation running at ``t`` (``host_ops`` sorted
    by start, ``starts`` their starts), under the labelled benchmark span
    around it ('idle host' where none runs)."""
    i = bisect.bisect_right(starts, t) - 1
    inner, outer = None, None
    for j in range(i, max(i - 2000, -1), -1):
        n, s, e = host_ops[j]
        if e >= t:
            if n.startswith('gpubench.'):
                outer = outer or n
            elif inner is None:
                inner = n
        if inner and outer:
            break
    parts = [p for p in (outer, inner) if p]
    return ' / '.join(parts) if parts else 'idle host'


def profile(fn, sync) -> Profile:
    """``fn()`` under ``torch.profiler`` (host and CUDA activity), followed
    by a synchronisation; the device operations and the host operations
    that overlap the traced window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    import torch
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with torch_profile(activities=activities) as prof:
        with torch.profiler.record_function('gpubench.window_start'):
            pass
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
        with torch.profiler.record_function('gpubench.window_end'):
            pass
    device, host = [], []
    marks = {}
    for ev in prof.events():
        rng = (ev.time_range.start, ev.time_range.end)
        if ev.name in ('gpubench.window_start', 'gpubench.window_end'):
            marks[ev.name] = rng
            continue
        if ev.device_type == DeviceType.CUDA:
            # the benchmark's own labels show on the device timeline too
            if not ev.name.startswith('gpubench.'):
                device.append((ev.name, *rng))
        else:
            host.append((ev.name, *rng))
    t0_us = marks.get('gpubench.window_start', (0, 0))[1]
    t1_us = marks.get('gpubench.window_end', (0, 0))[0]
    if device and t1_us <= t0_us:
        t0_us = min(s for _, s, _ in device)
        t1_us = max(e for _, _, e in device)
    device.sort(key=lambda x: x[1])
    return Profile(device_ops=device, host_ops=host, window_s=window_s,
                   t0_us=t0_us, t1_us=t1_us)
