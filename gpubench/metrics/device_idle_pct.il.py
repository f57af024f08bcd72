"""The device's idle share (%) of the traced window: 100 minus the union
of the profiler's device operation intervals (overlap counted once) over
the window's length. Nothing where the profiler traced no device operation."""


def read(run):
    p = run.profiled
    if p is None or not p.device_ops or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
