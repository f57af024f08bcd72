"""The device's idle time (ms) per step inside the host's ``tds.render``
ranges, their children's included: the union of those ranges less the
union of the device's operations, from :mod:`gpubench.program`'s run (b)
under the profiler, per traced step. Nothing where the program has no such
span."""
from gpubench import program


def read(run):
    p = program.measure(run)
    return None if p is None else p['render_idle_ms']
