"""Stream time (ms) between the CUDA events of the program's ``metrics`` span,
the step's metrics block (collision, offroad, wrong way, red lights), per step
of the window's function, summed over its records and averaged over the traced
steps of :mod:`gpubench.program`'s run (a). Nothing where the program has no
such span."""
from gpubench import program


def read(run):
    return program.span_ms(run, 'metrics')
