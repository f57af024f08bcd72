"""Host time (ms) of the program's ``step`` span, the whole step, per step of
the window's function, summed over its records and averaged over the traced
steps of :mod:`gpubench.program`'s run (a). Nothing where the program has no
such span."""
from gpubench import program


def read(run):
    return program.span_ms(run, 'step', device=False)
