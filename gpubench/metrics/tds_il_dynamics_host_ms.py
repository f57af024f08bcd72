"""Host time (ms) of the program's ``dynamics`` span,
``Simulator.functional_step``, per gradient rollout of the window's function,
summed over its records and averaged over the traced gradient rollouts of
:mod:`gpubench.program`'s run (a). Nothing where the program has no such
span."""
from gpubench import program


def read(run):
    return program.span_ms(run, 'dynamics', device=False)
