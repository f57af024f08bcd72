"""Stream time (ms) between the CUDA events of the program's
``render.backward`` span, the render's backward (``SoftAccum.backward``: B5b,
its zero fill and tile sum; the other render Functions' where they run), per
gradient rollout of the window's function, summed over its records and averaged
over the traced gradient rollouts of :mod:`gpubench.program`'s run (a). Nothing
where the program has no such span."""
from gpubench import program


def read(run):
    return program.span_ms(run, 'render.backward')
