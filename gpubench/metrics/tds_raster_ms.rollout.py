"""Stream time (ms) between the CUDA events of the program's ``render.raster``
span, the render's kernel call (``ops.hard.raster``: B6b), per step of the
window's function, summed over its records and averaged over the traced steps
of :mod:`gpubench.program`'s run (a). Nothing where the program has no such
span."""
from gpubench import program


def read(run):
    return program.span_ms(run, 'render.raster')
