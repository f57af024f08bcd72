"""Stream time (ms) between the CUDA events of the program's ``scene`` span,
``BirdviewRGBMeshGenerator.generate``: the frame's mesh, map included, per step
of the window's function, summed over its records and averaged over the traced
steps of :mod:`gpubench.program`'s run (a). Nothing where the program has no
such span."""
from gpubench import program


def read(run):
    return program.span_ms(run, 'scene')
