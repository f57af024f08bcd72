"""Stream time (ms) between the CUDA events of the program's
``render.operands`` span, the render's operands
(``Renderer.hard_frame_operands``: background, screen faces, the raster's
operands), per step of the window's function, summed over its records and
averaged over the traced steps of :mod:`gpubench.program`'s run (a). Nothing
where the program has no such span."""
from gpubench import program


def read(run):
    return program.span_ms(run, 'render.operands')
