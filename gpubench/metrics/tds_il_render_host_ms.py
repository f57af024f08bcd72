"""Host time (ms) of the program's ``render`` span,
``Renderer.render_rgb_mesh_chw`` (operands and the soft raster's forward), per
gradient rollout of the window's function, summed over its records and averaged
over the traced gradient rollouts of :mod:`gpubench.program`'s run (a). Nothing
where the program has no such span."""
from gpubench import program


def read(run):
    return program.span_ms(run, 'render', device=False)
