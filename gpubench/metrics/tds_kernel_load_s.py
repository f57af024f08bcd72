"""Seconds the program spent building and loading its kernel libraries
(the ``kernel.load_s`` counter of ``torchdrivesim_tpu_torch.tracing``),
read after the run: every kernel loads in the warm-up, so this is its value
at the end of set-up (0 where none loaded, as on the CPU). Nothing where the
program has no such counter."""
from gpubench import program


def read(run):
    p = program.measure(run)
    return None if p is None else float(p['counts'].get('kernel.load_s', 0.0))
