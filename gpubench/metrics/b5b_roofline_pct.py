"""B5B's (the grouped soft raster's backward) share (%) of its
roofline: the bound counted from the traced rollout's frames
(``bounds.accum_bound_s`` over each frame's face coefficients, worked out
by the reference from the scene) over the kernel's mean device time per
launch in the profiler's trace. Nothing where the trace has no launch."""
import statistics

KERNELS = ('accum_bwd_kernel',)


def read(run):
    p, bound = run.profiled, run.scenes.get('b5b_bound_s')
    times = p.kernel_us(KERNELS) if p is not None else []
    if not times or bound is None:
        return None
    return 100.0 * bound / (statistics.fmean(times) * 1e-6)
