"""B6b's share (%) of its roofline: the bound counted from each traced
frame's scene (``bounds.hard_bound_s``: the road mesh, boxes, direction
triangles and stoplines in screen space) over the kernel's mean device time
per launch in the profiler's trace. Nothing where the trace has no launch."""
import statistics

KERNELS = ('hard_raster_kernel<false>',)


def read(run):
    p, bound = run.profiled, run.scenes.get('render_kernel_bound_s')
    times = p.kernel_us(KERNELS) if p is not None else []
    if not times or bound is None:
        return None
    return 100.0 * bound / (statistics.fmean(times) * 1e-6)
