"""Device time (ms) of one step's primitives or frame mesh and render (generate_prims or generate, then the renderer), between events recorded around the call by
the rollout driver's traced steps; the mean over those steps."""
import statistics

SPAN = 'render'


def read(run):
    times = run.spans.get(SPAN)
    return statistics.fmean(times) if times else None
