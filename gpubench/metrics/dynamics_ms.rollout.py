"""Device time (ms) of one step's dynamics (simulator.functional_step), between events recorded around the call by
the rollout driver's traced steps; the mean over those steps."""
import statistics

SPAN = 'dynamics'


def read(run):
    times = run.spans.get(SPAN)
    return statistics.fmean(times) if times else None
