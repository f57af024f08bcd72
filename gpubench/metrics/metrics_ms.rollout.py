"""Device time (ms) of one step's collision, offroad, wrong-way and red-light calls, between events recorded around the call by
the rollout driver's traced steps; the mean over those steps."""
import statistics

SPAN = 'metrics'


def read(run):
    times = run.spans.get(SPAN)
    return statistics.fmean(times) if times else None
