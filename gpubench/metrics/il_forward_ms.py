"""Device time (ms) of the IL loss (make_il_loss_fn: the 40-step rollout through render, policy and dynamics) of one gradient rollout, between events recorded around the call by
the IL driver's traced rollouts; the mean over those rollouts."""
import statistics

SPAN = 'il_forward'


def read(run):
    times = run.spans.get(SPAN)
    return statistics.fmean(times) if times else None
