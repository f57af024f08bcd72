"""Device time (ms) of torch.autograd.grad of the IL loss with respect to the policy's parameters, per gradient rollout, between events recorded around the call by
the IL driver's traced rollouts; the mean over those rollouts."""
import statistics

SPAN = 'il_backward'


def read(run):
    times = run.spans.get(SPAN)
    return statistics.fmean(times) if times else None
