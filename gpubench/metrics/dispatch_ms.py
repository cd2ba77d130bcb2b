"""Host time to issue a batch: the mean, over every batch the window
issued, of the time inside its run_batch call, which enqueues the batch
without waiting for it, in ms."""
from gpubench.stats import mean


def read(run):
    if not run.dispatch_s:
        return None
    return mean(run.dispatch_s) * 1e3
