"""The 95th percentile, over every batch of the window, of the host time
from the batch's run_batch call to its counters on the host, in ms."""
from gpubench.stats import percentile


def read(run):
    if not run.batches:
        return None
    return percentile([(b.done - b.issued) * 1e3 for b in run.batches], 95)
