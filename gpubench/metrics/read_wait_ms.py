"""Host time a batch in the read that waits for its counters (the program's
span `ldpc.sweep.read`, `Sweep.run`'s `.tolist()`), the mean over the traced
stretch's batches, in ms."""
from gpubench import spans


def read(run):
    tl = spans.timeline(run)
    return None if tl is None else tl.mean_ms(spans.READ)
