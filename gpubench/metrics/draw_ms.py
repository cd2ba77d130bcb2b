"""Host time a batch in `Sweep.draw` (the program's span `ldpc.sweep.draw`:
the batch seed and, for the host chains, the batch's torch.Generator), the
mean over the traced stretch's batches, in ms."""
from gpubench import spans


def read(run):
    tl = spans.timeline(run)
    return None if tl is None else tl.mean_ms(spans.DRAW)
