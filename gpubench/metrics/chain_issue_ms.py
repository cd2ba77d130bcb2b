"""Host time a batch in the step's host chain up to the decoder's call (the
program's span `ldpc.step.chain`), the mean over the traced stretch's
batches, in ms."""
from gpubench import spans


def read(run):
    tl = spans.timeline(run)
    return None if tl is None else tl.mean_ms(spans.CHAIN)
