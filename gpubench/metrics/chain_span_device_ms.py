"""Device time a batch of the kernels, copies and sets whose launch (the
runtime or driver call with the same `args.correlation`) falls inside the
program's span `ldpc.step.chain`, in ms; an operation whose launch is not
in the trace counts for no span."""
from gpubench import spans


def read(run):
    tl = spans.timeline(run)
    return None if tl is None else tl.chain_device_ms()
