"""Device time a batch of every device operation of the traced stretch that
is not a decoder kernel (the channel chain: draws, encoder, modulation,
noise, demap, quantizer, the counters' sums and copy), in ms."""


def read(run):
    t = run.trace
    if t is None or not run.traced or t.busy_s <= 0:
        return None
    return t.other_s / len(run.traced) * 1e3
