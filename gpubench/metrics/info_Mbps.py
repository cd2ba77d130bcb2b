"""Decoded information bits a second: the information bits of every batch
of the window (frames times k), over the window's seconds, from the start
of its `Sweep.run` to its return, in Mbit/s."""
from gpubench.stats import rate


def read(run):
    if not run.batches:
        return None
    frames = sum(b.counters[0] for b in run.batches)
    return rate(frames * run.k, run.window_s) / 1e6
