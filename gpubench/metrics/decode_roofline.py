"""The decoder kernels' share of their roofline over the traced stretch:
the least time the card could take to decode the stretch's batches
(`gpubench.roofline`: operations for the iterations the counters report,
bytes of the code's shapes) over the decoder kernels' device time, in %."""
from gpubench import roofline


def read(run):
    t = run.trace
    if t is None or not run.traced or t.decoder_s <= 0:
        return None
    bound = sum(roofline.bound_seconds(
        roofline.decode_ops(run.edges, b.counters[3]),
        roofline.decode_bytes(run.n, run.k, b.counters[0]))
        for b in run.traced)
    return 100.0 * bound / t.decoder_s
