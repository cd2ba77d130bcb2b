"""The benchmark's yardstick against hand numbers: the roofline counts, the
rate over the window and the percentile over every batch."""
import pytest

from gpubench import registry, roofline, stats
from gpubench.run import Batch, Run


@pytest.mark.parametrize("edges,iters,lanes,ms", [
    (2376, 20, 16384, 0.1394),      # 802.11n n=648 r1/2, K1 at B = 16,384
    (227160, 20, 1024, 0.8332),     # DVB-S2 n=64,800 r1/2, K6b at B = 1,024
])
def test_operation_bound(edges, iters, lanes, ms):
    ops = roofline.decode_ops(edges, iters * lanes)
    assert ops == 12 * edges * iters * lanes
    assert roofline.bound_seconds(ops, 0.0) * 1e3 == pytest.approx(ms,
                                                                   abs=5e-5)


def test_operation_bound_dominates_bytes():
    n, k, lanes = 648, 324, 16384
    nbytes = roofline.decode_bytes(n, k, lanes)
    assert nbytes == n * lanes + k * lanes // 8 + 40
    ops = roofline.decode_ops(2376, 20 * lanes)
    assert roofline.bound_seconds(ops, nbytes) == ops / roofline.PEAK_OPS_PER_S


def test_percentile_hand_values():
    xs = list(range(1, 101))            # 1 .. 100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile([7.0], 95) == 7.0


def _run(latencies_ms, window_s=1.0, k=324, lanes=16384):
    t, batches = 0.0, []
    for i, ms in enumerate(latencies_ms):
        batches.append(Batch(i, t, t + ms / 1e3, [lanes, 0, 0, 0, lanes]))
        t += ms / 1e3 / 4
    return Run(setup_s=3.0, window_s=window_s, batches=batches,
               dispatch_s=[1e-4] * len(batches), n=2 * k, k=k, edges=2376)


def read(name, run):
    return registry.metric_reader(name).read(run)


def test_rate_and_tail_over_a_stall():
    steady = [6.0] * 190
    stall = steady[:100] + [250.0] * 12 + steady[100:]
    base, stalled = _run(steady), _run(stall, window_s=1.0)
    # the rate counts every batch over the window
    assert read("info_Mbps", base) == pytest.approx(190 * 16384 * 324 / 1e6)
    # twelve stalled batches of 202 are 6%: the 95th percentile sees them
    assert read("batch_ms_p95", base) == pytest.approx(6.0)
    assert read("batch_ms_p95", stalled) > 200.0
    assert read("dispatch_ms", base) == pytest.approx(0.1)
    assert read("setup_s", base) == 3.0


def test_rate_is_not_a_median_of_pieces():
    run = _run([6.0] * 100, window_s=2.0)
    assert read("info_Mbps", run) == pytest.approx(
        100 * 16384 * 324 / 2.0 / 1e6)


def test_readers_without_a_trace_read_nothing():
    run = _run([6.0] * 10)
    for name in ("chain_device_ms", "decode_roofline", "device_idle_pct"):
        assert read(name, run) is None
    assert read("info_Mbps", _run([])) is None
