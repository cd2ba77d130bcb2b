"""The trace's reduction on a hand-made timeline: busy and idle time inside
the traced window, decoder time by kernel name, and idle gaps named by
what the host was doing."""
import pytest

from gpubench import trace


def X(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_summary_of_a_hand_timeline():
    events = [
        X("gpubench.issue", 0, 10, "user_annotation"),
        X("aten::roll", 2, 6, "cpu_op"),
        X("void ldpc::flood_packed_kernel<4, 8, true>(ldpc::Params)", 10, 50,
          "kernel"),
        X("at::native::vectorized_elementwise_kernel<4>", 60, 10, "kernel"),
        X("aten::_local_scalar_dense", 60, 35, "cpu_op"),
        X("gpubench.counters", 95, 5, "user_annotation"),
        X("Memcpy DtoH (Device -> Pageable)", 90, 5, "gpu_memcpy"),
        X("outside the window", 200, 50, "kernel"),
    ]
    s = trace.summarize(events, {"flood_packed_kernel"})
    us = 1e-6
    assert s.window_s == pytest.approx(100 * us)
    assert s.busy_s == pytest.approx(65 * us)
    assert s.decoder_s == pytest.approx(50 * us)
    assert s.other_s == pytest.approx(15 * us)
    gaps = dict(s.idle_gaps)
    assert gaps["aten::roll"] == pytest.approx(10 * us)     # 0-10
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(20 * us)
    assert gaps["gpubench.counters"] == pytest.approx(5 * us)  # 95-100
    assert sum(gaps.values()) + s.busy_s == pytest.approx(s.window_s)
    assert s.device_ops[0][1] == pytest.approx(50 * us)


def test_a_trace_without_the_spans_is_refused():
    with pytest.raises(ValueError):
        trace.summarize([X("k", 0, 1, "kernel")], set())
