"""The readers of the program's spans on a hand-made timeline: each of the
five metrics from the spans, the card's busy time and each operation's
launch (matched by `args.correlation`), an operation with no launch left
unattributed, and `trace.summarize` unmoved by the spans."""
import json

import pytest

from gpubench import registry, spans, trace
from gpubench.run import Batch, Run

METRICS = ("draw_ms", "read_wait_ms", "issue_idle_pct", "chain_issue_ms",
           "chain_span_device_ms")


def X(name, ts, dur, cat, corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def frame():
    """The benchmark's own spans and the device work of two batches, as
    `trace.py`'s reduction sees them: window 10-200 us, busy 40-90 and
    150-190."""
    return [
        X("gpubench.issue", 10, 40, "user_annotation"),
        X("cudaLaunchKernel", 20, 2, "cuda_runtime", 1),
        X("cudaLaunchKernel", 30, 2, "cuda_runtime", 2),
        X("cuLaunchKernel", 45, 2, "cuda_driver", 3),
        X("at::native::vectorized_elementwise_kernel<4>", 40, 10, "kernel",
          1),
        X("at::native::roll_cuda_kernel", 50, 10, "kernel", 2),
        X("void ldpc::stream_pipelined_kernel<8, false>", 60, 30, "kernel",
          3),
        X("gpubench.issue", 110, 30, "user_annotation"),
        X("cudaLaunchKernel", 120, 2, "cuda_runtime", 4),
        X("at::native::vectorized_elementwise_kernel<4>", 150, 20, "kernel",
          4),
        X("cudaMemcpyAsync", 175, 20, "cuda_runtime", 5),
        X("Memcpy DtoH (Device -> Pageable)", 180, 10, "gpu_memcpy", 5),
        X("gpubench.counters", 195, 5, "user_annotation"),
        # launched before the trace began: no launch to match
        X("void ldpc::stream_pipelined_kernel<8, false>", 170, 10, "kernel",
          99),
    ]


def program():
    """The program's spans of the same two batches."""
    return [
        X("ldpc.sweep.issue", 0, 50, "user_annotation"),
        X("ldpc.sweep.draw", 0, 8, "user_annotation"),
        X("ldpc.step.chain", 12, 22, "user_annotation"),
        X("ldpc.sweep.issue", 100, 40, "user_annotation"),
        X("ldpc.sweep.draw", 100, 4, "user_annotation"),
        X("ldpc.step.chain", 112, 18, "user_annotation"),
        X("ldpc.sweep.read", 60, 30, "user_annotation"),
        X("ldpc.sweep.read", 170, 25, "user_annotation"),
    ]


def expected():
    return {
        "draw_ms": 6e-3,                 # (8 + 4) / 2 us
        "read_wait_ms": 27.5e-3,         # (30 + 25) / 2
        # inside an issue and idle: 10-40 and 100-140 of the 190 us window
        # (0-10 is before it)
        "issue_idle_pct": 100.0 * 70 / 190,
        # launches 1, 2 (chain 12-34) and 4 (chain 112-130): 10 + 10 + 20
        "chain_issue_ms": 20e-3,
        "chain_span_device_ms": 20e-3,
    }


def test_the_timeline_reads_each_metric():
    tl = spans.Timeline.of(frame() + program())
    want = expected()
    assert tl.mean_ms(spans.DRAW) == pytest.approx(want["draw_ms"])
    assert tl.mean_ms(spans.READ) == pytest.approx(want["read_wait_ms"])
    assert tl.issue_idle_pct() == pytest.approx(want["issue_idle_pct"])
    assert tl.mean_ms(spans.CHAIN) == pytest.approx(want["chain_issue_ms"])
    assert tl.chain_device_ms() == pytest.approx(
        want["chain_span_device_ms"])
    assert [a for a, _ in tl.spans[spans.ISSUE]] == [0, 100]
    # 10 us of the 90 us of device time has no launch in the trace
    assert tl.unattributed_share() == pytest.approx(10 / 90)


def test_an_operation_without_its_launch_is_unattributed():
    events = frame() + program()
    for e in events:                 # the chain's kernels lose their launch
        if e["cat"] == "cuda_runtime" and e["args"]["correlation"] in (1, 2):
            e["args"]["correlation"] += 1000
    tl = spans.Timeline.of(events)
    assert tl.chain_device_ms() == pytest.approx(10e-3)    # launch 4 alone
    assert tl.unattributed_share() == pytest.approx(30 / 90)


def test_a_trace_without_the_programs_spans_reads_none():
    assert spans.Timeline.of(frame()) is None


def test_a_trace_without_device_work_reads_no_device_metric():
    host = [e for e in frame() + program()
            if e["cat"] not in trace.DEVICE_CATS]
    tl = spans.Timeline.of(host)
    assert tl.issue_idle_pct() is None and tl.chain_device_ms() is None
    assert tl.unattributed_share() is None
    assert tl.mean_ms(spans.DRAW) == pytest.approx(expected()["draw_ms"])


def run_of(traced=True):
    batches = [Batch(i, 0.0, 1.0, [16, 0, 0, 8, 16]) for i in range(2)]
    return Run(setup_s=1.0, window_s=2.0, batches=batches,
               dispatch_s=[0.001] * 2, n=64, k=32, edges=192,
               traced=batches if traced else [],
               trace=trace.summarize(frame(), set()) if traced else None)


def test_the_readers_find_this_process_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "OUT", tmp_path)
    run = run_of()
    for name in METRICS:                          # no trace file yet
        assert registry.metric_reader(name).read(run) is None
    (tmp_path / "trace-x.json").write_text(
        json.dumps({"traceEvents": frame() + program()}))
    want = expected()
    for name in METRICS:
        got = registry.metric_reader(name).read(run)
        assert got == pytest.approx(want[name]), name
        assert registry.metric_reader(name + ".host_paced").read(run) == got
        # an untraced run reads nothing, whatever lies in out/
        assert registry.metric_reader(name).read(run_of(False)) is None
    # a trace without the program's spans (the program before them)
    (tmp_path / "trace-y.json").write_text(
        json.dumps({"traceEvents": frame()}))
    for name in METRICS:
        assert registry.metric_reader(name).read(run) is None


def test_a_trace_written_before_the_process_is_not_read(tmp_path,
                                                        monkeypatch):
    import os
    monkeypatch.setattr(spans, "OUT", tmp_path)
    path = tmp_path / "trace-x.json"
    path.write_text(json.dumps({"traceEvents": frame() + program()}))
    old = spans.process_start() - 60
    os.utime(path, (old, old))
    assert registry.metric_reader("draw_ms").read(run_of()) is None


def test_the_programs_spans_leave_the_summary_as_it_was():
    names = {"stream_pipelined_kernel"}
    a = trace.summarize(frame(), names)
    b = trace.summarize(frame() + program(), names)
    for field in ("window_s", "busy_s", "decoder_s", "other_s"):
        assert getattr(b, field) == getattr(a, field), field
    assert b.device_ops == a.device_ops
    assert sum(s for _, s in b.idle_gaps) == pytest.approx(
        sum(s for _, s in a.idle_gaps))


def test_the_span_names_are_the_programs():
    from ldpc_tpu_torch.utils import profiling
    assert spans.NAMES == profiling.SPANS
    assert (spans.ISSUE, spans.DRAW, spans.READ, spans.CHAIN) == (
        profiling.SPAN_ISSUE, profiling.SPAN_DRAW, profiling.SPAN_READ,
        profiling.SPAN_CHAIN)


def test_each_span_metric_is_reported_where_it_reads():
    bench = registry.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    plain = {"draw_ms": ["wifi648-mc", "dvbs2-64800-allzeros"],
             "chain_issue_ms": ["dvbs2-64800-allzeros"]}
    plain["read_wait_ms"] = plain["issue_idle_pct"] = plain["draw_ms"]
    plain["chain_span_device_ms"] = plain["chain_issue_ms"]
    for name in METRICS:
        assert entries[name]["workloads"] == plain[name]
        assert entries[name]["moves"] == "info_Mbps"
        twin = entries[name + ".host_paced"]
        assert twin["workloads"] == ["dvbs2-64800-host", "wifi648-host"]
        assert twin["moves"] == "info_Mbps.host_paced"
        assert twin["layer"] == entries[name]["layer"]
