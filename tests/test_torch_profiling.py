"""`ldpc_tpu_torch/utils/profiling.py` on the CPU: the timer, the trace and
the parser of ptxas' build report (the CUDA-event path runs on the card, in
`chip_smoke.py` and the probes)."""
import json
import os
import time

import pytest
import torch

from ldpc_tpu_torch.utils import profiling

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3fooILb0EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN3fooILb0EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 16 bytes smem
ptxas info    : Compile time = 85.027 ms
ptxas info    : Compiling entry function '_ZN3fooILb1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN3fooILb1EEEvNS_6ParamsE
    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z3barPKaPa' for 'sm_90a'
ptxas info    : Function properties for _Z3barPKaPa
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, used 0 barriers
"""


def test_timed_on_the_cpu_is_the_median_of_the_calls():
    calls = []

    def fn(x, delay):
        calls.append(delay)
        time.sleep(delay)
        return x + 1

    t = profiling.timed(fn, torch.zeros(3), 0.02, reps=3, warmup=2)
    assert len(calls) == 5
    assert 0.015 < t < 0.2
    calls.clear()
    assert profiling.timed(lambda: None, reps=2, warmup=0) < 0.01
    with pytest.raises(RuntimeError):      # asked for the card: no fallback
        profiling.timed(lambda: None, reps=1, device="cuda")


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "traces")
    for _ in range(2):
        with profiling.trace(logdir) as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
        assert prof is not None
    files = sorted(os.listdir(logdir))
    assert files == ["trace-0.json", "trace-1.json"]
    with open(os.path.join(logdir, files[0])) as f:
        assert "traceEvents" in json.load(f)


def test_compiled_cost_parses_a_ptxas_report():
    parsed = profiling.parse_ptxas(PTXAS_LOG)
    assert list(parsed) == ["_ZN3fooILb0EEEvNS_6ParamsE",
                            "_ZN3fooILb1EEEvNS_6ParamsE", "_Z3barPKaPa"]
    assert parsed["_ZN3fooILb0EEEvNS_6ParamsE"] == {
        "registers": 32, "stack_bytes": 0, "spill_stores": 0,
        "spill_loads": 0, "smem_bytes": 16}
    assert parsed["_ZN3fooILb1EEEvNS_6ParamsE"] == {
        "registers": 48, "stack_bytes": 24, "spill_stores": 8,
        "spill_loads": 12, "smem_bytes": 0}
    cost = profiling.compiled_cost(PTXAS_LOG, kernel="foo")
    assert sorted(cost["kernels"]) == ["_ZN3fooILb0EEEvNS_6ParamsE",
                                       "_ZN3fooILb1EEEvNS_6ParamsE"]
    assert cost["max_registers"] == 48 and cost["spills"] == 20
    assert "bound_ms" not in cost
    cost = profiling.compiled_cost(PTXAS_LOG, kernel="bar", nbytes=3.35e9,
                                   ops=67e6)
    assert cost["max_registers"] == 12 and cost["spills"] == 0
    assert cost["bound_by"] == "bytes"
    assert cost["bound_ms"] == pytest.approx(1.0)
    assert profiling.compiled_cost("")["kernels"] == {}


def test_bound_is_the_larger_of_bytes_and_operations():
    assert profiling.bound(3.35e12, 0) == (pytest.approx(1e3), "bytes")
    ms, by = profiling.bound(1, 67e12)
    assert by == "operations" and ms == pytest.approx(1e3)
    a, b = torch.zeros(10, dtype=torch.int8), torch.zeros(4, 2)
    assert profiling.tensor_bytes(a, (b, 3), {"k": a}, None) == 10 + 32 + 10
