"""Timing, tracing and cost helpers (counterpart of
`ldpc_tpu/utils/profiling.py`: `trace`, `timed`, `compiled_cost`).

  * `timed(fn, *args)`: median seconds a call, by CUDA events on a CUDA
    device and by `time.perf_counter` on the CPU; `event_ms` is the list of
    per-call event times it takes the median of, for callers that print
    the spread, and `in_turns_ms` takes it of several callables in turns.
    Events recorded around a call hold the host's dispatch of it as well
    when the stream was idle;
  * `device_timed(fn, *args)`, `device_ms`: the same on the card alone,
    the dispatch hidden behind a spin kernel; they raise off the card;
  * `trace(logdir)`: a `torch.profiler` context that writes a Chrome trace
    into `logdir`;
  * `span(name)`: one of the program's spans (below), recorded while a
    `torch.profiler` session records;
  * `compiled_cost(...)`: what the port can know of a hand-written kernel
    without a profiler: registers, spills and shared memory as ptxas
    reported them when the library was built, and the least time the card
    could take for a call (`bound`).

The reference synchronises by host fetch and takes the best of several
trials against a bursty tunnelled platform; neither is needed where CUDA
events read the card's own clock, so neither is ported.

The program's spans mark the sweep loop's and the step's layer boundaries
with `record_function`, so they land in the Kineto trace beside the card's
CUPTI events, on one clock:

  * `ldpc.sweep.issue` (`Sweep.run`): one batch's issue, its draw and the
    step call that enqueues it;
  * `ldpc.sweep.draw`, inside it: `Sweep.draw`, the batch seed and, for
    the host chains, the batch's `torch.Generator`;
  * `ldpc.sweep.read` (`Sweep.run`): the `.tolist()` that waits for a
    batch's counters;
  * `ldpc.step.chain` (`sim/pipeline.make_lane_step`): the host chain up to
    the decoder's call (the transposed chain's draws, encoder, modulation,
    noise and demap; the batch-first `chain`, up to the quantized LLRs).
    The megakernel's step is one launch and has none.

Spans of one batch are tied by order and nesting, not by name: the i-th
issue of a `Sweep.run` is batch i, its draw and chain nest inside it, and
the i-th read is batch i's. Any `torch.profiler` session records them
(`trace`, the benchmark's traced stretch, a caller's own); nothing else
turns them on. Off, a span is one check of
`torch.autograd.profiler._is_profiler_enabled` and one shared no-op
context: 0.27-0.63 us on the host of an NVIDIA H100 machine (torch 2.11),
against 11-13 us for a `record_function` that records nothing and 15.5 us
for one that records.
"""
from __future__ import annotations

import contextlib
import os
import re
import statistics
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.autograd import profiler as autograd_profiler

from ..device import resolve_device

# NVIDIA H100 SXM data sheet: device-memory rate, and the float32 rate
# outside the tensor cores that bounds integer work from above (the int32
# units have half the float32 lanes).
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12

SPAN_ISSUE = "ldpc.sweep.issue"
SPAN_DRAW = "ldpc.sweep.draw"
SPAN_READ = "ldpc.sweep.read"
SPAN_CHAIN = "ldpc.step.chain"
SPANS = (SPAN_ISSUE, SPAN_DRAW, SPAN_READ, SPAN_CHAIN)
_OFF = contextlib.nullcontext()


def span(name: str):
    """The span `name` in the `torch.profiler` session that is recording,
    or the shared no-op context when none is."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return autograd_profiler.record_function(name)


def event_ms(fn: Callable[[], Any], reps: int) -> List[float]:
    """Milliseconds of each of `reps` calls of fn() on the current CUDA
    stream, by a pair of CUDA events around every call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_device(device=None) -> torch.device:
    """The CUDA device asked for (the current one when None), for what runs
    on the card only: any other device raises ValueError, and a missing
    card RuntimeError (`resolve_device`)."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"this runs on a CUDA device only, not on {dev}")
    return dev


def device_ms(fn: Callable[[], Any], reps: int, device=None,
              spin_ms: float = 0.5) -> List[float]:
    """Milliseconds of fn() as the device runs it, without the host's
    dispatch, for each of `reps` calls: a spin kernel (`torch.cuda._sleep`)
    of about spin_ms is enqueued ahead of the start event, and the host
    records the start event, calls fn() and records the end event while it
    spins, so the events bracket only the work fn() enqueued (the launch
    latency on the device included). fn() is called exactly `reps` times; a
    call whose dispatch outlasted the spin is left out of the times and
    doubles the spin for the calls after it (raises if no call is left).
    fn() enqueues its work on the current stream of `device` (the current
    CUDA device when None); any other device raises, and nothing falls
    back to the CPU."""
    dev = cuda_device(device)
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # the spin's cycles a millisecond, from one timed spin
        torch.cuda._sleep(1 << 16)
        start.record()
        torch.cuda._sleep(1 << 20)
        end.record()
        end.synchronize()
        cycles = max(1, int(spin_ms * (1 << 20) / start.elapsed_time(end)))
        times: List[float] = []
        host_ms = 0.0
        for _ in range(reps):
            t0 = time.perf_counter()
            torch.cuda._sleep(cycles)
            start.record()
            fn()
            end.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            end.synchronize()
            if host_ms < spin_ms:
                times.append(start.elapsed_time(end))
            else:
                spin_ms, cycles = 2 * spin_ms, 2 * cycles
    if not times:
        raise RuntimeError(f"the host's dispatch outlasted every spin (the "
                           f"last call's {host_ms:.1f} ms)")
    return times


def device_timed(fn: Callable, *args, reps: int = 10, warmup: int = 1,
                 device=None) -> float:
    """Median seconds of fn(*args) on the device alone (`device_ms`) over
    `reps` calls after `warmup` calls; a device that is not CUDA raises."""
    dev = cuda_device(device)
    with torch.cuda.device(dev):
        for _ in range(max(warmup, 0)):
            fn(*args)
        torch.cuda.synchronize()
        return statistics.median(
            device_ms(lambda: fn(*args), reps, device=dev)) / 1e3


def in_turns_ms(fns: Dict[str, Callable[[], Any]], reps: int,
                warmup: int = 3) -> Dict[str, List[float]]:
    """Milliseconds of `reps` calls of each fn a turn (`event_ms`), the
    callables in turns a, b, ..., ..., b, a after `warmup` calls each, so
    that a drift of the card's clock weighs on all of them alike."""
    names = list(fns)
    for name in names:
        for _ in range(warmup):
            fns[name]()
    torch.cuda.synchronize()
    times: Dict[str, List[float]] = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name] += event_ms(fns[name], reps)
    return times


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _tensors(item)
    elif isinstance(tree, dict):
        yield from _tensors(list(tree.values()))


def timed(fn: Callable, *args, reps: int = 10, warmup: int = 1,
          device: Optional[torch.device] = None) -> float:
    """Median seconds of fn(*args) over `reps` calls after `warmup` calls.

    On a CUDA device each call is bracketed by CUDA events; on the CPU by
    `time.perf_counter`. The device is `device`, else that of the first
    tensor among the arguments or the warm-up's outputs, else the CPU; a
    CUDA device that does not exist raises."""
    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args)
    if device is None:
        found = next(_tensors([list(args), out]), None)
        device = found.device if found is not None else torch.device("cpu")
    device = resolve_device(device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            return statistics.median(event_ms(lambda: fn(*args), reps)) / 1e3
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the context with `torch.profiler` (CPU
    activity, and CUDA activity where a device exists) and write a Chrome
    trace `trace-<n>.json` into `logdir` (open it in Perfetto or
    chrome://tracing). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        n = len([f for f in os.listdir(logdir) if f.startswith("trace-")])
        prof.export_chrome_trace(os.path.join(logdir, f"trace-{n}.json"))


def tensor_bytes(*trees) -> int:
    """Bytes of every tensor in the arguments (tuples, lists and dict
    values are walked; anything else counts 0)."""
    return sum(t.numel() * t.element_size() for t in _tensors(list(trees)))


def bound(nbytes: float, ops: float) -> Tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for a call
    that must move `nbytes` (every input read once, every output written
    once) and do `ops` integer operations: the larger of bytes over the
    memory rate and operations over the CUDA cores' rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """ptxas' `-v` report by entry function (mangled name): registers,
    stack_bytes, spill_stores, spill_loads and smem_bytes (static shared
    memory; dynamic shared memory is chosen at the launch)."""
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {
                "registers": 0, "stack_bytes": 0, "spill_stores": 0,
                "spill_loads": 0, "smem_bytes": 0})
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = (
                int(g) for g in m.groups())
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def compiled_cost(ptxas_log: str, kernel: Optional[str] = None,
                  nbytes: Optional[float] = None,
                  ops: Optional[float] = None) -> Dict[str, Any]:
    """What is known of a built kernel library before it runs.

    ptxas_log: the library's build report (`kernels.build.Library.
    ptxas_log`). kernel: a substring of the entry functions' mangled names
    to keep (all of them when None). With nbytes and ops, the call's
    `bound_ms` and `bound_by` (`bound`) are added. Returns {"kernels":
    {name: {registers, stack_bytes, spill_stores, spill_loads,
    smem_bytes}}, "max_registers", "spills", ["bound_ms", "bound_by"]}."""
    kernels = {name: rec for name, rec in parse_ptxas(ptxas_log).items()
               if kernel is None or kernel in name}
    cost: Dict[str, Any] = {
        "kernels": kernels,
        "max_registers": max((k["registers"] for k in kernels.values()),
                             default=0),
        "spills": sum(k["spill_stores"] + k["spill_loads"]
                      for k in kernels.values()),
    }
    if nbytes is not None and ops is not None:
        cost["bound_ms"], cost["bound_by"] = bound(nbytes, ops)
    return cost
