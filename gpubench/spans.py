"""The program's own spans in the traced stretch, for the per-layer metrics
that read them.

While a `torch.profiler` session records, the program marks its sweep loop
and its step with `record_function` spans (`ldpc_tpu_torch/utils/
profiling.py`): `ldpc.sweep.issue` around a batch's issue in `Sweep.run`,
`ldpc.sweep.draw` around its draw inside it, `ldpc.sweep.read` around the
read that waits for a batch's counters, and `ldpc.step.chain` around the
step's host chain up to the decoder's call (none on the megakernel's step).
The names are written out here, not imported, so that a program without
the spans reads as one whose trace holds none: every reader then returns
None.

The trace is the newest `out/trace-*.json` written since the process
started (`run.profile_stretch` writes one a process), loaded once. From it
come the program's spans by name in order of start, the card's busy time
inside the traced window (the `gpubench.*` frame and the union of device
operations, as `trace.py` takes them), and each device operation's launch:
the runtime or driver call with the same `args.correlation`. An operation
whose launch is not in the trace is unattributed, never guessed.
"""
from __future__ import annotations

import bisect
import functools
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from . import trace

OUT = Path(__file__).resolve().parent / "out"
ISSUE, DRAW, READ, CHAIN = ("ldpc.sweep.issue", "ldpc.sweep.draw",
                            "ldpc.sweep.read", "ldpc.step.chain")
NAMES = (ISSUE, DRAW, READ, CHAIN)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

Interval = Tuple[float, float]


def _overlap(xs: List[Interval], ys: List[Interval]) -> float:
    """Length of the intersection of two unions of disjoint sorted
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclass
class Timeline:
    """What the readers need of one trace; times in microseconds."""
    spans: Dict[str, List[Interval]]       # the program's, by start
    window: Optional[Interval]             # the gpubench.* frame
    busy: List[Interval]                   # device, merged, in the window
    ops: List[Tuple[float, float, Optional[float]]]  # start, end, launch

    @classmethod
    def of(cls, events: List[dict]) -> Optional["Timeline"]:
        """The timeline of Chrome-trace events, or None where they hold
        none of the program's spans."""
        spans: Dict[str, List[Interval]] = {n: [] for n in NAMES}
        frame: Dict[str, List[Interval]] = {trace.SPAN_ISSUE: [],
                                            trace.SPAN_DONE: []}
        launch: Dict[int, float] = {}
        dev = []
        for e in events:
            if e.get("ph") != "X" or "ts" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            name = e.get("name")
            corr = (e.get("args") or {}).get("correlation")
            if cat in trace.DEVICE_CATS:
                dev.append((a, b, corr))
            elif cat in LAUNCH_CATS and corr is not None:
                launch[corr] = a
            elif cat in trace.HOST_CATS:
                if name in spans:
                    spans[name].append((a, b))
                elif name in frame:
                    frame[name].append((a, b))
        if not any(spans.values()):
            return None
        window = None
        busy: List[Interval] = []
        if frame[trace.SPAN_ISSUE] and frame[trace.SPAN_DONE]:
            w0 = min(a for a, _ in frame[trace.SPAN_ISSUE])
            w1 = max(b for _, b in frame[trace.SPAN_DONE])
            window = (w0, w1)
            busy = trace._merge([(max(a, w0), min(b, w1)) for a, b, _ in dev
                                 if b > w0 and a < w1])
        ops = [(a, b, launch.get(c)) for a, b, c in dev]
        return cls({n: sorted(v) for n, v in spans.items()}, window, busy,
                   ops)

    def mean_ms(self, name: str) -> Optional[float]:
        """Mean host time of the span `name`, one a batch, in ms."""
        s = self.spans[name]
        return sum(b - a for a, b in s) / len(s) * 1e-3 if s else None

    def issue_idle_pct(self) -> Optional[float]:
        """Share of the window in which the card is idle while the host is
        inside `ldpc.sweep.issue`, in %; None where the card ran
        nothing in the window."""
        if self.window is None or not self.busy or not self.spans[ISSUE]:
            return None
        w0, w1 = self.window
        issue = trace._merge([(max(a, w0), min(b, w1))
                              for a, b in self.spans[ISSUE]
                              if b > w0 and a < w1])
        inside = sum(b - a for a, b in issue)
        idle = inside - _overlap(issue, self.busy)
        return 100.0 * idle / (w1 - w0) if w1 > w0 else None

    def chain_device_ms(self) -> Optional[float]:
        """Device time a batch of the operations launched inside
        `ldpc.step.chain`, in ms; None where the card ran nothing."""
        chain = self.spans[CHAIN]
        if not chain or not self.ops:
            return None
        starts = [a for a, _ in chain]
        total = 0.0
        for a, b, at in self.ops:
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= chain[i][1]:
                total += b - a
        return total / len(chain) * 1e-3

    def unattributed_share(self) -> Optional[float]:
        """Share of the device time whose launch is not in the trace."""
        total = sum(b - a for a, b, _ in self.ops)
        if total <= 0:
            return None
        return sum(b - a for a, b, at in self.ops if at is None) / total


def process_start() -> float:
    """Wall-clock seconds at which this process started (Linux's
    /proc/self/stat: ticks since boot)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    age = (time.clock_gettime(time.CLOCK_BOOTTIME)
           - ticks / os.sysconf("SC_CLK_TCK"))
    return time.time() - age


@functools.lru_cache(maxsize=1)
def _load(path: str, mtime_ns: int) -> Optional[Timeline]:
    return Timeline.of(trace.load(Path(path)))


def timeline(run) -> Optional[Timeline]:
    """The timeline of this process's traced stretch, or None where the run
    was not traced or its trace holds none of the program's spans."""
    if run.trace is None or not run.traced:
        return None
    start = process_start()
    found = [(p.stat().st_mtime_ns, p) for p in OUT.glob("trace-*.json")]
    found = [(m, p) for m, p in found if m >= start * 1e9]
    if not found:
        return None
    mtime, path = max(found)
    return _load(str(path), mtime)
