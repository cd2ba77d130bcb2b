"""Reading a `torch.profiler` trace of the sweep loop.

The profiled stretch marks each batch's issue (its `run_batch` call) and the
hand-over of its counters once they are on the host (`Sweep.run`'s per-batch
`_save` call, right after the read) with the spans `gpubench.issue` and
`gpubench.counters` (`record_function`). The traced window runs from the
first issue's start to the last hand-over's end. On
the device track every kernel, copy and set runs for some time; their union
within the window is the busy time, and the rest is idle. A kernel whose name
holds a decoder kernel's name (`registry.decoder_kernels`) is decoder time;
every other device operation is the chain's.
"""
from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Set, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
SPAN_ISSUE, SPAN_DONE = "gpubench.issue", "gpubench.counters"
TOP = 10


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    decoder_s: float
    other_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def is_decoder(name: str, decoder_names: Set[str]) -> bool:
    return any(t in decoder_names for t in re.findall(r"[A-Za-z_]\w*", name))


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class _HostIndex:
    """The innermost host span at a time: the shortest span covering it
    among the last `BACK` to start before it, or among the long spans."""
    BACK = 64
    LONG_US = 1000.0

    def __init__(self, host: List[Tuple[float, float, str]]):
        self.host = sorted(host)
        self.starts = [a for a, _, _ in self.host]
        self.long = [h for h in self.host if h[1] - h[0] >= self.LONG_US]

    def label(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t)
        near = self.host[max(0, i - self.BACK):i]
        cover = [(b - a, n) for a, b, n in near if b >= t]
        if not cover:
            cover = [(b - a, n) for a, b, n in self.long if a <= t <= b]
        return min(cover)[1] if cover else "host between ops"


def short(name: str, width: int = 120) -> str:
    name = name.replace("void ", "", 1) if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def summarize(events: List[dict], decoder_names: Set[str]) -> TraceSummary:
    """Chrome-trace events (a list of dicts) -> the window's summary."""
    dev, host, issue, done = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        name = str(e.get("name", ""))
        if cat in DEVICE_CATS:
            dev.append((a, b, name))
        elif cat in HOST_CATS:
            if name == SPAN_ISSUE:
                issue.append((a, b))
            elif name == SPAN_DONE:
                done.append((a, b))
            host.append((a, b, name))
    if not issue or not done:
        raise ValueError(f"the trace holds no {SPAN_ISSUE} / {SPAN_DONE} "
                         f"spans")
    w0 = min(a for a, _ in issue)
    w1 = max(b for _, b in done)
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in dev
              if b > w0 and a < w1]
    busy = _merge([(a, b) for a, b, _ in inside])
    by_name: Dict[str, float] = defaultdict(float)
    decoder = other = 0.0
    for a, b, n in inside:
        by_name[short(n)] += b - a
        if is_decoder(n, decoder_names):
            decoder += b - a
        else:
            other += b - a
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    at = _HostIndex(host)
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            gaps[short(at.label(0.5 * (g0 + g1)))] += g1 - g0
    us = 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        window_s=(w1 - w0) * us, busy_s=sum(b - a for a, b in busy) * us,
        decoder_s=decoder * us, other_s=other * us,
        device_ops=[[n, s * us] for n, s in top],
        idle_gaps=[[n, s * us] for n, s in idle])


def load(path: Path) -> List[dict]:
    data = json.loads(Path(path).read_text())
    return data["traceEvents"] if isinstance(data, dict) else data
