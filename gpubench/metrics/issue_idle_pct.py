"""Share of the traced window (the `gpubench.*` frame of `trace.py`) in
which no kernel, copy or set runs on the card while the host is inside the
program's span `ldpc.sweep.issue` (a batch's draw and the step call that
enqueues it), in %."""
from gpubench import spans


def read(run):
    tl = spans.timeline(run)
    return None if tl is None else tl.issue_idle_pct()
