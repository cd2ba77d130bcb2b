"""The readings that a cell's check limit is set from, on the card.

    python -m gpubench.control --workload NAME --seeds S1 S2 ... [--program]

For each seed it draws the batches a run would check (`check.sample` over a
window of `WINDOW` batches) and works each out twice with the plain
reference: in the configuration's precision, and as the control, in the
nearest precision below it (int4 for the 8-bit LLRs: the same LLR range with
an LSB 16 times as wide, the offset in the new LSB). The control's
`counter_gap` against the reference is the check's upper reading. With
`--program` the program's own step runs the same batches (the timed path's
`run_batch(draw(0, i), sigma)`, without a window), and its gap is a lower
reading. One JSON line a seed on standard output; the benchmark's runs never
run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import check, registry
from .reference.batch import Reference, setting
from .run import sim_config

CONTROL_BITS = 4
WINDOW = 1000   # batches a window holds, for the sample's draw


def readings(wl: registry.Workload, seed: int, window: int, program: bool,
             device: str = "cuda", batch=None) -> dict:
    import torch
    tr = wl.traffic
    st = setting(wl.config, tr, batch=batch)
    idx = check.sample(seed, window, int(tr["check_batches"]))
    out = {"workload": wl.name, "seed": seed, "batches": idx}
    if program:
        from ldpc_tpu_torch.sim.sweep import Sweep
        sweep = Sweep(sim_config(wl.config, tr, seed), device=device,
                      batch=st.batch, lookahead=int(tr["lookahead"]))
        prog = {i: sweep.run_batch(sweep.draw(0, i), st.sigma).tolist()
                for i in idx}
        del sweep
        if device == "cuda":
            torch.cuda.empty_cache()
    ref = Reference(st, device)
    want = {i: ref.counters(seed, i) for i in idx}
    del ref
    ctl = Reference(setting(wl.config, tr, batch=batch, bits=CONTROL_BITS),
                    device)
    low = {i: ctl.counters(seed, i) for i in idx}
    out["reference"] = want
    out["control"] = low
    out["control_gap"] = check.judge(low, want, tr["limits"]
                                     )["counter_gap"]["value"]
    if program:
        out["program"] = prog
        out["program_gap"] = check.judge(prog, want, tr["limits"]
                                         )["counter_gap"]["value"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gpubench.control: no CUDA card", file=sys.stderr)
        return 2
    wl = registry.workload(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(wl, seed, WINDOW, args.program)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
