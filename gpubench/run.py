"""The benchmark of the simulator's PyTorch and CUDA port on one card.

    python -m gpubench.run --workload NAME --seed N --seconds S --trace 0|1

A workload is a configuration (`configs/`) under a traffic mix (`cells/`),
both named in `BENCHMARK.json`. The run drives the program's own sweep
loop, `Sweep.run`, over the cell's one point: `Sweep(cfg, batch=B,
lookahead=L)` is the set-up, with the run's seed as `cfg.run.seed`, and
`Sweep.run` issues batch i as `run_batch(draw(0, i), sigma)`, keeps L in
flight and reads their counters in order. It is a closed loop: the next
batch is issued when a batch's counters have been read. The window is
bounded by `Sweep.run`'s `max_frames`, sized from the loop's rate at set-up
to last about `--seconds`, with its frame-error target out of reach. The
step and the hand-over of each batch's counters are wrapped on the
instance to stamp them (`Stamps`).

Set-up (`setup_s`: process start to the window's first batch) builds the
sweep, warms up every shape with a short `Sweep.run` and times one more,
of `CALIBRATE_S` seconds at the warm-up's rate, to size the window; the
warm-up runs slower than the loop, so that run is shorter. Every batch of
the window counts. With `--trace 1` a shorter `Sweep.run` follows under
`torch.profiler` and the per-layer metrics are read from it. After that the
program is freed, and a sample of the window's batches, drawn from the
seed, is worked out again by the plain reference (`reference/`) and
compared (`check.py`). The last line on standard output is the result, one
JSON object; the numbers compared, each beside its limit, are the last
lines on standard error.

The run needs a CUDA card: without one it exits with code 2 and prints no
result. It exits with code 3, and no result, if JAX or the JAX package has
been loaded in the process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402

from . import check, registry, trace  # noqa: E402
from .reference.batch import Reference, setting  # noqa: E402

HERE = Path(__file__).resolve().parent
OUT = HERE / "out"
FORBIDDEN = ("jax", "jaxlib", "flax", "ldpc_tpu")
PROGRAM = "ldpc_tpu_torch"
UNREACHED = 1 << 62      # a frame-error target that no window reaches
CALIBRATE_S = 1.0        # seconds, at the warm-up's rate, of the run that
                         # sizes the window
START_S = 0.3            # seconds of the loop that start the profiler


def forbidden_modules(names) -> List[str]:
    """The forbidden top-level names among module names, compared whole
    (`ldpc_tpu_torch` is not `ldpc_tpu`)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


@dataclass
class Batch:
    index: int
    issued: float             # host clock at the batch's run_batch call
    done: float               # host clock once its counters are on the host
    counters: List[int]


@dataclass
class Run:
    """What a run recorded, as the metric readers see it."""
    setup_s: float
    window_s: float
    batches: List[Batch]      # every batch of the window, in the order read
    dispatch_s: List[float]   # host time of each run_batch call
    n: int
    k: int
    edges: int
    traced: List[Batch] = field(default_factory=list)
    trace: Optional["trace.TraceSummary"] = None


class Stamps:
    """`Sweep.run`'s own loop, stamped on the host clock. The sweep's step
    (`sweep.run_batch`) and the hand-over of each batch's counters
    (`sweep._save`, which `Sweep.run` calls once a batch, right after the
    batch's counters reached the host) are wrapped on the instance, and
    each wrapper calls what it wraps, so the window times the loop that
    users run, with its lookahead, its reads and its saves, and no copy of
    it."""

    def __init__(self, sweep, step: Callable):
        self.sweep = sweep
        base = sweep.run_batch
        stamps = self

        class StampedStep:
            """The step as `Sweep.run` calls it, with the attributes
            (`mc`, `backend_label`, ...) of the step it stands for."""

            def __getattr__(self, name):
                return getattr(base, name)

            def __call__(self, rng, sigma):
                return stamps._issue(step, rng, sigma)

        sweep.run_batch = StampedStep()
        self.save = sweep._save
        sweep._save = self._save
        self._start(lambda name: nullcontext())

    def _start(self, mark: Callable[[str], object]) -> None:
        self.mark = mark
        self.issued: deque = deque()
        self.batches: List[Batch] = []
        self.dispatch: List[float] = []
        self.totals = [0] * 5

    def _issue(self, step: Callable, rng, sigma):
        a = time.perf_counter()
        with self.mark(trace.SPAN_ISSUE):
            out = step(rng, sigma)
        self.dispatch.append(time.perf_counter() - a)
        self.issued.append(a)
        return out

    def _save(self, points, meta) -> None:
        t = time.perf_counter()
        with self.mark(trace.SPAN_DONE):
            pt = points[0]
            totals = [pt.frames, pt.bit_errs, pt.frame_errs, pt.iter_sum,
                      pt.converged]
            self.batches.append(Batch(
                pt.batches - 1, self.issued.popleft(), t,
                [x - y for x, y in zip(totals, self.totals)]))
            self.totals = totals
            self.save(points, meta)

    def run(self, ebn0_db: float, n_batches: int,
            mark: Callable[[str], object] = lambda name: nullcontext()):
        """`Sweep.run` over one point for `n_batches` batches (its
        `max_frames`; the frame-error target is out of reach). Returns
        (the batches in the order read, each issue's dispatch seconds,
        start, end) on the host clock."""
        self._start(mark)
        t0 = time.perf_counter()
        self.sweep.run([ebn0_db], target_frame_errors=UNREACHED,
                       max_frames=n_batches * self.sweep.batch)
        t1 = time.perf_counter()
        return self.batches, self.dispatch, t0, t1


def sim_config(config: dict, traffic: dict, seed: int):
    from ldpc_tpu_torch.config import (ChannelConfig, CodeConfig,
                                       DecoderConfig, QuantConfig,
                                       RunConfig, SimConfig)
    c = config["code"]
    return SimConfig(
        code=CodeConfig(family=c["family"], n=int(c["n"]), rate=c["rate"],
                        code_seed=int(c.get("code_seed", 0))),
        channel=ChannelConfig(modulation=config["channel"]["modulation"],
                              ebn0_db=float(traffic["ebn0_db"])),
        quant=QuantConfig(**config["quant"]),
        decoder=DecoderConfig(**config["decoder"]),
        run=RunConfig(batch=int(config["run"]["batch"]), seed=int(seed),
                      rng=traffic["rng"],
                      all_zeros=bool(traffic.get("all_zeros", False))))


def launch_counts() -> dict:
    from ldpc_tpu_torch.kernels import minsum, minsum_stream
    return {"minsum": dict(minsum.library_launches),
            "minsum_mc": dict(minsum.mc_launches),
            "minsum_plain": minsum.plain_calls,
            "stream": dict(minsum_stream.instance_launches),
            "stream_plain": minsum_stream.plain_calls}


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_workload(wl: registry.Workload, seed: int, seconds: float,
                 traced: bool, device: str = "cuda",
                 batch: Optional[int] = None,
                 wrap: Optional[Callable] = None) -> dict:
    """One run of a workload; returns the result object. `batch` overrides
    the configuration's batch and `wrap(run_batch, sweep)` replaces the
    step (CPU tests of the check)."""
    import torch

    cuda = device == "cuda"
    tr = wl.traffic
    st = setting(wl.config, tr, batch=batch)
    run, peak = _program(wl, st, seed, seconds, traced, device, wrap)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    program = {b.index: b.counters for b in run.batches}
    picked = check.sample(seed, len(run.batches), int(tr["check_batches"]))
    ref = Reference(st, device)
    reference = {run.batches[j].index: ref.counters(seed, run.batches[j].index)
                 for j in picked}
    del ref
    checks = check.judge(program, reference, tr["limits"])
    failed = sum(check.counter_gap(program[i], reference[i])
                 > tr["limits"]["counter_gap"] for i in reference)

    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": wl.chips if cuda else 0,
           "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power"] = power_limit()
    result = {"correct": bool(reference) and check.passed(checks),
              "attempted": len(run.batches), "failed": int(failed),
              "metrics": registry.read_metrics(wl, traced, run),
              "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    return result


def _program(wl: registry.Workload, st, seed: int, seconds: float,
             traced: bool, device: str, wrap: Optional[Callable]):
    """The program's part of a run: set-up, warm-up, the window and the
    traced stretch, each a `Sweep.run` of the cell's point. Returns (the
    run's record, peak device memory); the program's state goes when it
    returns."""
    import torch
    from ldpc_tpu_torch.sim.sweep import Sweep

    cuda = device == "cuda"
    tr = wl.traffic
    lookahead = int(tr["lookahead"])
    ebn0 = float(tr["ebn0_db"])
    marks = [time.perf_counter()]
    sweep = Sweep(sim_config(wl.config, tr, seed), device=device,
                  batch=st.batch, lookahead=lookahead)
    loop = Stamps(sweep, sweep.run_batch if wrap is None
                  else wrap(sweep.run_batch, sweep))

    def batches_for(secs: float, n: int, a: float, b: float) -> int:
        return max(lookahead, round(n * secs / max(b - a, 1e-9)))

    # set-up: warm every shape, then size the window from the loop's rate
    warm = int(tr["warmup_rounds"]) * lookahead
    _, _, a, b = loop.run(ebn0, warm)
    marks += [a, b]
    n = batches_for(CALIBRATE_S, warm, a, b)
    _, _, a, b = loop.run(ebn0, n)
    n_window = batches_for(seconds, n, a, b)
    if cuda:
        torch.cuda.synchronize()
    batches, dispatch, t0, t1 = loop.run(ebn0, n_window)
    code = st.code
    run = Run(setup_s=t0 - T_START, window_s=t1 - t0, batches=batches,
              dispatch_s=dispatch, n=code.n, k=code.k, edges=code.edges)
    print(f"gpubench: route {sweep.backend}; {len(batches)} batches in "
          f"{t1 - t0:.3f} s; launches {json.dumps(launch_counts())}",
          file=sys.stderr)
    phases = zip(("imports", "sweep", "warm-up", "sizing"),
                 [T_START] + marks, marks + [t0])
    print("gpubench: set-up " + ", ".join(f"{name} {b - a:.3f} s"
                                          for name, a, b in phases),
          file=sys.stderr)
    if traced:
        run.traced, run.trace = profile_stretch(
            wl, loop, ebn0,
            batches_for(START_S, n_window, t0, t1),
            batches_for(float(tr["trace_seconds"]), n_window, t0, t1))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return run, peak


def profile_stretch(wl: registry.Workload, loop: Stamps, ebn0: float,
                    n_start: int, n_traced: int):
    """`Sweep.run` under torch.profiler: `n_start` batches to start the
    profiler, then `n_traced` recorded. Returns (the recorded batches,
    summary)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"trace-{wl.name}.json"
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                 ) as prof:
        loop.run(ebn0, n_start, mark=record_function)
        prof.step()
        batches, _, _, _ = loop.run(ebn0, n_traced, mark=record_function)
        prof.step()
    names = registry.decoder_kernels(wl.root, PROGRAM)
    return batches, trace.summarize(trace.load(path), names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches live in the checkout, at fixed paths, so that a
    # checkout's later runs find what its first run built
    OUT.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(OUT / "triton-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(OUT / "extensions")
    wl = registry.workload(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl.chips:
        print(f"gpubench: {args.workload} needs {wl.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    result = run_workload(wl, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"gpubench: the process loaded {bad}: no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
