"""Probe of the two-lane packed decoder instances on one CUDA device:
times them in turns with the one-lane template they replaced and with the
streaming kernels that `auto` weighs them against
(`sim.pipeline.stream_first`).

    python -m ldpc_tpu_torch.kernels.probe_two_lane [--parent DIR]
        [--batch 1024 4096] [--route-batch 256 1024] [--reps 5]
        [--out FILE]

Cells: NR BG1 Z=384 rate 1/2 (preset `nr-bg1-layered`, 1.25 dB) and DVB-S2
n=16,200 rate 1/2 (`dvbs2-64800-r12` at n=16,200, 1.4 dB), each in five
forms, flooding min-sum (K1), flooding offset min-sum beta 2 (K1, with
early termination K2), flooding min* (K5), layered offset min-sum beta 2
(K3) and layered min* (K5), at 20 fixed iterations and with early
termination, at each B of `--batch`, on int8 LLRs of the all-zeros word
over BPSK/AWGN (hard-output form). The other shapes the two-lane rule
takes (`SHAPES`), in the same way in fewer forms: NR BG1 Z=256 rate 1/2
(1.25 dB; flooding offset min-sum and layered min*), NR BG1 Z=128 rate 1/3
(0.75 dB; flooding offset min-sum and min*: its layered state takes four
lanes) and DVB-S2 n=16,200 rate 8/9 (4.0 dB; flooding and layered offset
min-sum: its min* keeps the one-lane template); so every form that `auto`
moved from the template is timed on each shape: flooding, and layered
min* (its layered min-sum family streams), and the forced layered route
on rate 8/9. Each
cell's instance (`kernel`, the decoder's launch shape) is timed by CUDA
events (`utils.profiling.event_ms`)
and on the device alone (`device_ms`), each `--reps` calls a turn, and its
bound printed (`utils.profiling.bound` over the call's bytes and
`minsum.iteration_ops` for the iterations its lanes ran).

`--parent DIR`: a checkout (`git archive`) of a commit whose decoder
libraries decode these codes with the one-lane template; its
`minsum_flood.cu` and `minsum_layered.cu` are built from
`DIR/ldpc_tpu_torch/kernels/csrc` with the same flags, both at once, and
launched through that commit's C signature (no channel buffer). Each cell
then runs parent, two-lane, two-lane, parent, both timings, and the two
outputs must be equal (both are bit-exact with the plain version).

Four-lane cells: 802.11n n=648 rate 1/2 (the canonical preset), flooding
min-sum and offset min-sum, fixed and with early termination, at B =
16,384: the four-lane kernel, whose V phase the two-lane work reordered,
in turns with the parent's (which takes the packed tables too).

Route cells: layered offset min-sum on the two codes at each B of
`--route-batch`, fixed and with early termination, batch first (n > 4,096):
the decoder `auto` picks (the streaming library's instance) against the
two-lane instance behind its transposes (`backend="pallas"`), outputs
equal, in turns stream, two-lane, two-lane, stream.

Prints the card's `nvidia-smi` name and power limit, then one JSON line a
cell (also appended to `--out`); raises without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import statistics
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from .. import PRESETS
from ..codes import CodeTensors, build_code, from_reference
from ..sim import pipeline
from ..utils.profiling import bound, device_ms, event_ms, tensor_bytes
from . import build, minsum
from .probe_stream import channel_q

CODES = {"NR BG1 Z=384": ("nr-bg1-layered", {}, 1.25),
         "DVB-S2 n=16,200 r1/2": ("dvbs2-64800-r12", dict(n=16200), 1.4)}
# the other shapes of the two-lane rule: code -> (preset, code fields,
# Eb/N0), forms
SHAPES = {
    "NR BG1 Z=256 r1/2": (("nr-bg1-layered", dict(Z=256), 1.25),
                          ("flooding OMS", "layered min*")),
    "NR BG1 Z=128 r1/3": (("nr-bg1-layered", dict(Z=128, rate="1/3"), 0.75),
                          ("flooding OMS", "flooding min*")),
    "DVB-S2 n=16,200 r8/9": (("dvbs2-64800-r12", dict(n=16200, rate="8/9"),
                              4.0), ("flooding OMS", "layered OMS"))}
# a code of the four-lane flooding kernel, whose V phase the two-lane
# instances' channel stage reordered: its fixed and early-terminating
# flooding forms at the canonical step's batch, against the parent's
FOUR_LANE = {"802.11n n=648 r1/2": ("wifi-648-r12-minsum", {}, 2.0)}
FOUR_LANE_BATCH = 16384
# form -> (schedule, algorithm, beta_lsb)
FORMS = {"flooding min-sum": ("flooding", "min-sum", 0),
         "flooding OMS": ("flooding", "offset-min-sum", 2),
         "flooding min*": ("flooding", "min-star", 0),
         "layered OMS": ("layered", "offset-min-sum", 2),
         "layered min*": ("layered", "min-star", 0)}


def config(code: str, form: str, early_term: bool):
    """The cell's SimConfig: the code's preset, 20 iterations at most."""
    preset, code_kw, _ = _codes()[code]
    schedule, algorithm, beta = FORMS[form]
    cfg = PRESETS[preset]
    return dataclasses.replace(
        cfg, code=dataclasses.replace(cfg.code, **code_kw),
        decoder=dataclasses.replace(cfg.decoder, schedule=schedule,
                                    algorithm=algorithm, max_iter=20,
                                    early_term=early_term),
        quant=dataclasses.replace(cfg.quant, beta_lsb=beta))


def _codes():
    """Every cell's code: name -> (preset, code fields, Eb/N0)."""
    return {**CODES, **{k: v[0] for k, v in SHAPES.items()}, **FOUR_LANE}


def code_tensors(code: str, dev) -> CodeTensors:
    preset, code_kw, _ = _codes()[code]
    cfg = PRESETS[preset]
    return from_reference(build_code(dataclasses.replace(
        cfg, code=dataclasses.replace(cfg.code, **code_kw))), dev)


def k_name(form: str, early_term: bool) -> str:
    """The kernel row of PERF.md a form belongs to."""
    if "min*" in form:
        return "K5"
    if form.startswith("layered"):
        return "K3"
    return "K2" if early_term else "K1"


class ParentDecoder:
    """The parent commit's library for decoder d's code and configuration,
    launched through its own C signature (no channel buffer): the one-lane
    template on the codes the two-lane instances took from it."""

    def __init__(self, d: minsum.MinsumDecoder, cdll: ctypes.CDLL):
        self.d = d
        self.launch = getattr(cdll, f"{d.library}_launch")
        _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.launch.argtypes = [_P, _I, _F, _P, _I, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, ctypes.POINTER(_I), _I,
                                ctypes.POINTER(minsum.McArgs), _P, _I, _P]
        self.launch.restype = _I
        self.error_string = getattr(cdll, f"{d.library}_error_string")
        self.error_string.argtypes = [_I]
        self.error_string.restype = ctypes.c_char_p

    def kernel(self, chan: torch.Tensor):
        """Hard bits, iters and conv of int8 chan (nb, Z, B)."""
        d, ct = self.d, self.d.ct
        dev = d.ct.device
        B = int(chan.shape[2])
        iters = torch.empty(B, dtype=torch.int32, device=dev)
        conv = torch.empty(B, dtype=torch.bool, device=dev)
        hard = torch.empty((ct.nb, ct.Z, B), dtype=torch.uint8, device=dev)
        num, shift = d.alpha_pair
        thr = (ctypes.c_int * minsum.MAX_THRESHOLDS)(*(d.minstar or ()))

        def ptr(t):
            return None if t is None else t.data_ptr()
        err = self.launch(
            ptr(chan), 0, 0.0, None, 0, ptr(hard), None, None,
            ptr(iters), ptr(conv), d.tables_on(dev).data_ptr(), B, ct.nb,
            ct.Z, ct.mb, ct.n_entries, d.dec.max_iter,
            int(d.dec.early_term), d.quant.qmax, d.beta, num, shift,
            d.star_deg, thr, len(d.minstar or ()), None, *d._launch_tables,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"parent {d.library} launch failed: "
                               f"{self.error_string(err).decode()} ({err})")
        return hard, iters, conv


def parent_libraries(parent: Path) -> Dict[str, ctypes.CDLL]:
    """The parent's two decoder libraries, built from its sources with
    this commit's flags, both at once, into the build directory."""
    csrc = parent / "ldpc_tpu_torch" / "kernels" / "csrc"
    out = build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    names = list(minsum.LIBRARIES.values())
    results = {}

    def one(name):
        results[name] = subprocess.run(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(csrc / f"{name}.cu")],
            capture_output=True, text=True)
    threads = [threading.Thread(target=one, args=(name,)) for name in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, proc in results.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}:\n"
                               f"{proc.stderr}")
    return {name: ctypes.CDLL(str(out / f"lib{name}.so")) for name in names}


def in_turns(fns: Dict[str, Callable[[], object]], reps: int
             ) -> Dict[str, Dict[str, List[float]]]:
    """Event and device-only ms of each fn, `reps` calls a turn, in turns
    a, b, b, a (after three warm-up calls each)."""
    names = list(fns)
    for name in names:
        for _ in range(3):
            fns[name]()
    torch.cuda.synchronize()
    out = {name: {"event": [], "device": []} for name in names}
    for name in names + names[::-1]:
        out[name]["event"] += event_ms(fns[name], reps)
    for name in names + names[::-1]:
        out[name]["device"] += device_ms(fns[name], reps)
    return out


def medians(times: Dict[str, Dict[str, List[float]]]) -> Dict[str, object]:
    return {f"{name}_{kind}_ms": [statistics.median(t), min(t), max(t)]
            for name, kinds in times.items() for kind, t in kinds.items()}


def equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def kernel_cells(ct: CodeTensors, code: str, B: int, gen, reps: int,
                 parent: Optional[Dict[str, ctypes.CDLL]], gpu: str,
                 emit: Callable[[dict], None], forms=tuple(FORMS)) -> None:
    for form in forms:
        for et in (False, True):
            cfg = config(code, form, et)
            d = minsum.make_decoder(ct, cfg.decoder, cfg.quant)
            ebn0 = _codes()[code][2]
            chan = channel_q(ct, cfg, ebn0, B, gen).T.reshape(
                ct.nb, ct.Z, B).contiguous()
            out = d.kernel(chan)
            fns = {"two_lane": lambda: d.kernel(chan)}
            if parent is not None:
                old = ParentDecoder(d, parent[d.library])
                if not equal(old.kernel(chan), out):
                    raise AssertionError(f"{code} {form} B={B}: the parent's "
                                         f"template and the two-lane "
                                         f"instance differ")
                fns = {"parent": lambda: old.kernel(chan), **fns}
            times = in_turns(fns, reps)
            its = int(out[1].to(torch.int64).sum())
            b_ms, b_by = bound(tensor_bytes(chan, out),
                               its * minsum.iteration_ops(ct, d.minstar))
            emit({"gpu": gpu, "cell": "kernel", "code": code, "form": form,
                  "row": k_name(form, et), "early_term": et, "B": B,
                  "ebn0_db": ebn0, "mean_iters": its / B,
                  "launch_shape": list(d.launch_shape()),
                  "lanes_per_thread": d.lanes_per_thread,
                  "equal_to_parent": parent is not None,
                  "bound_ms": b_ms, "bound_by": b_by, **medians(times)})


def route_cells(ct: CodeTensors, code: str, B: int, gen, reps: int,
                gpu: str, emit: Callable[[dict], None]) -> None:
    for et in (False, True):
        cfg = config(code, "layered OMS", et)
        auto, label = pipeline.select_decoder(ct, cfg, batch=B)
        two, two_label = pipeline.select_decoder(ct, cfg, batch=B,
                                                 backend="pallas")
        q = channel_q(ct, cfg, CODES[code][2], B, gen)
        out = auto.kernel(q)
        if not equal(two.kernel(q), out):
            raise AssertionError(f"{code} B={B}: {label} and {two_label} "
                                 f"differ")
        times = in_turns({"stream": lambda: auto.kernel(q),
                          "two_lane": lambda: two.kernel(q)}, reps)
        emit({"gpu": gpu, "cell": "route", "code": code, "B": B,
              "early_term": et, "auto": label, "forced": two_label,
              "mean_iters": float(out[1].double().mean()),
              **medians(times)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--batch", type=int, nargs="+", default=[1024, 4096])
    ap.add_argument("--route-batch", type=int, nargs="*",
                    default=[256, 1024])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    dev = torch.device("cuda")
    parent = parent_libraries(args.parent) if args.parent else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    for code in CODES:
        ct = code_tensors(code, dev)
        for B in args.batch:
            kernel_cells(ct, code, B, gen, args.reps, parent, gpu, emit)
        for B in args.route_batch:
            route_cells(ct, code, B, gen, args.reps, gpu, emit)
    for code, (_, forms) in SHAPES.items():
        ct = code_tensors(code, dev)
        for B in args.batch:
            kernel_cells(ct, code, B, gen, args.reps, parent, gpu, emit,
                         forms=forms)
    for code in FOUR_LANE:
        kernel_cells(code_tensors(code, dev), code, FOUR_LANE_BATCH, gen,
                     args.reps, parent, gpu, emit,
                     forms=("flooding min-sum", "flooding OMS"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
