"""Probe of the streaming library on one CUDA device: builds it, holds every
instance to the plain version at the real widths, and times the kernels in
turns on the same inputs, which is what `minsum_stream.instance_auto`
rests on. `decoders` and `in_turns` are also what `chip_smoke.py` times the
library with.

    python -m ldpc_tpu_torch.kernels.probe_stream [--batch 1024] [--reps 5]

The instances: the pipelined kernel (`stream-pipelined`,
`stream-pipelined-et`) and the template (`stream`, `stream-et` with the
posteriors in device memory, `stream-resident`, `stream-resident-et` in
shared memory), each where its rule takes the code. Correctness: 10
iterations on DVB-S2 n=64,800 (B=64), n=16,200 (B=128) and NR BG1 Z=384
(B=64), fixed and with early termination, every instance against the plain
version, tolerance 0. Times: B = `--batch` on the same three codes, 20
iterations, fixed at the cell's Eb/N0 and with early termination 0.25 dB
above, each kernel's CUDA-event median (min, max) over `--reps` runs a
turn, the kernels in turns a, b, c, c, b, a. Prints the card's
`nvidia-smi` name and power limit beside every time.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
from typing import Dict, Optional

import torch

from .. import PRESETS
from ..codes import CodeTensors, build_code, from_reference
from ..config import cn_params
from ..ops.channel import sigma_for
from ..ops.quantize import quantize
from ..utils.profiling import in_turns_ms
from . import minsum, minsum_stream as ms


def channel_q(ct, cfg, ebn0_db, B, gen):
    """int8 LLRs (B, n) of the all-zeros word over BPSK/AWGN at ebn0_db."""
    sigma = float(sigma_for(ebn0_db, ct.code.rate, "bpsk"))
    y = 1.0 + sigma * torch.randn((B, ct.n), generator=gen,
                                  device=ct.device)
    return quantize(2.0 * y / sigma ** 2, cfg.quant)


def decoders(ct: CodeTensors, max_iter: int, beta: int, qmax: int, alpha,
             early_term: bool) -> Dict[str, ms.StreamDecoder]:
    """Every instance of the library whose rule takes the code, by
    variant, in the order old, new, old: the template with the posteriors
    in device memory (`block_fits`), the pipelined kernel
    (`pipelined_fits`), the template with the posteriors in shared memory."""
    kws = [dict(resident=False)] if ms.block_fits(ct, False,
                                                  early_term) else []
    if ms.pipelined_fits(ct):
        kws.append(dict(pipelined=True))
    if ms.block_fits(ct, True, early_term):
        kws.append(dict(resident=True))
    decs = (ms.make_stream_decoder(ct, max_iter=max_iter, beta=beta,
                                   qmax=qmax, alpha=alpha,
                                   early_term=early_term, **kw)
            for kw in kws)
    return {d.variant: d for d in decs}


def in_turns(decs: Dict[str, ms.StreamDecoder], q: torch.Tensor, what: str,
             gpu: str, reps: int = 5,
             extra: Optional[Dict[str, object]] = None) -> Dict[str, float]:
    """The kernels of `decs` on q: their outputs equal (else
    AssertionError), then CUDA-event ms in turns with `extra` (other
    decoders with a `kernel`, timed only). Prints each median with its min
    and max; returns name -> median ms."""
    ref = None
    for d in decs.values():
        out = d.kernel(q)
        ref = out if ref is None else ref
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"{what}: {d.variant} differs from "
                                 f"{next(iter(decs))}")
    fns = {name: (lambda d=d: d.kernel(q))
           for name, d in {**decs, **(extra or {})}.items()}
    times = in_turns_ms(fns, reps)
    med = {name: statistics.median(t) for name, t in times.items()}
    print(f"[{gpu}] {what} (mean iters {float(ref[1].double().mean()):.2f}"
          f"): " + ", ".join(
              f"{name} {med[name]:.4f} ms (runs {len(t)}, min {min(t):.4f}, "
              f"max {max(t):.4f})" for name, t in times.items()), flush=True)
    return med


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    lib = ms.load_library(rebuild=True)
    print(f"build {lib.build_seconds:.2f} s")
    for line in lib.ptxas_log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print("  ptxas:", line.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    base = PRESETS["dvbs2-64800-r12"]
    short = dataclasses.replace(base, code=dataclasses.replace(
        base.code, n=16200))
    nr = PRESETS["nr-bg1-layered"]
    cases = (("dvbs2-64800", base, 1.0, 64), ("dvbs2-16200", short, 1.4, 128),
             ("nr-bg1-z384", nr, 1.0, 64))
    for name, cfg, db, B in cases:
        ct = from_reference(build_code(cfg), dev)
        beta, alpha = cn_params(cfg.decoder, cfg.quant)
        q = channel_q(ct, cfg, db, B, gen)
        print(f"{name}: n={ct.n} Z={ct.Z} E={ct.n_entries} on-chip lanes "
              f"{minsum.pick_lanes(ct, 'layered')}, rows of degree "
              f"{ms.max_row_degree(ct)} at most", flush=True)
        for et in (False, True):
            decs = decoders(ct, 10, beta, cfg.quant.qmax, alpha, et)
            plain = next(iter(decs.values())).plain(q)
            for d in decs.values():
                smem, dmax, blocks = d.launch_shape()
                if smem != d.smem_bytes():
                    raise AssertionError(f"{name}: the library's block of "
                                         f"{smem} B is not the wrapper's")
                out = d.kernel(q)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(out, plain))
                print(f"  {d.variant}: == plain {same} (mean iters "
                      f"{float(out[1].double().mean()):.2f}, converged "
                      f"{int(out[2].sum())}/{B}; {smem} B smem, register row "
                      f"{dmax}, {blocks} blocks/SM)", flush=True)
                if not same:
                    raise AssertionError(f"{name} {d.variant} != plain")
        for et, point in ((False, db), (True, db + 0.25)):
            q = channel_q(ct, cfg, point, args.batch, gen)
            in_turns(decoders(ct, cfg.decoder.max_iter, beta, cfg.quant.qmax,
                              alpha, et), q,
                     f"{name} B={args.batch} {'ET' if et else 'fixed'} at "
                     f"{point} dB", gpu, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
