"""Probe of the streaming library on one CUDA device: builds it, holds its
four instances to the plain version at the real widths, and times the two
posterior placements against each other, which is what
`minsum_stream.resident_auto` rests on.

    python -m ldpc_tpu_torch.kernels.probe_stream [--batch 1024] [--reps 5]

Prints the card's `nvidia-smi` name and power limit beside every time.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess

import torch

from .. import PRESETS
from ..codes import build_code, from_reference
from ..config import cn_params
from ..ops.channel import sigma_for
from ..ops.quantize import quantize
from ..utils.profiling import event_ms
from . import minsum, minsum_stream as ms


def channel_q(ct, cfg, ebn0_db, B, gen):
    """int8 LLRs (B, n) of the all-zeros word over BPSK/AWGN at ebn0_db."""
    sigma = float(sigma_for(ebn0_db, ct.code.rate, "bpsk"))
    y = 1.0 + sigma * torch.randn((B, ct.n), generator=gen,
                                  device=ct.device)
    return quantize(2.0 * y / sigma ** 2, cfg.quant)


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
    cts = {}
    for name, cfg, db, B in cases:
        ct = cts[name] = from_reference(build_code(cfg), dev)
        q = channel_q(ct, cfg, db, B, gen)
        lanes = minsum.pick_lanes(ct, "layered")
        print(f"{name}: n={ct.n} Z={ct.Z} E={ct.n_entries} on-chip lanes "
              f"{lanes}", flush=True)
        for et in (False, True):
            dc = dataclasses.replace(cfg.decoder, early_term=et, max_iter=10)
            outs = {}
            for res in (False, True):
                d = ms.make_decoder(ct, dc, cfg.quant, resident=res)
                if d.launch_smem() != ms.smem_bytes(ct, res, et):
                    raise AssertionError(f"{name}: the library's block of "
                                         f"{d.launch_smem()} B is not the "
                                         f"wrapper's")
                outs[d.variant] = d.kernel(q)
                torch.cuda.synchronize()
            plain = d.plain(q)
            for variant, out in outs.items():
                same = all(torch.equal(a, b) for a, b in zip(out, plain))
                print(f"  {variant}: == plain {same} (mean iters "
                      f"{float(out[1].double().mean()):.2f}, converged "
                      f"{int(out[2].sum())}/{B})", flush=True)
                if not same:
                    raise AssertionError(f"{name} {variant} != plain")
    B = args.batch
    for name, cfg, db, _ in cases[:2]:
        ct = cts[name]
        for et, point in ((False, db), (True, db + 0.25)):
            q = channel_q(ct, cfg, point, B, gen)
            dc = dataclasses.replace(cfg.decoder, early_term=et)
            beta, alpha = cn_params(dc, cfg.quant)
            ref = None
            for res in (False, True):
                d = ms.make_stream_decoder(
                    ct, max_iter=dc.max_iter, beta=beta, alpha=alpha,
                    qmax=cfg.quant.qmax, resident=res, early_term=et)
                out = d.kernel(q)
                if ref is None:
                    ref = out
                if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                    raise AssertionError("instances differ")
                t = event_ms(lambda: d.kernel(q), args.reps)
                print(f"[{gpu}] {name} B={B} {d.variant} at {point} dB "
                      f"(mean iters {float(out[1].double().mean()):.2f}): "
                      f"median {statistics.median(t):.3f} ms (min "
                      f"{min(t):.3f}, max {max(t):.3f})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
