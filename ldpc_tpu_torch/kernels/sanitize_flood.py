"""Race, barrier and initialisation check of the flooding library's
instances on one CUDA device, under NVIDIA's compute-sanitizer.

    python -m ldpc_tpu_torch.kernels.sanitize_flood [--tools racecheck,...]

Builds the flooding library (`csrc/minsum_flood.cu`) in this process, then
runs `python -m ldpc_tpu_torch.kernels.sanitize_flood --cases` once under
`compute-sanitizer --tool <tool>` for each of racecheck, synccheck and
initcheck. The cases launch each instance once at a small batch and hold
its outputs to the plain version (tolerance 0): the packed kernel's
early-terminating min-sum instance (n=648 OMS, fused IO), its min* instances
(fixed and ET), its Monte-Carlo forms (OMS ET and min* ET, Philox) and its
fixed min-sum instance (K1); the one-lane template on the codes it keeps
(NR BG1 Z=384 fixed and ET, min* on the (3,30) array code's rows of 30).
Prints each tool's command, its "ERROR SUMMARY" line and the card's
`nvidia-smi` name and power limit; exits non-zero if a tool reports an
error, a case disagrees with plain, or compute-sanitizer cannot be run.
It is not part of `chip_smoke.py`'s timed run: a sanitized launch runs
orders of magnitude slower.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from typing import List, Optional

import numpy as np
import torch

TOOLS = ("racecheck", "synccheck", "initcheck")
BATCH = 37      # nine words of four lanes and a ragged one


def find_sanitizer() -> Optional[str]:
    """compute-sanitizer on PATH or beside nvcc's toolkit, else None."""
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for rel in ("bin/compute-sanitizer", "compute-sanitizer/compute-sanitizer"):
        path = os.path.join(home, rel)
        if os.path.exists(path):
            return path
    return None


def run_cases() -> None:
    """Each instance once at BATCH lanes (a few at the long codes) ==
    plain; raises on a difference."""
    from .. import PRESETS
    from ..codes import CodeTensors, build_code, from_reference, qc_entries
    from ..codes.toy import array_qc
    from ..ops.channel import sigma_for
    from ..ops.mc import gain_for
    from . import minsum
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    cfg = PRESETS["wifi-648-r12-minsum"]
    wifi = from_reference(build_code(cfg), dev)
    oms = (dataclasses.replace(cfg.decoder, algorithm="offset-min-sum",
                               early_term=True),
           dataclasses.replace(cfg.quant, beta_lsb=2))
    star = dataclasses.replace(cfg.decoder, algorithm="min-star")
    q0 = dataclasses.replace(cfg.quant, beta_lsb=0)
    star_et = dataclasses.replace(star, early_term=True)

    def llrs(ct, B):
        x = rng.normal(20, 40, size=(ct.n, B))
        return torch.as_tensor(np.clip(np.round(x), -127, 127).astype(
            np.int8)).reshape(ct.nb, ct.Z, B).to(dev)

    def hold(label, d, args, kw=None):
        kw = kw or {}
        out_k = d.kernel(*args, **kw)
        torch.cuda.synchronize()
        out_p = d.plain(*args, **kw)
        same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(out_k, out_p))
        inner = getattr(d, "decoder", d)
        print(f"  {label}: {'packed' if inner.packed else 'one-lane'}, "
              f"== plain {same}", flush=True)
        if not same:
            raise AssertionError(f"kernel != plain on {label}")

    sigma = np.float32(sigma_for(2.0, wifi.code.rate, "bpsk"))
    y = 1.0 + sigma * rng.standard_normal((wifi.n, BATCH))
    f32 = torch.as_tensor((2.0 * y / sigma ** 2).astype(np.float32)).reshape(
        wifi.nb, wifi.Z, BATCH).to(dev)
    info = torch.zeros((wifi.kb, wifi.Z, BATCH), dtype=torch.uint8,
                       device=dev)
    for label, dc, qc in (("K2 n648 OMS ET fused-IO", *oms),
                          ("K5 n648 min* flooding ET fused-IO", star_et, q0)):
        d = minsum.make_decoder(wifi, dc, qc, input_scale=qc.scale,
                                count_info_cols=wifi.kb)
        hold(label, d, (f32, info))
    for label, dc, qc in (("K1 n648 min-sum fixed-20", cfg.decoder,
                           cfg.quant),
                          ("K5 n648 min* flooding fixed-20", star, q0)):
        hold(label, minsum.make_decoder(wifi, dc, qc), (llrs(wifi, BATCH),))
    g = gain_for(sigma, cfg.quant.scale)
    for label, dc, qc in (("K2 MC n648 OMS ET Philox", *oms),
                          ("K5 MC n648 min* flooding ET Philox", star_et,
                           q0)):
        d = minsum.make_decoder(wifi, dc, qc, input_scale=qc.scale,
                                count_info_cols=wifi.kb, mc_batch=BATCH)
        hold(label, d, (0x5EED, sigma, g))
    nr = from_reference(build_code(PRESETS["nr-bg1-layered"]), dev)
    few = dataclasses.replace(cfg.decoder, max_iter=5)
    for label, dc in (("one-lane K1 NR BG1 Z=384 fixed-5", few),
                      ("one-lane K2 NR BG1 Z=384 ET", dataclasses.replace(
                          few, early_term=True))):
        hold(label, minsum.make_decoder(nr, dc, cfg.quant), (llrs(nr, 2),))
    code = array_qc(3, 30, 31)
    qc_, entries = qc_entries(code)
    arr = CodeTensors(code=code, device=dev, n=int(code.n), k=int(code.k),
                      Z=int(qc_.Z), nb=int(qc_.nb), mb=int(qc_.mb), kb=0,
                      entries=entries, P=None, perm=None,
                      info_positions=torch.zeros(0, dtype=torch.int64,
                                                 device=dev),
                      ident_info=False)
    hold("one-lane K5 array 3x30 min* flooding ET",
         minsum.make_decoder(arr, dataclasses.replace(star_et, max_iter=5),
                             q0), (llrs(arr, 5),))


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", action="store_true",
                    help="run the cases (what each tool wraps)")
    ap.add_argument("--tools", default=",".join(TOOLS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("sanitize_flood needs a CUDA device")
    if args.cases:
        run_cases()
        return 0
    from . import minsum
    minsum.load_library("minsum_flood", rebuild=True)
    print(gpu_line(), flush=True)
    san = find_sanitizer()
    if san is None:
        print("compute-sanitizer: not found in this toolkit", flush=True)
        return 2
    bad = 0
    for tool in args.tools.split(","):
        cmd = [san, "--tool", tool, sys.executable, "-m",
               "ldpc_tpu_torch.kernels.sanitize_flood", "--cases"]
        print(f"$ {' '.join(cmd)}", flush=True)
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=1800)
        lines = (proc.stdout + proc.stderr).splitlines()
        for line in lines:
            if any(w in line for w in ("== plain", "ERROR SUMMARY",
                                       "not supported")):
                print(f"  {line.strip()}", flush=True)
        summary = [ln for ln in lines if "ERROR SUMMARY" in ln]
        errors = (int(re.search(r"(\d+) error", summary[-1]).group(1))
                  if summary else None)
        print(f"{tool}: exit {proc.returncode}, errors {errors}", flush=True)
        if proc.returncode != 0 or errors != 0:
            bad += 1
            print("\n".join(lines[-40:]), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
