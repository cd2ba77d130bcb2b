"""Single-device entry and multi-process dry run of the port (counterpart
of `__graft_entry__.py`'s `entry` and `dryrun_multichip`).

    python -m ldpc_tpu_torch.parallel.dryrun --world 2 --device cpu

entry(device) gives the flagship step (`wifi-648-r12-minsum`: encode ->
BPSK -> AWGN -> demap -> quantize -> decode -> counters) at B = 512 and
its arguments. dryrun_multichip(n, device) runs, in each rank of a world
of n processes, three steps over an (n / ici, ici) ("dcn", "ici") mesh:
the flagship step at 8n lanes, the two-point fused step, and the
streaming seam (a toy Z=8 code forced onto the streaming library at 128n
lanes, the all-zeros word), and holds each to the same step without a
mesh (equal counters). The command spawns the n ranks, which meet at a
file store in a temporary directory; on CUDA it builds the kernel
libraries first, so the ranks load them. It prints each rank's counters
and exits non-zero if any rank fails, disagrees or outlives `--timeout`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def _pipeline(batch: int, device: DeviceLike, mesh=None, n_points=1,
              cfg=None, backend="auto"):
    from ..codes import build_code, from_reference
    from ..config import PRESETS
    from ..sim import make_run_batch

    cfg = cfg or PRESETS["wifi-648-r12-minsum"]
    code = build_code(cfg)
    ct = from_reference(code, resolve_device(device))
    fn = make_run_batch(ct, cfg, batch=batch, n_points=n_points,
                        backend=backend, mesh=mesh)
    return fn, code


def _generator(device: DeviceLike, seed: int) -> torch.Generator:
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(seed)
    return g


def entry(device: DeviceLike = "cuda"):
    """-> (fn, args): the flagship step at B = 512 and its arguments."""
    from ..ops.channel import sigma_for
    fn, code = _pipeline(512, device)
    sigma = np.float32(sigma_for(2.0, code.rate, "bpsk"))
    return fn, (_generator(device, 0), sigma)


def _stream_cfg(n: int):
    from ..config import PRESETS
    cfg = PRESETS["wifi-648-r12-minsum"]
    return dataclasses.replace(
        cfg, code=dataclasses.replace(cfg.code, family="toy", Z=8),
        decoder=dataclasses.replace(cfg.decoder, schedule="layered",
                                    algorithm="offset-min-sum",
                                    early_term=False),
        quant=dataclasses.replace(cfg.quant, beta_lsb=2),
        run=dataclasses.replace(cfg.run, batch=128 * n, all_zeros=True))


def dryrun_multichip(n: int, device: DeviceLike = "cuda") -> Dict:
    """In each rank of a world of n processes (`parallel.init_distributed`
    first): the three steps over the mesh, each == the same step without
    a mesh. Returns {step: global counters}."""
    import torch.distributed as dist

    from ..ops.channel import sigma_for
    from .mesh import make_mesh

    if dist.get_world_size() != n:
        raise ValueError(f"dryrun_multichip({n}) in a world of "
                         f"{dist.get_world_size()}")
    ici = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh((n // ici, ici), ("dcn", "ici"), device=device)
    out = {}

    def hold(name, build, args, frames):
        """name's counters over the mesh and without it, equal."""
        got = build(mesh)(*args()).tolist()
        want = build(None)(*args()).tolist()
        total = sum(got[0]) if isinstance(got[0], list) else got[0]
        if got != want or total != frames:
            raise AssertionError(f"{name}: mesh {got} != one device {want} "
                                 f"(frames {frames})")
        out[name] = got

    # 1. the flagship step, 8 lanes a rank
    code = _pipeline(8 * n, device)[1]
    sigma = np.float32(sigma_for(2.0, code.rate, "bpsk"))
    hold("flagship", lambda m: _pipeline(8 * n, device, m)[0],
         lambda: (_generator(device, 1), sigma), 8 * n)
    # 2. the fused two-point step (lanes striped over the points)
    sig2 = np.asarray([sigma_for(e, code.rate, "bpsk") for e in (2.0, 3.0)],
                      np.float32)
    hold("fused", lambda m: _pipeline(8 * n, device, m, n_points=2)[0],
         lambda: (_generator(device, 2), sig2), 8 * n)
    # 3. the streaming seam: a toy code forced onto the streaming library
    scfg = _stream_cfg(n)

    def stream_step(m):
        fn = _pipeline(128 * n, device, m, cfg=scfg, backend="stream")[0]
        if "stream" not in fn.backend_label:
            raise AssertionError(f"streaming seam on {fn.backend_label}")
        return fn

    hold("stream", stream_step, lambda: (_generator(device, 3),
                                         np.float32(0.8)), 128 * n)
    out["labels"] = [_pipeline(8 * n, device, mesh)[0].backend_label,
                     stream_step(mesh).backend_label]
    return out


def _build_libraries() -> None:
    """Build (or find built) the libraries the dry run launches, before
    the ranks start, so that they only load them."""
    from concurrent.futures import ThreadPoolExecutor

    from ..kernels import minsum
    from ..kernels import minsum_stream as stream
    with ThreadPoolExecutor(len(minsum.SOURCES) + 1) as pool:
        jobs = [pool.submit(minsum.load_library, name)
                for name in minsum.SOURCES]
        jobs.append(pool.submit(stream.load_library))
        for job in jobs:
            job.result()


def _rank_main(a) -> int:
    from .mesh import init_distributed
    import torch.distributed as dist
    init_distributed(f"file://{a.store}", a.world, a.rank, device=a.device)
    try:
        out = dryrun_multichip(a.world, a.device)
        print(json.dumps({"rank": a.rank, **out}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def spawn(world: int, device: str, timeout: float = 300.0) -> List[Dict]:
    """Run dryrun_multichip(world) in `world` new processes; returns each
    rank's result. Raises if a rank fails, disagrees or times out."""
    if device == "cuda":
        resolve_device(device)
        _build_libraries()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ldpc_tpu_torch.parallel.dryrun",
             "--world", str(world), "--device", device, "--rank", str(r),
             "--store", store],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        results, failed = [], []
        try:
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=timeout)
                if p.returncode:
                    failed.append(f"rank {r} exit {p.returncode}:\n"
                                  f"{err[-4000:]}")
                else:
                    results.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if failed:
        raise RuntimeError("dry run failed: " + "\n".join(failed))
    first = {k: v for k, v in results[0].items() if k != "rank"}
    for res in results[1:]:
        if {k: v for k, v in res.items() if k != "rank"} != first:
            raise AssertionError(f"ranks disagree: {results}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ldpc_tpu_torch.parallel.dryrun",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--world", type=int, default=2,
                    help="processes (ranks) to spawn")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a rank may take")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank is not None:
        return _rank_main(a)
    for res in spawn(a.world, a.device, a.timeout):
        print(json.dumps(res), flush=True)
    print(f"dryrun_multichip({a.world}) ok", flush=True)
    return 0


if __name__ == "__main__":
    from .mesh import exit_process
    exit_process(main())
