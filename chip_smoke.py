#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (`ldpc_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. device: requires a CUDA device (never runs on the CPU) and prints the
   card's `nvidia-smi` name and power limit;
2. build: compiles `ldpc_tpu_torch/kernels/csrc/minsum_flood.cu` with nvcc
   for sm_90a, fresh, and prints the build time and ptxas' report;
3. kernel vs plain: the CUDA kernel against its plain torch version on the
   card, tolerance 0 on every output (an integer program): 802.11n n=648
   at 20 iterations and B=16,384 in hard-output and fused-IO modes, two
   smaller min-sum variants (offset beta=2, normalized alpha=3/4), and
   n=1944 rate 3/4 (Z=81);
4. the slice: `Sweep(PRESETS["wifi-648-r12-minsum"], device="cuda",
   batch=16384).run([1.5, 2.0, 2.5])` with 32,768 frames per point, BER and
   FER held to `results/wifi648_minsum.json` with rates_compatible (Wilson,
   z=2.576), and the kernel's launch counter read around the run;
5. times with CUDA events (warm-up, median): decode of one 16,384-codeword
   batch by the kernel and by the plain version, and the full step's
   decoded info bits/s.

Ends with one JSON line of kernel records and, last, the device line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PRESET = "wifi-648-r12-minsum"
REFERENCE = os.path.join(HERE, "results", "wifi648_minsum.json")
BATCH = 16384
POINTS = (1.5, 2.0, 2.5)
FRAMES_PER_POINT = 32768


def phase(name):
    print(f"== {name}", flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def import_port():
    sys.path.insert(0, HERE)
    import ldpc_tpu_torch
    pkg = os.path.dirname(os.path.abspath(ldpc_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"ldpc_tpu_torch imported from {pkg}, not from "
                           f"the checkout at {HERE}")
    return ldpc_tpu_torch


def mixed_llrs(rng, n, B, qmax=127):
    """int8 LLRs (n, B): half easy lanes (large |LLR|), half noisy."""
    x = rng.normal(0, 40, size=(n, B))
    x[:, : B // 2] = rng.normal(30, 25, size=(n, B // 2))
    return np.clip(np.round(x), -qmax, qmax).astype(np.int8)


def channel_llrs(rng, ct, B, scale, sigma=0.8):
    """float32 LLRs (n, B) of the all-zeros codeword over BPSK/AWGN, the
    first 64 values set to exact half-LSB points of the quantizer, and
    info bits (k, B): zeros for half the lanes (the sent word), random for
    the rest (scored against a different word)."""
    y = 1.0 + sigma * rng.standard_normal((ct.n, B))
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    llr.flat[:64] = (np.arange(64) - 32 + 0.5) / scale
    info = rng.integers(0, 2, (ct.k, B), dtype=np.uint8)
    info[:, : B // 2] = 0
    return llr, info


def max_abs_err(a, b):
    return max(float((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if x.numel() else 0.0 for x, y in zip(a, b))


def median_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def lane_bit_errors(sweep, snr_idx, ebn0_db):
    """Per-frame info-bit errors of batch 0 of one sweep point, re-drawn
    from the sweep's own generator through the step's own parts; fails
    unless their sum is the step's own bit-error counter."""
    from ldpc_tpu_torch.ops import channel as ch
    from ldpc_tpu_torch.ops.encode import make_encoder_t
    ct, B = sweep.ct, sweep.batch
    sigma = np.float32(ch.sigma_for(ebn0_db, sweep.code.rate, "bpsk"))
    g = sweep.generator(snr_idx, 0)
    info_t = torch.randint(0, 2, (ct.k, B), generator=g, device=ct.device,
                           dtype=torch.uint8)
    y = ch.awgn_t(g, ch.modulate_t(make_encoder_t(ct)(info_t), "bpsk"),
                  sigma)
    llr = ch.demap_t(y, sigma, "bpsk").reshape(ct.nb, ct.Z, B)
    bits = sweep.run_batch.decoder(llr, info_t.reshape(ct.kb, ct.Z, B))[0]
    step = sweep.run_batch(sweep.generator(snr_idx, 0), sigma).tolist()
    if int(bits.sum()) != step[1]:
        raise AssertionError("re-drawn batch differs from the step's own")
    return bits


def main():
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this check "
                           "runs on a CUDA device only")
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(gpu, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device_count {torch.cuda.device_count()}", flush=True)
    port = import_port()
    from ldpc_tpu_torch.codes import build_code, from_reference
    from ldpc_tpu_torch.kernels import minsum
    from ldpc_tpu_torch.sim import Sweep
    from ldpc_tpu_torch.sim.stats import (mean_compatible,
                                          rates_compatible)
    dev = torch.device("cuda")

    phase("build")
    lib = minsum.load_library(rebuild=True)
    print(f"nvcc sm_90a build of {minsum.SOURCE}: {lib.build_seconds:.2f} s "
          f"-> {os.path.relpath(lib.path, HERE)}", flush=True)
    for line in lib.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())

    phase("kernel vs plain (tolerance 0)")
    cfg = port.PRESETS[PRESET]
    rng = np.random.default_rng(2024)
    base_dec, base_q = cfg.decoder, cfg.quant
    oms = (dataclasses.replace(base_dec, algorithm="offset-min-sum"),
           dataclasses.replace(base_q, beta_lsb=2))
    nms = (dataclasses.replace(base_dec, algorithm="normalized-min-sum"),
           dataclasses.replace(base_q, alpha_num=3, alpha_shift=2))
    wifi = from_reference(build_code(cfg), dev)
    n1944 = from_reference(build_code(dataclasses.replace(
        cfg, code=dataclasses.replace(cfg.code, n=1944, rate="3/4"))), dev)
    cases = [  # (label, code, decoder cfg, quant cfg, B, fused)
        ("n648 min-sum hard B=16384", wifi, base_dec, base_q, BATCH, False),
        ("n648 min-sum fused-IO B=16384", wifi, base_dec, base_q, BATCH,
         True),
        ("n648 offset beta=2 hard B=2000", wifi, *oms, 2000, False),
        ("n648 normalized alpha=3/4 fused-IO B=1000", wifi, *nms, 1000,
         True),
        ("n1944 r3/4 min-sum hard B=4096", n1944, base_dec, base_q, 4096,
         False),
        ("n1944 r3/4 min-sum fused-IO B=4099", n1944, base_dec, base_q, 4099,
         True),
    ]
    worst = 0.0
    for label, ct, dc, qc, B, fused in cases:
        if fused:
            d = minsum.make_decoder(ct, dc, qc, input_scale=qc.scale,
                                    count_info_cols=ct.kb)
            llr, info = channel_llrs(rng, ct, B, qc.scale)
            args = (torch.as_tensor(llr).reshape(ct.nb, ct.Z, B).to(dev),
                    torch.as_tensor(info).reshape(ct.kb, ct.Z, B).to(dev))
        else:
            d = minsum.make_decoder(ct, dc, qc)
            args = (torch.as_tensor(mixed_llrs(rng, ct.n, B)).reshape(
                ct.nb, ct.Z, B).to(dev),)
        out_k = d.kernel(*args)
        torch.cuda.synchronize()
        out_p = d.plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(out_k, out_p)
        same = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
        lanes, smem = d.launch_config()
        conv = int(out_k[-1].sum())
        print(f"{label}: max_abs_err {err:g} equal {same} "
              f"(converged {conv}/{B}, {lanes} lanes/block, {smem} B smem)",
              flush=True)
        if not same:
            raise AssertionError(f"kernel != plain on {label}")
        worst = max(worst, err)

    phase("the slice")
    with open(REFERENCE) as f:
        ref = {r["ebn0_db"]: r for r in json.load(f)["results"]}
    sweep = Sweep(cfg, device="cuda", batch=BATCH)
    minsum.reset_counters()
    res = sweep.run(list(POINTS), target_frame_errors=10 ** 9,
                    max_frames=FRAMES_PER_POINT)
    torch.cuda.synchronize()
    launches, plain = minsum.kernel_launches, minsum.plain_calls
    print(f"backend {sweep.backend}: kernel_launches {launches}, "
          f"plain_calls {plain}", flush=True)
    if launches <= 0 or plain != 0:
        raise AssertionError("the slice did not run through the kernel only")
    k = sweep.code.k_eff
    for si, row in enumerate(res.rows()):
        r = ref[row["ebn0_db"]]
        ok_f = rates_compatible(row["frame_errs"], row["frames"],
                                r["frame_errs"], r["frames"])
        bits_wilson = rates_compatible(row["bit_errs"], row["frames"] * k,
                                       r["bit_errs"], r["frames"] * k)
        # BER: bit errors cluster in failed frames, so compare bit errors
        # per frame with their per-frame variance, from batch 0 re-drawn
        var = lane_bit_errors(sweep, si, row["ebn0_db"]).double().var()
        ok_b = mean_compatible(row["bit_errs"], row["frames"],
                               r["bit_errs"], r["frames"], float(var))
        print(f"Eb/N0 {row['ebn0_db']} dB: frames {row['frames']} "
              f"BER {row['ber']:.4e} ref {r['ber']:.4e} compatible {ok_b} "
              f"(per-frame z-test, sd {float(var) ** 0.5:.2f} bits/frame; "
              f"Wilson over bits {bits_wilson}); FER {row['fer']:.4e} "
              f"[{row['fer_lo']:.4e}, {row['fer_hi']:.4e}] ref "
              f"{r['fer']:.4e} [{r['fer_lo']:.4e}, {r['fer_hi']:.4e}] "
              f"compatible {ok_f}; avg_iters {row['avg_iters']} converged "
              f"{row['early_term_rate']:.4f}", flush=True)
        if row["frames"] < r["frames"] or not (ok_b and ok_f):
            raise AssertionError(f"slice disagrees with {REFERENCE} at "
                                 f"{row['ebn0_db']} dB")
        if not (np.isfinite(row["ber"]) and np.isfinite(row["fer"])):
            raise AssertionError("non-finite rates")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    if loaded:
        raise AssertionError(f"jax modules loaded: {loaded[:5]}")

    phase("times (CUDA events, median)")
    d = sweep.run_batch.decoder
    B = BATCH
    from ldpc_tpu_torch.ops.channel import sigma_for
    sig = np.float32(sigma_for(2.0, sweep.code.rate, "bpsk"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    # decode work does not depend on the data (fixed iterations): the
    # all-zeros codeword at 2.0 dB, scored against random info bits
    info_t = torch.randint(0, 2, (wifi.k, B), generator=gen, device=dev,
                           dtype=torch.uint8)
    y = 1.0 + float(sig) * torch.randn((wifi.n, B), generator=gen,
                                       device=dev)
    llr = 2.0 * y / float(sig * sig)
    args = (llr.reshape(wifi.nb, wifi.Z, B),
            info_t.reshape(wifi.kb, wifi.Z, B))
    for _ in range(3):
        d.kernel(*args)
    d.plain(*args)
    torch.cuda.synchronize()
    plain_t, kern_t = [], []
    for turn in ("plain", "kernel", "kernel", "plain"):
        if turn == "plain":
            plain_t += median_ms(lambda: d.plain(*args), 3)
        else:
            kern_t += median_ms(lambda: d.kernel(*args), 10)
    kern_ms, plain_ms = statistics.median(kern_t), statistics.median(plain_t)
    print(f"[{gpu}] decode of {B} codewords (fused-IO, 20 iterations): "
          f"kernel {kern_ms:.4f} ms (runs {len(kern_t)}, min "
          f"{min(kern_t):.4f}, max {max(kern_t):.4f}), plain "
          f"{plain_ms:.4f} ms (runs {len(plain_t)}, min {min(plain_t):.4f}, "
          f"max {max(plain_t):.4f})", flush=True)

    rb = sweep.run_batch
    step_gen = sweep.generator(0, 0)
    for _ in range(3):
        rb(step_gen, sig)
    torch.cuda.synchronize()
    step_s = []
    for _ in range(10):
        t0 = time.perf_counter()
        rb(step_gen, sig).tolist()
        step_s.append(time.perf_counter() - t0)
    step = statistics.median(step_s)
    bps = B * wifi.k / step
    print(f"[{gpu}] full step (encode, channel, decode, counters) of {B} "
          f"codewords: {step * 1e3:.4f} ms median of {len(step_s)} (min "
          f"{min(step_s) * 1e3:.4f}, max {max(step_s) * 1e3:.4f}) -> "
          f"{bps:.6e} decoded info bits/s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "minsum_flood", "route": "cuda", "source": minsum.SOURCE,
        "replaces": minsum.REPLACES, "launches": launches,
        "max_abs_err": worst, "ms": kern_ms, "plain_ms": plain_ms}]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
