#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (`ldpc_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. device: requires a CUDA device (never runs on the CPU) and prints the
   card's `nvidia-smi` name and power limit;
2. build: compiles both kernel libraries fresh with nvcc for sm_90a, at
   the same time (`minsum_flood.cu`: K1/K1-IO/K2; `minsum_layered.cu`:
   K3), and prints each build's time and ptxas' register/spill report;
3. kernel vs plain: each CUDA kernel against its plain torch version on
   the card, tolerance 0 on every output (an integer program). Flooding,
   fixed iterations (K1, K1-IO): 802.11n n=648 at B=16,384 in hard-output
   and fused-IO modes, offset beta=2, normalized alpha=3/4, n=1944 rate
   3/4. Flooding with early termination (K2): n=648 at 2.0 dB fused-IO
   B=16,384, offset beta=2 with max_iter 1. Layered (K3): n=1944 rate 5/6
   OMS at 3.0 dB fused-IO B=16,384 with early termination, the same code
   at 20 fixed iterations with B=4,099, n=648 normalized alpha=3/4 with
   max_iter 7, n=1944 rate 3/4 fused-IO. An all-zero noiseless batch
   through K2 and K3 must give iters 0 and converged on every lane;
4. slice 1: `Sweep(PRESETS["wifi-648-r12-minsum"], device="cuda",
   batch=16384).run([1.5, 2.0, 2.5])`, 32,768 frames per point, against
   `results/wifi648_minsum.json`;
5. slice 2: `Sweep(PRESETS["wifi-full-oms"], device="cuda",
   batch=16384).run([3.0, 3.5])` with AUTO two-phase, 131,072 frames per
   point, against `results/wifi12_1944_r56.json`: FER and the converged
   rate by Wilson intervals (z=2.576), BER and average iterations by
   per-frame z-tests with the variances of batch 0, re-drawn;
   then two-phase == single-phase counters on one batch at 3.5 dB.
   Each slice reads the kernel launch counters reset just before it;
6. times: kernels with CUDA events (warm-up, median, plain and kernel in
   turns), steps with the host clock and a sync (info bits/s).

Ends with one JSON line of kernel records, the nvidia-smi line, and, last,
the device line {"ok": true, "device": {"platform": "gpu", ...}}.
"""
import concurrent.futures
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
BATCH = 16384
SLICES = (  # (preset, reference file, points, frames per point)
    ("wifi-648-r12-minsum", "wifi648_minsum.json", (1.5, 2.0, 2.5), 32768),
    ("wifi-full-oms", "wifi12_1944_r56.json", (3.0, 3.5), 131072),
)


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


def event_ms(fn, reps):
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


def kernel_vs_plain_ms(d, args, gpu, what, kernel_reps=10, plain_reps=3):
    """Median ms of d.kernel and d.plain on args, in turns (plain, kernel,
    kernel, plain) after a warm-up; prints and returns both."""
    for _ in range(3):
        d.kernel(*args)
    d.plain(*args)
    torch.cuda.synchronize()
    plain_t, kern_t = [], []
    for turn in ("plain", "kernel", "kernel", "plain"):
        if turn == "plain":
            plain_t += event_ms(lambda: d.plain(*args), plain_reps)
        else:
            kern_t += event_ms(lambda: d.kernel(*args), kernel_reps)
    kern_ms, plain_ms = statistics.median(kern_t), statistics.median(plain_t)
    print(f"[{gpu}] {what}: kernel {kern_ms:.4f} ms (runs {len(kern_t)}, "
          f"min {min(kern_t):.4f}, max {max(kern_t):.4f}), plain "
          f"{plain_ms:.4f} ms (runs {len(plain_t)}, min {min(plain_t):.4f}, "
          f"max {max(plain_t):.4f})", flush=True)
    return kern_ms, plain_ms


def step_seconds(rb, gen, sigma, reps=10):
    for _ in range(3):
        rb(gen, sigma)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        rb(gen, sigma).tolist()
        out.append(time.perf_counter() - t0)
    return out


def lane_values(sweep, snr_idx, ebn0_db):
    """Per-frame info-bit errors and iterations of batch 0 of one sweep
    point, re-drawn from the sweep's own generator through the step's own
    parts; fails unless their sums are the step's own counters."""
    from ldpc_tpu_torch.ops.channel import sigma_for
    from ldpc_tpu_torch.sim.pipeline import make_lane_step
    step = make_lane_step(sweep.ct, sweep.cfg, batch=sweep.batch)
    sigma = np.float32(sigma_for(ebn0_db, sweep.code.rate, "bpsk"))
    bits, _, iters, _ = step(sweep.generator(snr_idx, 0), sigma)
    want = sweep.run_batch(sweep.generator(snr_idx, 0), sigma).tolist()
    if [int(bits.sum()), int(iters.sum())] != [want[1], want[3]]:
        raise AssertionError("re-drawn batch differs from the step's own")
    return bits.double(), iters.double()


def check_slice(port, minsum, preset, ref_name, points, frames):
    """Runs one preset's sweep on the card and holds it to its recorded
    waterfall; returns (sweep, launches of each library in this run)."""
    from ldpc_tpu_torch.sim import Sweep
    from ldpc_tpu_torch.sim.stats import (mean_compatible, rates_compatible,
                                          wilson_interval)
    with open(os.path.join(HERE, "results", ref_name)) as f:
        ref = {r["ebn0_db"]: r for r in json.load(f)["results"]}
    sweep = Sweep(port.PRESETS[preset], device="cuda", batch=BATCH)
    minsum.reset_counters()
    res = sweep.run(list(points), target_frame_errors=10 ** 9,
                    max_frames=frames)
    torch.cuda.synchronize()
    launches = dict(minsum.library_launches)
    plain = minsum.plain_calls
    print(f"{preset}: backend {sweep.backend}; kernel launches {launches}, "
          f"plain_calls {plain}", flush=True)
    lib = minsum.LIBRARIES[sweep.cfg.decoder.schedule]
    if launches[lib] <= 0 or plain != 0:
        raise AssertionError(f"{preset} did not run through {lib} only")
    k = sweep.code.k_eff
    for si, row in enumerate(res.rows()):
        r = ref[row["ebn0_db"]]
        ok_f = rates_compatible(row["frame_errs"], row["frames"],
                                r["frame_errs"], r["frames"])
        ok_c = rates_compatible(round(row["early_term_rate"] * row["frames"]),
                                row["frames"],
                                round(r["early_term_rate"] * r["frames"]),
                                r["frames"])
        bits_wilson = rates_compatible(row["bit_errs"], row["frames"] * k,
                                       r["bit_errs"], r["frames"] * k)
        # BER and iterations cluster in failed frames: compare per-frame
        # means with their per-frame variance, from batch 0 re-drawn
        bits, iters = lane_values(sweep, si, row["ebn0_db"])
        ok_b = mean_compatible(row["bit_errs"], row["frames"],
                               r["bit_errs"], r["frames"], float(bits.var()))
        ok_i = mean_compatible(row["avg_iters"] * row["frames"],
                               row["frames"], r["avg_iters"] * r["frames"],
                               r["frames"], float(iters.var()))
        ref_lo, ref_hi = wilson_interval(r["frame_errs"], r["frames"])
        auto = sweep.auto_choice.get(si)
        print(f"  Eb/N0 {row['ebn0_db']} dB: frames {row['frames']} "
              f"BER {row['ber']:.4e} ref {r['ber']:.4e} compatible {ok_b} "
              f"(per-frame z-test, sd {float(bits.var()) ** 0.5:.2f} "
              f"bits/frame; Wilson over bits {bits_wilson}); FER "
              f"{row['fer']:.4e} [{row['fer_lo']:.4e}, {row['fer_hi']:.4e}] "
              f"ref {r['fer']:.4e} [{ref_lo:.4e}, {ref_hi:.4e}] "
              f"compatible {ok_f}; avg_iters {row['avg_iters']:.4f} ref "
              f"{r['avg_iters']:.4f} compatible {ok_i} (sd "
              f"{float(iters.var()) ** 0.5:.2f}); converged "
              f"{row['early_term_rate']:.6f} ref {r['early_term_rate']:.6f} "
              f"compatible {ok_c}"
              + (f"; AUTO (p1, cap) = {auto}" if auto else ""), flush=True)
        if row["frames"] < min(r["frames"], frames) or not (
                ok_b and ok_f and ok_i and ok_c):
            raise AssertionError(f"{preset} disagrees with {ref_name} at "
                                 f"{row['ebn0_db']} dB")
        if not (np.isfinite(row["ber"]) and np.isfinite(row["fer"])):
            raise AssertionError("non-finite rates")
    return sweep, launches


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
    from ldpc_tpu_torch.ops.channel import sigma_for
    from ldpc_tpu_torch.sim import make_run_batch
    dev = torch.device("cuda")

    phase("build (both libraries at once)")
    libs = list(minsum.SOURCES)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(
            lambda name: minsum.load_library(name, rebuild=True), libs))
    for name, lib in zip(libs, built):
        print(f"nvcc sm_90a build of {minsum.SOURCES[name]}: "
              f"{lib.build_seconds:.2f} s -> "
              f"{os.path.relpath(lib.path, HERE)}", flush=True)
        for line in lib.ptxas_log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                print("  ptxas:", line.strip())

    phase("kernel vs plain (tolerance 0)")
    cfg648 = port.PRESETS["wifi-648-r12-minsum"]
    oms_cfg = port.PRESETS["wifi-full-oms"]
    rng = np.random.default_rng(2024)
    base_dec, base_q = cfg648.decoder, cfg648.quant
    oms = (dataclasses.replace(base_dec, algorithm="offset-min-sum"),
           dataclasses.replace(base_q, beta_lsb=2))
    nms = (dataclasses.replace(base_dec, algorithm="normalized-min-sum"),
           dataclasses.replace(base_q, alpha_num=3, alpha_shift=2))
    et = dict(early_term=True)

    def dec_cfg(d, **kw):
        return dataclasses.replace(d, **kw)

    def code(n, rate):
        return from_reference(build_code(dataclasses.replace(
            cfg648, code=dataclasses.replace(cfg648.code, n=n,
                                             rate=rate))), dev)

    wifi, n1944, r56 = code(648, "1/2"), code(1944, "3/4"), code(1944, "5/6")
    lay = oms_cfg.decoder                     # layered OMS, ET, 20 iterations
    lay_q = oms_cfg.quant
    sig = {(ct, db): float(sigma_for(db, ct.code.rate, "bpsk"))
           for ct, db in ((r56, 3.0), (r56, 3.5), (wifi, 2.0), (n1944, 3.0))}
    cases = [  # (label, code, decoder cfg, quant cfg, B, fused, sigma)
        ("K1 n648 min-sum hard B=16384", wifi, base_dec, base_q, BATCH,
         False, None),
        ("K1-IO n648 min-sum fused-IO B=16384", wifi, base_dec, base_q,
         BATCH, True, 0.8),
        ("K1 n648 offset beta=2 hard B=2000", wifi, *oms, 2000, False, None),
        ("K1-IO n648 normalized alpha=3/4 fused-IO B=1000", wifi, *nms, 1000,
         True, 0.8),
        ("K1 n1944 r3/4 min-sum hard B=4096", n1944, base_dec, base_q, 4096,
         False, None),
        ("K1-IO n1944 r3/4 min-sum fused-IO B=4099", n1944, base_dec, base_q,
         4099, True, 0.8),
        ("K3 n1944 r5/6 OMS ET fused-IO 3.0 dB B=16384", r56, lay, lay_q,
         BATCH, True, sig[r56, 3.0]),
        ("K3 n1944 r5/6 OMS fixed-20 hard B=4099", r56,
         dec_cfg(lay, early_term=False), lay_q, 4099, False, None),
        ("K3 n648 normalized alpha=3/4 ET max_iter 7 hard B=2000", wifi,
         dec_cfg(nms[0], schedule="layered", max_iter=7, **et), nms[1], 2000,
         False, None),
        ("K3 n1944 r3/4 OMS ET fused-IO 3.0 dB B=4096", n1944, lay, lay_q,
         4096, True, sig[n1944, 3.0]),
        ("K2 n648 min-sum ET fused-IO 2.0 dB B=16384", wifi,
         dec_cfg(base_dec, **et), base_q, BATCH, True, sig[wifi, 2.0]),
        ("K2 n648 offset beta=2 ET max_iter 1 hard B=3000", wifi,
         dec_cfg(oms[0], max_iter=1, **et), oms[1], 3000, False, None),
    ]
    worst = dict.fromkeys(libs, 0.0)
    for label, ct, dc, qc, B, fused, sigma in cases:
        if fused:
            d = minsum.make_decoder(ct, dc, qc, input_scale=qc.scale,
                                    count_info_cols=ct.kb)
            llr, info = channel_llrs(rng, ct, B, qc.scale, sigma)
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
        iters = out_k[-2].double()
        print(f"{label}: max_abs_err {err:g} equal {same} (converged "
              f"{conv}/{B}, mean iters {float(iters.mean()):.3f}, "
              f"{d.library} {lanes} lanes/block, {smem} B smem)", flush=True)
        if not same:
            raise AssertionError(f"kernel != plain on {label}")
        worst[d.library] = max(worst[d.library], err)
    for ct, dc in ((wifi, dec_cfg(base_dec, **et)), (r56, lay)):
        B = 1000
        d = minsum.make_decoder(ct, dc, lay_q, input_scale=4.0,
                                count_info_cols=ct.kb)
        zero = (torch.full((ct.nb, ct.Z, B), 2.0, device=dev),
                torch.zeros((ct.kb, ct.Z, B), dtype=torch.uint8, device=dev))
        bits, frame, iters, conv = d.kernel(*zero)
        torch.cuda.synchronize()
        ok = (int(iters.abs().sum()) == 0 and bool(conv.all())
              and int(bits.sum()) == 0 and int(frame.sum()) == 0)
        print(f"all-zero noiseless {d.library} n={ct.n} B={B}: iters 0 and "
              f"converged on every lane {ok}", flush=True)
        if not ok:
            raise AssertionError(f"{d.library} all-zero batch: iters "
                                 f"{iters.unique().tolist()}")

    phase("slice 1 and slice 2 (sweeps against recorded waterfalls)")
    sweeps, launches = {}, {}
    for preset, ref_name, points, frames in SLICES:
        sweeps[preset], launches[preset] = check_slice(
            port, minsum, preset, ref_name, points, frames)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    if loaded:
        raise AssertionError(f"jax modules loaded: {loaded[:5]}")

    phase("two-phase == single-phase on the card (wifi-full-oms, 3.5 dB)")
    oms_sweep = sweeps["wifi-full-oms"]
    s35 = np.float32(sigma_for(3.5, r56.code.rate, "bpsk"))
    p1, frac = oms_sweep.auto_choice.get(1, (None, None))
    cfg2 = dataclasses.replace(oms_cfg, decoder=dataclasses.replace(
        oms_cfg.decoder, phase1_iters=p1 or 4, phase2_frac=frac or 0.25))
    rb2 = make_run_batch(oms_sweep.ct, cfg2, batch=BATCH)
    rb1 = oms_sweep.run_batch
    for b in range(2):
        c1 = rb1(oms_sweep.generator(1, b), s35).tolist()
        c2 = rb2(oms_sweep.generator(1, b), s35).tolist()
        print(f"batch {b}: single-phase {c1} two-phase ({rb2.backend_label}, "
              f"p1 {cfg2.decoder.phase1_iters}, capacity "
              f"{rb2.decoder.capacity}) {c2} equal {c1 == c2}", flush=True)
        if c1 != c2 or not rb2.backend_label.endswith("-2phase"):
            raise AssertionError("two-phase counters differ on the card")

    phase("times (CUDA events for kernels, host clock + sync for steps)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    timing = {}

    def fused_args(ct, sigma):
        info_t = torch.randint(0, 2, (ct.k, BATCH), generator=gen,
                               device=dev, dtype=torch.uint8)
        y = 1.0 + sigma * torch.randn((ct.n, BATCH), generator=gen,
                                      device=dev)
        llr = 2.0 * y / (sigma * sigma)
        return (llr.reshape(ct.nb, ct.Z, BATCH),
                info_t.reshape(ct.kb, ct.Z, BATCH))

    # K1: the canonical decode (all-zeros word at 2.0 dB scored against
    # random info bits; the work does not depend on the data)
    k1 = sweeps["wifi-648-r12-minsum"].run_batch.decoder
    timing["K1"] = kernel_vs_plain_ms(
        k1, fused_args(wifi, sig[wifi, 2.0]), gpu,
        f"K1-IO decode of {BATCH} codewords (n648, fused-IO, 20 iterations)")
    k2 = minsum.make_decoder(wifi, dec_cfg(base_dec, **et), base_q,
                             input_scale=4.0, count_info_cols=wifi.kb)
    timing["K2"] = kernel_vs_plain_ms(
        k2, fused_args(wifi, sig[wifi, 2.0]), gpu,
        f"K2 decode of {BATCH} codewords (n648 min-sum, ET, fused-IO, "
        f"2.0 dB)")
    k3 = oms_sweep.run_batch.decoder
    for db in (3.0, 3.5):
        timing[f"K3 {db}"] = kernel_vs_plain_ms(
            k3, fused_args(r56, sig[r56, db]), gpu,
            f"K3 decode of {BATCH} codewords (n1944 r5/6 OMS, ET, fused-IO, "
            f"{db} dB)")
    k3f = minsum.make_decoder(r56, dec_cfg(lay, early_term=False), lay_q,
                              input_scale=4.0, count_info_cols=r56.kb)
    timing["K3 fixed"] = kernel_vs_plain_ms(
        k3f, fused_args(r56, sig[r56, 3.0]), gpu,
        f"K3 decode of {BATCH} codewords (n1944 r5/6 OMS, 20 fixed "
        f"iterations, fused-IO, 3.0 dB)")

    def report_step(name, rb, generator, sigma, k):
        st = step_seconds(rb, generator, sigma)
        med = statistics.median(st)
        print(f"[{gpu}] {name} step ({rb.backend_label}) of {BATCH} "
              f"codewords: {med * 1e3:.4f} ms median of {len(st)} (min "
              f"{min(st) * 1e3:.4f}, max {max(st) * 1e3:.4f}) -> "
              f"{BATCH * k / med:.6e} decoded info bits/s", flush=True)

    s648 = sweeps["wifi-648-r12-minsum"]
    report_step("wifi-648-r12-minsum 2.0 dB", s648.run_batch,
                s648.generator(0, 0), np.float32(sig[wifi, 2.0]), wifi.k)
    auto_rb = oms_sweep.tuned_run_batch(1, s35)
    for turn in ("single", "auto", "auto", "single"):
        report_step(f"wifi-full-oms 3.5 dB {turn}-phase",
                    rb1 if turn == "single" else auto_rb,
                    oms_sweep.generator(1, 0), s35, r56.k)

    print(json.dumps({"kernels": [
        {"name": "minsum_flood", "route": "cuda",
         "source": minsum.SOURCES["minsum_flood"],
         "replaces": minsum.REPLACES["minsum_flood"],
         "launches": launches["wifi-648-r12-minsum"]["minsum_flood"],
         "max_abs_err": worst["minsum_flood"], "ms": timing["K1"][0],
         "plain_ms": timing["K1"][1]},
        {"name": "minsum_layered", "route": "cuda",
         "source": minsum.SOURCES["minsum_layered"],
         "replaces": minsum.REPLACES["minsum_layered"],
         "launches": launches["wifi-full-oms"]["minsum_layered"],
         "max_abs_err": worst["minsum_layered"], "ms": timing["K3 3.0"][0],
         "plain_ms": timing["K3 3.0"][1]}]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
