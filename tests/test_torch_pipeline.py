"""The port's simulation step and sweep (ldpc_tpu_torch.sim) against the JAX
reference, and the port's isolation from JAX.

With the random draws injected, one step of the port must equal the JAX
chain built from the same arrays counter for counter (tolerance 0). With
its own torch.Generator streams the port is held to the JAX sweep
statistically."""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.config import PRESETS
from ldpc_tpu.ops import channel as jch
from ldpc_tpu.ops import decode_ref as jref
from ldpc_tpu.ops import encode as jenc
from ldpc_tpu.ops.quantize import quantize as jquantize
from ldpc_tpu_torch.codes import from_reference
from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.kernels import minsum
from ldpc_tpu_torch.ops import channel as tch
from ldpc_tpu_torch.ops.encode import make_encoder_t
from ldpc_tpu_torch.sim import (BatchCounters, Sweep, make_run_batch,
                                rates_compatible)
from ldpc_tpu_torch.sim.stats import mean_compatible
from ldpc_tpu_torch.sim.sweep import batch_seed

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = PRESETS["wifi-648-r12-minsum"]


def _jax_chain_counters(code, info_t, noise, sigma, quant, max_iter):
    """The reference chain op by op: make_encoder_t -> modulate_t -> x +
    sigma * noise -> demap_t -> quantize -> make_flooding_decoder -> counts."""
    B = info_t.shape[1]
    x = jch.modulate_t(jenc.make_encoder_t(code)(jnp.asarray(info_t)),
                       "bpsk")
    y = x + jnp.float32(sigma) * jnp.asarray(noise)
    q = jquantize(jch.demap_t(y, sigma, "bpsk"), quant)
    hard, iters, conv = map(np.asarray, jref.make_flooding_decoder(
        code, max_iter=max_iter, beta=0, qmax=quant.qmax,
        early_term=False)(q.T))
    err = hard[:, : code.k] != info_t.T
    return [B, int(err.sum()), int(err.any(axis=1).sum()), int(iters.sum()),
            int(conv.sum())]


@pytest.mark.parametrize("ebn0", [1.5, 2.0])
def test_run_batch_matches_jax_chain(rng, ebn0):
    """The slice as a whole: wifi-648, 20 iterations, B=256."""
    code = make_code(648, "1/2")
    ct = from_reference(code, "cpu")
    B = 256
    info_t = rng.integers(0, 2, (code.k, B), dtype=np.uint8)
    noise = rng.standard_normal((code.n, B)).astype(np.float32)
    sigma = np.float32(tch.sigma_for(ebn0, code.rate, "bpsk"))
    rb = make_run_batch(ct, CFG, batch=B)
    assert rb.backend_label == "torch-plain" and rb.decoder.counting
    got = rb(None, sigma, info_t=torch.as_tensor(info_t),
             noise=torch.as_tensor(noise))
    assert got.dtype == torch.int64 and got.shape == (5,)
    want = _jax_chain_counters(code, info_t, noise, sigma, CFG.quant, 20)
    assert got.tolist() == want
    assert 0 < want[2] < B          # in the waterfall: some frames fail


def test_run_batch_hard_output_path_matches_fused(rng):
    """Codes whose info bits are not the identity prefix decode to hard bits
    and count outside the decoder; the counters are the same."""
    code = make_code(648, "1/2")
    ct = from_reference(code, "cpu")
    B = 64
    info_t = torch.as_tensor(rng.integers(0, 2, (code.k, B), dtype=np.uint8))
    noise = torch.as_tensor(
        rng.standard_normal((code.n, B)).astype(np.float32))
    sigma = np.float32(0.84)
    fused = make_run_batch(ct, CFG, batch=B)
    hard = make_run_batch(dataclasses.replace(ct, ident_info=False), CFG,
                          batch=B)
    assert fused.decoder.counting and not hard.decoder.counting
    a = fused(None, sigma, info_t=info_t, noise=noise)
    b = hard(None, sigma, info_t=info_t, noise=noise)
    assert a.tolist() == b.tolist()


def test_run_batch_generator_streams(rng):
    ct = from_reference(make_code(648, "1/2"), "cpu")
    rb = make_run_batch(ct, CFG, batch=32)
    sigma = np.float32(0.9)

    def run(seed):
        return rb(torch.Generator().manual_seed(seed), sigma).tolist()

    assert run(1) == run(1)
    assert run(1) != run(2)
    with pytest.raises(ValueError, match="Generator"):
        rb(None, sigma)
    with pytest.raises(ValueError, match="info_t"):
        rb(None, sigma, info_t=torch.zeros((ct.k, 31), dtype=torch.uint8))


def _lane_bit_errors(sweep, snr_idx, ebn0):
    """Per-frame bit errors of batch 0 of a sweep point, re-drawn from the
    sweep's own generator through the step's parts."""
    ct, B = sweep.ct, sweep.batch
    sigma = np.float32(tch.sigma_for(ebn0, sweep.code.rate, "bpsk"))
    g = sweep.generator(snr_idx, 0)
    info_t = torch.randint(0, 2, (ct.k, B), generator=g, dtype=torch.uint8)
    y = tch.awgn_t(g, tch.modulate_t(make_encoder_t(ct)(info_t), "bpsk"),
                   sigma)
    llr = tch.demap_t(y, sigma, "bpsk").reshape(ct.nb, ct.Z, B)
    return sweep.run_batch.decoder(llr, info_t.reshape(ct.kb, ct.Z, B))[0]


def test_sweep_cpu_matches_jax_sweep_statistically():
    """A small CPU sweep at 2.0 dB against the JAX sweep on CPU: FER by
    Wilson intervals, BER by a per-frame z-test (bit errors cluster in
    failed frames)."""
    from ldpc_tpu.sim import Sweep as JaxSweep
    frames = 1024
    port = Sweep(CFG, device="cpu", batch=512)
    p = port.run([2.0], target_frame_errors=10 ** 9,
                 max_frames=frames).points[0]
    ref = JaxSweep(CFG, decoder_backend="jnp", batch=512).run(
        [2.0], target_frame_errors=10 ** 9, max_frames=frames).points[0]
    assert p.frames == ref.frames == frames
    assert rates_compatible(p.frame_errs, p.frames, ref.frame_errs,
                            ref.frames)
    var = float(_lane_bit_errors(port, 0, 2.0).double().var())
    assert mean_compatible(p.bit_errs, p.frames, ref.bit_errs, ref.frames,
                           var)
    assert 0 < p.frame_errs < frames and p.iter_sum == 20 * frames


def test_sweep_reproducible_and_bounded():
    cfg = dataclasses.replace(CFG, run=dataclasses.replace(CFG.run, seed=3))
    a = Sweep(cfg, device="cpu", batch=64)
    r1 = a.run([1.0, 3.0], target_frame_errors=5, max_frames=256)
    r2 = Sweep(cfg, device="cpu", batch=64).run(
        [1.0, 3.0], target_frame_errors=5, max_frames=256)
    assert [vars(p) | {"wall_s": 0} for p in r1.points] == \
        [vars(p) | {"wall_s": 0} for p in r2.points]
    low, high = r1.points
    assert low.batches == 1 and low.frame_errs >= 5     # target reached
    assert high.frames == 256 and high.batches == 4     # budget spent
    assert r1.decoder_backend == "torch-plain"


def test_sweep_result_uses_results_schema():
    res = Sweep(CFG, device="cpu", batch=32).run(
        [2.0], target_frame_errors=1, max_frames=32)
    mine = json.loads(res.to_json())
    with open(os.path.join(ROOT, "results", "wifi648_minsum.json")) as f:
        ref = json.load(f)
    assert set(mine) == set(ref)
    assert set(mine["results"][0]) == set(ref["results"][0])
    assert mine["config"] == json.loads(CFG.to_json())
    assert (mine["k"], mine["n"]) == (324, 648)


def test_batch_seed():
    seeds = {batch_seed(0, s, b) for s in range(4) for b in range(64)}
    assert len(seeds) == 256
    assert batch_seed(5, 1, 2) == batch_seed(5, 1, 2) != batch_seed(6, 1, 2)
    assert all(0 <= s < 2 ** 64 for s in seeds)


def test_batch_counters():
    a = BatchCounters(1, 2, 3, 4, 5)
    assert a + BatchCounters.zero() == a
    assert a + a == BatchCounters(2, 4, 6, 8, 10)


def _cfg(**sections):
    return dataclasses.replace(CFG, **{
        k: dataclasses.replace(getattr(CFG, k), **v)
        for k, v in sections.items()})


@pytest.mark.parametrize("cfg,label", [
    (_cfg(decoder=dict(schedule="layered")), "torch-plain-layered"),
    (_cfg(decoder=dict(early_term=True)), "torch-plain"),
])
def test_layered_and_early_term_configs_run(cfg, label):
    """Layered (K3) and early-terminating (K2) configurations, once refused,
    run through the plain decoders on CPU."""
    sweep = Sweep(cfg, device="cpu", batch=32)
    assert sweep.backend == label
    assert sweep.run_batch.decoder.library == minsum.LIBRARIES[
        cfg.decoder.schedule]
    p = sweep.run([2.0], target_frame_errors=10 ** 9,
                  max_frames=64).points[0]
    assert p.frames == 64 and 0 < p.converged <= 64
    if cfg.decoder.early_term:
        assert p.iter_sum < 20 * 64
    else:
        assert p.iter_sum == 20 * 64


@pytest.mark.parametrize("cfg,match", [
    (_cfg(decoder=dict(algorithm="min-star")), "K5"),
    (_cfg(decoder=dict(algorithm="sum-product")), "item 12"),
    (_cfg(channel=dict(modulation="16qam")), "item 11"),
    (_cfg(code=dict(punct_frac=0.25)), "item 13"),
    (_cfg(run=dict(all_zeros=True)), "batch-first"),
    (_cfg(run=dict(rng="device")), "K1-MC"),
])
def test_configs_outside_the_slice_raise(cfg, match):
    with pytest.raises(NotImplementedError, match=match):
        Sweep(cfg, device="cpu", batch=32)


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="fall back"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="fall back"):
        Sweep(CFG, device="cuda", batch=32)
    with pytest.raises(RuntimeError, match="fall back"):
        from_reference(make_code(648, "1/2"), "cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_decoder_dispatch_never_falls_back_to_plain(monkeypatch, rng):
    """A CUDA-looking tensor goes to the kernel entry, never the plain
    version: with no card the kernel entry raises instead."""
    ct = from_reference(make_code(648, "1/2"), "cpu")
    dec = make_run_batch(ct, CFG, batch=4).decoder
    llr = torch.zeros((ct.nb, ct.Z, 4)).to("meta")
    info = torch.zeros((ct.kb, ct.Z, 4), dtype=torch.uint8).to("meta")
    plain = minsum.plain_calls
    with pytest.raises(ValueError, match="CUDA tensors"):
        dec(llr, info)
    assert minsum.plain_calls == plain


def test_port_runs_without_loading_jax():
    """Import the port and run a tiny CPU sweep in a fresh interpreter: no
    jax module may be loaded by it (some hosts pre-import jax from
    sitecustomize, so compare sys.modules before and after)."""
    code = (
        "import sys\n"
        "before = {m for m in sys.modules if m.split('.')[0] == 'jax'}\n"
        "import ldpc_tpu_torch\n"
        "from ldpc_tpu_torch.sim import Sweep\n"
        "import torch; torch.set_num_threads(1)\n"
        "r = Sweep(ldpc_tpu_torch.PRESETS['wifi-648-r12-minsum'],"
        " device='cpu', batch=16).run([2.0], max_frames=16)\n"
        "assert r.points[0].frames == 16\n"
        "after = {m for m in sys.modules if m.split('.')[0] == 'jax'}\n"
        "print(sorted(after - before))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ldpc_tpu modules that pull in JAX when imported
JAX_PULLING = ("jax", "jaxlib", "ldpc_tpu.sim", "ldpc_tpu.ops",
               "ldpc_tpu.kernels", "ldpc_tpu.parallel", "ldpc_tpu.utils",
               "ldpc_tpu.cli")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = [os.path.join(d, f)
             for d, _, fs in os.walk(os.path.join(ROOT, "ldpc_tpu_torch"))
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            assert not any(mod == p or mod.startswith(p + ".")
                           for p in JAX_PULLING), (path, mod)
    smoke = set(_imports(os.path.join(ROOT, "chip_smoke.py")))
    assert not any(m.split(".")[0] == "ldpc_tpu" for m in smoke), smoke
