"""The wifi-full-oms slice as a whole: 802.11n n=1944 rate 5/6, BPSK,
8-bit offset min-sum (beta=2), layered, early termination, AUTO two-phase
(preset `wifi-full-oms`), through the port's step and sweep on the CPU.

With the random draws injected, one step must equal the JAX chain with
`make_layered_decoder` counter for counter (tolerance 0). With its own
torch.Generator streams the sweep is held to the JAX sweep statistically:
FER by Wilson intervals, BER and average iterations by per-frame
z-tests (both cluster in failed frames)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.config import PRESETS
from ldpc_tpu.ops import channel as jch
from ldpc_tpu.ops import decode_ref as jref
from ldpc_tpu.ops import encode as jenc
from ldpc_tpu.ops.quantize import quantize as jquantize
from ldpc_tpu_torch.codes import build_code, from_reference
from ldpc_tpu_torch.ops import channel as tch
from ldpc_tpu_torch.sim import Sweep, make_run_batch, rates_compatible
from ldpc_tpu_torch.sim.pipeline import make_lane_step
from ldpc_tpu_torch.sim.stats import mean_compatible

torch.set_num_threads(2)

CFG = PRESETS["wifi-full-oms"]


def _jax_chain_counters(code, info_t, noise, sigma, cfg):
    """The reference chain op by op with the layered decoder."""
    B = info_t.shape[1]
    x = jch.modulate_t(jenc.make_encoder_t(code)(jnp.asarray(info_t)),
                       "bpsk")
    y = x + jnp.float32(sigma) * jnp.asarray(noise)
    q = jquantize(jch.demap_t(y, sigma, "bpsk"), cfg.quant)
    hard, iters, conv = map(np.asarray, jref.make_decoder(
        code, cfg.decoder, cfg.quant)(q.T))
    err = hard[:, : code.k] != info_t.T
    return [B, int(err.sum()), int(err.any(axis=1).sum()), int(iters.sum()),
            int(conv.sum())]


def test_run_batch_matches_jax_chain(rng):
    code = build_code(CFG)
    assert (code.n, code.k) == (1944, 1620)
    ct = from_reference(code, "cpu")
    B = 256
    info_t = rng.integers(0, 2, (code.k, B), dtype=np.uint8)
    noise = rng.standard_normal((code.n, B)).astype(np.float32)
    sigma = np.float32(tch.sigma_for(3.0, code.rate, "bpsk"))
    rb = make_run_batch(ct, CFG, batch=B)
    # the AUTO sentinel builds the single-phase decoder outside a sweep
    assert rb.backend_label == "torch-plain-layered" and rb.decoder.counting
    got = rb(None, sigma, info_t=torch.as_tensor(info_t),
             noise=torch.as_tensor(noise))
    want = _jax_chain_counters(code, info_t, noise, sigma, CFG)
    assert got.tolist() == want
    assert 0 < want[2] < B and want[3] < 20 * B   # waterfall, early exits


def test_two_phase_run_batch_matches_single_phase(rng):
    """A fixed two-phase build of the preset on the same injected draws."""
    code = build_code(CFG)
    ct = from_reference(code, "cpu")
    B = 128
    info_t = torch.as_tensor(rng.integers(0, 2, (code.k, B), dtype=np.uint8))
    noise = torch.as_tensor(rng.standard_normal((code.n, B)).astype(
        np.float32))
    sigma = np.float32(tch.sigma_for(3.5, code.rate, "bpsk"))
    cfg2 = dataclasses.replace(CFG, decoder=dataclasses.replace(
        CFG.decoder, phase1_iters=4, phase2_frac=0.25))
    rb2 = make_run_batch(ct, cfg2, batch=B)
    assert rb2.backend_label == "torch-plain-layered-2phase"
    rb1 = make_run_batch(ct, CFG, batch=B)
    a = rb1(None, sigma, info_t=info_t, noise=noise)
    b = rb2(None, sigma, info_t=info_t, noise=noise)
    assert a.tolist() == b.tolist()


def _lanes(sweep, snr_idx, ebn0):
    """Per-frame (bit errors, iterations) of batch 0 of a sweep point,
    re-drawn from the sweep's own generator."""
    step = make_lane_step(sweep.ct, sweep.cfg, batch=sweep.batch)
    sigma = np.float32(tch.sigma_for(ebn0, sweep.code.rate, "bpsk"))
    bits, _, iters, _ = step(sweep.generator(snr_idx, 0), sigma)
    return bits.double(), iters.double()


@pytest.mark.parametrize("ebn0", [3.0])
def test_sweep_cpu_matches_jax_sweep_statistically(ebn0):
    from ldpc_tpu.sim import Sweep as JaxSweep
    frames = 512
    port = Sweep(CFG, device="cpu", batch=256)
    p = port.run([ebn0], target_frame_errors=10 ** 9,
                 max_frames=frames).points[0]
    ref = JaxSweep(CFG, decoder_backend="jnp", batch=256).run(
        [ebn0], target_frame_errors=10 ** 9, max_frames=frames).points[0]
    assert p.frames == ref.frames == frames
    assert rates_compatible(p.frame_errs, p.frames, ref.frame_errs,
                            ref.frames)
    assert rates_compatible(p.converged, p.frames, ref.converged,
                            ref.frames)
    bits, iters = _lanes(port, 0, ebn0)
    assert mean_compatible(p.bit_errs, p.frames, ref.bit_errs, ref.frames,
                           float(bits.var()))
    assert mean_compatible(p.iter_sum, p.frames, ref.iter_sum, ref.frames,
                           float(iters.var()))
    assert 0 < p.frame_errs < frames and p.iter_sum < 20 * frames
