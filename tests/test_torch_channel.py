"""The port's full channel set (ldpc_tpu_torch.ops.channel) against the JAX
ops, and the `qam16-1944-chain` slice (preset `multihost-qam-chain` on one
device: 802.11n n=1944 rate 3/4, Gray 16-QAM with max-log demapping, 8-bit
offset min-sum beta=2, layered, early termination) as a whole.

Tolerances. Symbols: 0. LLRs: 0, for every modulation, batch-first and
batch-last: both packages do the same float32 operations in the same order
(squared distances, minima masked with 1e30, (m1 - m0) / n0, n0 = 2 sigma
sigma), and neither XLA's CPU backend nor torch contracts them. The step on
injected draws: 0 on every counter. The CPU sweep, on its own
torch.Generator streams: FER and converged rate inside the Wilson interval
of the recorded waterfall, BER and iterations by per-frame z-tests."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.config as rcfg
from ldpc_tpu.ops import channel as jch
from ldpc_tpu.ops import decode_ref as jref
from ldpc_tpu.ops import encode as jenc
from ldpc_tpu.ops.quantize import quantize as jquantize
from ldpc_tpu_torch import PRESETS
from ldpc_tpu_torch.codes import build_code, from_reference
from ldpc_tpu_torch.ops import channel as tch
from ldpc_tpu_torch.sim import Sweep, make_run_batch, rates_compatible
from ldpc_tpu_torch.sim.pipeline import make_lane_step
from ldpc_tpu_torch.sim.stats import mean_compatible

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODS = list(jch.MODULATIONS)
NON_BPSK = [m for m in MODS if m != "bpsk"]
# qam16-1944-chain: the preset without its mesh, as bench.py runs it
QAM = dataclasses.replace(PRESETS["multihost-qam-chain"], run=dataclasses.replace(
    PRESETS["multihost-qam-chain"].run, mesh_shape=None))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def test_modulation_tables_equal_the_reference():
    assert tch.MODULATIONS == jch.MODULATIONS
    assert tch.BITS_PER_SYM == jch.BITS_PER_SYM
    assert tch.APSK_GAMMA == jch.APSK_GAMMA
    for mod in ("8psk", "16apsk", "32apsk"):
        for a, b in zip(tch._constellation(mod), jch._constellation(mod)):
            np.testing.assert_array_equal(a, b)
    for ba in (1, 2, 3):
        for a, b in zip(tch._gray_levels(ba), jch._gray_levels(ba)):
            np.testing.assert_array_equal(a, b)
        assert tch._axis_norm(ba) == jch._axis_norm(ba)


@pytest.mark.parametrize("mod", MODS)
@pytest.mark.parametrize("ebn0,rate", [(0.0, 0.5), (5.5, 0.75), (9.0, 5 / 6)])
def test_sigma_for_equals_the_reference(mod, ebn0, rate):
    assert tch.sigma_for(ebn0, rate, mod) == jch.sigma_for(ebn0, rate, mod)


@pytest.mark.parametrize("mod", MODS)
def test_modulate_equals_the_reference(rng, mod):
    m = tch.BITS_PER_SYM[mod]
    B, n = 24, 20 * m
    bits = rng.integers(0, 2, (B, n), dtype=np.uint8)
    x = tch.modulate(_t(bits), mod)
    assert x.dtype == torch.float32
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jch.modulate(jnp.asarray(bits), mod)))
    xt = tch.modulate_t(_t(bits.T), mod)
    np.testing.assert_array_equal(
        xt.numpy(), np.asarray(jch.modulate_t(jnp.asarray(bits.T), mod)))
    if mod == "bpsk":
        assert tuple(xt.shape) == (n, B)
        np.testing.assert_array_equal(xt.numpy(), x.numpy().T)
    else:
        # (nsym, 2, B) is (B, nsym, 2) with the batch moved last, unit Es
        assert tuple(xt.shape) == (n // m, 2, B)
        np.testing.assert_array_equal(xt.numpy(),
                                      np.moveaxis(x.numpy(), 0, -1))
        every = tch.modulate(_t(np.array(
            [[(i >> (m - 1 - b)) & 1 for b in range(m)]
             for i in range(1 << m)], np.uint8).reshape(1, -1)), mod)
        assert abs(float((every ** 2).sum(-1).mean()) - 1.0) < 1e-6


@pytest.mark.parametrize("lane_sigma", [False, True],
                         ids=["scalar-sigma", "lane-sigma"])
@pytest.mark.parametrize("mod", MODS)
def test_demap_equals_the_reference(rng, mod, lane_sigma):
    m = tch.BITS_PER_SYM[mod]
    B, n = 16, 30 * m
    bits = rng.integers(0, 2, (B, n), dtype=np.uint8)
    x = np.asarray(jch.modulate(jnp.asarray(bits), mod))
    sigma = (rng.uniform(0.04, 0.25, B).astype(np.float32) if lane_sigma
             else np.float32(0.11))
    sb = sigma.reshape((-1,) + (1,) * (x.ndim - 1)) if lane_sigma else sigma
    y = (x + sb * rng.standard_normal(x.shape)).astype(np.float32)
    yt = np.ascontiguousarray(np.moveaxis(y, 0, -1))
    llr = tch.demap(_t(y), sigma, mod)
    assert llr.dtype == torch.float32 and tuple(llr.shape) == (B, n)
    np.testing.assert_array_equal(
        llr.numpy(), np.asarray(jch.demap(jnp.asarray(y), sigma, mod)))
    llr_t = tch.demap_t(_t(yt), sigma, mod)
    assert tuple(llr_t.shape) == (n, B)
    np.testing.assert_array_equal(
        llr_t.numpy(), np.asarray(jch.demap_t(jnp.asarray(yt), sigma, mod)))
    # batch-last == transposed batch-first
    np.testing.assert_array_equal(llr_t.numpy(), llr.numpy().T)
    # the sign of an LLR is the bit where the noise is small
    assert ((llr.numpy() < 0) == bits.astype(bool)).mean() > 0.8
    if lane_sigma:
        # per-lane sigma == scalar sigma, lane by lane
        for b in (0, B - 1):
            one = tch.demap_t(_t(yt[..., b:b + 1]), sigma[b], mod)
            np.testing.assert_array_equal(one.numpy()[:, 0],
                                          llr_t.numpy()[:, b])


@pytest.mark.parametrize("mod", NON_BPSK)
def test_awgn_takes_symbol_shaped_noise(rng, mod):
    m = tch.BITS_PER_SYM[mod]
    B, n = 8, 6 * m
    x = tch.modulate_t(_t(rng.integers(0, 2, (n, B), dtype=np.uint8)), mod)
    noise = rng.standard_normal(tuple(x.shape)).astype(np.float32)
    sig = rng.uniform(0.2, 0.6, B).astype(np.float32)
    y = tch.awgn_t(None, x, sig, noise=_t(noise))
    np.testing.assert_array_equal(y.numpy(), x.numpy() + sig * noise)
    g = torch.Generator().manual_seed(1)
    y2 = tch.awgn_t(g, x, 0.5)
    assert y2.shape == x.shape and not torch.equal(y2, x)
    xb = tch.modulate(_t(rng.integers(0, 2, (B, n), dtype=np.uint8)), mod)
    nb = rng.standard_normal(tuple(xb.shape)).astype(np.float32)
    np.testing.assert_array_equal(
        tch.awgn(None, xb, sig, noise=_t(nb)).numpy(),
        xb.numpy() + sig[:, None, None] * nb)


@pytest.mark.parametrize("mod", NON_BPSK)
def test_ragged_symbol_count_is_refused(mod):
    m = tch.BITS_PER_SYM[mod]
    bits = torch.zeros((4, 5 * m + 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="do not fill"):
        tch.modulate(bits, mod)
    with pytest.raises(ValueError, match="do not fill"):
        tch.modulate_t(bits.T.contiguous(), mod)


def test_step_refuses_a_code_that_fills_no_symbols():
    """The reference's refusal (sim/pipeline.py:475): n=648 is no multiple
    of 32APSK's 5 bits; an unknown modulation is a ValueError too."""
    cfg = dataclasses.replace(
        PRESETS["wifi-648-r12-minsum"],
        channel=dataclasses.replace(PRESETS["wifi-648-r12-minsum"].channel,
                                    modulation="32apsk"))
    ct = from_reference(build_code(cfg), "cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        make_run_batch(ct, cfg, batch=8)
    bad = dataclasses.replace(cfg, channel=dataclasses.replace(
        cfg.channel, modulation="128qam"))
    with pytest.raises(ValueError, match="unknown modulation"):
        make_run_batch(ct, bad, batch=8)


def test_bsc_and_its_llrs(rng):
    bits = rng.integers(0, 2, (6, 50), dtype=np.uint8)
    flips = rng.integers(0, 2, (6, 50), dtype=np.uint8)
    y = tch.bsc(None, _t(bits), 0.1, flips=_t(flips))
    assert y.dtype == torch.uint8
    np.testing.assert_array_equal(y.numpy(), bits ^ flips)
    for p in (0.05, 0.2):
        got = tch.bsc_llr(y, p).numpy()
        want = np.asarray(jch.bsc_llr(jnp.asarray(y.numpy()), p))
        # one float32 log on each side: libm against XLA, an ulp apart at most
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
        assert ((got < 0) == y.numpy().astype(bool)).all()
    g = torch.Generator().manual_seed(3)
    big = torch.zeros((200, 500), dtype=torch.uint8)
    rate = float(tch.bsc(g, big, 0.1).float().mean())
    assert abs(rate - 0.1) < 0.005
    with pytest.raises(ValueError, match="Generator"):
        tch.bsc(None, big, 0.1)


# ---------------------------------------------------------------------------
# The qam16-1944-chain slice
# ---------------------------------------------------------------------------

def _jax_chain_counters(code, info_t, noise, sigma, cfg, ref_cfg):
    """The reference chain op by op (sim/pipeline.py's transposed step)."""
    B = info_t.shape[1]
    mod = cfg.channel.modulation
    x = jch.modulate_t(jenc.make_encoder_t(code)(jnp.asarray(info_t)), mod)
    y = x + jnp.float32(sigma) * jnp.asarray(noise)
    q = jquantize(jch.demap_t(y, sigma, mod), ref_cfg.quant)
    hard, iters, conv = map(np.asarray, jref.make_decoder(
        code, ref_cfg.decoder, ref_cfg.quant)(q.T))
    err = hard[:, : code.k] != info_t.T
    return [B, int(err.sum()), int(err.any(axis=1).sum()), int(iters.sum()),
            int(conv.sum())]


def test_qam16_step_matches_jax_chain(rng):
    from ldpc_tpu.codes.ieee80211n import make_code
    code = build_code(QAM)
    assert (code.n, code.k, code.Z) == (1944, 1458, 81)
    ct = from_reference(code, "cpu")
    B = 64
    info_t = rng.integers(0, 2, (code.k, B), dtype=np.uint8)
    noise = rng.standard_normal((code.n // 4, 2, B)).astype(np.float32)
    sigma = np.float32(tch.sigma_for(5.5, code.rate, "16qam"))
    rb = make_run_batch(ct, QAM, batch=B)
    assert rb.backend_label == "torch-plain-layered" and rb.decoder.counting
    assert not rb.mc
    got = rb(None, sigma, info_t=_t(info_t), noise=_t(noise))
    want = _jax_chain_counters(make_code(1944, "3/4"), info_t, noise, sigma,
                               QAM, rcfg.PRESETS["multihost-qam-chain"])
    assert got.tolist() == want
    assert 0 < want[2] < B and want[3] < 20 * B   # waterfall, early exits
    with pytest.raises(ValueError, match="noise must be"):
        rb(None, sigma, info_t=_t(info_t),
           noise=_t(noise.reshape(code.n // 2, B)))


def test_qam16_never_takes_the_megakernel():
    """rng="device" with 16-QAM runs the host chain, as in the reference."""
    cfg = dataclasses.replace(QAM, run=dataclasses.replace(QAM.run,
                                                           rng="device"))
    ct = from_reference(build_code(cfg), "cpu")
    rb = make_run_batch(ct, cfg, batch=8)
    assert not rb.mc and rb.backend_label == "torch-plain-layered"


def test_qam16_fused_lanes_match_single_points(rng):
    """Two sigma slots striped over the batch == each point alone."""
    ct = from_reference(build_code(QAM), "cpu")
    B = 16
    info_t = _t(rng.integers(0, 2, (ct.k, B), dtype=np.uint8))
    noise = _t(rng.standard_normal((ct.n // 4, 2, B)).astype(np.float32))
    sig = np.asarray([tch.sigma_for(e, ct.code.rate, "16qam")
                      for e in (5.0, 6.0)], np.float32)
    fused = make_lane_step(ct, QAM, batch=B, n_points=2)(
        None, sig, info_t=info_t, noise=noise)
    for s in range(2):
        one = make_lane_step(ct, QAM, batch=B)(None, sig[s], info_t=info_t,
                                               noise=noise)
        for a, b in zip(fused, one):
            assert torch.equal(a[s::2], b[s::2])


def test_qam16_cpu_sweep_lands_on_the_recorded_waterfall():
    """512 frames at 5.5 dB against results/qam16_1944_r34_oms.json
    (262,144 frames there)."""
    rec = json.load(open(os.path.join(ROOT, "results",
                                      "qam16_1944_r34_oms.json")))
    row = next(r for r in rec["results"] if r["ebn0_db"] == 5.5)
    frames = 512
    sweep = Sweep(QAM, device="cpu", batch=128)
    assert sweep.backend == "torch-plain-layered"
    p = sweep.run([5.5], target_frame_errors=10 ** 9,
                  max_frames=frames).points[0]
    assert p.frames == frames
    assert rates_compatible(p.frame_errs, p.frames, row["frame_errs"],
                            row["frames"])
    ref_conv = round(row["early_term_rate"] * row["frames"])
    assert rates_compatible(p.converged, p.frames, ref_conv, row["frames"])
    step = make_lane_step(sweep.ct, QAM, batch=sweep.batch)
    bits, _, iters, _ = step(sweep.generator(0, 0), sweep._sigma(5.5))
    assert mean_compatible(p.bit_errs, p.frames, row["bit_errs"],
                           row["frames"], float(bits.double().var()))
    ref_iters = row["avg_iters"] * row["frames"]
    assert mean_compatible(p.iter_sum, p.frames, ref_iters, row["frames"],
                           float(iters.double().var()))


def test_cli_runs_the_qam_preset_on_one_device(tmp_path):
    """`sweep --preset multihost-qam-chain` without --mesh: one device, the
    preset's (2, 4) mesh dropped and recorded as null, as bench.py's
    qam16-1944-chain has it; --mesh itself is refused until
    parallel/mesh.py is ported."""
    from ldpc_tpu_torch import cli
    out = str(tmp_path / "qam")
    base = ["sweep", "--preset", "multihost-qam-chain", "--device", "cpu",
            "--batch", "8", "--ebn0", "6.5", "--max-frames", "16"]
    assert cli.main(base + ["--out", out]) == 0
    got = json.load(open(out + ".json"))
    assert got["config"]["run"]["mesh_shape"] is None
    assert got["config"]["channel"]["modulation"] == "16qam"
    assert got["decoder_backend"] == "torch-plain-layered"
    assert got["results"][0]["frames"] == 16
    with pytest.raises(NotImplementedError, match="parallel/mesh.py"):
        cli.main(base + ["--mesh", "2x4"])
