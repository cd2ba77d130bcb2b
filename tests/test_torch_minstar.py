"""min* (K5) in the port: the plain decoders (ldpc_tpu_torch.ops.decode_ref,
the plain version of csrc/cn_minstar.cuh) against golden and the JAX QC
decoder, the wrapper's CPU path against the Pallas kernel in interpret
mode, and the `wifi-648-minstar` slice (802.11n n=648 rate 1/2, BPSK, 8-bit
min*, layered, early termination, beta_lsb=0) as a whole.

Every integer output is compared with tolerance 0: box-plus with its
per-combine clip is an integer program whose grouping is part of the
result. The one float stage, the megakernel's prologue on injected words,
has the tolerance of tests/test_torch_mc.py (one LSB on at most 1e-4 of
the LLRs, torch's libm against XLA's); lanes with equal LLRs must agree
exactly. The CUDA kernel runs only on a GPU: chip_smoke.py holds it to
these plain versions there."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.config as rcfg
from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.qcstruct import qc_encode_numpy
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.golden.decoder import decode_fixed
from ldpc_tpu.ops import channel as jch
from ldpc_tpu.ops import decode_qc as jqc
from ldpc_tpu.ops import encode as jenc
from ldpc_tpu.ops.quantize import quantize as jquantize
from ldpc_tpu_torch import (PRESETS, DecoderConfig, QuantConfig,
                            minstar_thresholds)
from ldpc_tpu_torch.codes import build_code, from_reference
from ldpc_tpu_torch.kernels import minsum
from ldpc_tpu_torch.ops import channel as tch
from ldpc_tpu_torch.ops import decode_ref as tref
from ldpc_tpu_torch.ops import rng as trng
from ldpc_tpu_torch.ops.mc import gain_for, make_prologue
from ldpc_tpu_torch.sim import Sweep, make_run_batch
from ldpc_tpu_torch.sim.pipeline import use_mc

torch.set_num_threads(2)

# bench.py's wifi-648-minstar: the canonical code with the min* CN update
_C = PRESETS["wifi-648-r12-minsum"]
MINSTAR = dataclasses.replace(
    _C, quant=dataclasses.replace(_C.quant, beta_lsb=0),
    decoder=dataclasses.replace(_C.decoder, algorithm="min-star",
                                schedule="layered", early_term=True))
# (thresholds, bits): the scale-4 LUT, no correction, a 6-bit quantizer
VARIANTS = {"T830": ((8, 3, 0), 8), "Tnone": ((), 8), "T830-6bit": ((8, 3, 0),
                                                                    6)}


def _channel_llrs(rng, B, n, sigma, qmax, scale=4.0):
    """Integer LLRs of the all-zeros codeword over BPSK/AWGN; lane 0 clean."""
    y = 1.0 + sigma * rng.standard_normal((B, n))
    y[0] = 1.0
    return np.clip(np.round(2 * y / sigma ** 2 * scale), -qmax,
                   qmax).astype(np.int8)


def _golden(chan, code, **kw):
    rs = [decode_fixed(row.astype(np.int32), code, **kw) for row in chan]
    return (np.stack([r.hard for r in rs]), np.array([r.iters for r in rs]),
            np.array([r.converged for r in rs]))


def _assert_equal(got, *wants):
    for want in wants:
        for g, w in zip(got, want):
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))


@functools.lru_cache(maxsize=None)
def _jax_qc(n, rate, schedule, max_iter, early_term, T, qmax=127):
    """The JAX QC min* decoder of an 802.11n code; compiling one takes
    longer than any decode here, so tests share them."""
    return jqc.make_qc_decoder(make_code(n, rate), schedule=schedule,
                               max_iter=max_iter, qmax=qmax,
                               early_term=early_term, minstar=T)


def _plain(code, schedule, **kw):
    maker = (tref.make_layered_decoder if schedule == "layered"
             else tref.make_flooding_decoder)
    return maker(code, **kw)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("early_term", [False, True], ids=["fixed", "et"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_plain_minstar_toy_matches_golden_and_jax_qc(rng, schedule,
                                                     early_term, variant):
    T, bits = VARIANTS[variant]
    qmax = (1 << (bits - 1)) - 1
    code = toy_qc(8)
    chan = _channel_llrs(rng, 24, code.n, 0.9, qmax)
    kw = dict(max_iter=7, qmax=qmax, early_term=early_term, minstar=T)
    out = _plain(code, schedule, **kw)(torch.as_tensor(chan))
    assert out[0].dtype == torch.uint8 and out[1].dtype == torch.int32
    want_qc = jqc.make_qc_decoder(code, schedule=schedule, **kw)(
        jnp.asarray(chan))
    _assert_equal(out, _golden(chan, code, schedule=schedule, **kw), want_qc)
    if early_term:
        assert out[1][0] == 0 and out[2][0]
        assert 0 < int(out[2].sum()) and int(out[1].max()) > 1


@pytest.mark.parametrize("schedule,early_term,variant,with_jax", [
    ("layered", True, "T830", True), ("layered", False, "T830", False),
    ("flooding", True, "T830", False),
    ("flooding", False, "T830-6bit", True),
    ("layered", True, "T830-6bit", False), ("layered", True, "Tnone", False)])
def test_plain_minstar_wifi648_matches_golden_and_jax_qc(
        rng, schedule, early_term, variant, with_jax):
    """Row degrees 7 and 8; the 6-bit cases saturate often, which is where
    two pad slots combining to qmax instead of the identity would show.
    Golden in every case, the JAX QC decoder in two."""
    T, bits = VARIANTS[variant]
    qmax = (1 << (bits - 1)) - 1
    code = make_code(648, "1/2")
    chan = _channel_llrs(rng, 4, code.n, 0.78, qmax)
    kw = dict(max_iter=5, qmax=qmax, early_term=early_term, minstar=T)
    out = _plain(code, schedule, **kw)(torch.as_tensor(chan))
    _assert_equal(out, _golden(chan, code, schedule=schedule, **kw))
    if with_jax:
        _assert_equal(out, _jax_qc(648, "1/2", schedule, 5, early_term, T,
                                   qmax)(jnp.asarray(chan)))


def test_plain_minstar_wifi1944_r56_matches_golden_and_jax_qc(rng):
    """Row degree 20 (n=1944 rate 5/6), layered with early termination."""
    code = make_code(1944, "5/6")
    assert max(len(a) for a in code.cn_adj) == 20
    sigma = float(np.sqrt(1 / (2 * code.rate * 10 ** 0.3)))
    chan = _channel_llrs(rng, 16, code.n, sigma, 127)
    kw = dict(max_iter=6, qmax=127, early_term=True, minstar=(8, 3, 0))
    out = tref.make_layered_decoder(code, **kw)(torch.as_tensor(chan))
    _assert_equal(out, _jax_qc(1944, "5/6", "layered", 6, True, (8, 3, 0))(
        jnp.asarray(chan)))
    _assert_equal([o[1:3] for o in out],
                  _golden(chan[1:3], code, schedule="layered", **kw))
    assert 0 < int(out[2].sum()) and int(out[1].min()) < int(out[1].max())


def test_empty_thresholds_are_min_sum(rng):
    """T=() keeps the per-combine clip but no correction: exclude-self
    sign-min, which is plain min-sum (golden pins the same)."""
    code = toy_qc(8)
    chan = torch.as_tensor(_channel_llrs(rng, 16, code.n, 0.9, 127))
    for schedule in ("flooding", "layered"):
        a = _plain(code, schedule, max_iter=5, minstar=())(chan)
        b = _plain(code, schedule, max_iter=5, beta=0)(chan)
        _assert_equal(a, b)


def test_boxplus_pins():
    """The pinned arithmetic on single pairs: the LUT at scale 4, the
    per-combine clip, and a zero magnitude forgetting its sign."""
    T = (8, 3, 0)

    def bp(x, y, qmax=127):
        return int(tref._boxplus2(torch.tensor(x, dtype=torch.int32),
                                  torch.tensor(y, dtype=torch.int32), T,
                                  qmax))
    assert bp(5, 5) == 5 + 0 - 3          # c(10) = 0, c(0) = 3
    assert bp(1, -1) == 0                 # 1 + c(2)=2 - c(0)=3 -> 0, sign lost
    assert bp(-1, 1) == 0
    assert bp(3, -4) == -(3 + 1 - 2)      # c(7) = 1, c(1) = 2
    assert bp(200, -300, qmax=31) == -31  # clipped at every combine
    assert bp(tref._MINSTAR_INF, -9) == -9
    out = tref._cn_update_minstar(
        torch.tensor([[[7, 0, 0, 0]]], dtype=torch.int32),
        torch.tensor([[[True, False, False, False]]]), T, 127)
    assert out.tolist() == [[[127, 0, 0, 0]]]   # a degree-1 row gives +qmax


def test_minstar_composes_with_neither_beta_nor_alpha():
    code = toy_qc(4)
    for maker in (tref.make_flooding_decoder, tref.make_layered_decoder):
        with pytest.raises(ValueError, match="beta/alpha"):
            maker(code, beta=1, minstar=(8, 3, 0))
        with pytest.raises(ValueError, match="beta/alpha"):
            maker(code, alpha=(3, 2), minstar=(8, 3, 0))
    # the config-level factories take min* without offset, whatever
    # quant.beta_lsb says, as the reference's do
    ct = from_reference(code, "cpu")
    d = minsum.make_decoder(ct, DecoderConfig(algorithm="min-star"),
                            QuantConfig(beta_lsb=2))
    assert (d.beta, d.alpha, d.minstar) == (0, None, (8, 3, 0))
    assert d.star_deg == max(len(r) for r in ct.entries)
    assert minsum.make_decoder(ct, DecoderConfig(),
                               QuantConfig()).star_deg == 0
    # more thresholds than the kernel's parameters hold are refused
    assert len(minstar_thresholds(QuantConfig(scale=16.0))) > 8
    with pytest.raises(ValueError, match="thresholds"):
        minsum.make_decoder(ct, DecoderConfig(algorithm="min-star"),
                            QuantConfig(scale=16.0))


def _to_t(chan, ct):
    """(B, n) -> the kernel layout (nb, Z, B)."""
    return torch.as_tensor(np.ascontiguousarray(chan.T)).reshape(
        ct.nb, ct.Z, chan.shape[0])


@pytest.mark.parametrize("schedule,early_term", [("layered", True),
                                                 ("flooding", False)])
def test_wrapper_matches_pallas_interpret_toy4(rng, schedule, early_term):
    """The wrapper's CPU path (batch last) against the Pallas min* kernel in
    interpret mode, pre-transposed layout, on the small toy code."""
    from ldpc_tpu.kernels.minsum_pallas import make_pallas_decoder
    code = toy_qc(4)
    ct = from_reference(code, "cpu")
    B = 8
    chan = _channel_llrs(rng, B, code.n, 0.9, 127)
    pallas = make_pallas_decoder(code, qmax=127, schedule=schedule,
                                 early_term=early_term, max_iter=5,
                                 batch_tile=4, interpret=True,
                                 pre_transposed=True, minstar=(8, 3, 0))
    want = pallas(jnp.asarray(_to_t(chan, ct).numpy()))
    dec = minsum.make_decoder(
        ct, DecoderConfig(algorithm="min-star", schedule=schedule,
                          max_iter=5, early_term=early_term),
        QuantConfig(beta_lsb=0))
    plain = minsum.plain_calls
    got = dec(_to_t(chan, ct))
    assert minsum.plain_calls == plain + 1
    _assert_equal(got, want)


@pytest.mark.slow
@pytest.mark.parametrize("schedule,early_term",
                         [("layered", True), ("layered", False),
                          ("flooding", True), ("flooding", False)])
def test_wrapper_matches_pallas_interpret(schedule, early_term):
    """As tests/test_minstar.py runs the Pallas kernel: toy Z=8, a 6-bit
    quantizer, 8 iterations, through either package's make_decoder."""
    from ldpc_tpu.kernels.minsum_pallas import make_decoder as make_pl
    code = toy_qc(8)
    kw = dict(algorithm="min-star", max_iter=8, schedule=schedule,
              early_term=early_term)
    qkw = dict(bits=6, scale=4.0, beta_lsb=0)
    chan = np.random.default_rng(7).integers(
        -25, 25, size=(16, code.n)).astype(np.int8)
    want = make_pl(code, rcfg.DecoderConfig(**kw), rcfg.QuantConfig(**qkw),
                   batch_tile=16, interpret=True)(jnp.asarray(chan))
    ct = from_reference(code, "cpu")
    hard, iters, conv = minsum.make_decoder(
        ct, DecoderConfig(**kw), QuantConfig(**qkw))(_to_t(chan, ct))
    _assert_equal((hard.reshape(code.n, -1).T, iters, conv), want)


def test_wrapper_fused_io_counts_equal_the_hard_path(rng):
    """Fused IO with min*: float LLRs quantized in the decoder and per-lane
    error counts out equal quantize -> decode -> count by hand."""
    code = make_code(648, "1/2")
    ct = from_reference(code, "cpu")
    B = 12
    llr = (2 / 0.8 ** 2 * (1 + 0.8 * rng.standard_normal((code.n, B)))
           ).astype(np.float32)
    info = np.zeros((code.k, B), np.uint8)
    dc = DecoderConfig(algorithm="min-star", schedule="layered", max_iter=6,
                       early_term=True)
    q = QuantConfig(beta_lsb=0)
    fused = minsum.make_decoder(ct, dc, q, input_scale=4.0,
                                count_info_cols=ct.kb)
    bits, frame, iters, conv = fused(
        torch.as_tensor(llr).reshape(ct.nb, ct.Z, B),
        torch.as_tensor(info).reshape(ct.kb, ct.Z, B))
    chan = np.asarray(jquantize(jnp.asarray(llr), rcfg.QuantConfig(
        beta_lsb=0)))
    hard, it2, cv2 = _jax_qc(648, "1/2", "layered", 6, True, (8, 3, 0))(
        jnp.asarray(chan.T))
    err = np.asarray(hard)[:, : code.k] != info.T
    _assert_equal((bits, frame, iters, conv),
                  (err.sum(1), err.any(1), it2, cv2))


# ---------------------------------------------------------------------------
# The wifi-648-minstar slice
# ---------------------------------------------------------------------------

def _ref_cfg(cfg):
    return rcfg.SimConfig.from_json(cfg.to_json())


@pytest.mark.parametrize("ebn0", [1.5, 2.0])
def test_minstar_step_matches_jax_chain(rng, ebn0):
    code = make_code(648, "1/2")
    ct = from_reference(build_code(MINSTAR), "cpu")
    B = 128
    info_t = rng.integers(0, 2, (code.k, B), dtype=np.uint8)
    noise = rng.standard_normal((code.n, B)).astype(np.float32)
    sigma = np.float32(tch.sigma_for(ebn0, code.rate, "bpsk"))
    rb = make_run_batch(ct, MINSTAR, batch=B)
    assert rb.backend_label == "torch-plain-minstar-layered"
    assert rb.decoder.counting and not rb.mc
    got = rb(None, sigma, info_t=torch.as_tensor(info_t),
             noise=torch.as_tensor(noise))
    ref = _ref_cfg(MINSTAR)
    x = jch.modulate_t(jenc.make_encoder_t(code)(jnp.asarray(info_t)),
                       "bpsk")
    y = x + jnp.float32(sigma) * jnp.asarray(noise)
    q = jquantize(jch.demap_t(y, sigma, "bpsk"), ref.quant)
    assert (ref.decoder.algorithm, ref.quant.beta_lsb) == ("min-star", 0)
    assert rcfg.minstar_thresholds(ref.quant) == (8, 3, 0)
    hard, iters, conv = map(np.asarray, _jax_qc(
        648, "1/2", "layered", 20, True, (8, 3, 0))(q.T))
    err = hard[:, : code.k] != info_t.T
    want = [B, int(err.sum()), int(err.any(axis=1).sum()), int(iters.sum()),
            int(conv.sum())]
    assert got.tolist() == want
    assert want[2] < B and B < want[3] < 20 * B   # early exits
    if ebn0 == 1.5:
        assert want[2] > 0                        # in the waterfall


def _reference_q(code, words, sigma, gain, qmax=127):
    """The reference megakernel's formula (tests/test_kernels.py:355-383)
    on injected words: info bits, qc_encode_numpy, Box-Muller, quantize."""
    Z, nb = code.Z, code.base.shape[1]
    k, nph, _ = trng.word_layout(code.k // Z, nb, Z)
    B = words.shape[1]

    def to_unit(w):
        wu = jax.lax.bitcast_convert_type(w, jnp.uint32)
        si = jax.lax.bitcast_convert_type(
            jax.lax.shift_right_logical(wu, jnp.uint32(8)), jnp.int32)
        return (si.astype(jnp.float32) * jnp.float32(2.0 ** -24)
                + jnp.float32(2.0 ** -25))

    info = (words[:k].view(np.uint32) & 1).astype(np.uint8)
    cw = qc_encode_numpy(code, info.T).T
    f1 = to_unit(jnp.asarray(words[k: k + nph * Z].reshape(nph, Z, B)))
    f2 = to_unit(jnp.asarray(words[k + nph * Z:].reshape(nph, Z, B)))
    r = jnp.sqrt(jnp.float32(-2.0) * jnp.log(f1))
    th = jnp.float32(2.0 * np.pi) * f2
    nrm = jnp.stack([r * jnp.cos(th), r * jnp.sin(th)], axis=1).reshape(
        2 * nph, Z, B)[:nb]
    xf = (jnp.float32(1.0) - jnp.float32(2.0)
          * jnp.asarray(cw.reshape(nb, Z, B), jnp.int32).astype(jnp.float32))
    xs = (xf + jnp.asarray(sigma, jnp.float32) * nrm) * jnp.asarray(
        gain, jnp.float32)
    q = jnp.where(xs >= 0, jnp.floor(xs + 0.5), jnp.ceil(xs - 0.5))
    q = np.asarray(jnp.clip(q, -qmax, qmax).astype(jnp.int8))
    return info, q.reshape(nb * Z, B)


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_minstar_device_rng_takes_the_megakernel(rng, schedule):
    """min* with rng="device" selects the megakernel (BPSK, identity info
    prefix, encodable parity), and its plain version on injected words
    equals the reference's formula plus the JAX min* decoder."""
    cfg = dataclasses.replace(
        MINSTAR, run=dataclasses.replace(MINSTAR.run, rng="device"),
        decoder=dataclasses.replace(MINSTAR.decoder, schedule=schedule,
                                    max_iter=6))
    code = make_code(648, "1/2")
    ct = from_reference(build_code(cfg), "cpu")
    assert use_mc(ct, cfg)
    B, sigma = 96, np.float32(0.8)
    rb = make_run_batch(ct, cfg, batch=B)
    want_label = "torch-plain-minstar" + ("-layered" if schedule == "layered"
                                          else "") + "-mc"
    assert rb.mc and rb.backend_label == want_label
    assert isinstance(rb.decoder, minsum.McDecoder)
    gain = gain_for(sigma, 4.0)
    W = trng.word_layout(ct.kb, ct.nb, ct.Z)[2]
    words = rng.integers(0, 1 << 32, (W, B), dtype=np.uint32).view(np.int32)
    assert not rb.decoder.inject_random     # the step draws from Philox
    d = minsum.make_decoder(ct, cfg.decoder, cfg.quant, input_scale=4.0,
                            count_info_cols=ct.kb, mc_batch=B,
                            inject_random=True)
    bits, frame, iters, conv = (x.numpy() for x in d(
        None, sigma, gain, words=torch.as_tensor(words)))
    info, q_ref = _reference_q(code, words, sigma, gain)
    q_t = make_prologue(ct.code, 127)(torch.as_tensor(words), sigma,
                                      gain)[2].numpy()
    diff = q_t.astype(np.int64) - q_ref
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 1e-4
    same = (diff == 0).all(axis=0)
    assert same.sum() >= B - 2
    hard, it_r, cv_r = map(np.asarray, _jax_qc(
        648, "1/2", schedule, 6, True, (8, 3, 0))(jnp.asarray(q_ref.T)))
    err = hard[:, : code.k] != info.T
    for got, want in ((bits, err.sum(1)), (frame, err.any(1)),
                      (iters, it_r), (conv, cv_r)):
        np.testing.assert_array_equal(got[same],
                                      np.asarray(want)[same].astype(got.dtype))
    assert 0 < int(conv.sum()) <= B
    # and the step itself runs off the Philox stream, reproducibly
    a = rb(12345, sigma)
    assert a.tolist() == rb(12345, sigma).tolist() and a[0] == B


def test_minstar_cpu_sweep_runs_both_rng_modes():
    for rng_mode, label in (("host", "torch-plain-minstar-layered"),
                            ("device", "torch-plain-minstar-layered-mc")):
        cfg = dataclasses.replace(MINSTAR, run=dataclasses.replace(
            MINSTAR.run, rng=rng_mode))
        sweep = Sweep(cfg, device="cpu", batch=64)
        assert sweep.backend == label
        p = sweep.run([2.0], target_frame_errors=10 ** 9,
                      max_frames=128).points[0]
        assert p.frames == 128 and 0 < p.converged <= 128
        assert 128 < p.iter_sum < 20 * 128
