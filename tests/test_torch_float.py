"""The port's float decoders (ldpc_tpu_torch.ops.decode_ref:
`make_float_decoder`, `make_layered_float_decoder`) and float mode in the
batch-first step, on the CPU.

Equality strategy, as tests/test_float_layered.py: the min-sum family is
min/abs/sign/add, so on integer-valued float32 inputs (offset 0.5, factor
0.75) every intermediate is exact in float32 and in golden's float64, and
the contract is equality of `hard`, `iters` and `conv` between the port, the
JAX decoder and `golden.decode_float`: tolerance 0. Sum-product runs a
tanh/atanh chain whose last bits differ between libraries: the port and
the JAX decoder must agree on every frame's `conv` and `iters` and on every
hard bit of the frames that converged (a frame that fails keeps posteriors
near 0, whose signs a rounding may flip); on the inputs below they agree on
every frame outright, which the test states."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.config as rcfg
from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.golden.decoder import decode_float
from ldpc_tpu.ops import channel as jch
from ldpc_tpu.ops import decode_ref as jref
from ldpc_tpu.ops import encode as jenc
from ldpc_tpu.sim.pipeline import select_decoder as ref_select_decoder
from ldpc_tpu.sim.sweep import build_code as ref_build_code
from ldpc_tpu_torch.codes import (build_code, config_from_reference,
                                  from_reference, own_code)
from ldpc_tpu_torch.ops import channel as tch
from ldpc_tpu_torch.ops import decode_ref as tref
from ldpc_tpu_torch.sim import Sweep, make_run_batch

torch.set_num_threads(2)

MIN_SUM_CASES = [
    dict(algorithm="min-sum", beta=0.0, early_term=False, max_iter=5),
    dict(algorithm="min-sum", beta=0.0, early_term=True, max_iter=6),
    dict(algorithm="offset-min-sum", beta=0.5, early_term=True, max_iter=5),
    dict(algorithm="normalized-min-sum", beta=0.75, early_term=True,
         max_iter=5),
]


def _int_llrs(rng, B, n, lo=-40, hi=40):
    return rng.integers(lo, hi, size=(B, n)).astype(np.float32)


def _golden(chan, code, **kw):
    rs = [decode_float(row.astype(np.float64), code, **kw) for row in chan]
    return (np.stack([r.hard for r in rs]), np.array([r.iters for r in rs]),
            np.array([r.converged for r in rs]))


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(g.numpy().dtype))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("kw", MIN_SUM_CASES,
                         ids=lambda kw: f"{kw['algorithm']}-{kw['beta']}-"
                                        f"{'et' if kw['early_term'] else 'fixed'}")
def test_float_min_sum_family_equals_jax_and_golden(schedule, kw):
    code = toy_qc(4)
    chan = _int_llrs(np.random.default_rng(21), 16, code.n)
    got = tref.make_float_decoder(own_code(code), schedule=schedule, **kw)(
        torch.as_tensor(chan))
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int32
    assert got[2].dtype == torch.bool
    _assert_equal(got, jref.make_float_decoder(code, schedule=schedule, **kw)(
        jnp.asarray(chan)))
    _assert_equal(got, _golden(chan, code, schedule=schedule, **kw))
    if kw["early_term"]:
        assert len(np.unique(got[1].numpy())) >= 2
    else:
        assert (got[1] == kw["max_iter"]).all()


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_float_offset_min_sum_on_wifi648(schedule):
    code = make_code(648, "1/2")
    chan = _int_llrs(np.random.default_rng(22), 4, code.n, -20, 20)
    kw = dict(algorithm="offset-min-sum", beta=0.5, early_term=True,
              max_iter=4, schedule=schedule)
    got = tref.make_float_decoder(own_code(code), **kw)(torch.as_tensor(chan))
    _assert_equal(got, jref.make_float_decoder(code, **kw)(jnp.asarray(chan)))
    _assert_equal(got, _golden(chan, code, **kw))


def _noisy_llrs(rng, code, B, sigma):
    """float32 LLRs of random codewords over BPSK/AWGN."""
    info = rng.integers(0, 2, (B, code.k), dtype=np.uint8)
    cw = np.asarray(jenc.make_encoder(code)(jnp.asarray(info)))
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    return (2.0 * y / sigma ** 2).astype(np.float32)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("early_term", [False, True])
def test_sum_product_equals_jax(schedule, early_term):
    """Sum-product against the JAX decoder: `iters` and `conv` of every
    frame, every hard bit of the converged frames; the share of frames
    whose hard bits differ at all is 0 on these inputs."""
    code = toy_qc(8)
    llr = _noisy_llrs(np.random.default_rng(23), code, 64, 0.85)
    kw = dict(algorithm="sum-product", early_term=early_term, max_iter=12,
              schedule=schedule)
    hard, iters, conv = tref.make_float_decoder(own_code(code), **kw)(
        torch.as_tensor(llr))
    jh, ji, jc = map(np.asarray,
                     jref.make_float_decoder(code, **kw)(jnp.asarray(llr)))
    np.testing.assert_array_equal(iters.numpy(), ji)
    np.testing.assert_array_equal(conv.numpy(), jc.astype(bool))
    ok = conv.numpy()
    assert 0 < ok.sum()
    np.testing.assert_array_equal(hard.numpy()[ok], jh[ok])
    differing = (hard.numpy() != jh).any(axis=1).mean()
    assert differing == 0.0
    # golden (float64) on the first frames that converged: the same words
    for b in np.nonzero(ok)[0][:4]:
        r = decode_float(llr[b].astype(np.float64), code, **kw)
        if r.converged:
            np.testing.assert_array_equal(hard.numpy()[b], r.hard)


def test_float_decoder_refusals():
    code = own_code(toy_qc(4))
    with pytest.raises(ValueError, match="unknown float CN update"):
        tref.make_float_decoder(code, algorithm="min-star")
    with pytest.raises(ValueError):
        tref.make_float_decoder(code, schedule="zigzag")


BASE = rcfg.PRESETS["wifi-648-r12-minsum"]
# name -> (decoder fields, quant fields, code fields)
STEP_CASES = {
    "sum-product-flooding": (dict(algorithm="sum-product", early_term=True,
                                  max_iter=10), {}, {}),
    "min-sum-float-layered": (dict(algorithm="min-sum-float",
                                   schedule="layered", early_term=True), {},
                              {}),
    "offset-float-layered-punctured": (
        dict(algorithm="offset-min-sum-float", schedule="layered",
             early_term=True), dict(beta_lsb=2), dict(punct_frac=0.25)),
    "normalized-float-flooding-shortened": (
        dict(algorithm="normalized-min-sum-float", early_term=False,
             max_iter=6), {}, dict(shorten_bits=27)),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_float_mode_step_matches_jax_chain(name):
    """Float mode in the batch-first step (no quantizer: the decoder takes
    the raw LLRs, 1e6 at shortened positions) against the reference chain
    with the reference's own `select_decoder`, counter for counter."""
    dec_kw, quant_kw, code_kw = STEP_CASES[name]
    ref_cfg = dataclasses.replace(
        BASE, code=dataclasses.replace(BASE.code, **code_kw),
        quant=dataclasses.replace(BASE.quant, **quant_kw),
        decoder=dataclasses.replace(BASE.decoder, **dec_kw))
    ref_code = ref_build_code(ref_cfg)
    cfg = config_from_reference(ref_cfg)
    ct = from_reference(build_code(cfg), "cpu")
    B = 32
    rng = np.random.default_rng(sorted(STEP_CASES).index(name))
    excluded = sorted(set(map(int, ref_code.punct_vns))
                      | set(map(int, ref_code.shortened_vns)))
    tx_pos = np.setdiff1d(np.arange(ref_code.n), excluded)
    info = rng.integers(0, 2, (B, ref_code.k), dtype=np.uint8)
    noise = rng.standard_normal((B, len(tx_pos))).astype(np.float32)
    sigma = np.float32(tch.sigma_for(2.0, ct.code.rate, "bpsk"))
    rb = make_run_batch(ct, cfg, batch=B)
    assert rb.backend_label == "torch-float" and not rb.transposed
    got = rb(None, sigma, info=torch.as_tensor(info),
             noise=torch.as_tensor(noise)).tolist()

    info_pos = np.asarray(jenc.info_positions(ref_code))
    sent = info.copy()
    sent[:, np.isin(info_pos, np.asarray(ref_code.shortened_vns))] = 0
    cw = jenc.make_encoder(ref_code)(jnp.asarray(sent))
    y = jch.modulate(cw[:, tx_pos], "bpsk") + jnp.float32(sigma) * noise
    llr = jch.demap(y, sigma, "bpsk")
    if excluded:
        full = jnp.zeros((B, ref_code.n), llr.dtype).at[:, tx_pos].set(llr)
        if len(ref_code.shortened_vns):
            full = full.at[:, np.asarray(ref_code.shortened_vns)].set(
                jnp.float32(1e6))
        llr = full
    dec, label = ref_select_decoder(ref_code, ref_cfg)
    assert label == "jnp-float"
    hard, iters, conv = map(np.asarray, dec(llr))
    err = hard[:, info_pos] != sent
    want = [B, int(err.sum()), int(err.any(axis=1).sum()), int(iters.sum()),
            int(conv.sum())]
    assert got == want
    assert 0 < want[4]


def test_float_sweep_runs_and_counts_k_eff():
    cfg = config_from_reference(dataclasses.replace(
        BASE, decoder=dataclasses.replace(BASE.decoder,
                                          algorithm="sum-product",
                                          early_term=True)))
    sweep = Sweep(cfg, device="cpu", batch=16)
    assert sweep.backend == "torch-float"
    res = sweep.run([3.0], target_frame_errors=10 ** 9, max_frames=32)
    row = res.rows()[0]
    assert row["frames"] == 32 and row["avg_iters"] < 20
    # a forced fixed-point route does not apply to a float algorithm
    assert Sweep(cfg, device="cpu", batch=16,
                 decoder_backend="qc").backend == "torch-float"
