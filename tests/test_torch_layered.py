"""The port's layered decoder (K3's plain version) and early-terminating
decoders (K2, K3) against golden, the JAX decoders and the Pallas kernel in
interpret mode, and the kernel build's source hash.

Every integer output is compared with tolerance 0: min-sum over integers
is deterministic. The CUDA kernels run only on a GPU (chip_smoke.py holds
them to these plain versions there); here the wrapper's CPU path, which is
the plain version, is held to the reference."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.config import DecoderConfig, QuantConfig
from ldpc_tpu.golden.decoder import decode_fixed
from ldpc_tpu.ops import decode_ref as jref
from ldpc_tpu_torch.codes import from_reference
from ldpc_tpu_torch.kernels import build, minsum
from ldpc_tpu_torch.ops import decode_ref as tref

torch.set_num_threads(2)


def _random_llrs(rng, B, n, qmax=127):
    # easy (large |LLR|) and hard (noisy) lanes: converged and not
    x = rng.normal(0, 40, size=(B, n))
    x[: B // 2] = rng.normal(30, 25, size=(B // 2, n))
    return np.clip(np.round(x), -qmax, qmax).astype(np.int8)


def _channel_llrs(rng, B, n, sigma, scale=4.0):
    """int8 LLRs of the all-zeros codeword over BPSK/AWGN."""
    y = 1.0 + sigma * rng.standard_normal((B, n))
    return np.clip(np.round(2 * y / sigma ** 2 * scale), -127,
                   127).astype(np.int8)


def _golden(chan, code, schedule, **kw):
    rs = [decode_fixed(row.astype(np.int32), code, schedule=schedule, **kw)
          for row in chan]
    return (np.stack([r.hard for r in rs]), np.array([r.iters for r in rs]),
            np.array([r.converged for r in rs]))


def _to_t(chan, ct):
    """(B, n) -> the kernel layout (nb, Z, B)."""
    return torch.as_tensor(np.ascontiguousarray(chan.T)).reshape(
        ct.nb, ct.Z, chan.shape[0])


def _assert_equal(got, *wants):
    for want in wants:
        for g, w in zip(got, want):
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))


LAYERED_CASES = [
    dict(beta=0, early_term=False, max_iter=6),
    dict(beta=0, early_term=True, max_iter=7),
    dict(beta=2, early_term=False, max_iter=5),
    dict(beta=2, early_term=True, max_iter=6),
    dict(beta=0, alpha=(3, 2), early_term=False, max_iter=5),
    dict(beta=1, alpha=(3, 2), early_term=True, max_iter=6),
]


@pytest.mark.parametrize("kw", LAYERED_CASES)
def test_layered_toy_matches_golden_and_jax(rng, kw):
    code = toy_qc(4)
    chan = _random_llrs(rng, 16, code.n)
    out = tref.make_layered_decoder(code, qmax=127, **kw)(
        torch.as_tensor(chan))
    assert out[0].dtype == torch.uint8 and out[1].dtype == torch.int32
    assert out[2].dtype == torch.bool
    jax_out = jref.make_layered_decoder(code, qmax=127, **kw)(
        jnp.asarray(chan))
    _assert_equal(out, _golden(chan, code, "layered", qmax=127, **kw),
                  jax_out)


@pytest.mark.parametrize("kw", [
    dict(beta=0, early_term=False, max_iter=4),
    dict(beta=2, early_term=True, max_iter=6),
    dict(beta=0, alpha=(3, 2), early_term=True, max_iter=5),
])
def test_layered_wifi648_matches_golden_and_jax(rng, kw):
    code = make_code(648, "1/2")
    chan = _channel_llrs(rng, 4, code.n, sigma=0.8)
    out = tref.make_layered_decoder(code, qmax=127, **kw)(
        torch.as_tensor(chan))
    jax_out = jref.make_layered_decoder(code, qmax=127, **kw)(
        jnp.asarray(chan))
    _assert_equal(out, _golden(chan, code, "layered", qmax=127, **kw),
                  jax_out)


@pytest.mark.parametrize("bits", [4, 6])
@pytest.mark.parametrize("early_term", [False, True])
def test_layered_low_bitwidth_matches_golden(rng, bits, early_term):
    qmax = (1 << (bits - 1)) - 1
    code = toy_qc(4)
    chan = _random_llrs(rng, 16, code.n, qmax=qmax)
    kw = dict(beta=1, early_term=early_term, max_iter=6)
    out = tref.make_layered_decoder(code, qmax=qmax, **kw)(
        torch.as_tensor(chan))
    _assert_equal(out, _golden(chan, code, "layered", qmax=qmax, **kw))


def test_layered_wifi1944_r56_oms_et_matches_jax(rng):
    """The wifi-full-oms decoder (n=1944 rate 5/6, OMS beta=2, early
    termination, 20 iterations) at 3.0 dB against the JAX decoder."""
    code = make_code(1944, "5/6")
    sigma = float(np.sqrt(1 / (2 * code.rate * 10 ** 0.3)))
    chan = _channel_llrs(rng, 64, code.n, sigma)
    kw = dict(beta=2, early_term=True, max_iter=20)
    out = tref.make_layered_decoder(code, qmax=127, **kw)(
        torch.as_tensor(chan))
    _assert_equal(out, jref.make_layered_decoder(code, qmax=127, **kw)(
        jnp.asarray(chan)))
    iters, conv = out[1].numpy(), out[2].numpy()
    assert 0 < conv.sum() < 64 and iters.min() < iters.max()


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("algorithm,quant", [
    ("offset-min-sum", QuantConfig(beta_lsb=2)),
    ("normalized-min-sum", QuantConfig(alpha_num=3, alpha_shift=2)),
])
def test_make_decoder_dispatches_like_jax(rng, schedule, algorithm, quant):
    code = toy_qc(8)
    dcfg = DecoderConfig(algorithm=algorithm, schedule=schedule, max_iter=6,
                         early_term=True)
    chan = _random_llrs(rng, 12, code.n)
    out = tref.make_decoder(code, dcfg, quant)(torch.as_tensor(chan))
    _assert_equal(out, jref.make_decoder(code, dcfg, quant)(
        jnp.asarray(chan)))
    with pytest.raises(ValueError, match="min-sum family"):
        tref.make_decoder(code, dataclasses.replace(
            dcfg, algorithm="min-star"), quant)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_early_term_edge_iterations(rng, schedule):
    """Iteration 0 (the channel state is a codeword: iters 0, converged)
    and convergence at exactly max_iter (iters = max_iter, converged),
    both against golden."""
    code = toy_qc(8)
    B = 24
    chan = _random_llrs(rng, B, code.n)
    chan[0] = 60                                   # all-zeros, noiseless
    kw = dict(beta=0, qmax=127, early_term=True)
    maker = (tref.make_layered_decoder if schedule == "layered"
             else tref.make_flooding_decoder)
    _, iters, conv = maker(code, max_iter=10, **kw)(torch.as_tensor(chan))
    assert iters[0] == 0 and conv[0]
    late = [i for i in range(B) if conv[i] and iters[i] >= 2]
    assert late, "no lane converges after iteration 1"
    k = int(iters[late[0]])
    out = maker(code, max_iter=k, **kw)(torch.as_tensor(chan))
    assert out[1][late[0]] == k and out[2][late[0]]
    _assert_equal(out, _golden(chan, code, schedule, max_iter=k, **kw))


def _dcfg(schedule, max_iter, early_term, algorithm="min-sum"):
    return DecoderConfig(algorithm=algorithm, schedule=schedule,
                         max_iter=max_iter, early_term=early_term)


@pytest.mark.parametrize("schedule,early_term", [
    ("layered", True), ("layered", False), ("flooding", True)])
def test_wrapper_matches_pallas_interpret_toy(rng, schedule, early_term):
    """The wrapper's CPU path (batch last, hard output) against the Pallas
    kernel in interpret mode, pre-transposed layout: K3 with and without
    early termination, K2."""
    from ldpc_tpu.kernels.minsum_pallas import make_pallas_decoder
    code = toy_qc(4)
    ct = from_reference(code, "cpu")
    B = 8
    chan = _random_llrs(rng, B, code.n)
    chan[1] = 50                        # a lane done at iteration 0
    chan_t = _to_t(chan, ct)
    pallas = make_pallas_decoder(code, qmax=127, beta=2, schedule=schedule,
                                 early_term=early_term, max_iter=6,
                                 batch_tile=4, interpret=True,
                                 pre_transposed=True)
    want = pallas(jnp.asarray(chan_t.numpy()))
    dec = minsum.make_decoder(
        ct, _dcfg(schedule, 6, early_term, "offset-min-sum"),
        QuantConfig(beta_lsb=2))
    got = dec(chan_t)
    assert got[0].shape == (ct.nb, ct.Z, B) and got[0].dtype == torch.uint8
    _assert_equal(got, want)
    if early_term:
        assert got[1][1] == 0 and got[2][1]


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_wrapper_fused_io_matches_pallas_interpret_toy(rng, schedule):
    """Fused IO (float LLRs quantized in the decoder, per-lane info-bit
    error counts out) with early termination, against the Pallas fused-IO
    kernel in interpret mode."""
    from ldpc_tpu.kernels.minsum_pallas import make_pallas_decoder
    code = toy_qc(4)
    ct = from_reference(code, "cpu")
    assert ct.ident_info
    B = 8
    llr = (rng.standard_normal((code.n, B)) * 2 + 1).astype(np.float32)
    llr[:, 0] = 3.0                     # the sent all-zeros word, clean
    info = rng.integers(0, 2, (code.k, B), dtype=np.uint8)
    info[:, :4] = 0
    pallas = make_pallas_decoder(code, qmax=127, schedule=schedule,
                                 early_term=True, max_iter=6, batch_tile=4,
                                 interpret=True, pre_transposed=True,
                                 input_scale=4.0, count_info_cols=ct.kb)
    want = pallas(jnp.asarray(llr).reshape(ct.nb, ct.Z, B),
                  jnp.asarray(info).reshape(ct.kb, ct.Z, B))
    dec = minsum.make_decoder(ct, _dcfg(schedule, 6, True),
                              QuantConfig(beta_lsb=0), input_scale=4.0,
                              count_info_cols=ct.kb)
    got = dec(torch.as_tensor(llr).reshape(ct.nb, ct.Z, B),
              torch.as_tensor(info).reshape(ct.kb, ct.Z, B))
    _assert_equal(got, want)
    assert got[2][0] == 0 and got[3][0] and got[0][0] == 0


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_wrapper_counts_per_library(rng, schedule):
    ct = from_reference(toy_qc(4), "cpu")
    dec = minsum.make_decoder(ct, _dcfg(schedule, 3, True),
                              QuantConfig(beta_lsb=0))
    lib = minsum.LIBRARIES[schedule]
    assert dec.library == lib and lib in minsum.SOURCES
    assert minsum.SOURCES[lib].endswith(f"csrc/{lib}.cu")
    minsum.library_launches[lib] = 5
    minsum.reset_counters()
    assert minsum.library_launches == dict.fromkeys(minsum.SOURCES, 0)
    dec(_to_t(_random_llrs(rng, 4, ct.n), ct))
    assert minsum.plain_calls == 1 and minsum.kernel_launches == 0
    assert sum(minsum.library_launches.values()) == 0


def test_wrapper_refuses_codes_outside_the_kernel_domain(rng):
    """The kernels' CN update needs base rows of degree >= 2 (and int16-safe
    posteriors); a code outside that is refused at the kernel entry, while
    the real codes of the presets are inside it."""
    ct = from_reference(toy_qc(4), "cpu")
    rows = [ct.entries[0][:1]] + list(ct.entries[1:])
    eid = iter(range(ct.n_entries))
    short = dataclasses.replace(ct, entries=tuple(
        tuple((c, s, next(eid)) for c, s, _ in row) for row in rows))
    dec = minsum.make_decoder(short, _dcfg("layered", 3, True),
                              QuantConfig(beta_lsb=0))
    with pytest.raises(NotImplementedError, match="degrees >= 2"):
        dec.kernel(_to_t(_random_llrs(rng, 4, ct.n), ct))
    for n, rate in ((648, "1/2"), (1944, "5/6"), (1944, "3/4")):
        full = from_reference(make_code(n, rate), "cpu")
        dec = minsum.make_decoder(full, _dcfg("layered", 20, True),
                                  QuantConfig(beta_lsb=2))
        assert dec._kernel_domain is None


def test_build_hash_covers_included_headers(monkeypatch, tmp_path):
    """A library's name hashes its source and every local header it
    includes, transitively, so editing a shared header rebuilds."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "c.cuh").write_text("// not included\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh",
                                                     "b.cuh"]
    before = build.library_path("k")
    (tmp_path / "c.cuh").write_text("// edited\n")
    assert build.library_path("k") == before
    (tmp_path / "b.cuh").write_text("// edited\n")
    assert build.library_path("k") != before


def test_shipped_kernels_share_the_cn_header():
    for lib in minsum.SOURCES:
        names = [p.name for p in build.sources(lib)]
        assert names == [f"{lib}.cu", "cn_minsum.cuh"], names
    assert (build.library_path("minsum_flood")
            != build.library_path("minsum_layered"))
