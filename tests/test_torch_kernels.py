"""The port's decoders against the JAX reference and the golden model.

ldpc_tpu_torch.ops.decode_ref (the plain version of the CUDA kernel) and
ldpc_tpu_torch.kernels.minsum (its wrapper; on CPU tensors it runs the plain
version) must equal golden.decoder.decode_fixed, the JAX flooding decoder
and the Pallas kernel in interpret mode exactly: min-sum over integers is
deterministic, so every integer output is compared with tolerance 0. The
CUDA kernel itself runs only on a GPU (chip_smoke.py); here the wrapper's
checks in front of it are tested."""
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
from ldpc_tpu.ops.quantize import quantize as jquantize
from ldpc_tpu_torch.codes import from_reference
from ldpc_tpu_torch.kernels import build, minsum
from ldpc_tpu_torch.ops.decode_ref import make_flooding_decoder

torch.set_num_threads(2)


def _random_llrs(rng, B, n, qmax=127):
    # easy (large |LLR|) and hard (noisy) lanes: converged and not
    x = rng.normal(0, 40, size=(B, n))
    x[: B // 2] = rng.normal(30, 25, size=(B // 2, n))
    return np.clip(np.round(x), -qmax, qmax).astype(np.int8)


def _golden_batch(chan, code, **kw):
    rs = [decode_fixed(row.astype(np.int32), code, schedule="flooding", **kw)
          for row in chan]
    return (np.stack([r.hard for r in rs]), np.array([r.iters for r in rs]),
            np.array([r.converged for r in rs]))


def _to_t(chan, ct):
    """(B, n) -> the kernel layout (nb, Z, B)."""
    B = chan.shape[0]
    return torch.as_tensor(np.ascontiguousarray(chan.T)).reshape(
        ct.nb, ct.Z, B)


DECODE_CASES = [
    dict(beta=0, early_term=False, max_iter=6),
    dict(beta=0, early_term=True, max_iter=7),
    dict(beta=2, early_term=False, max_iter=6),
    dict(beta=2, early_term=True, max_iter=6),
    dict(beta=0, alpha=(3, 2), early_term=False, max_iter=6),
    dict(beta=1, alpha=(3, 2), early_term=True, max_iter=5),
]


@pytest.mark.parametrize("kw", DECODE_CASES)
def test_plain_decoder_toy_matches_golden_and_jax(rng, kw):
    code = toy_qc(4)
    chan = _random_llrs(rng, 16, code.n)
    hard, iters, conv = make_flooding_decoder(code, qmax=127, **kw)(
        torch.as_tensor(chan))
    assert hard.dtype == torch.uint8 and iters.dtype == torch.int32
    assert conv.dtype == torch.bool
    g = _golden_batch(chan, code, qmax=127, **kw)
    j = map(np.asarray,
            jref.make_flooding_decoder(code, qmax=127, **kw)(
                jnp.asarray(chan)))
    for got, gold, jax_out in zip((hard, iters, conv), g, j):
        np.testing.assert_array_equal(got.numpy(), gold)
        np.testing.assert_array_equal(got.numpy(), jax_out)


@pytest.mark.parametrize("kw", [
    dict(beta=0, early_term=False, max_iter=5),
    dict(beta=2, early_term=True, max_iter=5),
    dict(beta=0, alpha=(3, 2), early_term=False, max_iter=4),
])
def test_plain_decoder_wifi648_matches_golden_and_jax(rng, kw):
    code = make_code(648, "1/2")
    chan = _random_llrs(rng, 4, code.n)
    out = make_flooding_decoder(code, qmax=127, **kw)(torch.as_tensor(chan))
    g = _golden_batch(chan, code, qmax=127, **kw)
    j = map(np.asarray, jref.make_flooding_decoder(code, qmax=127, **kw)(
        jnp.asarray(chan)))
    for got, gold, jax_out in zip(out, g, j):
        np.testing.assert_array_equal(got.numpy(), gold)
        np.testing.assert_array_equal(got.numpy(), jax_out)


@pytest.mark.parametrize("bits", [4, 6])
def test_plain_decoder_low_bitwidth(rng, bits):
    qmax = (1 << (bits - 1)) - 1
    code = toy_qc(4)
    chan = _random_llrs(rng, 16, code.n, qmax=qmax)
    for kw in (dict(beta=1, early_term=True, max_iter=6),
               dict(beta=0, early_term=False, max_iter=6)):
        out = make_flooding_decoder(code, qmax=qmax, **kw)(
            torch.as_tensor(chan))
        g = _golden_batch(chan, code, qmax=qmax, **kw)
        for got, gold in zip(out, g):
            np.testing.assert_array_equal(got.numpy(), gold)


def test_plain_decoder_wifi648_fixed20_matches_jax(rng):
    """The canonical decode (20 fixed iterations) at a realistic operating
    point, against the JAX decoder (golden is too slow at 20 iterations)."""
    code = make_code(648, "1/2")
    sigma = 0.7943282
    y = 1.0 + sigma * rng.standard_normal((64, code.n))
    chan = np.clip(np.round(2 * y / sigma ** 2 * 4), -127, 127).astype(
        np.int8)
    kw = dict(beta=0, early_term=False, max_iter=20)
    out = make_flooding_decoder(code, qmax=127, **kw)(torch.as_tensor(chan))
    j = jref.make_flooding_decoder(code, qmax=127, **kw)(jnp.asarray(chan))
    for got, jax_out in zip(out, j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_out))
    assert 0 < int(out[2].sum()) < 64


def _dcfg(max_iter, early_term=False, algorithm="min-sum"):
    return DecoderConfig(algorithm=algorithm, schedule="flooding",
                         max_iter=max_iter, early_term=early_term)


@pytest.mark.parametrize("early_term", [False, True])
def test_wrapper_matches_pallas_interpret_toy(rng, early_term):
    """The wrapper's CPU path (the kernel's plain version, batch last)
    against the Pallas kernel in interpret mode, pre-transposed layout."""
    from ldpc_tpu.kernels.minsum_pallas import make_pallas_decoder
    code = toy_qc(4)
    ct = from_reference(code, "cpu")
    B = 8
    chan = _random_llrs(rng, B, code.n)
    chan_t = _to_t(chan, ct)
    pallas = make_pallas_decoder(code, qmax=127, schedule="flooding",
                                 early_term=early_term, max_iter=6,
                                 batch_tile=4, interpret=True,
                                 pre_transposed=True)
    want = [np.asarray(o) for o in pallas(jnp.asarray(chan_t.numpy()))]
    dec = minsum.make_decoder(ct, _dcfg(6, early_term),
                              QuantConfig(beta_lsb=0))
    got = dec(chan_t)
    assert got[0].shape == (ct.nb, ct.Z, B) and got[0].dtype == torch.uint8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.slow
def test_fused_io_matches_pallas_interpret_wifi648(rng):
    """Fused-IO form (float LLRs quantized in the decoder, per-lane info-bit
    error counts out) against the Pallas fused-IO kernel in interpret mode
    (about 20-30 s on a CPU, hence slow)."""
    from ldpc_tpu.kernels.minsum_pallas import make_pallas_decoder
    code = make_code(648, "1/2")
    ct = from_reference(code, "cpu")
    B = 8
    llr = (rng.standard_normal((code.n, B)) * 8).astype(np.float32)
    info = rng.integers(0, 2, (code.k, B), dtype=np.uint8)
    pallas = make_pallas_decoder(code, qmax=127, schedule="flooding",
                                 early_term=False, max_iter=4, batch_tile=8,
                                 interpret=True, pre_transposed=True,
                                 input_scale=4.0, count_info_cols=ct.kb)
    want = [np.asarray(o) for o in pallas(
        jnp.asarray(llr).reshape(ct.nb, ct.Z, B),
        jnp.asarray(info).reshape(ct.kb, ct.Z, B))]
    dec = minsum.make_decoder(ct, _dcfg(4), QuantConfig(beta_lsb=0),
                              input_scale=4.0, count_info_cols=ct.kb)
    got = dec(torch.as_tensor(llr).reshape(ct.nb, ct.Z, B),
              torch.as_tensor(info).reshape(ct.kb, ct.Z, B))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype))


@pytest.mark.parametrize("algorithm,quant", [
    ("min-sum", QuantConfig(beta_lsb=0)),
    ("offset-min-sum", QuantConfig(beta_lsb=2)),
    ("normalized-min-sum", QuantConfig(alpha_num=3, alpha_shift=2)),
])
def test_fused_io_matches_jax_chain_wifi648(rng, algorithm, quant):
    """Fused-IO counts against the JAX decode_ref + quantize + counting on
    the same float LLRs and info bits, 20 iterations."""
    code = make_code(648, "1/2")
    ct = from_reference(code, "cpu")
    B = 32
    llr = (rng.standard_normal((code.n, B)) * 6 + 3).astype(np.float32)
    info = rng.integers(0, 2, (code.k, B), dtype=np.uint8)
    dcfg = _dcfg(20, algorithm=algorithm)
    dec = minsum.make_decoder(ct, dcfg, quant, input_scale=quant.scale,
                              count_info_cols=ct.kb)
    bits, frame, iters, conv = dec(
        torch.as_tensor(llr).reshape(ct.nb, ct.Z, B),
        torch.as_tensor(info).reshape(ct.kb, ct.Z, B))
    assert bits.dtype == torch.int32 and frame.dtype == torch.int32
    q = jquantize(jnp.asarray(llr.T), quant)
    h, it, cv = map(np.asarray, jref.make_decoder(code, dcfg, quant)(q))
    err = h[:, : code.k] != info.T
    np.testing.assert_array_equal(bits.numpy(), err.sum(axis=1))
    np.testing.assert_array_equal(frame.numpy(), err.any(axis=1))
    np.testing.assert_array_equal(iters.numpy(), it)
    np.testing.assert_array_equal(conv.numpy(), cv)


def test_dispatch_by_device_counts_plain_calls(rng):
    ct = from_reference(toy_qc(4), "cpu")
    dec = minsum.make_decoder(ct, _dcfg(3), QuantConfig(beta_lsb=0))
    chan = _to_t(_random_llrs(rng, 4, ct.n), ct)
    launches, plain = minsum.kernel_launches, minsum.plain_calls
    dec(chan)
    assert minsum.plain_calls == plain + 1
    assert minsum.kernel_launches == launches
    minsum.reset_counters()
    assert (minsum.kernel_launches, minsum.plain_calls) == (0, 0)


def test_wrapper_rejects_bad_inputs(rng):
    ct = from_reference(toy_qc(4), "cpu")
    q = QuantConfig(beta_lsb=0)
    dec = minsum.make_decoder(ct, _dcfg(3), q)
    good = _to_t(_random_llrs(rng, 4, ct.n), ct)
    with pytest.raises(TypeError, match="dtype"):
        dec(good.to(torch.int32))
    with pytest.raises(ValueError, match="shape"):
        dec(good.reshape(ct.nb * ct.Z, 4))
    with pytest.raises(ValueError, match="shape"):
        dec(good.reshape(ct.Z, ct.nb, 4))
    with pytest.raises(ValueError, match="info"):
        dec(good, torch.zeros((ct.kb, ct.Z, 4), dtype=torch.uint8))
    # the kernel itself takes CUDA tensors only, and never builds for CPU
    with pytest.raises(ValueError, match="CUDA tensors"):
        dec.kernel(good)
    fused = minsum.make_decoder(ct, _dcfg(3), q, input_scale=4.0,
                                count_info_cols=ct.kb)
    llr = torch.zeros((ct.nb, ct.Z, 4))
    info = torch.zeros((ct.kb, ct.Z, 4), dtype=torch.uint8)
    fused(llr, info)
    with pytest.raises(TypeError, match="float32"):
        fused(llr.to(torch.float64), info)
    with pytest.raises(ValueError, match="info must be given"):
        fused(llr)
    with pytest.raises(TypeError, match="uint8"):
        fused(llr, info.to(torch.int8))
    with pytest.raises(ValueError, match="info shape"):
        fused(llr, info[:, :, :3])
    with pytest.raises(ValueError, match="count_info_cols"):
        minsum.make_decoder(ct, _dcfg(3), q, input_scale=4.0,
                            count_info_cols=ct.nb + 1)
    not_ident = dataclasses.replace(ct, ident_info=False)
    with pytest.raises(ValueError, match="identity prefix"):
        minsum.make_decoder(not_ident, _dcfg(3), q, count_info_cols=ct.kb)


@pytest.mark.parametrize("dcfg,match", [
    (DecoderConfig(algorithm="sum-product", schedule="flooding"),
     "no fixed-point CN parameters"),
    (DecoderConfig(algorithm="min-sum-float", schedule="layered"),
     "no fixed-point CN parameters"),
])
def test_unported_decoders_raise(dcfg, match):
    """The float decoders have no kernel: the wrapper refuses them as the
    reference's does (`cn_params`); the step names their ROADMAP item
    (`test_torch_pipeline.py`)."""
    ct = from_reference(toy_qc(4), "cpu")
    with pytest.raises(ValueError, match=match):
        minsum.make_decoder(ct, dcfg, QuantConfig())


def test_kernel_tables():
    """The kernel's packed tables: per-layer entries and, for the variable
    phase, each base column's entries."""
    code = make_code(648, "1/2")
    ct = from_reference(code, "cpu")
    t = minsum.kernel_tables(ct)
    E, mb, nb = ct.n_entries, ct.mb, ct.nb
    assert t.dtype == np.int32 and len(t) == (mb + 1) + 3 * E + (nb + 1)
    layer_ptr = t[: mb + 1]
    cols, shifts = t[mb + 1: mb + 1 + E], t[mb + 1 + E: mb + 1 + 2 * E]
    col_ptr, col_ent = t[mb + 1 + 2 * E: mb + 2 + 2 * E + nb], t[-E:]
    assert layer_ptr[0] == 0 and layer_ptr[-1] == E
    for i, row in enumerate(ct.entries):
        seg = slice(layer_ptr[i], layer_ptr[i + 1])
        assert list(zip(cols[seg], shifts[seg])) == [(c, s) for c, s, _ in
                                                     row]
    assert sorted(col_ent.tolist()) == list(range(E))
    for j in range(nb):
        ents = col_ent[col_ptr[j]: col_ptr[j + 1]]
        assert (cols[ents] == j).all()
        assert len(ents) == (code.base[:, j] >= 0).sum()


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_early_term_refused_by_the_kernel(rng, schedule):
    """Early termination (K2 flooding, K3 layered) runs in the plain
    version on CPU; the kernel entry takes it but refuses CPU tensors, so
    nothing falls back and nothing builds here."""
    ct = from_reference(toy_qc(4), "cpu")
    dcfg = DecoderConfig(algorithm="min-sum", schedule=schedule,
                         max_iter=3, early_term=True)
    dec = minsum.make_decoder(ct, dcfg, QuantConfig(beta_lsb=0))
    assert dec.library == minsum.LIBRARIES[schedule]
    chan = _to_t(_random_llrs(rng, 4, ct.n), ct)
    hard, iters, conv = dec(chan)          # plain: fine on CPU
    assert iters.max() <= 3
    with pytest.raises(ValueError, match="CUDA tensors"):
        dec.kernel(chan)


def test_build_names_library_by_source_hash(monkeypatch, tmp_path):
    p = build.library_path("minsum_flood")
    assert p.parent == build.BUILD_DIR
    assert p.name.startswith("libminsum_flood-") and p.suffix == ".so"
    assert p == build.library_path("minsum_flood")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("minsum_flood") != p
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
