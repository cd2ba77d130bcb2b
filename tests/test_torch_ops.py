"""The port's ops (ldpc_tpu_torch.ops, .codes, .sim.stats) against the JAX
reference and the golden model on identical numpy inputs.

Tolerance is 0 for every integer output (int8 LLRs, codeword bits, tables).
Float LLRs are allowed 1 ulp: XLA's CPU fusion may contract x + sigma * n
into an FMA where torch rounds the product first. The JAX chains here run
op by op (not jitted), so they are expected to agree exactly."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes.code import expand_qc
from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.layout import compile_qc_layout
from ldpc_tpu.codes.qcstruct import qc_encode_numpy
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.config import PRESETS, QuantConfig
from ldpc_tpu.golden import decoder as golden_dec
from ldpc_tpu.golden import encoder as golden_enc
from ldpc_tpu.ops import channel as jch
from ldpc_tpu.ops import encode as jenc
from ldpc_tpu.ops.quantize import quantize as jquantize
from ldpc_tpu_torch.codes import build_code, from_reference
from ldpc_tpu_torch.ops import channel as tch
from ldpc_tpu_torch.ops import encode as tenc
from ldpc_tpu_torch.ops.quantize import dequantize, quantize

torch.set_num_threads(2)

CODES = {
    "toy4": lambda: toy_qc(4),
    "wifi648": lambda: make_code(648, "1/2"),
    "wifi1944r34": lambda: make_code(1944, "3/4"),
}


def _boundary_llrs(rng, scale):
    """Random LLRs plus exact half-LSB points, values one float32 ulp
    either side of them, and saturating magnitudes."""
    half = (np.arange(-40, 41) + 0.5) / scale
    near = np.concatenate([np.nextafter(half.astype(np.float32), np.inf),
                           np.nextafter(half.astype(np.float32), -np.inf)])
    special = np.array([0.0, -0.0, 0.49999997 / scale, -0.49999997 / scale,
                        1e3, -1e3, 31.75, -31.75, 31.875, -31.875, 1e-30])
    rand = rng.normal(0, 12, 2000)
    return np.concatenate([half, near, special, rand]).astype(np.float32)


@pytest.mark.parametrize("bits,scale", [(8, 4.0), (4, 4.0), (6, 2.0),
                                        (8, 3.0)])
def test_quantize_matches_reference(rng, bits, scale):
    quant = QuantConfig(bits=bits, scale=scale)
    x = _boundary_llrs(rng, scale)
    got = quantize(torch.as_tensor(x), quant).numpy()
    want = np.asarray(jquantize(jnp.asarray(x), quant))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    if scale in (2.0, 4.0):
        # golden rounds in float64; away from the float32 rounding of
        # x * scale + 0.5 one ulp below a half-LSB point (which the
        # reference op shares) it must agree too
        rand = x[-2000:]
        g = golden_dec.quantize(rand, scale=scale, bits=bits)
        np.testing.assert_array_equal(got[-2000:], g)
    assert np.abs(got).max() <= quant.qmax
    # float32 semantics of the reference op (and of the kernel's quant32):
    # 0.49999997 + 0.5 rounds to 1.0 in float32, so this is +-1, not 0
    t = quantize(torch.tensor([0.49999997, -0.49999997]) / scale, quant)
    assert t.tolist() == [1, -1]
    # round half away from zero, not to even
    t = quantize(torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5]) / scale, quant)
    assert t.tolist() == [1, 2, 3, -1, -3]


def test_dequantize_roundtrip():
    q = torch.arange(-127, 128, dtype=torch.int8)
    back = quantize(dequantize(q), QuantConfig())
    assert torch.equal(back, q)


@pytest.mark.parametrize("name", sorted(CODES))
def test_encoder_t_matches_reference(rng, name):
    code = CODES[name]()
    ct = from_reference(code, "cpu")
    B = 48
    info_t = rng.integers(0, 2, (code.k, B), dtype=np.uint8)
    got = tenc.make_encoder_t(ct)(torch.as_tensor(info_t)).numpy()
    want = np.asarray(jenc.make_encoder_t(code)(jnp.asarray(info_t)))
    gold = golden_enc.encode(code, info_t.T).T
    assert got.dtype == np.uint8 and got.shape == (code.n, B)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, gold)
    H = code.h_dense().astype(np.int64)
    assert not ((H @ got.astype(np.int64)) % 2).any()
    # batch-first form is the transpose
    bf = tenc.make_encoder(ct)(torch.as_tensor(info_t.T.copy())).numpy()
    np.testing.assert_array_equal(bf, got.T)


def test_encoder_large_qc_code_raises():
    """Above n = 4096 the dense form is not built, so a QC code without the
    encodable dual-diagonal parity part has no encoder: it raises."""
    base = make_code(648, "1/2").base.copy()
    base[:, 12] = -1                 # no weight-3 first parity column
    code = expand_qc(base, 200, name="no-staircase")
    assert code.n > tenc.DENSE_MAX_N and not tenc.has_qc_struct(code)
    with pytest.raises(ValueError, match="no encodable QC parity structure"):
        tenc.make_qc_encoder_t(code)


def test_encoder_large_qc_code_uses_structured_encoder(rng):
    """Above n = 4096 a QC code with the encodable parity structure takes
    the structured encoder, bit-exact with the reference's golden
    structured encoder and with zero syndrome."""
    code = build_code(PRESETS["dvbs2-64800-r12"])
    ct = from_reference(code, "cpu")
    assert ct.P is None and ct.perm is None
    np.testing.assert_array_equal(ct.info_positions.numpy(),
                                  np.arange(code.k))
    info_t = rng.integers(0, 2, (code.k, 3), dtype=np.uint8)
    got = tenc.make_encoder_t(ct)(torch.as_tensor(info_t)).numpy()
    np.testing.assert_array_equal(got, qc_encode_numpy(code, info_t.T).T)
    np.testing.assert_array_equal(got[: code.k], info_t)
    for b in range(3):
        assert not code.syndrome(got[:, b]).any()
    plain_qc = expand_qc(np.array([[0, 0, 0], [0, 1, 2]]), 3, name="plain")
    with pytest.raises(ValueError, match="no encodable QC"):
        tenc.make_qc_encoder_t(plain_qc)


@pytest.mark.parametrize("name", sorted(CODES))
def test_info_positions_match_reference(name):
    code = CODES[name]()
    np.testing.assert_array_equal(tenc.info_positions(code),
                                  jenc.info_positions(code))


@pytest.mark.parametrize("ebn0,rate,mod", [(2.0, 0.5, "bpsk"),
                                           (1.5, 0.75, "bpsk"),
                                           (6.0, 0.75, "16qam")])
def test_sigma_for_matches_reference(ebn0, rate, mod):
    assert tch.sigma_for(ebn0, rate, mod) == jch.sigma_for(ebn0, rate, mod)


def test_bpsk_chain_t_matches_reference(rng):
    """modulate_t -> awgn_t (injected noise) -> demap_t, batch last, scalar
    and per-lane sigma. Float LLRs within 1 ulp (expected: exact), and the
    quantized int8 LLRs exactly equal."""
    n, B = 648, 64
    bits = rng.integers(0, 2, (n, B), dtype=np.uint8)
    noise = rng.standard_normal((n, B)).astype(np.float32)
    for sigma in (np.float32(0.7943282),
                  rng.uniform(0.5, 1.0, B).astype(np.float32)):
        x_t = tch.modulate_t(torch.as_tensor(bits), "bpsk")
        y_t = tch.awgn_t(None, x_t, sigma, noise=torch.as_tensor(noise))
        llr_t = tch.demap_t(y_t, sigma, "bpsk")
        x_j = jch.modulate_t(jnp.asarray(bits), "bpsk")
        y_j = x_j + jnp.asarray(sigma, jnp.float32) * jnp.asarray(noise)
        llr_j = jch.demap_t(y_j, sigma, "bpsk")
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
        assert x_t.dtype == torch.float32 and llr_t.dtype == torch.float32
        np.testing.assert_array_max_ulp(llr_t.numpy(), np.asarray(llr_j), 1)
        np.testing.assert_array_equal(
            quantize(llr_t).numpy(),
            np.asarray(jquantize(llr_j, QuantConfig())))


def test_bpsk_chain_batch_first_matches_reference(rng):
    B, n = 32, 96
    bits = rng.integers(0, 2, (B, n), dtype=np.uint8)
    noise = rng.standard_normal((B, n)).astype(np.float32)
    sigma = rng.uniform(0.5, 1.0, B).astype(np.float32)   # per codeword
    x = tch.modulate(torch.as_tensor(bits), "bpsk")
    llr = tch.demap(tch.awgn(None, x, sigma, noise=torch.as_tensor(noise)),
                    sigma, "bpsk")
    s_j = jnp.asarray(sigma)[:, None]
    y_j = jch.modulate(jnp.asarray(bits), "bpsk") + s_j * jnp.asarray(noise)
    np.testing.assert_array_max_ulp(
        llr.numpy(), np.asarray(jch.demap(y_j, sigma, "bpsk")), 1)


def test_sigma_is_float32_before_arithmetic():
    """A float64 sigma is rounded to float32 first, as the reference's
    Sweep passes np.float32(sigma)."""
    y = torch.linspace(-2, 2, 101)
    s64 = 0.7943282347242815
    a = tch.demap_t(y, s64, "bpsk")
    b = tch.demap_t(y, np.float32(s64), "bpsk")
    assert torch.equal(a, b)


def test_awgn_generator_statistics():
    x = torch.zeros((512, 256))
    g1 = torch.Generator().manual_seed(5)
    y1 = tch.awgn_t(g1, x, 0.75)
    g2 = torch.Generator().manual_seed(5)
    assert torch.equal(y1, tch.awgn_t(g2, x, 0.75))     # same seed, same draw
    g3 = torch.Generator().manual_seed(6)
    assert not torch.equal(y1, tch.awgn_t(g3, x, 0.75))
    m, v = float(y1.mean()), float(y1.var())
    assert abs(m) < 4 * 0.75 / math.sqrt(y1.numel())
    assert abs(v / 0.75 ** 2 - 1) < 0.02
    # lanes are independent: neighbouring-lane correlation near zero
    c = np.corrcoef(y1[:, :-1].flatten(), y1[:, 1:].flatten())[0, 1]
    assert abs(c) < 0.01
    with pytest.raises(ValueError, match="Generator"):
        tch.awgn_t(None, x, 0.75)


@pytest.mark.parametrize("mod", ["qpsk", "16qam", "8psk"])
def test_non_bpsk_raises(mod):
    """Beyond BPSK the bits must fill whole symbols (13 bits fill none of
    these), and 12 bits give 12 LLRs back."""
    bits = torch.zeros((13, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="do not fill"):
        tch.modulate_t(bits, mod)
    with pytest.raises(ValueError, match="do not fill"):
        tch.modulate(bits.T, mod)
    x = tch.modulate_t(bits[:12], mod)
    assert tuple(x.shape) == (12 // tch.BITS_PER_SYM[mod], 2, 4)
    llr = tch.demap_t(x, 0.5, mod)
    assert tuple(llr.shape) == (12, 4) and bool((llr > 0).all())


@pytest.mark.parametrize("name", sorted(CODES))
def test_from_reference_tables(name):
    """Entry lists in compile_qc_layout / minsum_pallas._qc_entries order,
    systematic form, info positions and the ident_info rule."""
    from ldpc_tpu.kernels.minsum_pallas import _qc_entries
    code = CODES[name]()
    ct = from_reference(code, "cpu")
    qc = compile_qc_layout(code)
    _, pallas_layers = _qc_entries(code)
    assert (ct.n, ct.k, ct.Z, ct.nb, ct.mb) == (code.n, code.k, qc.Z,
                                                qc.nb, qc.mb)
    assert ct.kb == code.k // qc.Z
    assert [[(c, s) for c, s, _ in row] for row in ct.entries] == \
        pallas_layers
    eids = [e for row in ct.entries for _, _, e in row]
    assert eids == list(range(len(eids))) and ct.n_entries == len(eids)
    for i, row in enumerate(ct.entries):
        for t, (c, s, _) in enumerate(row):
            assert (c, s) == (qc.layer_cols[i, t], qc.layer_shifts[i, t])
    P, perm = golden_enc.systematic_form(code)
    np.testing.assert_array_equal(ct.P.numpy(), P.astype(np.float32))
    assert ct.P.dtype == torch.float32
    assert ct.perm is None and np.array_equal(perm, np.arange(code.n))
    np.testing.assert_array_equal(ct.info_positions.numpy(),
                                  jenc.info_positions(code))
    assert ct.ident_info == (code.k % qc.Z == 0 and np.array_equal(
        jenc.info_positions(code), np.arange(code.k)))
    assert ct.ident_info


@pytest.mark.parametrize("preset", ["wifi-648-r12-minsum", "wifi-full-oms",
                                    "multihost-qam-chain"])
def test_build_code_matches_reference(preset):
    from ldpc_tpu.sim.sweep import build_code as jax_build_code
    cfg = PRESETS[preset]
    a, b = build_code(cfg), jax_build_code(cfg)
    assert (a.name, a.n, a.m, a.k, a.Z) == (b.name, b.n, b.m, b.k, b.Z)
    np.testing.assert_array_equal(a.base, b.base)


def test_build_code_rate_matching_matches_reference():
    from ldpc_tpu.sim.sweep import build_code as jax_build_code
    cfg = PRESETS["wifi-648-r12-minsum"]
    cfg = dataclasses.replace(cfg, code=dataclasses.replace(
        cfg.code, punct_frac=0.25, shorten_bits=27))
    a, b = build_code(cfg), jax_build_code(cfg)
    np.testing.assert_array_equal(a.punct_vns, b.punct_vns)
    np.testing.assert_array_equal(a.shortened_vns, b.shortened_vns)


def test_stats_copy_matches_reference():
    from ldpc_tpu.sim import stats as jstats
    from ldpc_tpu_torch.sim import stats as tstats
    for errs, trials in ((0, 10), (5, 1000), (330130, 16384 * 324)):
        assert tstats.wilson_interval(errs, trials) == \
            jstats.wilson_interval(errs, trials)
    for args in ((10, 1000, 14, 1000), (10, 1000, 400, 1000)):
        assert tstats.rates_compatible(*args) == \
            jstats.rates_compatible(*args)
    kw = dict(ebn0_db=2.0, frames=1024, bit_errs=3000, frame_errs=120,
              iter_sum=20480, converged=900, batches=2, wall_s=1.5)
    assert tstats.SnrPoint(**kw).row(324, 648) == \
        jstats.SnrPoint(**kw).row(324, 648)
    rows = [{"ebn0_db": 1.0, "ber": 1e-3}, {"ebn0_db": 2.0, "ber": 1e-5}]
    assert tstats.snr_at_ber(rows, 1e-4) == jstats.snr_at_ber(rows, 1e-4)


def test_mean_compatible():
    from ldpc_tpu_torch.sim.stats import mean_compatible
    # 20.0 vs 20.3 bits/frame with sd 25 over 16k frames each: compatible
    assert mean_compatible(20.0 * 16384, 16384, 20.3 * 16384, 16384, 625.0)
    # 20 vs 22 is not
    assert not mean_compatible(20.0 * 16384, 16384, 22.0 * 16384, 16384,
                               625.0)
    assert not mean_compatible(1, 0, 1, 10, 1.0)
