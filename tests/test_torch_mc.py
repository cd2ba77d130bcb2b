"""The Monte-Carlo megakernel's plain version (ldpc_tpu_torch.ops.encode.
make_qc_encoder_t, ops.mc, kernels.minsum.McDecoder) against the JAX
reference on the same numpy-made random words.

Tolerances:
  * the structured encoder, the info bits and the codewords: 0;
  * the int8 LLRs q: at most 1 LSB on at most 1e-4 of the entries. torch's
    CPU log/sin/cos and XLA's may differ by an ulp, which can move
    (x + sigma n) * gain across a rounding boundary;
  * the per-lane outputs: 0 on every lane whose q column is equal (the
    decode is an integer program);
  * per-lane sigma against scalar sigma, stripe by stripe: 0 (the same ops
    on the same words).
On the card the kernel is held to this plain version with tolerance 0
(chip_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes.code import expand_qc
from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.qcstruct import qc_encode_numpy
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.config import PRESETS, DecoderConfig, QuantConfig
from ldpc_tpu.ops import decode_ref as jref
from ldpc_tpu_torch.codes import from_reference
from ldpc_tpu_torch.kernels import build, minsum
from ldpc_tpu_torch.ops import rng as trng
from ldpc_tpu_torch.ops.encode import make_encoder_t, make_qc_encoder_t
from ldpc_tpu_torch.ops.mc import gain_for, make_prologue

torch.set_num_threads(2)

SCALE, QMAX = 4.0, 127
# the two configurations of tests/test_kernels.py:385-387
CONFIGS = {
    "flooding-fixed4": DecoderConfig(schedule="flooding", early_term=False,
                                     max_iter=4),
    "layered-et3-beta2": DecoderConfig(algorithm="offset-min-sum",
                                       schedule="layered", early_term=True,
                                       max_iter=3),
}
QUANTS = {"flooding-fixed4": QuantConfig(scale=SCALE),
          "layered-et3-beta2": QuantConfig(scale=SCALE, beta_lsb=2)}


@pytest.mark.parametrize("code_fn", [
    lambda: make_code(648, "1/2"), lambda: make_code(1296, "2/3"),
    lambda: make_code(1944, "5/6"), lambda: toy_qc(4)])
def test_qc_encoder_matches_reference_and_dense(rng, code_fn):
    code = code_fn()
    B = 40
    info = rng.integers(0, 2, (code.k, B), dtype=np.uint8)
    got = make_qc_encoder_t(code)(torch.as_tensor(info)).numpy()
    assert got.dtype == np.uint8 and got.shape == (code.n, B)
    np.testing.assert_array_equal(got, qc_encode_numpy(code, info.T).T)
    dense = make_encoder_t(from_reference(code, "cpu"))(
        torch.as_tensor(info)).numpy()
    np.testing.assert_array_equal(got, dense)
    H = code.h_dense().astype(np.int64)
    assert not ((H @ got.astype(np.int64)) % 2).any()


def test_qc_encoder_refuses_unstructured_code():
    with pytest.raises(ValueError, match="no encodable QC"):
        make_qc_encoder_t(expand_qc(np.array([[0, 0, 0], [0, 1, 2]]), 3))


def _random_words(rng, code, B):
    Z = code.Z
    kb, nb = code.k // Z, code.base.shape[1]
    W = trng.word_layout(kb, nb, Z)[2]
    u = rng.integers(0, 1 << 32, (W, B), dtype=np.uint32)
    return u.view(np.int32)


def _reference_q(code, words, sigma, gain):
    """The reference's formula (tests/test_kernels.py:355-383) on the same
    words: info bits, qc_encode_numpy, Box-Muller, demap, quantize."""
    Z, nb = code.Z, code.base.shape[1]
    k, nph, _ = trng.word_layout(code.k // Z, nb, Z)
    B = words.shape[1]

    def to_unit(w):
        wu = jax.lax.bitcast_convert_type(w, jnp.uint32)
        s = jax.lax.shift_right_logical(wu, jnp.uint32(8))
        si = jax.lax.bitcast_convert_type(s, jnp.int32)
        return (si.astype(jnp.float32) * jnp.float32(2.0 ** -24)
                + jnp.float32(2.0 ** -25))

    info = (words[:k].view(np.uint32) & 1).astype(np.uint8)
    cw = qc_encode_numpy(code, info.T).T
    u1 = jnp.asarray(words[k: k + nph * Z].reshape(nph, Z, B))
    u2 = jnp.asarray(words[k + nph * Z:].reshape(nph, Z, B))
    f1, f2 = to_unit(u1), to_unit(u2)
    r = jnp.sqrt(jnp.float32(-2.0) * jnp.log(f1))
    th = jnp.float32(2.0 * np.pi) * f2
    nrm = jnp.stack([r * jnp.cos(th), r * jnp.sin(th)], axis=1).reshape(
        2 * nph, Z, B)[:nb]
    xf = (jnp.float32(1.0) - jnp.float32(2.0)
          * jnp.asarray(cw.reshape(nb, Z, B), jnp.int32).astype(jnp.float32))
    xs = (xf + jnp.asarray(sigma, jnp.float32) * nrm) * jnp.asarray(
        gain, jnp.float32)
    q = jnp.where(xs >= 0, jnp.floor(xs + 0.5), jnp.ceil(xs - 0.5))
    q = np.asarray(jnp.clip(q, -QMAX, QMAX).astype(jnp.int8))
    return info, cw, q.reshape(nb * Z, B)


def _lane_counts(hard, info):
    """Per-lane (bit_errs, frame_err) of (B, n) hard bits vs (k, B) info."""
    err = hard[:, : info.shape[0]] != info.T
    return err.sum(axis=1), err.any(axis=1).astype(np.int32)


def _check_q(q_port, q_ref):
    d = q_port.astype(np.int64) - q_ref
    assert np.abs(d).max() <= 1
    assert (d != 0).mean() <= 1e-4
    return (d == 0).all(axis=0)     # lanes whose q column is equal


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_megakernel_matches_reference_formula(rng, name):
    """Injected words through McDecoder.plain against the reference's
    formula plus the JAX plain decoder, n=648, B=256."""
    code = make_code(648, "1/2")
    ct = from_reference(code, "cpu")
    B, sigma = 256, np.float32(0.82)
    gain = gain_for(sigma, SCALE)
    assert gain == np.float32(2.0) * np.float32(SCALE) / (sigma * sigma)
    words = _random_words(rng, code, B)
    info, cw, q_ref = _reference_q(code, words, sigma, gain)
    # the prologue alone
    info_t, cw_t, q_t = make_prologue(code, QMAX)(torch.as_tensor(words),
                                                  sigma, gain)
    np.testing.assert_array_equal(info_t.numpy(), info)
    np.testing.assert_array_equal(cw_t.numpy(), cw)
    same = _check_q(q_t.numpy(), q_ref)
    # the whole step
    dc, qc = CONFIGS[name], QUANTS[name]
    d = minsum.make_decoder(ct, dc, qc, input_scale=SCALE,
                            count_info_cols=ct.kb, mc_batch=B,
                            inject_random=True)
    plain = minsum.plain_calls
    bits, frame, iters, conv = (x.numpy() for x in d(
        None, sigma, gain, words=torch.as_tensor(words)))
    assert minsum.plain_calls == plain + 1
    hard, it_r, cv_r = map(np.asarray, jref.make_decoder(code, dc, qc)(
        jnp.asarray(q_ref.T)))
    bits_r, frame_r = _lane_counts(hard, info)
    assert same.sum() >= B - 2
    for got, want in ((bits, bits_r), (frame, frame_r), (iters, it_r),
                      (conv, cv_r)):
        np.testing.assert_array_equal(got[same], np.asarray(want)[same])
    assert 0 < frame.sum() < B


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_megakernel_matches_pallas_megakernel(rng, name):
    """The same, against the Pallas megakernel itself in interpret mode
    (inject_random, the reference's own test hook)."""
    from ldpc_tpu.kernels.minsum_pallas import make_pallas_decoder
    code = make_code(648, "1/2")
    ct = from_reference(code, "cpu")
    Z, nb = code.Z, code.base.shape[1]
    kb = code.k // Z
    k, nph, _ = trng.word_layout(kb, nb, Z)
    B, sigma = 256, np.float32(0.82)
    gain = gain_for(sigma, SCALE)
    words = _random_words(rng, code, B)
    dc, qc = CONFIGS[name], QUANTS[name]
    beta = qc.beta_lsb if dc.algorithm == "offset-min-sum" else 0
    d_mc = make_pallas_decoder(
        code, qmax=QMAX, batch_tile=128, interpret=True, input_scale=SCALE,
        count_info_cols=kb, mc_batch=B, inject_random=True,
        schedule=dc.schedule, early_term=dc.early_term,
        max_iter=dc.max_iter, beta=beta)
    want = [np.asarray(x) for x in d_mc(
        jnp.zeros((3,), jnp.int32), jnp.asarray([sigma, gain], jnp.float32),
        jnp.asarray(words[:k].reshape(kb, Z, B)),
        jnp.asarray(words[k: k + nph * Z].reshape(nph, Z, B)),
        jnp.asarray(words[k + nph * Z:].reshape(nph, Z, B)))]
    d = minsum.make_decoder(ct, dc, qc, input_scale=SCALE,
                            count_info_cols=kb, mc_batch=B,
                            inject_random=True)
    got = [x.numpy() for x in d(None, sigma, gain,
                                words=torch.as_tensor(words))]
    same = _check_q(make_prologue(code, QMAX)(torch.as_tensor(words), sigma,
                                              gain)[2].numpy(),
                    _reference_q(code, words, sigma, gain)[2])
    assert same.sum() >= B - 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[same], w.astype(g.dtype)[same])


def test_lane_sigma_matches_scalar_stripes(rng):
    """Per-lane sigma rows (the fused sweep's form) == the scalar form at
    each lane's sigma, stripe by stripe, tolerance 0; Philox words."""
    code = toy_qc(4)
    ct = from_reference(code, "cpu")
    cfg = PRESETS["wifi-648-r12-minsum"]
    B, P = 48, 3
    sigmas = np.asarray([0.55, 0.8, 1.1], np.float32)
    point = np.arange(B) % P
    sl = torch.as_tensor(sigmas[point])
    kw = dict(input_scale=SCALE, count_info_cols=ct.kb, mc_batch=B)
    lane = minsum.make_decoder(ct, cfg.decoder, cfg.quant,
                               mc_lane_sigma=True, **kw)
    out = lane(1234, sigma_lane=sl, gain_lane=gain_for(sl, SCALE))
    scalar = minsum.make_decoder(ct, cfg.decoder, cfg.quant, **kw)
    for p, s in enumerate(sigmas):
        ref = scalar(1234, s, gain_for(s, SCALE))
        sel = torch.as_tensor(point == p)
        for a, b in zip(out, ref):
            assert torch.equal(a[sel], b[sel])
    assert int(out[1][torch.as_tensor(point == 2)].sum()) > 0


def test_philox_mode_is_inject_mode_of_its_words():
    """The Philox form draws exactly `rng.words(seed)`; a lane's outcome
    does not depend on the batch size."""
    ct = from_reference(make_code(648, "1/2"), "cpu")
    cfg = PRESETS["wifi-648-r12-minsum"]
    dc = dataclasses.replace(cfg.decoder, max_iter=5)
    s = np.float32(0.75)
    g = gain_for(s, SCALE)

    def make(B, inject=False):
        return minsum.make_decoder(ct, dc, cfg.quant, input_scale=SCALE,
                                   count_info_cols=ct.kb, mc_batch=B,
                                   inject_random=inject)
    a = make(24)(99, s, g)
    d = make(24, inject=True)
    b = d(None, s, g, words=trng.words(99, d.n_words, 24, "cpu"))
    c = make(12)(99, s, g)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x[:12], z)


def test_mc_wrapper_dispatch_and_refusals(rng):
    """CPU arguments run the plain version; a CUDA-looking tensor goes to
    the kernel entry, which raises without a card (no fallback); wrong
    configurations and arguments are refused."""
    code = make_code(648, "1/2")
    ct = from_reference(code, "cpu")
    cfg = PRESETS["wifi-648-r12-minsum"]
    d = minsum.make_decoder(ct, cfg.decoder, cfg.quant, input_scale=SCALE,
                            count_info_cols=ct.kb, mc_batch=4,
                            inject_random=True)
    assert d.library == "minsum_flood" and d.counting
    words = torch.as_tensor(_random_words(rng, code, 4))
    plain, launches = minsum.plain_calls, minsum.kernel_launches
    out = d(None, 0.8, gain_for(0.8, SCALE), words=words)
    assert [tuple(x.shape) for x in out] == [(4,)] * 4
    assert minsum.plain_calls == plain + 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        d(None, 0.8, 1.0, words=words.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        d.kernel(None, 0.8, 1.0, words=words)
    assert (minsum.plain_calls, minsum.kernel_launches) == (plain + 1,
                                                            launches)
    with pytest.raises(ValueError, match="words must be given"):
        d(5, 0.8, 1.0)
    with pytest.raises(ValueError, match="words shape"):
        d(None, 0.8, 1.0, words=words[:, :3])
    with pytest.raises(ValueError, match="structural kb"):
        minsum.make_decoder(ct, cfg.decoder, cfg.quant, input_scale=SCALE,
                            count_info_cols=ct.kb - 1, mc_batch=4)
    with pytest.raises(ValueError, match="input_scale"):
        minsum.make_decoder(ct, cfg.decoder, cfg.quant, mc_batch=4)
    with pytest.raises(ValueError, match="need mc_batch"):
        minsum.make_decoder(ct, cfg.decoder, cfg.quant, mc_lane_sigma=True)
    plain_qc = from_reference(expand_qc(
        np.array([[0, 0, 1, -1], [1, 0, 0, 0]]), 5, name="plain"), "cpu")
    with pytest.raises(ValueError, match="structure"):
        minsum.make_decoder(plain_qc, cfg.decoder, cfg.quant,
                            input_scale=SCALE, count_info_cols=2,
                            mc_batch=4)


def test_kernel_build_hash_covers_the_mc_headers():
    """Both libraries include the megakernel stage and Philox, so an edit
    of either header gives a new library path (a rebuild)."""
    for name in minsum.SOURCES:
        names = [p.name for p in build.sources(name)]
        assert {"mc_stage.cuh", "philox.cuh", "cn_minsum.cuh"} <= set(names)
        assert names[0] == f"{name}.cu"
    assert minsum.MC_REPLACES == "ldpc_tpu/kernels/minsum_pallas.py:990"
