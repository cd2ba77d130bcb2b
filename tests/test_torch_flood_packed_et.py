"""The packed flooding instance's early-terminating and min* forms
(flood_packed_kernel<LPT, DMAX, STAR, ET, MC> of
ldpc_tpu_torch/kernels/csrc/minsum_flood.cu: K2, K5 on the flooding
schedule and their K1-MC forms) against the references, on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py). Here a numpy
emulation of its datapath, over the whole batch, is held to
golden.decoder.decode_fixed(schedule="flooding"), to the JAX flooding
decoders (jnp for the min-sum family, the QC decoder for min*), to the
Pallas kernel in interpret mode and to the port's plain version, with
tolerance 0 on hard bits, iterations and convergence. It extends the
emulation of tests/test_torch_flood_packed.py (four lanes in a 32-bit word,
totals as 16x2 pairs, negated messages, the row held as one byte a lane)
with what the new instances add: min* with its leaves as the row bytes,
its suffixes as bytes and bp2 on magnitude pairs and sign bytes; early
termination with the syndrome fused into the C phase (the XOR of the
state-k totals over each row, stamped per running lane), a word of running
lanes whose outputs are written from the totals when each finishes while
the lane runs on unread, a closing syndrome pass of state max_iter, and
words whose lanes are all done skipping both phases. The shape rule under
the new instances' launch bound is checked against hand-computed lanes and
bytes, and the wrapper's constants against the source's."""
import dataclasses
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.golden.decoder import decode_fixed
from ldpc_tpu.ops import decode_qc as jqc
from ldpc_tpu.ops import decode_ref as jref
from ldpc_tpu_torch import PRESETS
from ldpc_tpu_torch.codes import build_code, from_reference
from ldpc_tpu_torch.config import DecoderConfig, QuantConfig
from ldpc_tpu_torch.kernels import build, minsum
from ldpc_tpu_torch.ops import decode_ref as tref
from ldpc_tpu_torch.ops import rng as trng
from ldpc_tpu_torch.ops.mc import gain_for, make_prologue
from test_torch_layered_packed import (H, emit, prmt, replicate,
                                       star_bp2, star_bytes, star_constants,
                                       star_pack, star_unpack, vadd2,
                                       viaddmax, vmaxs2, vmins2, vneg2,
                                       widen)

torch.set_num_threads(2)


# --- the packed flooding datapath with early termination and min* ----------

def packed_flood(ct, chan, max_iter, qmax, early_term, beta=0, alpha=None,
                 minstar=None):
    """flood_packed_kernel's datapath over the batch: chan int8 (n, B) ->
    (hard (B, n) uint8, iters (B,), conv (B,) bool). A word of four lanes
    stands for the threads of one lane column (they share `act`)."""
    n, Z, B = ct.n, ct.Z, chan.shape[1]
    W = -(-B // 4)
    ch = np.zeros((n, 4 * W), np.int8)
    ch[:, :B] = chan
    chw = ch.view(np.uint32)                          # (n, W)
    nmsg = np.zeros((ct.n_entries * Z, W), np.uint32)  # negated messages
    cols = [[] for _ in range(ct.nb)]
    for row in ct.entries:
        for col, s, e in row:
            cols[col].append((e, s))
    y = np.arange(Z)
    q2 = np.uint32(qmax * 0x00010001)
    dmax = minsum.row_degree_instance(ct)
    tc = star_constants(minstar) if minstar is not None else None
    valid = np.zeros(4 * W, bool)
    valid[:B] = True
    act = np.ascontiguousarray(
        np.where(valid, 0xFF, 0).astype(np.uint8)).view(np.uint32)  # (W,)
    out_hard = np.zeros((n, 4 * W), np.uint8)
    iters = np.full(4 * W, max_iter, np.int32)
    tot = [np.zeros((n, W), np.uint32), np.zeros((n, W), np.uint32)]

    def var(col, s):
        return col * Z + (y + s) % Z

    def lanes(words):
        """(W,) words of 0xff bytes -> (4W,) bool lanes."""
        return np.ascontiguousarray(words).view(np.uint8) == 0xFF

    def hard_now():
        sign = prmt(tot[0], tot[1], 0x7531)
        return (np.ascontiguousarray(sign).view(np.uint8) >> 7) & 1

    def decide(k, un):
        """Stamp the running lanes with an unsatisfied row (un: (Z, W),
        bit 7 of each byte), then finish the others at state k."""
        nonlocal act
        stamped = np.bitwise_or.reduce(un, axis=0) & act & H
        iters[lanes(act)] = k
        fin = act & ~replicate(stamped)
        out_hard[:, lanes(fin)] = hard_now()[:, lanes(fin)]
        act = act & ~fin

    def row_parity():
        un = np.zeros((Z, W), np.uint32)
        for row in ct.entries:
            x = [np.zeros((Z, W), np.uint32) for _ in range(2)]
            for col, s, _ in row:
                x = [x[k] ^ tot[k][var(col, s)] for k in range(2)]
            un |= prmt(x[0], x[1], 0x7531)
        return un

    for it in range(max_iter + 1):
        upd = act != 0 if early_term else np.ones(W, bool)
        # V phase: tot = chan - the sum of the negated messages
        lo, hi = widen(chw)
        if it:
            s_lo, s_hi = np.zeros_like(lo), np.zeros_like(hi)
            for j, col in enumerate(cols):
                for e, s in col:
                    w_lo, w_hi = widen(nmsg[e * Z + (y - s) % Z])
                    s_lo[j * Z: (j + 1) * Z] = vadd2(s_lo[j * Z: (j + 1) * Z],
                                                      w_lo)
                    s_hi[j * Z: (j + 1) * Z] = vadd2(s_hi[j * Z: (j + 1) * Z],
                                                      w_hi)
            lo, hi = vadd2(lo, vneg2(s_lo)), vadd2(hi, vneg2(s_hi))
        tot[0][:, upd] = lo[:, upd]
        tot[1][:, upd] = hi[:, upd]
        if early_term and not act.any():
            break
        if it == max_iter:
            if early_term:
                decide(it, row_parity())       # the closing syndrome pass
            break
        # C phase, every check row y of every base row at once; with ET the
        # parity of the state-`it` hard bits on the way
        un = np.zeros((Z, W), np.uint32)
        for row in ct.entries:
            d = len(row)
            slots = dmax if dmax else d
            if early_term or minstar is not None:
                slots = min(slots, (d + 3) & ~3)   # groups of four past d
            min1 = [np.full((Z, W), 0x40004000, np.uint32) for _ in range(2)]
            min2 = [np.full((Z, W), 0x40004000, np.uint32) for _ in range(2)]
            ns = np.zeros((Z, W), np.uint32)
            x = [np.zeros((Z, W), np.uint32) for _ in range(2)]
            rb = []
            for i in range(slots):
                col, s, e = row[min(i, d - 1)]
                t = [tot[k][var(col, s)] for k in range(2)]
                nw = nmsg[e * Z + y] if it else np.zeros((Z, W), np.uint32)
                r = [vadd2(t[k], widen(nw)[k]) for k in range(2)]
                m = [vmins2(vmaxs2(r[k], vneg2(r[k])), q2) for k in range(2)]
                w = prmt(m[0], m[1], 0x6420) | (prmt(r[0], r[1], 0x7531) & H)
                if minstar is None:
                    for k in range(2):
                        mk = m[k] if i < d else np.uint32(0x007F007F)
                        min2[k] = vmins2(min2[k], vmaxs2(min1[k], mk))
                        min1[k] = vmins2(min1[k], mk)
                    if i < d:
                        ns ^= w & H
                if i < d:
                    x = [x[k] ^ t[k] for k in range(2)]
                rb.append(w)
            un |= prmt(x[0], x[1], 0x7531)
            if minstar is not None:
                # the leaves are the row bytes; suffixes as bytes, backwards;
                # then the prefix pass emits
                sf = [None] * d
                acc = None
                for j in range(d - 1, 0, -1):
                    lf = star_unpack(rb[j])
                    acc = lf if j == d - 1 else star_bp2(lf, acc, tc, q2)
                    sf[j] = star_pack(acc)
                pre = None
                msgs = []
                for i in range(d):
                    if i == 0:
                        out = star_unpack(sf[1])
                    elif i == d - 1:
                        out = pre
                    else:
                        out = star_bp2(pre, star_unpack(sf[i + 1]), tc, q2)
                    if i < d - 1:
                        lf = star_unpack(rb[i])
                        pre = lf if i == 0 else star_bp2(pre, lf, tc, q2)
                    msgs.append(star_bytes(out)[0])
            else:
                a, b = list(min1), list(min2)
                if alpha is not None:
                    num, shift = alpha
                    keep = np.uint32((0xFFFF >> shift) * 0x00010001)
                    a = [((v * np.uint32(num)) >> np.uint32(shift)) & keep
                         for v in a]
                    b = [((v * np.uint32(num)) >> np.uint32(shift)) & keep
                         for v in b]
                if beta:
                    nb_ = np.uint32(((-beta) & 0xFFFF) * 0x00010001)
                    a = [viaddmax(v, nb_, np.uint32(0)) for v in a]
                    b = [viaddmax(v, nb_, np.uint32(0)) for v in b]
                m1 = prmt(min1[0], min1[1], 0x6420)
                o1, o2 = prmt(a[0], a[1], 0x6420), prmt(b[0], b[1], 0x6420)
                msgs = [emit(rb[i], m1, o1, o2, ns)[0] for i in range(d)]
            for i, (_, _, e) in enumerate(row):
                nmsg[(e * Z + y)[:, None], upd] = msgs[i][:, upd]
        if early_term:
            decide(it, un)
    rest = lanes(act) if early_term else valid
    out_hard[:, rest] = hard_now()[:, rest]
    if early_term:
        conv = ~lanes(act)
    else:
        sy = np.zeros((ct.mb * Z, 4 * W), np.uint8)
        for li, row in enumerate(ct.entries):
            for col, s, _ in row:
                sy[li * Z: (li + 1) * Z] ^= out_hard[var(col, s)]
        conv = ~sy.any(axis=0)
    return (np.ascontiguousarray(out_hard[:, :B].T), iters[:B], conv[:B])


# --- inputs and references ---------------------------------------------------

def channel_llrs(rng, n, B, sigma, qmax, scale=4.0):
    """int8 LLRs (n, B) of the all-zeros codeword over BPSK/AWGN at a spread
    of noise levels across the lanes (so lanes of one word finish at
    different iterations), lane 0 noiseless."""
    sig = np.linspace(0.6 * sigma, 1.2 * sigma, B)
    yv = 1.0 + sig * rng.standard_normal((n, B))
    yv[:, 0] = 1.0
    return np.clip(np.round(2 * yv / sig ** 2 * scale), -qmax,
                   qmax).astype(np.int8)


ALGOS = {"min-sum": dict(beta=0, alpha=None),
         "offset-beta2": dict(beta=2, alpha=None),
         "normalized-3/4": dict(beta=0, alpha=(3, 2)),
         "minstar-T830": dict(minstar=(8, 3, 0)),
         "minstar-Tnone": dict(minstar=())}


def _golden(chan, code, qmax, max_iter, early_term, **kw):
    rs = [decode_fixed(row.astype(np.int32), code, schedule="flooding",
                       qmax=qmax, early_term=early_term, max_iter=max_iter,
                       **kw) for row in chan.T]
    return (np.stack([r.hard for r in rs]).astype(np.uint8),
            np.array([r.iters for r in rs]),
            np.array([r.converged for r in rs]))


_JAX = {}


def _jax(code, max_iter, qmax, early_term, beta=0, alpha=None, minstar=None):
    """The JAX flooding decoder, one compile per code and configuration."""
    key = (code.name, max_iter, qmax, early_term, beta, alpha, minstar)
    if key not in _JAX:
        if minstar is not None:
            _JAX[key] = jqc.make_qc_decoder(
                code, schedule="flooding", max_iter=max_iter, qmax=qmax,
                early_term=early_term, minstar=minstar)
        else:
            _JAX[key] = jref.make_flooding_decoder(
                code, max_iter=max_iter, beta=beta, qmax=qmax,
                early_term=early_term, alpha=alpha)
    return _JAX[key]


def _plain(code, chan, **kw):
    out = tref.make_flooding_decoder(code, **kw)(
        torch.as_tensor(np.ascontiguousarray(chan.T)))
    return tuple(x.numpy() for x in out)


def _assert_equal(got, *wants):
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))


@functools.lru_cache(maxsize=None)
def _code(name):
    if name == "toy":
        return toy_qc(4)
    n, rate = {"wifi648": (648, "1/2"), "n1944_r56": (1944, "5/6"),
               "n1944_r34": (1944, "3/4")}[name]
    return make_code(n, rate)


def _run_all(code, chan, qmax, max_iter, early_term, golden_lanes=None,
             with_jax=True, **kw):
    """The emulation against plain, JAX (with_jax: its min* decoder takes
    a quarter of a minute to compile, so the tests past the first matrix
    hold min* to plain and golden only; plain == JAX there is
    tests/test_torch_decode_qc.py's) and golden (on `golden_lanes` lanes,
    all by default); returns the emulation's outputs."""
    ct = from_reference(code, "cpu")
    got = packed_flood(ct, chan, max_iter, qmax, early_term, **kw)
    _assert_equal(got, _plain(code, chan, max_iter=max_iter, qmax=qmax,
                              early_term=early_term, **kw))
    if with_jax:
        _assert_equal(got, _jax(code, max_iter, qmax, early_term, **kw)(
            jnp.asarray(np.ascontiguousarray(chan.T))))
    lanes = slice(None) if golden_lanes is None else slice(0, golden_lanes)
    _assert_equal(tuple(x[lanes] for x in got),
                  _golden(chan[:, lanes], code, qmax, max_iter, early_term,
                          **kw))
    return got


@pytest.mark.parametrize("early_term", [False, True], ids=["fixed", "et"])
@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("code_name", ["toy", "wifi648"])
def test_emulation_matches_golden_jax_and_plain(code_name, algo, early_term):
    """7 lanes (a ragged last word), 6 iterations; golden on every lane of
    the toy code and on three of wifi-648."""
    code = _code(code_name)
    rng = np.random.default_rng(hash((code_name, algo, early_term)) % 2**32)
    chan = channel_llrs(rng, code.n, 7, 0.8, 127)
    _run_all(code, chan, 127, 6, early_term,
             golden_lanes=None if code_name == "toy" else 3, **ALGOS[algo])


@pytest.mark.parametrize("algo", ["offset-beta2", "minstar-T830"])
@pytest.mark.parametrize("rate", ["5/6", "3/4"])
def test_emulation_n1944_et_iters_and_conv(rate, algo):
    """802.11n n=1944 (rows of 19-20: the 24-entry register row, its last
    group of four skipped; rows of 14-15: the 16-entry row), early
    termination, 20 iterations, lanes that finish at different iterations
    and lanes that do not finish; golden on the first two lanes."""
    code = _code("n1944_r56" if rate == "5/6" else "n1944_r34")
    sigma = 0.6 if rate == "5/6" else 0.68
    chan = channel_llrs(np.random.default_rng(5), code.n, 13, sigma, 127)
    kw = ALGOS[algo]
    got = _run_all(code, chan, 127, 20, True, golden_lanes=2,
                   with_jax="minstar" not in kw, **kw)
    assert len(set(got[1].tolist())) >= 3
    assert 0 < int(got[2].sum()) < 13


@pytest.mark.parametrize("algo", ["offset-beta2", "minstar-T830",
                                  "normalized-3/4"])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_emulation_quantizer_widths(bits, algo):
    """qmax 7, 31 and 127 on wifi-648 with early termination."""
    qmax = (1 << (bits - 1)) - 1
    code = _code("wifi648")
    chan = channel_llrs(np.random.default_rng(bits), code.n, 6, 0.8, qmax,
                        scale=4.0 * qmax / 127)
    kw = ALGOS[algo]
    _run_all(code, chan, qmax, 8, True, golden_lanes=2,
             with_jax="minstar" not in kw, **kw)


@pytest.mark.parametrize("B", [1, 2, 3, 5, 9])
def test_emulation_ragged_batches_match_plain(B):
    code = _code("wifi648")
    ct = from_reference(code, "cpu")
    chan = channel_llrs(np.random.default_rng(B), code.n, B, 0.85, 127)
    for et in (True, False):
        for kw in (dict(beta=2), dict(minstar=(8, 3, 0))):
            got = packed_flood(ct, chan, 6, 127, et, **kw)
            _assert_equal(got, _plain(code, chan, max_iter=6, qmax=127,
                                      early_term=et, **kw))


@pytest.mark.parametrize("algo", ["min-sum", "offset-beta2", "minstar-T830",
                                  "minstar-Tnone"])
def test_lanes_of_one_word_finish_at_different_iterations(algo):
    """Within one thread's word of four lanes, lanes finish at different
    iterations; each keeps its own iters, conv and the hard bits of its
    own first success, while the others run on."""
    code = _code("wifi648")
    ct = from_reference(code, "cpu")
    chan = channel_llrs(np.random.default_rng(11), code.n, 16, 0.85, 127)
    got = packed_flood(ct, chan, 20, 127, True, **ALGOS[algo])
    words = got[1].reshape(4, 4)
    assert any(len(set(w.tolist())) > 1 for w in words)
    _assert_equal(got, _plain(code, chan, max_iter=20, qmax=127,
                              early_term=True, **ALGOS[algo]))


@pytest.mark.parametrize("algo", ["offset-beta2", "minstar-T830"])
@pytest.mark.parametrize("code_name", ["wifi648", "n1944_r56"])
def test_all_zero_batch_finishes_at_iteration_zero(code_name, algo):
    """A noiseless batch is a codeword in state 0: the C phase of iteration
    0 finds every row satisfied, iters 0."""
    code = _code(code_name)
    ct = from_reference(code, "cpu")
    chan = np.full((code.n, 6), 8, np.int8)
    hard, iters, conv = packed_flood(ct, chan, 20, 127, True, **ALGOS[algo])
    assert not hard.any() and not iters.any() and conv.all()


@pytest.mark.parametrize("early_term", [False, True], ids=["fixed", "et"])
@pytest.mark.parametrize("algo", ["offset-beta2", "minstar-T830"])
def test_max_iter_one(algo, early_term):
    """One iteration: with ET the C phase of iteration 0 checks state 0
    and the closing pass state 1."""
    code = _code("wifi648")
    chan = channel_llrs(np.random.default_rng(21), code.n, 9, 0.55, 127)
    kw = ALGOS[algo]
    got = _run_all(code, chan, 127, 1, early_term, golden_lanes=3,
                   with_jax="minstar" not in kw, **kw)
    if early_term:
        assert set(got[1].tolist()) <= {0, 1} and got[2].any()


def _pallas(code, ct, chan, max_iter, early_term, B, **kw):
    from ldpc_tpu.kernels.minsum_pallas import make_pallas_decoder
    pal = make_pallas_decoder(code, qmax=127, schedule="flooding",
                              early_term=early_term, max_iter=max_iter,
                              batch_tile=4, interpret=True,
                              pre_transposed=True, **kw)
    out = pal(jnp.asarray(chan.reshape(ct.nb, ct.Z, B)))
    hard = np.asarray(out[0]).reshape(ct.n, B).T
    return hard, np.asarray(out[1]), np.asarray(out[2])


@pytest.mark.parametrize("early_term", [False, True], ids=["fixed", "et"])
@pytest.mark.parametrize("algo", ["offset-beta2", "minstar-T830"])
def test_emulation_matches_pallas_interpret_toy(algo, early_term):
    """The toy code (Z=4) against the Pallas flooding kernel in interpret
    mode, pre-transposed layout, as tests/test_torch_kernels.py runs it."""
    code = _code("toy")
    ct = from_reference(code, "cpu")
    chan = channel_llrs(np.random.default_rng(3), code.n, 8, 0.9, 127)
    got = packed_flood(ct, chan, 6, 127, early_term, **ALGOS[algo])
    _assert_equal(got, _pallas(code, ct, chan, 6, early_term, 8,
                               **ALGOS[algo]))


@pytest.mark.slow
@pytest.mark.parametrize("algo", ["offset-beta2", "minstar-T830"])
def test_emulation_matches_pallas_interpret_wifi648(algo):
    """wifi-648 with early termination against the Pallas kernel in
    interpret mode (tens of seconds on a CPU, hence slow)."""
    code = _code("wifi648")
    ct = from_reference(code, "cpu")
    chan = channel_llrs(np.random.default_rng(4), code.n, 8, 0.85, 127)
    got = packed_flood(ct, chan, 4, 127, True, **ALGOS[algo])
    _assert_equal(got, _pallas(code, ct, chan, 4, True, 8, **ALGOS[algo]))


# --- the megakernel ----------------------------------------------------------

MC_CONFIGS = {
    "oms-et": (DecoderConfig(algorithm="offset-min-sum", schedule="flooding",
                             early_term=True, max_iter=6),
               QuantConfig(beta_lsb=2)),
    "minsum-et": (DecoderConfig(algorithm="min-sum", schedule="flooding",
                                early_term=True, max_iter=6),
                  QuantConfig()),
    "minstar-et": (DecoderConfig(algorithm="min-star", schedule="flooding",
                                 early_term=True, max_iter=6),
                   QuantConfig(beta_lsb=0)),
    "minstar-fixed": (DecoderConfig(algorithm="min-star",
                                    schedule="flooding", early_term=False,
                                    max_iter=6),
                      QuantConfig(beta_lsb=0)),
}


def _mc_words(rng, code, B):
    Z = code.Z
    W = trng.word_layout(code.k // Z, code.base.shape[1], Z)[2]
    return rng.integers(0, 1 << 32, (W, B), dtype=np.uint32).view(np.int32)


def _mc_emulated(code, words, sigma, gain, dc, qc):
    """The megakernel on injected words: the prologue's info bits and int8
    LLRs, the packed flooding datapath, the per-lane counts."""
    ct = from_reference(code, "cpu")
    info, _, q = make_prologue(code, qc.qmax)(torch.as_tensor(words), sigma,
                                              gain)
    if dc.algorithm == "min-star":
        kw = dict(minstar=tuple(minsum.minstar_thresholds(qc)))
    else:
        beta, alpha = minsum.cn_params(dc, qc)
        kw = dict(beta=beta, alpha=alpha)
    hard, iters, conv = packed_flood(ct, q.numpy(), dc.max_iter, qc.qmax,
                                     dc.early_term, **kw)
    err = hard[:, : code.k] != info.numpy().T
    return (err.sum(axis=1), err.any(axis=1).astype(np.int32), iters, conv)


@pytest.mark.parametrize("name", sorted(MC_CONFIGS))
def test_mc_inject_emulation_matches_plain_megakernel(rng, name):
    """Injected words on n=648 flooding: the emulated megakernel == the
    port's plain megakernel (McDecoder.plain), lane for lane."""
    code = _code("wifi648")
    ct = from_reference(code, "cpu")
    dc, qc = MC_CONFIGS[name]
    B, sigma = 37, np.float32(0.82)
    gain = gain_for(sigma, qc.scale)
    words = _mc_words(rng, code, B)
    got = _mc_emulated(code, words, sigma, gain, dc, qc)
    d = minsum.make_decoder(ct, dc, qc, input_scale=qc.scale,
                            count_info_cols=ct.kb, mc_batch=B,
                            inject_random=True)
    assert d.decoder.packed
    want = d(None, sigma, gain, words=torch.as_tensor(words))
    _assert_equal(got, tuple(x.numpy() for x in want))
    assert 0 < int(got[1].sum()) < B


# --- the shape rule ------------------------------------------------------------

def _ct(n, rate):
    return from_reference(make_code(n, rate), "cpu")


def _preset_ct(name, **code):
    cfg = PRESETS[name]
    cfg = dataclasses.replace(cfg, code=dataclasses.replace(cfg.code, **code))
    return from_reference(build_code(cfg), "cpu")


# Hand-computed: the state is the fixed instance's (per lane 2n B of
# totals, n of channel, E * Z of messages, 8 B of counters, each part
# rounded up to 16 B), but a block holds at most 256 threads. n=648 (Z=27,
# E*Z = 2,376): 4 lanes = 32 + 5,184 + 2,592 + 9,504 = 17,312 B, 12 blocks =
# 48 codewords; up to 9 columns (243 threads) no shape holds more (8 lanes:
# 6 blocks, 36 lanes: one), so 4 lanes, as for the fixed instance, whose one
# block of 52 lanes (351 threads) the bound now excludes. n=1944 r5/6 (Z=81,
# E*Z = 6,399 -> 25,600): 32 + 15,552 + 7,776 + 25,600 = 48,960 B, 4 blocks;
# at most 3 columns (243 threads). r3/4 (E*Z = 6,885): 50,912 B, 4 blocks.
# n=1296 r1/2 (Z=54, E*Z = 4,644): 34,160 B, 6 blocks = 24 codewords, which
# 8 and 12 lanes (3 and 2 blocks) only equal.
@pytest.mark.parametrize("n,rate,want", [
    (648, "1/2", (4, 4, 17312, 12)),
    (1944, "5/6", (4, 4, 48960, 4)),
    (1944, "3/4", (4, 4, 50912, 4)),
    (1296, "1/2", (4, 4, 34160, 6)),
])
def test_et_and_minstar_packed_shape_hand_computed(n, rate, want):
    ct = _ct(n, rate)
    lanes, _, smem, _ = want
    star = minsum.star_degree(ct, DecoderConfig(algorithm="min-star"))
    for sd, et in ((0, True), (star, False), (star, True)):
        assert minsum.packed_shape(ct, "flooding", sd, et) == want
        assert minsum.is_packed(ct, "flooding", sd, et)
        assert minsum.pick_lanes(ct, "flooding", sd, et) == lanes
        assert minsum.onchip_smem_bytes(ct, "flooding", sd, lanes, et) == smem


def test_launch_bound_caps_the_et_and_minstar_block():
    """The toy code (Z=4): the fixed instance's rule weighs blocks of up to
    256 columns of four threads (1,024 threads) and takes 76 lanes, 21
    blocks an SM; the ET and min* instances weigh at most 64 columns (256
    threads), whose best holds fewer codewords an SM, and take 60 lanes, 26
    blocks."""
    ct = from_reference(_code("toy"), "cpu")
    star = minsum.star_degree(ct, DecoderConfig(algorithm="min-star"))
    assert minsum.packed_shape(ct) == (76, 4, 10032, 21)
    for sd, et in ((0, True), (star, False)):
        assert minsum.packed_shape(ct, "flooding", sd, et) == (60, 4, 7920,
                                                               26)
    assert minsum.flood_max_threads(0, False) == minsum.MAX_THREADS
    assert minsum.flood_max_threads(0, True) == minsum.FLOOD_ET_STAR_THREADS
    assert minsum.flood_max_threads(7, False) == minsum.FLOOD_ET_STAR_THREADS


@pytest.mark.parametrize("name,code", [
    ("dvbs2-64800-r12", dict(n=16200)),       # 86,760 B a codeword
    ("nr-bg1-layered", {}),                    # Z=384: above 256 threads
])
def test_codes_without_a_block_of_four_take_the_two_lane_instance(name,
                                                                  code):
    """Checks that these codes, which no block of four lanes a thread fits
    (their channel, totals and messages exceed a block's shared memory, or
    NR BG1's 384 threads the bound), take the two-lane instance (the
    channel in device memory, 384 threads a block) and not the one-lane
    template, in every early-terminating and min* form: their rows (7, 22)
    fit a register row."""
    ct = _preset_ct(name, **code)
    star = minsum.star_degree(ct, DecoderConfig(algorithm="min-star"))
    assert star <= max(minsum.ROW_DEGREES)
    for sd, et in ((0, True), (star, False), (star, True)):
        lanes, lpt, smem, blocks = minsum.packed_shape(ct, "flooding", sd,
                                                       et)
        assert (lanes, lpt, blocks) == (2, minsum.TWO_LANES, 1)
        assert lanes // lpt * ct.Z <= minsum.TWO_LANE_THREADS
        assert minsum.packed_smem_bytes(ct, 4, "flooding") > minsum.MAX_SMEM
        assert minsum.is_packed(ct, "flooding", sd, et)
    d = minsum.make_decoder(ct, DecoderConfig(schedule="flooding",
                                              early_term=True),
                            QuantConfig())
    assert d.packed and d.lanes_per_thread == minsum.TWO_LANES
    assert d._launch_tables == (d._ptab.ctypes.data, len(d._ptab))


def test_minstar_rows_above_24_keep_the_one_lane_template():
    """The (3,30) array code: rows of 30 fit no min* register row; its
    min-sum instances, fixed and with early termination, read the row twice
    in the packed kernel."""
    from ldpc_tpu_torch.codes import qc_entries
    from ldpc_tpu_torch.codes.toy import array_qc
    _, entries = qc_entries(array_qc(3, 30, 31))
    ct = dataclasses.replace(_ct(648, "1/2"), entries=entries)
    assert minsum.row_degree_instance(ct) == 0
    assert not minsum.is_packed(ct, "flooding", 30, True)
    assert not minsum.is_packed(ct, "flooding", 30, False)
    assert minsum.is_packed(ct, "flooding", 0, True)


@pytest.mark.parametrize("algorithm,early_term", [
    ("offset-min-sum", True), ("min-star", True), ("min-star", False)])
def test_flooding_decoder_takes_the_packed_tables(algorithm, early_term):
    ct = _ct(1944, "5/6")
    d = minsum.make_decoder(ct, DecoderConfig(algorithm=algorithm,
                                              schedule="flooding",
                                              early_term=early_term),
                            QuantConfig(beta_lsb=2 if "offset" in algorithm
                                        else 0))
    assert d.packed and d.library == "minsum_flood"
    assert d._launch_tables == (d._ptab.ctypes.data, len(d._ptab))
    assert d.param_words() == len(d._ptab) <= minsum.TAB_WORDS


def test_flood_constants_mirror_the_source():
    src = (build.CSRC / "minsum_flood.cu").read_text()
    m = re.search(r"constexpr int kFloodEtStarThreads = (\d+);", src)
    assert m and int(m.group(1)) == minsum.FLOOD_ET_STAR_THREADS
    # the bounds the two kernel templates are declared with, and the rule's
    fixed = re.search(r"__launch_bounds__\(kMaxThreads\)\s+"
                      r"flood_packed_kernel\(", src)
    et_star = re.search(r"__launch_bounds__\(kFloodEtStarThreads, 1\)\s+"
                        r"flood_packed_kernel\(", src)
    assert fixed and et_star
    assert re.search(r"return star_deg > 0 \|\| early_term \? "
                     r"kFloodEtStarThreads : kMaxThreads;", src)
