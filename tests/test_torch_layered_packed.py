"""The packed layered instance (layered_packed_kernel of
ldpc_tpu_torch/kernels/csrc/minsum_layered.cu: K3, K5 on the layered
schedule and the layered K1-MC) against the references, on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py). Here a numpy
emulation of its datapath, over the whole batch, is held to
golden.decoder.decode_fixed(schedule="layered"), to the JAX layered
decoders (jnp for the min-sum family, the QC decoder for min*), to the
Pallas kernel in interpret mode and to the port's plain version, with
tolerance 0 on hard bits, iterations and convergence: four codeword lanes
packed in a 32-bit word (byte k = lane k), posteriors as 16x2 pairs, the
messages stored negated, the check row held as raw values (unclipped 16x2
pairs) and row bytes (min(|raw|, qmax) | sign << 7 a lane) in DMAX slots
with padded entries past the row's degree, the emit on the four bytes at
once and the posterior update post = raw + new; min* with its values as
magnitude pairs and sign bytes, its suffixes as bytes, bp2's correction as
add-min-relu steps on two lanes; early termination with a word of running
lanes whose outputs are written when each finishes. The shape rule
(`packed_shape(ct, "layered")`) is checked against hand-computed lanes and
bytes, its refusals, and the wrapper's constants against the source's."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.qcstruct import qc_encode_numpy
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

torch.set_num_threads(2)

H = np.uint32(0x80808080)
ONE2 = np.uint32(0x00010001)


# --- the kernel's word operations on uint32 arrays -------------------------

def prmt(a, b, sel):
    """PTX prmt.b32 in its default mode: byte k of the result is byte
    (nibble k & 7) of (b:a), or that byte's sign replicated when nibble k
    has bit 3 set."""
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32)
    src = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    out = np.zeros(np.broadcast(a, b).shape, np.uint32)
    for k in range(4):
        s = (sel >> (4 * k)) & 0xF
        byte = ((src >> np.uint64(8 * (s & 7))) & np.uint64(0xFF)).astype(
            np.uint32)
        if s & 8:
            byte = np.where(byte & 0x80, 0xFF, 0).astype(np.uint32)
        out |= byte << np.uint32(8 * k)
    return out


def _halves(x):
    x = np.asarray(x, np.uint32)
    return ((x & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int32),
            (x >> 16).astype(np.uint16).view(np.int16).astype(np.int32))


def _pack(lo, hi):
    return ((lo.astype(np.uint32) & 0xFFFF)
            | ((hi.astype(np.uint32) & 0xFFFF) << np.uint32(16)))


def _pairwise(f):
    def op(*xs):
        hs = [_halves(x) for x in xs]
        return _pack(f(*(h[0] for h in hs)), f(*(h[1] for h in hs)))
    return op


vadd2 = _pairwise(lambda a, b: a + b)                          # __vadd2
vmins2 = _pairwise(np.minimum)                                 # __vmins2
vmaxs2 = _pairwise(np.maximum)                                 # __vmaxs2
# __viaddmin_s16x2_relu: max(min(a + b, c), 0) a half
viaddmin_relu = _pairwise(lambda a, b, c: np.maximum(np.minimum(a + b, c),
                                                     0))
# __viaddmax_s16x2: max(a + b, c) a half
viaddmax = _pairwise(lambda a, b, c: np.maximum(a + b, c))


def vneg2(a):
    return vadd2(~np.asarray(a, np.uint32), ONE2)


def widen(w):
    """int8 lanes 0, 1 and 2, 3 of w as sign-extended 16x2 pairs."""
    return prmt(w, 0, 0x9180), prmt(w, 0, 0xB3A2)


def replicate(b):
    """bit 7 of every byte over its byte (prmt's sign mode)."""
    return prmt(b, 0, 0xBA98)


def emit(w, m1, o1, o2, ns):
    """PackedEmit::emit: the negated new message bytes of an entry from its
    row bytes, and the new message bytes."""
    x = (w & np.uint32(0x7F7F7F7F)) ^ m1
    ne = replicate(x + np.uint32(0x7F7F7F7F))
    mag = (o1 & ne) | (o2 & ~ne)
    sm = replicate(w ^ ns)
    negm = (H - mag) ^ H
    return (mag & sm) | (negm & ~sm), (negm & sm) | (mag & ~sm)


# --- min* on packed lanes ----------------------------------------------------

def star_leaf(raw, q2):
    """StarVal of raw pairs: magnitudes min(|raw|, qmax), signs in bit 7."""
    m = [vmins2(vmaxs2(r, vadd2(~r, ONE2)), q2) for r in raw]
    return m, prmt(raw[0], raw[1], 0x7531)


def star_pack(v):
    return prmt(v[0][0], v[0][1], 0x6420) | (v[1] & H)


def star_unpack(w):
    mb = w & np.uint32(0x7F7F7F7F)
    return [prmt(mb, 0, 0x4140), prmt(mb, 0, 0x4342)], w


def star_bp2(x, y, tc, q2):
    """star_bp2 of cn_packed.cuh: the correction as -#{T : d <= T < s}, each
    term min([T < s], [d <= T]) from two add-min-relu steps."""
    s_out = x[1] ^ y[1]
    m = []
    for k in range(2):
        mn = vmins2(x[0][k], y[0][k])
        if tc:
            s = vadd2(x[0][k], y[0][k])
            e = vadd2(mn, ~vmaxs2(x[0][k], y[0][k]))
            acc = np.zeros_like(mn)
            for nt, t2 in tc:
                acc = vadd2(acc, vmins2(viaddmin_relu(s, nt, ONE2),
                                        viaddmin_relu(e, t2, ONE2)))
            mn = viaddmin_relu(vadd2(mn, ~acc), ONE2, q2)
        m.append(mn)
    return m, s_out


def star_bytes(v):
    """(negated message bytes, message bytes) of a StarVal."""
    mb = prmt(v[0][0], v[0][1], 0x6420)
    negm = (H - mb) ^ H
    sm = replicate(v[1])
    return (mb & sm) | (negm & ~sm), (negm & sm) | (mb & ~sm)


def star_constants(T):
    """(-T, T + 2) of each threshold as 16x2 pairs (star_constants)."""
    return [(np.uint32(((-t) & 0xFFFF) * 0x10001),
             np.uint32(((t + 2) & 0xFFFF) * 0x10001)) for t in T]


# --- the packed layered datapath ---------------------------------------------

def packed_layered(ct, chan, max_iter, qmax, early_term, beta=0, alpha=None,
                   minstar=None):
    """The packed layered kernel's datapath over the batch: chan int8 (n, B)
    -> (hard (B, n) uint8, iters (B,), conv (B,) bool)."""
    n, Z, B = ct.n, ct.Z, chan.shape[1]
    W = -(-B // 4)
    ch = np.zeros((n, 4 * W), np.int8)
    ch[:, :B] = chan
    lo, hi = widen(ch.view(np.uint32))             # posteriors, (n, W) each
    post = [lo, hi]
    nmsg = np.zeros((ct.n_entries * Z, W), np.uint32)  # negated messages
    y = np.arange(Z)
    q2 = np.uint32(qmax * 0x00010001)
    dmax = minsum.row_degree_instance(ct, "layered")
    tc = star_constants(minstar) if minstar is not None else None
    valid = np.zeros(4 * W, bool)
    valid[:B] = True
    act = np.ascontiguousarray(
        np.where(valid, 0xFF, 0).astype(np.uint8)).view(np.uint32)  # (W,)
    out_hard = np.zeros((n, 4 * W), np.uint8)
    iters = np.full(4 * W, max_iter if not early_term else 0, np.int32)

    def var(col, s):
        return col * Z + (y + s) % Z

    def lanes(word_mask):
        """(W,) words of 0xff bytes -> (4W,) bool lanes."""
        return np.ascontiguousarray(word_mask).view(np.uint8) == 0xFF

    def hard_now():
        sign = prmt(post[0], post[1], 0x7531)
        return ((np.ascontiguousarray(sign).view(np.uint8) >> 7) & 1)

    def check(k):
        nonlocal act
        un = np.zeros((Z, W), np.uint32)
        for row in ct.entries:
            x0 = np.zeros((Z, W), np.uint32)
            x1 = np.zeros((Z, W), np.uint32)
            for col, s, _ in row:
                v = var(col, s)
                x0 ^= post[0][v]
                x1 ^= post[1][v]
            un |= prmt(x0, x1, 0x7531)
        stamped = np.bitwise_or.reduce(un, axis=0) & act & H
        running = lanes(act)
        iters[running] = k
        fin = act & ~replicate(stamped)
        done = lanes(fin)
        out_hard[:, done] = hard_now()[:, done]
        act = act & ~fin

    if early_term:
        check(0)
    for it in range(max_iter):
        if early_term and not act.any():
            break
        upd = act != 0 if early_term else np.ones(W, bool)
        for row in ct.entries:
            d = len(row)
            slots = dmax if dmax else d
            raw, rb = [], []
            min1 = [np.full((Z, W), 0x40004000, np.uint32) for _ in range(2)]
            min2 = [np.full((Z, W), 0x40004000, np.uint32) for _ in range(2)]
            ns = np.zeros((Z, W), np.uint32)
            for i in range(slots):
                col, s, e = row[min(i, d - 1)]
                v = var(col, s)
                nw = nmsg[e * Z + y] if it else np.zeros((Z, W), np.uint32)
                r = [vadd2(post[k][v], widen(nw)[k]) for k in range(2)]
                raw.append(r)
                if minstar is not None:
                    continue
                m = [vmins2(vmaxs2(r[k], vneg2(r[k])), q2) for k in range(2)]
                for k in range(2):
                    mk = m[k] if i < d else np.uint32(0x007F007F)
                    min2[k] = vmins2(min2[k], vmaxs2(min1[k], mk))
                    min1[k] = vmins2(min1[k], mk)
                w = prmt(m[0], m[1], 0x6420) | (prmt(r[0], r[1], 0x7531) & H)
                if i < d:
                    ns ^= w & H
                rb.append(w)
            if minstar is not None:
                # suffixes as bytes, backwards; then the prefix pass emits
                suf = [None] * d
                acc = None
                for j in range(d - 1, 0, -1):
                    leaf = star_leaf(raw[j], q2)
                    acc = leaf if j == d - 1 else star_bp2(leaf, acc, tc, q2)
                    suf[j] = star_pack(acc)
                pre = None
                outs = []
                for i in range(d):
                    if i == 0:
                        out = star_unpack(suf[1])
                    elif i == d - 1:
                        out = pre
                    else:
                        out = star_bp2(pre, star_unpack(suf[i + 1]), tc, q2)
                    if i < d - 1:
                        leaf = star_leaf(raw[i], q2)
                        pre = leaf if i == 0 else star_bp2(pre, leaf, tc, q2)
                    outs.append(star_bytes(out))
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
                outs = [emit(rb[i], m1, o1, o2, ns) for i in range(d)]
            for i, (col, s, e) in enumerate(row):
                msg, nv = outs[i]
                v = var(col, s)
                idx = e * Z + y
                nmsg[idx[:, None], upd] = msg[:, upd]
                for k in range(2):
                    new = vadd2(raw[i][k], widen(nv)[k])
                    post[k][v[:, None], upd] = new[:, upd]
        if early_term:
            check(it + 1)
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
    return (np.ascontiguousarray(out_hard[:, :B].T), iters[:B],
            conv[:B])


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
    rs = [decode_fixed(row.astype(np.int32), code, schedule="layered",
                       qmax=qmax, early_term=early_term, max_iter=max_iter,
                       **kw) for row in chan.T]
    return (np.stack([r.hard for r in rs]).astype(np.uint8),
            np.array([r.iters for r in rs]),
            np.array([r.converged for r in rs]))


_JAX = {}


def _jax(code, max_iter, qmax, early_term, beta=0, alpha=None, minstar=None):
    """The JAX decoder, one compile per code and configuration."""
    key = (code.name, max_iter, qmax, early_term, beta, alpha, minstar)
    if key not in _JAX:
        _JAX[key] = _make_jax(code, max_iter, qmax, early_term, beta, alpha,
                              minstar)
    return _JAX[key]


def _make_jax(code, max_iter, qmax, early_term, beta, alpha, minstar):
    if minstar is not None:
        return jqc.make_qc_decoder(code, schedule="layered",
                                   max_iter=max_iter, qmax=qmax,
                                   early_term=early_term, minstar=minstar)
    return jref.make_layered_decoder(code, max_iter=max_iter, beta=beta,
                                     qmax=qmax, early_term=early_term,
                                     alpha=alpha)


def _plain(code, chan, **kw):
    out = tref.make_layered_decoder(code, **kw)(
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
             **kw):
    """The emulation against plain, JAX and golden (on `golden_lanes`
    lanes, all by default); returns the emulation's outputs."""
    ct = from_reference(code, "cpu")
    got = packed_layered(ct, chan, max_iter, qmax, early_term, **kw)
    _assert_equal(got, _plain(code, chan, max_iter=max_iter, qmax=qmax,
                              early_term=early_term, **kw))
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
    """7 lanes (a ragged last word), 6 iterations."""
    code = _code(code_name)
    rng = np.random.default_rng(hash((code_name, algo, early_term)) % 2**32)
    chan = channel_llrs(rng, code.n, 7, 0.8, 127)
    _run_all(code, chan, 127, 6, early_term, **ALGOS[algo])


@pytest.mark.parametrize("rate", ["5/6", "3/4"])
def test_emulation_n1944_oms_et_iters_and_conv(rate):
    """802.11n n=1944 (rows of 19-20: the 20-entry register row; rows of
    14-15: the 16-entry row), offset min-sum beta=2, early termination, 20
    iterations, lanes that finish at different iterations and lanes that
    do not finish; golden on the first five lanes."""
    code = _code("n1944_r56" if rate == "5/6" else "n1944_r34")
    sigma = 0.6 if rate == "5/6" else 0.68
    chan = channel_llrs(np.random.default_rng(5), code.n, 13, sigma, 127)
    got = _run_all(code, chan, 127, 20, True, golden_lanes=5, beta=2)
    assert len(set(got[1].tolist())) >= 3
    assert 0 < int(got[2].sum()) < 13


@pytest.mark.parametrize("algo", ["offset-beta2", "minstar-T830"])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_emulation_quantizer_widths(bits, algo):
    """qmax 7, 31 and 127 on wifi-648 with early termination."""
    qmax = (1 << (bits - 1)) - 1
    code = _code("wifi648")
    chan = channel_llrs(np.random.default_rng(bits), code.n, 6, 0.8, qmax,
                        scale=4.0 * qmax / 127)
    kw = dict(ALGOS[algo])
    _run_all(code, chan, qmax, 8, True, golden_lanes=3, **kw)


@pytest.mark.parametrize("B", [1, 2, 3, 5, 9])
def test_emulation_ragged_batches_match_plain(B):
    code = _code("wifi648")
    ct = from_reference(code, "cpu")
    chan = channel_llrs(np.random.default_rng(B), code.n, B, 0.85, 127)
    for kw in (dict(beta=2), dict(minstar=(8, 3, 0))):
        got = packed_layered(ct, chan, 10, 127, True, **kw)
        _assert_equal(got, _plain(code, chan, max_iter=10, qmax=127,
                                  early_term=True, **kw))


@pytest.mark.parametrize("algo", ["offset-beta2", "minstar-T830"])
def test_lanes_of_one_word_finish_at_different_iterations(algo):
    """Within one thread's word of four lanes, lanes finish at different
    iterations; each keeps its own iters, conv and the hard bits of its
    own first success."""
    code = _code("wifi648")
    ct = from_reference(code, "cpu")
    chan = channel_llrs(np.random.default_rng(11), code.n, 16, 0.85, 127)
    got = packed_layered(ct, chan, 20, 127, True, **ALGOS[algo])
    words = got[1].reshape(4, 4)
    assert any(len(set(w.tolist())) > 1 for w in words)
    _assert_equal(got, _plain(code, chan, max_iter=20, qmax=127,
                              early_term=True, **ALGOS[algo]))


@pytest.mark.parametrize("algo", ["offset-beta2", "minstar-T830"])
def test_all_zero_batch_finishes_at_iteration_zero(algo):
    code = _code("n1944_r56")
    ct = from_reference(code, "cpu")
    chan = np.full((code.n, 6), 8, np.int8)
    hard, iters, conv = packed_layered(ct, chan, 20, 127, True,
                                       **ALGOS[algo])
    assert not hard.any() and not iters.any() and conv.all()


def _pallas(code, ct, chan, max_iter, early_term, B, **kw):
    from ldpc_tpu.kernels.minsum_pallas import make_pallas_decoder
    pal = make_pallas_decoder(code, qmax=127, schedule="layered",
                              early_term=early_term, max_iter=max_iter,
                              batch_tile=4, interpret=True,
                              pre_transposed=True, **kw)
    out = pal(jnp.asarray(chan.reshape(ct.nb, ct.Z, B)))
    hard = np.asarray(out[0]).reshape(ct.n, B).T
    return hard, np.asarray(out[1]), np.asarray(out[2])


@pytest.mark.parametrize("early_term", [False, True], ids=["fixed", "et"])
@pytest.mark.parametrize("algo", ["offset-beta2", "minstar-T830"])
def test_emulation_matches_pallas_interpret_toy(algo, early_term):
    """The toy code (Z=4) against the Pallas layered kernel in interpret
    mode, pre-transposed layout, as tests/test_torch_layered.py runs it."""
    code = _code("toy")
    ct = from_reference(code, "cpu")
    chan = channel_llrs(np.random.default_rng(3), code.n, 8, 0.9, 127)
    got = packed_layered(ct, chan, 6, 127, early_term, **ALGOS[algo])
    _assert_equal(got, _pallas(code, ct, chan, 6, early_term, 8,
                               **ALGOS[algo]))


@pytest.mark.slow
@pytest.mark.parametrize("algo", ["offset-beta2", "minstar-T830"])
def test_emulation_matches_pallas_interpret_wifi648(algo):
    """wifi-648 against the Pallas kernel in interpret mode (tens of
    seconds on a CPU, hence slow)."""
    code = _code("wifi648")
    ct = from_reference(code, "cpu")
    chan = channel_llrs(np.random.default_rng(4), code.n, 8, 0.85, 127)
    got = packed_layered(ct, chan, 4, 127, True, **ALGOS[algo])
    _assert_equal(got, _pallas(code, ct, chan, 4, True, 8, **ALGOS[algo]))


# --- the megakernel ----------------------------------------------------------

MC_CONFIGS = {"oms": (DecoderConfig(algorithm="offset-min-sum",
                                    schedule="layered", early_term=True,
                                    max_iter=6),
                      QuantConfig(beta_lsb=2)),
              "minstar": (DecoderConfig(algorithm="min-star",
                                        schedule="layered", early_term=True,
                                        max_iter=6),
                          QuantConfig(beta_lsb=0))}


def _mc_words(rng, code, B):
    Z = code.Z
    W = trng.word_layout(code.k // Z, code.base.shape[1], Z)[2]
    return rng.integers(0, 1 << 32, (W, B), dtype=np.uint32).view(np.int32)


def _mc_emulated(code, words, sigma, gain, dc, qc):
    """The megakernel on injected words: the prologue's info bits and int8
    LLRs, the packed layered datapath, the per-lane counts."""
    ct = from_reference(code, "cpu")
    info, _, q = make_prologue(code, qc.qmax)(torch.as_tensor(words), sigma,
                                              gain)
    beta, alpha = (0, None)
    kw = {}
    if dc.algorithm == "min-star":
        kw["minstar"] = tuple(minsum.minstar_thresholds(qc))
    else:
        beta, alpha = minsum.cn_params(dc, qc)
        kw.update(beta=beta, alpha=alpha)
    hard, iters, conv = packed_layered(ct, q.numpy(), dc.max_iter, qc.qmax,
                                       dc.early_term, **kw)
    err = hard[:, : code.k] != info.numpy().T
    return (err.sum(axis=1), err.any(axis=1).astype(np.int32), iters, conv)


@pytest.mark.parametrize("name", sorted(MC_CONFIGS))
def test_mc_inject_emulation_matches_plain_megakernel(rng, name):
    """Injected words on n=648 layered with early termination: the
    emulated megakernel == the port's plain megakernel (McDecoder.plain),
    lane for lane, as tests/test_kernels.py:336 holds the TPU one."""
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
    want = d(None, sigma, gain, words=torch.as_tensor(words))
    _assert_equal(got, tuple(x.numpy() for x in want))
    assert 0 < int(got[1].sum()) < B


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(MC_CONFIGS))
def test_mc_inject_emulation_matches_pallas_megakernel(rng, name):
    """The same against the Pallas megakernel in interpret mode with
    inject_random (lanes whose LLRs equal the reference's: torch's libm and
    XLA's may differ by an ulp, see tests/test_torch_mc.py)."""
    from ldpc_tpu.kernels.minsum_pallas import make_pallas_decoder
    code = _code("wifi648")
    Z, nb = code.Z, code.base.shape[1]
    kb = code.k // Z
    k, nph, _ = trng.word_layout(kb, nb, Z)
    dc, qc = MC_CONFIGS[name]
    B, sigma = 128, np.float32(0.82)
    gain = gain_for(sigma, qc.scale)
    words = _mc_words(rng, code, B)
    kw = (dict(minstar=tuple(minsum.minstar_thresholds(qc)))
          if dc.algorithm == "min-star" else dict(beta=qc.beta_lsb))
    d_mc = make_pallas_decoder(
        code, qmax=qc.qmax, batch_tile=128, interpret=True,
        input_scale=qc.scale, count_info_cols=kb, mc_batch=B,
        inject_random=True, schedule="layered", early_term=True,
        max_iter=dc.max_iter, **kw)
    want = [np.asarray(x) for x in d_mc(
        jnp.zeros((3,), jnp.int32), jnp.asarray([sigma, gain], jnp.float32),
        jnp.asarray(words[:k].reshape(kb, Z, B)),
        jnp.asarray(words[k: k + nph * Z].reshape(nph, Z, B)),
        jnp.asarray(words[k + nph * Z:].reshape(nph, Z, B)))]
    got = _mc_emulated(code, words, sigma, gain, dc, qc)
    info = (words[:k].view(np.uint32) & 1).astype(np.uint8)
    cw = qc_encode_numpy(code, info.T).T
    assert cw.shape == (code.n, B)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(g.dtype))


# --- the shape rule ------------------------------------------------------------

def _ct(n, rate):
    return from_reference(make_code(n, rate), "cpu")


# Hand-computed: per lane 2n B of posteriors and E * Z of messages, plus 8 B
# of counters, each part rounded up to 16 B for the block; an SM gives
# blocks 233,472 B with a 1,024 B reserve each; up to 256 threads a block.
# n=648 (E*Z = 2,376): 4 lanes = 32 + 5,184 + 9,504 = 14,720 B, 14 blocks =
# 56 codewords; 8 lanes (2 warps) 29,440 B, 7 blocks = 56; the most any
# shape holds is 60 (12 lanes, 5 blocks; 20 lanes, 3 blocks), and 56 >= 9/10
# of 60, so 4 lanes. n=1944 r5/6 (E*Z = 6,399 -> 25,600 at 4 lanes): 32 +
# 15,552 + 25,600 = 41,184 B, 5 blocks = 20 codewords; 8 lanes (162 threads)
# 82,336 B, 2 blocks = 16; 12 lanes exceed 256 threads. r3/4 (E*Z = 6,885):
# 32 + 15,552 + 27,552 = 43,136 B, 5 blocks. r1/2 (E*Z = 6,966): 32 + 15,552
# + 27,872 = 43,456 B, 5 blocks. n=1296 r1/2 (Z=54, E*Z = 4,644): 32 +
# 10,368 + 18,576 = 28,976 B, 7 blocks = 28; 8 lanes 57,920 B, 3 blocks =
# 24.
@pytest.mark.parametrize("n,rate,want", [
    (648, "1/2", (4, 4, 14720, 14)),
    (1944, "5/6", (4, 4, 41184, 5)),
    (1944, "3/4", (4, 4, 43136, 5)),
    (1944, "1/2", (4, 4, 43456, 5)),
    (1296, "1/2", (4, 4, 28976, 7)),
])
def test_layered_packed_shape_hand_computed(n, rate, want):
    ct = _ct(n, rate)
    assert minsum.packed_shape(ct, "layered") == want
    lanes, _, smem, _ = want
    for star, et in ((0, False), (0, True), (minsum.star_degree(
            ct, DecoderConfig(algorithm="min-star")), True)):
        assert minsum.is_packed(ct, "layered", star, et)
        assert minsum.pick_lanes(ct, "layered", star, et) == lanes
        assert minsum.onchip_smem_bytes(ct, "layered", star, lanes,
                                        et) == smem
    assert minsum.packed_smem_bytes(ct, lanes, "layered") == smem


@pytest.mark.parametrize("n,rate,want", [
    # the largest base-row degree -> the least layered register row
    (648, "1/2", 8), (648, "2/3", 16), (648, "5/6", 24), (1944, "3/4", 16),
    (1944, "5/6", 20),
])
def test_layered_row_degree_instance(n, rate, want):
    assert minsum.row_degree_instance(_ct(n, rate), "layered") == want


def _preset_ct(name, **code):
    cfg = PRESETS[name]
    cfg = dataclasses.replace(cfg, code=dataclasses.replace(cfg.code, **code))
    return from_reference(build_code(cfg), "cpu")


@pytest.mark.parametrize("name,code,lanes", [
    ("dvbs2-64800-r12", dict(n=16200), 1),        # 86,760 B a codeword
    ("nr-bg1-layered", {}, 2),                     # Z=384: 1,536 threads
])
def test_codes_without_a_block_of_four_take_the_two_lane_instance(
        name, code, lanes):
    """Checks that these codes, which no block of four lanes a thread fits
    and which the one-lane template took with `lanes` lanes a block (its
    rule still admits them), now take the two-lane instance: a block of two
    lanes and Z threads, one an SM, min* too (rows of 7 and 22 fit a
    register row)."""
    ct = _preset_ct(name, **code)
    assert minsum.packed_smem_bytes(ct, 4, "layered") > minsum.MAX_SMEM
    shape = minsum.packed_shape(ct, "layered")
    assert shape[:2] == (2, minsum.TWO_LANES) and shape[3] == 1
    for star in (0, 7):
        assert minsum.is_packed(ct, "layered", star, True)
    assert minsum.pick_lanes(ct, "layered") == 2
    # the template's own rule, which the two-lane instance replaced
    template = (minsum.align16(4 * minsum.table_words(ct))
                + minsum.align16(8 * lanes) + minsum.align16(2 * ct.n * lanes)
                + minsum.align16(ct.n_entries * ct.Z * lanes))
    assert template <= minsum.MAX_SMEM and lanes * ct.Z <= minsum.MAX_THREADS
    d = minsum.make_decoder(ct, DecoderConfig(schedule="layered"),
                            QuantConfig())
    assert d.packed and d.lanes_per_thread == minsum.TWO_LANES
    assert d._launch_tables == (d._ptab.ctypes.data, len(d._ptab))


def test_nr_bg1_z128_takes_one_packed_block_an_sm():
    """NR BG1 Z=128 rate 1/3 (n=8,704, 309 circulants, rows of 4-7 and
    21-22): 56,968 B a codeword, so a block of four lanes (128 threads)
    takes 32 + 69,632 + 158,208 = 227,872 B, within the 232,448 B opt-in:
    one block an SM, four codewords, the 24-entry register row (a short row
    skips its unused groups of four slots)."""
    ct = _preset_ct("nr-bg1-layered", Z=128, rate="1/3")
    assert (ct.n, ct.n_entries * ct.Z) == (8704, 39552)
    assert minsum.packed_shape(ct, "layered") == (4, 4, 227872, 1)
    assert minsum.is_packed(ct, "layered", 0, True)
    assert minsum.row_degree_instance(ct, "layered") == 24


def test_minstar_rows_above_24_keep_the_one_lane_template():
    """The (3,30) array code: rows of 30 fit no min* register row; its
    min-sum instance reads the row twice in the packed kernel."""
    from ldpc_tpu_torch.codes import qc_entries
    from ldpc_tpu_torch.codes.toy import array_qc
    _, entries = qc_entries(array_qc(3, 30, 31))
    ct = dataclasses.replace(_ct(648, "1/2"), entries=entries)
    assert minsum.row_degree_instance(ct, "layered") == 0
    assert not minsum.is_packed(ct, "layered", 30, True)
    assert minsum.is_packed(ct, "layered", 0, True)


def test_layered_decoder_takes_the_packed_tables():
    ct = _ct(1944, "5/6")
    d = minsum.make_decoder(ct, DecoderConfig(schedule="layered"),
                            QuantConfig(beta_lsb=2))
    assert d.packed and d.library == "minsum_layered"
    assert d._launch_tables == (d._ptab.ctypes.data, len(d._ptab))
    assert d.param_words() == len(d._ptab) + ct.n_entries <= minsum.TAB_WORDS


def test_oversized_layered_tables_raise_in_the_wrapper():
    """A code whose packed tables and posterior offsets exceed the kernel's
    parameters raises before any launch; it never takes another kernel."""
    base = _ct(648, "1/2")
    rows = 1200     # 7,202 words of packed tables, 9,602 with the offsets
    entries = tuple(((2 * i % rows, 0, 2 * i), ((2 * i + 1) % rows, 0,
                                                2 * i + 1))
                    for i in range(rows))
    ct = dataclasses.replace(base, n=rows, Z=1, nb=rows, mb=rows,
                             entries=entries)
    d = minsum.make_decoder(ct, DecoderConfig(schedule="layered"),
                            QuantConfig())
    assert d.packed and len(d._ptab) <= minsum.TAB_WORDS < d.param_words()
    with pytest.raises(ValueError, match="exceed"):
        d.kernel(torch.zeros((rows, 1, 4), dtype=torch.int8))


# The wrapper's mirror of the layered kernel's constants, against the
# source's own.
@pytest.mark.parametrize("py,cu", [
    ("LAYERED_MAX_THREADS", "kLayeredMaxThreads"),
    ("LAYERED_ROW_DEGREES", "kLayeredRowDegrees[4]"),
])
def test_layered_constants_mirror_the_source(py, cu):
    import re
    src = (build.CSRC / "minsum_layered.cu").read_text()
    m = re.search(r"constexpr int " + re.escape(cu) + r" = \{?([0-9, ]+)\}?;",
                  src)
    assert m, cu
    want = tuple(int(x) for x in m.group(1).split(","))
    got = getattr(minsum, py)
    assert (got if isinstance(got, tuple) else (got,)) == want


def test_both_libraries_include_the_packed_header():
    for lib in minsum.SOURCES:
        assert "cn_packed.cuh" in [p.name for p in build.sources(lib)]
