"""The packed flooding instance (flood_packed_kernel of
ldpc_tpu_torch/kernels/csrc/minsum_flood.cu: K1, K1-IO and K1-MC flooding)
against the references, on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py). Here a numpy
emulation of its datapath, over the whole batch, is held to
golden.decoder.decode_fixed, to the JAX decoders (jnp, and the Pallas
kernel in interpret mode) and to the port's plain version, with tolerance
0: four codeword lanes packed in a 32-bit word (byte k = lane k), totals as
16x2 pairs, the messages stored negated, the check row kept as one byte a
lane (min(|raw|, qmax) in 7 bits and the sign of raw) in DMAX registers with
padded entries past the row's degree, and the emit computed on the four
bytes at once from the stored bytes. The shape rule (`packed_shape`,
`onchip_smem_bytes`, `pick_lanes`) is checked against hand-computed lanes
and bytes, and the admission rule against the one before the packed
instance."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.golden.decoder import decode_fixed
from ldpc_tpu.ops import decode_ref as jref
from ldpc_tpu_torch import PRESETS
from ldpc_tpu_torch.codes import build_code, from_reference
from ldpc_tpu_torch.config import DecoderConfig, QuantConfig
from ldpc_tpu_torch.kernels import minsum
from ldpc_tpu_torch.ops.decode_ref import make_flooding_decoder

torch.set_num_threads(2)

H = np.uint32(0x80808080)


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


def vadd2(a, b):
    """__vadd2: a + b per 16-bit half, no carry between halves."""
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _pack(al + bl, ah + bh)


def vneg2(a):
    return vadd2(~np.asarray(a, np.uint32), np.uint32(0x00010001))


def vmins2(a, b):
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _pack(np.minimum(al, bl), np.minimum(ah, bh))


def vmaxs2(a, b):
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _pack(np.maximum(al, bl), np.maximum(ah, bh))


def widen(w):
    """int8 lanes 0, 1 and 2, 3 of w as sign-extended 16x2 pairs."""
    return prmt(w, 0, 0x9180), prmt(w, 0, 0xB3A2)


def emit(w, m1, o1, o2, ns):
    """PackedEmit::emit: the negated new message bytes of an entry."""
    x = (w & np.uint32(0x7F7F7F7F)) ^ m1
    ne = (((x + np.uint32(0x7F7F7F7F)) & H) >> np.uint32(7)) * np.uint32(0xFF)
    mag = (o1 & ne) | (o2 & ~ne)
    sm = (((w ^ ns) & H) >> np.uint32(7)) * np.uint32(0xFF)
    negm = (H - mag) ^ H
    return (mag & sm) | (negm & ~sm)


def packed_decode(ct, chan, max_iter, qmax, beta=0, alpha=None):
    """The packed datapath over the batch: chan int8 (n, B) -> (hard (B, n)
    uint8, iters (B,), conv (B,) bool), fixed iterations."""
    n, Z, B = ct.n, ct.Z, chan.shape[1]
    W = -(-B // 4)
    ch = np.zeros((n, 4 * W), np.int8)
    ch[:, :B] = chan
    chw = ch.view(np.uint32)                       # (n, W)
    E = ct.n_entries
    nmsg = np.zeros((E * Z, W), np.uint32)         # negated messages
    rows = ct.entries
    cols = [[] for _ in range(ct.nb)]
    for row in rows:
        for col, s, e in row:
            cols[col].append((e, s))
    dmax = minsum.row_degree_instance(ct)
    y = np.arange(Z)
    q2 = np.uint32(qmax * 0x00010001)
    for it in range(max_iter + 1):
        # V phase: tot = chan - the sum of the negated messages
        lo, hi = widen(chw)
        if it:
            s_lo = np.zeros_like(lo)
            s_hi = np.zeros_like(hi)
            for j, col in enumerate(cols):
                for e, s in col:
                    m = nmsg[e * Z + (y - s) % Z]
                    w_lo, w_hi = widen(m)
                    s_lo[j * Z: (j + 1) * Z] = vadd2(s_lo[j * Z: (j + 1) * Z],
                                                      w_lo)
                    s_hi[j * Z: (j + 1) * Z] = vadd2(s_hi[j * Z: (j + 1) * Z],
                                                      w_hi)
            lo, hi = vadd2(lo, vneg2(s_lo)), vadd2(hi, vneg2(s_hi))
        tot = (lo, hi)
        if it == max_iter:
            break
        # C phase, every check row y of every base row at once
        for row in rows:
            d = len(row)
            min1 = [np.full((Z, W), 0x40004000, np.uint32) for _ in range(2)]
            min2 = [np.full((Z, W), 0x40004000, np.uint32) for _ in range(2)]
            ns = np.zeros((Z, W), np.uint32)
            rb = []
            for i in range(dmax if dmax else d):
                col, s, e = row[min(i, d - 1)]
                var = col * Z + (y + s) % Z
                nw = nmsg[e * Z + y] if it else np.zeros((Z, W), np.uint32)
                raw, m = [], []
                for k, wk in enumerate(widen(nw)):
                    r = vadd2(tot[k][var], wk)
                    raw.append(r)
                    m.append(vmins2(vmaxs2(r, vneg2(r)), q2))
                    mk = m[k] if i < d else np.uint32(0x007F007F)
                    min2[k] = vmins2(min2[k], vmaxs2(min1[k], mk))
                    min1[k] = vmins2(min1[k], mk)
                w = prmt(m[0], m[1], 0x6420) | (prmt(raw[0], raw[1], 0x7531)
                                                 & H)
                if i < d:
                    ns ^= w & H
                rb.append(w)
            a, b = list(min1), list(min2)
            if alpha is not None:
                num, shift = alpha
                keep = np.uint32((0xFFFF >> shift) * 0x00010001)
                a = [((v * np.uint32(num)) >> np.uint32(shift)) & keep
                     for v in a]
                b = [((v * np.uint32(num)) >> np.uint32(shift)) & keep
                     for v in b]
            if beta:
                a = [vmaxs2(vadd2(v, np.uint32((-beta & 0xFFFF) * 0x10001)),
                            np.uint32(0)) for v in a]
                b = [vmaxs2(vadd2(v, np.uint32((-beta & 0xFFFF) * 0x10001)),
                            np.uint32(0)) for v in b]
            m1 = prmt(min1[0], min1[1], 0x6420)
            o1, o2 = prmt(a[0], a[1], 0x6420), prmt(b[0], b[1], 0x6420)
            for i, (_, _, e) in enumerate(row):
                nmsg[e * Z + y] = emit(rb[i], m1, o1, o2, ns)
    sign = (prmt(tot[0], tot[1], 0x7531) >> np.uint32(7)) & np.uint32(
        0x01010101)
    hard = np.ascontiguousarray(sign).view(np.uint8)[:, :B]
    un = [np.zeros((Z, W), np.uint32) for _ in range(2)]
    for row in rows:
        x = [np.zeros((Z, W), np.uint32) for _ in range(2)]
        for col, s, _ in row:
            var = col * Z + (y + s) % Z
            x = [x[k] ^ tot[k][var] for k in range(2)]
        un = [un[k] | x[k] for k in range(2)]
    unsat = (prmt(un[0], un[1], 0x7531) >> np.uint32(7)) & np.uint32(
        0x01010101)
    unsat = np.ascontiguousarray(unsat).view(np.uint8)[:, :B].any(axis=0)
    return (np.ascontiguousarray(hard.T), np.full(B, max_iter, np.int32),
            ~unsat)


# --- inputs ----------------------------------------------------------------

def tie_llrs(rng, n, B, qmax):
    """int8 LLRs (n, B) that force ties and raw == 0: lanes of one
    magnitude with random signs, lanes of zeros and of +-1, a noisy lane
    and lanes near a codeword (all-zeros) at low noise."""
    x = np.zeros((n, B), np.int64)
    for b in range(B):
        kind = b % 6
        if kind == 0:
            x[:, b] = 3 * rng.choice([-1, 1], n)
        elif kind == 1:
            x[:, b] = 0
        elif kind == 2:
            x[:, b] = rng.integers(-1, 2, n)
        elif kind == 3:
            x[:, b] = np.round(rng.normal(0, 40, n))
        elif kind == 4:
            x[:, b] = np.round(rng.normal(12, 9, n))
        else:
            x[:, b] = qmax * rng.choice([-1, 1, 1, 1], n)
    return np.clip(x, -qmax, qmax).astype(np.int8)


CODES = {"wifi648": ("1/2", 648), "n1944_r34": ("3/4", 1944),
         "n1944_r56": ("5/6", 1944)}
ALGOS = {"min-sum": dict(beta=0, alpha=None),
         "offset-beta2": dict(beta=2, alpha=None),
         "normalized-3/4": dict(beta=0, alpha=(3, 2))}


def _golden(chan, code, qmax, max_iter, beta, alpha):
    rs = [decode_fixed(row.astype(np.int32), code, schedule="flooding",
                       qmax=qmax, beta=beta, alpha=alpha, early_term=False,
                       max_iter=max_iter) for row in chan.T]
    return (np.stack([r.hard for r in rs]).astype(np.uint8),
            np.array([r.iters for r in rs]),
            np.array([r.converged for r in rs]))


# the widths of the bit-width study (scripts/make_bits_study.py) beside the
# canonical 8: qmax 3, 7, 15, 31
@pytest.mark.parametrize("bits", [8, 6, 5, 4, 3])
@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("code_name", list(CODES))
def test_packed_emulation_matches_golden_jax_and_plain(code_name, algo, bits):
    rate, n = CODES[code_name]
    code = make_code(n, rate)
    ct = from_reference(code, "cpu")
    qmax = (1 << (bits - 1)) - 1
    kw = ALGOS[algo]
    max_iter = 4
    rng = np.random.default_rng(hash((code_name, algo, bits)) % 2 ** 32)
    chan = tie_llrs(rng, ct.n, 7, qmax)     # 7: a ragged last word
    got = packed_decode(ct, chan, max_iter, qmax, **kw)
    want = _golden(chan, code, qmax, max_iter, **kw)
    plain = make_flooding_decoder(code, qmax=qmax, early_term=False,
                                  max_iter=max_iter, **kw)(
        torch.as_tensor(np.ascontiguousarray(chan.T)))
    jax_out = jref.make_flooding_decoder(code, qmax=qmax, early_term=False,
                                         max_iter=max_iter, **kw)(
        jnp.asarray(np.ascontiguousarray(chan.T)))
    for g, w, p, j in zip(got, want, plain, jax_out):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p.numpy())
        np.testing.assert_array_equal(g, np.asarray(j))


# the bit-width study's Q-formats (scripts/make_bits_study.py:56-63): bits ->
# scale = qmax / clip
STUDY_SCALES = {3: 0.75, 4: 0.875, 5: 1.25, 6: 1.9375}


@pytest.mark.parametrize("bits", sorted(STUDY_SCALES))
def test_quantizer_matches_reference_at_the_study_scales(bits):
    """The port's quantizer (the plain version of the fused-IO kernels'
    in-kernel quant32) == ldpc_tpu/ops/quantize.py at the study's scales:
    on the float32 values whose float32 product with the scale is exactly
    a half LSB (ties, which round away from zero), on their neighbours, past
    the clip and on noise."""
    from ldpc_tpu.config import QuantConfig as RefQuantConfig
    from ldpc_tpu.ops.quantize import quantize as jquantize
    from ldpc_tpu_torch.ops.quantize import quantize
    scale, qmax = STUDY_SCALES[bits], (1 << (bits - 1)) - 1
    s32 = np.float32(scale)
    halves = np.arange(-qmax - 3, qmax + 3, dtype=np.float32) + 0.5
    at = (halves / s32).astype(np.float32)
    near = np.concatenate([np.nextafter(at, np.float32(np.inf)), at,
                           np.nextafter(at, np.float32(-np.inf))])
    ties = near[near * s32 == np.tile(halves, 3)]
    assert (ties > 0).any() and (ties < 0).any()
    noise = np.random.default_rng(bits).normal(
        0, 2 * qmax / scale, 4096).astype(np.float32)
    x = np.concatenate([ties, near, noise])
    got = quantize(torch.as_tensor(x),
                   QuantConfig(bits=bits, scale=scale)).numpy()
    want = np.asarray(jquantize(jnp.asarray(x),
                                RefQuantConfig(bits=bits, scale=scale)))
    np.testing.assert_array_equal(got, want)
    t = ties * s32
    np.testing.assert_array_equal(
        got[: len(ties)],
        np.clip(np.sign(t) * np.ceil(np.abs(t)), -qmax, qmax).astype(np.int8))


def test_packed_emulation_wifi648_fixed20_matches_plain(rng):
    """The canonical decode, 20 iterations, at a realistic operating point
    and a batch of 64, against the port's plain version."""
    code = make_code(648, "1/2")
    ct = from_reference(code, "cpu")
    sigma = 0.7943282
    y = 1.0 + sigma * rng.standard_normal((ct.n, 64))
    chan = np.clip(np.round(2 * y / sigma ** 2 * 4), -127, 127).astype(
        np.int8)
    got = packed_decode(ct, chan, 20, 127)
    want = make_flooding_decoder(code, qmax=127, early_term=False,
                                 max_iter=20)(
        torch.as_tensor(np.ascontiguousarray(chan.T)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert 0 < int(got[2].sum()) < 64


def _pallas(code, ct, chan, max_iter, qmax, B):
    from ldpc_tpu.kernels.minsum_pallas import make_pallas_decoder
    pal = make_pallas_decoder(code, qmax=qmax, schedule="flooding",
                              early_term=False, max_iter=max_iter,
                              batch_tile=B, interpret=True,
                              pre_transposed=True)
    out = pal(jnp.asarray(chan.reshape(ct.nb, ct.Z, B)))
    hard = np.asarray(out[0]).reshape(ct.n, B).T
    return hard, np.asarray(out[1]), np.asarray(out[2])


@pytest.mark.parametrize("bits", [8, 6])
def test_packed_emulation_matches_pallas_interpret_toy(bits):
    code = toy_qc(4)
    ct = from_reference(code, "cpu")
    qmax = (1 << (bits - 1)) - 1
    chan = tie_llrs(np.random.default_rng(bits), ct.n, 8, qmax)
    got = packed_decode(ct, chan, 6, qmax)
    for g, w in zip(got, _pallas(code, ct, chan, 6, qmax, 8)):
        np.testing.assert_array_equal(g, w.astype(g.dtype))


@pytest.mark.slow
def test_packed_emulation_matches_pallas_interpret_wifi648():
    """wifi-648 against the Pallas kernel in interpret mode (about 40 s on
    a CPU, hence slow)."""
    code = make_code(648, "1/2")
    ct = from_reference(code, "cpu")
    chan = tie_llrs(np.random.default_rng(3), ct.n, 8, 127)
    got = packed_decode(ct, chan, 3, 127)
    for g, w in zip(got, _pallas(code, ct, chan, 3, 127, 8)):
        np.testing.assert_array_equal(g, w.astype(g.dtype))


def test_emit_is_cnrow_emit_on_every_byte():
    """The four-byte emit against CnRow::emit lane by lane, over every
    row byte (7-bit magnitude and sign) and a spread of row states."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        qmax = int(rng.choice([31, 127]))
        min1 = rng.integers(0, qmax + 1, 4)
        min2 = np.maximum(min1, rng.integers(0, qmax + 1, 4))
        o1, o2 = np.maximum(min1 - 1, 0), np.maximum(min2 - 1, 0)
        neg = rng.integers(0, 2, 4)
        m = rng.integers(0, qmax + 1, (256, 4))
        m[:64] = min1                                   # ties with min1
        s = rng.integers(0, 2, (256, 4))
        w = ((m | (s << 7)).astype(np.uint32)
             << (8 * np.arange(4, dtype=np.uint32))).sum(axis=1).astype(
            np.uint32)

        def word(v):
            return np.uint32(sum(int(x) << (8 * k) for k, x in enumerate(v)))
        got = emit(w, word(min1), word(o1), word(o2), word(neg << 7))
        got_lanes = got.view(np.uint8).reshape(256, 4).view(np.int8)
        mag = np.where(m == min1, o2, o1)
        c2v = np.where((neg ^ s) == 1, -mag, mag)
        np.testing.assert_array_equal(got_lanes, -c2v)


# --- the shape rule ----------------------------------------------------------

def _ct(n, rate):
    return from_reference(make_code(n, rate), "cpu")


# Hand-computed: per lane 2n B of totals, n of channel and E * Z of
# messages, plus 8 B of counters, each part rounded up to 16 B for the
# block; an SM gives blocks 233,472 B with a 1,024 B reserve each. n=648
# (E*Z = 2,376): 4 lanes = 32 + 5,184 + 2,592 + 9,504 = 17,312 B, 12
# blocks = 48 codewords, and no shape holds more than 52 (one block of 52),
# so the fewest lanes within 9/10 of 52 is 4. n=1944 r3/4 (E*Z = 6,885): 4
# lanes = 32 + 15,552 + 7,776 + 27,552 = 50,912 B, 4 blocks, 16 codewords,
# the most. n=1944 r5/6 (E*Z = 6,399): 32 + 15,552 + 7,776 + 25,600 =
# 48,960 B, 4 blocks. n=1944 r1/2 (E*Z = 6,966): 32 + 15,552 + 7,776 +
# 27,872 = 51,232 B, 4 blocks. n=1296 r1/2 (E*Z = 4,644): 32 + 10,368 +
# 5,184 + 18,576 = 34,160 B, 6 blocks = 24 codewords, which no shape beats
# (12 lanes: 2 blocks); r5/6 (E*Z = 4,590): 18,360 rounds to 18,368, so
# 33,952 B, 6 blocks.
@pytest.mark.parametrize("n,rate,want", [
    (648, "1/2", (4, 4, 17312, 12)),
    (1944, "3/4", (4, 4, 50912, 4)),
    (1944, "5/6", (4, 4, 48960, 4)),
    (1944, "1/2", (4, 4, 51232, 4)),
    (1296, "1/2", (4, 4, 34160, 6)),
    (1296, "5/6", (4, 4, 33952, 6)),
])
def test_packed_shape_hand_computed(n, rate, want):
    ct = _ct(n, rate)
    assert minsum.packed_shape(ct) == want
    lanes, lpt, smem, _ = want
    assert minsum.pick_lanes(ct, "flooding") == lanes
    assert minsum.onchip_smem_bytes(ct, "flooding", 0, lanes) == smem
    assert minsum.packed_smem_bytes(ct, lanes) == smem


@pytest.mark.parametrize("n,rate,want", [
    # the largest base-row degree -> the least register row holding it
    (648, "1/2", 8), (648, "2/3", 16), (648, "3/4", 16), (648, "5/6", 24),
    (1944, "3/4", 16),
])
def test_row_degree_instance(n, rate, want):
    assert minsum.row_degree_instance(_ct(n, rate)) == want


def test_row_degree_instance_reads_long_rows_twice():
    """The (3,30) array code's rows (degree 30) exceed every register
    row: DMAX 0, the row read twice."""
    from ldpc_tpu_torch.codes import qc_entries
    from ldpc_tpu_torch.codes.toy import array_qc
    code = array_qc(3, 30, 31)
    _, entries = qc_entries(code)
    assert max(len(r) for r in entries) == 30 > max(minsum.ROW_DEGREES)
    assert minsum.row_degree_instance(
        dataclasses.replace(_ct(648, "1/2"), entries=entries)) == 0


# The wrapper's mirror of the packed instance's constants, against the
# source's own.
@pytest.mark.parametrize("py,cu", [
    ("SM_SMEM", "kSmSmem"), ("BLOCK_RESERVE", "kBlockReserve"),
    ("SM_WARPS", "kSmWarps"), ("SM_BLOCKS", "kSmBlocks"),
    ("LANES_PER_THREAD", "kLanesPerThread"), ("TAB_WORDS", "kTabWords"),
    ("ROW_DEGREES", "kRowDegrees[3]"),
])
def test_packed_constants_mirror_the_source(py, cu):
    import re
    src = open(minsum.build.CSRC / "cn_packed.cuh").read()
    m = re.search(r"constexpr int " + re.escape(cu) + r" = \{?([0-9, ]+)\}?;",
                  src)
    assert m, cu
    want = tuple(int(x) for x in m.group(1).split(","))
    got = getattr(minsum, py)
    assert (got if isinstance(got, tuple) else (got,)) == want


@pytest.mark.parametrize("early_term,algorithm,want", [
    # since the early-terminating and min* instances joined the packed
    # kernel, n=648 takes its block of four lanes (27 threads, within their
    # launch bound of 256) with the fixed instance's state, 17,312 B
    (True, "min-sum", (4, 17312)),
    (False, "min-star", (4, 17312)),
])
def test_other_flooding_instances_keep_their_rule(early_term, algorithm,
                                                  want):
    ct = _ct(648, "1/2")
    dec = DecoderConfig(algorithm=algorithm, schedule="flooding",
                        early_term=early_term)
    star = minsum.star_degree(ct, dec)
    lanes = minsum.pick_lanes(ct, "flooding", star, early_term)
    assert (lanes, minsum.onchip_smem_bytes(ct, "flooding", star, lanes,
                                            early_term)) == want
    assert minsum.is_packed(ct, "flooding", star, early_term)
    # the one-lane-a-thread template keeps its rule (tables in shared
    # memory, power-of-two lanes, 113 KB for two blocks an SM) on a code
    # with no block of four or two lanes: NR BG1 Z=384 rate 1/3 (the rate
    # 1/2 code takes the two-lane instance)
    nr_cfg = PRESETS["nr-bg1-layered"]
    nr = from_reference(build_code(dataclasses.replace(
        nr_cfg, code=dataclasses.replace(nr_cfg.code, rate="1/3"))), "cpu")
    star = minsum.star_degree(nr, dec)
    assert not minsum.is_packed(nr, "flooding", star, early_term)
    assert minsum.pick_lanes(nr, "flooding", star, early_term) == (
        _old_pick_lanes(nr, "flooding", star)) > 0


def _old_pick_lanes(ct, schedule, star_deg):
    """The admission rule before the packed instance, for every on-chip
    kernel: power-of-two lanes <= 32 with the tables in shared memory."""
    for limit in (minsum.PREFERRED_SMEM, minsum.MAX_SMEM):
        lanes = 32
        while lanes >= 1:
            smem = (minsum.align16(4 * minsum.table_words(ct))
                    + minsum.align16(8 * lanes)
                    + minsum.align16(2 * ct.n * lanes)
                    + (minsum.align16(ct.n * lanes)
                       if schedule == "flooding" else 0)
                    + minsum.align16(ct.n_entries * ct.Z * lanes)
                    + minsum.align16(star_deg * ct.Z * lanes))
            if lanes * ct.Z <= minsum.MAX_THREADS and smem <= limit:
                return lanes
            lanes //= 2
    return 0


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_onchip_domain_admits_what_it_admitted(preset):
    """Every preset code, in flooding with fixed iterations (the packed
    instance) and as configured: admitted before, admitted now."""
    cfg = PRESETS[preset]
    ct = from_reference(build_code(cfg), "cpu")
    for dec in (cfg.decoder, dataclasses.replace(
            cfg.decoder, schedule="flooding", early_term=False,
            algorithm="min-sum")):
        star = minsum.star_degree(ct, dec)
        before = (minsum.kernel_domain(ct, cfg.quant) is None
                  and _old_pick_lanes(ct, dec.schedule, star) > 0)
        now = minsum.onchip_domain(ct, dec, cfg.quant) is None
        assert now or not before, (preset, dec)
        if now and minsum.is_packed(ct, dec.schedule, star, dec.early_term):
            assert len(minsum.packed_tables(ct)) <= minsum.TAB_WORDS


def test_code_without_a_two_lane_block_keeps_the_one_lane_kernel():
    """NR BG1 Z=384 rate 1/3 (n=26,112): two lanes of state (totals and
    messages, 341,776 B) exceed a block's shared memory, so the fixed
    min-sum flooding instance is the one-lane template (one lane, 384
    threads), as before the packed kernel. NR BG1 Z=384 rate 1/2 and DVB-S2
    n=16,200 fit two lanes but not the packed kernel's four: since the
    two-lane instances they take those, one block of two lanes an SM."""
    cfg = PRESETS["nr-bg1-layered"]
    ct = from_reference(build_code(dataclasses.replace(
        cfg, code=dataclasses.replace(cfg.code, rate="1/3"))), "cpu")
    assert minsum.packed_shape(ct) == (0, 0, 0, 0)
    assert not minsum.is_packed(ct, "flooding", 0, False)
    assert minsum.pick_lanes(ct, "flooding") == _old_pick_lanes(
        ct, "flooding", 0) == 1
    nr = from_reference(build_code(cfg), "cpu")
    dvb = PRESETS["dvbs2-64800-r12"]
    short = from_reference(build_code(dataclasses.replace(
        dvb, code=dataclasses.replace(dvb.code, n=16200))), "cpu")
    for code, smem in ((nr, 228880), (short, 173536)):
        assert minsum.packed_shape(code) == (2, minsum.TWO_LANES, smem, 1)
        assert minsum.is_packed(code, "flooding", 0, False)
        assert minsum.pick_lanes(code, "flooding") == 2
        assert _old_pick_lanes(code, "flooding", 0) == 1


def test_packed_tables_layout():
    ct = _ct(648, "1/2")
    t = minsum.packed_tables(ct).astype(np.int64)
    mb, nb, E, Z = ct.mb, ct.nb, ct.n_entries, ct.Z
    assert len(t) == mb + nb + 2 + 2 * E == 214
    layer_ptr, col_ptr = t[: mb + 1], t[mb + 1: mb + nb + 2]
    ent, col_ent = t[mb + nb + 2: mb + nb + 2 + E], t[-E:]
    assert list(np.diff(layer_ptr)) == [len(r) for r in ct.entries]
    for row in ct.entries:
        for col, s, e in row:
            assert ent[e] == (col * Z) << 11 | s
    for j in range(nb):
        for q in range(col_ptr[j], col_ptr[j + 1]):
            e, s = col_ent[q] >> 11, col_ent[q] & 0x7FF
            assert e % Z == 0
            col, shift, _ = [x for row in ct.entries for x in row][e // Z]
            assert (col, shift) == (j, s)


def test_oversized_tables_raise_in_the_wrapper():
    """A code whose entry tables exceed the kernel's parameters raises
    before any launch; it never takes another kernel."""
    base = _ct(648, "1/2")
    rows = 2000
    entries = tuple(((2 * i % rows, 0, 2 * i), ((2 * i + 1) % rows, 0,
                                                2 * i + 1))
                    for i in range(rows))
    ct = dataclasses.replace(base, n=rows, Z=1, nb=rows, mb=rows,
                             entries=entries)
    d = minsum.make_decoder(ct, DecoderConfig(schedule="flooding",
                                              early_term=False),
                            QuantConfig())
    assert d.packed and len(d._ptab) > minsum.TAB_WORDS
    with pytest.raises(ValueError, match="exceed"):
        d.kernel(torch.zeros((rows, 1, 4), dtype=torch.int8))
