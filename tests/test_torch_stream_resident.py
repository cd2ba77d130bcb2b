"""The packed resident streaming kernel (resident_packed_kernel of
ldpc_tpu_torch/kernels/csrc/minsum_stream.cu: K6d and K6e, the instances
`stream-resident` and `stream-resident-et` wherever its block fits)
against the references, on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py holds it to its plain
version there). Here a numpy emulation of its datapath, over the whole
batch, is held to golden.decoder.decode_fixed(schedule="layered"), to the
Pallas kernels `kernel_resident` and `kernel_resident_et` of
ldpc_tpu/kernels/minsum_stream.py in interpret mode, to the JAX QC decoder
and to the port's plain version (ops/decode_qc, which the wrapper runs on
CPU tensors for the packed kernel and the template alike), with tolerance 0
on hard bits, iterations and convergence: a block of LPT = 2 or 4 codeword
lanes, their int8 channel bytes in one word, the posteriors as 16x2 pairs
at the byte offsets of `resident_tables`; the negated messages in 4-byte
words of 4 / LPT entries in a device scratch that starts as garbage and
is not read in the first iteration, copied into a ring of RESIDENT_STAGES
stages RESIDENT_AHEAD steps ahead; rows of up to RESIDENT_ROW entries in
registers (groups of four slots, padded slots that repeat the last entry's
loads and take no part), longer rows in a reduce pass and an emit pass;
PackedRow/PackedEmit's arithmetic on the words; early termination with a
word of running lanes, the block's syndrome vote every RESIDENT_VOTE base
rows, lanes that write their hard bits when each finishes and run on
unread, the block leaving once none runs. Then the shape rule against
hand-computed bytes at B = 256 and 1,024, the codes the template keeps, and
the wrapper's constants against the source's."""
import dataclasses
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes.code import expand_qc
from ldpc_tpu.codes.dvbs2 import make_code as make_dvbs2
from ldpc_tpu.codes.ieee80211n import make_code as make_wifi
from ldpc_tpu.codes.nr_bg import make_code as make_nr
from ldpc_tpu.codes.toy import array_qc, toy_qc
from ldpc_tpu.golden.decoder import decode_fixed
from ldpc_tpu.kernels import minsum_stream as jstream
from ldpc_tpu.ops import decode_qc as jqc
from ldpc_tpu_torch import PRESETS
from ldpc_tpu_torch.codes import (CodeTensors, build_code, from_reference,
                                  own_code, qc_entries)
from ldpc_tpu_torch.kernels import build, minsum_stream as ms
from ldpc_tpu_torch.ops.decode_qc import make_qc_decoder
from test_torch_layered_packed import (H, emit, prmt, vadd2, viaddmax,
                                       vmaxs2, vmins2, vneg2, widen)

torch.set_num_threads(2)

SLOW = pytest.mark.slow
SOURCE = (build.CSRC / "minsum_stream.cu").read_text()
SENT = np.uint32(0x40004000)     # kMinSentinel in both halves
PAD = np.uint32(0x007F007F)      # a padded slot's magnitude
OMS = dict(beta=2, alpha=None)
NMS = dict(beta=0, alpha=(3, 2))
MS = dict(beta=0, alpha=None)


# --- the datapath ------------------------------------------------------------

def _lane_words(x, lanes):
    """(nblk * lanes, n) int8 -> (n, nblk) uint32, byte k = lane k."""
    nb = x.shape[0] // lanes
    b = x.reshape(nb, lanes, -1).view(np.uint8).astype(np.uint32)
    w = np.zeros((x.shape[1], nb), np.uint32)
    for k in range(lanes):
        w |= b[:, k, :].T << np.uint32(8 * k)
    return w


def _lanes_of(words, lanes):
    """(n, nblk) uint32 of one byte a lane -> (nblk * lanes, n) uint8."""
    b = np.ascontiguousarray(words).view(np.uint8).reshape(
        words.shape[0], words.shape[1], 4)[:, :, :lanes]
    return np.ascontiguousarray(b.transpose(1, 2, 0)).reshape(
        -1, words.shape[0])


def resident_decode(ct, chan, max_iter, lanes, qmax=127, beta=0, alpha=None,
                    early_term=False):
    """The packed resident kernel's datapath over the batch: chan int8 (B,
    n) -> (hard (B, n) uint8, iters (B,) int32, conv (B,) bool). Block b
    holds lanes b * lanes ..; lanes past the batch get a zero channel and
    never run."""
    chan = np.asarray(chan, np.int8)
    B, n = chan.shape
    Z, mb = ct.Z, ct.mb
    NP, EPW = lanes // 2, 4 // lanes
    nblk = -(-B // lanes)
    ch = np.zeros((nblk * lanes, n), np.int8)
    ch[:B] = chan
    tab = ms.resident_tables(ct, lanes).astype(np.int64)
    E = ct.n_entries
    layer_ptr, wptr, off = tab[: mb + 1], tab[mb + 1: 2 * mb + 2], tab[-E:]
    assert len(tab) == 2 * (mb + 1) + E
    wmax = int(np.diff(wptr).max())
    assert wmax == ms.resident_wmax(ct, lanes)
    y = np.arange(Z)
    q2 = np.uint32(qmax * 0x00010001)

    def var_of(e):
        """Row y's posterior of entry e: byte off >> 11 + 2 lanes y, less
        2 lanes Z where y >= off & 0x7ff; as a variable index."""
        a = (off[e] >> 11) + 2 * lanes * y - np.where(
            y >= (off[e] & 0x7FF), 2 * lanes * Z, 0)
        assert (a % (2 * lanes) == 0).all()
        return a // (2 * lanes)

    lo, hi = widen(_lane_words(ch, lanes))
    post = [lo, hi if NP == 2 else np.zeros_like(hi)]
    assert NP == 2 or not post[1].any()
    msg = np.full((int(wptr[-1]), Z, nblk), 0xA5A5A5A5, np.uint32)
    ring = np.full((ms.RESIDENT_STAGES, wmax, Z, nblk), 0x5A5A5A5A,
                   np.uint32)
    fetch = [0]

    def copy_next():
        f_it, f_l = divmod(fetch[0], mb)
        if 1 <= f_it < max_iter:
            w0, w1 = wptr[f_l], wptr[f_l + 1]
            ring[fetch[0] % ms.RESIDENT_STAGES, : w1 - w0] = msg[w0:w1]
        fetch[0] += 1

    lane_valid = np.arange(nblk * lanes) < B
    iters = np.full(nblk * lanes, 0 if early_term else max_iter, np.int32)
    hard = np.zeros((nblk * lanes, n), np.uint8)

    def lanes_set(words):
        """(nblk,) words of 0xff bytes -> (nblk * lanes,) bool."""
        return (np.ascontiguousarray(words).view(np.uint8).reshape(
            nblk, 4)[:, :lanes] == 0xFF).reshape(-1)

    def hard_now():
        return _lanes_of((prmt(post[0], post[1], 0x7531) >> np.uint32(7))
                         & np.uint32(0x01010101), lanes)

    def unsat(need):
        """The block's vote: bit 7 of lane k's byte where some row of the
        block is unsatisfied, RESIDENT_VOTE base rows a vote, stopping once
        every lane of `need` has one."""
        found = np.zeros(nblk, np.uint32)
        for l0 in range(0, mb, ms.RESIDENT_VOTE):
            if ((found & need) == need).all():
                break
            for l in range(l0, min(l0 + ms.RESIDENT_VOTE, mb)):
                x = [np.zeros((Z, nblk), np.uint32) for _ in range(2)]
                for e in range(layer_ptr[l], layer_ptr[l + 1]):
                    v = var_of(e)
                    x[0] ^= post[0][v]
                    x[1] ^= post[1][v]
                found |= (np.bitwise_or.reduce(prmt(x[0], x[1], 0x7531),
                                               axis=0) & need)
        return found & need

    def words_of(lane_mask):
        """(nblk * lanes,) bool -> (nblk,) words of 0xff bytes."""
        b = np.where(lane_mask.reshape(nblk, lanes), 0xFF, 0).astype(np.uint8)
        return np.ascontiguousarray(np.pad(b, ((0, 0), (0, 4 - lanes)))
                                    ).view(np.uint32)[:, 0]

    act = words_of(lane_valid)

    def check(k):
        """State k: running lanes with no unsatisfied row finish, with
        iters = k and their hard bits from this state."""
        nonlocal act
        running = lanes_set(act)
        iters[running] = k
        stamped = lanes_set(prmt(unsat(act & H), 0, 0xBA98))
        fin = running & ~stamped
        hard[fin] = hard_now()[fin]
        act = act & ~words_of(fin)

    def row_state():
        return dict(min1=[SENT.copy() + np.zeros((Z, nblk), np.uint32)
                          for _ in range(NP)],
                    min2=[SENT.copy() + np.zeros((Z, nblk), np.uint32)
                          for _ in range(NP)],
                    ns=np.zeros((Z, nblk), np.uint32))

    def entry(st, t, old, real, add):
        """PackedRow::entry: the row bytes and raw pairs of one entry."""
        w_old = widen(old)
        raw = [vadd2(t[k], w_old[k]) if k < NP else np.zeros_like(t[0])
               for k in range(2)]
        m = [vmins2(vmaxs2(raw[k], vneg2(raw[k])), q2) if k < NP
             else np.zeros_like(t[0]) for k in range(2)]
        if add:
            for k in range(NP):
                mk = m[k] if real else PAD
                st["min2"][k] = vmins2(st["min2"][k],
                                       vmaxs2(st["min1"][k], mk))
                st["min1"][k] = vmins2(st["min1"][k], mk)
        w = prmt(m[0], m[1], 0x6420) | (prmt(raw[0], raw[1], 0x7531) & H)
        if add and real:
            st["ns"] ^= w & H
        return w, raw

    def emitter(st):
        """PackedEmit: (m1, o1, o2, ns)."""
        z = np.zeros((Z, nblk), np.uint32)
        a = [st["min1"][0], st["min1"][1] if NP == 2 else z]
        b = [st["min2"][0], st["min2"][1] if NP == 2 else z]
        m1 = prmt(a[0], a[1], 0x6420)
        if alpha is not None and tuple(alpha) != (1, 0):
            num, shift = alpha
            keep = np.uint32((0xFFFF >> shift) * 0x00010001)
            a = [((v * np.uint32(num)) >> np.uint32(shift)) & keep for v in a]
            b = [((v * np.uint32(num)) >> np.uint32(shift)) & keep for v in b]
        if beta:
            nb_ = np.uint32(((-beta) & 0xFFFF) * 0x00010001)
            a = [viaddmax(v, nb_, np.uint32(0)) for v in a]
            b = [viaddmax(v, nb_, np.uint32(0)) for v in b]
        return m1, prmt(a[0], a[1], 0x6420), prmt(b[0], b[1], 0x6420), \
            st["ns"]

    def message_word(words, i, m):
        if lanes == 4:
            words[i] = m
        else:
            words[i // 2] |= (m & np.uint32(0xFFFF)) << np.uint32(
                16 * (i % 2))

    if early_term:
        check(0)
    for it in range(max_iter):
        running = (act != 0) if early_term else np.ones(nblk, bool)
        if not running.any():
            break
        for l in range(mb):
            t_step = it * mb + l
            copy_next()
            slot = ring[t_step % ms.RESIDENT_STAGES]
            e0, d = layer_ptr[l], layer_ptr[l + 1] - layer_ptr[l]

            def old_of(i):
                if not it:
                    return np.zeros((Z, nblk), np.uint32)
                word = slot[i // EPW]
                return (word if lanes == 4 else
                        (word >> np.uint32(16 * (i % 2))) & np.uint32(0xFFFF))

            new_post = {}
            words = [np.zeros((Z, nblk), np.uint32)
                     for _ in range(ms.resident_words(d, lanes))]
            st = row_state()
            if d <= ms.RESIDENT_ROW:
                rb, raws, vs = [], [], []
                for i in range(ms.RESIDENT_ROW):
                    if (i & ~3) >= d:
                        break
                    ei = min(i, d - 1)
                    v = var_of(e0 + ei)
                    w, raw = entry(st, [post[0][v], post[1][v]], old_of(ei),
                                   i < d, True)
                    rb.append(w)
                    raws.append(raw)
                    vs.append(v)
                m1, o1, o2, ns = emitter(st)
                for i in range(d):
                    mg, nv = emit(rb[i], m1, o1, o2, ns)
                    wn = widen(nv)
                    new_post[e0 + i] = (vs[i], [vadd2(raws[i][k], wn[k])
                                                for k in range(2)])
                    message_word(words, i, mg)
            else:
                for i in range(d):
                    v = var_of(e0 + i)
                    entry(st, [post[0][v], post[1][v]], old_of(i), True,
                          True)
                m1, o1, o2, ns = emitter(st)
                for i in range(d):
                    v = var_of(e0 + i)
                    w, raw = entry(st, [post[0][v], post[1][v]], old_of(i),
                                   True, False)
                    mg, nv = emit(w, m1, o1, o2, ns)
                    wn = widen(nv)
                    new_post[e0 + i] = (v, [vadd2(raw[k], wn[k])
                                            for k in range(2)])
                    message_word(words, i, mg)
            cols = np.nonzero(running)[0]
            for v, pair in new_post.values():
                for k in range(NP):
                    post[k][np.ix_(v, cols)] = pair[k][:, cols]
            for w, word in enumerate(words):
                msg[wptr[l] + w][:, cols] = word[:, cols]
        if early_term:
            check(it + 1)
    if early_term:
        rest = lanes_set(act)
        conv = ~rest
    else:
        rest = lane_valid
        conv = ~lanes_set(prmt(unsat(act & H), 0, 0xBA98))
    hard[rest] = hard_now()[rest]
    return hard[:B], iters[:B], conv[:B]


# --- codes, inputs, references -----------------------------------------------

def _mixed_code():
    """Base rows of degree 2, 3, ..., 8 (one each; random shifts, Z = 7)
    over 10 base columns, every column used."""
    rng = np.random.default_rng(21)
    base = -np.ones((7, 10), np.int64)
    for r, d in enumerate(range(2, 9)):
        cols = rng.choice(10, size=d, replace=False)
        if r == 6:
            cols = np.union1d(cols, np.setdiff1d(
                np.arange(10), np.nonzero((base >= 0).any(axis=0))[0]))[:8]
        base[r, cols] = rng.integers(0, 7, size=len(cols))
    assert (base >= 0).any(axis=0).all()
    return expand_qc(base, 7, name="mixed_deg2_8_z7")


@functools.lru_cache(maxsize=None)
def _code(name):
    return {"toy": lambda: toy_qc(8),
            "mixed": _mixed_code,
            "wifi648": lambda: make_wifi(648, "1/2"),
            "nr-bg2-z16": lambda: make_nr(base_graph=2, Z=16),
            "nr-bg1-z16": lambda: make_nr(base_graph=1, Z=16),
            "array-3x30": lambda: array_qc(3, 30, 31),
            "dvbs2-16200-r89": lambda: make_dvbs2(16200, "8/9")}[name]()


def _llrs(rng, B, n, sigma, qmax, scale=4.0):
    """Quantized LLRs of the all-zeros codeword (a codeword of every code)
    over BPSK/AWGN, the noise spread across the lanes (so lanes of one
    block finish at different iterations), lane 0 noiseless."""
    sig = np.linspace(0.7 * sigma, 1.3 * sigma, B)[:, None]
    yv = 1.0 + sig * rng.standard_normal((B, n))
    yv[0] = 1.0
    return np.clip(np.round(2.0 * yv / sig ** 2 * scale), -qmax,
                   qmax).astype(np.int8)


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64))


def _golden(code, chan, max_iter, cn, early_term, qmax):
    rows = [decode_fixed(c.astype(np.int32), code, max_iter=max_iter,
                         beta=cn["beta"], qmax=qmax, schedule="layered",
                         early_term=early_term, alpha=cn["alpha"])
            for c in chan]
    return (np.stack([r.hard for r in rows]),
            np.array([r.iters for r in rows]),
            np.array([r.converged for r in rows]))


@functools.lru_cache(maxsize=None)
def _tensors(name):
    """CodeTensors of a test code on the CPU; the array code has no
    systematic form, so it gets the entries only (what a decoder reads)."""
    code = _code(name)
    if not name.startswith("array"):
        return from_reference(code, "cpu")
    port = own_code(code)
    qc, entries = qc_entries(port)
    return CodeTensors(code=port, device=torch.device("cpu"), n=int(code.n),
                       k=int(code.k), Z=int(qc.Z), nb=int(qc.nb),
                       mb=int(qc.mb), kb=0, entries=entries, P=None,
                       perm=None, info_positions=torch.zeros(
                           0, dtype=torch.int64), ident_info=False)


def _plain(code, chan, max_iter, cn, early_term, qmax):
    out = make_qc_decoder(own_code(code),
                          max_iter=max_iter, qmax=qmax, schedule="layered",
                          early_term=early_term, **cn)(torch.as_tensor(chan))
    return [x.numpy() for x in out]


# (code, lanes, B, iterations, sigma, CN, early termination, qmax, JAX too,
#  golden lanes (None: all))
CASES = [
    # rows of degree 2-8, every CN variant, both lane counts, fixed and ET
    *(("mixed", L, 7, 6, 0.8, cn, et, 127, True, None)
      for L in (2, 4) for cn in (OMS, NMS, MS) for et in (False, True)),
    # qmax 7 and 31: the clip at qmax bites
    *(("mixed", L, 6, 6, 0.8, OMS, et, q, False, None)
      for L, q in ((4, 7), (2, 31)) for et in (False, True)),
    # ragged batches 1, 3, 5 and max_iter 1
    *(("wifi648", L, B, 4, 0.8, OMS, et, 127, False, None)
      for L, B, et in ((4, 1, True), (4, 3, False), (2, 5, True),
                       (2, 3, False), (4, 5, True))),
    ("wifi648", 4, 5, 1, 0.8, NMS, True, 127, False, None),
    ("wifi648", 2, 5, 1, 0.8, OMS, False, 127, False, None),
    # rows of 21-22 (two passes) beside rows of 4-7 (registers)
    *(("nr-bg1-z16", L, 6, 5, 0.8, OMS, et, 127, True, None)
      for L in (2, 4) for et in (False, True)),
    ("nr-bg2-z16", 4, 6, 5, 0.8, NMS, True, 127, False, None),
    # rows of 30 (the (3,30) array code) and 27-28 (DVB-S2 n=16,200 r8/9)
    ("array-3x30", 4, 5, 6, 0.7, OMS, False, 127, False, None),
    ("array-3x30", 2, 5, 6, 0.7, OMS, True, 127, False, None),
    ("dvbs2-16200-r89", 4, 3, 3, 0.5, OMS, True, 127, False, 1),
    ("dvbs2-16200-r89", 2, 3, 3, 0.5, NMS, False, 127, False, 1),
]


def _case_id(c):
    name, L, B, iters, _, cn, et, qmax, _, _ = c
    alg = {id(OMS): "oms", id(NMS): "nms", id(MS): "ms"}[id(cn)]
    return (f"{name}-L{L}-B{B}-{alg}-{'et' if et else 'fixed'}{iters}"
            f"-q{qmax}")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_datapath_equals_golden_jax_and_plain(case):
    name, L, B, iters, sigma, cn, et, qmax, jax_too, g_lanes = case
    code = _code(name)
    ct = _tensors(name)
    chan = _llrs(np.random.default_rng(hash(_case_id(case)) % 2 ** 32), B,
                 code.n, sigma, qmax)
    got = resident_decode(ct, chan, iters, L, qmax=qmax, early_term=et,
                          **cn)
    plain = _plain(code, chan, iters, cn, et, qmax)
    _same(got, plain)
    gl = slice(None) if g_lanes is None else slice(0, g_lanes)
    _same([x[gl] for x in got],
          _golden(code, chan[gl], iters, cn, et, qmax))
    if jax_too:
        _same(got, jqc.make_qc_decoder(
            code, max_iter=iters, qmax=qmax, schedule="layered",
            early_term=et, **cn)(jnp.asarray(chan)))
    if et:
        assert got[1][0] == 0 and got[2][0]
    # the wrapper runs the same decode on the CPU through its plain
    # version: the resident instance, on the packed kernel where its block
    # fits (lanes by the batch), else on the template
    dec = ms.make_stream_decoder(ct, max_iter=iters, qmax=qmax,
                                 early_term=et, resident=True, **cn)
    assert dec.packed == ms.resident_packed_fits(ct, 2)
    assert dec.lanes_for(B) == (ms.resident_lanes(ct, B) if dec.packed
                                else 1)
    before = ms.plain_calls, ms.kernel_launches, ms.packed_launches
    _same([x.numpy() for x in dec(torch.as_tensor(chan))], plain)
    assert (ms.plain_calls, ms.kernel_launches, ms.packed_launches) == (
        before[0] + 1, before[1], before[2])


@pytest.mark.parametrize("lanes", [2, 4])
def test_lanes_of_one_block_finish_apart(lanes):
    """Early termination: lanes of one block converge at different
    iterations; each keeps the hard bits and iterations of its own first
    success while the block runs on."""
    code = _code("wifi648")
    ct = from_reference(code, "cpu")
    chan = _llrs(np.random.default_rng(4), 12, code.n, 0.85, 127)
    got = resident_decode(ct, chan, 12, lanes, early_term=True, **OMS)
    _same(got, _golden(code, chan, 12, OMS, True, 127))
    blocks = got[1].reshape(-1, lanes)
    assert (blocks.max(axis=1) > blocks.min(axis=1)).sum() >= 2


@pytest.mark.parametrize("et", [False, True], ids=["fixed", "et"])
@pytest.mark.parametrize("lanes", [2, 4])
def test_all_zero_noiseless_batch(lanes, et):
    ct = from_reference(_code("nr-bg1-z16"), "cpu")
    chan = np.full((5, ct.n), 8, np.int8)
    hard, iters, conv = resident_decode(ct, chan, 5, lanes, early_term=et,
                                        **OMS)
    assert not hard.any() and conv.all()
    assert (iters == (0 if et else 5)).all()


@pytest.mark.parametrize("variant,lanes,et", [
    ("resident", 4, False), ("resident-et", 2, True),
    pytest.param("resident", 2, False, marks=SLOW),
    pytest.param("resident-et", 4, True, marks=SLOW)])
def test_datapath_equals_pallas_interpret(variant, lanes, et):
    """The reference's kernel_resident (K6d) and kernel_resident_et (K6e)
    in interpret mode on the toy code, 128 lanes, 6 iterations."""
    code = _code("toy")
    chan = _llrs(np.random.default_rng(11), 128, code.n, 0.9, 127)
    ref = jstream.make_stream_decoder(
        code, max_iter=6, beta=2, qmax=127, batch_tile=128, interpret=True,
        **(dict(early_term=True) if et else dict(resident=True)))
    assert ref.variant == variant
    want = [np.asarray(x) for x in ref(jnp.asarray(chan))]
    got = resident_decode(from_reference(code, "cpu"), chan, 6, lanes,
                          early_term=et, **OMS)
    _same(got, want)
    if et:
        assert len(np.unique(want[1])) >= 3


@SLOW
@pytest.mark.parametrize("et", [False, True], ids=["fixed", "et"])
def test_nr_bg1_z384_emulation_equals_plain(et):
    """The real widths of NR BG1 Z=384 (17,664 variables, 768 punctured at
    LLR 0), 5 lanes at four lanes a thread, 4 iterations."""
    cfg = PRESETS["nr-bg1-layered"]
    code = build_code(cfg)
    ct = from_reference(code, "cpu")
    chan = _llrs(np.random.default_rng(2), 5, ct.n, 0.7, 127)
    chan[:, np.asarray(code.punct_vns)] = 0
    got = resident_decode(ct, chan, 4, 4, early_term=et, **OMS)
    want = make_qc_decoder(code, max_iter=4, qmax=127, schedule="layered",
                           early_term=et, **OMS)(torch.as_tensor(chan))
    _same(got, [x.numpy() for x in want])


# --- shapes, refusals, constants ---------------------------------------------

def _ct(name="dvbs2-64800-r12", **code):
    cfg = PRESETS[name]
    cfg = dataclasses.replace(cfg, code=dataclasses.replace(cfg.code,
                                                            **code))
    return cfg, from_reference(build_code(cfg), "cpu")


# code -> (n, Z, mb, E, the longest row), then at 2 and 4 lanes a thread:
# (message words of a block, ring words a stage, shared memory, blocks an
# SM by shared memory)
SHAPES = {
    ("nr-bg1-layered", ()): ((17664, 384, 24, 206, 22),
                             {2: (109, 11, 16 + 70656 + 2 * 11 * 384 * 4
                                  + 16, 2),
                              4: (206, 22, 16 + 141312 + 2 * 22 * 384 * 4
                                  + 16, 1)}),
    ("dvbs2-64800-r12", (("n", 16200),)): (
        (16200, 360, 25, 151, 7),
        {2: (76, 4, 16 + 64800 + 2 * 4 * 360 * 4 + 16, 3),
         4: (151, 7, 16 + 129600 + 2 * 7 * 360 * 4 + 16, 1)}),
    ("dvbs2-64800-r12", (("n", 16200), ("rate", "8/9"))): (
        (16200, 360, 5, 136, 28),
        {2: (70, 14, 16 + 64800 + 2 * 14 * 360 * 4 + 16, 2),
         4: (136, 28, 16 + 129600 + 2 * 28 * 360 * 4 + 16, 1)}),
}


@pytest.mark.parametrize("key", list(SHAPES), ids=["nr-bg1-z384",
                                                   "dvbs2-16200",
                                                   "dvbs2-16200-r89"])
def test_shapes_against_hand_computed_bytes(key):
    (n, Z, mb, E, dmax), per_lanes = SHAPES[key]
    _, ct = _ct(key[0], **dict(key[1]))
    assert (ct.n, ct.Z, ct.mb, ct.n_entries, ms.max_row_degree(ct)) == (
        n, Z, mb, E, dmax)
    assert ms.RESIDENT_STAGES == 2
    for L, (words, wmax, smem, blocks) in per_lanes.items():
        tab = ms.resident_tables(ct, L)
        assert len(tab) == 2 * (mb + 1) + E <= ms.TAB_WORDS
        assert int(tab[2 * mb + 1]) == words == sum(
            ms.resident_words(len(r), L) for r in ct.entries)
        assert ms.resident_wmax(ct, L) == wmax
        assert ms.resident_packed_smem(ct, L) == smem <= ms.MAX_SMEM
        assert ms.resident_packed_fits(ct, L)
        assert ms.resident_blocks(ct, L) == blocks
    # B = 256: 64 blocks of four would leave half of 132 SMs idle, so two
    # lanes a thread (128 blocks); B = 1,024: 256 blocks of four
    assert ms.resident_lanes(ct, 256) == 2
    assert ms.resident_lanes(ct, 1024) == 4
    d = ms.make_stream_decoder(ct, resident=True, early_term=True)
    assert d.packed and d.variant == "stream-resident-et"
    assert [d.lanes_for(B) for B in (256, 1024)] == [2, 4]
    assert d.kernel_name(256) == "resident_packed_kernel<2, true>"
    assert d.kernel_name(1024) == "resident_packed_kernel<4, true>"


def test_template_keeps_the_codes_the_packed_kernel_refuses():
    """No code that `stream-resident` admitted before the packed kernel is
    refused: where no packed block fits, the template keeps it. DVB-S2
    n=64,800 (259,200 B of posteriors at two lanes) is one such code."""
    cfg, ct = _ct()
    assert ms.block_fits(ct, True, False) and ms.block_fits(ct, True, True)
    assert not ms.resident_packed_fits(ct, 2)
    assert ms.resident_packed_smem(ct, 2) > ms.MAX_SMEM
    assert ms.resident_lanes(ct, 1024) == 0
    for et, variant in ((False, "stream-resident"),
                        (True, "stream-resident-et")):
        c = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, early_term=et))
        d = ms.make_decoder(ct, c.decoder, c.quant, resident=True)
        assert d.variant == variant and not d.packed
        assert d.kernel_name(1024) == (
            f"minsum_stream_kernel<true, {'true' if et else 'false'}>")
        assert d.lanes_for(1024) == 1 and d.smem_bytes() == ms.smem_bytes(
            ct, True, et)
    # Z above the launch bound, or one base row (the ring looks a step
    # ahead): the template
    _, nr = _ct("nr-bg1-layered")
    wide = dataclasses.replace(nr, Z=640)
    assert not ms.resident_packed_fits(wide, 2)
    toy = from_reference(_code("toy"), "cpu")
    assert ms.make_stream_decoder(toy, resident=True).packed
    one_row = dataclasses.replace(toy, mb=1, entries=toy.entries[:1])
    assert not ms.resident_packed_fits(one_row, 2)
    assert not ms.make_stream_decoder(one_row, resident=True).packed


def test_lanes_follow_the_batch():
    """The packed kernel's lanes a thread come from the batch of each
    launch and the SM count of the code's card (132 off the card), the
    rule `instance_auto` reads: four lanes once ceil(B / 4) blocks give
    every SM its one block of four (NR BG1: B >= 525); no caller forces
    them."""
    _, ct = _ct("nr-bg1-layered")
    assert ms.card_sms(ct.device) == ms.card_sms(None) == ms.H100_SMS == 132
    assert ms.resident_blocks(ct, 4) == 1
    d = ms.make_stream_decoder(ct, resident=True)
    assert d.packed
    assert [d.lanes_for(B) for B in (1, 3, 5, 256, 524, 525, 1024, 4099)] \
        == [2, 2, 2, 2, 2, 4, 4, 4]
    assert [ms.resident_lanes(ct, B) for B in (524, 525)] == [2, 4]
    for kw in (dict(lanes=2), dict(lanes=1, resident=True)):
        with pytest.raises(TypeError, match="lanes"):
            ms.make_stream_decoder(ct, **kw)
    before = ms.kernel_launches, ms.packed_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        d.kernel(torch.zeros((2, ct.n), dtype=torch.int8))
    assert (ms.kernel_launches, ms.packed_launches) == before


def test_constants_equal_the_source():
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             SOURCE).group(1))
    assert const("kResidentRow") == ms.RESIDENT_ROW
    assert const("kResidentAhead") == ms.RESIDENT_AHEAD
    assert "constexpr int kResidentStages = kResidentAhead + 1;" in SOURCE
    assert const("kResidentMaxThreads") == ms.RESIDENT_MAX_THREADS
    assert const("kResidentVote") == ms.RESIDENT_VOTE
    # a round of the vote ORs into s_un between two barriers: every thread
    # reads the same word, and no thread ORs the next round's lanes into it
    # before every thread has read it
    assert re.search(r"if \(un\) atomicOr\(s_un, un\);\s+__syncthreads\(\);"
                     r"\s+found = \*s_un;\s+__syncthreads\(\);", SOURCE)
    assert re.search(r"__launch_bounds__\(kResidentMaxThreads, LPT == 2 \? "
                     r"2 : 1\)\s+resident_packed_kernel\(", SOURCE)
    assert "return (d * lpt + 3) / 4;" in SOURCE      # resident_words
    assert "return (lpt == 2 || lpt == 4)" in SOURCE
    for L in ms.RESIDENT_LANES:
        assert f"resident_packed_kernel<{L}, true>" in SOURCE
        assert f"resident_packed_kernel<{L}, false>" in SOURCE
