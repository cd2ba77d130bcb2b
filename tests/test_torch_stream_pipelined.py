"""The pipelined streaming kernel (stream_pipelined_kernel of
ldpc_tpu_torch/kernels/csrc/minsum_stream.cu: K6b/K6c and K6f as the route
takes them) against the references, on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py). Here a numpy
emulation of its datapath, over the whole batch, is held to
golden.decoder.decode_fixed(schedule="layered"), to the JAX QC decoder and
to the port's plain version (ops/decode_qc), with tolerance 0: the int16
posteriors of a block's codeword; the tables as the kernel's parameters
(`pipelined_tables`: layer_ptr, then base2 = 2 (col Z + shift) and thr = Z
- shift an entry); each layer step's int8 row messages, DMAX bytes a row
(the 8-, 24-, 28- or 32-entry register row: DVB-S2 rate 8/9's rows of
27-28 take 28 bytes, the (3,30) array code's 30 and a code with rows of 25
and 32 take 32), copied into a ring of RING_STAGES slots
RING_AHEAD steps ahead, nothing copied and old = 0 in the first iteration
(the scratch starts as garbage); the row's reduction on unclipped
magnitudes with one clip at qmax; early termination with the block's
chunked syndrome vote, latched hard bits and `iters`. Then that reduction
against CnRow's on rows with ties at min1 and magnitudes beyond qmax, the
shape rule against hand-computed bytes, the wrapper's constants against
the source's, and the route rule (`instance_auto`, `select_decoder`) on
CPU code tensors."""
import dataclasses
import functools
import re
from pathlib import Path

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
from ldpc_tpu.ops import decode_qc as jqc
from ldpc_tpu_torch import PRESETS
from ldpc_tpu_torch.codes import (CodeTensors, build_code, from_reference,
                                  own_code, qc_entries)
from ldpc_tpu_torch.kernels import minsum_stream as ms
from ldpc_tpu_torch.ops.decode_qc import make_qc_decoder
from ldpc_tpu_torch.sim.pipeline import select_decoder

torch.set_num_threads(2)

SENTINEL = 1 << 14       # ldpc::kMinSentinel
CHUNK = 8                # kSyndromeChunk: base rows between block votes
SOURCE = (Path(ms.__file__).resolve().parent / "csrc"
          / "minsum_stream.cu").read_text()
OMS = dict(beta=2, alpha=None)
NMS = dict(beta=0, alpha=(3, 2))
MS = dict(beta=0, alpha=None)


# --- the check row ------------------------------------------------------

def finish(m, beta, alpha):
    """CnRow::finish on min1 or min2."""
    if alpha is not None and tuple(alpha) != (1, 0):
        m = (m * alpha[0]) >> alpha[1]
    return np.maximum(m - beta, 0) if beta else m


def row_update(raws, qmax, beta, alpha):
    """The kernel's row over one layer's raw values (a list of arrays,
    entry k's v2c): min1/min2 of the unclipped magnitudes, clipped at qmax
    once, the emit comparing unclipped magnitudes with the unclipped min1.
    Returns the new messages."""
    min1 = np.full(raws[0].shape, SENTINEL, np.int64)
    min2 = min1.copy()
    negacc = np.zeros(raws[0].shape, np.int64)
    for raw in raws:
        m = np.abs(raw)
        min2 = np.minimum(min2, np.maximum(min1, m))
        min1 = np.minimum(min1, m)
        negacc ^= raw
    min1o = finish(np.minimum(min1, qmax), beta, alpha)
    min2o = finish(np.minimum(min2, qmax), beta, alpha)
    news = []
    for raw in raws:
        mag = np.where(np.abs(raw) == min1, min2o, min1o)
        news.append(np.where((negacc ^ raw) < 0, -mag, mag))
    return news


def cn_row(raws, qmax, beta, alpha):
    """CnRow (cn_minsum.cuh) as the template computes it: magnitudes
    clipped at qmax on the way in, the emit comparing clipped values."""
    min1 = np.full(raws[0].shape, SENTINEL, np.int64)
    min2 = min1.copy()
    negacc = np.zeros(raws[0].shape, np.int64)
    for raw in raws:
        m = np.minimum(np.abs(raw), qmax)
        min2 = np.minimum(min2, np.maximum(min1, m))
        min1 = np.minimum(min1, m)
        negacc ^= raw
    min1o, min2o = finish(min1, beta, alpha), finish(min2, beta, alpha)
    out = []
    for raw in raws:
        mag = np.where(np.minimum(np.abs(raw), qmax) == min1, min2o, min1o)
        out.append(np.where((negacc ^ raw) < 0, -mag, mag))
    return out


# --- the datapath -----------------------------------------------------------

def pipelined_decode(ct, chan, max_iter, qmax=127, beta=0, alpha=None,
                     early_term=False):
    """The pipelined kernel's datapath over the batch: chan int8 (B, n) ->
    (hard (B, n) uint8, iters (B,) int32, conv (B,) bool). Block b is lane
    b; a lane that is done (early termination) leaves its state alone."""
    chan = np.asarray(chan, np.int8)
    B = chan.shape[0]
    Z, mb = ct.Z, ct.mb
    E = ct.n_entries
    tab = ms.pipelined_tables(ct).astype(np.int64)
    assert len(tab) == mb + 1 + 2 * E
    layer_ptr, base2, thr = tab[: mb + 1], tab[mb + 1: mb + 1 + E], tab[-E:]
    W = ms.row_bytes(ct)
    assert W == ms.pipelined_dmax(ct) and max(np.diff(layer_ptr)) <= W
    y = np.arange(Z)

    def pidx_of(e):
        """Row y's posterior of entry e: byte 2 y + base2[e], less 2 Z
        where y >= thr[e]; as an int16 index."""
        a = 2 * y + base2[e] - np.where(y >= thr[e], 2 * Z, 0)
        return a // 2

    def unsat(post):
        """The block's vote: any row unsatisfied, chunk by chunk."""
        res = np.zeros(B, bool)
        for l0 in range(0, mb, CHUNK):
            chunk = np.zeros(B, bool)
            for l in range(l0, min(l0 + CHUNK, mb)):
                x = np.zeros((B, Z), np.int64)
                for e in range(layer_ptr[l], layer_ptr[l + 1]):
                    x ^= post[:, pidx_of(e)].astype(np.int64)
                chunk |= (x < 0).any(axis=1)
            res |= chunk
            if chunk.all():
                break
        return res

    post = chan.astype(np.int16)
    msg = np.full((B, mb, Z, W), 0xA5, np.uint8)      # never zeroed
    ring = np.full((ms.RING_STAGES, B, Z, W), 0x5A, np.uint8)
    fetch = [0]                                       # next step to copy

    def copy_next():
        it_f, l_f = divmod(fetch[0], mb)
        if 1 <= it_f < max_iter:
            ring[fetch[0] % ms.RING_STAGES] = msg[:, l_f]
        fetch[0] += 1

    for _ in range(ms.RING_AHEAD):
        copy_next()
    done = ~unsat(post) if early_term else np.zeros(B, bool)
    iters = np.zeros(B, np.int32)
    for it in range(max_iter):
        if done.all():
            break
        act = ~done
        for l in range(mb):
            t = it * mb + l
            copy_next()
            row = (ring[t % ms.RING_STAGES] if it
                   else np.zeros((B, Z, W), np.uint8))
            e0, e1 = layer_ptr[l], layer_ptr[l + 1]
            pidx = [pidx_of(e) for e in range(e0, e1)]
            raws = [post[:, pi].astype(np.int64)
                    - row[..., k].view(np.int8).astype(np.int64)
                    for k, pi in enumerate(pidx)]
            news = row_update(raws, qmax, beta, alpha)
            lanes = np.nonzero(act)[0]
            for pi, raw, nw in zip(pidx, raws, news):
                post[np.ix_(lanes, pi)] = (raw + nw)[lanes].astype(np.int16)
            new_row = np.zeros((B, Z, W), np.uint8)     # unused slots: 0
            for k, nw in enumerate(news):
                new_row[..., k] = nw.astype(np.int8).view(np.uint8)
            msg[act, l] = new_row[act]
        if early_term:
            iters[act] = it + 1
            done[act] = ~unsat(post)[act]
    conv = done if early_term else ~unsat(post)
    if not early_term:
        iters[:] = max_iter
    return (post < 0).astype(np.uint8), iters, conv


# --- the cases --------------------------------------------------------------

def rows_25_32(Z=37):
    """Four base rows of 25 and 32 circulants in turn, array-code shifts
    i j mod Z (girth 6 at a prime Z): the 32-entry register row's longest
    and shortest rows. No systematic form; decoded on LLRs alone."""
    base = np.array([[(i * j) % Z if i % 2 or j < 25 else -1
                      for j in range(32)] for i in range(4)], np.int64)
    return expand_qc(base, Z, name=f"rows_25_32_z{Z}")


@functools.lru_cache(maxsize=None)
def _code(name):
    return {"toy": lambda: toy_qc(8),
            "wifi648": lambda: make_wifi(648, "1/2"),
            "nr-bg2-z16": lambda: make_nr(base_graph=2, Z=16),
            "nr-bg1-z16": lambda: make_nr(base_graph=1, Z=16),
            "dvbs2-16200": lambda: make_dvbs2(16200, "1/2"),
            "dvbs2-64800": lambda: make_dvbs2(64800, "1/2"),
            "dvbs2-16200-r89": lambda: make_dvbs2(16200, "8/9"),
            "array-3x30": lambda: array_qc(3, 30, 31),
            "rows-25-32": rows_25_32}[name]()


@functools.lru_cache(maxsize=None)
def _tensors(name):
    """CodeTensors of a test code on the CPU; the codes with no systematic
    form get the entries only (what a decoder reads)."""
    code = _code(name)
    if name not in ("array-3x30", "rows-25-32"):
        return from_reference(code, "cpu")
    port = own_code(code)
    qc, entries = qc_entries(port)
    return CodeTensors(code=port, device=torch.device("cpu"), n=int(code.n),
                       k=int(code.k), Z=int(qc.Z), nb=int(qc.nb),
                       mb=int(qc.mb), kb=0, entries=entries, P=None,
                       perm=None, info_positions=torch.zeros(
                           0, dtype=torch.int64), ident_info=False)


def _llrs(rng, B, n, sigma=0.8, scale=4.0, qmax=127):
    """Quantized LLRs of the all-zeros word over BPSK/AWGN."""
    y = 1.0 + sigma * rng.standard_normal((B, n))
    return np.clip(np.round(2.0 * y / sigma ** 2 * scale), -qmax,
                   qmax).astype(np.int8)


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64))


def _references(code, chan, max_iter, cn, early_term, jax_too, qmax=127):
    """golden per codeword, the port's plain decode_qc and, where asked,
    the JAX QC decoder: all three equal, returned as golden's."""
    beta, alpha = cn["beta"], cn["alpha"]
    rows = [decode_fixed(c, code, max_iter=max_iter, beta=beta, qmax=qmax,
                         schedule="layered", early_term=early_term,
                         alpha=alpha) for c in chan]
    want = (np.stack([r.hard for r in rows]),
            np.array([r.iters for r in rows]),
            np.array([r.converged for r in rows]))
    plain = make_qc_decoder(own_code(code), max_iter=max_iter, beta=beta,
                            qmax=qmax, schedule="layered",
                            early_term=early_term,
                            alpha=alpha)(torch.as_tensor(chan))
    _same([x.numpy() for x in plain], want)
    if jax_too:
        got = jqc.make_qc_decoder(code, max_iter=max_iter, beta=beta,
                                  qmax=qmax, schedule="layered",
                                  early_term=early_term, alpha=alpha)(
            jnp.asarray(chan))
        _same(got, want)
    return want


# (code, B, iterations, sigma, CN, early termination, JAX too, qmax)
CASES = [
    *(("toy", 16, 5, 0.9, cn, et, True, 127)
      for cn in (OMS, NMS) for et in (False, True)),
    *(("toy", 16, 5, 0.9, OMS, et, True, 31) for et in (False, True)),
    *(("wifi648", 6, 4, 0.8, cn, et, cn is OMS, 127)
      for cn in (OMS, NMS) for et in (False, True)),
    *(("wifi648", 6, 4, 0.8, OMS, et, False, 31) for et in (False, True)),
    # rows of 10 and of 22: the 24-entry register row, 24 bytes a row
    ("nr-bg2-z16", 8, 4, 0.8, OMS, False, True, 127),
    ("nr-bg2-z16", 8, 5, 0.8, NMS, True, False, 127),
    ("nr-bg1-z16", 4, 4, 0.8, OMS, True, False, 127),
    ("dvbs2-16200", 2, 3, 0.8, OMS, False, True, 127),
    ("dvbs2-16200", 2, 5, 0.72, NMS, True, False, 127),
    ("dvbs2-16200", 2, 5, 0.72, OMS, True, False, 127),
    ("dvbs2-64800", 1, 2, 0.8, OMS, False, False, 127),
    # rows of 27-28: the 28-entry register row, 28 bytes a row (seven
    # words: byte k of the row in byte k % 4 of word k / 4)
    ("dvbs2-16200-r89", 2, 3, 0.5, OMS, False, True, 127),
    ("dvbs2-16200-r89", 2, 4, 0.45, NMS, True, False, 127),
    ("dvbs2-16200-r89", 3, 3, 0.5, MS, True, False, 31),
    # rows of 30 and of 25 and 32: the 32-entry register row, every CN
    # variant, qmax 7, 31 and 127, ragged batches
    *(("array-3x30", 5, 6, 0.7, cn, et, False, 127)
      for cn in (OMS, NMS, MS) for et in (False, True)),
    *(("array-3x30", 3, 6, 0.7, OMS, et, False, q)
      for q in (7, 31) for et in (False, True)),
    *(("rows-25-32", B, 6, 0.7, cn, et, False, 127)
      for B, cn in ((1, OMS), (3, NMS), (5, MS)) for et in (False, True)),
    *(("rows-25-32", 4, 6, 0.7, cn, et, False, q)
      for q, cn in ((7, OMS), (31, NMS)) for et in (False, True)),
    ("rows-25-32", 4, 5, 0.7, OMS, True, True, 127),
]


def _case_id(case):
    code, B, iters, _, cn, et, _, qmax = case
    alg = {id(OMS): "oms", id(NMS): "nms", id(MS): "ms"}[id(cn)]
    return (f"{code}-B{B}-{alg}-{'et' if et else 'fixed'}{iters}-q{qmax}")


# the JAX QC decoder compiles for 25-45 s on the codes of the longer rows
SLOW_JAX = ("dvbs2-16200-r89", "rows-25-32")


@pytest.mark.parametrize("case", [
    pytest.param(c, id=_case_id(c), marks=(
        [pytest.mark.slow] if c[6] and c[0] in SLOW_JAX else []))
    for c in CASES])
def test_datapath_equals_golden_jax_and_plain(case):
    name, B, iters, sigma, cn, et, jax_too, qmax = case
    code = _code(name)
    ct = _tensors(name)
    chan = _llrs(np.random.default_rng(7), B, code.n, sigma, qmax=qmax)
    if et:
        chan[0] = min(60, qmax)           # a codeword from the start
    got = pipelined_decode(ct, chan, iters, qmax=qmax, early_term=et, **cn)
    want = _references(code, chan, iters, cn, et, jax_too, qmax)
    _same(got, want)
    if et:
        assert want[1][0] == 0 and want[2][0]
    # the wrapper runs the same decode on the CPU through its plain version
    dec = ms.make_stream_decoder(ct, max_iter=iters, qmax=qmax,
                                 early_term=et, pipelined=True, **cn)
    assert dec.variant == ms.PIPELINED[et] and dec.resident
    before = ms.plain_calls, ms.kernel_launches
    _same([x.numpy() for x in dec(torch.as_tensor(chan))], want)
    assert (ms.plain_calls, ms.kernel_launches) == (before[0] + 1,
                                                    before[1])


@pytest.mark.parametrize("et", [False, True], ids=["fixed", "et"])
@pytest.mark.parametrize("name", ["wifi648", "nr-bg2-z16", "rows-25-32"])
def test_all_zero_noiseless_batch(et, name):
    ct = _tensors(name)
    chan = np.full((4, ct.n), 8, np.int8)
    hard, iters, conv = pipelined_decode(ct, chan, 5, early_term=et, **OMS)
    assert not hard.any() and conv.all()
    assert (iters == (0 if et else 5)).all()


@pytest.mark.parametrize("et", [False, True], ids=["fixed", "et"])
@pytest.mark.parametrize("cn", [OMS, NMS], ids=["oms", "nms"])
def test_batch_where_every_row_ties(cn, et):
    """Every |LLR| equal: each row's entries tie at min1 (min2 == min1) in
    the first layers, so every entry at min1 gets min2o, which equals
    min1o."""
    code = _code("toy")
    ct = from_reference(code, "cpu")
    rng = np.random.default_rng(3)
    chan = np.where(rng.random((6, code.n)) < 0.2, -9, 9).astype(np.int8)
    got = pipelined_decode(ct, chan, 4, early_term=et, **cn)
    _same(got, _references(code, chan, 4, cn, et, True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_reduction_equals_cnrow(seed):
    """Random rows of degree 2-32 (OMS, NMS, plain min-sum; qmax 127, 31
    and 7, so that the clip at qmax bites), a third of them with ties at
    min1, some at 0 and some beyond qmax: the kernel's row (unclipped
    reduction, one clip, the emit against the unclipped min1) gives
    CnRow's messages entry by entry."""
    rng = np.random.default_rng(seed)
    for d in (*range(2, 9), 10, 19, 22, 24, *range(25, 33)):
        raws = [rng.integers(-300, 300, size=4096) for _ in range(d)]
        tie = rng.random(4096) < 0.33
        for k in rng.choice(d, size=2, replace=False):
            raws[k] = np.where(tie, np.where(raws[k] < 0, -5, 5), raws[k])
        raws[0] = np.where(rng.random(4096) < 0.1, 0, raws[0])
        for qmax in (127, 31, 7):
            for cn in (OMS, NMS, MS):
                for got, want in zip(row_update(raws, qmax, **cn),
                                     cn_row(raws, qmax, **cn)):
                    np.testing.assert_array_equal(got, want)


def test_constants_equal_the_source():
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             SOURCE).group(1))
    assert const("kRingAhead") == ms.RING_AHEAD
    assert ms.RING_STAGES == ms.RING_AHEAD + 1
    assert const("kRingTabWords") == ms.RING_TAB_WORDS
    assert const("kSyndromeChunk") == CHUNK
    assert "constexpr int W = DMAX;" in SOURCE      # int8 rows
    assert ("return max_deg <= 8 ? 8 : max_deg <= 24 ? 24 : max_deg <= 28 ? "
            "28\n       : max_deg <= 32 ? 32 : 0;") in SOURCE
    assert ("return dmax <= 8 ? 1024 : dmax <= 24 ? 512 : dmax <= 28 ? 384 "
            ": 256;") in SOURCE
    assert all(ms.pipelined_threads(w) == t
               for w, t in ms.PIPELINED_ROWS.items())
    # rows of 27 and 28 take straight-line bodies in the 28-entry row
    assert "case 27: layer(Deg<27>{}" in SOURCE
    assert "case 28: layer(Deg<28>{}" in SOURCE
    assert "__launch_bounds__(pipelined_threads(DMAX))" in SOURCE
    for w in ms.PIPELINED_ROWS:
        assert f"stream_pipelined_kernel<{w}, true>" in SOURCE
        assert f"stream_pipelined_kernel<{w}, false>" in SOURCE


def _ct(name="dvbs2-64800-r12", **code):
    cfg = PRESETS[name]
    cfg = dataclasses.replace(cfg, code=dataclasses.replace(cfg.code,
                                                            **code))
    return cfg, from_reference(build_code(cfg), "cpu")


def test_shape_rule_against_hand_computed_bytes():
    cfg, ct = _ct()
    assert (ct.nb, ct.mb, ct.Z, ct.n_entries) == (180, 90, 360, 631)
    assert ms.max_row_degree(ct) == 8 and ms.pipelined_dmax(ct) == 8
    # the template's resident block: 2,165 table words, the flag, posteriors
    assert ms.smem_bytes(ct, True, False) == 8672 + 16 + 129600 == 138288
    # the pipelined block: posteriors, 3 ring stages of 360 rows of 8
    # bytes, the mbarrier
    assert ms.RING_STAGES == 3
    assert ms.pipelined_smem(ct) == 129600 + 3 * 360 * 8 + 16 == 138256
    assert ms.row_bytes(ct) == 8
    # the scratch a codeword: 8 bytes a check row
    assert ct.mb * ct.Z * 8 == 259200
    assert len(ms.pipelined_tables(ct)) == 91 + 2 * 631 <= ms.RING_TAB_WORDS
    # NR BG1 Z=384: rows up to 22 take the 24-entry register row
    nr_cfg, nr = _ct("nr-bg1-layered")
    assert ms.max_row_degree(nr) == 22 and ms.pipelined_dmax(nr) == 24
    assert ms.pipelined_smem(nr) == 2 * 17664 + 3 * 384 * 24 + 16 == 62992
    assert ms.pipelined_fits(nr)
    # DVB-S2 n=64,800 rate 8/9: 20 base rows of 27 (19) and 28 (1), 541
    # circulants; the 28-entry register row, 28 bytes a row (27.05 a row
    # exact: the stored messages are 28 / 27.05 of them)
    _, r89 = _ct(rate="8/9")
    assert (r89.nb, r89.mb, r89.Z, r89.n_entries) == (180, 20, 360, 541)
    assert sorted(len(r) for r in r89.entries) == [27] * 19 + [28]
    assert ms.pipelined_dmax(r89) == ms.row_bytes(r89) == 28
    assert ms.pipelined_threads(28) == 384 >= r89.Z
    assert ms.pipelined_smem(r89) == 129600 + 3 * 360 * 28 + 16 == 159856
    assert len(ms.pipelined_tables(r89)) == 21 + 2 * 541 == 1103
    assert r89.mb * r89.Z * 28 == 201600            # the scratch a codeword
    assert ms.pipelined_fits(r89)
    # rows of 30 and of 25-32 take the 32-entry row: 32 bytes a row
    for name in ("array-3x30", "rows-25-32"):
        t = _tensors(name)
        assert ms.pipelined_dmax(t) == ms.row_bytes(t) == 32
        assert ms.pipelined_smem(t) == (2 * t.n + 15) // 16 * 16 + (
            3 * t.Z * 32 + 15) // 16 * 16 + 16
        assert ms.pipelined_fits(t)


def test_pipelined_rule_follows_the_shape():
    """What the pipelined kernel refuses: rows above its 32-entry
    register row, more threads than the register row's launch bound (512
    at 24 entries, 384 at 28, 256 at 32), a ring that would wrap onto the
    step it feeds; the template then takes the code where it fits. The
    kernel keeps the posteriors resident."""
    _, ct = _ct()
    r89_cfg, r89 = _ct(rate="8/9")
    assert ms.max_row_degree(r89) == 28 and ms.pipelined_dmax(r89) == 28
    assert ms.pipelined_fits(r89)
    assert ms.make_stream_decoder(r89, pipelined=True).variant == \
        "stream-pipelined"
    assert ms.instance_auto(r89, False) == "pipelined"
    assert ms.instance_auto(r89, True, 1024) == "pipelined"
    s89_cfg, s89 = _ct(n=16200, rate="8/9")
    assert ms.pipelined_fits(s89) and ms.straight_rows(s89)
    # the packed resident kernel at four lanes a thread, else the 28-entry
    # row's straight-line bodies
    assert ms.instance_auto(s89, True, 1024) == "resident"
    assert ms.instance_auto(s89, True, 256) == "pipelined"
    assert ms.instance_auto(s89, True) == "pipelined"
    assert ms.pipelined_fits(ct)
    wide = dataclasses.replace(ct, Z=640)
    assert ms.pipelined_dmax(wide) == 8 and ms.pipelined_fits(wide)
    nr_cfg, nr = _ct("nr-bg1-layered")
    assert not ms.pipelined_fits(dataclasses.replace(nr, Z=640))
    # 384 threads at rows of 25-28: Z = 384 fits, 385 does not; 256 at
    # rows of 29-32
    assert [ms.pipelined_threads(w) for w in (8, 24, 28, 32)] == [
        1024, 512, 384, 256]
    assert ms.pipelined_fits(dataclasses.replace(r89, Z=384))
    assert not ms.pipelined_fits(dataclasses.replace(r89, Z=385))
    arr = _tensors("array-3x30")
    assert ms.pipelined_dmax(arr) == 32 and ms.pipelined_fits(arr)
    assert ms.pipelined_fits(dataclasses.replace(arr, Z=256))
    assert not ms.pipelined_fits(dataclasses.replace(arr, Z=257))
    # a row of 33: no register row; the template streams it
    long_row = dataclasses.replace(r89, entries=[
        r89.entries[0] + r89.entries[1][:6], *r89.entries[2:]], mb=19)
    assert ms.max_row_degree(long_row) == 33
    assert ms.pipelined_dmax(long_row) == 0
    assert not ms.pipelined_fits(long_row)
    with pytest.raises(ValueError, match="does not take"):
        ms.make_stream_decoder(long_row, pipelined=True)
    assert ms.instance_auto(long_row, False) == "stream"
    toy = from_reference(toy_qc(8), "cpu")
    assert toy.mb > ms.RING_AHEAD and ms.pipelined_fits(toy)
    assert not ms.pipelined_fits(dataclasses.replace(toy, mb=ms.RING_AHEAD))
    with pytest.raises(ValueError, match="resident"):
        ms.make_stream_decoder(ct, pipelined=True, resident=False)


def test_kernel_refuses_cpu_tensors():
    """On a CPU tensor the decoder runs its plain version; its `kernel`
    raises rather than fall back, and counts no launch."""
    ct = from_reference(_code("toy"), "cpu")
    dec = ms.make_stream_decoder(ct, max_iter=2, pipelined=True)
    before = ms.kernel_launches, ms.instance_launches["stream-pipelined"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        dec.kernel(torch.zeros((2, ct.n), dtype=torch.int8))
    assert (ms.kernel_launches,
            ms.instance_launches["stream-pipelined"]) == before
    assert set(ms.instance_launches) == {*ms.INSTANCES.values(),
                                         *ms.PIPELINED.values()}


def test_route_rule_on_cpu_code_tensors():
    """instance_auto and select_decoder's labels, read from shapes alone."""
    cfg, ct = _ct()
    for et, variant in ((False, "stream-pipelined"),
                        (True, "stream-pipelined-et")):
        c = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, early_term=et))
        assert ms.instance_auto(ct, et) == "pipelined"
        dec, label = select_decoder(ct, c, batch=64)
        assert dec.variant == variant and label == "torch-plain-" + variant
        assert dec.pipelined and dec.resident
    # rows of 22-23 (rate 5/6): the 24-entry register row; 27-28 (rate
    # 8/9): the 28-entry register row
    for rate, variant in (("5/6", "stream-pipelined"),
                          ("8/9", "stream-pipelined")):
        c, r = _ct(rate=rate)
        assert select_decoder(r, c, batch=64)[0].variant == variant
        c = dataclasses.replace(c, decoder=dataclasses.replace(
            c.decoder, early_term=True))
        assert select_decoder(r, c, batch=64)[0].variant == variant + "-et"
    # codes where two resident blocks of the template fit an SM (forced:
    # the on-chip route takes these codes), with no batch given: the
    # pipelined kernel where its straight-line bodies hold the rows (rows
    # of 7-8, and n=16,200's rows of 27-28 at the 28-entry row); the
    # packed resident kernel for NR BG1's rows of up to 22 (the guarded
    # 24-entry row loses there)
    for (c, r), want in ((_ct(n=16200), "pipelined"),
                         (_ct("nr-bg1-layered"), "resident"),
                         (_ct(n=16200, rate="8/9"), "pipelined")):
        assert ms.resident_auto(r, True)
        assert ms.instance_auto(r, True) == want
        variant = select_decoder(r, c, backend="stream")[0].variant
        assert variant == ("stream-pipelined" if want == "pipelined"
                           else "stream-resident")
    assert ms.pipelined_fits(_ct("nr-bg1-layered")[1])
    assert ms.pipelined_fits(_ct(n=16200, rate="8/9")[1])
    # the forced placements of the template stay what they were
    assert ms.make_decoder(ct, cfg.decoder, cfg.quant,
                           resident=False).variant == "stream"
    assert ms.make_decoder(ct, cfg.decoder, cfg.quant,
                           resident=True).variant == "stream-resident"
