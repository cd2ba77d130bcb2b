"""The one-lane decoder instances (`flood_quad_kernel`,
`layered_row_kernel`; csrc/minsum_flood.cu, csrc/minsum_layered.cu) on the
CPU: the quad instance's word mapping (four check rows of one codeword a
word, the circulant shift as a rotation) modelled in numpy against (r + s)
mod Z, its entry tables (`minsum.quad_tables`) driving a numpy model of
the flooding datapath against the plain decoder, the shape rule
(`minsum.one_lane_shape`) against hand-computed bytes and threads and the
sources' constants, the routes and instances of each code the one-lane
template decoded before (the (3,30) array code keeps it), the forced
template, and the plain decoders the card holds the kernels to on NR BG1
Z=384 rate 1/3 against `golden.decoder.decode_fixed` and the JAX package's
plain edge-gather decoder. The kernels themselves run on the card only
(`chip_smoke.py`, slice 13)."""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.config as rcfg
from ldpc_tpu.golden.decoder import decode_fixed
from ldpc_tpu.ops.decode_ref import make_decoder as ref_make_decoder
from ldpc_tpu.sim.sweep import build_code as ref_build_code
from ldpc_tpu_torch import PRESETS
from ldpc_tpu_torch.codes import build_code, from_reference, qc_entries
from ldpc_tpu_torch.codes.toy import array_qc
from ldpc_tpu_torch.config import DecoderConfig, QuantConfig
from ldpc_tpu_torch.kernels import build, minsum
from ldpc_tpu_torch.sim.pipeline import resolve_route, select_decoder

torch.set_num_threads(2)


def _cfg(name="nr-bg1-layered", **code):
    cfg = PRESETS[name]
    return dataclasses.replace(cfg, code=dataclasses.replace(cfg.code,
                                                             **code))


def _ct(name="nr-bg1-layered", **code):
    return from_reference(build_code(_cfg(name, **code)), "cpu")


CODES = {
    "nr384-r13": ("nr-bg1-layered", dict(rate="1/3")),
    "nr320-r13": ("nr-bg1-layered", dict(Z=320, rate="1/3")),
    "dvb16200-r89": ("dvbs2-64800-r12", dict(n=16200, rate="8/9")),
}


def _key_cfg(key):
    preset, code = CODES[key]
    return _cfg(preset, **code)


def _key_ct(key):
    return from_reference(build_code(_key_cfg(key)), "cpu")


# ---------------------------------------------------------------------------
# The quad mapping.

def _quad_check_word(w, q, Q):
    """Variable word and rotation that check word q reads for an entry by
    base row (word w), as quad_totals of csrc/cn_packed.cuh computes them."""
    c = q >= ((w >> 2) & 0x7FF)
    return (w >> 13) + q - np.where(c, Q, 0), (w + c) & 3


def _quad_variable_word(w, q, Q):
    """Message word and rotation that variable word q reads for an entry by
    base column (word w), as quad_message computes them."""
    lo = q < ((w >> 2) & 0x7FF)
    return (w >> 13) + q - np.where(lo, 0, Q), (w + lo) & 3


@pytest.mark.parametrize("Z", [360, 384])
def test_quad_mapping_against_the_circulant(Z):
    """One base row holding every shift s < Z (entry s in base column s):
    element k of check word q, rotated by m, reads element (k + m) mod 4 of
    variable word idx, which must be variable row (r + s) mod Z of column s
    for check row r = q + k Z/4; and the way back, element k of variable
    word q reads element (k - m) mod 4 of message word idx, the message of
    the check row r with (r + s) mod Z = q + k Z/4."""
    ct = dataclasses.replace(
        _ct(), Z=Z, nb=Z, mb=1, entries=(tuple((s, s, s) for s in range(Z)),))
    Q = Z // minsum.QUAD_ROWS
    t = minsum.quad_tables(ct).astype(np.int64)
    ent, by_col = t[Z + 3: Z + 3 + Z], t[Z + 3 + Z:]
    q = np.arange(Q)[:, None]
    k = np.arange(minsum.QUAD_ROWS)[None, :]
    for s in range(Z):
        # check rows r = q + kQ of entry s
        idx, m = _quad_check_word(ent[s], q, Q)
        col, vq = np.divmod(idx, Q)
        assert np.all(col == s) and np.all((0 <= vq) & (vq < Q))
        v = vq + ((k + m) % 4) * Q                    # variable row read
        np.testing.assert_array_equal(v, (q + k * Q + s) % Z)
        # variable rows v = q + kQ of column s (its one entry, s)
        idx, m = _quad_variable_word(by_col[s], q, Q)
        e, cq = np.divmod(idx, Q)
        assert np.all(e == s) and np.all((0 <= cq) & (cq < Q))
        r = cq + ((k - m) % 4) * Q                    # check row read
        np.testing.assert_array_equal((r + s) % Z, q + k * Q)


def test_quad_tables_share_the_packed_layout():
    """quad_tables keeps packed_tables' pointers and lengths: layer_ptr,
    col_ptr, then an entry word by base row and one by base column."""
    ct = _ct(**CODES["nr384-r13"][1])
    quad, packed = minsum.quad_tables(ct), minsum.packed_tables(ct)
    mb, nb, E = ct.mb, ct.nb, ct.n_entries
    assert quad.dtype == np.uint32 and len(quad) == len(packed)
    np.testing.assert_array_equal(quad[: mb + nb + 2], packed[: mb + nb + 2])
    Q = ct.Z // 4
    for row in ct.entries:
        for col, s, e in row:
            w = int(quad[mb + nb + 2 + e])
            assert (w >> 13, (w >> 2) & 0x7FF, w & 3) == (
                col * Q + s % Q, Q - s % Q, s // Q)


# ---------------------------------------------------------------------------
# A numpy model of the quad flooding datapath, driven by quad_tables.

def _quad_flood_model(ct, chan, max_iter, beta, early_term):
    """Hard bits (n,), iters, conv of one codeword's int LLRs (n,) through
    the quad instance's datapath: totals and messages as [word][element]
    arrays, each entry's words and rotations from the table words, the
    min-sum row of cn_minsum.cuh per element."""
    Z, nb, mb, E = ct.Z, ct.nb, ct.mb, ct.n_entries
    Q, qmax = Z // 4, 127
    t = minsum.quad_tables(ct).astype(np.int64)
    layer_ptr, col_ptr = t[: mb + 1], t[mb + 1: mb + nb + 2]
    ent, by_col = t[mb + nb + 2: mb + nb + 2 + E], t[mb + nb + 2 + E:]
    q = np.arange(Q)
    k = np.arange(4)
    # word j Q + q holds variables j Z + q + k Q
    chw = chan.reshape(nb, 4, Q).transpose(0, 2, 1).reshape(nb * Q, 4)
    c2v = np.zeros((E * Q, 4), np.int64)   # messages, not negated
    tot = np.zeros((nb * Q, 4), np.int64)

    def gather_row(li):
        words = []
        for e in range(layer_ptr[li], layer_ptr[li + 1]):
            idx, m = _quad_check_word(ent[e], q, Q)
            words.append(tot[idx[:, None], (k[None, :] + m[:, None]) % 4])
        return np.stack(words)               # (d, Q, 4)

    def unsat():
        return any(np.any(np.bitwise_xor.reduce(
            (gather_row(li) < 0).astype(np.int64), axis=0))
            for li in range(mb))

    for it in range(max_iter + 1):
        for j in range(nb):
            s = np.zeros((Q, 4), np.int64)
            if it:
                for x in range(col_ptr[j], col_ptr[j + 1]):
                    idx, m = _quad_variable_word(by_col[x], q, Q)
                    s += c2v[idx[:, None], (k[None, :] - m[:, None]) % 4]
            tot[j * Q: (j + 1) * Q] = chw[j * Q: (j + 1) * Q] + s
        if it == max_iter:
            conv = not unsat()
            iters = max_iter
            break
        if early_term and not unsat():
            conv, iters = True, it
            break
        for li in range(mb):
            e0, e1 = layer_ptr[li], layer_ptr[li + 1]
            old = np.stack([c2v[e * Q + q] for e in range(e0, e1)])
            raw = gather_row(li) - old
            mag = np.minimum(np.abs(raw), qmax)
            srt = np.sort(mag, axis=0)
            min1, min2 = srt[0], srt[1]
            o1, o2 = np.maximum(min1 - beta, 0), np.maximum(min2 - beta, 0)
            neg = np.bitwise_xor.reduce((raw < 0).astype(np.int64), axis=0)
            for i, e in enumerate(range(e0, e1)):
                out = np.where(mag[i] == min1, o2, o1)
                c2v[e * Q + q] = np.where(neg ^ (raw[i] < 0), -out, out)
    hard = (tot.reshape(nb, Q, 4).transpose(0, 2, 1).reshape(-1) < 0)
    return hard.astype(np.uint8), iters, conv


@pytest.mark.parametrize("Z,max_iter,early_term,beta", [
    (32, 6, True, 2), (32, 5, False, 0), (384, 3, True, 2)])
def test_quad_datapath_model_equals_plain(Z, max_iter, early_term, beta):
    """The numpy model of the quad datapath on NR BG1 rate 1/3 (rows of 4-22)
    == the plain flooding decoder, hard bits, iterations and convergence,
    on three lanes (lane 0 noiseless)."""
    ct = _ct(Z=Z, rate="1/3")
    B = 3
    rng = np.random.default_rng(Z + max_iter)
    y = 1.0 + 0.8 * rng.standard_normal((B, ct.n))
    y[0] = 1.0
    chan = np.clip(np.round(2 * y / 0.64 * 4), -127, 127).astype(np.int8)
    d = minsum.make_decoder(ct, DecoderConfig(
        algorithm="offset-min-sum" if beta else "min-sum",
        schedule="flooding", max_iter=max_iter, early_term=early_term),
        QuantConfig(beta_lsb=beta))
    assert d.one_lane or Z == 32
    hard, iters, conv = d.plain(torch.as_tensor(np.ascontiguousarray(
        chan.T)).reshape(ct.nb, ct.Z, B))
    hard = hard.reshape(ct.n, B).T.numpy()
    for b in range(B):
        h, i, c = _quad_flood_model(ct, chan[b].astype(np.int64), max_iter,
                                    beta, early_term)
        np.testing.assert_array_equal(h, hard[b])
        assert (i, c) == (int(iters[b]), bool(conv[b]))


# ---------------------------------------------------------------------------
# The shape rule.

# Hand-computed: a quad block holds 16 B of counters, the int16 totals
# (8 B a word of four variables: 2n B) and the int8 messages (E Z B), each
# rounded up to 16 B; the channel lives in device memory. NR BG1 rate 1/3
# (nb = 68, mb = 46, E = 309): Z=384 16 + 52,224 + 118,656 = 170,896 B, one
# block an SM; its C phase has 46 x 96 = 4,416 (base row, word) items, 9
# rounds of 512 threads, 491 a round: 512 threads; min* at 384: 12 rounds,
# 368 a round: 384. Z=320: 16 + 43,520 + 98,880 = 142,416 B; 3,680 items,
# 8 rounds, 460: 480 threads (min*: 10 rounds, 368: 384). DVB-S2 n=16,200
# rate 8/9 (nb = 45, mb = 5, E = 136, Z = 360): 16 + 32,400 + 48,960 =
# 81,376 B, two blocks an SM (2 x 82,400 of 233,472); 450 items, min* in 2
# rounds of 225: 256 threads. The register-row block has the same bytes
# (int16 posteriors, int8 messages) and Z threads.
ONE_LANE_SHAPES = {
    ("nr384-r13", "flooding", 0): (512, 170896, 1),
    ("nr384-r13", "flooding", 22): (384, 170896, 1),
    ("nr384-r13", "layered", 22): (384, 170896, 1),
    ("nr320-r13", "flooding", 0): (480, 142416, 1),
    ("nr320-r13", "flooding", 22): (384, 142416, 1),
    ("nr320-r13", "layered", 22): (320, 142416, 1),
    ("dvb16200-r89", "flooding", 28): (256, 81376, 2),
    ("dvb16200-r89", "layered", 28): (360, 81376, 2),
}


@pytest.mark.parametrize("key,schedule,star", sorted(ONE_LANE_SHAPES))
def test_one_lane_shape_against_hand_computed_bytes(key, schedule, star):
    ct = _key_ct(key)
    want = ONE_LANE_SHAPES[key, schedule, star]
    assert minsum.one_lane_shape(ct, schedule, star) == want
    for et in (False, True):
        assert minsum.is_one_lane(ct, schedule, star, et)
        assert not minsum.is_packed(ct, schedule, star, et)
        assert minsum.pick_lanes(ct, schedule, star, et) == 1
        assert minsum.onchip_smem_bytes(ct, schedule, star, 1, et) == want[1]
    with pytest.raises(ValueError, match="1 lane a block"):
        minsum.onchip_smem_bytes(ct, schedule, star, 2, False)
    bound = (minsum.TWO_LANE_THREADS if schedule == "layered"
             else minsum.QUAD_STAR_THREADS if star else minsum.QUAD_THREADS)
    assert want[0] <= bound and want[0] % 32 == 0 or schedule == "layered"


def test_one_lane_shape_refusals():
    """Z % 4 != 0 (the quad instance only), rows above 28, Z above the
    layered bound, state above a block's shared memory."""
    ct = _ct(**CODES["nr384-r13"][1])
    assert minsum.one_lane_shape(
        dataclasses.replace(ct, Z=382), "flooding")[0] == 0
    _, entries = qc_entries(array_qc(3, 30, 31))
    rows30 = dataclasses.replace(ct, entries=entries)
    for schedule in ("flooding", "layered"):
        assert minsum.one_lane_shape(rows30, schedule) == (0, 0, 0)
    assert minsum.one_lane_shape(dataclasses.replace(ct, Z=388),
                                 "layered") == (0, 0, 0)
    big = dataclasses.replace(ct, Z=768, n=2 * ct.n)   # 341,776 B
    assert minsum.one_lane_shape(big, "flooding") == (0, 0, 0)


# The wrapper's mirror of the one-lane constants, against the source's own.
@pytest.mark.parametrize("py,cu", [("QUAD_ROWS", "kQuadRows"),
                                   ("QUAD_THREADS", "kQuadThreads"),
                                   ("QUAD_STAR_THREADS", "kQuadStarThreads")])
def test_one_lane_constants_mirror_the_source(py, cu):
    src = (build.CSRC / "cn_packed.cuh").read_text()
    m = re.search(r"constexpr int " + cu + r" = (\d+);", src)
    assert m and int(m.group(1)) == getattr(minsum, py)


def test_one_lane_row_degrees_mirror_the_source():
    src = (build.CSRC / "cn_packed.cuh").read_text()
    m = re.search(r"constexpr int kOneLaneRowDegrees\[2\] = \{(\d+), (\d+)\};",
                  src)
    assert m and tuple(map(int, m.groups())) == minsum.ONE_LANE_ROW_DEGREES


@pytest.mark.parametrize("lib,kernel,bound", [
    ("minsum_flood", "flood_quad_kernel",
     r"STAR \? kQuadStarThreads : kQuadThreads, 1"),
    ("minsum_layered", "layered_row_kernel", r"kTwoLaneThreads, 1")])
def test_one_lane_kernels_are_declared_in_units_of_their_own(lib, kernel,
                                                               bound):
    """Each library declares its one-lane kernel under its launch bound,
    names its instances in units of their own only (through getters: the
    flooding library's fourth unit, the layered library's fourth and, for
    early termination, fifth), and reads `template_only` in its C entries
    (unit 1)."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    assert re.search(r"__launch_bounds__\(" + bound + r"\)\s+" + kernel
                     + r"\(", src)
    units = 4 if "quad" in kernel else 5
    assert build.UNITS[lib] == units
    getter = "quad_instance<" if "quad" in kernel else "row_instance_of<"
    named = 0
    for u in range(4, units + 1):
        start = src.index(f"#if !defined(LDPC_UNIT) || LDPC_UNIT == {u}")
        named += src[start:src.index("#endif", start)].count(getter)
    assert named == src.count(getter) == 2 * (units - 3)
    one = src.index("#if !defined(LDPC_UNIT) || LDPC_UNIT == 1")
    assert "template_only" in src[one:]


# ---------------------------------------------------------------------------
# Routes and instances.

def _with(cfg, **dec):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, **dec))


@pytest.mark.parametrize("key,schedule,algorithm,et,route,one_lane", [
    # NR BG1 Z=384 rate 1/3: no block of two lanes; flooding every form
    ("nr384-r13", "flooding", "offset-min-sum", True, "onchip", True),
    ("nr384-r13", "flooding", "offset-min-sum", False, "onchip", True),
    ("nr384-r13", "flooding", "normalized-min-sum", False, "onchip", True),
    ("nr384-r13", "flooding", "min-sum", True, "onchip", True),
    ("nr384-r13", "flooding", "min-star", False, "onchip", True),
    ("nr384-r13", "flooding", "min-star", True, "onchip", True),
    # layered min*; the min-sum family streams (stream_first)
    ("nr384-r13", "layered", "min-star", False, "onchip", True),
    ("nr384-r13", "layered", "min-star", True, "onchip", True),
    ("nr384-r13", "layered", "offset-min-sum", True, "stream", False),
    ("nr320-r13", "flooding", "offset-min-sum", True, "onchip", True),
    ("nr320-r13", "layered", "min-star", True, "onchip", True),
    # DVB-S2 rate 8/9: min* on rows of 27-28 on both schedules; its
    # min-sum family stays two-lane (flooding) or streams (layered)
    ("dvb16200-r89", "flooding", "min-star", False, "onchip", True),
    ("dvb16200-r89", "flooding", "min-star", True, "onchip", True),
    ("dvb16200-r89", "layered", "min-star", False, "onchip", True),
    ("dvb16200-r89", "layered", "min-star", True, "onchip", True),
    ("dvb16200-r89", "flooding", "offset-min-sum", True, "onchip", False),
    ("dvb16200-r89", "layered", "offset-min-sum", True, "stream", False),
])
def test_routes_take_the_one_lane_instance(key, schedule, algorithm, et,
                                           route, one_lane):
    cfg = _with(_key_cfg(key), schedule=schedule, algorithm=algorithm,
                early_term=et)
    ct = from_reference(build_code(cfg), "cpu")
    assert resolve_route(ct, cfg) == route
    dec, label = select_decoder(ct, cfg, batch=1024)
    if route == "onchip":
        inner = dec.inner
        assert label.endswith("-bf")
        assert inner.one_lane == one_lane and inner.packed != one_lane
        assert inner.lanes_per_thread == (1 if one_lane else 2)
        if one_lane:
            assert inner.quad == (schedule == "flooding")
            want = (minsum.quad_tables(ct) if inner.quad
                    else minsum.packed_tables(ct))
            np.testing.assert_array_equal(inner._ptab, want)
            assert inner._launch_tables == (inner._ptab.ctypes.data,
                                            len(want))
            assert inner.param_words() == len(want) <= minsum.TAB_WORDS


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_array_code_keeps_the_template(schedule):
    """The (3,30) array code (Z = 31, rows of 30): no one-lane instance
    (rows above 28, and Z % 4 != 0), so min* keeps the one-lane template,
    which takes no parameter tables beyond the row pointers it reads."""
    _, entries = qc_entries(array_qc(3, 30, 31))
    ct = dataclasses.replace(_ct(**CODES["nr384-r13"][1]), entries=entries,
                             Z=31, nb=30, mb=3, n=930)
    for et in (False, True):
        assert not minsum.is_one_lane(ct, schedule, 30, et)
        assert not minsum.is_packed(ct, schedule, 30, et)
    d = minsum.make_decoder(ct, DecoderConfig(algorithm="min-star",
                                              schedule=schedule),
                            QuantConfig(beta_lsb=0))
    assert not d.packed and not d.one_lane and not d.template
    assert d._launch_tables[1] == len(minsum.packed_tables(ct))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_template_is_forced_on_request(schedule):
    """make_decoder(..., template=True) takes the one-lane template on a
    code a one-lane (or packed) instance takes: no tables in its launch,
    and the megakernel refused."""
    for key in ("nr384-r13", "dvb16200-r89"):
        ct = _key_ct(key)
        dc = DecoderConfig(algorithm="min-star", schedule=schedule)
        d = minsum.make_decoder(ct, dc, QuantConfig(beta_lsb=0),
                                template=True)
        assert d.template and not d.packed and not d.one_lane
        assert d._launch_tables == (None, 0)
        assert not d.quad
    with pytest.raises(ValueError, match="template"):
        minsum.make_decoder(ct, dc, QuantConfig(), input_scale=4.0,
                            count_info_cols=ct.kb, mc_batch=8,
                            template=True)


def test_one_lane_launches_are_counted_apart():
    minsum.one_lane_launches["minsum_flood"] = 5
    minsum.reset_counters()
    assert minsum.one_lane_launches == dict.fromkeys(minsum.SOURCES, 0)


# ---------------------------------------------------------------------------
# The plain decoders the card holds the one-lane instances to: NR BG1
# Z=384 rate 1/3 (n = 26,112), two lanes (lane 0 noiseless), against golden
# (about 1 s a noisy codeword and iteration; its min* about 20 s, so the
# min* cases are `slow`) and, for the min-sum family, the JAX package's
# plain edge-gather decoder (`ops/decode_ref`, 1-2 s; it has no min*).

@pytest.fixture(scope="module")
def nr384_r13():
    cfg = rcfg.PRESETS["nr-bg1-layered"]
    code = ref_build_code(dataclasses.replace(
        cfg, code=dataclasses.replace(cfg.code, rate="1/3")))
    rng = np.random.default_rng(21)
    y = 1.0 + 0.85 * rng.standard_normal((2, code.n))
    y[0] = 1.0
    chan = np.clip(np.round(2 * y / 0.85 ** 2 * 4), -127, 127).astype(np.int8)
    return code, from_reference(code, "cpu"), chan


@pytest.mark.parametrize("schedule,algorithm,early_term,max_iter", [
    ("flooding", "offset-min-sum", True, 4),
    ("flooding", "min-sum", False, 3),
    ("layered", "offset-min-sum", True, 4),
    pytest.param("flooding", "min-star", True, 2, marks=pytest.mark.slow),
    pytest.param("layered", "min-star", False, 2, marks=pytest.mark.slow)])
def test_plain_decoders_on_nr_bg1_z384_r13(nr384_r13, schedule, algorithm,
                                           early_term, max_iter):
    code, ct, chan = nr384_r13
    B = 2
    quant = QuantConfig(beta_lsb=2 if algorithm == "offset-min-sum" else 0)
    dec = DecoderConfig(algorithm=algorithm, schedule=schedule,
                        max_iter=max_iter, early_term=early_term)
    d = minsum.make_decoder(ct, dec, quant)
    assert d.one_lane
    hard, iters, conv = d.plain(torch.as_tensor(np.ascontiguousarray(
        chan.T)).reshape(ct.nb, ct.Z, B))
    got = (hard.reshape(code.n, B).T.numpy(), iters.numpy(), conv.numpy())
    star = d.minstar
    if star is None:
        ref = ref_make_decoder(
            code, rcfg.DecoderConfig(algorithm=algorithm, schedule=schedule,
                                     max_iter=max_iter,
                                     early_term=early_term),
            rcfg.QuantConfig(beta_lsb=quant.beta_lsb))
        for g, w in zip(got, ref(jnp.asarray(chan))):
            np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))
    beta = quant.beta_lsb if algorithm == "offset-min-sum" else 0
    rs = [decode_fixed(row.astype(np.int32), code, max_iter=max_iter,
                       beta=beta, schedule=schedule, early_term=early_term,
                       minstar=star) for row in chan]
    for g, gd in zip(got, (np.stack([r.hard for r in rs]),
                           np.array([r.iters for r in rs]),
                           np.array([r.converged for r in rs]))):
        np.testing.assert_array_equal(g, gd.astype(g.dtype))
    if early_term:
        assert got[1][0] == 0 and got[1][1] > 0
