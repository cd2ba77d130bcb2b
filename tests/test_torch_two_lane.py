"""The two-lane packed decoder instances (`flood_two_lane_kernel`,
`layered_two_lane_kernel`; csrc/minsum_flood.cu, csrc/minsum_layered.cu)
on the CPU: their shape rule (`minsum.packed_shape` / `pick_lanes`) against
hand-computed bytes, threads and blocks for each code they take, the
wrapper's constants against the sources', the three-unit build, the routes
and labels of `sim/pipeline.py` on those codes (`stream_first` keeps the
streaming main paths), and the plain decoders the card holds the kernels
to against the JAX package's Pallas kernel in interpret mode and
`golden.decoder.decode_fixed` on an NR BG1 code at a small Z and a short
DVB-S2-like code. The kernels themselves run on the card only
(`chip_smoke.py`, slice 12)."""
import dataclasses
import os
import re
import stat
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.config as rcfg
from ldpc_tpu.sim.sweep import build_code as ref_build_code
from ldpc_tpu.codes.toy import toy_qc_odd
from ldpc_tpu.golden.decoder import decode_fixed
from ldpc_tpu.kernels.minsum_pallas import make_pallas_decoder
from ldpc_tpu_torch import PRESETS
from ldpc_tpu_torch.codes import build_code, from_reference
from ldpc_tpu_torch.config import DecoderConfig, QuantConfig, \
    minstar_thresholds
from ldpc_tpu_torch.kernels import build, minsum
from ldpc_tpu_torch.sim.pipeline import (resolve_route, select_decoder,
                                         stream_first)

torch.set_num_threads(2)


def _cfg(name="nr-bg1-layered", **code):
    cfg = PRESETS[name]
    return dataclasses.replace(cfg, code=dataclasses.replace(cfg.code,
                                                             **code))


def _ct(name="nr-bg1-layered", **code):
    return from_reference(build_code(_cfg(name, **code)), "cpu")


# The codes of the two-lane instances and the one whose min* takes the
# one-lane instance:
# (name, preset, code fields).
CODES = {
    "nr384": ("nr-bg1-layered", {}),
    "nr256": ("nr-bg1-layered", dict(Z=256)),
    "nr128-r13": ("nr-bg1-layered", dict(Z=128, rate="1/3")),
    "dvb16200": ("dvbs2-64800-r12", dict(n=16200)),
    "dvb16200-r89": ("dvbs2-64800-r12", dict(n=16200, rate="8/9")),
}

# Hand-computed: a two-lane block is one column of Z threads holding two
# lanes; its state is 2 x 8 B of counters, 2 x 2n B of int16 totals (or
# posteriors) and 2 x E Z B of int8 messages, each part rounded up to 16 B
# (the two-lane flooding instances keep the channel in device memory, so
# flooding's state is layered's); an SM gives 233,472 B less 1,024 B a
# block. NR BG1 rate 1/2 (nb = 46, E = 206): Z=384 16 + 70,656 + 158,208 =
# 228,880 B (of the 232,448 a block may take), one block an SM; Z=256 16 +
# 47,104 + 105,472 = 152,592 B, one. NR BG1 Z=128 rate 1/3 (nb = 68, E =
# 309): 16 + 34,816 + 79,104 = 113,936 B, two blocks an SM (four codewords;
# the block of four lanes, 227,872 B, also holds four, so the fewer lanes
# win); its layered state takes four lanes a thread (32 + 69,632 + 158,208
# = 227,872 B: no channel), so layered is no two-lane instance. DVB-S2
# n=16,200 (Z = 360): rate 1/2 (E = 151) 16 + 64,800 + 108,720 = 173,536 B,
# rate 8/9 (E = 136) 16 + 64,800 + 97,920 = 162,736 B. Four lanes a thread
# fit none of them: NR BG1 Z=128 rate 1/3's flooding block of four is 32 +
# 69,632 + 34,816 (the channel) + 158,208 = 262,688 B.
TWO_LANE_SHAPES = {
    ("nr384", "flooding"): (2, 2, 228880, 1),
    ("nr384", "layered"): (2, 2, 228880, 1),
    ("nr256", "flooding"): (2, 2, 152592, 1),
    ("nr256", "layered"): (2, 2, 152592, 1),
    ("nr128-r13", "flooding"): (2, 2, 113936, 2),
    ("nr128-r13", "layered"): (4, 4, 227872, 1),
    ("dvb16200", "flooding"): (2, 2, 173536, 1),
    ("dvb16200", "layered"): (2, 2, 173536, 1),
    ("dvb16200-r89", "flooding"): (2, 2, 162736, 1),
    ("dvb16200-r89", "layered"): (2, 2, 162736, 1),
}


@pytest.mark.parametrize("key,schedule", sorted(TWO_LANE_SHAPES))
def test_shape_rule_against_hand_computed_bytes(key, schedule):
    preset, code = CODES[key]
    ct = _ct(preset, **code)
    want = TWO_LANE_SHAPES[key, schedule]
    lanes, lpt, smem, _ = want
    for star, et in ((0, False), (0, True), (7, False), (7, True)):
        assert minsum.packed_shape(ct, schedule, star, et) == want
        assert minsum.is_packed(ct, schedule, star, et)
        assert minsum.pick_lanes(ct, schedule, star, et) == lanes
        assert minsum.onchip_smem_bytes(ct, schedule, star, lanes,
                                        et) == smem
    assert lanes // lpt * ct.Z <= minsum.TWO_LANE_THREADS
    assert smem <= minsum.MAX_SMEM
    d = minsum.make_decoder(ct, DecoderConfig(schedule=schedule),
                            QuantConfig())
    assert (d.packed_lanes, d.lanes_per_thread) == (lanes, lpt)
    assert d._launch_tables == (d._ptab.ctypes.data, len(d._ptab))
    assert d.param_words() <= minsum.TAB_WORDS
    if lpt == minsum.TWO_LANES:
        # no block of four lanes a thread fits: four lanes' state
        four = minsum.packed_smem_bytes(ct, 4, schedule, 4)
        assert four > minsum.MAX_SMEM


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_minstar_above_24_keeps_the_one_lane_template(schedule):
    """DVB-S2 n=16,200 rate 8/9 (rows of 27-28): min* is no two-lane
    instance (its rows exceed the two-lane register rows) and takes one lane
    a block, now in the one-lane instance (`minsum.is_one_lane`: the tables
    in the parameters, the 28-entry register row) and no longer the
    one-lane template, which the forced decoder keeps; its min-sum family
    takes the two-lane instance. The name predates the one-lane
    instances."""
    ct = _ct("dvbs2-64800-r12", n=16200, rate="8/9")
    star = minsum.star_degree(ct, DecoderConfig(algorithm="min-star"))
    assert star == 28
    for et in (False, True):
        assert not minsum.is_packed(ct, schedule, star, et)
        assert minsum.is_one_lane(ct, schedule, star, et)
        assert minsum.pick_lanes(ct, schedule, star, et) == 1
    dec = DecoderConfig(algorithm="min-star", schedule=schedule)
    d = minsum.make_decoder(ct, dec, QuantConfig(beta_lsb=0))
    assert not d.packed and d.one_lane and d.lanes_per_thread == 1
    assert d._launch_tables == (d._ptab.ctypes.data, len(d._ptab))
    t = minsum.make_decoder(ct, dec, QuantConfig(beta_lsb=0), template=True)
    assert not t.packed and not t.one_lane and t.lanes_per_thread == 1
    assert t._launch_tables == (None, 0)
    assert minsum.is_packed(ct, schedule, 0, True)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_code_without_a_two_lane_block_takes_the_one_lane_instance(
        schedule):
    """NR BG1 Z=384 rate 1/3 (n = 26,112, 309 circulants): 170,880 B a lane
    (2n of totals, E Z of messages), so two lanes exceed a block's shared
    memory; the one-lane instance (flood_quad_kernel, layered_row_kernel)
    decodes it, one lane a block, in 170,896 B."""
    ct = _ct(Z=384, rate="1/3")
    assert (ct.n, ct.n_entries) == (26112, 309)
    assert minsum.packed_smem_bytes(ct, 2, schedule, 2) > minsum.MAX_SMEM
    assert minsum.packed_shape(ct, schedule) == (0, 0, 0, 0)
    assert not minsum.is_packed(ct, schedule, 0, True)
    assert minsum.is_one_lane(ct, schedule, 0, True)
    assert minsum.one_lane_shape(ct, schedule)[1] == 170896
    assert minsum.pick_lanes(ct, schedule) == 1


# The wrapper's mirror of the two-lane constants, against the source's own.
@pytest.mark.parametrize("py,cu", [("TWO_LANES", "kTwoLanes"),
                                   ("TWO_LANE_THREADS", "kTwoLaneThreads"),
                                   ("LANES_PER_THREAD", "kLanesPerThread")])
def test_two_lane_constants_mirror_the_source(py, cu):
    src = (build.CSRC / "cn_packed.cuh").read_text()
    m = re.search(r"constexpr int " + cu + r" = (\d+);", src)
    assert m and int(m.group(1)) == getattr(minsum, py)


@pytest.mark.parametrize("lib,kernel", [("minsum_flood",
                                         "flood_two_lane_kernel"),
                                        ("minsum_layered",
                                         "layered_two_lane_kernel")])
def test_two_lane_kernels_are_declared_under_their_bound(lib, kernel):
    """Each library declares its two-lane kernel under kTwoLaneThreads and
    at least one block an SM, without the megakernel (two instances a row
    degree and update, fixed and early-terminating; `two_lane_instance`
    gives null for the megakernel, which `prepare` refuses), names its
    instances in its second unit only, and the four-lane rule comes first
    in its shape function."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    assert re.search(r"__launch_bounds__\(kTwoLaneThreads, 1\)\s+"
                     + kernel + r"\(", src)
    assert build.UNITS[lib] == (5 if lib == "minsum_layered" else 4)
    # the two-lane instances are named in two_lane_instance, which unit 2
    # alone calls; unit 1 takes them through the getter
    two = src.index("#if !defined(LDPC_UNIT) || LDPC_UNIT == 2")
    one = src.index("#if !defined(LDPC_UNIT) || LDPC_UNIT == 1", two)
    assert re.search(r"template <int DMAX, bool STAR, bool ET>\s+"
                     r"__global__", src)
    assert len(re.findall(kernel + r"<DMAX, STAR, (?:true|false)>",
                          src)) == 2
    assert re.search(r"two_lane_instance\(bool et, bool mc\) \{\s+"
                     r"if \(mc\) return nullptr;", src)
    assert src.index(kernel + "<") < src.index("two_lane_instance(") < two
    assert "two_lane_instance<" in src[two:one]
    assert "two_lane_instance<" not in src[one:]
    assert re.search(r"packed_shape\(\s*Z, kTwoLaneThreads,.{0,120}?"
                     r"kTwoLanes\);", src, re.S)
    head = (build.CSRC / "cn_packed.cuh").read_text()
    assert re.search(r"cudaError_t prepare\(K kern, int smem\) \{\s+"
                     r"if \(!kern\) return cudaErrorNotSupported;", head)


def test_library_units_build_at_once_and_link(tmp_path, monkeypatch):
    """A library of four units: nvcc compiles the source once a unit with
    -c -DLDPC_UNIT=u, all at once, then links the objects into the library;
    the objects are removed, ptxas' reports of every step kept."""
    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "a = sys.argv[1:]\n"
        f"open({str(log)!r}, 'a').write(' '.join(a) + '\\n')\n"
        "open(a[a.index('-o') + 1], 'w').write('x')\n"
        "print('ptxas info    : Used 1 registers ' + a[-1][-12:])\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    out = tmp_path / "lib" / "libminsum_flood.so"
    report = build.compile_library("minsum_flood", out)
    calls = log.read_text().splitlines()
    assert len(calls) == 5
    # the units run at once, in any order; the link comes last
    calls[:4] = sorted(calls[:4], key=lambda c: c.split("LDPC_UNIT=")[1])
    for u, call in zip((1, 2, 3, 4), calls):
        assert f"-c -DLDPC_UNIT={u} -o" in call and "-shared" not in call
        assert call.endswith("minsum_flood.cu")
    objs = [c.split(" -o ")[1].split()[0] for c in calls[:4]]
    assert calls[4].endswith(" ".join(objs)) and "-shared" in calls[4]
    assert out.read_text() == "x"
    assert out.with_suffix(".log").read_text() == report
    assert report.count("ptxas info") == 5
    assert sorted(os.listdir(out.parent)) == ["libminsum_flood.log",
                                              "libminsum_flood.so"]
    # one unit: one call with -shared, the source straight to the library
    log.unlink()
    build.compile_library("microbench", tmp_path / "lib" / "libmb.so")
    (call,) = log.read_text().splitlines()
    assert "-shared" in call and "LDPC_UNIT" not in call
    # the units are part of the build's hash
    before = build.library_path("minsum_flood")
    monkeypatch.setitem(build.UNITS, "minsum_flood", 1)
    assert build.library_path("minsum_flood") != before


def test_a_failed_unit_fails_the_build(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "sys.exit(3 if '-DLDPC_UNIT=2' in sys.argv else 0)\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    out = tmp_path / "lib" / "libminsum_layered.so"
    with pytest.raises(RuntimeError, match=r"nvcc failed \(3\)"):
        build.compile_library("minsum_layered", out)
    assert not out.exists() and os.listdir(out.parent) == []


def _with(cfg, **dec):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, **dec))


@pytest.mark.parametrize("key,schedule,algorithm,route,label,lpt", [
    # the streaming main paths keep their kernels (stream_first)
    ("nr384", "layered", "offset-min-sum", "stream",
     "torch-plain-stream-resident-et", None),
    ("dvb16200", "layered", "offset-min-sum", "stream",
     "torch-plain-stream-pipelined-et", None),
    ("dvb16200-r89", "layered", "offset-min-sum", "stream",
     "torch-plain-stream-pipelined-et", None),
    # flooding and min* have no streaming form: the two-lane instance
    ("nr384", "flooding", "offset-min-sum", "onchip", "torch-plain-bf", 2),
    ("nr384", "layered", "min-star", "onchip",
     "torch-plain-minstar-layered-bf", 2),
    ("nr256", "flooding", "min-star", "onchip", "torch-plain-minstar-bf", 2),
    ("dvb16200", "flooding", "min-sum", "onchip", "torch-plain-bf", 2),
    ("dvb16200", "layered", "min-star", "onchip",
     "torch-plain-minstar-layered-bf", 2),
    ("dvb16200-r89", "flooding", "offset-min-sum", "onchip",
     "torch-plain-bf", 2),
    # min* on rows of 27-28: the one-lane instance
    ("dvb16200-r89", "layered", "min-star", "onchip",
     "torch-plain-minstar-layered-bf", 1),
    # a block of four lanes: NR BG1 Z=128 rate 1/3 layered, and the
    # canonical code
    ("nr128-r13", "layered", "offset-min-sum", "onchip",
     "torch-plain-layered-bf", 4),
    ("nr128-r13", "flooding", "offset-min-sum", "onchip", "torch-plain-bf",
     2),
])
def test_routes_and_labels(key, schedule, algorithm, route, label, lpt):
    preset, code = CODES[key]
    cfg = _with(_cfg(preset, **code), schedule=schedule, algorithm=algorithm,
                early_term=True)
    ct = from_reference(build_code(cfg), "cpu")
    assert resolve_route(ct, cfg) == route
    assert stream_first(ct, cfg) == (route == "stream")
    dec, got = select_decoder(ct, cfg, batch=256)
    assert got == label
    if lpt is not None:
        assert dec.inner.lanes_per_thread == lpt
        assert dec.inner.packed == (lpt > 1)
    # a forced "pallas" takes the on-chip kernel: the two-lane instance on
    # the streaming paths' codes
    forced, flabel = select_decoder(ct, cfg, batch=256, backend="pallas")
    assert flabel.endswith("-bf")
    assert forced.inner.lanes_per_thread == (lpt or 2)


def test_canonical_paths_keep_four_lanes():
    for name in ("wifi-648-r12-minsum", "wifi-full-oms"):
        cfg = PRESETS[name]
        ct = from_reference(build_code(cfg), "cpu")
        assert resolve_route(ct, cfg) == "onchip"
        for schedule in ("flooding", "layered"):
            assert minsum.packed_shape(ct, schedule)[1] == 4


@pytest.mark.parametrize("name,batch,et,variant", [
    ("nr384", 256, False, "stream-resident"),
    ("nr384", 1024, True, "stream-resident-et"),
    ("dvb16200", 1024, True, "stream-resident-et"),
    ("dvb16200", 256, True, "stream-pipelined-et"),
])
def test_stream_first_keeps_the_streaming_main_paths(name, batch, et,
                                                     variant):
    """`nr-bg1-z384-stream` (B = 256), `dvbs2-16200-r12-resident-et` (B =
    1,024) and their other batch: `auto` streams them as before the two-lane
    instances, whose block the layered rule now finds."""
    preset, code = CODES[name]
    cfg = _with(_cfg(preset, **code), early_term=et)
    ct = from_reference(build_code(cfg), "cpu")
    assert minsum.packed_shape(ct, "layered")[1] == minsum.TWO_LANES
    assert stream_first(ct, cfg)
    dec, label = select_decoder(ct, cfg, batch=batch)
    assert label == "torch-plain-" + variant and dec.variant == variant


# The plain decoders the card holds the two-lane instances to, against the
# reference: NR BG1 rate 1/2 at Z = 32 (rows of 21-22, the 24-entry row)
# and the short DVB-S2 stand-in toy_qc_odd (five base rows of three),
# flooding min-sum and offset min-sum and min* in both schedules, fixed and
# with early termination, on int8 LLRs from a seed.
def _ref_code(name):
    if name == "nr-bg1-z32":
        cfg = rcfg.PRESETS["nr-bg1-layered"]
        return ref_build_code(dataclasses.replace(
            cfg, code=dataclasses.replace(cfg.code, Z=32)))
    return toy_qc_odd(16)


# The Pallas kernel in interpret mode compiles for 1-2.5 minutes on NR BG1
# (206 circulants) on the CPU and for about 12 s on the stand-in, and
# golden's min* takes seconds a codeword on NR BG1, so: three lanes (lane 0
# noiseless) at five iterations, golden every case, the Pallas kernel on
# the stand-in.
@pytest.mark.parametrize("code_name,schedule,algorithm,early_term,pallas", [
    ("nr-bg1-z32", "flooding", "offset-min-sum", True, False),
    ("nr-bg1-z32", "flooding", "min-sum", False, False),
    ("nr-bg1-z32", "flooding", "min-star", True, False),
    ("nr-bg1-z32", "layered", "min-star", True, False),
    ("dvbs2-like-z16", "flooding", "min-star", True, True),
    ("dvbs2-like-z16", "flooding", "min-sum", False, True),
    ("dvbs2-like-z16", "layered", "min-star", False, False)])
def test_plain_decoders_equal_pallas_interpret_and_golden(
        code_name, schedule, algorithm, early_term, pallas):
    code = _ref_code(code_name)
    ct = from_reference(code, "cpu")
    B, max_iter = 3, 5
    quant = QuantConfig(beta_lsb=2 if algorithm == "offset-min-sum" else 0)
    rng = np.random.default_rng(20)
    y = 1.0 + 0.75 * rng.standard_normal((B, code.n))
    y[0] = 1.0
    chan = np.clip(np.round(2 * y / 0.75 ** 2 * quant.scale), -127,
                   127).astype(np.int8)
    star = (tuple(int(t) for t in minstar_thresholds(quant))
            if algorithm == "min-star" else None)
    beta = quant.beta_lsb if algorithm == "offset-min-sum" else 0
    d = minsum.make_decoder(ct, DecoderConfig(
        algorithm=algorithm, schedule=schedule, max_iter=max_iter,
        early_term=early_term), quant)
    hard, iters, conv = d.plain(torch.as_tensor(np.ascontiguousarray(
        chan.T)).reshape(ct.nb, ct.Z, B))
    got = (hard.reshape(code.n, B).T.numpy(), iters.numpy(), conv.numpy())
    rs = [decode_fixed(row.astype(np.int32), code, max_iter=max_iter,
                       beta=beta, schedule=schedule, early_term=early_term,
                       minstar=star) for row in chan]
    golden = (np.stack([r.hard for r in rs]), np.array([r.iters for r in rs]),
              np.array([r.converged for r in rs]))
    for g, gd in zip(got, golden):
        np.testing.assert_array_equal(g, gd.astype(g.dtype))
    if pallas:
        kernel = make_pallas_decoder(
            code, max_iter=max_iter, beta=beta, schedule=schedule,
            early_term=early_term, batch_tile=B, interpret=True,
            minstar=star)
        for g, w in zip(got, kernel(jnp.asarray(chan))):
            np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))
    # lanes finish apart, and lane 0 (noiseless) at once
    if early_term:
        assert got[1][0] == 0 and len(set(got[1].tolist())) > 1
