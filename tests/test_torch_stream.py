"""The port's streaming decoder (ldpc_tpu_torch.kernels.minsum_stream) on
the CPU, where the wrapper runs its plain version (ops/decode_qc), against
the Pallas streaming kernel (ldpc_tpu.kernels.minsum_stream) in interpret
mode in each of its five variants (dynamic, static, resident, resident-et,
stream-et), as tests/test_decode_qc.py runs them. Equal int8 inputs from a
numpy seed; tolerance 0 on hard bits, iteration counts and convergence
flags. Then the host refusals and the H100's admission rule
(`sim/pipeline.select_decoder`) on CPU code tensors, which builds nothing.

The CUDA library itself runs only on a GPU: chip_smoke.py holds its four
instances to this plain version there."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.nr_bg import make_code as make_nr
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.kernels import minsum_stream as jstream
from ldpc_tpu_torch import PRESETS, DecoderConfig, QuantConfig
from ldpc_tpu_torch.codes import build_code, from_reference
from ldpc_tpu_torch.kernels import minsum, minsum_stream as tstream
from ldpc_tpu_torch.sim.pipeline import (resolve_route, select_decoder,
                                         stream_first, use_transposed)

torch.set_num_threads(2)

CODES = {
    "toy": (lambda: toy_qc(8), 128),
    "nr-bg2-z16": (lambda: make_nr(base_graph=2, Z=16), 256),
    "wifi648": (lambda: make_code(648, "1/2"), 128),
}
# Pallas variant -> (its make_stream_decoder arguments, the port's
# (resident, early_term), the port's instance)
VARIANTS = {
    "dynamic": (dict(static_unroll=False), (False, False), "stream"),
    "static": (dict(resident=False), (False, False), "stream"),
    "resident": (dict(resident=True), (True, False), "stream-resident"),
    "resident-et": (dict(early_term=True), (True, True),
                    "stream-resident-et"),
    "stream-et": (dict(early_term=True, resident=False), (False, True),
                  "stream-et"),
}
SLOW = pytest.mark.slow     # interpret mode beyond ~10 s


@functools.lru_cache(maxsize=None)
def _code(name):
    return CODES[name][0]()


def _llrs(rng, B, n, et):
    """Early termination: the noisy all-zeros word, lanes converging at
    varied iterations (lane 0 clean); else half easy, half noisy lanes."""
    if et:
        x = rng.normal(18, 16, size=(B, n))
        x[0] = 60
    else:
        x = rng.normal(0, 40, size=(B, n))
        x[: B // 2] = rng.normal(30, 25, size=(B // 2, n))
    return np.clip(np.round(x), -127, 127).astype(np.int8)


@pytest.mark.parametrize("code_name,variant", [
    ("toy", "dynamic"), ("toy", "static"), ("toy", "resident"),
    ("toy", "resident-et"), ("toy", "stream-et"),
    pytest.param("nr-bg2-z16", "dynamic", marks=SLOW),
    pytest.param("nr-bg2-z16", "static", marks=SLOW),
    pytest.param("nr-bg2-z16", "resident", marks=SLOW),
    pytest.param("nr-bg2-z16", "resident-et", marks=SLOW),
    pytest.param("nr-bg2-z16", "stream-et", marks=SLOW),
    pytest.param("wifi648", "static", marks=SLOW),
    pytest.param("wifi648", "resident", marks=SLOW),
    pytest.param("wifi648", "resident-et", marks=SLOW),
    pytest.param("wifi648", "stream-et", marks=SLOW),
])
def test_stream_decoder_equals_pallas_interpret(code_name, variant):
    code = _code(code_name)
    B = CODES[code_name][1]
    kw, (resident, et), instance = VARIANTS[variant]
    chan = _llrs(np.random.default_rng(11), B, code.n, et)
    ref = jstream.make_stream_decoder(code, max_iter=6, beta=2, qmax=127,
                                      batch_tile=128, interpret=True, **kw)
    assert ref.variant == variant
    want = [np.asarray(x) for x in ref(jnp.asarray(chan))]
    dec = tstream.make_stream_decoder(
        from_reference(code, "cpu"), max_iter=6, beta=2, qmax=127,
        resident=resident, early_term=et)
    assert dec.variant == instance
    before = tstream.plain_calls, tstream.kernel_launches
    hard, iters, conv = dec(torch.as_tensor(chan))
    assert (tstream.plain_calls, tstream.kernel_launches) == (
        before[0] + 1, before[1])
    np.testing.assert_array_equal(hard.numpy(), want[0])
    np.testing.assert_array_equal(iters.numpy(), want[1])
    np.testing.assert_array_equal(conv.numpy(), want[2].astype(bool))
    if et:
        assert int(iters[0]) == 0 and len(np.unique(want[1])) >= 3
    else:
        assert (iters == 6).all() and 0 < int(conv.sum()) < B


def test_wifi648_has_no_dynamic_variant_in_the_reference():
    """Why the matrix above has no ("wifi648", "dynamic"): the Pallas
    kernel with run-time layer tables refuses Z=27 (not a multiple of 8).
    The port's `stream` instance, which answers it, has no such limit."""
    code = _code("wifi648")
    with pytest.raises(ValueError, match="sublane-aligned"):
        jstream.make_stream_decoder(code, max_iter=6, beta=2, qmax=127,
                                    batch_tile=128, interpret=True,
                                    static_unroll=False)
    dec = tstream.make_stream_decoder(from_reference(code, "cpu"),
                                      max_iter=6, beta=2, resident=False)
    assert dec.variant == "stream"


def test_normalized_and_plain_min_sum_equal_the_jax_qc_decoder():
    """alpha and beta=0 reach the plain version as the reference's
    `make_decoder` passes them (cn_params)."""
    import ldpc_tpu.config as rcfg
    from ldpc_tpu.ops import decode_qc as jqc
    code = _code("toy")
    ct = from_reference(code, "cpu")
    chan = _llrs(np.random.default_rng(5), 32, code.n, True)
    for algorithm in ("min-sum", "normalized-min-sum", "offset-min-sum"):
        dec = dict(algorithm=algorithm, schedule="layered", max_iter=5,
                   early_term=True)
        quant = dict(beta_lsb=1, alpha_num=3, alpha_shift=2)
        got = tstream.make_decoder(ct, DecoderConfig(**dec),
                                   QuantConfig(**quant))(
            torch.as_tensor(chan))
        want = jqc.make_decoder(code, rcfg.DecoderConfig(**dec),
                                rcfg.QuantConfig(**quant))(chan)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_host_refusals():
    ct = from_reference(_code("toy"), "cpu")
    # a base row of degree 1 (as tests/test_decode_qc.py's deg1_toy)
    rows = [ct.entries[0][:1]] + list(ct.entries[1:])
    eid = iter(range(ct.n_entries))
    short = dataclasses.replace(ct, entries=tuple(
        tuple((c, s, next(eid)) for c, s, _ in row) for row in rows))
    with pytest.raises(ValueError, match="degree-1"):
        tstream.make_stream_decoder(short, max_iter=4)
    # posteriors that leave int16: column degree 3 at qmax 2**14
    with pytest.raises(ValueError, match="int16"):
        tstream.make_stream_decoder(ct, max_iter=4, qmax=1 << 14)
    # not a QC code
    no_qc = dataclasses.replace(ct, code=dataclasses.replace(
        ct.code, base=None, Z=None))
    with pytest.raises(ValueError, match="QC structure"):
        tstream.make_stream_decoder(no_qc, max_iter=4)
    with pytest.raises(ValueError, match="min-sum family"):
        tstream.make_decoder(ct, DecoderConfig(algorithm="min-star",
                                               schedule="layered"),
                             QuantConfig())
    with pytest.raises(ValueError, match="layered-only"):
        tstream.make_decoder(ct, DecoderConfig(algorithm="min-sum",
                                               schedule="flooding"),
                             QuantConfig())
    dec = tstream.make_stream_decoder(ct, max_iter=4)
    with pytest.raises(TypeError, match="int8"):
        dec(torch.zeros((2, ct.n), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        dec(torch.zeros((2, ct.n + 1), dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        dec.kernel(torch.zeros((2, ct.n), dtype=torch.int8))
    # a block is one codeword: the wrapper's granularity is 1 on any device
    assert dec.batch_tile == 1 and tstream.block_fits(ct, True, True)


def _preset(name, **code):
    cfg = PRESETS[name]
    return dataclasses.replace(cfg, code=dataclasses.replace(cfg.code,
                                                             **code))


def _with(cfg, **dec):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                **dec))


@functools.lru_cache(maxsize=None)
def _ct(name, n=None):
    cfg = _preset(name, **({"n": n} if n else {}))
    return cfg, from_reference(build_code(cfg), "cpu")


def test_admission_rule_on_cpu_code_tensors():
    """Which decoder each preset gets on the H100, read from shapes alone
    (no library is built: there is no nvcc here)."""
    long_cfg, long_ct = _ct("dvbs2-64800-r12")
    # n=64,800: 129,600 B of posteriors + 227,160 B of messages a codeword
    assert minsum.pick_lanes(long_ct, "layered") == 0
    assert minsum.onchip_smem_bytes(long_ct, "layered", 0, 1) > 356760
    assert resolve_route(long_ct, long_cfg) == "stream"
    # rows of 7-8: the pipelined kernel takes the code (posteriors on chip,
    # int8 rows copied in ahead); the template's resident block would be
    # 138 KB, one block an SM
    assert tstream.smem_bytes(long_ct, True, False) > 113 * 1024
    dec, label = select_decoder(long_ct, long_cfg, batch=64)
    assert label == "torch-plain-stream-pipelined"
    assert dec.variant == "stream-pipelined"
    assert dec.resident and dec.pipelined
    dec, label = select_decoder(long_ct, _with(long_cfg, early_term=True),
                                batch=64)
    assert label == "torch-plain-stream-pipelined-et"
    assert tstream.smem_bytes(long_ct, False, True) < 113 * 1024
    # forced routes; a placement is forced through make_decoder(resident=)
    assert tstream.make_decoder(long_ct, long_cfg.decoder, long_cfg.quant,
                                resident=True).variant == "stream-resident"
    assert tstream.make_decoder(long_ct, long_cfg.decoder, long_cfg.quant,
                                resident=False).variant == "stream"
    assert tstream.make_decoder(
        long_ct, _with(long_cfg, early_term=True).decoder, long_cfg.quant,
        resident=False).variant == "stream-et"
    assert tstream.make_decoder(long_ct, long_cfg.decoder, long_cfg.quant,
                                pipelined=True).variant == "stream-pipelined"
    assert select_decoder(long_ct, long_cfg, backend="pallas")[
        1] == "torch-plain-stream-pipelined"
    assert select_decoder(long_ct, long_cfg, backend="qc-jnp")[
        1] == "torch-qc"
    assert select_decoder(long_ct, long_cfg, backend="jnp")[
        1] == "torch-ref"
    # min* and flooding have no streaming form: the plain QC decoder, as
    # the reference's qc-jnp
    for change in (dict(algorithm="min-star"), dict(schedule="flooding")):
        cfg = _with(long_cfg, **change)
        assert select_decoder(long_ct, cfg)[1] == "torch-qc"
        with pytest.raises(ValueError):
            select_decoder(long_ct, cfg, backend="stream")
        with pytest.raises(ValueError, match="no kernel"):
            select_decoder(long_ct, cfg, backend="pallas")
    # n=16,200 (86,760 B) and NR BG1 Z=384 (114,432 B) fit an SM, but no
    # block of four lanes: K3 is the two-lane instance, behind transposes
    # (the step is batch first: n > 4096). `auto` streams both
    # (stream_first): n=16,200 through the pipelined kernel (rows of 7: its
    # 8-entry row), NR BG1 through the packed resident kernel; each was
    # measured faster than that K3. "pallas" keeps K3 for both
    short_cfg, short_ct = _ct("dvbs2-64800-r12", 16200)
    nr_cfg, nr_ct = _ct("nr-bg1-layered")
    # forced through the library: rows of 7 take the pipelined kernel's
    # 8-entry row; NR BG1's rows of up to 22 would take its 24-entry row,
    # which loses to the packed resident kernel
    for cfg, ct, auto_label, forced_label in (
            (short_cfg, short_ct, "torch-plain-stream-pipelined",
             "torch-plain-stream-pipelined-et"),
            (nr_cfg, nr_ct, "torch-plain-stream-resident",
             "torch-plain-stream-resident-et")):
        assert minsum.pick_lanes(ct, "layered") == 2
        assert minsum.packed_shape(ct, "layered")[1] == minsum.TWO_LANES
        dec, label = select_decoder(ct, cfg, batch=64)
        assert label == auto_label
        assert stream_first(ct, cfg) == (auto_label != "torch-plain-"
                                         "layered-bf")
        dec, label = select_decoder(ct, cfg, batch=64, backend="pallas")
        assert label == "torch-plain-layered-bf"
        assert dec.inner.library == "minsum_layered"
        assert not use_transposed(ct, cfg, "onchip")
        forced, label = select_decoder(ct, _with(cfg, early_term=True),
                                       backend="stream")
        assert label == forced_label and forced.resident
        assert forced.pipelined == ("pipelined" in forced_label)
        assert forced.packed == ("resident" in forced_label)
    # the batch reaches the rule: n=16,200 takes the packed resident
    # kernel where it runs four lanes a thread (B = 1,024), the pipelined
    # kernel at B = 256 (two lanes); NR BG1 takes the packed kernel at both
    # batches, two lanes a thread at B = 256
    for cfg, ct, B, et, variant, lanes in (
            (short_cfg, short_ct, 1024, False, "stream-resident", 4),
            (short_cfg, short_ct, 256, False, "stream-pipelined", 1),
            (short_cfg, short_ct, 1024, True, "stream-resident-et", 4),
            (short_cfg, short_ct, 256, True, "stream-pipelined-et", 1),
            (nr_cfg, nr_ct, 256, False, "stream-resident", 2),
            (nr_cfg, nr_ct, 1024, True, "stream-resident-et", 4)):
        dec, label = select_decoder(ct, _with(cfg, early_term=et), batch=B)
        assert label == "torch-plain-" + variant
        assert dec.variant == variant and dec.lanes_for(B) == lanes
    assert len(nr_ct.code.punct_vns) == 768
    # the canonical code stays on the transposed on-chip path
    wifi_cfg, wifi_ct = _ct("wifi-648-r12-minsum")
    assert select_decoder(wifi_ct, wifi_cfg, batch=64)[1] == "torch-plain"
    assert use_transposed(wifi_ct, wifi_cfg, "onchip")
    assert select_decoder(wifi_ct, _with(wifi_cfg, schedule="layered"),
                          backend="stream")[
        1] == "torch-plain-stream-pipelined"
    # rows of 27-28 (n=16,200 rate 8/9): the pipelined kernel's 28-entry
    # register row (straight-line bodies) where the packed resident kernel
    # would run two lanes a thread (B = 256, and with no batch given), the
    # packed resident kernel at four (B = 1,024: 210,272 B a block, one an
    # SM), as on n=16,200 rate 1/2; `auto` takes either before K3's
    # one-lane template
    r89_cfg = _preset("dvbs2-64800-r12", n=16200, rate="8/9")
    r89_ct = from_reference(build_code(r89_cfg), "cpu")
    assert tstream.max_row_degree(r89_ct) == 28
    assert tstream.pipelined_fits(r89_ct)
    assert tstream.pipelined_dmax(r89_ct) == 28
    assert tstream.straight_rows(r89_ct)
    for et, sfx in ((False, ""), (True, "-et")):
        assert select_decoder(r89_ct, _with(r89_cfg, early_term=et),
                              backend="stream")[0].variant == (
            "stream-pipelined" + sfx)
        assert stream_first(r89_ct, _with(r89_cfg, early_term=et))
        for B, variant, lanes in ((256, "stream-pipelined", 1),
                                  (1024, "stream-resident", 4)):
            dec, label = select_decoder(
                r89_ct, _with(r89_cfg, early_term=et), batch=B)
            assert label == "torch-plain-" + variant + sfx
            assert dec.packed == (lanes == 4)
            assert dec.lanes_for(B) == lanes
    for unknown in ("mosaic", "onchip", "stream-resident", "ref"):
        with pytest.raises(ValueError, match="unknown decoder backend"):
            select_decoder(wifi_ct, wifi_cfg, backend=unknown)


def test_two_phase_capacity_follows_the_stream_block():
    """The reference rounds the two-phase capacity to the stream kernel's
    128-lane tile; here a block is one codeword, or masks its packed lanes
    past the batch, so the granularity is 1, and the label carries the
    instance of phase 2, chosen at the capacity it decodes: at 204
    codewords the pipelined kernel (the packed resident kernel would run
    two lanes a thread there), while phase 1 decodes the whole batch of
    2,048 on the packed resident kernel, four lanes a thread."""
    cfg, ct = _ct("dvbs2-64800-r12", 16200)
    cfg = _with(cfg, early_term=True, phase1_iters=4, phase2_frac=0.1)
    dec, label = select_decoder(ct, cfg, batch=2048, backend="stream")
    assert label == "torch-plain-stream-pipelined-et-2phase"
    assert dec.dec_full.variant == "stream-pipelined-et"
    assert dec.dec_full.batch_tile == 1
    assert dec.dec_p1.packed and dec.dec_p1.lanes_for(2048) == 4
    assert dec.batch_first and dec.capacity == 204
    assert dec.dec_p1.max_iter == 4 and dec.dec_full.max_iter == 20
