"""The port's batch-first step (ldpc_tpu_torch.sim.pipeline, the
counterpart of `run_batch_bf`): rate matching (punctured and shortened
variables), the all-zeros shortcut, long codes (n > 4096), per-lane sigma
and batch-first two-phase early termination, on the CPU.

With the random draws injected (info bits and standard-normal noise from a
numpy seed), one step must equal the reference chain, built op by op from
the JAX package's own parts exactly as `ldpc_tpu/sim/pipeline.py:648-692`
chains them, counter for counter: tolerance 0. A rate-matched code carried
across by value equals the reference's field by field."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.config as rcfg
from ldpc_tpu.ops import channel as jch
from ldpc_tpu.ops import decode_ref as jref
from ldpc_tpu.ops import encode as jenc
from ldpc_tpu.ops.quantize import quantize as jquantize
from ldpc_tpu.sim.sweep import build_code as ref_build_code
from ldpc_tpu_torch import PRESETS
from ldpc_tpu_torch.codes import (build_code, config_from_reference,
                                  from_reference)
from ldpc_tpu_torch.ops import channel as tch
from ldpc_tpu_torch.sim import Sweep, make_run_batch
from ldpc_tpu_torch.sim.pipeline import make_lane_step, rate_matching

torch.set_num_threads(2)

BASE = rcfg.PRESETS["wifi-648-r12-minsum"]


def _ref_cfg(base=BASE, **sections):
    cfg = base
    for name, fields in sections.items():
        cfg = dataclasses.replace(cfg, **{name: dataclasses.replace(
            getattr(cfg, name), **fields)})
    return cfg


OMS_ET = dict(decoder=dict(algorithm="offset-min-sum", schedule="layered",
                           early_term=True), quant=dict(beta_lsb=2))
NR = dict(code=dict(family="5gnr", base_graph=2, Z=16, rate="1/3"))
# name -> (reference config, Eb/N0 dB, batch)
CASES = {
    "punctured-tail": (_ref_cfg(code=dict(punct_frac=0.25)), 3.0, 64),
    "punctured-random-oms-et": (_ref_cfg(code=dict(
        punct_frac=0.2, punct_scheme="random"), **OMS_ET), 3.0, 64),
    "shortened": (_ref_cfg(code=dict(shorten_bits=27), **OMS_ET), 2.0, 64),
    "shortened-and-punctured": (_ref_cfg(code=dict(
        shorten_bits=54, punct_frac=0.125)), 2.5, 48),
    "nr-bg2-z16": (_ref_cfg(**NR, **OMS_ET), 2.0, 64),
    "nr-bg2-z16-fillers": (_ref_cfg(code=dict(
        family="5gnr", base_graph=2, Z=16, rate="1/3", k_info=120),
        **OMS_ET), 2.0, 48),
    "all-zeros": (_ref_cfg(run=dict(all_zeros=True)), 2.0, 64),
    "all-zeros-punctured-qpsk": (_ref_cfg(
        code=dict(punct_frac=0.26), channel=dict(modulation="qpsk"),
        run=dict(all_zeros=True), **OMS_ET), 2.0, 48),
    "punctured-16qam": (_ref_cfg(code=dict(n=1944, rate="3/4",
                                           punct_frac=0.206),
                                 channel=dict(modulation="16qam"),
                                 **OMS_ET), 6.0, 32),
    "dvbs2-16200": (_ref_cfg(
        rcfg.PRESETS["dvbs2-64800-r12"], code=dict(n=16200),
        decoder=dict(max_iter=4)), 3.0, 8),
    "dvbs2-16200-et": (_ref_cfg(
        rcfg.PRESETS["dvbs2-64800-r12"], code=dict(n=16200),
        decoder=dict(max_iter=4, early_term=True)), 2.6, 8),
}


def _draws(rng, code, cfg, B):
    """(info (B, k) uint8, noise float32 of the symbols' shape)."""
    mod = cfg.channel.modulation
    n_tx = code.n - len(set(map(int, code.punct_vns))
                        | set(map(int, code.shortened_vns)))
    m = tch.BITS_PER_SYM[mod]
    shape = (B, n_tx) if mod == "bpsk" else (B, n_tx // m, 2)
    return (rng.integers(0, 2, (B, code.k), dtype=np.uint8),
            rng.standard_normal(shape).astype(np.float32))


def _jax_chain_counters(code, cfg, info, noise, sigma):
    """`run_batch_bf` (ldpc_tpu/sim/pipeline.py:648-692) op by op, with the
    draws given; the decoder is the reference's plain jnp one."""
    B = info.shape[0]
    mod = cfg.channel.modulation
    info_pos = np.asarray(jenc.info_positions(code))
    excluded = set(map(int, code.punct_vns)) | set(
        map(int, code.shortened_vns))
    tx_pos = np.asarray([v for v in range(code.n) if v not in excluded])
    info = jnp.asarray(info)
    if cfg.run.all_zeros:
        info = jnp.zeros_like(info)
    if len(code.shortened_vns):
        short_info = np.intersect1d(np.asarray(code.shortened_vns), info_pos)
        if len(short_info):
            keep = np.ones(code.k, np.uint8)
            pos_of = {int(p): i for i, p in enumerate(info_pos)}
            keep[[pos_of[int(v)] for v in short_info]] = 0
            info = info * jnp.asarray(keep)
    cw = (jnp.zeros((B, code.n), jnp.uint8) if cfg.run.all_zeros
          else jenc.make_encoder(code)(info))
    tx = cw[:, tx_pos] if excluded else cw
    y = jch.modulate(tx, mod) + jnp.float32(sigma) * jnp.asarray(noise)
    llr = jch.demap(y, sigma, mod)
    if excluded:
        full = jnp.zeros((B, code.n), llr.dtype).at[:, tx_pos].set(llr)
        if len(code.shortened_vns):
            full = full.at[:, np.asarray(code.shortened_vns)].set(
                jnp.float32(1e6))
        llr = full
    q = jquantize(llr, cfg.quant)
    hard, iters, conv = map(np.asarray, jref.make_decoder(
        code, cfg.decoder, cfg.quant)(q))
    err = hard[:, info_pos] != np.asarray(info)
    return [B, int(err.sum()), int(err.any(axis=1).sum()), int(iters.sum()),
            int(conv.sum())]


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_first_step_matches_jax_chain(name):
    ref_cfg, ebn0, B = CASES[name]
    ref_code = ref_build_code(ref_cfg)
    cfg = config_from_reference(ref_cfg)
    code = build_code(cfg)
    ct = from_reference(code, "cpu")
    rng = np.random.default_rng(sorted(CASES).index(name))
    info, noise = _draws(rng, ref_code, ref_cfg, B)
    sigma = np.float32(tch.sigma_for(ebn0, code.rate,
                                     cfg.channel.modulation))
    assert sigma == np.float32(jch.sigma_for(ebn0, ref_code.rate,
                                             ref_cfg.channel.modulation))
    rb = make_run_batch(ct, cfg, batch=B)
    assert not rb.transposed and not rb.mc
    assert rb.backend_label.endswith("-bf")       # K1/K3 behind transposes
    got = rb(None, sigma, info=torch.as_tensor(info),
             noise=torch.as_tensor(noise)).tolist()
    want = _jax_chain_counters(ref_code, ref_cfg, info, noise, sigma)
    assert got == want
    assert want[4] > 0                            # some lane converges
    if name.startswith("all-zeros"):
        # nothing drawn for the info bits: a generator serves the noise only
        g = torch.Generator().manual_seed(1)
        assert rb(g, sigma).tolist()[0] == B
    # every other route decodes the same words: the streaming library's
    # plain version where it applies, the QC and edge-gather decoders
    routes = ["qc", "jnp"]
    if cfg.decoder.schedule == "layered":
        routes += ["stream"]
    for backend in routes:
        rb2 = make_run_batch(ct, cfg, batch=B, backend=backend)
        assert rb2(None, sigma, info=torch.as_tensor(info),
                   noise=torch.as_tensor(noise)).tolist() == want, backend


@pytest.mark.parametrize("name", ["punctured-tail", "shortened",
                                  "shortened-and-punctured", "nr-bg2-z16",
                                  "nr-bg2-z16-fillers"])
def test_rate_matched_code_carried_across_equals_the_reference(name):
    """`from_reference` on the reference's rate-matched code, and the
    port's own `build_code`, field by field; the step's positions are the
    reference's (n_tx counts the union of punctured and shortened)."""
    ref_cfg = CASES[name][0]
    ref_code = ref_build_code(ref_cfg)
    own = build_code(config_from_reference(ref_cfg))
    carried = from_reference(ref_code, "cpu")
    for code in (own, carried.code):
        for f in ("name", "n", "m", "k", "Z", "standard_exact", "k_eff"):
            assert getattr(code, f) == getattr(ref_code, f), f
        assert code.rate == ref_code.rate
        for f in ("base", "punct_vns", "shortened_vns"):
            np.testing.assert_array_equal(getattr(code, f),
                                          getattr(ref_code, f))
        assert all(np.array_equal(a, b)
                   for a, b in zip(code.cn_adj, ref_code.cn_adj))
    tx_pos, short_pos, keep = rate_matching(carried)
    excluded = set(map(int, ref_code.punct_vns)) | set(
        map(int, ref_code.shortened_vns))
    assert tx_pos.tolist() == [v for v in range(ref_code.n)
                               if v not in excluded]
    assert len(tx_pos) == ref_code.n - len(excluded)
    if len(ref_code.shortened_vns):
        assert short_pos.tolist() == list(map(int, ref_code.shortened_vns))
        assert int(keep.sum()) == ref_code.k_eff
    else:
        assert short_pos is None and keep is None


def test_transmitted_length_must_fill_the_symbols():
    """The reference's refusal (pipeline.py:471-474): 648 - 81 punctured
    bits do not fill 16-QAM symbols."""
    cfg = config_from_reference(_ref_cfg(
        code=dict(punct_frac=0.25), channel=dict(modulation="16qam")))
    ct = from_reference(build_code(cfg), "cpu")
    assert (ct.n - len(ct.code.punct_vns)) % 4
    with pytest.raises(ValueError, match="not a multiple"):
        make_run_batch(ct, cfg, batch=8)


def test_batch_first_two_phase_equals_single_phase():
    """`TwoPhaseDecoder(batch_first=True)` (make_two_phase_decoder,
    pipeline.py:269-319): repack on the leading axis, and the overflow
    path, give the single-phase counters."""
    ref_cfg, _, B = CASES["shortened"]
    ebn0 = 1.0                  # some lanes converge, some do not
    cfg = config_from_reference(ref_cfg)
    ct = from_reference(build_code(cfg), "cpu")
    rng = np.random.default_rng(9)
    info, noise = _draws(rng, ct.code, cfg, B)
    sigma = np.float32(tch.sigma_for(ebn0, ct.code.rate, "bpsk"))
    draws = dict(info=torch.as_tensor(info), noise=torch.as_tensor(noise))
    want = make_run_batch(ct, cfg, batch=B)(None, sigma, **draws).tolist()
    assert 0 < want[4] < B
    for p1, frac, backend in ((3, 0.5, "auto"), (2, 0.02, "auto"),
                              (3, 0.5, "stream"), (3, 0.5, "qc")):
        cfg2 = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, phase1_iters=p1, phase2_frac=frac))
        rb2 = make_run_batch(ct, cfg2, batch=B, backend=backend)
        assert rb2.backend_label.endswith("-2phase")
        assert rb2.decoder.batch_first
        assert rb2(None, sigma, **draws).tolist() == want


def test_fused_points_on_the_batch_first_step():
    """n_points > 1 (pipeline.py:657-664): lane b takes sigma[b % P] on the
    leading axis; each stripe equals the single-point step on its lanes."""
    ref_cfg, _, _ = CASES["punctured-tail"]
    cfg = config_from_reference(ref_cfg)
    ct = from_reference(build_code(cfg), "cpu")
    B, P = 48, 3
    rng = np.random.default_rng(4)
    info, noise = _draws(rng, ct.code, cfg, B)
    sig = np.asarray([tch.sigma_for(e, ct.code.rate, "bpsk")
                      for e in (2.0, 3.0, 4.0)], np.float32)
    draws = dict(info=torch.as_tensor(info), noise=torch.as_tensor(noise))
    fused = make_run_batch(ct, cfg, batch=B, n_points=P)(None, sig, **draws)
    assert tuple(fused.shape) == (5, P)
    single = make_lane_step(ct, cfg, batch=B)
    for i in range(P):
        bits, frame, iters, conv = single(None, sig[i], **draws)
        want = [B // P] + [int(x[i::P].sum())
                           for x in (bits, frame, iters, conv)]
        assert fused[:, i].tolist() == want
    assert fused[2, 0] > fused[2, 2]              # FER falls with Eb/N0


def test_run_fused_on_the_batch_first_step():
    """`Sweep.run_fused` on a rate-matched code: the fused counters of one
    batch are the step's stripes, every point gets its frames, and FER
    falls with Eb/N0."""
    cfg = config_from_reference(CASES["punctured-tail"][0])
    sweep = Sweep(cfg, device="cpu", batch=48)
    assert sweep.backend == "torch-plain-bf" and not sweep.run_batch.mc
    res = sweep.run_fused([1.5, 3.0, 4.5], target_frame_errors=10 ** 9,
                          max_frames=96)
    rows = res.rows()
    assert [r["frames"] for r in rows] == [96, 96, 96]
    assert rows[0]["frame_errs"] > rows[2]["frame_errs"]
    rb = sweep.fused_run_batch(3)
    sig = np.asarray([sweep._sigma(e) for e in (1.5, 3.0, 4.5)], np.float32)
    total = sum(rb(sweep.draw(0, b), sig) for b in range(6))  # 16 a stripe
    assert total[1:].T.tolist() == [
        [r["bit_errs"], r["frame_errs"], round(r["avg_iters"] * 96),
         round(r["early_term_rate"] * 96)] for r in rows]


def test_sweep_and_cli_run_rate_matched_and_long_codes(tmp_path):
    """Info bits per frame are k_eff; `--puncture-frac`, `--shorten-bits`
    and `--decoder-backend` run; the long preset runs through the sweep on
    the streaming decoder's plain version."""
    from ldpc_tpu_torch import cli
    out = str(tmp_path / "punct")
    argv = ["sweep", "--preset", "wifi-648-r12-minsum", "--device", "cpu",
            "--puncture-frac", "0.25", "--shorten-bits", "27", "--batch",
            "16", "--ebn0", "3.0", "--max-frames", "32", "--out", out]
    assert cli.main(argv) == 0
    got = json.load(open(out + ".json"))
    assert got["decoder_backend"] == "torch-plain-bf"
    assert got["k"] == 324 - 27 and got["results"][0]["frames"] == 32
    assert got["config"]["code"]["punct_frac"] == 0.25
    out2 = str(tmp_path / "qc")
    assert cli.main(argv[:-1] + [out2, "--decoder-backend", "qc-jnp",
                                 "--puncture-scheme", "random"]) == 0
    assert json.load(open(out2 + ".json"))["decoder_backend"] == "torch-qc"
    cfg = dataclasses.replace(
        PRESETS["dvbs2-64800-r12"],
        code=dataclasses.replace(PRESETS["dvbs2-64800-r12"].code, n=16200),
        decoder=dataclasses.replace(PRESETS["dvbs2-64800-r12"].decoder,
                                    max_iter=3))
    sweep = Sweep(cfg, device="cpu", batch=4, decoder_backend="stream")
    assert sweep.backend == "torch-plain-stream-pipelined"
    p = sweep.run([3.0], target_frame_errors=10 ** 9, max_frames=8).points[0]
    assert p.frames == 8 and p.iter_sum == 3 * 8
