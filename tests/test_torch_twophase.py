"""Two-phase early termination and its AUTO tuner in the port
(ldpc_tpu_torch.sim.pipeline.TwoPhaseDecoder, ldpc_tpu_torch.sim.tune)
against the reference's cost model and against single-phase decoding.

Two-phase decoding restarts the unconverged lanes from the channel LLRs;
integer min-sum replays the same trajectory, so every per-lane output and
every counter must equal the single-phase run (tolerance 0), on the
repack path and on the overflow fallback alike."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.config import PRESETS, DecoderConfig, QuantConfig, SimConfig
from ldpc_tpu.sim import tune as jtune
from ldpc_tpu_torch.codes import from_reference
from ldpc_tpu_torch.kernels import minsum
from ldpc_tpu_torch.ops.channel import sigma_for
from ldpc_tpu_torch.sim import Sweep, make_run_batch, select_decoder
from ldpc_tpu_torch.sim import tune
from ldpc_tpu_torch.sim.pipeline import TwoPhaseDecoder

torch.set_num_threads(2)

OMS = PRESETS["wifi-full-oms"]


def test_tuner_constants_are_the_reference_s():
    assert tune.P1_CANDIDATES == jtune.P1_CANDIDATES
    assert tune.CAP_QUANTUM == jtune.CAP_QUANTUM


@settings(max_examples=60, deadline=None)
@given(max_iter=st.integers(3, 30),
       tile_frac=st.sampled_from([1 / 2048, 1 / 128, 1 / 16, 0.1, 0.3, 1.0]),
       data=st.data())
def test_pick_two_phase_matches_reference(max_iter, tile_frac, data):
    n = data.draw(st.integers(1, 300))
    conv_at = data.draw(st.lists(st.integers(0, max_iter), min_size=n,
                                 max_size=n))
    got = tune.pick_two_phase(np.asarray(conv_at), max_iter, tile_frac)
    assert got == jtune.pick_two_phase(np.asarray(conv_at), max_iter,
                                       tile_frac)


def test_pick_two_phase_cases():
    # everything converges by iteration 2: p1 = 2 with the smallest cap
    assert tune.pick_two_phase(np.full(1000, 2), 20, 1 / 128) == (
        2, tune.CAP_QUANTUM)
    # nothing converges: two-phase cannot pay
    assert tune.pick_two_phase(np.full(1000, 20), 20, 1 / 128) == (
        None, None)


def _cfg(schedule, max_iter=8, p1=None, frac=0.25, algorithm="min-sum"):
    base = SimConfig()
    return dataclasses.replace(base, decoder=DecoderConfig(
        algorithm=algorithm, schedule=schedule, max_iter=max_iter,
        early_term=True, phase1_iters=p1, phase2_frac=frac),
        quant=QuantConfig(beta_lsb=2 if algorithm == "offset-min-sum"
                          else 0))


def _llrs(rng, ct, B, sigma):
    y = 1.0 + sigma * rng.standard_normal((ct.n, B))
    return torch.as_tensor((2 * y / sigma ** 2).astype(np.float32)).reshape(
        ct.nb, ct.Z, B)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("counting", [True, False])
def test_two_phase_equals_single_phase(rng, schedule, counting):
    """Repack path: few unconverged lanes after p1 iterations."""
    ct = from_reference(toy_qc(8), "cpu")
    if not counting:
        ct = dataclasses.replace(ct, ident_info=False)
    B = 256
    d2, lbl2 = select_decoder(ct, _cfg(schedule, p1=2, frac=0.25), batch=B)
    d1, lbl1 = select_decoder(ct, _cfg(schedule), batch=B)
    assert isinstance(d2, TwoPhaseDecoder) and lbl2 == lbl1 + "-2phase"
    assert d2.capacity == 64 and d2.batch_tile == 1
    assert d2.counting == counting
    llr = _llrs(rng, ct, B, 0.6)
    info = torch.zeros((ct.kb, ct.Z, B), dtype=torch.uint8)
    args = (llr, info) if counting else (llr,)
    out1 = d1(*args)
    n_uncv_p1 = int((~d2.dec_p1(*args)[-1]).sum())
    assert 0 < n_uncv_p1 <= d2.capacity, "operating point off for the test"
    out2 = d2(*args)
    assert len(out1) == len(out2) == (4 if counting else 3)
    for a, b in zip(out1, out2):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_two_phase_overflow_falls_back_exactly(rng, schedule):
    """More unconverged lanes than capacity decode the whole batch."""
    ct = from_reference(toy_qc(8), "cpu")
    B = 256
    d2, _ = select_decoder(ct, _cfg(schedule, p1=2, frac=0.0625), batch=B)
    d1, _ = select_decoder(ct, _cfg(schedule), batch=B)
    llr = torch.as_tensor(rng.normal(0, 1.5, (ct.nb, ct.Z, B)).astype(
        np.float32))                                    # junk: no codeword
    info = torch.as_tensor(rng.integers(0, 2, (ct.kb, ct.Z, B),
                                        dtype=np.uint8))
    assert int((~d2.dec_p1(llr, info)[-1]).sum()) > d2.capacity
    for a, b in zip(d1(llr, info), d2(llr, info)):
        assert torch.equal(a, b)


def test_two_phase_capacity_and_labels():
    ct = from_reference(toy_qc(8), "cpu")
    # single-phase where the reference is: AUTO sentinel, p1 >= max_iter,
    # no early termination, no batch
    for cfg, batch in ((_cfg("layered", p1=-1), 256),
                       (_cfg("layered", p1=8), 256),
                       (_cfg("layered", p1=2), None)):
        dec, label = select_decoder(ct, cfg, batch=batch)
        assert isinstance(dec, minsum.MinsumDecoder)
        assert label == "torch-plain-layered"
    no_et = _cfg("flooding", p1=2)
    no_et = dataclasses.replace(no_et, decoder=dataclasses.replace(
        no_et.decoder, early_term=False))
    assert select_decoder(ct, no_et, batch=256)[1] == "torch-plain"
    dec, label = select_decoder(ct, _cfg("layered", p1=3, frac=0.3),
                                batch=100)
    assert label == "torch-plain-layered-2phase" and dec.capacity == 30
    assert dec.dec_p1.dec.max_iter == 3 and dec.dec_full.dec.max_iter == 8


def test_iter_probe_marks_unconverged_lanes_max_iter():
    ct = from_reference(toy_qc(8), "cpu")
    cfg = _cfg("layered", max_iter=5, p1=-1)
    probe = tune.make_iter_probe(ct, cfg, batch=128)
    sigma = np.float32(sigma_for(1.0, ct.code.rate, "bpsk"))
    it = probe(torch.Generator().manual_seed(3), sigma)
    assert it.shape == (128,) and it.dtype == torch.int32
    # the same draws through the single-phase step
    rb = make_run_batch(ct, dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, phase1_iters=None)),
        batch=128)
    frames, _, _, iter_sum, conv = rb(torch.Generator().manual_seed(3),
                                      sigma).tolist()
    assert 0 < conv < frames
    n_max = int((it == 5).sum())
    assert n_max >= frames - conv and int(it.max()) == 5
    # unconverged lanes ran max_iter too, so the probe's sum is the step's
    assert int(it.sum()) == iter_sum


def test_auto_sweep_counters_equal_single_phase():
    """AUTO two-phase on the wifi-full-oms code (layered OMS, early
    termination) with a short budget: the tuner picks two-phase at the
    high-SNR point, and every counter equals the single-phase sweep's."""
    cfg_single = dataclasses.replace(OMS, decoder=dataclasses.replace(
        OMS.decoder, phase1_iters=None))
    auto = Sweep(OMS, device="cpu", batch=128)
    single = Sweep(cfg_single, device="cpu", batch=128)
    assert auto.backend == single.backend == "torch-plain-layered"
    pts = [3.0, 4.0]
    ra = auto.run(pts, target_frame_errors=10 ** 9, max_frames=256)
    rs = single.run(pts, target_frame_errors=10 ** 9, max_frames=256)
    assert set(auto.auto_choice) == {0, 1} and not single.auto_choice
    p1, frac = auto.auto_choice[1]
    assert p1 is not None and 0 < frac <= 0.5
    assert any(lbl.endswith("-2phase") for lbl in
               (rb.backend_label for rb in auto._tuned_rb.values()))
    for a, b in zip(ra.points, rs.points):
        assert (a.frames, a.bit_errs, a.frame_errs, a.iter_sum,
                a.converged) == (b.frames, b.bit_errs, b.frame_errs,
                                 b.iter_sum, b.converged)
    assert ra.points[1].iter_sum < 20 * 256
