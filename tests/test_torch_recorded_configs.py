"""The recorded configurations that `chip_smoke.py`'s slices 10 and 11 run
on the card, on the CPU: each file's configuration as the port builds it
(the file's own `config` header, or for `results/bits_wifi648.json`, which
has none, as `scripts/make_bits_study.py:40-60` builds it) equals the
reference's field by field; the PBRL, QC-PEG and punctured codes that
slice 11 builds equal the reference's entry for entry; the route each
slice expects is the route `select_decoder` gives on a CPU code; the
slices run the file's own points and frame counts (slice 11 every row of
its file); one step of the new shapes equals the JAX chain on injected
draws, counter for counter (tolerance 0): the batch-first step on 8PSK and
16APSK DVB-S2 n=16,200 and on NR BG2 Z=128 rate 1/5, and the batch-last
fused-IO step of the bit-width study at 3 and 5 bits; and the family-wise
z that holds a file's rows."""
import dataclasses
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.config as rcfg
from ldpc_tpu.codes.qcstruct import qc_encode_numpy
from ldpc_tpu.ops import channel as jch
from ldpc_tpu.ops import decode_ref as jref
from ldpc_tpu.ops import encode as jenc
from ldpc_tpu.ops.quantize import quantize as jquantize
from ldpc_tpu.sim.sweep import build_code as ref_build_code
import ldpc_tpu_torch as port
from ldpc_tpu_torch.codes import build_code, config_from_reference, \
    from_reference
from ldpc_tpu_torch.ops import channel as tch
from ldpc_tpu_torch.sim import make_run_batch
from ldpc_tpu_torch.sim.pipeline import select_decoder

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()
SLICES = {sl.label: sl for sl in CS.SLICES
          if sl.label.startswith(("10", "11"))}
FILES = sorted({sl.what for sl in SLICES.values()}
               | {CS.DEEP_TAIL, CS.NR_SYM["ref"]})
# the files of slice 11 whose codes the port constructs or rate-matches,
# and NR BG1 Z=128 rate 1/3 (a generated base graph, punctured)
BUILT = sorted([sl.what for sl in SLICES.values()
                if sl.what.startswith(("pbrl_", "designed_648.qcpeg",
                                       "rate_ladder_"))] + [CS.NR_SYM["ref"]])


def _header(name):
    with open(os.path.join(ROOT, "results", name)) as f:
        return json.load(f)["config"]


def _reference_config(what):
    """The reference's configuration of a recorded file: its header read by
    `ldpc_tpu.config.SimConfig.from_json`, or a width of the bit-width
    study built as scripts/make_bits_study.py:40-60 builds it."""
    name, _, bits = what.partition(":")
    if not bits:
        return rcfg.SimConfig.from_json(json.dumps(_header(name)))
    base = rcfg.PRESETS["wifi-648-r12-minsum"]
    base = dataclasses.replace(
        base, decoder=dataclasses.replace(base.decoder,
                                          algorithm="offset-min-sum",
                                          early_term=True),
        run=dataclasses.replace(base.run, batch=16384, max_frames=131072))
    clip = {2: 2.0, 3: 4.0, 4: 8.0, 5: 12.0, 6: 16.0, 7: 24.0, 8: 31.75}
    b = int(bits)
    qmax = (1 << (b - 1)) - 1
    return dataclasses.replace(base, quant=dataclasses.replace(
        base.quant, bits=b, scale=qmax / clip.get(b, 31.75),
        beta_lsb=max(1, round(0.5 * qmax / clip.get(b, 31.75)))))


@pytest.mark.parametrize("what", FILES)
def test_configuration_equals_the_reference(what):
    """Field by field, section by section; and the code it builds."""
    got = CS.recorded_config(port, what)
    ref = _reference_config(what)
    carried = config_from_reference(ref)
    for section in ("code", "channel", "quant", "decoder", "run"):
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(carried, section)), section
    assert got == carried
    code, ref_code = build_code(got), ref_build_code(ref)
    assert (code.name, code.n, code.k, code.k_eff) == (
        ref_code.name, ref_code.n, ref_code.k, ref_code.k_eff)


@pytest.mark.parametrize("what", BUILT)
def test_constructed_and_rate_matched_codes_equal_the_reference(what):
    """PBRL (`codes/peg.pbrl_construct`) and QC-PEG codes built from the
    file's own header, 802.11n n=648 punctured by `codes/rate_compat` and NR
    BG1 Z=128 rate 1/3: the parity-check matrix entry for entry, the base
    matrix, the punctured and shortened variables and the rate."""
    cfg = CS.recorded_config(port, what)
    code, ref = build_code(cfg), ref_build_code(_reference_config(what))
    np.testing.assert_array_equal(code.h_dense(), ref.h_dense())
    np.testing.assert_array_equal(code.base, ref.base)
    for f in ("punct_vns", "shortened_vns"):
        np.testing.assert_array_equal(getattr(code, f), getattr(ref, f))
    assert (code.name, code.Z, code.rate) == (ref.name, ref.Z, ref.rate)
    if what.startswith("pbrl_"):
        assert (code.n, code.Z, cfg.code.family) == (756, 27, "pbrl")


def test_bit_widths_are_the_studys_q_formats():
    """qmax 3, 7, 15, 31 at scales 0.75, 0.875, 1.25, 1.9375, beta 1 LSB;
    the study's configuration otherwise (802.11n n=648, OMS, flooding,
    early termination)."""
    got = {b: CS.recorded_config(port, f"{CS.BITS_REF}:{b}").quant
           for b in (3, 4, 5, 6)}
    assert {b: (q.qmax, q.scale, q.beta_lsb) for b, q in got.items()} == {
        3: (3, 0.75, 1), 4: (7, 0.875, 1), 5: (15, 1.25, 1),
        6: (31, 1.9375, 1)}
    cfg = CS.recorded_config(port, f"{CS.BITS_REF}:3")
    assert (cfg.code.n, cfg.decoder.algorithm, cfg.decoder.schedule,
            cfg.decoder.early_term) == (648, "offset-min-sum", "flooding",
                                        True)


def test_recorded_configuration_is_taken_as_it_is():
    with pytest.raises(ValueError, match="as its file records it"):
        CS.slice_config(port, "dvbs2_16200_8psk.json", "device")
    with pytest.raises(ValueError, match="as its file records it"):
        CS.slice_config(port, "dvbs2_16200_8psk.json", "host",
                        schedule="flooding")


@pytest.mark.parametrize("label", sorted(SLICES))
def test_select_decoder_gives_the_expected_route(label):
    """The route `chip_smoke.py` expects on the card is the one the
    admission rule gives on a CPU code at the slice's batch, with the plain
    version's name: `torch-plain` for `cuda-minsum`, `torch-plain-` for
    `cuda-` otherwise, `torch-float` as it is."""
    sl = SLICES[label]
    cfg = CS.slice_config(port, sl.what, sl.rng)
    ct = from_reference(build_code(cfg), "cpu")
    _, got = select_decoder(ct, cfg, batch=sl.batch)
    want = sl.expect.replace("cuda-minsum", "torch-plain").replace(
        "cuda-", "torch-plain-")
    assert got == want
    assert sl.backend == "auto" and sl.equal_to is None


def test_deep_tail_runs_slice_3s_instance():
    """The deep tail's header is the canonical preset with rng="device" at
    the fused batch, so `run_fused` launches the per-lane-sigma K1-MC
    instance that slice 3 holds to plain; its stop rule is the file's."""
    cfg = CS.recorded_config(port, CS.DEEP_TAIL)
    canon = port.PRESETS["wifi-648-r12-minsum"]
    assert (cfg.code, cfg.decoder, cfg.quant) == (canon.code, canon.decoder,
                                                  canon.quant)
    assert (cfg.run.rng, cfg.run.batch) == ("device", CS.FUSED["batch"])
    assert (cfg.run.target_frame_errors, cfg.run.max_frames) == (
        100, 50_000_000)
    ct = from_reference(build_code(cfg), "cpu")
    dec, label = select_decoder(ct, cfg, batch=cfg.run.batch, n_points=4)
    assert label == "torch-plain-mc" and dec.lane_sigma
    assert len(CS.read_ref(CS.DEEP_TAIL)) == 4


@pytest.mark.parametrize("label", sorted(SLICES))
def test_slices_run_the_files_points_and_frames(label):
    """Each point is a row of the file, at the file's frame count."""
    sl = SLICES[label]
    ref = CS.read_ref(sl.ref)
    frames = (sl.frames if isinstance(sl.frames, tuple)
              else (sl.frames,) * len(sl.points))
    assert [ref[p]["frames"] for p in sl.points] == list(frames)
    if sl.what.startswith(CS.BITS_REF):
        assert len(ref) == 5 and {r["bits"] for r in ref.values()} == {
            int(sl.what.split(":")[1])}
    if label.startswith("11"):
        # at a batch that divides its frames (the file's own for 16-QAM),
        # held at the family-wise z of its rows
        assert sl.least_row
        assert all(f % sl.batch == 0 for f in frames)
        assert sl.batch == (4096 if CS.QAM16_FILE in sl.what else CS.BATCH)
        assert sl.z == CS.family_z(len(ref))


def test_family_z():
    """The Bonferroni z of rows sharing 1%: 8 rows (slice 2's K2 rows),
    36 (slice 6's), and each new file's rows."""
    assert round(CS.family_z(8), 3) == 3.227
    assert 3.63 < CS.family_z(36) < 3.64      # 3.635
    assert CS.OMS_ET_Z == CS.family_z(8)
    rows = {}
    ten = [sl for sl in SLICES.values() if sl.label.startswith("10")]
    for sl in ten:
        key = sl.ref.partition(":")[0]
        rows[key] = rows.get(key, 0) + len(sl.points)
    assert rows[CS.BITS_REF] == 12 and sum(rows.values()) + 4 == 36
    for sl in ten:
        assert sl.z == CS.family_z(rows[sl.ref.partition(":")[0]])


# --- one step against the JAX chain on injected draws ----------------------

def _bf_jax_counters(code, cfg, info, noise, sigma):
    """ldpc_tpu/sim/pipeline.py:648-692 op by op with the draws given, the
    plain jnp decoder. The codes are QC with n > 4096, where the reference
    encodes with its structured encoder (`make_qc_encoder`); its numpy
    twin `qc_encode_numpy` gives the same words without a minute of
    op-by-op dispatch."""
    info_pos = np.asarray(jenc.info_positions(code))
    excluded = set(map(int, code.punct_vns)) | set(
        map(int, code.shortened_vns))
    tx_pos = np.asarray([v for v in range(code.n) if v not in excluded])
    assert code.n > 4096 and jenc._has_qc_struct(code)
    cw = jnp.asarray(qc_encode_numpy(code, info))
    tx = cw[:, tx_pos] if excluded else cw
    mod = cfg.channel.modulation
    y = jch.modulate(tx, mod) + jnp.float32(sigma) * jnp.asarray(noise)
    llr = jch.demap(y, sigma, mod)
    if excluded:
        llr = jnp.zeros((info.shape[0], code.n), llr.dtype).at[
            :, tx_pos].set(llr)
    q = jquantize(llr, cfg.quant)
    hard, iters, conv = map(np.asarray, jref.make_decoder(
        code, cfg.decoder, cfg.quant)(q))
    err = hard[:, info_pos] != info
    return [info.shape[0], int(err.sum()), int(err.any(axis=1).sum()),
            int(iters.sum()), int(conv.sum())]


# file -> (Eb/N0 dB, batch, max_iter or None for the file's)
BATCH_FIRST = {"dvbs2_16200_8psk.json": (4.5, 8, 4),
               "dvbs2_16200_16apsk.json": (6.25, 8, 4),
               "nr_bg2_z128_r15.json": (1.25, 16, None)}


@pytest.mark.parametrize("name", sorted(BATCH_FIRST))
def test_batch_first_step_matches_jax_chain(name):
    ebn0, B, max_iter = BATCH_FIRST[name]
    ref_cfg = rcfg.SimConfig.from_json(json.dumps(_header(name)))
    if max_iter:
        ref_cfg = dataclasses.replace(ref_cfg, decoder=dataclasses.replace(
            ref_cfg.decoder, max_iter=max_iter))
    ref_code = ref_build_code(ref_cfg)
    cfg = config_from_reference(ref_cfg)
    ct = from_reference(build_code(cfg), "cpu")
    mod = cfg.channel.modulation
    n_tx = ct.n - len(ct.code.punct_vns)
    m = tch.BITS_PER_SYM[mod]
    rng = np.random.default_rng(sorted(BATCH_FIRST).index(name) + 30)
    info = rng.integers(0, 2, (B, ct.code.k), dtype=np.uint8)
    noise = rng.standard_normal(
        (B, n_tx) if m == 1 else (B, n_tx // m, 2)).astype(np.float32)
    sigma = np.float32(tch.sigma_for(ebn0, ct.code.rate, mod))
    assert sigma == np.float32(jch.sigma_for(ebn0, ref_code.rate, mod))
    rb = make_run_batch(ct, cfg, batch=B)
    assert not rb.transposed
    got = rb(None, sigma, info=torch.as_tensor(info),
             noise=torch.as_tensor(noise)).tolist()
    want = _bf_jax_counters(ref_code, ref_cfg, info, noise, sigma)
    assert got == want
    assert 0 < want[1] or 0 < want[4]       # not all lanes trivially equal


@pytest.mark.parametrize("bits", [3, 5])
def test_fused_io_step_of_the_bit_width_study_matches_jax_chain(rng, bits):
    """The batch-last step with the quantizer in the decoder at the study's
    scale (0.75 at 3 bits, 1.25 at 5) against make_encoder_t -> modulate_t
    -> AWGN -> demap_t -> quantize -> the jnp flooding OMS decoder."""
    what = f"{CS.BITS_REF}:{bits}"
    ref_cfg = _reference_config(what)
    cfg = CS.recorded_config(port, what)
    code = ref_build_code(ref_cfg)
    ct = from_reference(build_code(cfg), "cpu")
    B, ebn0 = 256, 2.5
    info_t = rng.integers(0, 2, (code.k, B), dtype=np.uint8)
    noise = rng.standard_normal((code.n, B)).astype(np.float32)
    sigma = np.float32(tch.sigma_for(ebn0, code.rate, "bpsk"))
    rb = make_run_batch(ct, cfg, batch=B)
    assert rb.transposed and rb.decoder.counting
    assert rb.decoder.input_scale == cfg.quant.scale
    got = rb(None, sigma, info_t=torch.as_tensor(info_t),
             noise=torch.as_tensor(noise)).tolist()
    x = jch.modulate_t(jenc.make_encoder_t(code)(jnp.asarray(info_t)),
                       "bpsk")
    y = x + jnp.float32(sigma) * jnp.asarray(noise)
    q = jquantize(jch.demap_t(y, sigma, "bpsk"), ref_cfg.quant)
    hard, iters, conv = map(np.asarray, jref.make_decoder(
        code, ref_cfg.decoder, ref_cfg.quant)(q.T))
    err = hard[:, : code.k] != info_t.T
    want = [B, int(err.sum()), int(err.any(axis=1).sum()), int(iters.sum()),
            int(conv.sum())]
    assert got == want
    assert 0 < want[2] < B


def test_soft_bsc_runs_the_files_points():
    """Slice 11d's soft BSC: the file's eight p at its 16,384 frames, in
    batches of scripts/make_bsc_curve.py's 4,096, on the canonical preset
    (the configuration the file names)."""
    with open(os.path.join(ROOT, "results", CS.BSC["ref"])) as f:
        doc = json.load(f)
    assert doc["config"] == f"{CS.BSC['preset']} over BSC"
    rows = doc["results"]
    assert tuple(r["p"] for r in rows) == CS.BSC["ps"]
    assert {r["frames"] for r in rows} == {CS.BSC["frames"]}
    assert CS.BSC["frames"] % CS.BSC["batch"] == 0
    cfg = port.PRESETS[CS.BSC["preset"]]
    ct = from_reference(build_code(cfg), "cpu")
    _, label = select_decoder(ct, cfg, batch=CS.BSC["batch"],
                              batch_first=True)
    assert label == "torch-plain-bf"
