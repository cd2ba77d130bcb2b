"""The port's sweep loop around the megakernel (ldpc_tpu_torch.sim.sweep:
run_fused, run with lookahead and checkpoint/resume; sim.checkpoint,
sim.report, cli) on the CPU, against the reference's contracts and
files.

Counters of the port's own streams are compared exactly with each other
(resumed == uninterrupted, CLI == in-process); against the reference's
recorded waterfall the comparison is statistical (99% Wilson
intervals)."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldpc_tpu.config import (PRESETS, ChannelConfig, CodeConfig,
                             DecoderConfig, QuantConfig, RunConfig,
                             SimConfig)
from ldpc_tpu_torch import cli
from ldpc_tpu_torch.kernels import minsum
from ldpc_tpu_torch.sim import Sweep, rates_compatible
from ldpc_tpu_torch.sim import checkpoint as tckpt
from ldpc_tpu_torch.sim import report as treport

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _toy_cfg(batch=64, rng="device", **dec):
    """tests/test_sim.py's toy configuration, device RNG by default."""
    return SimConfig(
        code=CodeConfig(family="toy", Z=8),
        channel=ChannelConfig(modulation="bpsk"),
        quant=QuantConfig(bits=8, scale=4.0, beta_lsb=0),
        decoder=DecoderConfig(algorithm="min-sum", schedule="flooding",
                              max_iter=8, early_term=True, **dec),
        run=RunConfig(batch=batch, seed=3, target_frame_errors=30,
                      max_frames=400, rng=rng),
    )


def _counters(res):
    return [(p.ebn0_db, p.frames, p.bit_errs, p.frame_errs, p.iter_sum,
             p.converged) for p in res.points]


def test_fused_retirement_and_checkpoint(tmp_path):
    """tests/test_sim.py:376-410 on the port's megakernel path: the lanes
    of a finished point go to the point still running; a checkpointed
    fused sweep resumes and completes; a wrong point set is refused."""
    cfg = _toy_cfg(batch=64)
    s = Sweep(cfg, device="cpu", lookahead=2)
    assert s.run_batch.mc and s.backend == "torch-plain-mc"
    fused = s.run_fused([6.0, -2.0], target_frame_errors=8, max_frames=2000)
    clean, noisy = fused.points
    assert noisy.frame_errs >= 8
    assert clean.frames >= 2000
    assert clean.frames > noisy.frames
    # a fused batch is (5, P) on the device, lane b at point b % P
    assert tuple(s.fused_run_batch(2)(s.draw(0, 0),
                                      np.float32([0.5, 1.0])).shape) == (5, 2)

    path = str(tmp_path / "fused.json")
    s1 = Sweep(cfg, device="cpu", checkpoint_path=path, lookahead=1)
    r1 = s1.run_fused([6.0, -2.0], target_frame_errors=50, max_frames=128)
    assert os.path.exists(path)
    mid_frames = [p.frames for p in r1.points]
    state = tckpt.load(path)
    assert state["meta"]["fused_batch_idx"] == max(
        p.batches for p in r1.points)
    s2 = Sweep(cfg, device="cpu", checkpoint_path=path, lookahead=1)
    r2 = s2.run_fused([6.0, -2.0], target_frame_errors=50, max_frames=512)
    for pm, p2 in zip(mid_frames, r2.points):
        assert p2.frames >= pm  # resumed, not restarted
    assert r2.points[1].frame_errs >= 50
    for p in r2.points:
        assert 0 <= p.bit_errs <= p.frames * s2.code.k
    with pytest.raises(ValueError, match="resume requires the same"):
        Sweep(cfg, device="cpu", checkpoint_path=path).run_fused(
            [6.0, -1.0], target_frame_errors=50, max_frames=256)


def test_run_fused_is_deterministic():
    """Slot assignment depends only on consumed counters: with a fixed
    lookahead the same call gives the same counters."""
    cfg = _toy_cfg(batch=48)
    a = Sweep(cfg, device="cpu").run_fused([1.0, 2.0, 3.0],
                                           target_frame_errors=20,
                                           max_frames=480)
    b = Sweep(cfg, device="cpu").run_fused([1.0, 2.0, 3.0],
                                           target_frame_errors=20,
                                           max_frames=480)
    assert _counters(a) == _counters(b)
    assert all(p.frames > 0 for p in a.points)


@pytest.mark.parametrize("rng_mode", ["device", "host"])
def test_run_resumed_equals_uninterrupted(tmp_path, rng_mode):
    """run() stopped by max_frames and resumed with a larger budget gives
    the counters of one uninterrupted run (sample-exact), and lookahead
    does not change them."""
    cfg = _toy_cfg(batch=32, rng=rng_mode)
    path = str(tmp_path / "s.json")
    kw = dict(target_frame_errors=10 ** 9)
    Sweep(cfg, device="cpu", checkpoint_path=path).run([1.5, 3.0],
                                                       max_frames=64, **kw)
    res = Sweep(cfg, device="cpu", checkpoint_path=path).run(
        [1.5, 3.0], max_frames=160, **kw)
    ref = Sweep(cfg, device="cpu", lookahead=1).run([1.5, 3.0],
                                                    max_frames=160, **kw)
    assert _counters(res) == _counters(ref)
    assert [p.frames for p in res.points] == [160, 160]
    assert [p.batches for p in res.points] == [5, 5]
    with pytest.raises(ValueError, match="point list"):
        Sweep(cfg, device="cpu", checkpoint_path=path).run([3.0],
                                                           max_frames=192)


def test_reference_and_port_checkpoints_read_but_never_resume(tmp_path):
    """One schema: each package's load reads the other's file. The run
    meta names the port's streams, so a resume across packages refuses
    in both directions."""
    from ldpc_tpu.sim import Sweep as RefSweep
    from ldpc_tpu.sim import checkpoint as rckpt
    ref_state = os.path.join(ROOT, "results", "wifi648_minsum.state")
    st = tckpt.load(ref_state)
    want = rckpt.load(ref_state)
    assert st["version"] == want["version"] == tckpt._VERSION
    assert [dataclasses.asdict(p) for p in st["points"]] == [
        dataclasses.asdict(p) for p in want["points"]]
    assert st["points"][0].frames == 16384
    # the port refuses to resume the reference's file
    copy = str(tmp_path / "ref.state")
    shutil.copy(ref_state, copy)
    cfg = PRESETS["wifi-648-r12-minsum"]
    with pytest.raises(ValueError, match="random streams"):
        Sweep(cfg, device="cpu", checkpoint_path=copy).run(
            [p.ebn0_db for p in st["points"]])
    # a port checkpoint loads through the reference's load ...
    cfg = _toy_cfg(batch=32, rng="host")
    path = str(tmp_path / "port.state")
    Sweep(cfg, device="cpu", checkpoint_path=path).run([2.0], max_frames=32)
    got = rckpt.load(path)
    assert got["meta"]["rng_stream"] == \
        "ldpc_tpu_torch:torch.Generator(cpu)"
    assert got["points"][0].frames == 32
    # ... and the reference's sweep refuses to resume it
    with pytest.raises(ValueError, match="resume requires the same"):
        RefSweep(cfg, decoder_backend="jnp", checkpoint_path=path).run(
            [2.0], max_frames=64)


def test_checkpoint_refuses_a_changed_config(tmp_path):
    cfg = _toy_cfg(batch=32)
    path = str(tmp_path / "s.json")
    Sweep(cfg, device="cpu", checkpoint_path=path).run([2.0], max_frames=32)
    other = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, max_iter=9))
    with pytest.raises(ValueError, match="different SimConfig"):
        Sweep(other, device="cpu", checkpoint_path=path).run([2.0],
                                                             max_frames=64)
    # stop rules and two-phase tuning are not part of the identity
    longer = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, max_frames=999), decoder=dataclasses.replace(
        cfg.decoder, phase1_iters=-1))
    res = Sweep(longer, device="cpu", checkpoint_path=path).run(
        [2.0], max_frames=64)
    assert res.points[0].frames == 64


def test_report_columns_and_outputs(tmp_path, monkeypatch):
    from ldpc_tpu.sim import report as rreport
    assert treport._COLUMNS == rreport._COLUMNS
    res = Sweep(_toy_cfg(batch=32), device="cpu").run([2.0], max_frames=32)
    csv = treport.to_csv(res)
    assert csv.splitlines()[0] == ",".join(rreport._COLUMNS)
    paths = treport.write_outputs(res, str(tmp_path / "sub" / "r"))
    assert [os.path.basename(p) for p in paths] == ["r.json", "r.csv"]
    with open(paths[0]) as f:
        assert json.load(f)["results"][0]["frames"] == 32
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        treport.plot_waterfall([res], str(tmp_path / "r.png"))


def test_cli_fused_device_rng_matches_in_process(tmp_path, capsys):
    """`sweep --device cpu --rng device --fused` writes json+csv and the
    default checkpoint, and its counters equal Sweep.run_fused run in
    process with the same configuration."""
    out = str(tmp_path / "mc")
    argv = ["sweep", "--family", "toy", "--Z", "8", "--rng", "device",
            "--fused", "--ebn0", "1.0:3.0:1.0", "--batch", "60",
            "--target-errors", "15", "--max-frames", "600", "--max-iter",
            "8", "--device", "cpu", "--out", out]
    assert cli.main(argv) == 0
    assert "wrote:" in capsys.readouterr().out
    with open(out + ".json") as f:
        got = json.load(f)
    assert os.path.exists(out + ".csv") and os.path.exists(out + ".state")
    assert got["decoder_backend"] == "torch-plain-mc"
    cfg = cli._build_config(cli.build_parser().parse_args(argv))
    assert cfg.run.rng == "device" and cfg.run.batch == 60
    res = Sweep(cfg, device="cpu").run_fused([1.0, 2.0, 3.0])
    keys = ("ebn0_db", "frames", "bit_errs", "frame_errs", "avg_iters",
            "early_term_rate")
    assert [{k: r[k] for k in keys} for r in got["results"]] == [
        {k: r[k] for k in keys} for r in res.rows()]
    # rerunning the same command resumes the finished state: no new batch
    assert cli.main(argv) == 0
    with open(out + ".json") as f:
        again = json.load(f)
    assert [r["frames"] for r in again["results"]] == [
        r["frames"] for r in got["results"]]


def test_cli_flags_match_the_reference():
    """Every flag of the reference's sweep command exists with its default,
    except --platform, which --device replaces."""
    from ldpc_tpu.cli import build_parser as ref_parser
    ref = vars(ref_parser().parse_args(["sweep"]))
    port = vars(cli.build_parser().parse_args(["sweep"]))
    ref.pop("platform")
    assert port.pop("device") == "cuda"
    assert port == ref


# the ids are the test's names from before the refusals named the module
# they waited for; since the mesh is ported, the first three cases are the
# refusals of mesh flags that name no world (tests/test_torch_mesh.py runs
# the worlds), the fourth the one flag still not ported
@pytest.mark.parametrize("flags,exc,match", [
    (["--mesh", "2"], SystemExit, "a mesh needs a world"),
    (["--num-processes", "2"], SystemExit,
     "requires --coordinator and --process-id"),
    (["--coordinator", "localhost:1234"], SystemExit,
     "require --num-processes"),
    (["--superbatches", "2"], NotImplementedError, "superbatching"),
], ids=["flags0-item 16", "flags1-item 16", "flags2-item 16",
        "flags3-superbatching"])
def test_cli_refuses_unported_flags(flags, exc, match):
    with pytest.raises(exc, match=match):
        cli.main(["sweep", "--preset", "wifi-648-r12-minsum",
                  "--device", "cpu"] + flags)


def test_cli_imports_no_jax():
    """The port's CLI reuses ldpc_tpu.cli's config builder, whose module
    imports only ldpc_tpu.config: importing it loads no jax module."""
    code = (
        "import sys\n"
        "before = {m for m in sys.modules if m.split('.')[0] == 'jax'}\n"
        "import ldpc_tpu.cli, ldpc_tpu_torch.cli\n"
        "after = {m for m in sys.modules if m.split('.')[0] == 'jax'}\n"
        "print(sorted(after - before))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_mc_fer_agrees_with_recorded_fused_waterfall():
    """The megakernel's plain version at 2.0 dB, 2,048 frames, on the CPU:
    FER inside the 99% Wilson interval of results/wifi648_fused_mc.json
    (the TPU megakernel's own run; a different random family, so the
    comparison is statistical)."""
    cfg = PRESETS["wifi-648-r12-minsum"]
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                           rng="device"))
    s = Sweep(cfg, device="cpu", batch=1024)
    assert s.run_batch.mc
    minsum.reset_counters()
    p = s.run([2.0], target_frame_errors=10 ** 9, max_frames=2048).points[0]
    assert p.frames == 2048 and minsum.plain_calls == 2
    with open(os.path.join(ROOT, "results", "wifi648_fused_mc.json")) as f:
        ref = {r["ebn0_db"]: r for r in json.load(f)["results"]}[2.0]
    assert rates_compatible(p.frame_errs, p.frames, ref["frame_errs"],
                            ref["frames"])
    assert p.iter_sum == 20 * 2048
