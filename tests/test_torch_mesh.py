"""The port's process mesh (ldpc_tpu_torch.parallel; the mesh plumbing of
sim/pipeline.py, sim/sweep.py, sim/impsamp.py and the CLI) on the CPU,
over gloo.

Worlds of 2 and 4 ranks are spawned processes that meet at a file store
in the test's tmp_path; each runs a job of this module (`_job_*`), and
every rank's result must be the same. The contract is the reference's
(tests/test_sim.py:45, :62, tests/test_mesh_backends.py:53-138): the same
seed gives the same integer counters at every mesh size and shape
(tolerance 0), and the importance sampler's sums agree within rtol 1e-6
with its raw counts exact. A world of one rank equals the run without a
mesh bit for bit. Against the JAX package: the errors of `make_mesh` and
`shard_lanes`, `batch_multiple`, and the statistics of a fused sweep
(Wilson intervals for FER, the per-frame z-test for BER)."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ldpc_tpu_torch import cli
from ldpc_tpu_torch.codes import build_code, from_reference
from ldpc_tpu_torch.config import (ChannelConfig, CodeConfig, DecoderConfig,
                                   QuantConfig, RunConfig, SimConfig)
from ldpc_tpu_torch.kernels import minsum
from ldpc_tpu_torch.ops import rng as prng
from ldpc_tpu_torch.parallel import (batch_multiple, init_distributed,
                                     make_mesh, pick_backend, shard_lanes)
from ldpc_tpu_torch.parallel.mesh import gather_hosts, host_layout
from ldpc_tpu_torch.sim import Sweep, make_run_batch
from ldpc_tpu_torch.sim.sweep import batch_seed

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 32                   # the jobs' global batch: 8 lanes a rank at W = 4
SEED = 5

WORKER = r"""
import importlib.util, json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from ldpc_tpu_torch.parallel import exit_process, init_distributed, make_mesh
a = json.loads(sys.argv[2])
spec = importlib.util.spec_from_file_location("mesh_jobs", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
init_distributed("file://" + a["store"], a["world"], a["rank"],
                 device="cpu")
try:
    shape = None if a["shape"] is None else tuple(a["shape"])
    mesh = make_mesh(shape, tuple(a["axes"]), device="cpu")
    out = getattr(mod, a["job"])(mesh, **a["kw"])
    with open(a["out"], "w") as f:
        json.dump(out, f)
finally:
    dist.destroy_process_group()
exit_process(0)
"""


def run_world(tmp_path, job, world, shape=None, axes=("batch",),
              timeout=180, **kw):
    """Every rank's result of job(mesh, **kw) in a spawned world of
    `world` ranks (mesh `shape` on `axes`, flat when None); any rank's
    failure fails the test."""
    d = tmp_path / f"world-{job}-{world}-{shape}"
    d.mkdir()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        a = dict(store=str(d / "store"), world=world, rank=r, job=job,
                 shape=shape, axes=list(axes), kw=kw,
                 out=str(d / f"rank{r}.json"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, os.path.abspath(__file__),
             json.dumps(a)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errors.append(f"rank {r}: exit {p.returncode}\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    outs = [json.load(open(d / f"rank{r}.json")) for r in range(world)]
    lanes = [o.pop("lanes", None) if isinstance(o, dict) else None
             for o in outs]
    for r, o in enumerate(outs[1:], 1):
        assert o == outs[0], f"rank {r} disagrees with rank 0"
    if lanes[0] is not None:
        local = B // world
        assert lanes == [[r * local, local] for r in range(world)]
    return outs[0]


# ---------------------------------------------------------------------------
# Configurations and jobs (run in the spawned ranks and, with mesh=None, in
# this process)
# ---------------------------------------------------------------------------

def _cfg(rng="host", **over):
    """The toy Z=8 code (n=48), 8-bit min-sum flooding at 20 fixed
    iterations; `over` replaces fields section by section."""
    cfg = SimConfig(
        code=CodeConfig(family="toy", Z=8),
        channel=ChannelConfig(modulation="bpsk"),
        quant=QuantConfig(bits=8, scale=4.0, beta_lsb=0),
        decoder=DecoderConfig(algorithm="min-sum", schedule="flooding",
                              max_iter=20, early_term=False),
        run=RunConfig(batch=B, seed=SEED, target_frame_errors=20,
                      max_frames=256, rng=rng))
    for section, fields in over.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **fields)})
    return cfg


OMS_ET = dict(algorithm="offset-min-sum", schedule="layered", early_term=True)
CASES = {   # name -> (config, n_points, sigma or sigmas)
    "host batch last": (_cfg(), 1, 0.8),
    "host batch last, 16-QAM layered ET": (_cfg(
        channel=dict(modulation="16qam"), decoder=OMS_ET,
        quant=dict(beta_lsb=2)), 1, 0.55),
    "batch first, rate matched": (_cfg(
        code=dict(punct_frac=0.25), decoder=OMS_ET,
        quant=dict(beta_lsb=2)), 1, 0.7),
    "fused two points": (_cfg(), 2, (0.7, 0.95)),
    "two-phase ET": (_cfg(decoder=dict(OMS_ET, phase1_iters=2,
                                       phase2_frac=0.5),
                          quant=dict(beta_lsb=2)), 1, 0.9),
    "two-phase ET, batch first": (_cfg(
        code=dict(punct_frac=0.25), decoder=dict(OMS_ET, phase1_iters=2,
                                                 phase2_frac=0.5),
        quant=dict(beta_lsb=2)), 1, 0.8),
    "device RNG": (_cfg(rng="device"), 1, 0.8),
    "device RNG, fused": (_cfg(rng="device"), 2, (0.7, 0.95)),
}


def _draw(cfg, b):
    """Batch b's random source for the step of cfg."""
    seed = batch_seed(SEED, 0, b)
    if cfg.run.rng == "device":
        return seed
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _injected(cfg, rb):
    """Global draws of batch 0 from a numpy seed, in the step's shapes."""
    from ldpc_tpu_torch.ops.channel import BITS_PER_SYM
    code = build_code(cfg)
    r = np.random.default_rng(11)
    m = BITS_PER_SYM[cfg.channel.modulation]
    n_tx = code.n - len(code.punct_vns)

    def normal(*shape):
        return torch.as_tensor(r.standard_normal(shape), dtype=torch.float32)

    if rb.transposed:
        return dict(info_t=torch.as_tensor(r.integers(0, 2, (code.k, B)),
                                           dtype=torch.uint8),
                    noise=normal(code.n, B) if m == 1
                    else normal(code.n // m, 2, B))
    return dict(info=torch.as_tensor(r.integers(0, 2, (B, code.k)),
                                     dtype=torch.uint8),
                noise=normal(B, n_tx) if m == 1 else normal(B, n_tx // m, 2))


def _job_counters(mesh):
    """Each case's counters of two batches, and of one batch on injected
    global draws (host chains); the step's label and lanes."""
    out = {}
    for name, (cfg, n_points, sigma) in CASES.items():
        ct = from_reference(build_code(cfg), "cpu")
        rb = make_run_batch(ct, cfg, batch=B, n_points=n_points, mesh=mesh)
        sig = np.asarray(sigma, np.float32)
        got = [rb(_draw(cfg, b), sig).tolist() for b in range(2)]
        if not rb.mc:
            got.append(rb(None, sig, **_injected(cfg, rb)).tolist())
        out[name] = {"counters": got, "label": rb.backend_label}
    if mesh is not None:
        out["lanes"] = list(shard_lanes(mesh, B))
        out["batch_multiple"] = batch_multiple(mesh, 4)
        errors = []
        for shape in ((3,), (mesh.size() + 1,)):
            try:
                make_mesh(shape, device="cpu")
            except ValueError as e:
                errors.append(str(e))
        try:
            shard_lanes(mesh, 4 * mesh.size() + 1)
        except ValueError as e:
            errors.append(str(e))
        out["errors"] = errors
    return out


def _job_sweeps(mesh, checkpoint=None):
    """Sweep.run (AUTO two-phase: the tuner's choice from rank 0),
    Sweep.run_fused with device RNG, and a checkpointed run cut short."""
    def rows(res):
        return [[p.ebn0_db, p.frames, p.bit_errs, p.frame_errs, p.iter_sum,
                 p.converged, p.batches] for p in res.points]

    auto = Sweep(_cfg(decoder=dict(OMS_ET, phase1_iters=-1),
                      quant=dict(beta_lsb=2)), device="cpu", mesh=mesh)
    out = {"auto": rows(auto.run([1.0, 4.0])),
           "auto_choice": [list(auto.auto_choice[i]) for i in range(2)],
           "fused": rows(Sweep(_cfg(rng="device"), device="cpu",
                               mesh=mesh).run_fused([1.0, 3.0]))}
    if checkpoint:
        cut = Sweep(_cfg(), device="cpu", checkpoint_path=checkpoint,
                    mesh=mesh).run([2.0], max_frames=3 * B)
        out["cut"] = rows(cut)
    return out


def _is_runs(mesh):
    from ldpc_tpu_torch.sim.impsamp import (_apportion, estimate_fer,
                                            make_is_run, make_symmetric_run)
    cfg = _cfg(decoder=OMS_ET, quant=dict(beta_lsb=2),
               run=dict(all_zeros=True))
    code = build_code(cfg)
    sets = [[0, 3, 9], [1, 4], [17, 20, 30]]
    plain = make_is_run(code, cfg, sets, delta=1.5, pi0=0.5, batch=B,
                        device="cpu", mesh=mesh)
    strat = make_is_run(code, cfg, sets, delta=[1.2, 1.5, 2.0], pi0=0.25,
                        batch=B, device="cpu", mesh=mesh, stratify=True)
    sym = make_symmetric_run(code, cfg, [[0, 3, 9], [1, 4]], delta=1.5,
                             pi0=0.25, batch=B, device="cpu", mesh=mesh)
    counts = torch.as_tensor(_apportion(strat.pis, B, 2))
    return code, cfg, sets, plain, strat, sym, counts, estimate_fer


def _job_is(mesh):
    """Two batches of each IS run at 0.8, stacked sums; estimate_fer."""
    code, cfg, sets, plain, strat, sym, counts, estimate_fer = _is_runs(mesh)
    out = {}
    for name, run, extra in (("plain", plain, ()),
                             ("stratified", strat, (counts,)),
                             ("symmetric", sym, ())):
        out[name] = [run(_draw(cfg, b), 0.8, *extra).tolist()
                     for b in range(2)]
    est = estimate_fer(code, cfg, sets, 4.0, frames=3 * B, delta=1.5,
                       pi0=0.5, batch=B, run=plain, device="cpu")
    out["estimate"] = [est.fer, est.rel_std, est.frames, est.raw_hits,
                       est.ber]
    out["lanes"] = [plain.lane0, plain.local_batch]
    return out


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def no_mesh():
    return _job_counters(None)


@pytest.fixture(scope="module")
def counters_at(tmp_path_factory):
    """_job_counters over a spawned world, each world spawned once."""
    cache = {}

    def at(world, shape=None, axes=("batch",)):
        key = (world, shape)
        if key not in cache:
            cache[key] = run_world(tmp_path_factory.mktemp("w"),
                                   "_job_counters", world, shape, axes)
        return dict(cache[key])
    return at


def test_world_of_one_equals_no_mesh_bit_for_bit(tmp_path, no_mesh):
    """A world of one rank (spawned, gloo, a file store) == the run
    without a mesh, bit for bit."""
    got = run_world(tmp_path, "_job_counters", 1)
    assert got.pop("batch_multiple") == 4
    assert got.pop("errors") == ["mesh shape (3,) != 1 devices",
                                 "mesh shape (2,) != 1 devices"]
    assert got == no_mesh
    assert all(sum(c[2] if isinstance(c[2], int) else sum(c[2])
                   for c in v["counters"]) > 0 for v in got.values()), \
        "every case sees frame errors: the comparison is live"
    assert no_mesh["device RNG"]["label"].endswith("-mc")
    assert no_mesh["device RNG, fused"]["label"].endswith("-mc")
    assert no_mesh["two-phase ET"]["label"].endswith("-2phase")
    assert no_mesh["two-phase ET, batch first"]["label"].endswith("-2phase")


@pytest.mark.parametrize("world,shape,axes", [
    (2, None, ("batch",)), (4, None, ("batch",)), (4, (2, 2), ("dcn", "ici"))],
    ids=["W2", "W4", "2x2"])
def test_counters_equal_at_every_mesh(counters_at, no_mesh, world, shape,
                                     axes):
    """Host RNG batch last (BPSK, 16-QAM), batch first with rate matching,
    the fused two points, two-phase ET (both forms), the device-RNG plain
    stage (scalar and per-lane sigma; lane0), and injected global draws:
    equal counters at W = 2, 4 and 2x2 to the run without a mesh."""
    got = counters_at(world, shape, axes)
    assert got.pop("batch_multiple") == 4 * world
    errors = got.pop("errors")
    assert errors == [f"mesh shape (3,) != {world} devices",
                      f"mesh shape ({world + 1},) != {world} devices",
                      f"batch {4 * world + 1} not divisible by mesh size "
                      f"{world}"]
    assert got == no_mesh


def test_mesh_errors_and_batch_multiple_match_the_reference(counters_at):
    """The messages of `make_mesh` and of an indivisible batch, and
    `batch_multiple`, equal the JAX package's on as many fake devices as
    the world has ranks (the port's W = 2 values come from a spawned
    world)."""
    import jax

    from ldpc_tpu.parallel import batch_multiple as ref_multiple
    from ldpc_tpu.parallel import make_mesh as ref_make_mesh
    world = 2
    devs = jax.devices()[:world]
    want = []
    for shape in ((3,), (world + 1,)):
        with pytest.raises(ValueError) as e:
            ref_make_mesh(shape=shape, devices=devs)
        want.append(str(e.value))
    ref_mesh = ref_make_mesh(devices=devs)
    want.append(f"batch {4 * world + 1} not divisible by mesh size "
                f"{ref_mesh.size}")
    got = counters_at(world)
    assert got["errors"] == want
    assert got["batch_multiple"] == ref_multiple(ref_mesh, 4)


def test_indivisible_batch_matches_the_reference_message():
    """The reference's own refusal of a batch its mesh does not divide."""
    import jax

    from ldpc_tpu.config import PRESETS
    from ldpc_tpu.parallel import make_mesh as ref_make_mesh
    from ldpc_tpu.sim import build_code as ref_build_code
    from ldpc_tpu.sim import make_run_batch as ref_run_batch
    cfg = PRESETS["wifi-648-r12-minsum"]
    mesh = ref_make_mesh(devices=jax.devices()[:2])
    with pytest.raises(ValueError) as e:
        ref_run_batch(ref_build_code(cfg), cfg, batch=9, mesh=mesh,
                      decoder_backend="jnp")
    assert str(e.value) == "batch 9 not divisible by mesh size 2"


def test_sweeps_and_checkpoint_at_two_ranks(tmp_path):
    """Sweep.run with AUTO two-phase and Sweep.run_fused with device RNG
    over two ranks == without a mesh; a checkpoint written at W = 2
    (rank 0 writes) resumes at W = 1 to the uninterrupted run's counters."""
    path = str(tmp_path / "state.json")
    got = run_world(tmp_path, "_job_sweeps", 2, checkpoint=path)
    want = _job_sweeps(None)
    assert got["auto"] == want["auto"]
    assert got["auto_choice"] == want["auto_choice"]
    assert got["fused"] == want["fused"]
    assert got["cut"][0][1] == 3 * B
    meta = json.load(open(path))["meta"]
    assert meta["batch"] == B and "mesh" not in json.dumps(meta)
    resumed = Sweep(_cfg(), device="cpu", checkpoint_path=path).run([2.0])
    full = Sweep(_cfg(), device="cpu").run([2.0])
    r, f = resumed.points[0], full.points[0]
    assert (r.frames, r.bit_errs, r.frame_errs, r.iter_sum, r.converged,
            r.batches) == (f.frames, f.bit_errs, f.frame_errs, f.iter_sum,
                           f.converged, f.batches)
    assert f.frames > 3 * B


def test_is_runs_at_two_ranks(tmp_path):
    """make_is_run (multinomial and stratified, strata spanning ranks) and
    make_symmetric_run over two ranks: raw counts exact, weighted sums
    within rtol 1e-6 of one device (tests/test_mesh_backends.py:97);
    estimate_fer the same."""
    got = run_world(tmp_path, "_job_is", 2)
    want = _job_is(None)
    want.pop("lanes")
    for name in ("plain", "stratified", "symmetric"):
        g, w = np.asarray(got[name]), np.asarray(want[name])
        raw = 2
        np.testing.assert_array_equal(g[:, raw], w[:, raw])
        np.testing.assert_allclose(g, w, rtol=1e-6)
        assert w[:, raw].sum() > 0, f"{name}: raw hits: the test is live"
    g, w = got["estimate"], want["estimate"]
    assert g[2:4] == w[2:4]
    np.testing.assert_allclose([g[0], g[1], g[4]], [w[0], w[1], w[4]],
                               rtol=1e-6)


def test_cli_sweep_two_processes_prints_rank0s_result(tmp_path):
    """`sweep --num-processes 2 --coordinator ... --process-id i`: rank 0
    prints the CSV, rank 1 nothing; equal to one process; every rank's
    stderr names its lanes."""
    argv = ["sweep", "--family", "toy", "--Z", "8", "--device", "cpu",
            "--batch", "16", "--ebn0", "1.0,2.5", "--max-frames", "64",
            "--seed", "4"]
    rcs, outs = cli_world(tmp_path / "clistore", [argv, argv])
    assert rcs == [0, 0], outs[0][1] + outs[1][1]
    assert outs[1][0] == ""
    for r, (_, err) in enumerate(outs):
        assert f"# rank {r} of 2 (gloo, mesh (2,)): lanes [{8 * r}, " \
               f"{8 * r + 8})" in err
    one = _one_process(argv)
    assert _csv_counters(outs[0][0]) == one
    assert len(one) == 2


def test_cli_resume_two_processes_with_their_own_out(tmp_path):
    """Two ranks, each with its own --out (so its own default checkpoint
    <out>.state), cut short by --max-frames and rerun with a larger one:
    rank 0 alone reads its checkpoint and hands the state to rank 1, and
    the resumed run's counters equal one process's uninterrupted run. A
    rerun whose batch differs from the checkpoint's is refused on both
    ranks (rank 0's refusal reaches rank 1; no rank waits for it)."""
    base = ["sweep", "--family", "toy", "--Z", "8", "--device", "cpu",
            "--batch", "16", "--ebn0", "1.0,2.5", "--seed", "4",
            "--target-errors", "100000"]

    def argvs(frames, batch=16):
        return [base + ["--max-frames", str(frames), "--batch", str(batch),
                        "--out", str(tmp_path / f"rank{r}")]
                for r in range(2)]

    rcs, outs = cli_world(tmp_path / "cut", argvs(32))
    assert rcs == [0, 0], outs[0][1] + outs[1][1]
    assert os.path.exists(tmp_path / "rank0.state")
    assert not os.path.exists(tmp_path / "rank1.state")
    rcs, outs = cli_world(tmp_path / "resumed", argvs(96))
    assert rcs == [0, 0], outs[0][1] + outs[1][1]
    want = _one_process(base + ["--max-frames", "96"])
    assert _csv_counters(open(tmp_path / "rank0.csv").read()) == want
    assert not os.path.exists(tmp_path / "rank1.csv")
    assert [int(r["frames"]) for r in want] == [96, 96]
    rcs, outs = cli_world(tmp_path / "refused", argvs(128, batch=32))
    assert rcs[0] != 0 and rcs[1] != 0
    for _, err in outs:
        assert "resume requires the same batch" in err


def cli_world(store, argvs, timeout=180):
    """(exit codes, (stdout, stderr) of each rank) of `python -m
    ldpc_tpu_torch.cli` run as a world of len(argvs) processes that meet
    at the file `store`, rank r with argvs[r]."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    n = len(argvs)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ldpc_tpu_torch.cli", *argv,
         "--num-processes", str(n), "--coordinator", f"file://{store}",
         "--process-id", str(r)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r, argv in enumerate(argvs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _csv_counters(text):
    """The CSV's rows without the host-clock columns."""
    import csv
    import io
    return [{k: v for k, v in row.items() if k not in ("wall_s", "info_bps")}
            for row in csv.DictReader(io.StringIO(text))]


def _one_process(argv):
    """The CSV counters of cli.main(argv) in this process."""
    import contextlib
    import io
    one = io.StringIO()
    with contextlib.redirect_stdout(one):
        assert cli.main(argv) == 0
    return _csv_counters(one.getvalue())


def test_dryrun_multichip_two(tmp_path, monkeypatch):
    """`python -m ldpc_tpu_torch.parallel.dryrun --world 2 --device cpu`:
    the flagship step, the fused step and the streaming seam over a 1x2
    mesh, each == one device, on both ranks."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m",
                        "ldpc_tpu_torch.parallel.dryrun", "--world", "2",
                        "--device", "cpu", "--timeout", "150"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=200)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert lines[-1] == "dryrun_multichip(2) ok"
    ranks = [json.loads(x) for x in lines[:-1]]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["flagship"][0] == 16
    assert ranks[0]["labels"] == ["torch-plain",
                                  "torch-plain-stream-pipelined"]


def test_mc_plain_stage_counts_from_lane0():
    """The megakernel's plain stage at lane0 = L on B lanes == lanes
    [L, L + B) of the same stage from lane 0: the words are a function of
    (seed, global lane, word)."""
    cfg = _cfg(rng="device")
    ct = from_reference(build_code(cfg), "cpu")
    full = minsum.make_decoder(ct, cfg.decoder, cfg.quant, input_scale=4.0,
                               count_info_cols=ct.kb, mc_batch=24)
    part = minsum.make_decoder(ct, cfg.decoder, cfg.quant, input_scale=4.0,
                               count_info_cols=ct.kb, mc_batch=8)
    s, g = np.float32(0.9), np.float32(2 * 4.0 / 0.81)
    a = full(77, s, g)
    b = part(77, s, g, lane0=16)
    for x, y in zip(a, b):
        assert torch.equal(x[16:], y)
    w = prng.words(77, part.n_words, 8, "cpu", lane0=16)
    assert torch.equal(w, prng.words(77, part.n_words, 24, "cpu")[:, 16:])


def test_no_world_no_mesh():
    """make_mesh without a process group raises; so do init_distributed's
    half-given arguments and the CLI's mesh flags without a world."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(device="cpu")
    with pytest.raises(ValueError, match="together"):
        init_distributed("localhost:1", 2, None, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        init_distributed("localhost:1", 2, 2, device="cpu")
    with pytest.raises(SystemExit, match="world"):
        cli.main(["floor", "--device", "cpu", "--mesh", "2"])
    assert not dist.is_initialized()


def test_backend_rule(monkeypatch):
    """gloo on the CPU and where ranks share a card; NCCL where every
    rank has one."""
    assert pick_backend("cpu", 2)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pick_backend("cuda", 8) == (
        "gloo", "8 ranks share 1 card(s) of this host, which NCCL refuses")
    assert pick_backend("cuda", 1)[0] == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pick_backend("cuda", 4)[0] == "nccl"


def test_two_hosts_of_four_cards_take_nccl(monkeypatch):
    """multihost-qam-chain's deployment: eight ranks on two hosts of four
    cards each post their host name to the rendezvous store; each counts
    four ranks on its host, takes card 0-3 by its place among them, and
    NCCL. The same eight ranks on one host of one card take gloo."""
    import threading
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)

    def layouts(hosts):
        store = dist.HashStore()
        got = [None] * len(hosts)

        def rank(r):
            got[r] = host_layout(gather_hosts(store, r, len(hosts),
                                              hosts[r]), r)
        threads = [threading.Thread(target=rank, args=(r,))
                   for r in range(len(hosts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        return got

    two = layouts(["host-a"] * 4 + ["host-b"] * 4)
    assert two == [(r % 4, 4) for r in range(8)]
    assert {pick_backend("cuda", here) for _, here in two} == {
        ("nccl", "4 rank(s) on this host, each with a card of its own")}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    one = layouts(["host-a"] * 8)
    assert one == [(r, 8) for r in range(8)]
    assert pick_backend("cuda", 8)[0] == "gloo"


STATS_POINTS = (1.5, 2.5)
STATS_BATCH = 1024
STATS_FRAMES = 16384


def _job_stats(mesh):
    """A fused host-RNG toy sweep over the mesh: per point (frames,
    bit_errs, frame_errs)."""
    cfg = _cfg(run=dict(batch=STATS_BATCH))
    res = Sweep(cfg, device="cpu", mesh=mesh).run_fused(
        STATS_POINTS, target_frame_errors=10 ** 9, max_frames=STATS_FRAMES)
    return [[p.frames, p.bit_errs, p.frame_errs] for p in res.points]


@pytest.mark.slow
def test_fused_sweep_statistics_against_the_reference(tmp_path):
    """The port's fused toy sweep over two ranks against the JAX package's
    fused step over its 8 fake devices (`make_run_batch(mesh=make_mesh())`):
    FER inside each other's Wilson intervals (z = 2.576), BER by the
    per-frame z-test (sim/stats.mean_compatible) with the port's per-frame
    bit-error variance."""
    import jax

    from ldpc_tpu.codes.toy import toy_qc
    from ldpc_tpu.ops.channel import sigma_for
    from ldpc_tpu.parallel import make_mesh as ref_make_mesh
    from ldpc_tpu.sim.pipeline import make_run_batch as ref_run_batch
    from ldpc_tpu_torch.sim.pipeline import make_lane_step
    from ldpc_tpu_torch.sim.stats import mean_compatible, rates_compatible
    got = run_world(tmp_path, "_job_stats", 2, timeout=300)
    cfg = _cfg(run=dict(batch=STATS_BATCH))
    code = toy_qc(8)
    sig = np.asarray([sigma_for(e, code.rate, "bpsk") for e in STATS_POINTS],
                     np.float32)
    rb = ref_run_batch(code, cfg, batch=STATS_BATCH, mesh=ref_make_mesh(),
                       n_points=2, decoder_backend="jnp")
    ref = np.zeros((5, 2), np.int64)
    for b in range(2 * STATS_FRAMES // STATS_BATCH):
        ref += np.asarray(rb(jax.random.PRNGKey(100 + b), sig), np.int64)
    ct = from_reference(build_code(cfg), "cpu")
    bits, _, _, _ = make_lane_step(ct, cfg, batch=STATS_BATCH, n_points=2)(
        _draw(cfg, 0), sig)
    per_frame = bits.double().reshape(-1, 2)
    for i, (frames, bit_e, frame_e) in enumerate(got):
        assert frames == STATS_FRAMES == ref[0, i]
        assert frame_e > 0 and ref[2, i] > 0
        assert rates_compatible(frame_e, frames, int(ref[2, i]), frames)
        assert mean_compatible(bit_e, frames, float(ref[1, i]), frames,
                               float(per_frame[:, i].var()))
