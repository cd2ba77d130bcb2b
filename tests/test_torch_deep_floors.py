"""The deep floors that `chip_smoke.py`'s slice 11a runs on the card, on the
CPU, against the JAX package: the configurations the floor scripts build
(scripts/make_wifi_floor_sym.py, diag_dvb_mc_deep.py, make_dvb_floor_r5.py)
and the CLI flags that give `results/nr_floor_sym.json`'s header; the
proposals (`sim/floor_proposals.py`): the wifi-648 absorbing-orbit cover
equals the reference census's as a set, the DVB-S2 proposal the
reference's 109 orbits in order; `make_symmetric_run`'s tally on the JAX
run's own draws on NR BG1 Z=128 rate 1/3 (punctured, a 128-fold orbit) and
on DVB-S2 n=64,800 batch first (B = 2, two iterations, the whole DVB-S2
proposal): raw counts exactly, weighted sums within rtol 1e-5 (XLA's matmul
and logsumexp differ in the last bits); the counting rule of the DVB-S2
summary; and the holds (pooled seeds, `floor_z`, Wilson at the family-wise
z) on synthetic numbers and on the files' own."""
import ctypes
import dataclasses
import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.config as rcfg
from ldpc_tpu.analysis.asenum import enumerate_sets as ref_enumerate_sets
from ldpc_tpu.codes.dvbs2 import make_code as rmake_dvb
from ldpc_tpu.codes.ieee80211n import make_code as rmake_wifi
from ldpc_tpu.sim import impsamp as rimp
from ldpc_tpu.sim.sweep import build_code as ref_build_code
import ldpc_tpu_torch as port
from ldpc_tpu_torch import cli
from ldpc_tpu_torch.analysis import asenum as pasenum
from ldpc_tpu_torch.codes import build_code, config_from_reference
from ldpc_tpu_torch.sim import impsamp as pimp
from ldpc_tpu_torch.sim.floor_proposals import (absorbing_orbit_cover,
                                                harvested_orbit_reps)
from ldpc_tpu_torch.sim.stats import rates_compatible
from ldpc_tpu_torch.utils.native import omp_threads

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()


def omp_max_threads():
    """The OpenMP runtime's thread count, which the census libraries of
    both packages share."""
    getter = pasenum._lib().omp_get_max_threads
    getter.restype = ctypes.c_int
    return getter()


def _result(name):
    with open(os.path.join(ROOT, "results", name)) as f:
        return json.load(f)


def _script_config(algorithm, beta_lsb, **code):
    """The floor scripts' SimConfig: 8 bits at scale 4, layered, early
    termination, 20 iterations (NMS with alpha 3/4, as
    make_wifi_floor_sym.py spells it)."""
    quant = rcfg.QuantConfig(bits=8, scale=4.0, beta_lsb=beta_lsb)
    if algorithm == "normalized-min-sum":
        quant = rcfg.QuantConfig(bits=8, scale=4.0, beta_lsb=0, alpha_num=3,
                                 alpha_shift=2)
    return rcfg.SimConfig(code=rcfg.CodeConfig(**code), quant=quant,
                          decoder=rcfg.DecoderConfig(
                              algorithm=algorithm, max_iter=20,
                              schedule="layered", early_term=True))


def test_floor_configurations_equal_the_scripts():
    for _, algorithm, beta in CS.WIFI_SYM["algs"]:
        assert CS.wifi_sym_config(port, algorithm, beta) == \
            config_from_reference(_script_config(algorithm, beta))
    dvb = _script_config("offset-min-sum", 2, family="dvbs2", n=64800,
                         rate="1/2")
    got = CS.dvb_floor_config(port)
    assert got == config_from_reference(dvb)
    assert build_code(got).name == ref_build_code(dvb).name


def test_nr_cli_flags_give_the_files_configuration():
    """`floor --symmetric`'s flags in NR_SYM build the file's header, and
    its --frames in whole batches are the file's frames a seed."""
    args = cli.build_parser().parse_args(CS.NR_SYM["argv"])
    got = cli._run_config(args)
    assert got == CS.recorded_config(port, CS.NR_SYM["ref"])
    doc = _result(CS.NR_SYM["ref"])
    nb = -(-args.frames // args.batch)
    assert {r["frames"] for p in doc["points"] for r in p["seeds"]} == {
        nb * args.batch}
    assert [float(x) for x in args.delta.split(",")] == \
        doc["proposal"]["delta"]
    assert (args.pi0, args.seeds, args.symmetric) == (
        doc["proposal"]["pi0"], "61,62", True)
    a = doc["mc_anchors"]
    assert [round(a[str(e)]["fer"] * a[str(e)]["frames"])
            for e in CS.NR_SYM["mc_points"]] == [32, 4]
    assert {a[str(e)]["frames"] for e in CS.NR_SYM["mc_points"]} == {
        CS.NR_SYM["mc_frames"]}
    assert CS.NR_SYM["mc_frames"] % CS.NR_SYM["mc_batch"] == 0


@pytest.mark.parametrize("a_max", [
    6, pytest.param(8, marks=pytest.mark.slow, id="8-the-scripts-call")])
def test_wifi_orbit_cover_equals_the_reference(a_max):
    """The census call of scripts/make_wifi_floor_sym.py:33-45 on one
    thread (a_max 8, about 10 s a package; a_max 6 the fast case),
    canonical rotations of its absorbing sets, as a set; the port's call
    leaves the thread count as it found it. The reference's call, which
    sets the count for the process, is scoped by the port's `omp_threads`
    (both libraries share the OpenMP runtime)."""
    code, ref = build_code(port.SimConfig()), rmake_wifi(648, "1/2")
    env = os.environ.get("OMP_NUM_THREADS")
    before = omp_max_threads()
    got = absorbing_orbit_cover(code, a_max=a_max)
    assert (omp_max_threads(), os.environ.get("OMP_NUM_THREADS")) == (
        before, env)
    with omp_threads(pasenum._lib(), 1):
        r = ref_enumerate_sets(ref, a_max=a_max, b_max=3, dv_cap=3,
                               emit_min_a=5, emit_cap=16384, threads=1)
    want = {rimp.canonical_rotation(ref, S) for (_, _, f, S) in r.sets if f}
    assert set(got) == want and len(got) == len(want) > 0
    assert got == sorted(got)


def test_dvb_proposal_equals_the_reference():
    """scripts/make_dvb_floor_r5.py:57-100 with the reference's functions
    against `harvested_orbit_reps`: the same 109 orbits in the same order,
    327 components at the three depths."""
    mc, census = _result(CS.DVB_FLOOR["mc_deep"]), _result(
        CS.DVB_FLOOR["census"])
    ref = rmake_dvb(n=64800, rate="1/2")
    want, seen = [], set()
    for pt in mc["points"]:
        for s in pt["supports"]:
            if s["n_info"] > 0 and 1 <= s["size"] <= 48:
                c = rimp.canonical_rotation(ref, s["support"])
                if c not in seen:
                    seen.add(c)
                    want.append(c)
    c = rimp.canonical_rotation(ref, census["example_73_sets"][0])
    if c not in seen:
        want.append(c)
    code = build_code(CS.dvb_floor_config(port))
    got = harvested_orbit_reps(code, mc["points"],
                               census["example_73_sets"][:1])
    assert got == want
    x, d = pimp.expand_radial(got, CS.DVB_FLOOR["depths"])
    assert (len(got), len(x)) == (CS.DVB_FLOOR["reps"],
                                  CS.DVB_FLOOR["components"])
    assert len(set(got)) == len(got)


def _jax_draws(key, n_ch, B, K, pi0):
    """(eps, comp) of one JAX IS batch, as its run draws them (see
    tests/test_torch_impsamp.py)."""
    kc, kn = jax.random.split(key)
    eps = np.array(jax.random.normal(kn, (B, n_ch), jnp.float32))
    log_pi = jnp.log(jnp.concatenate(
        [jnp.asarray([pi0], jnp.float32),
         jnp.full((K,), (1.0 - pi0) / K, jnp.float32)]))
    comp = jax.random.categorical(kc, jnp.broadcast_to(log_pi, (B, K + 1)),
                                  axis=-1)
    return torch.as_tensor(eps), torch.as_tensor(np.array(comp))


def _nr_case():
    """NR BG1 Z=128 rate 1/3 (the file's header, four iterations): five
    random supports on transmitted positions, canonicalized, at three
    depths."""
    cfg = rcfg.SimConfig.from_json(json.dumps(_result(
        CS.NR_SYM["ref"])["config"]))
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, max_iter=4))
    code = ref_build_code(cfg)
    tx, _ = rimp._rate_match(code)
    rng = np.random.default_rng(12)
    sets = [sorted(rng.choice(tx, int(rng.integers(2, 6)),
                              replace=False).tolist()) for _ in range(5)]
    reps, deltas = rimp.expand_radial(
        sorted({rimp.canonical_rotation(code, s) for s in sets}),
        [1.2, 1.6, 2.0])
    return cfg, code, reps, deltas, 16, 1.25, 128


def _dvb_case():
    """DVB-S2 n=64,800 rate 1/2 batch first, B = 2, two iterations, the
    whole DVB-S2 proposal of slice 11a.4."""
    cfg = dataclasses.replace(_script_config(
        "offset-min-sum", 2, family="dvbs2", n=64800, rate="1/2"),
        decoder=rcfg.DecoderConfig(algorithm="offset-min-sum", max_iter=2,
                                   schedule="layered", early_term=True))
    code = ref_build_code(cfg)
    mc, census = _result(CS.DVB_FLOOR["mc_deep"]), _result(
        CS.DVB_FLOOR["census"])
    reps = harvested_orbit_reps(code, mc["points"],
                                census["example_73_sets"][:1])
    reps, deltas = rimp.expand_radial(reps, CS.DVB_FLOOR["depths"])
    return cfg, code, reps, deltas, 2, 0.9, 360


@pytest.mark.parametrize("case", [
    pytest.param(_nr_case, id="nr_bg1_z128_r13"),
    pytest.param(_dvb_case, marks=pytest.mark.slow, id="dvbs2_64800")])
def test_symmetric_tally_equals_the_jax_run(case):
    """NR BG1 Z=128 (about 6 s) is the fast case; DVB-S2 n=64,800 takes
    about 18 s (the JAX decoder's compile and the 327-row mean matrix)."""
    cfg, code, reps, deltas, B, sigma, fold = case()
    kw = dict(delta=deltas, pi0=0.25, batch=B)
    run_j = rimp.make_symmetric_run(code, cfg, reps, backend="jnp", **kw)
    run_p = pimp.make_symmetric_run(code, config_from_reference(cfg), reps,
                                    device="cpu", **kw)
    assert (run_p.K, run_p.orbit_multiplier, run_p.batch) == (
        run_j.K, fold, B)
    if fold == 128:
        assert len(code.punct_vns) == 2 * 128 and run_p.n_ch < code.n
    else:
        assert run_p.backend_label == "torch-plain-stream-pipelined-et"
    key = jax.random.PRNGKey(21)
    eps, comp = _jax_draws(key, run_p.n_ch, B, len(reps), 0.25)
    want = np.asarray(run_j(key, sigma), np.float64)
    got = run_p(None, sigma, eps=eps, comp=comp).numpy().astype(np.float64)
    assert want[2, -1] > 0 and got.shape == (4, len(reps) + 2)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_dvb_summary_counting_rule():
    """fails_info is the IS tally's raw count (a wrong information bit),
    fails_any a frame with any wrong bit (scripts/diag_dvb_mc_deep.py): a
    frame wrong in a parity bit alone counts in fails_any only."""
    code = rmake_wifi(648, "1/2")
    cfg = config_from_reference(_script_config("offset-min-sum", 2))
    run = pimp.make_is_run(code, cfg, [], batch=4, device="cpu")
    info = run.info_pos.numpy()
    parity = np.setdiff1d(np.arange(code.n), info)
    hard = torch.zeros((4, code.n), dtype=torch.uint8)
    hard[1, info[3]] = 1
    hard[2, parity[:5]] = 1
    hard[3, [info[0], parity[0]]] = 1
    sums = run.tally(hard, torch.ones(4), None)
    assert int(sums[2]) == 2 and int(hard.any(dim=1).sum()) == 3


def test_pooled_seeds_and_holds_on_synthetic_numbers():
    p = CS.pooled_seeds([{"fer": 2.0, "rel_std": 0.5},
                         {"fer": 4.0, "rel_std": 0.25}])
    assert p["fer"] == 3.0
    assert math.isclose(p["rel_std"] * 3.0, math.sqrt(2.0) / 2)
    # a seed with no hit adds nothing to the variance
    q = CS.pooled_seeds([{"fer": 0.0, "rel_std": float("inf")},
                         {"fer": 4.0, "rel_std": 0.5}])
    assert (q["fer"], q["rel_std"]) == (2.0, 0.5)
    assert CS.pooled_seeds([{"fer": 0.0, "rel_std": float("inf")}])[
        "rel_std"] is None
    a = {"fer": 1.0, "rel_std": 0.1}
    assert CS.floor_z(a, a) == 0.0
    assert CS.floor_z(a, {"fer": 1.0, "rel_std": None}) == float("inf")
    z4 = CS.family_z(4)
    assert round(z4, 3) == 3.023 and round(CS.family_z(2), 3) == 2.807
    # both standard errors 0.1: the difference's is 0.1 * sqrt(2)
    far, near = (1.0 + c * z4 * math.hypot(0.1, 0.1) for c in (1.01, 0.99))
    assert CS.floor_z(a, {"fer": far, "rel_std": 0.1 / far}) > z4 > \
        CS.floor_z(a, {"fer": near, "rel_std": 0.1 / near})
    z2 = CS.family_z(2)
    assert rates_compatible(32, 4_096_000, 60, 4_096_000, z2)
    assert not rates_compatible(32, 4_096_000, 90, 4_096_000, z2)


def test_the_files_rows_hold_against_themselves():
    """Each file's own numbers pass the holds the card applies: the wifi
    file's pooled seeds against themselves, the NR file's symmetric 1.2 dB
    row against its MC anchor at family_z(2), the DVB summary's 1.2 dB
    counts against themselves by Wilson intervals."""
    rows = _result(CS.WIFI_SYM["ref"])["rows"]
    for alg, _, _ in CS.WIFI_SYM["algs"]:
        for e in CS.WIFI_SYM["points"]:
            mine = [r for r in rows if r["alg"] == alg and r["ebn0_db"] == e]
            assert len(mine) == len(CS.WIFI_SYM["seeds"])
            assert {r["seed"] for r in mine} == set(CS.WIFI_SYM["seeds"])
            assert {r["frames"] for r in mine} == {CS.WIFI_SYM["frames"]}
            p = CS.pooled_seeds(mine)
            assert CS.floor_z(p, p) == 0.0 < p["rel_std"] < 1
    nr = _result(CS.NR_SYM["ref"])
    a = nr["mc_anchors"]["1.2"]
    anchor = {"fer": a["fer"], "rel_std": 1 / math.sqrt(
        round(a["fer"] * a["frames"]))}
    pt = next(p for p in nr["points"] if p["ebn0_db"] == 1.2)
    assert CS.floor_z(CS.pooled_seeds(pt["seeds"]), anchor) <= \
        CS.family_z(2)
    dvb = next(p for p in _result(CS.DVB_FLOOR["summary"])["points"]
               if p["ebn0_db"] == CS.DVB_FLOOR["ebn0"])
    assert dvb["frames"] == CS.DVB_FLOOR["frames"] == 976 * 1024
    assert CS.DVB_FLOOR["frames"] % CS.DVB_FLOOR["batch"] == 0
    assert (dvb["fails_info"], dvb["fails_any"]) == (93, 357)
