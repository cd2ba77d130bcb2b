"""The port's error-floor estimation (`ldpc_tpu_torch/sim/impsamp.py` and
the CLI's `floor`) against the JAX package's (`ldpc_tpu/sim/impsamp.py`,
`ldpc_tpu/cli.py`), on the CPU.

The JAX runs go through `backend="jnp"`, as `tests/test_trapping.py` runs
them. The port's runs take the JAX run's own draws: `eps` and `comp` are
rebuilt from the JAX key with `jax.random.split` / `normal` /
`categorical` and injected. Raw error counts are equal exactly (the hard
decisions are equal bit for bit: the LLRs are); the weighted sums differ
from XLA's in the last bits of the matmul and logsumexp and are held within
rtol 1e-5. Host-side pieces (rate matching, the radial ladder,
apportionment, rotations) are equal with tolerance 0."""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.config as rcfg
from ldpc_tpu.codes.ieee80211n import make_code as rmake_wifi
from ldpc_tpu.codes.toy import toy_qc as rtoy
from ldpc_tpu.sim import impsamp as rimp
from ldpc_tpu.sim.sweep import build_code as ref_build_code
from ldpc_tpu_torch import cli
from ldpc_tpu_torch.codes import config_from_reference, from_reference
from ldpc_tpu_torch.sim import impsamp as pimp
from ldpc_tpu_torch.sim import make_run_batch

torch.set_num_threads(2)

B = 256


def _cfg(**dec):
    """The floor's configuration (scripts/make_error_floor.py): 8-bit NMS,
    layered, early termination; fewer iterations for the CPU."""
    return rcfg.SimConfig(
        quant=rcfg.QuantConfig(bits=8, scale=4.0, beta_lsb=0),
        decoder=rcfg.DecoderConfig(**{**dict(
            algorithm="normalized-min-sum", max_iter=10,
            schedule="layered"), **dec}))


@pytest.fixture(scope="module")
def wifi():
    return rmake_wifi(648, "1/2")


@pytest.fixture(scope="module")
def toy():
    return rtoy(8)


@pytest.fixture(scope="module")
def punctured():
    """802.11n n=648 with 81 parity bits punctured and 27 info bits
    shortened: both rate-matching rules at once."""
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, code=dataclasses.replace(
        cfg.code, punct_frac=81 / 648, shorten_bits=27))
    return cfg, ref_build_code(cfg)


def _n_ch(code):
    tx, _ = rimp._rate_match(code)
    return code.n if tx is None else len(tx)


@jax.jit
def _normal(key, shape_like):
    return jax.random.normal(key, shape_like.shape, jnp.float32)


def _jax_draws(key, code, K=0, pi0=0.25):
    """(eps, comp) of one JAX IS batch, as its run draws them: split the
    key into (kc, kn); eps ~ normal(kn); comp ~ categorical(kc, log_pi)."""
    kc, kn = jax.random.split(key)
    eps = np.array(_normal(kn, np.zeros((B, _n_ch(code)), np.float32)))
    if not K:
        return torch.as_tensor(eps), None
    log_pi = jnp.log(jnp.concatenate(
        [jnp.asarray([pi0], jnp.float32),
         jnp.full((K,), (1.0 - pi0) / K, jnp.float32)]))
    comp = jax.jit(lambda k: jax.random.categorical(
        k, jnp.broadcast_to(log_pi, (B, K + 1)), axis=-1))(kc)
    return torch.as_tensor(eps), torch.as_tensor(np.array(comp))


def _hold(got, want):
    """Raw counts (row 2) exactly; the weighted rows within rtol 1e-5."""
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _ladder(code, rng, n_sets=6):
    sets = [sorted(rng.choice(code.n, size=int(rng.integers(3, 9)),
                              replace=False).tolist())
            for _ in range(n_sets)]
    return rimp.expand_radial(sets, [1.2, 2.0])


# ---------------------------------------------------------------------------
# Host-side pieces: tolerance 0
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["wifi", "punctured"])
def test_rate_match_equals_the_reference(which, request):
    code = request.getfixturevalue(which)
    code = code[1] if isinstance(code, tuple) else code
    got, want = pimp._rate_match(code), rimp._rate_match(code)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which", ["wifi", "punctured"])
def test_assemble_llr_equals_the_reference(which, request, rng):
    code = request.getfixturevalue(which)
    code = code[1] if isinstance(code, tuple) else code
    tx, sh = rimp._rate_match(code)
    if tx is not None:
        assert sh is not None and len(tx) < code.n
    sigma = np.float32(0.83)
    z = (sigma * rng.standard_normal((B, _n_ch(code)))).astype(np.float32)
    want = np.asarray(rimp._assemble_llr(jnp.asarray(z), sigma, code, tx, sh,
                                         B))
    got = pimp._assemble_llr(torch.as_tensor(z), sigma, code, tx, sh, B)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_expand_radial_apportion_and_rotation_equal_the_reference(toy, rng):
    sets = [rng.choice(toy.n, 4, replace=False).tolist() for _ in range(5)]
    for depths in ([2.0], [1.2, 1.6, 2.0, 2.4]):
        gs, gd = pimp.expand_radial(sets, depths)
        ws, wd = rimp.expand_radial(sets, depths)
        assert gs == ws and gd.dtype == wd.dtype
        np.testing.assert_array_equal(gd, wd)
    with pytest.raises(ValueError):
        pimp.expand_radial(sets, [])
    for _ in range(20):
        k = int(rng.integers(1, 40))
        pis = rng.random(k) ** 3
        total = int(rng.integers(k, 5000))
        got, want = pimp._apportion(pis, total), rimp._apportion(pis, total)
        assert got.dtype == want.dtype and got.sum() == total
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        pimp._apportion(np.ones(5), 4)
    for _ in range(20):
        s = rng.choice(toy.n, int(rng.integers(1, 6)), replace=False)
        assert (pimp.canonical_rotation(toy, s)
                == rimp.canonical_rotation(toy, s))


def test_mixture_log_weight_equals_the_reference(rng):
    n, K = 648, 40
    sigma = np.float32(0.8)
    M = ((rng.random((K, n)) < 0.01) * rng.choice([1.2, 2.0], (K, 1))
         ).astype(np.float32)
    sizes = (M ** 2).sum(axis=1).astype(np.float32)
    log_pi = np.log(np.concatenate([[0.25], np.full(K, 0.75 / K)])
                    ).astype(np.float32)
    z = (sigma * rng.standard_normal((B, n)) - M[rng.integers(0, K, B)]
         ).astype(np.float32)
    want = np.asarray(rimp.mixture_log_weight(
        jnp.asarray(z), jnp.asarray(M), jnp.asarray(sizes),
        jnp.asarray(log_pi), 1.0, sigma))
    got = pimp.mixture_log_weight(torch.as_tensor(z), torch.as_tensor(M),
                                  torch.as_tensor(sizes),
                                  torch.as_tensor(log_pi), 1.0, sigma)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert (got.numpy() <= -np.log(0.25) + 1e-5).all()


# ---------------------------------------------------------------------------
# One IS batch on the JAX run's own draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stratify", [False, True])
def test_is_run_equals_the_jax_run(wifi, stratify):
    rng = np.random.default_rng(3)
    sets, deltas = _ladder(wifi, rng)
    cfg = _cfg()
    kw = dict(delta=deltas, pi0=0.25, batch=B, stratify=stratify)
    run_j = rimp.make_is_run(wifi, cfg, sets, backend="jnp", **kw)
    run_p = pimp.make_is_run(wifi, config_from_reference(cfg), sets,
                             device="cpu", **kw)
    assert run_p.stratified == run_j.stratified == stratify
    assert run_p.n_comp == run_j.n_comp
    np.testing.assert_array_equal(run_p.pis, run_j.pis)
    assert run_p.backend_label == "torch-plain-layered-bf"
    counts = rimp._apportion(run_j.pis, B)
    for seed, sigma in ((0, 0.86), (1, 0.95)):
        key = jax.random.PRNGKey(seed)
        if stratify:
            want = run_j(key, sigma, jnp.asarray(counts))
            eps, _ = _jax_draws(key, wifi)
            got = run_p(None, sigma, counts, eps=eps)
        else:
            want = run_j(key, sigma)
            eps, comp = _jax_draws(key, wifi, len(sets))
            got = run_p(None, sigma, eps=eps, comp=comp)
        assert float(np.asarray(want)[2].sum()) > 0
        _hold(got, want)


def test_is_run_on_a_rate_matched_code_equals_the_jax_run(punctured):
    cfg, code = punctured
    rng = np.random.default_rng(4)
    sets, deltas = _ladder(code, rng, 4)
    # a set that lies in the punctured positions only: dropped by both
    sets = [list(map(int, code.punct_vns[:5]))] + list(sets)
    deltas = np.concatenate([[2.0], deltas]).astype(np.float32)
    kw = dict(delta=deltas, pi0=0.3, batch=B)
    with pytest.warns(UserWarning, match="dropped 1"):
        run_j = rimp.make_is_run(code, cfg, sets, backend="jnp", **kw)
    with pytest.warns(UserWarning, match="dropped 1"):
        run_p = pimp.make_is_run(code, config_from_reference(cfg), sets,
                                 device="cpu", **kw)
    assert run_p.n_comp == run_j.n_comp == len(sets)
    key = jax.random.PRNGKey(7)
    eps, comp = _jax_draws(key, code, len(sets) - 1, pi0=0.3)
    _hold(run_p(None, 0.9, eps=eps, comp=comp), run_j(key, 0.9))


@pytest.mark.parametrize("which", ["toy", "wifi"])
def test_symmetric_run_equals_the_jax_run(which, request):
    code = request.getfixturevalue(which)
    rng = np.random.default_rng(5)
    if which == "toy":
        reps, deltas = rimp.expand_radial([[0, 8], [16], [3, 20, 30]],
                                          [1.5, 2.0])
        sigma = 0.9
    else:
        sets, _ = _ladder(code, rng, 5)
        reps, deltas = rimp.expand_radial(
            sorted({rimp.canonical_rotation(code, s) for s in sets}),
            [1.2, 1.6, 2.0])
        sigma = 0.9
    cfg = _cfg()
    kw = dict(delta=deltas, pi0=0.5, batch=B)
    run_j = rimp.make_symmetric_run(code, cfg, reps, backend="jnp", **kw)
    run_p = pimp.make_symmetric_run(code, config_from_reference(cfg), reps,
                                    device="cpu", **kw)
    assert (run_p.K, run_p.orbit_multiplier, run_p.batch) == (
        run_j.K, run_j.orbit_multiplier, run_j.batch)
    key = jax.random.PRNGKey(11)
    eps, comp = _jax_draws(key, code, len(reps), pi0=0.5)
    want = np.asarray(run_j(key, sigma))
    assert want[2, -1] > 0
    got = run_p(None, sigma, eps=eps, comp=comp)
    assert got.shape == (4, len(reps) + 2)
    _hold(got, want)


def _roll_form(hard, reps, Z):
    """The reference's multiplicity machinery (impsamp.py:538-549) in
    torch: per rep, an OR of its rolled block rows."""
    Bh = hard.shape[0]
    hb = hard.reshape(Bh, -1, Z) != 0
    Mtot = torch.zeros(Bh, dtype=torch.float32)
    m0 = []
    for s in reps:
        mr = None
        for v in sorted(set(map(int, s))):
            b, o = divmod(v, Z)
            row = hb[:, b, :]
            if o:
                row = torch.roll(row, -o, dims=1)
            mr = row if mr is None else (mr | row)
        Mtot = Mtot + mr.to(torch.float32).sum(dim=1)
        m0.append(mr[:, 0].to(torch.float32))
    return Mtot, torch.stack(m0, dim=1)


@pytest.mark.parametrize("which,chunk", [("toy", None), ("wifi", None),
                                         ("wifi", 1000)])
def test_zfold_gather_equals_the_roll_form(which, chunk, request,
                                           monkeypatch):
    code = request.getfixturevalue(which)
    rng = np.random.default_rng(6)
    Z = int(code.Z)
    sets = [rng.choice(code.n, int(rng.integers(1, 8)), replace=False)
            for _ in range(9)]
    reps, _ = rimp.expand_radial(
        sorted({rimp.canonical_rotation(code, s) for s in sets}), [1, 2, 3])
    hard = torch.as_tensor((rng.random((64, code.n)) < 0.03).astype(
        np.uint8))
    hard[:4] = 0                                     # frames with no error
    if chunk:
        monkeypatch.setattr(pimp, "_GATHER_ELEMS", chunk)
    idx, inv, mult = (torch.as_tensor(a) for a in pimp._orbit_index(
        reps, Z, code.n))
    assert idx.shape[0] == len(reps) // 3             # distinct supports
    got = pimp._match_profile(hard, idx, inv, mult)
    want = _roll_form(hard, reps, Z)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        assert torch.equal(g, w)
    assert (got[0] > 0).any() and (got[0] == 0).any()


def test_harvest_equals_the_reference_on_injected_noise(wifi):
    cfg = _cfg()
    seed, frames, batch, ebn0 = 2, 768, B, 1.0
    key = jax.random.PRNGKey(seed)
    eps = [torch.as_tensor(np.array(_normal(
        jax.random.fold_in(key, i), np.zeros((batch, wifi.n), np.float32))))
        for i in range(frames // batch)]
    for cap in (256, 40):
        want = rimp.harvest_error_supports(wifi, cfg, ebn0, frames=frames,
                                           batch=batch, backend="jnp",
                                           seed=seed, max_supports=cap)
        got = pimp.harvest_error_supports(wifi, config_from_reference(cfg),
                                          ebn0, frames=frames, batch=batch,
                                          device="cpu", max_supports=cap,
                                          eps=eps)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="batches"):
        pimp.harvest_error_supports(wifi, cfg, ebn0, frames=frames,
                                    batch=batch, device="cpu", eps=eps[:1])


# ---------------------------------------------------------------------------
# The estimators on equal per-batch sums
# ---------------------------------------------------------------------------

class _FakeRun:
    """Per-batch sums from a list, in order; records the counts it got."""

    def __init__(self, outs, wrap, **attrs):
        self.outs, self.wrap, self.i, self.counts = outs, wrap, 0, []
        self.__dict__.update(attrs)

    def __call__(self, key, sigma, counts=None):
        if counts is not None:
            self.counts.append(np.asarray(counts).tolist())
        out = self.outs[self.i]
        self.i += 1
        return self.wrap(out)


def _fake_sums(rng, n, shape, batch):
    out = []
    for _ in range(n):
        w = rng.random(shape[1:] + (batch,)) * (rng.random(
            shape[1:] + (batch,)) < 0.1) * 3.0
        bits = rng.integers(0, 20, w.shape) * (w > 0)
        out.append(np.stack([w.sum(-1), (w * w).sum(-1), (w > 0).sum(-1),
                             (w * bits).sum(-1)]).astype(np.float32))
    return out


@pytest.mark.parametrize("mode", ["plain", "proportional", "neyman"])
def test_estimate_fer_equals_the_reference_on_equal_sums(wifi, mode):
    rng = np.random.default_rng(8)
    K, batch, frames = 7, 64, 640
    pis = np.concatenate([[0.25], np.full(K, 0.75 / K)])
    strat = mode != "plain"
    pilot = 256 if mode == "neyman" else 0
    n = (frames + pilot) // batch
    shape = (4, K + 1) if strat else (4,)
    outs = _fake_sums(rng, n, shape, batch)
    attrs = dict(batch=batch, stratified=strat, n_comp=K + 1, pis=pis)
    kw = dict(ebn0_db=3.0, frames=frames, batch=batch, pilot_frames=pilot,
              allocation="neyman" if mode == "neyman" else "proportional")
    fr = _FakeRun(outs, np.asarray, **attrs)
    fp = _FakeRun(outs, torch.as_tensor, device=torch.device("cpu"), **attrs)
    want = rimp.estimate_fer(wifi, _cfg(), [], run=fr, **kw)
    got = pimp.estimate_fer(wifi, _cfg(), [], run=fp, **kw)
    assert fp.i == fr.i == n and fp.counts == fr.counts
    if mode == "neyman":
        assert fp.counts[0] != fp.counts[-1]
    assert got.to_dict() == want.to_dict()
    assert type(got).__name__ == "ISEstimate"


def test_estimate_fer_symmetric_equals_the_reference_on_equal_sums(toy):
    rng = np.random.default_rng(9)
    K, batch = 5, 32
    outs = _fake_sums(rng, 6, (4, K + 2), batch)
    for o in outs:
        o[0, K + 1] = o[0, :K + 1].sum()
    attrs = dict(batch=batch, K=K, orbit_multiplier=8)
    kw = dict(ebn0_db=2.5, frames=6 * batch, batch=batch)
    want = rimp.estimate_fer_symmetric(toy, _cfg(), [[0]] * K,
                                       run=_FakeRun(outs, np.asarray,
                                                    **attrs), **kw)
    got = pimp.estimate_fer_symmetric(toy, _cfg(), [[0]] * K,
                                      run=_FakeRun(outs, torch.as_tensor,
                                                   device=torch.device("cpu"),
                                                   **attrs), **kw)
    assert got == want


def test_points_draw_independent_and_repeatable_streams(wifi):
    """Batch i of a point is keyed by (seed, round(1000 * Eb/N0), i)."""
    run = pimp.make_is_run(wifi, _cfg(), [[0, 1, 2, 3]], batch=8,
                           device="cpu")
    seen = []

    def spy(rng, sigma, *counts):
        seen.append(torch.randn(3, generator=rng))
        return torch.zeros(4)
    spy.batch, spy.device = 8, torch.device("cpu")
    for e in (3.0, 3.0, 3.5):
        pimp.estimate_fer(wifi, _cfg(), [], e, frames=16, run=spy)
    assert torch.equal(seen[0], seen[2]) and torch.equal(seen[1], seen[3])
    assert not torch.equal(seen[0], seen[1])
    assert not torch.equal(seen[0], seen[4])
    assert run.batch == 8


# ---------------------------------------------------------------------------
# Statistics and refusals
# ---------------------------------------------------------------------------

def test_k0_degenerates_to_plain_mc(wifi):
    """With no sets every weight is 1, and the IS chain is the step's
    all-zeros batch-first chain: on the same noise its raw error count is
    the step's frame-error count and its sum w*bits the bit errors."""
    cfg = config_from_reference(_cfg())
    run = pimp.make_is_run(wifi, cfg, [], batch=B, device="cpu")
    assert not run.stratified and list(run.pis) == [1.0]
    noise = torch.as_tensor(np.random.default_rng(10).standard_normal(
        (B, wifi.n)).astype(np.float32))
    sigma = np.float32(0.9)
    out = run(None, sigma, eps=noise)
    assert out[0] == out[2] and out[1] == out[2] and out[2] > 0
    az = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                          all_zeros=True))
    rb = make_run_batch(from_reference(wifi, "cpu"), az, batch=B)
    frames, bit_errs, frame_errs, _, _ = rb(None, sigma, noise=noise).tolist()
    assert (frames, frame_errs, bit_errs) == (B, int(out[2]), int(out[3]))


def test_estimate_matches_plain_mc_statistically(wifi):
    cfg = config_from_reference(_cfg(max_iter=6))
    plain = pimp.estimate_fer(wifi, cfg, [], ebn0_db=2.0, frames=1024,
                              batch=512, seed=5, device="cpu")
    mixed = pimp.estimate_fer(wifi, cfg, [[0, 1, 2, 3], [640, 641, 642]],
                              ebn0_db=2.0, frames=1024, batch=512, seed=7,
                              delta=2.0, pi0=0.5, device="cpu")
    assert plain.fer > 0 and mixed.fer > 0
    assert plain.raw_hits == round(plain.fer * plain.frames)
    tol = 5 * (plain.fer * plain.rel_std + mixed.fer * mixed.rel_std)
    assert abs(plain.fer - mixed.fer) <= tol


def test_refusals_equal_the_reference(wifi, toy):
    cfg = _cfg()
    qam = dataclasses.replace(cfg, channel=dataclasses.replace(
        cfg.channel, modulation="16qam"))
    from ldpc_tpu.codes.code import LDPCCode
    nonqc = LDPCCode(name="nonqc", n=3, m=2, k=1,
                     cn_adj=[np.array([0, 1], np.int32),
                             np.array([1, 2], np.int32)])
    for mod, make, args, kw, match in (
            (rimp, "make_is_run", (wifi, qam, []), {}, "BPSK"),
            (rimp, "make_is_run", (wifi, cfg, [[1]]), dict(pi0=0.0), "pi0"),
            (rimp, "make_is_run", (wifi, cfg, [[1]]), dict(delta=0.0),
             "delta"),
            (rimp, "make_symmetric_run", (nonqc, cfg, [[0]]), {}, "QC"),
            (rimp, "make_symmetric_run", (toy, cfg, []), {},
             "representative")):
        with pytest.raises(ValueError, match=match):
            getattr(rimp, make)(*args, **kw)
        with pytest.raises(ValueError, match=match):
            getattr(pimp, make)(*args, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown allocation"):
        pimp.estimate_fer(wifi, cfg, [], 3.0, 8, allocation="x",
                          device="cpu")
    for make in (pimp.make_is_run, pimp.make_symmetric_run):
        with pytest.raises(NotImplementedError, match="parallel/mesh.py"):
            make(toy, cfg, [[0]], device="cpu", mesh=object())
    run = pimp.make_is_run(wifi, cfg, [[1, 2]], batch=8, device="cpu",
                           stratify=True)
    with pytest.raises(ValueError, match="counts"):
        run(torch.Generator(), 0.9)


def test_symmetric_refuses_partial_block_rate_matching(toy):
    from ldpc_tpu.codes.rate_compat import puncture
    code = puncture(toy, frac=0.3, scheme="random", seed=2)
    with pytest.raises(ValueError):
        rimp.make_symmetric_run(code, _cfg(), [[0]])
    with pytest.raises(ValueError):
        pimp.make_symmetric_run(code, _cfg(), [[0]], device="cpu")


def test_entry_points_default_to_cuda(wifi):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pimp.make_is_run(wifi, _cfg(), [])
    with pytest.raises(RuntimeError, match="cuda"):
        pimp.harvest_error_supports(wifi, _cfg(), 2.0, frames=8, batch=8)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["floor", "--family", "toy", "--Z", "4"])


# ---------------------------------------------------------------------------
# The CLI's floor
# ---------------------------------------------------------------------------

def test_floor_parser_defaults_equal_the_reference():
    from ldpc_tpu.cli import build_parser as ref_parser
    ref = vars(ref_parser().parse_args(["floor"]))
    port = vars(cli.build_parser().parse_args(["floor"]))
    assert ref.pop("platform") is None
    assert port.pop("device") == "cuda"
    assert port == ref


def test_seed_band_is_the_standard_error_of_the_difference():
    """The one output meant to differ from the reference: the band is
    2 * hypot(sigma_a, sigma_b), where the reference's 2 * (sigma_a +
    sigma_b) is up to sqrt(2) wider. On this pair the two disagree."""
    a = {"fer": 1.0e-6, "rel_std": 0.1}
    b = {"fer": 1.4e-6, "rel_std": 0.1}
    sa, sb = a["fer"] * a["rel_std"], b["fer"] * b["rel_std"]
    linear = abs(a["fer"] - b["fer"]) <= 2 * (sa + sb)
    assert linear and not cli._seeds_agree(a, b)
    assert cli._seeds_agree(a, {"fer": 1.25e-6, "rel_std": 0.1})
    assert cli._seeds_agree(a, a)


def _floor_args(out, *extra):
    return ["floor", "--family", "toy", "--Z", "8", "--algorithm",
            "normalized-min-sum", "--beta-lsb", "0", "--schedule", "layered",
            "--max-iter", "8", "--harvest-ebn0", "1.0", "--harvest-frames",
            "256", "--batch", "128", "--frames", "256", "--ebn0", "2.5,3.0",
            "--k-sets", "8", "--out", out, *extra]


def _keys(d):
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list) and d and isinstance(d[0], dict):
        return [_keys(d[0])]
    return None


@pytest.mark.parametrize("extra", [
    ["--stratified", "--delta", "1.5,2.0", "--exact-sets", "4,2,3"],
    ["--symmetric", "--seeds", "1,2", "--delta", "1.5,2.0"],
])
def test_floor_cli_runs_on_the_cpu_with_the_reference_keys(tmp_path, extra):
    from ldpc_tpu import cli as rcli
    out, ref_out = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    assert cli.main(_floor_args(out, "--device", "cpu", *extra)) == 0
    assert rcli.main(_floor_args(ref_out, "--platform", "cpu", *extra)) == 0
    got, want = json.load(open(out)), json.load(open(ref_out))
    assert _keys(got) == _keys(want)
    assert got["config"] == want["config"]
    assert [p["ebn0_db"] for p in got["points"]] == [2.5, 3.0]
    if "--symmetric" in extra:
        assert all(len(p["seeds"]) == 2 for p in got["points"])
        assert got["proposal"]["orbit_multiplier"] == 8
    else:
        assert got["proposal"]["stratified"] is True
        assert all(p["frames"] == 256 for p in got["points"])


def test_floor_cli_refusals():
    with pytest.raises(NotImplementedError, match="parallel/mesh.py"):
        cli.main(["floor", "--device", "cpu", "--mesh", "2"])
    with pytest.raises(SystemExit, match="stratified"):
        cli.main(["floor", "--device", "cpu", "--family", "toy", "--Z", "4",
                  "--allocation", "neyman"])


def test_no_warning_without_dropped_sets(wifi):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pimp.make_is_run(wifi, _cfg(), [[0, 1]], batch=8, device="cpu")
