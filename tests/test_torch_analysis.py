"""The port's analysis layer (`ldpc_tpu_torch/analysis/`: `trapping`, the
exact census `asenum` over `csrc/as_enum.c`) and the census users of
`codes/peg.py` (`qc_peg_best(use_absorbing=True)`, `as_optimize`) against
the JAX package's, on the CPU: equal inputs, equal outputs, tolerance 0.
Codes enter both packages by value (`own_code`)."""

import numpy as np
import pytest

from ldpc_tpu.analysis import asenum as rasenum
from ldpc_tpu.analysis import trapping as rtrap
from ldpc_tpu.codes import peg as rpeg
from ldpc_tpu.codes.ieee80211n import make_code as rmake_wifi
from ldpc_tpu.codes.toy import toy_qc as rtoy
from ldpc_tpu_torch import analysis
from ldpc_tpu_torch.analysis import asenum as pasenum
from ldpc_tpu_torch.analysis import trapping as ptrap
from ldpc_tpu_torch.codes import own_code
from ldpc_tpu_torch.codes import peg as ppeg
from ldpc_tpu_torch.utils.native import omp_threads


@pytest.fixture(scope="module")
def wifi():
    ref = rmake_wifi(648, "1/2")
    return ref, own_code(ref)


@pytest.fixture(scope="module")
def toy():
    ref = rtoy(8)
    return ref, own_code(ref)


def _supports(code, rng, count=24):
    """Random supports of 1-12 variables, and a few sets grown from one
    check's neighbourhood (low b)."""
    out = [sorted(rng.choice(code.n, size=int(rng.integers(1, 13)),
                             replace=False).tolist()) for _ in range(count)]
    for c in rng.choice(code.m, size=4, replace=False):
        out.append(sorted(map(int, code.cn_adj[int(c)])))
    return out


@pytest.mark.parametrize("which", ["wifi", "toy"])
def test_classify_odd_checks_is_absorbing_equal_the_reference(which, request,
                                                              rng):
    ref, own = request.getfixturevalue(which)
    for s in _supports(ref, rng):
        assert ptrap.classify(own, s) == rtrap.classify(ref, s)
        np.testing.assert_array_equal(ptrap.odd_checks(own, s),
                                      rtrap.odd_checks(ref, s))
        assert ptrap.odd_checks(own, s).dtype == np.int32
        assert ptrap.is_absorbing(own, s) == rtrap.is_absorbing(ref, s)


@pytest.mark.parametrize("which", ["wifi", "toy"])
def test_refine_support_equals_the_reference(which, request, rng):
    ref, own = request.getfixturevalue(which)
    for s in _supports(ref, rng, 12):
        assert ptrap.refine_support(own, s) == rtrap.refine_support(ref, s)


@pytest.mark.parametrize("which", ["wifi", "toy"])
def test_grow_greedy_equals_the_reference(which, request, rng):
    ref, own = request.getfixturevalue(which)
    vr, vp = ref.vn_adj(), own.vn_adj()
    for s in _supports(ref, rng, 8):
        want = rtrap._grow_greedy(ref, frozenset(s), 10, vr)
        got = ptrap._grow_greedy(own, frozenset(s), 10, vp)
        assert got == want


@pytest.mark.parametrize("which,kw", [
    ("toy", dict(a_max=6, b_max=4, max_sets=64)),
    ("toy", dict(a_max=6, b_max=6, max_sets=64)),
    ("wifi", dict(a_max=10, b_max=4, max_sets=768)),
    ("wifi", dict(a_max=5, b_max=6, seeds=[[0, 1, 2]], per_vn_seeds=False)),
])
def test_search_and_dominant_sets_equal_the_reference(which, kw, request):
    ref, own = request.getfixturevalue(which)
    want = rtrap.search_trapping_sets(ref, **kw)
    got = ptrap.search_trapping_sets(own, **kw)
    assert got == want and list(got) == list(want)
    for k, min_a in ((5, 1), (48, 4)):
        assert (ptrap.dominant_sets(got, k=k, min_a=min_a)
                == rtrap.dominant_sets(want, k=k, min_a=min_a))


def _same_census(got, want):
    np.testing.assert_array_equal(got.class_counts, want.class_counts)
    np.testing.assert_array_equal(got.absorb_counts, want.absorb_counts)
    assert (got.nodes_visited, got.n_allowed, got.hub_floor,
            got.emit_truncated) == (want.nodes_visited, want.n_allowed,
                                    want.hub_floor, want.emit_truncated)
    # OpenMP threads emit sets in any order; the sets themselves are equal
    # unless the list was cut at emit_cap, where which ones made it depends
    # on the threads' timing
    assert len(got.sets) == len(want.sets)
    if not want.emit_truncated:
        assert sorted(got.sets) == sorted(want.sets)
    assert got.summary() == want.summary()
    assert (pasenum.absorbing_spectrum_key(got)
            == rasenum.absorbing_spectrum_key(want))


@pytest.mark.parametrize("which,kw", [
    ("wifi", dict(a_max=5, b_max=3, dv_cap=3)),
    ("wifi", dict(a_max=6, b_max=2, dv_cap=3, emit_min_a=4, emit_cap=200)),
    ("wifi", dict(a_max=3, b_max=4, dv_cap=0)),
    ("toy", dict(a_max=6, b_max=3)),
])
def test_enumerate_sets_equals_the_reference(which, kw, request):
    ref, own = request.getfixturevalue(which)
    got = pasenum.enumerate_sets(own, **kw)
    want = rasenum.enumerate_sets(ref, **kw)
    _same_census(got, want)
    for a, b, flag, S in got.sets[:300]:
        assert ptrap.classify(own, S) == (a, b)
        assert ptrap.is_absorbing(own, S) == flag


def test_exact_absorbing_census_equals_the_reference(wifi):
    ref, own = wifi
    got = analysis.exact_absorbing_census(own, a_max=6)
    assert got == rasenum.exact_absorbing_census(ref, a_max=6)
    # the 802.11n structure: no absorbing set below a=6, 27 (6,2) sets
    assert got["classes"]["(6,2)"] == 27
    assert sum(got["key"][:5 * 4]) == 0


def test_enumerate_sets_refuses_as_the_reference(toy):
    ref, own = toy
    for kw in (dict(a_max=0), dict(a_max=25), dict(b_max=-1)):
        with pytest.raises(ValueError):
            rasenum.enumerate_sets(ref, **kw)
        with pytest.raises(ValueError):
            pasenum.enumerate_sets(own, **kw)


def test_census_library_is_built_from_the_port_source():
    from ldpc_tpu_torch.utils.native import library_path
    lib = pasenum._lib()
    assert lib._name == library_path(pasenum.SOURCE, pasenum.BUILD_DIR)
    assert pasenum.SOURCE.endswith("ldpc_tpu_torch/csrc/as_enum.c")


@pytest.fixture
def one_thread():
    """The census emits sets in thread order; as_optimize ranks its moves
    by that order, so the comparison runs on one OpenMP thread (both
    libraries share the runtime). The thread count is restored after."""
    with omp_threads(pasenum._lib(), 1):
        yield


@pytest.mark.parametrize("Z,seed", [(7, 0), (9, 2)])
def test_as_optimize_equals_the_reference(Z, seed, one_thread):
    ref = rpeg.qc_peg_construct(kb=6, cb=6, Z=Z, col_degrees=3, seed=seed)
    own = ppeg.qc_peg_construct(kb=6, cb=6, Z=Z, col_degrees=3, seed=seed)
    np.testing.assert_array_equal(own.base, ref.base)
    got, log = ppeg.as_optimize(own, a_max=5, max_evals=20, seed=1)
    want, log_r = rpeg.as_optimize(ref, a_max=5, max_evals=20, seed=1)
    assert log == log_r
    assert any(e["event"] == "accept" for e in log)
    np.testing.assert_array_equal(got.base, want.base)
    assert (got.name, got.n, got.standard_exact) == (want.name, want.n,
                                                     want.standard_exact)


def test_as_optimize_refuses_as_the_reference(toy):
    from ldpc_tpu_torch.codes.code import LDPCCode
    cn = [np.array([0, 1], np.int32), np.array([1, 2], np.int32)]
    with pytest.raises(ValueError, match="QC"):
        ppeg.as_optimize(LDPCCode(name="nonqc", n=3, m=2, k=1, cn_adj=cn))


def test_qc_peg_best_with_the_census_equals_the_reference():
    best, table = ppeg.qc_peg_best(kb=6, cb=6, Z=5, col_degrees=3,
                                   n_seeds=2, seed0=1)
    best_r, table_r = rpeg.qc_peg_best(kb=6, cb=6, Z=5, col_degrees=3,
                                       n_seeds=2, seed0=1)
    assert table == table_r
    assert all(row["absorbing"] > 0 for row in table)
    np.testing.assert_array_equal(best.base, best_r.base)
