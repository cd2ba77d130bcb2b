"""The port's design funnel (`ldpc_tpu_torch/analysis/de.py`, `exit.py`,
`proto_de.py`) against the reference's, case by case: every case of
`tests/test_de.py`, `test_exit.py` and `test_proto_de.py` runs on both
packages, on each package's own codes and configs, and the port's output
equals the reference's with tolerance 0 (`==` on arrays and thresholds: the
copies do the same float operations in the same order). Each case also
keeps the reference test's own assertion, on the port's value. The two
cases the reference marks slow are slow here too."""
import math

import numpy as np
import pytest

from ldpc_tpu.analysis import de as rde
from ldpc_tpu.analysis import exit as rpx
from ldpc_tpu.analysis import proto_de as rpd
from ldpc_tpu.config import QuantConfig as RQuant
from ldpc_tpu_torch.analysis import de
from ldpc_tpu_torch.analysis import exit as px
from ldpc_tpu_torch.analysis import proto_de as pd
from ldpc_tpu_torch.config import QuantConfig

Q_MS = dict(bits=8, scale=4.0, beta_lsb=0)
Q_OMS = dict(bits=8, scale=4.0, beta_lsb=1)


def same(got, want):
    """Tolerance 0: arrays equal element for element (NaN nowhere), floats
    and tuples with ==."""
    if isinstance(got, np.ndarray) or isinstance(want, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    else:
        assert got == want, (got, want)
    return got


def wifi(n, rate):
    from ldpc_tpu.codes.ieee80211n import make_code as rmake
    from ldpc_tpu_torch.codes.ieee80211n import make_code
    return make_code(n, rate), rmake(n, rate)


def nr(bg, Z, **kw):
    from ldpc_tpu.codes.nr_bg import make_code as rmake
    from ldpc_tpu_torch.codes.nr_bg import make_code
    return make_code(base_graph=bg, Z=Z, **kw), rmake(base_graph=bg, Z=Z,
                                                     **kw)


def dvbs2(n, rate):
    from ldpc_tpu.codes.dvbs2 import make_code as rmake
    from ldpc_tpu_torch.codes.dvbs2 import make_code
    return make_code(n, rate), rmake(n, rate)


def same_spectra(a, b):
    for f in ("lam", "rho", "vnode", "cnode"):
        same(getattr(a, f), getattr(b, f))
    assert (a.max_dv, a.max_dc) == (b.max_dv, b.max_dc)


# ---------------------------------------------------------------------------
# tests/test_de.py
# ---------------------------------------------------------------------------

class TestGallagerDE:
    def test_gallager_a_36_threshold_pinned(self):
        th = same(de.gallager_threshold(3, 6, "gallager-a", tol=1e-5),
                  rde.gallager_threshold(3, 6, "gallager-a", tol=1e-5))
        assert abs(th - 0.03946) < 5e-4

    def test_gallager_48_thresholds(self):
        t3 = same(de.gallager_threshold(4, 8, "gallager-b", threshold=3),
                  rde.gallager_threshold(4, 8, "gallager-b", threshold=3))
        t2 = same(de.gallager_threshold(4, 8, "gallager-b"),
                  rde.gallager_threshold(4, 8, "gallager-b"))
        assert abs(t3 - 0.046) < 1e-3
        assert t2 < 0.01

    def test_trajectory_direction(self):
        th = same(de.gallager_threshold(3, 6, "gallager-a"),
                  rde.gallager_threshold(3, 6, "gallager-a"))
        below = same(de.gallager_trajectory(th * 0.9, 3, 6, "gallager-a"),
                     rde.gallager_trajectory(th * 0.9, 3, 6, "gallager-a"))
        p = min(th * 1.3, 0.49)
        above = same(de.gallager_trajectory(p, 3, 6, "gallager-a"),
                     rde.gallager_trajectory(p, 3, 6, "gallager-a"))
        assert below[-1] < 1e-10
        assert above[-1] > 1e-3

    def test_regular_equals_one_hot_spectra(self):
        same_spectra(de.regular_spectra(3, 6), rde.regular_spectra(3, 6))
        t1 = de.gallager_trajectory(0.03, 3, 6, "gallager-b")
        t2 = same(de.gallager_trajectory_spectra(
                      0.03, de.regular_spectra(3, 6), "gallager-b"),
                  rde.gallager_trajectory_spectra(
                      0.03, rde.regular_spectra(3, 6), "gallager-b"))
        np.testing.assert_allclose(t1, t2, rtol=0, atol=0)

    def test_irregular_spectra_from_code(self):
        from ldpc_tpu.codes.toy import array_qc as rarray
        from ldpc_tpu_torch.codes.toy import array_qc
        sp = de.spectra_from_code(array_qc(3, 6, 17))
        same_spectra(sp, rde.spectra_from_code(rarray(3, 6, 17)))
        assert sp.max_dv == 3 and sp.max_dc == 6
        assert sp.lam[3] == 1.0 and sp.rho[6] == 1.0
        own, ref = wifi(648, "1/2")
        spw = de.spectra_from_code(own)
        same_spectra(spw, rde.spectra_from_code(ref))
        assert spw.lam[2] > 0 and spw.max_dv >= 11
        assert abs(spw.lam.sum() - 1) < 1e-12
        assert abs(spw.rho.sum() - 1) < 1e-12
        assert abs(spw.vnode.sum() - 1) < 1e-12


class TestQuantizedDE:
    QUANT, RQUANT = QuantConfig(**Q_MS), RQuant(**Q_MS)

    def test_pe_trajectory_monotone_direction(self):
        traj = {}
        for sigma in (0.7, 1.3):
            pmf = same(de.chan_pmf_awgn(sigma, self.QUANT),
                       rde.chan_pmf_awgn(sigma, self.RQUANT))
            traj[sigma] = same(
                de.de_pe_trajectory(pmf, 3, 6, qmax=127, iters=60),
                rde.de_pe_trajectory(pmf, 3, 6, qmax=127, iters=60))
        good, bad = traj[0.7], traj[1.3]
        assert good[-1] < 1e-10
        assert bad[-1] > 1e-3
        assert np.all(np.diff(good) <= 1e-12)

    def test_regular_equals_one_hot_spectra(self):
        pmf = de.chan_pmf_awgn(0.8, self.QUANT)
        t1 = same(de.de_pe_trajectory(pmf, 3, 6, beta=1, qmax=127, iters=8),
                  rde.de_pe_trajectory(pmf, 3, 6, beta=1, qmax=127,
                                       iters=8))
        t2 = same(de.de_pe_trajectory_spectra(
                      pmf, de.regular_spectra(3, 6), beta=1, qmax=127,
                      iters=8),
                  rde.de_pe_trajectory_spectra(
                      pmf, rde.regular_spectra(3, 6), beta=1, qmax=127,
                      iters=8))
        np.testing.assert_allclose(t1, t2, rtol=0, atol=1e-15)

    def test_bsc_zero_quant_raises(self):
        for mod, quant in ((de, QuantConfig), (rde, RQuant)):
            with pytest.raises(ValueError, match="quantizes to 0"):
                mod.chan_pmf_bsc(0.39, quant(bits=8, scale=1.0, beta_lsb=0))

    def test_bsc_threshold_bracket_past_zero_quant(self):
        kw = dict(iters=60, tol=1e-3, bracket=(1e-3, 0.39))
        p = same(de.de_threshold_bsc(
                     3, 6, QuantConfig(bits=8, scale=1.0, beta_lsb=0), **kw),
                 rde.de_threshold_bsc(
                     3, 6, RQuant(bits=8, scale=1.0, beta_lsb=0), **kw))
        assert 1e-3 < p < 0.27

    def test_pmfs_normalized(self):
        pmf = same(de.chan_pmf_awgn(0.9, self.QUANT),
                   rde.chan_pmf_awgn(0.9, self.RQUANT))
        assert abs(pmf.sum() - 1) < 1e-12
        pmf2 = same(de.chan_pmf_bsc(0.05, self.QUANT),
                    rde.chan_pmf_bsc(0.05, self.RQUANT))
        assert abs(pmf2.sum() - 1) < 1e-12


class TestIrregularThresholds:
    def test_wifi648_oms_threshold_vs_waterfall(self):
        own, ref = wifi(648, "1/2")
        kw = dict(beta=1, iters=80, tol=5e-3, bracket=(0.6, 1.3))
        sigma_star = same(
            de.de_threshold_awgn_spectra(de.spectra_from_code(own),
                                         QuantConfig(**Q_OMS), **kw),
            rde.de_threshold_awgn_spectra(rde.spectra_from_code(ref),
                                          RQuant(**Q_OMS), **kw))
        rate = own.k / own.n
        ebn0_star = -20.0 * math.log10(sigma_star * math.sqrt(2 * rate))
        assert 0.188 < ebn0_star < 2.0, ebn0_star

    def test_irregular_beats_wrong_regular_proxy(self):
        own, ref = wifi(648, "1/2")
        kw = dict(beta=1, iters=60, tol=1e-2, bracket=(0.6, 1.3))
        q, rq = QuantConfig(**Q_OMS), RQuant(**Q_OMS)
        s_irr = same(de.de_threshold_awgn_spectra(
                         de.spectra_from_code(own), q, **kw),
                     rde.de_threshold_awgn_spectra(
                         rde.spectra_from_code(ref), rq, **kw))
        s_reg = same(de.de_threshold_awgn_spectra(
                         de.regular_spectra(3, 6), q, **kw),
                     rde.de_threshold_awgn_spectra(
                         rde.regular_spectra(3, 6), rq, **kw))
        assert s_irr > s_reg


class TestDecisionWeights:
    def test_min_degree_weights(self):
        own, ref = nr(2, 16)
        sp, rsp = de.spectra_from_code(own), rde.spectra_from_code(ref)
        same_spectra(sp, rsp)
        w = same(de.decision_weights_min_degree(sp, 2),
                 rde.decision_weights_min_degree(rsp, 2))
        assert w[1] == 0 and abs(w.sum() - 1) < 1e-12
        for mod, s in ((de, sp), (rde, rsp)):
            with pytest.raises(AssertionError):
                mod.decision_weights_min_degree(s, s.max_dv + 1)

    def test_nr_deg1_floor_vs_info_degrees(self):
        own, ref = nr(2, 16)
        q = QuantConfig(bits=8, scale=4.0, beta_lsb=2)
        rq = RQuant(bits=8, scale=4.0, beta_lsb=2)
        sp, rsp = de.spectra_from_code(own), rde.spectra_from_code(ref)
        pmf = same(de.chan_pmf_awgn(0.7, q), rde.chan_pmf_awgn(0.7, rq))
        pe_all = same(
            de.de_pe_trajectory_spectra(pmf, sp, beta=2, qmax=q.qmax,
                                        iters=80),
            rde.de_pe_trajectory_spectra(pmf, rsp, beta=2, qmax=rq.qmax,
                                         iters=80))[-1]
        w = de.decision_weights_min_degree(sp, 2)
        pe_info = same(
            de.de_pe_trajectory_spectra(pmf, sp, beta=2, qmax=q.qmax,
                                        iters=80, decision_vnode=w),
            rde.de_pe_trajectory_spectra(pmf, rsp, beta=2, qmax=rq.qmax,
                                         iters=80, decision_vnode=w))[-1]
        assert pe_all > 1e-3
        assert pe_info < pe_all / 10


# ---------------------------------------------------------------------------
# tests/test_exit.py
# ---------------------------------------------------------------------------

class TestJFunction:
    def test_endpoints_and_monotone(self):
        s = np.linspace(0.0, 12.0, 200)
        I = same(px.J(s), rpx.J(s))
        assert I[0] == 0.0
        assert I[-1] > 1.0 - 1e-8
        big = same(px.J(np.array([40.0])), rpx.J(np.array([40.0])))
        assert big[0] > 1.0 - 1e-12
        assert np.all(np.diff(I) >= 0)

    def test_inverse_roundtrip(self):
        s = np.array([0.05, 0.3, 1.0, 2.5, 6.0, 15.0])
        inv = same(px.J_inv(px.J(s)), rpx.J_inv(rpx.J(s)))
        assert np.abs(inv - s).max() < 1e-3

    def test_known_values(self):
        s = np.array([1.0, 2.0, 3.0])
        v = same(px.J(s), rpx.J(s))
        np.testing.assert_allclose(v, [0.160747, 0.485944, 0.759979],
                                   atol=1e-5)


class TestThresholds:
    def test_regular_36_threshold(self):
        B = np.zeros((3, 6), int)
        kw = dict(iters=2000, tol=5e-4, bracket=(0.5, 1.2))
        sig = same(px.pexit_threshold_sigma(B, **kw),
                   rpx.pexit_threshold_sigma(B, **kw))
        assert 0.86 < sig < 0.90

    def test_wifi648_bracketed_by_shannon_and_waterfall(self):
        own, ref = wifi(648, "1/2")
        same(px.sigma_ch_columns(own, 0.9), rpx.sigma_ch_columns(ref, 0.9))
        sigma, ebn0 = same(px.pexit_threshold_awgn(own, iters=1000, tol=1e-3),
                           rpx.pexit_threshold_awgn(ref, iters=1000,
                                                    tol=1e-3))
        assert 0.188 < ebn0 < 2.0

    def test_puncturing_raises_threshold(self):
        B = np.zeros((3, 6), int)
        kw = dict(iters=1500, tol=1e-3, bracket=(0.4, 1.2))
        s_full = same(px.pexit_threshold_sigma(B, **kw),
                      rpx.pexit_threshold_sigma(B, **kw))
        s_punct = same(px.pexit_threshold_sigma(B, punct_cols=[0], **kw),
                       rpx.pexit_threshold_sigma(B, punct_cols=[0], **kw))
        assert s_punct < s_full - 2e-3

    def test_shortened_column_helps(self):
        B = np.zeros((3, 6), int)
        kw = dict(iters=1500, tol=1e-3, bracket=(0.4, 1.4))
        s_full = same(px.pexit_threshold_sigma(B, **kw),
                      rpx.pexit_threshold_sigma(B, **kw))
        kw.update(short_cols=[5], decision_cols=[0, 1, 2, 3, 4])
        s_short = same(px.pexit_threshold_sigma(B, **kw),
                       rpx.pexit_threshold_sigma(B, **kw))
        assert s_short > s_full - 1e-3


class TestExitChart:
    @staticmethod
    def _tunnel_open(dv, dc, sigma_n):
        Ia, I_ev, I_ec_of = same(px.exit_curves_regular(dv, dc, sigma_n),
                                 rpx.exit_curves_regular(dv, dc, sigma_n))
        x = 0.0
        for _ in range(3000):
            ev = np.interp(x, Ia, I_ev)
            x_new = float(np.interp(ev, Ia, I_ec_of))
            if x_new <= x + 1e-12:
                break
            x = x_new
        return x > 0.999

    def test_tunnel_open_below_threshold(self):
        assert self._tunnel_open(3, 6, 0.80)

    def test_tunnel_closed_above_threshold(self):
        assert not self._tunnel_open(3, 6, 0.95)


class TestAgreementWithProtoDE:
    @pytest.mark.slow
    def test_dvbs2_direction(self):
        own, ref = dvbs2(16200, "1/2")
        sigma, ebn0 = same(px.pexit_threshold_awgn(own, iters=1500, tol=1e-3),
                           rpx.pexit_threshold_awgn(ref, iters=1500,
                                                    tol=1e-3))
        assert 0.1 < ebn0 < 1.6


# ---------------------------------------------------------------------------
# tests/test_proto_de.py
# ---------------------------------------------------------------------------

Q8, RQ8 = QuantConfig(**Q_OMS), RQuant(**Q_OMS)


def test_regular_collapse_exact():
    base = np.zeros((3, 6), np.int64)
    chan = de.chan_pmf_awgn(0.8, Q8)
    t_proto = same(
        pd.proto_de_trajectory(base, np.tile(chan, (6, 1)), beta=1,
                               qmax=Q8.qmax, iters=10),
        rpd.proto_de_trajectory(base, np.tile(chan, (6, 1)), beta=1,
                                qmax=RQ8.qmax, iters=10))
    t_reg = de.de_pe_trajectory(chan, 3, 6, beta=1, qmax=Q8.qmax, iters=10)
    np.testing.assert_allclose(t_proto, t_reg[:len(t_proto)], rtol=0,
                               atol=1e-14)


def test_punctured_column_slows_convergence():
    base = np.zeros((3, 6), np.int64)
    pm = np.tile(de.chan_pmf_awgn(0.75, Q8), (6, 1))
    pm_punct = pm.copy()
    pm_punct[0] = 0.0
    pm_punct[0, Q8.qmax] = 1.0
    kw = dict(beta=1, qmax=Q8.qmax, iters=30)
    t_full = same(pd.proto_de_trajectory(base, pm, **kw),
                  rpd.proto_de_trajectory(base, pm, **kw))
    t_punc = same(pd.proto_de_trajectory(base, pm_punct, **kw),
                  rpd.proto_de_trajectory(base, pm_punct, **kw))
    n = min(len(t_full), len(t_punc))
    assert t_punc[n - 1] > t_full[n - 1]


def test_shortened_column_is_known():
    base = np.zeros((3, 6), np.int64)
    pm = np.tile(de.chan_pmf_awgn(0.8, Q8), (6, 1))
    pm_short = pm.copy()
    pm_short[0] = 0.0
    pm_short[0, 2 * Q8.qmax] = 1.0
    kw = dict(beta=1, qmax=Q8.qmax, iters=20, decision_cols=[1, 2, 3, 4, 5])
    t_full = same(pd.proto_de_trajectory(base, pm, **kw),
                  rpd.proto_de_trajectory(base, pm, **kw))
    t_short = same(pd.proto_de_trajectory(base, pm_short, **kw),
                   rpd.proto_de_trajectory(base, pm_short, **kw))
    n = min(len(t_full), len(t_short))
    assert t_short[n - 1] <= t_full[n - 1] + 1e-15


def test_column_channel_pmfs_rate_matching():
    own, ref = nr(2, 16)
    pm = same(pd.column_channel_pmfs(own, 0.8, Q8),
              rpd.column_channel_pmfs(ref, 0.8, RQ8))
    Q = Q8.qmax
    punct_blocks = sorted({int(v) // 16 for v in own.punct_vns})
    assert punct_blocks == [0, 1]
    for j in punct_blocks:
        assert pm[j, Q] == 1.0
    assert abs(pm.sum(axis=1) - 1).max() < 1e-12


def test_proto_de_threshold_on_a_small_rate_matched_code():
    """The threshold search itself (bisection over proto_de_trajectory with
    the per-column channel) on the toy (3, 6) code with one base column
    punctured and one shortened (both column classes of the rate-matching
    model), at a small iteration count: equal to the reference's."""
    from ldpc_tpu.codes.rate_compat import puncture as rpuncture
    from ldpc_tpu.codes.rate_compat import shorten as rshorten
    from ldpc_tpu.codes.toy import toy_qc as rtoy
    from ldpc_tpu_torch.codes.rate_compat import puncture, shorten
    from ldpc_tpu_torch.codes.toy import toy_qc
    own = shorten(puncture(toy_qc(8), frac=1 / 3), 8)
    ref = rshorten(rpuncture(rtoy(8), frac=1 / 3), 8)
    assert len(own.punct_vns) == len(own.shortened_vns) == 8
    same(pd.column_channel_pmfs(own, 0.8, Q8),
         rpd.column_channel_pmfs(ref, 0.8, RQ8))
    kw = dict(beta=1, iters=12, tol=2e-2, bracket=(0.3, 1.2), target=1e-3)
    sigma = same(pd.proto_de_threshold_awgn(own, Q8, **kw),
                 rpd.proto_de_threshold_awgn(ref, RQ8, **kw))
    assert 0.3 < sigma < 1.2


@pytest.mark.slow
def test_dvbs2_structure_gain_direction():
    own, ref = dvbs2(16200, "1/2")
    q2, rq2 = (QuantConfig(bits=8, scale=4.0, beta_lsb=2),
               RQuant(bits=8, scale=4.0, beta_lsb=2))
    kw = dict(beta=2, iters=60, tol=1e-2, bracket=(0.6, 1.3), target=1e-5)
    s_single = same(
        de.de_threshold_awgn_spectra(de.spectra_from_code(own), q2, **kw),
        rde.de_threshold_awgn_spectra(rde.spectra_from_code(ref), rq2, **kw))
    s_proto = same(pd.proto_de_threshold_awgn(own, q2, **kw),
                   rpd.proto_de_threshold_awgn(ref, rq2, **kw))
    assert s_proto > s_single
