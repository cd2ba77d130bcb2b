"""Density evolution for (dv, dc)-regular LDPC ensembles (NumPy, offline).

A copy of `ldpc_tpu/analysis/de.py` under the same names, private
helpers included (`proto_de` imports `_cn_pair_ops`, `_sat_center` and
`chan_pmf_awgn`); it reads the port's `config.QuantConfig` and
`golden.decoder.quantize`, so its outputs equal the reference's bit for
bit: the same float operations in the same order.


Two analyses, both tracking the all-zeros-codeword / symmetric-channel
message distributions on the cycle-free ensemble (standard DE assumptions):

1. Hard-decision Gallager-A/B over the BSC — closed-form error-probability
   recursion (Gallager 1963):
     q_l      = (1 - (1 - 2 p_l)^(dc-1)) / 2          [CN wrong prob]
     p_{l+1}  = (1-p0) * P[Bin(dv-1, q_l) >= t]
              + p0 * (1 - P[Bin(dv-1, 1-q_l) >= t])   [VN flip rule, thr t]
   with t = dv-1 for Gallager-A and floor((dv-1)/2)+1 (strict majority of
   the other checks) for Gallager-B — the same pinned thresholds as
   golden/decoder.decode_hard.

2. Discrete density evolution for THIS repo's exact fixed-point min-sum /
   offset / normalized-min-sum semantics (golden/decoder.py): integer
   message alphabet [-qmax, qmax], CN = sign-product x exclude-self min
   magnitude folded pairwise (associative), then the pinned magnitude
   transform ((mag*num)>>shift, -beta, floor 0, cap qmax), VN = exact wide
   accumulation then saturation to [-qmax, qmax], hard decision 'bit=1 iff
   total < 0'. The channel pmf comes from the same quantizer
   (round-half-away-from-zero, symmetric saturation) applied to BPSK-AWGN
   LLRs (llr = 2y/sigma^2, y ~ N(+1, sigma^2)) or BSC LLRs
   (ops/channel.bsc_llr).

Both analyses run over IRREGULAR ensembles described by edge-perspective
degree spectra (lambda, rho) — `spectra_from_code` extracts them from an
`LDPCCode`'s actual degree profile, so thresholds apply to the production
802.11n/NR/DVB-S2 codes, not just (dv, dc)-regular toys (round-3 VERDICT
item 7). The (dv, dc)-regular entry points remain as one-hot special cases
(tested equal to the spectrum path).

Thresholds are found by bisection on the channel parameter: the largest
sigma (AWGN) / p (BSC) whose decision-error probability falls below a
target within the iteration budget. These are ensemble asymptotics —
finite-length codes operate with a gap to them (tests/test_de.py pins the
known Gallager-A (3,6) threshold and cross-checks the 802.11n OMS AWGN
threshold's direction against the measured waterfall artifacts).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from ..config import QuantConfig


# ---------------------------------------------------------------------------
# 0. Degree spectra — irregular-ensemble description
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DegreeSpectra:
    """Edge- and node-perspective degree distributions of an LDPC ensemble.

    lam[d] / rho[d]: fraction of EDGES incident to degree-d variables /
    checks (lambda/rho in the DE literature, index = degree).
    vnode[d] / cnode[d]: fraction of NODES of degree d (used for the
    decision-error average, which is over variable NODES).
    Arrays are indexed by degree (index 0..1 unused for checks; variable
    degree 1 is legal, e.g. NR's degree-1 extension parities).
    """
    lam: np.ndarray
    rho: np.ndarray
    vnode: np.ndarray
    cnode: np.ndarray

    @property
    def max_dv(self) -> int:
        return len(self.lam) - 1

    @property
    def max_dc(self) -> int:
        return len(self.rho) - 1


def regular_spectra(dv: int, dc: int) -> DegreeSpectra:
    """One-hot spectra of the (dv, dc)-regular ensemble."""
    lam = np.zeros(dv + 1)
    rho = np.zeros(dc + 1)
    lam[dv] = 1.0
    rho[dc] = 1.0
    return DegreeSpectra(lam=lam, rho=rho, vnode=lam.copy(),
                         cnode=rho.copy())


def spectra_from_code(code) -> DegreeSpectra:
    """Edge-degree spectra from an `LDPCCode`'s actual parity-check graph.

    Punctured/shortened variables are counted with their graph degree (the
    decoder sees them as ordinary variables with special channel LLRs); the
    ensemble threshold then describes the mother code.
    """
    dv = np.zeros(code.n, np.int64)
    dcs = []
    for vs in code.cn_adj:
        dv[vs] += 1
        dcs.append(len(vs))
    dcs = np.asarray(dcs, np.int64)
    max_dv, max_dc = int(dv.max()), int(dcs.max())
    lam = np.zeros(max_dv + 1)
    vnode = np.zeros(max_dv + 1)
    for d in range(1, max_dv + 1):
        cnt = int((dv == d).sum())
        vnode[d] = cnt / code.n
        lam[d] = cnt * d
    lam /= lam.sum()
    rho = np.zeros(max_dc + 1)
    cnode = np.zeros(max_dc + 1)
    for d in range(1, max_dc + 1):
        cnt = int((dcs == d).sum())
        cnode[d] = cnt / len(dcs)
        rho[d] = cnt * d
    rho /= rho.sum()
    return DegreeSpectra(lam=lam, rho=rho, vnode=vnode, cnode=cnode)


# ---------------------------------------------------------------------------
# 1. Hard-decision Gallager-A/B recursion (BSC)
# ---------------------------------------------------------------------------

def _binom_tail(n: int, k: int, p: np.ndarray) -> np.ndarray:
    """P[Bin(n, p) >= k] (exact sum; n is tiny)."""
    p = np.asarray(p, np.float64)
    out = np.zeros_like(p)
    for j in range(k, n + 1):
        out += math.comb(n, j) * p**j * (1 - p) ** (n - j)
    return out


def _gallager_thresholds_by_degree(max_dv: int, algorithm: str,
                                   threshold: Optional[int]) -> np.ndarray:
    """Per-variable-degree VN flip thresholds t(d) — the same pinned rule
    as golden/decoder._default_thresholds."""
    t = np.zeros(max_dv + 1, np.int64)
    for d in range(1, max_dv + 1):
        if threshold is not None:
            t[d] = int(threshold)
        elif algorithm == "gallager-a":
            t[d] = max(d - 1, 1)
        elif algorithm == "gallager-b":
            t[d] = (d - 1) // 2 + 1
        else:
            raise ValueError(algorithm)
    return t


def gallager_trajectory_spectra(p0: float, spectra: DegreeSpectra,
                                algorithm: str = "gallager-b",
                                threshold: Optional[int] = None,
                                iters: int = 500) -> np.ndarray:
    """Irregular Gallager-A/B message-error trajectory for BSC(p0):
      q_l     = sum_d rho_d (1 - (1-2 p_l)^(d-1)) / 2
      p_{l+1} = sum_d lam_d [(1-p0) P[Bin(d-1,q) >= t(d)]
                             + p0 (1 - P[Bin(d-1,1-q) >= t(d)])]
    with the per-degree thresholds of golden/decoder.decode_hard."""
    lam, rho = spectra.lam, spectra.rho
    t = _gallager_thresholds_by_degree(spectra.max_dv, algorithm, threshold)
    traj = [p0]
    p = float(p0)
    for _ in range(iters):
        q = 0.0
        for d in range(2, len(rho)):
            if rho[d]:
                q += rho[d] * (1.0 - (1.0 - 2.0 * p) ** (d - 1)) / 2.0
        p = 0.0
        for d in range(1, len(lam)):
            if lam[d]:
                p += lam[d] * float(
                    (1 - p0) * _binom_tail(d - 1, int(t[d]), q)
                    + p0 * (1.0 - _binom_tail(d - 1, int(t[d]), 1.0 - q)))
        traj.append(p)
        if p < 1e-12 or p > 0.5:
            break
    return np.asarray(traj)


def gallager_trajectory(p0: float, dv: int, dc: int,
                        algorithm: str = "gallager-b",
                        threshold: Optional[int] = None,
                        iters: int = 500) -> np.ndarray:
    """Message-error-probability trajectory p_0..p_iters for BSC(p0)
    ((dv, dc)-regular special case of gallager_trajectory_spectra)."""
    return gallager_trajectory_spectra(p0, regular_spectra(dv, dc),
                                       algorithm, threshold, iters)


def gallager_threshold_spectra(spectra: DegreeSpectra,
                               algorithm: str = "gallager-b",
                               threshold: Optional[int] = None,
                               tol: float = 1e-5) -> float:
    """Largest p0 for which the irregular recursion converges (bisection)."""
    lo, hi = 0.0, 0.5
    while hi - lo > tol:
        mid = (lo + hi) / 2
        ok = gallager_trajectory_spectra(
            mid, spectra, algorithm, threshold)[-1] < 1e-10
        lo, hi = (mid, hi) if ok else (lo, mid)
    return lo


def gallager_threshold(dv: int, dc: int, algorithm: str = "gallager-b",
                       threshold: Optional[int] = None,
                       tol: float = 1e-5) -> float:
    """Largest p0 for which the recursion converges to 0 (bisection)."""
    return gallager_threshold_spectra(regular_spectra(dv, dc), algorithm,
                                      threshold, tol)


# ---------------------------------------------------------------------------
# 2. Discrete density evolution for quantized min-sum (AWGN / BSC)
# ---------------------------------------------------------------------------

def _phi(x):
    return 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))


def chan_pmf_awgn(sigma: float, quant: QuantConfig) -> np.ndarray:
    """pmf over [-qmax, qmax] of the quantized channel LLR under the
    all-zeros codeword: y ~ N(+1, sigma^2), llr = 2y/sigma^2, quantized by
    the pinned round-half-away + symmetric-saturation rule."""
    Q = quant.qmax
    scale = float(quant.scale)
    mu = 2.0 * scale / sigma**2          # mean of scale*llr
    sd = 2.0 * scale / sigma             # std  of scale*llr
    v = np.arange(-Q, Q + 1, dtype=np.float64)
    lo = np.where(v > -Q, v - 0.5, -np.inf)   # round-half-away cell edges;
    hi = np.where(v < Q, v + 0.5, np.inf)     # saturation absorbs the tails
    pmf = _phi((hi - mu) / sd) - _phi((lo - mu) / sd)
    return pmf / pmf.sum()


def chan_pmf_bsc(p: float, quant: QuantConfig) -> np.ndarray:
    """Two-spike pmf of the quantized BSC LLR (ops/channel.bsc_llr) under
    the all-zeros codeword: magnitude log((1-p)/p), wrong sign w.p. p."""
    from ..golden.decoder import quantize as gq
    Q = quant.qmax
    mag = math.log((1.0 - p) / p)
    qv = int(gq(np.array([mag]), quant.scale, quant.bits)[0])
    if qv == 0:
        # The LLR magnitude quantizes to 0 (scale too small for this p):
        # the pmf would collapse to a spike at 0, Pe = P(total < 0) = 0,
        # and de_threshold_bsc would spuriously report convergence
        # (round-2 advisor finding). Refuse instead of silently lying.
        raise ValueError(
            f"BSC p={p}: LLR magnitude {mag:.4f} quantizes to 0 at "
            f"scale={quant.scale} — raise the quantizer scale (or lower "
            f"the bisection bracket) so the channel is representable")
    pmf = np.zeros(2 * Q + 1)
    pmf[Q + qv] += 1.0 - p
    pmf[Q - qv] += p
    return pmf


def _cn_pair(pa: np.ndarray, pb: np.ndarray, Q: int) -> np.ndarray:
    """pmf of c = sgn(a) sgn(b) min(|a|, |b|) for independent a, b.

    sign(0) = +1 per the pinned convention, but a zero magnitude forces
    c = 0 regardless of signs, so all mass with min-mag 0 lands on 0.
    """
    ap, bp = pa[Q + 1:], pb[Q + 1:]            # P(x = +v), v = 1..Q
    an, bn = pa[:Q][::-1], pb[:Q][::-1]        # P(x = -v), v = 1..Q
    a0, b0 = pa[Q], pb[Q]
    # Tails P(|x| > v & sign s), v = 1..Q (reverse cumsum shifted by one).
    def tail(x):
        c = np.cumsum(x[::-1])[::-1]
        return np.concatenate([c[1:], [0.0]])
    TAp, TAn, TBp, TBn = tail(ap), tail(an), tail(bp), tail(bn)
    pos = (ap * TBp + an * TBn + bp * TAp + bn * TAn
           + ap * bp + an * bn)
    neg = (ap * TBn + an * TBp + bp * TAn + bn * TAp
           + ap * bn + an * bp)
    out = np.zeros(2 * Q + 1)
    out[Q + 1:] = pos
    out[:Q] = neg[::-1]
    out[Q] = a0 + b0 - a0 * b0
    return out


@lru_cache(maxsize=8)
def _minstar_pair_targets(Q: int, thresholds: tuple) -> np.ndarray:
    """(2Q+1, 2Q+1) int32 table of the pinned fixed-point pairwise
    box-plus, shifted by +Q for bincount: T[a+Q, b+Q] = Q + bp2(a, b)
    with bp2 exactly golden/decoder._boxplus2 (per-combine clip to
    [0, Q], threshold-LUT correction, sign(0) = +1). DE folds a check's
    exclude-self combine as repeated pairing of iid message pmfs, so one
    exact pair table is the whole min* CN recursion."""
    v = np.arange(-Q, Q + 1)
    x, y = v[:, None], v[None, :]
    ax, ay = np.abs(x), np.abs(y)

    def corr(u):
        c = np.zeros_like(u)
        for t in thresholds:
            c += (u <= t).astype(np.int64)
        return c

    mag = np.minimum(ax, ay) + corr(ax + ay) - corr(np.abs(ax - ay))
    mag = np.clip(mag, 0, Q)
    T = np.where((x < 0) != (y < 0), -mag, mag)
    return (T + Q).astype(np.int32)


def _cn_pair_minstar(pa: np.ndarray, pb: np.ndarray, Q: int,
                     thresholds: tuple) -> np.ndarray:
    """pmf of c = bp2(a, b) (pinned fixed-point box-plus) for independent
    a, b — the min* counterpart of _cn_pair."""
    T = _minstar_pair_targets(Q, tuple(thresholds))
    W = np.outer(pa, pb)
    return np.bincount(T.ravel(), weights=W.ravel(), minlength=2 * Q + 1)


def _cn_pair_ops(Q: int, beta: int, alpha, minstar):
    """(pair, xform) closures for the CN recursion: min* uses the exact
    box-plus pair table with an identity post-transform (no beta/alpha by
    construction); the min-sum family pairs by signed min and applies the
    offset/normalized magnitude transform post-exclusion."""
    if minstar is not None:
        if beta or alpha is not None:
            raise ValueError("min-star does not compose with beta/alpha")
        return (lambda a, b: _cn_pair_minstar(a, b, Q, minstar),
                lambda p: p)
    return (lambda a, b: _cn_pair(a, b, Q),
            lambda p: _cn_mag_transform(p, Q, beta, alpha))


def _cn_mag_transform(pmf: np.ndarray, Q: int, beta: int,
                      alpha: Optional[Tuple[int, int]]) -> np.ndarray:
    """Apply the pinned magnitude transform to a message pmf:
    mag' = min(max(((mag*num)>>shift) - beta, 0), Q), sign kept."""
    out = np.zeros_like(pmf)
    for v in range(-Q, Q + 1):
        mag = abs(v)
        if alpha is not None:
            mag = (mag * alpha[0]) >> alpha[1]
        mag = min(max(mag - beta, 0), Q)
        nv = mag if v > 0 else -mag
        out[Q + nv] += pmf[Q + v]
    return out


def de_pe_trajectory_spectra(chan_pmf: np.ndarray, spectra: DegreeSpectra,
                             beta: int = 0,
                             alpha: Optional[Tuple[int, int]] = None,
                             qmax: int = 127,
                             iters: int = 100,
                             decision_vnode: Optional[np.ndarray] = None,
                             minstar: Optional[tuple] = None,
                             ) -> np.ndarray:
    """Decision-error-probability trajectory of quantized min-sum DE over
    an IRREGULAR ensemble (edge spectra lambda/rho; node spectrum for the
    decision average).

    chan_pmf: pmf over [-qmax, qmax] (chan_pmf_awgn / chan_pmf_bsc).
    Returns Pe after 0..iters iterations, Pe = P(decision total < 0)
    averaged over variable NODES (ties at 0 decide bit 0 = correct under
    the all-zeros convention, matching golden 'bit = 1 iff total < 0').

    minstar: threshold-LUT tuple (config.minstar_thresholds) — selects the
    min* (approx sum-product) CN recursion: the exact pmf of the pinned
    pairwise box-plus replaces the signed-min pair, no beta/alpha.

    decision_vnode: optional replacement node-degree weights for the
    DECISION average only (message densities still use the full spectra).
    Use case: 5G NR base graphs carry ~60% degree-1 extension parities
    whose decision Pe has an irreducible floor (their total is chan + one
    saturating message) while the info-carrying degrees converge — weight
    by degrees >= 2 to get the info-bit threshold instead of the floor.
    """
    Q = qmax
    assert len(chan_pmf) == 2 * Q + 1
    lam, rho = spectra.lam, spectra.rho
    vnode = spectra.vnode if decision_vnode is None else decision_vnode
    assert len(vnode) == len(spectra.vnode) and abs(vnode.sum() - 1) < 1e-9
    max_dv, max_dc = spectra.max_dv, spectra.max_dc

    def pe_and_v2c(c2v):
        """One wide accumulation chain serves every degree: acc_k = pmf of
        chan + k iid c2v (exact, no intermediate saturation — the pinned VN
        rule). v2c mix saturates acc_{d-1}; Pe averages P(acc_d < 0)."""
        acc = chan_pmf.copy()
        v2c_mix = np.zeros(2 * Q + 1)
        if max_dv >= 1 and lam[1]:
            v2c_mix += lam[1] * acc  # degree-1 VN: v2c = chan (0 others)
        pe = 0.0
        for k in range(1, max_dv + 1):
            acc = np.convolve(acc, c2v)
            C = (len(acc) - 1) // 2
            if vnode[k]:
                pe += vnode[k] * float(acc[:C].sum())
            if k + 1 <= max_dv and lam[k + 1]:
                v2c_mix += lam[k + 1] * _sat_center(acc, Q)
        return pe, v2c_mix

    pair, xform = _cn_pair_ops(Q, beta, alpha, minstar)

    def cn_mix(v2c):
        """Mixture over check degrees of the exclude-self fold + the pinned
        magnitude transform. fold_k = pmf of the pair op (signed min, or
        min* box-plus) folded over k messages."""
        out = np.zeros(2 * Q + 1)
        if max_dc >= 1 and rho[1]:
            # degree-1 check: empty exclusion set = +qmax (golden rule)
            spike = np.zeros(2 * Q + 1)
            spike[Q + Q] = 1.0
            out += rho[1] * xform(spike)
        fold = v2c.copy()  # fold of 1 message
        for d in range(2, max_dc + 1):
            if rho[d]:
                out += rho[d] * xform(fold)
            if d < max_dc:
                fold = pair(fold, v2c)
        return out

    # initial v2c mix: every edge carries the channel pmf
    v2c = chan_pmf.copy()
    traj = [float(chan_pmf[:Q].sum())]
    for _ in range(iters):
        c2v = cn_mix(v2c)
        pe, v2c = pe_and_v2c(c2v)
        # Renormalize: the per-iteration roundoff in the fold/conv chain is
        # ~1e-16 but amplifies ~(dc-1+2(dv-1))x per iteration — without this
        # the drift overflows float64 within ~60 iterations.
        np.maximum(v2c, 0.0, out=v2c)
        v2c /= v2c.sum()
        traj.append(pe)
        if traj[-1] < 1e-12:
            break
    return np.asarray(traj)


def _sat_center(acc: np.ndarray, Q: int) -> np.ndarray:
    """Clip a centered wide pmf to [-Q, Q] (tail mass onto the edges)."""
    C = (len(acc) - 1) // 2
    if C <= Q:
        out = np.zeros(2 * Q + 1)
        out[Q - C: Q + C + 1] = acc
        return out
    out = acc[C - Q: C + Q + 1].copy()
    out[0] += acc[: C - Q].sum()
    out[-1] += acc[C + Q + 1:].sum()
    return out


def de_pe_trajectory(chan_pmf: np.ndarray, dv: int, dc: int,
                     beta: int = 0, alpha: Optional[Tuple[int, int]] = None,
                     qmax: int = 127, iters: int = 100) -> np.ndarray:
    """Decision-error-probability trajectory of quantized min-sum DE
    ((dv, dc)-regular special case of de_pe_trajectory_spectra)."""
    return de_pe_trajectory_spectra(chan_pmf, regular_spectra(dv, dc),
                                    beta, alpha, qmax, iters)


def decision_weights_min_degree(spectra: DegreeSpectra,
                                dmin: int = 2) -> np.ndarray:
    """Node-degree decision weights restricted to degrees >= dmin,
    renormalized (see de_pe_trajectory_spectra.decision_vnode)."""
    w = spectra.vnode.copy()
    w[:dmin] = 0.0
    s = w.sum()
    assert s > 0, f"no variable nodes of degree >= {dmin}"
    return w / s


def de_threshold_awgn_spectra(
        spectra: DegreeSpectra, quant: QuantConfig, beta: int = 0,
        alpha: Optional[Tuple[int, int]] = None,
        iters: int = 100, target: float = 1e-7, tol: float = 2e-3,
        bracket: Tuple[float, float] = (0.3, 1.5),
        decision_vnode: Optional[np.ndarray] = None,
        minstar: Optional[tuple] = None) -> float:
    """Largest AWGN sigma at which irregular DE drives Pe below target
    (bisection). Eb/N0 at rate R: -20*log10(sigma*sqrt(2R))."""
    lo, hi = bracket

    def ok(sigma):
        pe = de_pe_trajectory_spectra(chan_pmf_awgn(sigma, quant), spectra,
                                      beta, alpha, quant.qmax, iters,
                                      decision_vnode=decision_vnode,
                                      minstar=minstar)
        return pe[-1] < target

    assert ok(lo), "bracket low end must converge"
    while hi - lo > tol:
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if ok(mid) else (lo, mid)
    return lo


def de_threshold_awgn(dv: int, dc: int, quant: QuantConfig,
                      beta: int = 0,
                      alpha: Optional[Tuple[int, int]] = None,
                      iters: int = 100, target: float = 1e-7,
                      tol: float = 2e-3,
                      bracket: Tuple[float, float] = (0.3, 1.5)) -> float:
    """Largest AWGN sigma at which DE drives Pe below target (bisection).
    Eb/N0 at rate R: -20*log10(sigma*sqrt(2R))."""
    return de_threshold_awgn_spectra(regular_spectra(dv, dc), quant, beta,
                                     alpha, iters, target, tol, bracket)


def de_threshold_bsc_spectra(
        spectra: DegreeSpectra, quant: QuantConfig, beta: int = 0,
        alpha: Optional[Tuple[int, int]] = None,
        iters: int = 100, target: float = 1e-7, tol: float = 1e-4,
        bracket: Tuple[float, float] = (1e-3, 0.4),
        decision_vnode: Optional[np.ndarray] = None,
        minstar: Optional[tuple] = None) -> float:
    """Largest BSC flip probability at which irregular quantized min-sum DE
    converges."""
    lo, hi = bracket

    def ok(p):
        try:
            chan = chan_pmf_bsc(p, quant)
        except ValueError:
            # LLR magnitude quantizes to 0 at this p (chan_pmf_bsc refuses
            # to report the spurious-convergence pmf): the decoder cannot
            # operate here, so treat the point as non-converged and let the
            # bisection shrink hi. Direct chan_pmf_bsc callers still get
            # the raise.
            return False
        pe = de_pe_trajectory_spectra(chan, spectra,
                                      beta, alpha, quant.qmax, iters,
                                      decision_vnode=decision_vnode,
                                      minstar=minstar)
        return pe[-1] < target

    assert ok(lo), "bracket low end must converge"
    while hi - lo > tol:
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if ok(mid) else (lo, mid)
    return lo


def de_threshold_bsc(dv: int, dc: int, quant: QuantConfig,
                     beta: int = 0,
                     alpha: Optional[Tuple[int, int]] = None,
                     iters: int = 100, target: float = 1e-7,
                     tol: float = 1e-4,
                     bracket: Tuple[float, float] = (1e-3, 0.4)) -> float:
    """Largest BSC flip probability at which quantized min-sum DE converges."""
    return de_threshold_bsc_spectra(regular_spectra(dv, dc), quant, beta,
                                    alpha, iters, target, tol, bracket)
