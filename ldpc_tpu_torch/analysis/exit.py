"""Protograph EXIT (PEXIT) analysis — Gaussian-approximation thresholds.

A copy of `ldpc_tpu/analysis/exit.py` under the same names; it reads
the port's `codes.code.qc_block_cover`. Its outputs equal the
reference's bit for bit.


The third leg of the offline-analysis layer (the role the reference kept in
MATLAB — SURVEY.md §1.2 'MATLAB analysis'; the reference mount is empty, so
the capability contract is BASELINE.json:5's float golden-model analysis
role). The repo now has three independent threshold tools:

  * de.py        — exact quantized DE over lambda/rho degree spectra;
  * proto_de.py  — exact quantized multi-edge-type DE (structure-aware);
  * exit.py      — PEXIT: float sum-product ensemble under the symmetric-
                   Gaussian (consistency) approximation, per-edge-type
                   mutual-information recursion (Liva & Chiani's protograph
                   EXIT; ten Brink's J-function formalism).

PEXIT trades exactness for speed: one trajectory costs O(E * iters) scalar
updates (no pmfs, no convolutions) — measured ~35x faster per threshold
than proto_de at matched tolerance on the production bases, and far more
per screening trajectory (results/pexit_screen.json). That makes
it the DESIGN loop tool — candidate protographs (e.g. the PBRL-style
rate-compatible constructions in codes/peg.py / scripts/make_pbrl_ladder.py)
can be screened by the thousands under PEXIT, then the exact quantized
proto-DE and silicon Monte-Carlo validate the finalists. This is precisely
the methodology of the PBRL literature (protograph EXIT design + DE
verification).

Conventions (all standard):
  * BPSK over AWGN with noise std sigma_n: channel LLR ~ N(mu, 2*mu) with
    mu = 2/sigma_n^2, i.e. the consistent Gaussian with sigma_ch = 2/sigma_n.
  * J(sigma) = mutual information of a consistent Gaussian LLR
    N(sigma^2/2, sigma^2) with its bit; computed by Gauss-Hermite quadrature
    (no closed-form approximation constants to trust).
  * VN update:  I_ev(i,j) = J( sqrt(sum_{s!=i} Jinv(I_ec(s,j))^2 + sig_ch_j^2) )
  * CN update:  I_ec(i,j) = 1 - J( sqrt(sum_{t!=j} Jinv(1 - I_ev(i,t))^2) )
    (the reciprocal-channel / duality approximation).
  * APP:        I_app(j) = J( sqrt(sum_s Jinv(I_ec(s,j))^2 + sig_ch_j^2) ),
    approximate bit error Pe(j) = Q(sigma_app/2).

Rate matching is modeled per base column exactly as proto_de.column
classification: punctured blocks get sigma_ch = 0 (never transmitted),
shortened blocks get sigma_ch = SIGMA_MAX (known bits).

Pure NumPy, on the host.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Largest LLR-sigma the J/Jinv tables represent. J(SIGMA_MAX) is
# indistinguishable from 1 at double precision for thresholds at the 1e-6
# Pe scale; Jinv saturates here.
SIGMA_MAX = 80.0


@lru_cache(maxsize=1)
def _gh_nodes(n: int = 96) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Hermite nodes/weights for E[g(X)], X ~ N(0,1):
    E[g] = sum w_i g(sqrt(2) x_i) / sqrt(pi)."""
    x, w = np.polynomial.hermite.hermgauss(n)
    return np.sqrt(2.0) * x, w / math.sqrt(math.pi)


def J(sigma: np.ndarray) -> np.ndarray:
    """Mutual information of a consistent Gaussian LLR N(sigma^2/2, sigma^2).

    Vectorized; exact to quadrature precision (~1e-12 over the table range).
    J(0) = 0, J(inf) = 1, strictly increasing."""
    sigma = np.asarray(sigma, np.float64)
    x, w = _gh_nodes()
    L = (sigma[..., None] ** 2) / 2.0 + sigma[..., None] * x
    # 1 - E[log2(1 + e^{-L})]; logaddexp for stability at large |L|
    val = 1.0 - (np.logaddexp(0.0, -L) / math.log(2.0)) @ w
    return np.clip(val, 0.0, 1.0)


@lru_cache(maxsize=1)
def _jinv_table() -> Tuple[np.ndarray, np.ndarray]:
    """Monotone (I, sigma) table for Jinv interpolation. The grid is dense
    near 0 (J ~ sigma^2) and near SIGMA_MAX (J saturates); 16k knots give
    interpolation error ~1e-9 in I."""
    s = np.concatenate([
        np.linspace(0.0, 4.0, 8001),
        np.geomspace(4.0, SIGMA_MAX, 8001)[1:],
    ])
    return J(s), s


def J_inv(I: np.ndarray) -> np.ndarray:
    """Inverse of J by table interpolation; saturates at SIGMA_MAX."""
    tI, ts = _jinv_table()
    return np.interp(np.clip(np.asarray(I, np.float64), 0.0, tI[-1]), tI, ts)


def _edges(base: np.ndarray) -> Tuple[List[np.ndarray], List[np.ndarray],
                                      np.ndarray, np.ndarray]:
    """Edge list of a protograph: per-row/per-col edge indices and the
    (row, col) of every edge. QC shifts are irrelevant to the ensemble."""
    mb, nb = base.shape
    ei, ej = np.nonzero(np.asarray(base) >= 0)
    E = len(ei)
    by_row = [np.nonzero(ei == i)[0] for i in range(mb)]
    by_col = [np.nonzero(ej == j)[0] for j in range(nb)]
    return by_row, by_col, ei.astype(np.int64), ej.astype(np.int64)


def sigma_ch_for(nb: int, punct_cols, short_cols,
                 sigma_n: float) -> np.ndarray:
    """(nb,) per-base-column channel LLR sigma for BPSK-AWGN: punctured
    columns 0 (never transmitted), shortened columns SIGMA_MAX (known
    bits), else the consistent-Gaussian 2/sigma_n."""
    punct, short = set(map(int, punct_cols)), set(map(int, short_cols))
    out = np.full(nb, 2.0 / sigma_n)
    for j in range(nb):
        if j in short:
            out[j] = SIGMA_MAX
        elif j in punct:
            out[j] = 0.0
    return out


def sigma_ch_columns(code, sigma_n: float) -> np.ndarray:
    """(nb,) channel sigmas for an LDPCCode's rate matching (mirrors
    proto_de.column_channel_pmfs classification; raises on bit-granular
    punct/shortened sets that don't cover whole Z-blocks)."""
    from ..codes.code import qc_block_cover
    Z = code.Z
    return sigma_ch_for(code.base.shape[1],
                        qc_block_cover(code.punct_vns, Z, "punctured"),
                        qc_block_cover(code.shortened_vns, Z, "shortened"),
                        sigma_n)


def pexit_trajectory(base: np.ndarray, sigma_ch: np.ndarray,
                     iters: int = 500,
                     decision_cols: Optional[Sequence[int]] = None,
                     stop_above: float = 1.0 - 1e-9) -> np.ndarray:
    """APP mutual-information trajectory (min over decision columns).

    base: (mb, nb), entry >= 0 marks an edge type. sigma_ch: (nb,) channel
    LLR sigmas (sigma_ch_columns). Returns I_app after 0..iters iterations;
    stops early once min I_app > stop_above (converged) or the trajectory
    stalls (fixed point above the target is a non-converging channel)."""
    base = np.asarray(base)
    by_row, by_col, ei, ej = _edges(base)
    E = len(ei)
    nb = base.shape[1]
    dcols = (np.arange(nb) if decision_cols is None
             else np.asarray(decision_cols, np.int64))
    sig2_ch_e = np.asarray(sigma_ch, np.float64)[ej] ** 2

    I_ec = np.zeros(E)

    def app(I_ec):
        s2 = J_inv(I_ec) ** 2
        col_sum = np.bincount(ej, weights=s2, minlength=nb)
        return J(np.sqrt(col_sum + np.asarray(sigma_ch) ** 2))

    traj = [float(app(I_ec)[dcols].min())]
    for _ in range(iters):
        # VN: leave-one-out over columns
        s2 = J_inv(I_ec) ** 2
        col_sum = np.bincount(ej, weights=s2, minlength=nb)
        I_ev = J(np.sqrt(np.maximum(col_sum[ej] - s2, 0.0) + sig2_ch_e))
        # CN: leave-one-out over rows on Jinv(1 - I_ev)^2
        t2 = J_inv(1.0 - I_ev) ** 2
        row_sum = np.bincount(ei, weights=t2, minlength=base.shape[0])
        I_ec = 1.0 - J(np.sqrt(np.maximum(row_sum[ei] - t2, 0.0)))
        traj.append(float(app(I_ec)[dcols].min()))
        if traj[-1] > stop_above:
            break
        if len(traj) > 8 and abs(traj[-1] - traj[-8]) < 1e-13:
            break  # stalled fixed point
    return np.asarray(traj)


def pexit_converges(base: np.ndarray, sigma_ch: np.ndarray,
                    iters: int = 500,
                    decision_cols: Optional[Sequence[int]] = None,
                    target_pe: float = 1e-6) -> bool:
    """True when PEXIT drives every decision column's approximate Pe below
    target (Pe = Q(sigma_app / 2) under the consistency assumption)."""
    # I-target equivalent of the Pe target
    sig_target = 2.0 * _ppf_q(target_pe)
    i_target = float(J(np.array([min(sig_target, SIGMA_MAX)]))[0])
    traj = pexit_trajectory(base, sigma_ch, iters, decision_cols,
                            stop_above=i_target)
    return traj[-1] > i_target or traj[-1] >= 1.0 - 1e-12


def _ppf_q(p: float) -> float:
    """Inverse Gaussian tail: x with Q(x) = p (bisection; p < 0.5)."""
    lo, hi = 0.0, 60.0
    for _ in range(200):
        mid = (lo + hi) / 2
        if 0.5 * math.erfc(mid / math.sqrt(2.0)) > p:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def pexit_threshold_sigma(base: np.ndarray,
                          punct_cols: Sequence[int] = (),
                          short_cols: Sequence[int] = (),
                          iters: int = 500,
                          decision_cols: Optional[Sequence[int]] = None,
                          target_pe: float = 1e-6, tol: float = 1e-3,
                          bracket: Tuple[float, float] = (0.3, 2.5)) -> float:
    """Largest AWGN noise sigma_n at which PEXIT converges (bisection).
    Raises when the threshold sits outside the bracket on either side, so
    a saturated bracket can never masquerade as a real threshold."""
    nb = base.shape[1]

    def ok(sigma_n):
        return pexit_converges(base,
                               sigma_ch_for(nb, punct_cols, short_cols,
                                            sigma_n),
                               iters, decision_cols, target_pe)

    lo, hi = bracket
    assert ok(lo), "bracket low end must converge"
    if ok(hi):
        raise ValueError(
            f"PEXIT threshold exceeds the bracket's high end ({hi}); "
            f"raise the bracket (the returned value would otherwise "
            f"silently saturate at ~{hi})")
    while hi - lo > tol:
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if ok(mid) else (lo, mid)
    return lo


def pexit_threshold_awgn(code, iters: int = 500,
                         target_pe: float = 1e-6, tol: float = 1e-3,
                         bracket: Tuple[float, float] = (0.3, 2.5)
                         ) -> Tuple[float, float]:
    """(sigma_n*, Eb/N0* dB) of an LDPCCode under PEXIT, rate matching
    modeled per column; decision over info columns with shortened filler
    blocks excluded (same convention as proto_de_threshold_awgn)."""
    from ..codes.code import qc_block_cover
    Z = code.Z
    kb = code.k // Z
    short = qc_block_cover(code.shortened_vns, Z, "shortened")
    decision_cols = [j for j in range(kb) if j not in short]
    punct = sorted(qc_block_cover(code.punct_vns, Z, "punctured"))
    sigma = pexit_threshold_sigma(
        code.base, punct_cols=punct, short_cols=sorted(short), iters=iters,
        decision_cols=decision_cols, target_pe=target_pe, tol=tol,
        bracket=bracket)
    excl = set(map(int, code.punct_vns)) | set(map(int, code.shortened_vns))
    rate = code.k_eff / (code.n - len(excl))
    ebn0 = -20.0 * math.log10(sigma * math.sqrt(2.0 * rate))
    return sigma, ebn0


def exit_curves_regular(dv: int, dc: int, sigma_n: float,
                        grid: int = 201) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """The classic two-curve EXIT chart for a (dv, dc)-regular ensemble at
    noise sigma_n: returns (I_a, I_ev(I_a), I_ec_inverse(I_a)) where the
    decoder tunnel is open iff I_ev(x) > I_ec^{-1}(x) for all x < 1.

    I_ev(I_a)  = J( sqrt((dv-1) Jinv(I_a)^2 + sigma_ch^2) )
    I_ec(I_a)  = 1 - J( sqrt((dc-1)) * Jinv(1 - I_a) )  [plotted inverted]
    """
    Ia = np.linspace(0.0, 1.0 - 1e-9, grid)
    sig_ch = 2.0 / sigma_n
    I_ev = J(np.sqrt((dv - 1) * J_inv(Ia) ** 2 + sig_ch ** 2))
    # inverse of the CN transfer: x = I_ec(y) -> y; plot y vs x by sweeping y
    I_ec_of = 1.0 - J(math.sqrt(dc - 1) * J_inv(1.0 - Ia))
    return Ia, I_ev, I_ec_of
