"""Protograph (multi-edge-type) density evolution for quantized min-sum.

A copy of `ldpc_tpu/analysis/proto_de.py` under the same names; it
reads the port's `config.QuantConfig`, `analysis.de` and
`codes.code.qc_block_cover`. Its outputs equal the reference's bit
for bit.


The single-edge-type DE in `de.py` mixes message densities by degree
SPECTRA — exact only for the unstructured lambda/rho ensemble. The
production codes are STRUCTURED protographs (QC base matrices), and the
structure matters in both documented directions (results/
de_thresholds.json):

  * DVB-S2's IRA staircase measures ~0.2 dB BETTER than its lambda/rho
    ensemble threshold (structure gain the single-edge DE cannot see);
  * NR's rate matching (2Z punctured systematic columns at channel LLR 0,
    shortened filler columns pinned at +qmax) is a per-COLUMN property —
    unmodelable by iid-channel spectra DE, which also drowns the info-bit
    view in the degree-1 extension parities' decision floor.

Here every BASE-MATRIX ENTRY is its own edge type carrying its own message
pmf, every COLUMN has its own channel pmf (standard / punctured-zero /
shortened-saturated), and the decision error is reported per column class
— so thresholds apply to the actual rate-matched code. The lifting Z is
irrelevant to DE (all Z copies of an edge type are exchangeable on the
cycle-free ensemble); parallel edges don't occur in QC bases (one shift
per cell).

Integer semantics are the repo's pinned ones, shared with de.py
(`_cn_pair` signed-min fold, `_cn_mag_transform` offset/normalized
magnitude rule, exact wide VN accumulation then one saturation —
golden/decoder.py is the contract). A fully symmetric base (all rows one
degree, all columns one degree, uniform channel) collapses to the
(dv, dc)-regular recursion exactly — tested against de.de_pe_trajectory.

Cost: O(E) leave-one-out folds/convolutions per iteration via
prefix/suffix arrays (both the CN fold and the VN convolution are
associative + commutative on independent messages). NR BG1 (316 entries,
column degrees to 30) runs ~1 s/iteration in NumPy — thresholds are an
offline-artifact workload (scripts/make_proto_thresholds.py), not a test
one; tests pin the regular-collapse equality and tiny bases.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..config import QuantConfig
from .de import _cn_pair_ops, _sat_center, chan_pmf_awgn


def column_channel_pmfs(code, sigma: float, quant: QuantConfig
                        ) -> np.ndarray:
    """(nb, 2Q+1) per-BASE-COLUMN channel pmfs for BPSK-AWGN with the
    code's rate matching: punctured columns are never transmitted (LLR 0,
    a delta at 0), shortened filler columns are known zeros (saturated
    +qmax, the pipeline's 1e6 LLR); every other column sees the quantized
    AWGN LLR pmf. Columns are classified by their Z-block: rate matching
    puncture/shorten whole blocks in the QC constructions."""
    Q = quant.qmax
    nb = code.base.shape[1]
    Z = code.Z
    std = chan_pmf_awgn(sigma, quant)
    from ..codes.code import qc_block_cover
    punct = qc_block_cover(code.punct_vns, Z, "punctured")
    short = qc_block_cover(code.shortened_vns, Z, "shortened")
    out = np.zeros((nb, 2 * Q + 1))
    for j in range(nb):
        if j in short:
            out[j, Q + Q] = 1.0      # known zero -> +qmax
        elif j in punct:
            out[j, Q] = 1.0          # not transmitted -> LLR 0
        else:
            out[j] = std
    return out


def proto_de_trajectory(
        base: np.ndarray, chan_pmfs: np.ndarray,
        beta: int = 0, alpha: Optional[Tuple[int, int]] = None,
        qmax: int = 127, iters: int = 100,
        decision_cols: Optional[Sequence[int]] = None,
        stop_below: float = 1e-12,
        minstar: Optional[tuple] = None) -> np.ndarray:
    """Pe trajectory of quantized min-sum (or min*, via minstar =
    config.minstar_thresholds) protograph DE.

    base: (mb, nb) int array, entry >= 0 marks an edge type (QC shifts are
    irrelevant here). chan_pmfs: (nb, 2*qmax+1). decision_cols: columns
    averaged into the reported Pe (default: all). Returns Pe after
    0..iters iterations, Pe = mean over decision columns of
    P(decision total < 0)."""
    Q = qmax
    pair, xform = _cn_pair_ops(Q, beta, alpha, minstar)
    mb, nb = base.shape
    by_row = [np.nonzero(base[i] >= 0)[0] for i in range(mb)]
    by_col = [np.nonzero(base[:, j] >= 0)[0] for j in range(nb)]
    eid: Dict[Tuple[int, int], int] = {}
    for i in range(mb):
        for j in by_row[i]:
            eid[(i, int(j))] = len(eid)
    E = len(eid)
    dcols = (np.arange(nb) if decision_cols is None
             else np.asarray(decision_cols, np.int64))

    # v2c init: each edge carries its column's channel pmf
    v2c = np.zeros((E, 2 * Q + 1))
    for (i, j), e in eid.items():
        v2c[e] = chan_pmfs[j]

    def cn_step(v2c):
        """c2v[e] = mag-transform of the signed-min fold over the OTHER
        edges of e's row (prefix/suffix folds; the pairwise fold is
        associative + commutative on independent messages)."""
        c2v = np.empty_like(v2c)
        for i in range(mb):
            cols = by_row[i]
            d = len(cols)
            msgs = [v2c[eid[(i, int(j))]] for j in cols]
            if d == 1:
                # empty exclusion set = +qmax (golden rule)
                spike = np.zeros(2 * Q + 1)
                spike[Q + Q] = 1.0
                c2v[eid[(i, int(cols[0]))]] = xform(spike)
                continue
            pre = [msgs[0]]
            for k in range(1, d - 1):
                pre.append(pair(pre[-1], msgs[k]))
            suf = [msgs[-1]]
            for k in range(d - 2, 0, -1):
                suf.append(pair(suf[-1], msgs[k]))
            suf = suf[::-1]  # suf[k] = fold of msgs[k+1..d-1]... shifted
            for t, j in enumerate(cols):
                if t == 0:
                    excl = suf[0]
                elif t == d - 1:
                    excl = pre[d - 2]
                else:
                    excl = pair(pre[t - 1], suf[t])
                c2v[eid[(i, int(j))]] = xform(excl)
        return c2v

    def vn_step(c2v):
        """v2c[e] = saturate(chan_j + sum of the OTHER edges' c2v), exact
        wide accumulation then ONE saturation (pinned VN rule); also the
        per-column decision Pe from the FULL sum."""
        v2c = np.empty_like(c2v)
        pe_col = np.zeros(nb)
        for j in range(nb):
            rows = by_col[j]
            d = len(rows)
            msgs = [c2v[eid[(int(i), j)]] for i in rows]
            chan = chan_pmfs[j]
            # prefix[k] = chan conv msgs[0..k-1]; suffix[k] = msgs[k..d-1]
            pre = [chan]
            for k in range(d):
                pre.append(np.convolve(pre[-1], msgs[k]))
            suf = [msgs[-1]] if d else []
            for k in range(d - 2, -1, -1):
                suf.append(np.convolve(suf[-1], msgs[k]))
            suf = suf[::-1]  # suf[k] = conv of msgs[k..d-1]
            full = pre[d]
            C = (len(full) - 1) // 2
            pe_col[j] = full[:C].sum()
            for t, i in enumerate(rows):
                if d == 1:
                    acc = chan
                elif t == d - 1:
                    acc = pre[d - 1]
                else:
                    acc = np.convolve(pre[t], suf[t + 1])
                v2c[eid[(int(i), j)]] = _sat_center(acc, Q)
        # roundoff control (same rationale as de.py): renormalize
        np.maximum(v2c, 0.0, out=v2c)
        v2c /= v2c.sum(axis=1, keepdims=True)
        return v2c, pe_col

    traj = [float(np.mean([chan_pmfs[j][:Q].sum() for j in dcols]))]
    for _ in range(iters):
        c2v = cn_step(v2c)
        v2c, pe_col = vn_step(c2v)
        traj.append(float(pe_col[dcols].mean()))
        if traj[-1] < stop_below:
            break
    return np.asarray(traj)


def proto_de_threshold_awgn(
        code, quant: QuantConfig, beta: int = 0,
        alpha: Optional[Tuple[int, int]] = None,
        iters: int = 80, target: float = 1e-6, tol: float = 5e-3,
        bracket: Tuple[float, float] = (0.3, 1.5),
        decision_cols: Optional[Sequence[int]] = None,
        minstar: Optional[tuple] = None) -> float:
    """Largest AWGN sigma at which protograph DE drives the decision Pe
    (over decision_cols; default: the code's info-bit base columns,
    shortened filler blocks excluded) below target. Rate matching is
    modeled per column (column_channel_pmfs)."""
    if decision_cols is None:
        Z = code.Z
        kb = code.k // Z
        short = {int(v) // Z for v in code.shortened_vns}
        decision_cols = [j for j in range(kb) if j not in short]
    lo, hi = bracket

    def ok(sigma):
        pe = proto_de_trajectory(
            code.base, column_channel_pmfs(code, sigma, quant),
            beta=beta, alpha=alpha, qmax=quant.qmax, iters=iters,
            decision_cols=decision_cols, stop_below=target * 1e-3,
            minstar=minstar)
        return pe[-1] < target

    assert ok(lo), "bracket low end must converge"
    while hi - lo > tol:
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if ok(mid) else (lo, mid)
    return lo
