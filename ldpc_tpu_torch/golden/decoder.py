"""Golden-model LDPC decoders (NumPy, scalar, deliberately simple).

This module is the single source of truth for the framework's bit-exact
fixed-point semantics (SURVEY.md §3.4, §4.2). It plays the role the reference's
C decoder + MATLAB float decoder played (BASELINE.json:5 'iterative
belief-propagation decoder (min-sum / offset-min-sum) with fixed-point LLR
quantization ... fixed-point saturation arithmetic'): every other decoder in the
port (torch op, CUDA kernel, C oracle in csrc/) must match
decode_fixed EXACTLY on identical integer inputs — min-sum over integers is
deterministic, so the contract is equality, not tolerance.

Pinned semantics (SURVEY.md §8, frozen here):
  * Quantizer: q = clip(round_half_away_from_zero(llr * scale), -qmax, +qmax),
    qmax = 2**(bits-1)-1 (symmetric; -(qmax+1) never occurs).
  * sign(x) = -1 if x < 0 else +1  (zero is positive).
  * CN update (min-sum family): for edge e into check c,
      c2v[e] = S * sign(v2c[e]) * max(minmag_excl(e) - beta, 0)
    where S = prod of signs of all incoming v2c, minmag_excl = second-smallest
    magnitude if e attains the smallest, else smallest. beta is an integer
    number of LSBs (0 = plain min-sum).
  * VN accumulation is EXACT in wide integers (posterior magnitude is bounded by
    qmax*(dv+1) < 2**15 for every supported code — asserted in tests);
    saturation to [-qmax, +qmax] happens only when producing v2c messages.
  * Hard decision: bit = 1 iff posterior < 0 (LLR > 0 means bit 0).
  * Flooding iteration: totals from previous c2v -> v2c -> new c2v -> new
    totals -> hard decision -> syndrome early-exit check.
  * Layered iteration: for each layer in order, v2c = sat(post - c2v), new c2v,
    post += new_c2v - old_c2v (exact); hard decision + syndrome once per full
    sweep. All checks within a layer read the SAME pre-layer posterior
    (parallel-within-layer semantics, matching the Z-parallel kernels).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..codes.code import LDPCCode


def quantize(llr: np.ndarray, scale: float = 4.0, bits: int = 8) -> np.ndarray:
    """Float LLR -> b-bit fixed point. Round half away from zero, saturate
    symmetrically (BASELINE.json:5 'fixed-point LLR quantization')."""
    qmax = (1 << (bits - 1)) - 1
    scaled = np.asarray(llr, np.float64) * scale
    r = np.where(scaled >= 0, np.floor(scaled + 0.5), np.ceil(scaled - 0.5))
    return np.clip(r, -qmax, qmax).astype(np.int32)


def _sign(x: np.ndarray) -> np.ndarray:
    """-1 where negative else +1 (zero positive)."""
    return np.where(x < 0, -1, 1).astype(np.int32)


def _mag_xform(excl, beta: int, alpha):
    """The pinned CN magnitude transform (config.QuantConfig docstring):
    mag' = min(max(((excl * num) >> shift) - beta, 0), qmax-cap applied by
    the caller). alpha = (num, shift) scales by the dyadic rational
    num/2**shift (normalized min-sum); None is the identity. The >> is a
    floor shift on a nonnegative value, so it is exactly reproducible in
    int32 on every backend."""
    if alpha is not None:
        num, shift = alpha
        excl = (excl * num) >> shift
    return np.maximum(excl - beta, 0)


def _cn_update(v2c: np.ndarray, beta: int, qmax: int, alpha=None) -> np.ndarray:
    """Min-sum check-node update for one check's incoming messages (1-D).

    Degree-1 checks: the exclude-self minimum is over the empty set, defined as
    qmax (matches the dense padded implementations, whose pad slots carry
    magnitude qmax and sign +1), giving c2v = +xform(qmax).
    """
    if len(v2c) == 1:
        return np.array([int(_mag_xform(np.int32(qmax), beta, alpha))],
                        np.int32)
    mags = np.abs(v2c)
    order = np.argsort(mags, kind="stable")
    min1 = mags[order[0]]
    min2 = mags[order[1]]
    amin = order[0]
    sprod = int(np.prod(_sign(v2c)))
    excl = np.where(np.arange(len(v2c)) == amin, min2, min1)
    mag = _mag_xform(excl, beta, alpha)
    mag = np.minimum(mag, qmax)
    return (sprod * _sign(v2c) * mag).astype(np.int32)


_MINSTAR_INF = np.int32(1 << 14)  # box-plus identity sentinel (magnitude)


def _corr(u, thresholds) -> np.ndarray:
    """Threshold-LUT Jacobian correction: one LSB per crossed threshold
    (config.minstar_thresholds). u is a nonnegative int magnitude."""
    c = np.zeros_like(np.asarray(u, np.int32))
    for t in thresholds:
        c = c + (np.asarray(u) <= t).astype(np.int32)
    return c


def _boxplus2(x, y, thresholds, qmax: int):
    """Pinned fixed-point pairwise box-plus (min* CN arithmetic):

        mag  = clip(min(|x|,|y|) + c(|x|+|y|) - c(||x|-|y||), 0, qmax)
        sign = sign(x) * sign(y)            (sign(0) = +1)

    with c the threshold-LUT correction. The magnitude clip applies at
    EVERY combine (not only at the end) — part of the pinned semantics.
    The identity element is +_MINSTAR_INF: both corrections vanish there
    (thresholds are tiny), so boxplus2(x, INF) == clip(|x|,0,qmax)*sign(x)
    == x for in-range x. With an empty threshold tuple the operation
    degenerates to sign-min — exclude-self min-sum exactly (tested)."""
    ax, ay = np.abs(x), np.abs(y)
    mag = (np.minimum(ax, ay) + _corr(ax + ay, thresholds)
           - _corr(np.abs(ax - ay), thresholds))
    mag = np.clip(mag, 0, qmax)
    return np.where((x < 0) != (y < 0), -mag, mag).astype(np.int32)


def _cn_update_minstar(v2c: np.ndarray, thresholds, qmax: int) -> np.ndarray:
    """Min* check-node update: exclude-self box-plus over the check's
    incoming messages via prefix/suffix combines in NEIGHBOR-LIST ORDER
    (cn_adj ascending VN index — the pinned evaluation order; box-plus is
    associative in reals but fixed-point rounding makes the order part of
    the semantics). Degree-1 check: boxplus2(INF, INF) = +qmax, matching
    the min-sum convention."""
    d = len(v2c)
    pre = np.empty(d + 1, np.int32)
    suf = np.empty(d + 1, np.int32)
    pre[0] = _MINSTAR_INF
    suf[d] = _MINSTAR_INF
    for i in range(d):
        pre[i + 1] = _boxplus2(pre[i], np.int32(v2c[i]), thresholds, qmax)
        j = d - 1 - i
        suf[j] = _boxplus2(np.int32(v2c[j]), suf[j + 1], thresholds, qmax)
    return np.asarray([_boxplus2(pre[i], suf[i + 1], thresholds, qmax)
                       for i in range(d)], np.int32)


@dataclass
class DecodeResult:
    hard: np.ndarray          # (n,) uint8 decoded bits
    iters: int                # iterations actually run
    converged: bool           # syndrome satisfied at exit
    trace: Optional[List[dict]] = None  # per-iteration message dumps


def decode_fixed(
    chan: np.ndarray,
    code: LDPCCode,
    max_iter: int = 20,
    beta: int = 0,
    qmax: int = 127,
    schedule: str = "flooding",
    early_term: bool = True,
    trace: bool = False,
    alpha=None,
    minstar=None,
) -> DecodeResult:
    """Bit-exact fixed-point min-sum / offset / normalized-min-sum /
    min* decoder, one codeword.

    chan: (n,) integer channel LLRs already quantized to [-qmax, qmax].
    alpha: (num, shift) normalized-min-sum scaling, or None (see _mag_xform).
    minstar: threshold tuple (config.minstar_thresholds) — selects the
    min* CN update (_cn_update_minstar); beta/alpha must be 0/None then.
    """
    chan = np.asarray(chan, np.int32)
    assert chan.shape == (code.n,)
    if minstar is not None and (beta or alpha is not None):
        raise ValueError("min-star does not compose with beta/alpha")
    if schedule == "flooding":
        return _decode_flooding(chan, code, max_iter, beta, qmax, early_term,
                                trace, alpha, minstar)
    elif schedule == "layered":
        return _decode_layered(chan, code, max_iter, beta, qmax, early_term,
                               trace, alpha, minstar)
    raise ValueError(schedule)


def _syndrome_ok(code: LDPCCode, hard: np.ndarray) -> bool:
    for vs in code.cn_adj:
        if np.bitwise_xor.reduce(hard[vs]) != 0:
            return False
    return True


def _decode_flooding(chan, code, max_iter, beta, qmax, early_term, trace,
                     alpha=None, minstar=None):
    cn = (lambda v2c: _cn_update_minstar(v2c, minstar, qmax)
          ) if minstar is not None else (
        lambda v2c: _cn_update(v2c, beta, qmax, alpha))
    # c2v stored per (check, slot) as a ragged list of arrays.
    c2v = [np.zeros(len(vs), np.int32) for vs in code.cn_adj]
    tr: List[dict] = []
    total = chan.copy()
    hard = (total < 0).astype(np.uint8)
    it_done = 0
    converged = _syndrome_ok(code, hard) if early_term else False
    for it in range(max_iter):
        if converged:
            break
        # VN pass: totals from previous c2v, then per-edge extrinsic v2c.
        total = chan.copy()
        for c, vs in enumerate(code.cn_adj):
            np.add.at(total, vs, c2v[c])
        new_c2v = []
        for c, vs in enumerate(code.cn_adj):
            v2c = np.clip(total[vs] - c2v[c], -qmax, qmax)
            new_c2v.append(cn(v2c))
        c2v = new_c2v
        # Posterior + hard decision from the NEW messages.
        total = chan.copy()
        for c, vs in enumerate(code.cn_adj):
            np.add.at(total, vs, c2v[c])
        hard = (total < 0).astype(np.uint8)
        it_done = it + 1
        if trace:
            tr.append({"iter": it_done,
                       "c2v": [a.copy() for a in c2v],
                       "total": total.copy(),
                       "hard": hard.copy()})
        if early_term and _syndrome_ok(code, hard):
            converged = True
    if not early_term:
        converged = _syndrome_ok(code, hard)
    return DecodeResult(hard=hard, iters=it_done, converged=converged,
                        trace=tr if trace else None)


def _decode_layered(chan, code, max_iter, beta, qmax, early_term, trace,
                    alpha=None, minstar=None):
    cn = (lambda v2c: _cn_update_minstar(v2c, minstar, qmax)
          ) if minstar is not None else (
        lambda v2c: _cn_update(v2c, beta, qmax, alpha))
    from ..codes.layout import compile_layers_general, compile_qc_layout

    if code.base is not None and code.Z is not None:
        qc = compile_qc_layout(code)
        layers = [np.arange(i * qc.Z, (i + 1) * qc.Z, dtype=np.int32)
                  for i in range(qc.mb)]
    else:
        layers = compile_layers_general(code)

    c2v = [np.zeros(len(vs), np.int32) for vs in code.cn_adj]
    post = chan.astype(np.int32).copy()
    tr: List[dict] = []
    hard = (post < 0).astype(np.uint8)
    it_done = 0
    converged = _syndrome_ok(code, hard) if early_term else False
    for it in range(max_iter):
        if converged:
            break
        for layer in layers:
            # All checks in the layer read the same pre-layer posterior.
            pre = post.copy()
            for c in layer:
                vs = code.cn_adj[c]
                v2c = np.clip(pre[vs] - c2v[c], -qmax, qmax)
                new = cn(v2c)
                post[vs] += new - c2v[c]
                c2v[c] = new
        hard = (post < 0).astype(np.uint8)
        it_done = it + 1
        if trace:
            tr.append({"iter": it_done,
                       "c2v": [a.copy() for a in c2v],
                       "total": post.copy(),
                       "hard": hard.copy()})
        if early_term and _syndrome_ok(code, hard):
            converged = True
    if not early_term:
        converged = _syndrome_ok(code, hard)
    return DecodeResult(hard=hard, iters=it_done, converged=converged,
                        trace=tr if trace else None)


# ---------------------------------------------------------------------------
# Hard-decision golden decoders — the BSC companions to ops/channel.bsc
# (SURVEY.md §5.3 fault injection). Gallager-A/B message passing and the
# parallel bit-flipping decoder operate directly on hard channel bits; they
# are the classic low-complexity counterparts every fixed-point LDPC study
# keeps next to min-sum. Like decode_fixed, these are integer-deterministic:
# the batched jnp op (ops/decode_hard.py) must match them EXACTLY.
#
# Applicability caveat (measured, see tests/test_decode_hard.py and
# results/bsc_hard_wifi648): Gallager-A/B analysis assumes variable degree
# >= 3. On the standard codes in this repo ~half the variables have degree 2
# (dual-diagonal parity chains), through which hard-decision message passing
# propagates errors — unconverged frames can end far from the codeword.
# Parallel bit-flipping degrades gracefully there; both are stress-test /
# study decoders, not replacements for the soft min-sum family.
#
# Pinned semantics (frozen here, mirrored by ops/decode_hard.py):
#   * Edge messages are bits {0, 1}; init v2c[e] = y[vn(e)].
#   * CN update: c2v[e] = XOR of the OTHER incoming v2c bits on the check
#     (empty exclusion set, i.e. a degree-1 check, yields 0).
#   * Decision: with D(v) = #{incoming c2v != y[v]}, hard[v] = 1 - y[v] iff
#     2*D(v) > dv(v), else y[v] (tie keeps the channel bit).
#   * VN message update (after a non-converged decision): for edge e at
#     variable v, d_e = #{OTHER incoming c2v != y[v]}; v2c[e] = 1 - y[v] iff
#     d_e >= t(v), else y[v].
#   * Thresholds: Gallager-B default t(v) = floor((dv(v)-1)/2) + 1 (strict
#     majority of the other checks); Gallager-A t(v) = max(dv(v)-1, 1) (all
#     other checks must disagree). An explicit integer threshold overrides.
#   * Iteration = CN pass -> decision -> syndrome early-exit -> VN pass;
#     iters counts CN passes executed, 0 when y is already a codeword.
#   * Parallel bit-flipping keeps a bit estimate x (init y), no messages:
#     per iteration flip every v with 2*unsat(v) > dv(v) (strict majority of
#     its checks unsatisfied; explicit threshold t means unsat(v) >= t),
#     then re-check the syndrome.
# ---------------------------------------------------------------------------


def _default_thresholds(code: LDPCCode, algorithm: str) -> np.ndarray:
    dv = np.zeros(code.n, np.int32)
    for vs in code.cn_adj:
        dv[vs] += 1
    if algorithm == "gallager-a":
        return np.maximum(dv - 1, 1).astype(np.int32)
    return ((dv - 1) // 2 + 1).astype(np.int32)


def decode_hard(
    y: np.ndarray,
    code: LDPCCode,
    max_iter: int = 30,
    algorithm: str = "gallager-b",
    threshold: Optional[int] = None,
    early_term: bool = True,
) -> DecodeResult:
    """Hard-decision decoder, one codeword of channel bits y in {0,1}^n.

    algorithm: 'gallager-b' | 'gallager-a' | 'bit-flip'. threshold overrides
    the per-variable default (see module notes above) with a constant.
    """
    y = np.asarray(y, np.int32)
    assert y.shape == (code.n,) and ((y == 0) | (y == 1)).all()
    if algorithm == "bit-flip":
        return _decode_bitflip(y, code, max_iter, threshold, early_term)
    if algorithm not in ("gallager-a", "gallager-b"):
        raise ValueError(algorithm)
    dv = np.zeros(code.n, np.int32)
    for vs in code.cn_adj:
        dv[vs] += 1
    t = (np.full(code.n, int(threshold), np.int32) if threshold is not None
         else _default_thresholds(code, algorithm))

    v2c = [y[vs].copy() for vs in code.cn_adj]
    hard = y.astype(np.uint8)
    it_done = 0
    converged = _syndrome_ok(code, hard) if early_term else False
    for _ in range(max_iter):
        if converged:
            break
        # CN pass: exclude-self XOR.
        c2v = []
        for c, vs in enumerate(code.cn_adj):
            par = np.bitwise_xor.reduce(v2c[c]) if len(v2c[c]) else 0
            c2v.append(np.bitwise_xor(par, v2c[c]))
        # Decision: majority of incoming messages vs the channel bit.
        dis = np.zeros(code.n, np.int32)
        for c, vs in enumerate(code.cn_adj):
            np.add.at(dis, vs, (c2v[c] != y[vs]).astype(np.int32))
        hard = np.where(2 * dis > dv, 1 - y, y).astype(np.uint8)
        it_done += 1
        if early_term and _syndrome_ok(code, hard):
            converged = True
            break
        # VN pass: exclude-self disagreement count vs threshold.
        v2c = []
        for c, vs in enumerate(code.cn_adj):
            d_e = dis[vs] - (c2v[c] != y[vs]).astype(np.int32)
            v2c.append(np.where(d_e >= t[vs], 1 - y[vs], y[vs]))
    if not early_term:
        converged = _syndrome_ok(code, hard)
    return DecodeResult(hard=hard, iters=it_done, converged=converged)


def _decode_bitflip(y, code, max_iter, threshold, early_term):
    dv = np.zeros(code.n, np.int32)
    for vs in code.cn_adj:
        dv[vs] += 1
    x = y.copy()
    hard = x.astype(np.uint8)
    it_done = 0
    converged = _syndrome_ok(code, hard) if early_term else False
    for _ in range(max_iter):
        if converged:
            break
        unsat = np.zeros(code.n, np.int32)
        for c, vs in enumerate(code.cn_adj):
            if np.bitwise_xor.reduce(x[vs]) != 0:
                unsat[vs] += 1
        flip = (unsat >= int(threshold)) if threshold is not None \
            else (2 * unsat > dv)
        x = np.where(flip, 1 - x, x)
        hard = x.astype(np.uint8)
        it_done += 1
        if early_term and _syndrome_ok(code, hard):
            converged = True
    if not early_term:
        converged = _syndrome_ok(code, hard)
    return DecodeResult(hard=hard, iters=it_done, converged=converged)


# ---------------------------------------------------------------------------
# Float golden decoders — used to measure the fixed-point "quantization bound"
# (BASELINE.json:5 'within its fixed-point quantization bound'), the same
# float-vs-fixed methodology the reference's MATLAB layer provided.
# ---------------------------------------------------------------------------

def decode_float(
    chan_llr: np.ndarray,
    code: LDPCCode,
    max_iter: int = 20,
    # 'sum-product' | 'min-sum' | 'offset-min-sum' | 'normalized-min-sum'
    algorithm: str = "sum-product",
    beta: float = 0.5,  # OMS offset; carries the NMS alpha factor
    schedule: str = "flooding",
    early_term: bool = True,
) -> DecodeResult:
    """Floating-point BP decoder, one codeword. schedule='layered' mirrors
    _decode_layered's pinned semantics (all checks of a layer read the same
    pre-layer posterior; syndrome once per full sweep) so layered
    fixed-point runs have a same-schedule float quantization bound."""
    chan = np.asarray(chan_llr, np.float64)
    assert chan.shape == (code.n,)
    c2v = [np.zeros(len(vs)) for vs in code.cn_adj]
    hard = (chan < 0).astype(np.uint8)
    it_done = 0
    converged = _syndrome_ok(code, hard) if early_term else False

    def cn_float(v2c: np.ndarray) -> np.ndarray:
        if algorithm == "sum-product":
            t = np.tanh(np.clip(v2c, -30, 30) / 2.0)
            # exclude-self product via full product / self, guarding zeros
            eps = 1e-15
            t = np.where(np.abs(t) < eps, np.where(t < 0, -eps, eps), t)
            p = np.prod(t)
            r = np.clip(p / t, -0.999999999, 0.999999999)
            return 2.0 * np.arctanh(r)
        mags = np.abs(v2c)
        order = np.argsort(mags, kind="stable")
        min1, amin = mags[order[0]], order[0]
        min2 = mags[order[1]] if len(mags) > 1 else min1
        sgn = np.where(v2c < 0, -1.0, 1.0)
        sprod = np.prod(sgn)
        excl = np.where(np.arange(len(v2c)) == amin, min2, min1)
        if algorithm == "offset-min-sum":
            excl = np.maximum(excl - beta, 0.0)
        elif algorithm == "normalized-min-sum":
            excl = excl * beta
        return sprod * sgn * excl

    if schedule == "layered":
        from ..codes.layout import compile_layers_general, compile_qc_layout
        if code.base is not None and code.Z is not None:
            qc = compile_qc_layout(code)
            layers = [np.arange(i * qc.Z, (i + 1) * qc.Z, dtype=np.int32)
                      for i in range(qc.mb)]
        else:
            layers = compile_layers_general(code)
        post = chan.copy()
        for it in range(max_iter):
            if converged:
                break
            for layer in layers:
                pre = post.copy()
                for c in layer:
                    vs = code.cn_adj[c]
                    new = cn_float(pre[vs] - c2v[c])
                    post[vs] += new - c2v[c]
                    c2v[c] = new
            hard = (post < 0).astype(np.uint8)
            it_done = it + 1
            if early_term and _syndrome_ok(code, hard):
                converged = True
        if not early_term:
            converged = _syndrome_ok(code, hard)
        return DecodeResult(hard=hard, iters=it_done, converged=converged)
    elif schedule != "flooding":
        raise ValueError(schedule)

    for it in range(max_iter):
        if converged:
            break
        total = chan.copy()
        for c, vs in enumerate(code.cn_adj):
            np.add.at(total, vs, c2v[c])
        new_c2v = []
        for c, vs in enumerate(code.cn_adj):
            v2c = total[vs] - c2v[c]
            new_c2v.append(cn_float(v2c))
        c2v = new_c2v
        total = chan.copy()
        for c, vs in enumerate(code.cn_adj):
            np.add.at(total, vs, c2v[c])
        hard = (total < 0).astype(np.uint8)
        it_done = it + 1
        if early_term and _syndrome_ok(code, hard):
            converged = True
    if not early_term:
        converged = _syndrome_ok(code, hard)
    return DecodeResult(hard=hard, iters=it_done, converged=converged)
