"""Pure-torch fixed-point decoders (counterpart of
`ldpc_tpu/ops/decode_ref.py`: `make_flooding_decoder`,
`make_layered_decoder`, `make_decoder`).

The port's CPU decoders and the plain versions of the CUDA kernels
`kernels/csrc/minsum_flood.cu` (flooding) and `minsum_layered.cu`
(layered): the same dense padded gathers as the reference ops, on any
torch device. Min-sum, offset (beta) and normalized (dyadic alpha) CN
updates, or min* (`minstar=` the threshold tuple of
`config.minstar_thresholds`; the plain version of kernel K5, csrc/
cn_minstar.cuh), fixed iterations or per-lane early termination. Bit-exact
with `golden.decoder.decode_fixed` for either schedule.

Layout: messages live check-major in a flat (m * max_dc + 1) int32 buffer
per codeword; the last slot is a zero dump/pad slot (codes/layout.py).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..codes.code import LDPCCode
from ..codes.layout import compile_edge_layout, compile_layers_general
from ..config import DecoderConfig, QuantConfig, cn_params, minstar_thresholds

_BIG = 1 << 15
# The box-plus identity: both corrections vanish there (thresholds are tiny)
# and the clip brings min(|x|, INF) back to |x|, so bp2(x, INF) == x for x in
# [-qmax, qmax].
_MINSTAR_INF = 1 << 20

Decoded = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _cn_update(v2c: torch.Tensor, mask: torch.Tensor, beta: int,
               alpha=None) -> torch.Tensor:
    """Min-sum CN update on dense (..., C, D) int32 messages.

    Pad slots must hold +qmax (they never win the min and have a positive
    sign); output pads are zeroed. The excluded slot is the first slot of
    minimum magnitude (golden's stable argmin; torch.argmin returns the
    first minimal index)."""
    mags = v2c.abs()
    amin = mags.argmin(dim=-1, keepdim=True)
    slots = torch.arange(v2c.shape[-1], device=v2c.device)
    first = slots == amin
    min1 = mags.amin(dim=-1, keepdim=True)
    min2 = torch.where(first, _BIG, mags).amin(dim=-1, keepdim=True)
    neg = v2c < 0
    par = (neg.sum(dim=-1, keepdim=True) & 1).bool()
    excl_neg = par ^ neg
    excl_mag = torch.where(first, min2, min1)
    if alpha is not None:
        excl_mag = (excl_mag * alpha[0]) >> alpha[1]
    mag = torch.clamp(excl_mag - beta, min=0)
    val = torch.where(excl_neg, -mag, mag)
    return torch.where(mask, val, 0)


def _boxplus2(x: torch.Tensor, y: torch.Tensor, thresholds, qmax: int
              ) -> torch.Tensor:
    """The pinned fixed-point pairwise box-plus of min*:
    sign(x) sign(y) clip(min(|x|, |y|) + c(|x| + |y|) - c(||x| - |y||), 0,
    qmax), c(u) = #{T in thresholds : u <= T}, sign(0) = +1; a combine of
    magnitude 0 forgets its sign."""
    ax, ay = x.abs(), y.abs()
    mag = torch.minimum(ax, ay)
    if thresholds:
        s, d = ax + ay, (ax - ay).abs()
        for t in thresholds:
            mag = mag + (s <= t).to(torch.int32) - (d <= t).to(torch.int32)
    mag = torch.clamp(mag, 0, qmax)
    return torch.where((x < 0) != (y < 0), -mag, mag)


def _cn_update_minstar(v2c: torch.Tensor, mask: torch.Tensor, thresholds,
                       qmax: int) -> torch.Tensor:
    """min* CN update on dense (..., C, D) int32 messages already clipped to
    [-qmax, qmax]: exclude-self box-plus by prefix/suffix combines in slot
    order (the check's variables ascending), out[i] = bp2(pre[i],
    suf[i + 1]) with pre[0] = suf[D] = INF. `_boxplus2` with its clip is not
    associative, so the order is part of the result. Pad slots (mask false)
    are skipped by the chains (two INFs would combine to qmax, not to INF)
    and give 0; a row of degree 1 gives +qmax."""
    D = v2c.shape[-1]
    inf = torch.full_like(v2c[..., 0], _MINSTAR_INF)
    pre = [inf]
    for i in range(D - 1):
        pre.append(torch.where(
            mask[..., i], _boxplus2(pre[-1], v2c[..., i], thresholds, qmax),
            pre[-1]))
    suf = [inf]                                    # suf[D], then downwards
    for j in range(D - 1, 0, -1):
        suf.append(torch.where(
            mask[..., j], _boxplus2(v2c[..., j], suf[-1], thresholds, qmax),
            suf[-1]))
    suf.reverse()                                  # suf[k] is list item k - 1
    out = torch.stack([_boxplus2(pre[i], suf[i], thresholds, qmax)
                       for i in range(D)], dim=-1)
    return torch.where(mask, out, 0)


def _cn_fn(beta: int, alpha, minstar, qmax: int):
    """The CN update of a decoder as f(v2c, mask); min* composes with
    neither beta nor alpha."""
    if minstar is None:
        return lambda v2c, mask: _cn_update(v2c, mask, beta, alpha)
    if beta or alpha is not None:
        raise ValueError("min-star does not compose with beta/alpha")
    thr = tuple(int(t) for t in minstar)
    return lambda v2c, mask: _cn_update_minstar(v2c, mask, thr, qmax)


def _on_device(tables_np):
    """Per-device cache of the decoder's index tables."""
    tables: Dict[torch.device, tuple] = {}

    def on(device: torch.device):
        if device not in tables:
            tables[device] = tuple(torch.as_tensor(t, device=device)
                                   for t in tables_np)
        return tables[device]

    return on


def _syndrome_ok(hard: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
    """hard (B, n) bool/int -> (B,) bool; ev (m, D) variable per check slot,
    pad = n (a zero column appended to hard)."""
    bits = torch.nn.functional.pad(hard.to(torch.int32), (0, 1))[:, ev]
    synd = bits.sum(dim=-1, dtype=torch.int32) & 1
    return ~synd.bool().any(dim=-1)


def make_flooding_decoder(
    code: LDPCCode,
    max_iter: int = 20,
    beta: int = 0,
    qmax: int = 127,
    early_term: bool = True,
    alpha=None,
    minstar=None,
) -> Callable[[torch.Tensor], Decoded]:
    """Returns decode(chan[B, n] integer LLRs) -> (hard[B, n] uint8,
    iters[B] int32, converged[B] bool), computed on chan's device.
    minstar: the min* threshold tuple (`()` for no correction), or None for
    the min-sum family."""
    cn_update = _cn_fn(beta, alpha, minstar, qmax)
    lay = compile_edge_layout(code)
    M, D = lay.m, lay.max_dc
    on = _on_device((np.asarray(lay.ev_dense, np.int64),
                     np.asarray(lay.vn_pos, np.int64),
                     np.asarray(lay.cn_mask, bool)))

    def decode(chan: torch.Tensor) -> Decoded:
        ev, vn_pos, mask = on(chan.device)
        B = chan.shape[0]

        def pad1(x):
            return torch.nn.functional.pad(x, (0, 1))

        def totals(c2v_flat):
            return chan32 + c2v_flat[:, vn_pos].sum(dim=-1, dtype=torch.int32)

        def syndrome_ok(hard):
            return _syndrome_ok(hard, ev)

        chan32 = chan.to(torch.int32)
        c2v_flat = torch.zeros((B, M * D + 1), dtype=torch.int32,
                               device=chan.device)
        tot = chan32        # totals of the current messages (all zero)
        hard = chan32 < 0
        done = (syndrome_ok(hard) if early_term
                else torch.zeros(B, dtype=torch.bool, device=chan.device))
        iters = torch.zeros(B, dtype=torch.int32, device=chan.device)
        for _ in range(max_iter):
            if early_term and bool(done.all()):
                break
            c2v_d = c2v_flat[:, : M * D].reshape(B, M, D)
            v2c = torch.clamp(pad1(tot)[:, ev] - c2v_d, -qmax, qmax)
            v2c = torch.where(mask, v2c, qmax)
            new_flat = pad1(cn_update(v2c, mask).reshape(B, M * D))
            # Totals of the new messages: this iteration's posterior and the
            # next iteration's input (frozen lanes' totals are never used).
            tot = totals(new_flat)
            hard_new = tot < 0
            if early_term:
                ok_new = syndrome_ok(hard_new)
                keep = done[:, None]
                c2v_flat = torch.where(keep, c2v_flat, new_flat)
                hard = torch.where(keep, hard, hard_new)
                iters += (~done).to(torch.int32)
                done = done | ok_new
            else:
                c2v_flat, hard = new_flat, hard_new
                iters += 1
        conv = done if early_term else syndrome_ok(hard)
        return hard.to(torch.uint8), iters, conv

    return decode


def _layer_tables(code: LDPCCode, lay):
    """The layered decoders' gather tables, (L, Cmax, D) each: message
    slot, variable and mask of every check of every layer. Layers are the
    QC base rows when the code has them, else a greedy disjoint grouping
    (codes/layout.py); pad slots point at the dump slot and the pad
    column."""
    M, D, N = lay.m, lay.max_dc, lay.n
    DUMP = M * D
    if code.base is not None and code.Z is not None:
        Z = int(code.Z)
        layers = [np.arange(i * Z, (i + 1) * Z) for i in range(code.m // Z)]
    else:
        layers = compile_layers_general(code)
    L = len(layers)
    Cmax = max(len(l) for l in layers)
    lpos = np.full((L, Cmax, D), DUMP, np.int64)
    lev = np.full((L, Cmax, D), N, np.int64)
    lmask = np.zeros((L, Cmax, D), bool)
    for li, checks in enumerate(layers):
        for t, c in enumerate(checks):
            m_ = lay.cn_mask[c]
            lpos[li, t][m_] = c * D + np.nonzero(m_)[0]
            lev[li, t] = lay.ev_dense[c]
            lmask[li, t] = m_
    return lpos, lev, lmask


def make_layered_decoder(
    code: LDPCCode,
    max_iter: int = 20,
    beta: int = 0,
    qmax: int = 127,
    early_term: bool = True,
    alpha=None,
    minstar=None,
) -> Callable[[torch.Tensor], Decoded]:
    """Layered-schedule decoder; layers are the QC base rows when the code
    has them, else a greedy disjoint grouping (codes/layout.py). Returns
    decode(chan[B, n] integer LLRs) -> (hard[B, n] uint8, iters[B] int32,
    converged[B] bool), computed on chan's device.

    Per layer: v2c = clip(post - c2v, +-qmax), the CN update, then
    post += new - old and c2v = new. The checks of a layer touch disjoint
    variables, so the scatters never collide (pad slots add 0 to the pad
    column). With early termination a lane freezes (messages, posterior,
    hard bits) after its first iteration whose hard bits satisfy every
    check; a lane whose channel hard bits already do has iters = 0.
    minstar as in `make_flooding_decoder`."""
    cn_update = _cn_fn(beta, alpha, minstar, qmax)
    lay = compile_edge_layout(code)
    M, D, N = lay.m, lay.max_dc, lay.n
    DUMP = M * D
    lpos, lev, lmask = _layer_tables(code, lay)
    L = lpos.shape[0]
    on = _on_device((lpos, lev, lmask, np.asarray(lay.ev_dense, np.int64)))

    def decode(chan: torch.Tensor) -> Decoded:
        lpos_t, lev_t, lmask_t, ev = on(chan.device)
        B = chan.shape[0]
        chan32 = chan.to(torch.int32)
        c2v_flat = torch.zeros((B, DUMP + 1), dtype=torch.int32,
                               device=chan.device)
        post = torch.nn.functional.pad(chan32, (0, 1))     # pad column N
        hard = chan32 < 0
        done = (_syndrome_ok(hard, ev) if early_term
                else torch.zeros(B, dtype=torch.bool, device=chan.device))
        iters = torch.zeros(B, dtype=torch.int32, device=chan.device)
        for _ in range(max_iter):
            if early_term and bool(done.all()):
                break
            # ET keeps the old state for frozen lanes; fixed runs in place
            c2v_new, post_new = ((c2v_flat.clone(), post.clone())
                                 if early_term else (c2v_flat, post))
            for li in range(L):
                pos, evl, mk = lpos_t[li], lev_t[li], lmask_t[li]
                old = c2v_new[:, pos]                       # (B, C, D)
                v2c = torch.clamp(post_new[:, evl] - old, -qmax, qmax)
                v2c = torch.where(mk, v2c, qmax)
                new = cn_update(v2c, mk)
                delta = torch.where(mk, new - old, 0)
                post_new[:, evl.reshape(-1)] += delta.reshape(B, -1)
                c2v_new[:, pos.reshape(-1)] = new.reshape(B, -1)
            hard_new = post_new[:, :N] < 0
            if early_term:
                ok_new = _syndrome_ok(hard_new, ev)
                keep = done[:, None]
                c2v_flat = torch.where(keep, c2v_flat, c2v_new)
                post = torch.where(keep, post, post_new)
                hard = torch.where(keep, hard, hard_new)
                iters += (~done).to(torch.int32)
                done = done | ok_new
            else:
                c2v_flat, post, hard = c2v_new, post_new, hard_new
                iters += 1
        conv = done if early_term else _syndrome_ok(hard, ev)
        return hard.to(torch.uint8), iters, conv

    return decode


# ---------------------------------------------------------------------------
# Float decoders (counterpart of `_cn_update_float`, `make_float_decoder`,
# `make_layered_float_decoder`): belief propagation on raw float32 LLRs, no
# quantizer. The reference computes them outside any kernel; plain torch.
# ---------------------------------------------------------------------------

FLOAT_CN = ("sum-product", "min-sum", "offset-min-sum", "normalized-min-sum")


def _cn_update_float(v2c: torch.Tensor, mask: torch.Tensor, algorithm: str,
                     beta: float) -> torch.Tensor:
    """Float CN update on dense (..., C, D) float32 messages. sum-product
    is the tanh rule (inputs clipped to +-30, |tanh| floored at 1e-12, the
    quotient clipped to +-0.999999); the min-sum family excludes the first
    slot of least magnitude; offset subtracts beta, floored at 0, and for
    normalized beta carries the scaling factor."""
    if algorithm == "sum-product":
        t = torch.tanh(torch.clamp(v2c, -30.0, 30.0) / 2.0)
        eps = 1e-12
        t = torch.where(t.abs() < eps, torch.where(t < 0, -eps, eps), t)
        t = torch.where(mask, t, 1.0)
        p = t.prod(dim=-1, keepdim=True)
        r = torch.clamp(p / t, -0.999999, 0.999999)
        return torch.where(mask, 2.0 * torch.atanh(r), 0.0)
    big = 1e30
    mags = torch.where(mask, v2c, big).abs()
    amin = mags.argmin(dim=-1, keepdim=True)
    first = torch.arange(v2c.shape[-1], device=v2c.device) == amin
    min1 = mags.amin(dim=-1, keepdim=True)
    min2 = torch.where(first, big, mags).amin(dim=-1, keepdim=True)
    neg = (v2c < 0) & mask
    par = (neg.sum(dim=-1, keepdim=True) & 1).bool()
    excl_mag = torch.where(first, min2, min1)
    if algorithm == "offset-min-sum":
        excl_mag = torch.clamp(excl_mag - beta, min=0.0)
    elif algorithm == "normalized-min-sum":
        excl_mag = excl_mag * beta
    val = torch.where(par ^ neg, -excl_mag, excl_mag)
    return torch.where(mask, val, 0.0)


def make_float_decoder(
    code: LDPCCode,
    max_iter: int = 20,
    algorithm: str = "sum-product",
    beta: float = 0.5,
    early_term: bool = True,
    schedule: str = "flooding",
) -> Callable[[torch.Tensor], Decoded]:
    """Float BP decoder: decode(llr (B, n) float32) -> (hard uint8, iters
    int32, converged bool), on llr's device; schedule "layered" gives
    `make_layered_float_decoder`."""
    if algorithm not in FLOAT_CN:
        raise ValueError(f"unknown float CN update {algorithm!r}")
    if schedule == "layered":
        return make_layered_float_decoder(code, max_iter, algorithm, beta,
                                          early_term)
    if schedule != "flooding":
        raise ValueError(schedule)
    lay = compile_edge_layout(code)
    M, D = lay.m, lay.max_dc
    on = _on_device((np.asarray(lay.ev_dense, np.int64),
                     np.asarray(lay.vn_pos, np.int64),
                     np.asarray(lay.cn_mask, bool)))
    beta = float(np.float32(beta))

    def decode(chan: torch.Tensor) -> Decoded:
        ev, vn_pos, mask = on(chan.device)
        B = chan.shape[0]
        chan = chan.to(torch.float32)

        def pad1(x):
            return torch.nn.functional.pad(x, (0, 1))

        def totals(c2v_flat):
            return chan + c2v_flat[:, vn_pos].sum(dim=-1)

        c2v_flat = torch.zeros((B, M * D + 1), dtype=torch.float32,
                               device=chan.device)
        hard = chan < 0
        done = (_syndrome_ok(hard, ev) if early_term
                else torch.zeros(B, dtype=torch.bool, device=chan.device))
        iters = torch.zeros(B, dtype=torch.int32, device=chan.device)
        for _ in range(max_iter):
            if early_term and bool(done.all()):
                break
            c2v_d = c2v_flat[:, : M * D].reshape(B, M, D)
            v2c = pad1(totals(c2v_flat))[:, ev] - c2v_d
            new_flat = pad1(_cn_update_float(v2c, mask, algorithm, beta
                                             ).reshape(B, M * D))
            hard_new = totals(new_flat) < 0
            keep = done[:, None]
            c2v_flat = torch.where(keep, c2v_flat, new_flat)
            hard = torch.where(keep, hard, hard_new)
            iters += (~done).to(torch.int32)
            if early_term:
                done = done | _syndrome_ok(hard_new, ev)
        conv = done if early_term else _syndrome_ok(hard, ev)
        return hard.to(torch.uint8), iters, conv

    return decode


def make_layered_float_decoder(
    code: LDPCCode,
    max_iter: int = 20,
    algorithm: str = "sum-product",
    beta: float = 0.5,
    early_term: bool = True,
) -> Callable[[torch.Tensor], Decoded]:
    """Layered float BP decoder, the same-schedule float bound of the
    layered fixed-point runs: every check of a layer reads the posterior
    as it stood before the layer, the syndrome is taken once per sweep."""
    if algorithm not in FLOAT_CN:
        raise ValueError(f"unknown float CN update {algorithm!r}")
    lay = compile_edge_layout(code)
    on = _on_device(_layer_tables(code, lay)
                    + (np.asarray(lay.ev_dense, np.int64),))
    N, DUMP = lay.n, lay.m * lay.max_dc
    beta = float(np.float32(beta))

    def decode(chan: torch.Tensor) -> Decoded:
        lpos_t, lev_t, lmask_t, ev = on(chan.device)
        B = chan.shape[0]
        chan = chan.to(torch.float32)
        c2v_flat = torch.zeros((B, DUMP + 1), dtype=torch.float32,
                               device=chan.device)
        post = torch.nn.functional.pad(chan, (0, 1))
        hard = chan < 0
        done = (_syndrome_ok(hard, ev) if early_term
                else torch.zeros(B, dtype=torch.bool, device=chan.device))
        iters = torch.zeros(B, dtype=torch.int32, device=chan.device)
        for _ in range(max_iter):
            if early_term and bool(done.all()):
                break
            c2v_new, post_new = c2v_flat.clone(), post.clone()
            for li in range(lpos_t.shape[0]):
                pos, evl, mk = lpos_t[li], lev_t[li], lmask_t[li]
                old = c2v_new[:, pos]
                new = _cn_update_float(post_new[:, evl] - old, mk,
                                       algorithm, beta)
                delta = torch.where(mk, new - old, 0.0)
                post_new[:, evl.reshape(-1)] += delta.reshape(B, -1)
                c2v_new[:, pos.reshape(-1)] = new.reshape(B, -1)
            hard_new = post_new[:, :N] < 0
            keep = done[:, None]
            c2v_flat = torch.where(keep, c2v_flat, c2v_new)
            post = torch.where(keep, post, post_new)
            hard = torch.where(keep, hard, hard_new)
            iters += (~done).to(torch.int32)
            if early_term:
                done = done | _syndrome_ok(hard_new, ev)
        conv = done if early_term else _syndrome_ok(hard, ev)
        return hard.to(torch.uint8), iters, conv

    return decode


def make_decoder(code: LDPCCode, dec: DecoderConfig, quant: QuantConfig
                 ) -> Callable[[torch.Tensor], Decoded]:
    """Factory from configs, dispatching on dec.schedule; (beta, alpha)
    come from `config.cn_params`, the min* thresholds from
    `config.minstar_thresholds`."""
    if dec.algorithm not in ("min-sum", "offset-min-sum",
                             "normalized-min-sum", "min-star"):
        raise ValueError(f"the plain decoders support the min-sum family "
                         f"and min-star, got {dec.algorithm}")
    minstar = None
    if dec.algorithm == "min-star":
        beta, alpha, minstar = 0, None, minstar_thresholds(quant)
    else:
        beta, alpha = cn_params(dec, quant)
    maker = (make_layered_decoder if dec.schedule == "layered"
             else make_flooding_decoder)
    return maker(code, max_iter=dec.max_iter, beta=beta, qmax=quant.qmax,
                 early_term=dec.early_term, alpha=alpha, minstar=minstar)
