"""Rate-compatible puncturing / shortening for ANY code family.

The reference implements 802.11n-class fixed-rate codes; its research
context (rate-compatible punctured LDPC) motivates a first-class generic
rate-matching layer: derive a FAMILY of effective rates from one mother
code by puncturing parity bits, with the rate-compatible nesting property
(every higher-rate member's puncture set contains the lower-rate ones), so
one decoder graph serves an incremental-redundancy (IR-HARQ-style) ladder.

The 5G NR constructor (codes/nr_bg.py) hardcodes the standard's own rate
matching; this module generalizes the mechanism to every family: punctured
positions are never transmitted and enter the decoder with LLR 0 — the
simulation pipeline (sim/pipeline.py rate-matching block) already consumes
`punct_vns` uniformly, and Eb/N0 -> sigma calibration follows n_tx/k_eff
automatically through LDPCCode.rate.

Schemes:
  * "tail": puncture parity bits from the END of the codeword — the
    staircase tail of dual-diagonal QC codes degrades most gracefully
    (later parities depend on earlier ones), the standard convention.
  * "random": seeded-uniform order over parity positions, reproducible.

`puncture_order` exposes the full order so ladders nest by construction.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .code import LDPCCode


def _parity_positions(code: LDPCCode) -> np.ndarray:
    """Codeword positions that are puncture candidates: not information,
    not already punctured/shortened."""
    from ..ops.encode import info_positions
    excluded = set(map(int, info_positions(code)))
    excluded |= set(map(int, code.punct_vns))
    excluded |= set(map(int, code.shortened_vns))
    return np.asarray([v for v in range(code.n) if v not in excluded],
                      np.int32)


def puncture_order(code: LDPCCode, scheme: str = "tail",
                   seed: int = 0) -> np.ndarray:
    """The order in which parity positions are punctured as the rate rises.
    Prefixes of this order give NESTED puncture sets (rate-compatibility)."""
    parity = _parity_positions(code)
    if scheme == "tail":
        return parity[::-1].copy()
    if scheme == "random":
        rng = np.random.default_rng(seed)
        return rng.permutation(parity).astype(np.int32)
    raise ValueError(f"unknown puncture scheme {scheme!r} "
                     f"(expected 'tail' or 'random')")


def puncture(code: LDPCCode, count: Optional[int] = None,
             frac: Optional[float] = None, rate: Optional[float] = None,
             scheme: str = "tail", seed: int = 0) -> LDPCCode:
    """A punctured variant of `code` (the mother code is not modified).

    Exactly one of:
      count: number of parity bits to puncture;
      frac:  fraction of the mother code's parity bits to puncture;
      rate:  target effective rate k_eff/n_tx (count is derived).

    Punctures are a prefix of puncture_order(scheme, seed), so variants of
    the same mother code at increasing rates are rate-compatible (nested).
    """
    if sum(x is not None for x in (count, frac, rate)) != 1:
        raise ValueError("pass exactly one of count=, frac=, rate=")
    order = puncture_order(code, scheme, seed)
    if frac is not None:
        if not 0 <= frac < 1:
            raise ValueError(f"frac must be in [0, 1), got {frac}")
        count = int(round(frac * len(order)))
    elif rate is not None:
        if not code.rate <= rate < 1:
            raise ValueError(f"target rate {rate} not in "
                             f"[{code.rate:.4f}, 1)")
        # n_tx_target = k_eff / rate; puncture the difference.
        count = code.n_tx - int(round(code.k_eff / rate))
        count = max(0, min(count, len(order)))
    if not 0 <= count <= len(order):
        raise ValueError(f"count must be in [0, {len(order)}], got {count}")
    new_punct = order[:count]
    n_tx_new = code.n_tx - count
    if n_tx_new <= code.k_eff:
        raise ValueError(
            f"puncturing {count} of {len(order)} parity bits leaves "
            f"n_tx={n_tx_new} <= k_eff={code.k_eff} (rate >= 1)")
    merged = np.sort(np.concatenate(
        [np.asarray(code.punct_vns, np.int32), new_punct])).astype(np.int32)
    out = dataclasses.replace(
        code, punct_vns=merged,
        name=f"{code.name}+p{count}" if count else code.name)
    return out


def shorten(code: LDPCCode, count: int) -> LDPCCode:
    """A shortened variant: the LAST `count` information bits are known
    zeros (not transmitted; decoder sees saturated +LLR). Lowers the rate:
    k_eff' = k_eff - count, n_tx' = n_tx - count."""
    from ..ops.encode import info_positions
    if not 0 <= count < code.k_eff:
        raise ValueError(f"shorten count must be in [0, k_eff={code.k_eff})")
    if count == 0:
        return code
    info = np.asarray(info_positions(code), np.int32)
    avail = np.asarray(
        [v for v in info if v not in set(map(int, code.shortened_vns))],
        np.int32)
    new_short = avail[-count:]
    merged = np.sort(np.concatenate(
        [np.asarray(code.shortened_vns, np.int32), new_short])
    ).astype(np.int32)
    return dataclasses.replace(code, shortened_vns=merged,
                               name=f"{code.name}+s{count}")


def rate_ladder(code: LDPCCode, rates: Sequence[float],
                scheme: str = "tail", seed: int = 0) -> List[LDPCCode]:
    """Rate-compatible family: one punctured variant per target rate.
    All variants share the mother decoder graph; their puncture sets are
    nested (prefixes of one puncture order), so a receiver that accumulated
    the higher-rate transmission can decode any later increment in place."""
    out = []
    for r in rates:
        out.append(code if abs(r - code.rate) < 1e-9
                   else puncture(code, rate=float(r), scheme=scheme,
                                 seed=seed))
    return out
