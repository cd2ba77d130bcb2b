"""5G NR LDPC base graphs (3GPP TS 38.212 §5.3.2) — '5G-NR-like' realization.

Capability target (BASELINE.json:9): BG1/BG2 with the standard lifting sizes,
rate matching (puncturing of the first 2Z systematic columns + tail
puncturing from the circular buffer), and the layered decoding schedule.

Provenance: the exact 38.212 shift-coefficient tables (316 BG1 + 197 BG2
entries x 8 lifting sets) cannot be reconstructed offline with confidence, so
per SURVEY.md §8.1 these are generated codes with the exact STRUCTURAL
skeleton of the standard —

  * BG1: 46 x 68, kb=22; BG2: 42 x 52, kb=10;
  * 4 dual-diagonal core rows over a weight-3 parity column + staircase;
  * degree-1 identity extension rows (42/38 of them);
  * the first two information columns are high-degree and ALWAYS punctured;
  * lifting sizes Z = a * 2^j, a in {2,3,5,7,9,11,13,15}, Z <= 384;

— with seeded shifts, base-level 4-cycle repair, and standard_exact=False in
the code name and metadata. Swapping in the published tables would touch only
this file (the layout compiler, encoder, decoders and rate matching are
structure-generic).
"""
from __future__ import annotations

from fractions import Fraction
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

from .code import LDPCCode
from .qcstruct import gen_qc_code

# The 8 standard lifting sets (TS 38.212 Table 5.3.2-1).
LIFT_SETS = {a: [a * (1 << j) for j in range(8) if a * (1 << j) <= 384]
             for a in (2, 3, 5, 7, 9, 11, 13, 15)}
ALL_Z = sorted(z for zs in LIFT_SETS.values() for z in zs)

_PARAMS = {1: dict(mb=46, kb=22, cb=4), 2: dict(mb=42, kb=10, cb=4)}


def _topology(bg: int, rng: np.random.Generator) -> Tuple[List[List[int]],
                                                          List[List[int]]]:
    """Generate the (row -> info columns) support with the NR shape:
    dense core rows; sparse extension rows that lean on columns 0/1."""
    p = _PARAMS[bg]
    mb, kb, cb = p["mb"], p["kb"], p["cb"]
    rows: List[List[int]] = []
    # Core rows: nearly full over the info columns (BG1 core row weight ~19
    # of 22; BG2 ~8 of 10), always including columns 0 and 1.
    core_w = kb - 3
    for i in range(cb):
        others = rng.choice(np.arange(2, kb), size=core_w - 2, replace=False)
        rows.append(sorted({0, 1, *map(int, others)}))
    # Extension rows: weight 3..5 info entries, decreasing with depth;
    # column 0 or 1 appears in most rows (they are punctured and need the
    # extra degree).
    n_ext = mb - cb
    for e in range(n_ext):
        w = 5 if e < n_ext // 3 else (4 if e < 2 * n_ext // 3 else 3)
        # Exactly one of the punctured pair {0,1}: rows containing BOTH pin
        # the shift-difference s(0)-s(1), and at small Z the pigeonhole over
        # those pinned values makes 4-cycle-freedom infeasible.
        cols = {int(rng.integers(0, 2))}
        while len(cols) < w:
            cols.add(int(rng.integers(2, kb)))
        rows.append(sorted(cols))
    # Extension rows may also read core parities (adds rank robustness).
    ext_core = []
    for e in range(n_ext):
        if e % 3 == 0:
            ext_core.append([kb + int(rng.integers(0, cb))])
        else:
            ext_core.append([])
    return rows, ext_core


def full_graph(base_graph: int = 1, Z: int = 384, seed: int = 0) -> LDPCCode:
    """The full (un-rate-matched) BG code: n = (kb+mb) Z, k = kb Z.
    Registry-aware entry, consulted UNCACHED so in-process import-standard
    store()/remove() takes effect; the generated path stays lru_cached."""
    if base_graph not in (1, 2):
        raise ValueError(f"base_graph must be 1 or 2, got {base_graph}")
    if Z not in ALL_Z:
        raise ValueError(f"Z={Z} is not a standard NR lifting size")
    from .code import expand_qc
    from .imported import lookup
    imp = lookup("5gnr", f"bg{base_graph}_z{Z}")
    if imp is not None:
        # validated exact table from the import registry (codes/imported.py)
        Zi, B, _, _ = imp
        assert Zi == Z
        return expand_qc(B, Z, name=f"nr_bg{base_graph}_z{Z}_std",
                         standard_exact=True)
    return _full_graph_gen(base_graph, Z, seed)


@lru_cache(maxsize=32)
def _full_graph_gen(base_graph: int, Z: int, seed: int) -> LDPCCode:
    rng = np.random.default_rng(0xBABE + 131 * base_graph + seed)
    rows, ext_core = _topology(base_graph, rng)
    p = _PARAMS[base_graph]
    # Core rows share nearly all info columns, so girth 6 is only
    # achievable when Z exceeds the shared-support size (pigeonhole).
    code = gen_qc_code(rows, kb=p["kb"], cb=p["cb"], Z=Z, rng=rng,
                       name=f"nr_bg{base_graph}_z{Z}_like",
                       ext_core_cols=ext_core,
                       require_girth6=Z > p["kb"])
    return code


def make_code(base_graph: int = 1, Z: Optional[int] = 384,
              rate: str = "1/3", seed: int = 0,
              k_info: Optional[int] = None) -> LDPCCode:
    """Rate-matched NR-like code.

    Circular-buffer rate matching (TS 38.212 §5.4.2.1 shape): the first 2Z
    systematic bits are never transmitted; the transmitted block is the next
    n_tx = round(k / R) bits (systematic remainder, then parities in order).
    Unused trailing extension rows AND their parity columns are pruned from
    the decoder graph (their parities are untransmitted degree-1 variables,
    so the checks carry no information). Punctured variables receive channel
    LLR 0 (sim/pipeline.py).
    """
    Z = Z or 384
    p = _PARAMS[base_graph]
    kb, cb, mb_full = p["kb"], p["cb"], p["mb"]
    k = kb * Z
    # Shortening (TS 38.212 filler bits): payload k_info < k occupies the
    # first k_info systematic positions; positions [k_info, k) are
    # known-zero fillers — not transmitted, decoder LLR saturated positive.
    if k_info is None:
        k_info = k
    if not (0 < k_info <= k):
        raise ValueError(f"k_info={k_info} out of range (k={k})")
    n_short = k - k_info
    R = Fraction(rate)
    n_tx = int(round(k_info / R))
    # Transmitted systematic bits: the punctured prefix [0, 2Z) and the
    # shortened tail [k_info, k) OVERLAP when k_info < 2Z — count the union,
    # not the sum (round-1 advisor finding, mirrored from LDPCCode.n_tx).
    sys_tx = max(0, k_info - 2 * Z)
    min_tx = cb * Z + sys_tx              # all core parities transmitted
    max_tx = mb_full * Z + sys_tx
    if not (min_tx <= n_tx <= max_tx):
        raise ValueError(
            f"rate {rate} out of range for BG{base_graph} Z={Z}: n_tx={n_tx} "
            f"not in [{min_tx}, {max_tx}]")
    # Number of parity blocks needed (whole blocks; the last may be partially
    # punctured). Shortened fillers are not transmitted.
    par_bits = n_tx - sys_tx
    mb_used = -(-par_bits // Z)          # ceil
    mb_used = max(mb_used, cb)
    full = full_graph(base_graph, Z, seed)
    base = full.base[:mb_used, : kb + mb_used]
    from .code import expand_qc
    suffix = "_std" if full.standard_exact else "_like"
    code = expand_qc(
        base, Z,
        name=f"nr_bg{base_graph}_z{Z}_r{rate.replace('/', '')}{suffix}",
        standard_exact=full.standard_exact)
    # Punctured: first 2Z systematic + the untransmitted tail of the last
    # parity block.
    tail = mb_used * Z - par_bits
    punct = list(range(2 * Z))
    if tail:
        punct += list(range(code.n - tail, code.n))
    code.punct_vns = np.asarray(punct, np.int32)
    if n_short:
        code.shortened_vns = np.arange(k_info, k, dtype=np.int32)
    return code
