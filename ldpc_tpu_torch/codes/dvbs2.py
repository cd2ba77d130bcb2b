"""DVB-S2 LDPC codes (ETSI EN 302 307-1) — 'DVB-S2-like' realization.

Capability target (BASELINE.json:10): n=64800 normal frames across the
standard rate set, decoded with HBM-resident message state at batch 8k;
n=16200 short frames (EN 302 307-1 Table 5b k_ldpc values) ride the same
constructor.

Provenance: the standard defines H through per-rate accumulator address
tables (thousands of entries) that cannot be reconstructed offline, so per
SURVEY.md §8.1 these are generated codes with the standard's frame length,
rates, and information-column degree spectra (the published two-level
profiles: N1 columns of high degree d1, the rest degree 3, all parity
columns degree 2), realized as a quasi-cyclic code with Z=360 — the
standard's own column-group period — and an encodable 802.11n-style
dual-diagonal parity part standing in for the serial accumulator (both give
degree-2 parity chains; the QC form keeps the TPU kernel's Z-parallel layout
applicable). standard_exact=False, and the '_like' name suffix marks every
instance.

Degree profiles (info part), normal frame n=64800, Z=360:
    rate    k      high-degree cols  d1
    1/4    16200    5400             12
    1/3    21600    7200             12
    2/5    25920    8640             12
    1/2    32400   12960              8
    3/5    38880   12960             12
    2/3    43200    4320             13
    3/4    48600    5400             12
    4/5    51840    6480             11
    5/6    54000    5400             13
    8/9    57600    7200              4
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from .code import LDPCCode
from .qcstruct import gen_qc_code

N_NORMAL = 64800
N_SHORT = 16200
Z = 360

# Short-frame (n=16200) k_ldpc per nominal rate (EN 302 307-1 Table 5b;
# the short-frame LDPC code rates differ from the nominal MODCOD rates —
# e.g. nominal 1/2 uses k=7200, an effective 4/9). All k and n-k are
# multiples of Z=360. 9/10 is not defined for short frames.
SHORT_K: Dict[str, int] = {
    "1/4": 3240, "1/3": 5400, "2/5": 6480, "1/2": 7200, "3/5": 9720,
    "2/3": 10800, "3/4": 11880, "4/5": 12600, "5/6": 13320, "8/9": 14400,
}

# rate -> (k, n_high_degree_cols, d1)
PROFILES: Dict[str, Tuple[int, int, int]] = {
    "1/4": (16200, 5400, 12),
    "1/3": (21600, 7200, 12),
    "2/5": (25920, 8640, 12),
    "1/2": (32400, 12960, 8),
    "3/5": (38880, 12960, 12),
    "2/3": (43200, 4320, 13),
    "3/4": (48600, 5400, 12),
    "4/5": (51840, 6480, 11),
    "5/6": (54000, 5400, 13),
    "8/9": (57600, 7200, 4),
}


def make_code(n: int = N_NORMAL, rate: str = "1/2", seed: int = 0) -> LDPCCode:
    """Registry-aware entry: an imported exact table (codes/imported.py)
    takes precedence and is consulted UNCACHED (store()/remove() in the
    same process must take effect — advisor round-5); the generated
    fallback below stays lru_cached."""
    if n not in (N_NORMAL, N_SHORT):
        raise ValueError(f"DVB-S2 frames are n={N_NORMAL} (normal) or "
                         f"n={N_SHORT} (short), got {n}")
    if rate not in PROFILES or (n == N_SHORT and rate not in SHORT_K):
        raise ValueError(f"unsupported DVB-S2 rate {rate} for n={n}")
    from .imported import lookup
    imp = lookup("dvbs2", f"n{n}_r{rate.replace('/', '')}")
    if imp is not None:
        # validated exact table from the import registry (codes/imported.py)
        from .code import expand_qc
        Zi, B, ki, _ = imp
        assert Zi == Z
        return expand_qc(B, Z, k=ki,
                         name=f"dvbs2_n{n}_r{rate.replace('/', '')}_std",
                         standard_exact=True)
    return _make_code_gen(n, rate, seed)


@lru_cache(maxsize=32)
def _make_code_gen(n: int, rate: str, seed: int) -> LDPCCode:
    k, n_hi, d1 = PROFILES[rate]
    if n == N_SHORT:
        # Short frames keep the normal frame's degree SHAPE (d1 plus
        # degree-3 bulk) with the high-degree column count scaled to the
        # short k_ldpc — the exact published short-frame spectra are not
        # reconstructible offline, so these stay '_like' codes like the
        # normal frames (module docstring).
        k_s = SHORT_K[rate]
        n_hi = max(Z, min(k_s - Z, round(n_hi * k_s / k / Z) * Z))
        k = k_s
    assert k % Z == 0 and n_hi % Z == 0
    kb = k // Z
    mb = (n - k) // Z
    kb_hi = n_hi // Z
    # Full-string tag: a % 65536 truncation kept only the first two bytes,
    # so '1/2'/'1/3'/'1/4' (and '2/3'/'2/5', '3/4'/'3/5') seeded identical
    # RNGs — correlated shift draws across rates.
    rate_tag = int.from_bytes(rate.encode(), "little")  # stable across runs
    rng = np.random.default_rng(0xD2B + rate_tag + seed)

    # Column-first assignment: each info block-column picks its rows; convert
    # to row -> columns lists for gen_qc_code. Row loads are balanced greedily.
    row_load = np.zeros(mb, np.int64)
    rows_of_col: List[List[int]] = []
    for j in range(kb):
        d = d1 if j < kb_hi else 3
        # pick d distinct rows, favoring the least-loaded
        order = np.argsort(row_load + rng.uniform(0, 0.5, mb))
        picks = sorted(int(r) for r in order[:d])
        rows_of_col.append(picks)
        row_load[picks] += 1
    row_cols: List[List[int]] = [[] for _ in range(mb)]
    for j, rows in enumerate(rows_of_col):
        for r in rows:
            row_cols[r].append(j)

    code = gen_qc_code(row_cols, kb=kb, cb=mb, Z=Z, rng=rng,
                       name=f"dvbs2_n{n}_r{rate.replace('/', '')}_like")
    assert code.n == n and code.k == k
    return code
