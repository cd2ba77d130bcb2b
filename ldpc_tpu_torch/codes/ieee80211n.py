"""IEEE 802.11n QC-LDPC codes (IEEE 802.11-2012 Annex F).

The reference's canonical code set (BASELINE.json:7-8): 12 codes, n in
{648, 1296, 1944} x rate in {1/2, 2/3, 3/4, 5/6}, lifting Z in {27, 54, 81},
base matrices 24 columns wide with a dual-diagonal parity part.

Provenance: the reference checkout is empty and the environment has no network
(SURVEY.md §0), so these shift tables are reconstructed from knowledge of the
published standard and validated by structural invariant in
tests/test_codes.py (dual-diagonal parity form, full GF(2) rank, no 4-cycles,
encoder property H c^T = 0). Codes failing invariants would be replaced by
explicitly-labeled generated fallbacks (SURVEY.md §8.1); all 12 below pass.

Exactness status (round 2 audit): 9 of 12 recalled tables are 4-cycle-free
and believed exact. Three tables contain base-level 4-cycle collisions —
impossible in the published girth->=6 family, so one recalled digit per
collision is wrong. Independent re-recall reproduces the same digits, and the
structural invariants cannot single out which entry of a colliding pair is
the misrecalled one, so exact recovery is NOT possible offline. The offending
tables are girth-repaired deterministically (minimum shift delta on the first
info-column entry of the colliding pair) and labeled `_like`. For a reader
WITH access to IEEE 802.11-2012 Annex F, the uncertainty is fully
localized — compare only these (row, col) entries against the standard:

  (648, 3/4):  collision A rows(0,3) x cols(8,18): suspect (0,8)=4 or
               (3,8)=3 (col 18 is structurally-forced parity);
               collision B rows(1,2) x cols(0,20): suspect (1,0)=25 or
               (2,0)=25 (identical recalled digits -- likely a duplication
               error; col 20 is forced parity staircase).
  (1296,2/3):  collision A rows(1,6) x cols(1,2): suspects (1,1)=52,
               (6,1)=24, (1,2)=41, (6,2)=13 (both diffs = 28 mod 54);
               collision B rows(3,7) x cols(0,4): suspects (3,0)=20,
               (7,0)=32, (3,4)=4, (7,4)=16 (both diffs = 42 mod 54).
  (1944,2/3):  collision rows(3,5) x cols(0,2): suspects (3,0)=48,
               (5,0)=69, (3,2)=43, (5,2)=64 (both diffs = 5 mod 81).

Every other entry of the three tables (and all entries of the other nine) is
believed exact. Swapping in corrected digits only touches _T here; nothing
else in the framework changes (the `_like` label then clears automatically).
"""
from __future__ import annotations

from typing import Dict, Tuple

# Shared 4-cycle collision detector (one definition keeps the two
# girth-repair paths from diverging).
from .qcstruct import base_collisions as _base_collisions

import numpy as np

from .code import LDPCCode, expand_qc

# fmt: off
_T = {}

_T[(648, "1/2")] = """
 0 -1 -1 -1  0  0 -1 -1  0 -1 -1  0  1  0 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
22  0 -1 -1 17 -1  0  0 12 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1 -1
 6 -1  0 -1 10 -1 -1 -1 24 -1  0 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1
 2 -1 -1  0 20 -1 -1 -1 25  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1
23 -1 -1 -1  3 -1 -1 -1  0 -1  9 11 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1
24 -1 23  1 17 -1  3 -1 10 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1
25 -1 -1 -1  8 -1 -1 -1  7 18 -1 -1  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1
13 24 -1 -1  0 -1  8 -1  6 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1
 7 20 -1 16 22 10 -1 -1 23 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1
11 -1 -1 -1 19 -1 -1 -1 13 -1  3 17 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1
25 -1  8 -1 23 18 -1 14  9 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0
 3 -1 -1 -1 16 -1 -1  2 25  5 -1 -1  1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0
"""

_T[(648, "2/3")] = """
25 26 14 -1 20 -1  2 -1  4 -1 -1  8 -1 16 -1 18  1  0 -1 -1 -1 -1 -1 -1
10  9 15 11 -1  0 -1  1 -1 -1 18 -1  8 -1 10 -1 -1  0  0 -1 -1 -1 -1 -1
16  2 20 26 21 -1  6 -1  1 26 -1  7 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1
10 13  5  0 -1  3 -1  7 -1 -1 26 -1 -1 13 -1 16 -1 -1 -1  0  0 -1 -1 -1
23 14 24 -1 12 -1 19 -1 17 -1 -1 -1 20 -1 21 -1  0 -1 -1 -1  0  0 -1 -1
 6 22  9 20 -1 25 -1 17 -1  8 -1 14 -1 18 -1 -1 -1 -1 -1 -1 -1  0  0 -1
14 23 21 11 20 -1 24 -1 18 -1 19 -1 -1 -1 -1 22 -1 -1 -1 -1 -1 -1  0  0
17 11 11 20 -1 21 -1 26 -1  3 -1 -1 18 -1 26 -1  1 -1 -1 -1 -1 -1 -1  0
"""

_T[(648, "3/4")] = """
16 17 22 24  9  3 14 -1  4  2  7 -1 26 -1  2 -1 21 -1  1  0 -1 -1 -1 -1
25 12 12  3  3 26  6 21 -1 15 22 -1 15 -1  4 -1 -1 16 -1  0  0 -1 -1 -1
25 18 26 16 22 23  9 -1  0 -1  4 -1  4 -1  8 23 11 -1 -1 -1  0  0 -1 -1
 9  7  0  1 17 -1 -1  7  3 -1  3 23 -1 16 -1 -1 21 -1  0 -1 -1  0  0 -1
24  5 26  7  1 -1 -1 15 24 15 -1  8 -1 13 -1 13 -1 11 -1 -1 -1 -1  0  0
 2  2 19 14 24  1 15 19 -1 21 -1  2 -1 24 -1  3 -1  2  1 -1 -1 -1 -1  0
"""

_T[(648, "5/6")] = """
17 13  8 21  9  3 18 12 10  0  4 15 19  2  5 10 26 19 13 13  1  0 -1 -1
 3 12 11 14 11 25  5 18  0  9  2 26 26 10 24  7 14 20  4  2 -1  0  0 -1
22 16  4  3 10 21 12  5 21 14 19  5 -1  8  5 18 11  5  5 15  0 -1  0  0
 7  7 14 14  4 16 16 24 24 10  1  7 15  6 10 26  8 18 21 14  1 -1 -1  0
"""

_T[(1296, "1/2")] = """
40 -1 -1 -1 22 -1 49 23 43 -1 -1 -1  1  0 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
50  1 -1 -1 48 35 -1 -1 13 -1 30 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1 -1
39 50 -1 -1  4 -1  2 -1 -1 -1 -1 49 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1
33 -1 -1 38 37 -1 -1  4  1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1
45 -1 -1 -1  0 22 -1 -1 20 42 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1
51 -1 -1 48 35 -1 -1 -1 44 -1 18 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1
47 11 -1 -1 -1 17 -1 -1 51 -1 -1 -1  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1
 5 -1 25 -1  6 -1 45 -1 13 40 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1
33 -1 -1 34 24 -1 -1 -1 23 -1 -1 46 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1
 1 -1 27 -1  1 -1 -1 -1 38 -1 44 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1
-1 18 -1 -1 23 -1 -1  8  0 35 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0
49 -1 17 -1 30 -1 -1 -1 34 -1 -1 19  1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0
"""

_T[(1296, "2/3")] = """
39 31 22 43 -1 40  4 -1 11 -1 -1 50 -1 -1 -1  6  1  0 -1 -1 -1 -1 -1 -1
25 52 41  2  6 -1 14 -1 34 -1 -1 -1 24 -1 37 -1 -1  0  0 -1 -1 -1 -1 -1
43 31 29  0 21 -1 28 -1 -1  2 -1 -1  7 -1 17 -1 -1 -1  0  0 -1 -1 -1 -1
20 33 48 -1  4 13 -1 26 -1 -1 22 -1 -1 46 42 -1 -1 -1 -1  0  0 -1 -1 -1
45  7 18 51 12 25 -1 -1 -1 50 -1 -1  5 -1 -1 -1  0 -1 -1 -1  0  0 -1 -1
35 40 32 16  5 -1 -1 18 -1 -1 43 51 -1 32 -1 -1 -1 -1 -1 -1 -1  0  0 -1
 9 24 13 22 28 -1 -1 37 -1 -1 25 -1 -1 52 -1 13 -1 -1 -1 -1 -1 -1  0  0
32 22  4 21 16 -1 -1 -1 27 28 -1 38 -1 -1 -1  8  1 -1 -1 -1 -1 -1 -1  0
"""

_T[(1296, "3/4")] = """
39 40 51 41  3 29  8 36 -1 14 -1  6 -1 33 -1 11 -1  4  1  0 -1 -1 -1 -1
48 21 47  9 48 35 51 -1 38 -1 28 -1 34 -1 50 -1 50 -1 -1  0  0 -1 -1 -1
30 39 28 42 50 39  5 17 -1  6 -1 18 -1 20 -1 15 -1 40 -1 -1  0  0 -1 -1
29  0  1 43 36 30 47 -1 49 -1 47 -1  3 -1 35 -1 34 -1  0 -1 -1  0  0 -1
 1 32 11 23 10 44 12  7 -1 48 -1  4 -1  9 -1 17 -1 16 -1 -1 -1 -1  0  0
13  7 15 47 23 16 47 -1 43 -1 29 -1 52 -1  2 -1 53 -1  1 -1 -1 -1 -1  0
"""

_T[(1296, "5/6")] = """
48 29 37 52  2 16  6 14 53 31 34  5 18 42 53 31 45 -1 46 52  1  0 -1 -1
17  4 30  7 43 11 24  6 14 21  6 39 17 40 47  7 15 41 19 -1 -1  0  0 -1
 7  2 51 31 46 23 16 11 53 40 10  7 46 53 33 35 -1 25 35 38  0 -1  0  0
19 48 41  1 10  7 36 47  5 29 52 52 31 10 26  6  3  2 -1 51  1 -1 -1  0
"""

_T[(1944, "1/2")] = """
57 -1 -1 -1 50 -1 11 -1 50 -1 79 -1  1  0 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
 3 -1 28 -1  0 -1 -1 -1 55  7 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1 -1
30 -1 -1 -1 24 37 -1 -1 56 14 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1
62 53 -1 -1 53 -1 -1  3 35 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1
40 -1 -1 20 66 -1 -1 22 28 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1
 0 -1 -1 -1  8 -1 42 -1 50 -1 -1  8 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1
69 79 79 -1 -1 -1 56 -1 52 -1 -1 -1  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1
65 -1 -1 -1 38 57 -1 -1 72 -1 27 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1
64 -1 -1 -1 14 52 -1 -1 30 -1 -1 32 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1
-1 45 -1 70  0 -1 -1 -1 77  9 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1
 2 56 -1 57 35 -1 -1 -1 -1 -1 12 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0
24 -1 61 -1 60 -1 -1 27 51 -1 -1 16  1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0
"""

_T[(1944, "2/3")] = """
61 75  4 63 56 -1 -1 -1 -1 -1 -1  8 -1  2 17 25  1  0 -1 -1 -1 -1 -1 -1
56 74 77 20 -1 -1 -1 64 24  4 67 -1  7 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1
28 21 68 10  7 14 65 -1 -1 -1 23 -1 -1 -1 75 -1 -1 -1  0  0 -1 -1 -1 -1
48 38 43 78 76 -1 -1 -1 -1  5 36 -1 15 72 -1 -1 -1 -1 -1  0  0 -1 -1 -1
40  2 53 25 -1 52 62 -1 20 -1 -1 44 -1 -1 -1 -1  0 -1 -1 -1  0  0 -1 -1
69 23 64 10 22 -1 21 -1 -1 -1 -1 -1 68 23 29 -1 -1 -1 -1 -1 -1  0  0 -1
12  0 68 20 55 61 -1 40 -1 -1 -1 52 -1 -1 -1 44 -1 -1 -1 -1 -1 -1  0  0
58  8 34 64 78 -1 -1 11 78 24 -1 -1 -1 -1 -1 58  1 -1 -1 -1 -1 -1 -1  0
"""

_T[(1944, "3/4")] = """
48 29 28 39  9 61 -1 -1 -1 63 45 80 -1 -1 -1 37 32 22  1  0 -1 -1 -1 -1
 4 49 42 48 11 30 -1 -1 -1 49 17 41 37 15 -1 54 -1 -1 -1  0  0 -1 -1 -1
35 76 78 51 37 35 21 -1 17 64 -1 -1 -1 59  7 -1 -1 32 -1 -1  0  0 -1 -1
 9 65 44  9 54 56 73 34 42 -1 -1 -1 35 -1 -1 -1 46 39  0 -1 -1  0  0 -1
 3 62  7 80 68 26 -1 80 55 -1 36 -1 26 -1  9 -1 72 -1 -1 -1 -1 -1  0  0
26 75 33 21 69 59  3 38 -1 -1 -1 35 -1 62 36 26 -1 -1  1 -1 -1 -1 -1  0
"""

_T[(1944, "5/6")] = """
13 48 80 66  4 74  7 30 76 52 37 60 -1 49 73 31 74 73 23 -1  1  0 -1 -1
69 63 74 56 64 77 57 65  6 16 51 -1 64 -1 68  9 48 62 54 27 -1  0  0 -1
51 15  0 80 24 25 42 54 44 71 71  9 67 35 -1 58 -1 29 -1 53  0 -1  0  0
16 29 36 41 44 56 59 37 50 24 -1 65  4 65 52 -1  4 -1 73 52  1 -1 -1  0
"""
# fmt: on

N_VALUES = (648, 1296, 1944)
RATES = ("1/2", "2/3", "3/4", "5/6")
Z_OF_N = {648: 27, 1296: 54, 1944: 81}
MB_OF_RATE = {"1/2": 12, "2/3": 8, "3/4": 6, "5/6": 4}
NB = 24

_parsed: Dict[Tuple[int, str], Tuple[np.ndarray, bool]] = {}


def _repair_girth(B: np.ndarray, Z: int, mb: int) -> Tuple[np.ndarray, bool]:
    """Deterministically repair base-level 4-cycles by re-picking offending
    info-column shifts (SURVEY.md §8.1 fallback policy). Structural parity
    columns (>= kb) are never modified. Returns (B', was_repaired)."""
    B = B.copy()
    kb = NB - mb
    repaired = False
    for _ in range(64):
        cols = _base_collisions(B, Z)
        if not cols:
            break
        i1, i2, js = cols[0]
        # change the first info-column entry of the colliding pair, trying the
        # row with the larger index first (parity structure lives in low rows)
        cands = [(i, j) for j in js if j < kb for i in (i2, i1) if B[i, j] >= 0]
        assert cands, f"collision {cols[0]} involves only parity columns"
        i, j = cands[0]
        orig = B[i, j]
        for delta in range(1, Z):
            B[i, j] = (orig + delta) % Z
            if not any(j in js2 and (i in (a, b))
                       for (a, b, js2) in _base_collisions(B, Z)):
                break
        repaired = True
    assert not _base_collisions(B, Z), "girth repair failed"
    return B, repaired


def base_matrix(n: int, rate: str) -> np.ndarray:
    """Base matrix of circulant shifts, shape (mb, 24); -1 = zero block."""
    return _base_matrix_meta(n, rate)[0]


def is_standard_exact(n: int, rate: str) -> bool:
    """True when make_code(n, rate) returns an exact published table:
    either the in-repo reconstruction needed no girth repair, or a
    validated table is installed in the import registry
    (codes/imported.py) — registry-aware so the predicate always agrees
    with make_code().standard_exact."""
    from .imported import lookup
    if lookup("ieee80211n", f"n{n}_r{rate.replace('/', '')}") is not None:
        return True
    return _base_matrix_meta(n, rate)[1]


def _base_matrix_meta(n: int, rate: str) -> Tuple[np.ndarray, bool]:
    key = (n, rate)
    if key not in _parsed:
        rows = [r.split() for r in _T[key].strip().splitlines()]
        B = np.array([[int(x) for x in r] for r in rows], np.int64)
        assert B.shape == (MB_OF_RATE[rate], NB), key
        assert B[B >= 0].max() < Z_OF_N[n], key
        B, repaired = _repair_girth(B, Z_OF_N[n], MB_OF_RATE[rate])
        _parsed[key] = (B, not repaired)
    return _parsed[key]


def make_code(n: int = 648, rate: str = "1/2") -> LDPCCode:
    """Build one of the 12 IEEE 802.11n LDPC codes."""
    if n not in N_VALUES or rate not in RATES:
        raise ValueError(f"unsupported 802.11n code ({n}, {rate})")
    Z = Z_OF_N[n]
    from .imported import lookup
    imp = lookup("ieee80211n", f"n{n}_r{rate.replace('/', '')}")
    if imp is not None:
        # validated exact table from the import registry (codes/imported.py)
        Zi, B, _, _ = imp
        assert Zi == Z
        return expand_qc(
            B, Z, name=f"ieee80211n_n{n}_r{rate.replace('/', '')}_std",
            standard_exact=True)
    B, exact = _base_matrix_meta(n, rate)
    suffix = "" if exact else "_like"
    code = expand_qc(B, Z, name=f"ieee80211n_n{n}_r{rate.replace('/', '')}{suffix}",
                     standard_exact=exact)
    return code


def all_codes():
    for n in N_VALUES:
        for rate in RATES:
            yield make_code(n, rate)
