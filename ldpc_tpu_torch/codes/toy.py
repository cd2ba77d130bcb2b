"""Tiny code fixtures for bit-exact decoder testing (SURVEY.md §4.2).

These play the role of the reference's implicit smoke tests (all-zeros codeword
+ known seed): small enough to eyeball per-iteration message dumps, yet shaped
like the real codes (the toy QC code has dual-diagonal parity like 802.11n).
"""
from __future__ import annotations

import numpy as np

from .code import LDPCCode, expand_qc


def hamming74() -> LDPCCode:
    """(7,4) Hamming code viewed as an LDPC code."""
    H = np.array(
        [
            [1, 1, 0, 1, 1, 0, 0],
            [1, 0, 1, 1, 0, 1, 0],
            [0, 1, 1, 1, 0, 0, 1],
        ],
        np.uint8,
    )
    cn_adj = [np.nonzero(r)[0].astype(np.int32) for r in H]
    return LDPCCode(name="hamming74", n=7, m=3, k=4, cn_adj=cn_adj)


def toy_qc_odd(Z: int = 16) -> LDPCCode:
    """A 5x10 base-matrix QC code (rate 1/2, n = 10Z) with an ODD number of
    base rows — the small stand-in for DVB-S2 n=16200 r=1/2 (mb=25) in
    interpret-mode tests of the stream kernels' odd-mb path (two decoding
    iterations unrolled per loop body, DMA slot parity by GLOBAL layer
    index). The default Z=16 keeps Z % 8 == 0 so every kernel variant
    (dynamic/static/resident/resident-et) accepts it."""
    rng = np.random.default_rng(0x0DD)
    from .qcstruct import gen_qc_code

    row_cols = [[0, 1, 2], [1, 2, 3], [2, 3, 4], [0, 3, 4], [0, 1, 4]]
    return gen_qc_code(row_cols, kb=5, cb=5, Z=Z, rng=rng,
                       name=f"toy_qc_odd_z{Z}")


def array_qc(rows: int = 3, cols: int = 6, Z: int = 17) -> LDPCCode:
    """(rows, cols)-regular QC array code: base shifts s[i, j] = i*j mod Z,
    girth >= 6 for prime Z (Fan's array-code construction). The regular-code
    fixture for hard-decision decoder tests — unlike every standard code in
    this repo it has NO degree-2 variables, which is the regime Gallager-A/B
    analysis assumes. Not systematically encodable; used with the all-zeros
    codeword."""
    base = np.array([[(i * j) % Z for j in range(cols)]
                     for i in range(rows)], np.int64)
    return expand_qc(base, Z, name=f"array_{rows}x{cols}_z{Z}")


def toy_qc(Z: int = 4) -> LDPCCode:
    """A 3x6 base-matrix QC code (rate 1/2, n = 6Z) with an 802.11n-style
    parity structure: weight-3 first parity column with equal top/bottom
    shifts, then a dual-diagonal staircase of zero-shift identities."""
    base = np.array(
        [
            [0, 1, -1, 1, 0, -1],
            [2, -1, 3, 0, 0, 0],
            [-1, 3, 1, 1, -1, 0],
        ],
        np.int64,
    )
    base = np.where(base >= 0, base % Z, -1)
    return expand_qc(base, Z, name=f"toy_qc_z{Z}")
