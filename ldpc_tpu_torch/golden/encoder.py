"""Golden GF(2) systematic encoder (NumPy, dense — oracle only).

The reference encodes via the 802.11n dual-diagonal back-substitution
(BASELINE.json:5 'sparse parity-check encoding'; IEEE 802.11-2012 Annex F).
This golden encoder instead solves the general systematic form by GF(2)
elimination, so it works for ANY code and certifies the fast structured
encoders in ops/encode by the H @ c^T == 0 property.

Convention: codeword c = [info (k bits) | parity (m bits)] up to the column
permutation `perm` returned by systematic_form (identity for all supported
standard codes, whose last m columns are invertible).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..codes.code import LDPCCode

def systematic_form(code: LDPCCode) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (P, perm): parity generator P (m x k, uint8) and column
    permutation perm (n,) such that for c_perm = [s, p] with p = P @ s mod 2,
    the codeword c[perm] = c_perm satisfies H @ c == 0."""
    cached = getattr(code, "_systematic_cache", None)
    if cached is not None:
        return cached
    H = code.h_dense().astype(np.uint8)
    m, n = H.shape
    k = n - m
    perm = np.arange(n)
    A = H.copy()
    # Eliminate on the last m columns; swap in earlier columns when singular.
    for r in range(m):
        col = k + r
        piv_rows = np.nonzero(A[r:, col])[0]
        if len(piv_rows) == 0:
            # find a substitute column among the info columns
            for j in range(k - 1, -1, -1):
                if A[r:, j].any():
                    A[:, [col, j]] = A[:, [j, col]]
                    perm[[col, j]] = perm[[j, col]]
                    piv_rows = np.nonzero(A[r:, col])[0]
                    break
            else:
                raise ValueError("H is rank-deficient; cannot form systematic code")
        piv = r + piv_rows[0]
        if piv != r:
            A[[r, piv]] = A[[piv, r]]
        hit = np.nonzero(A[:, col])[0]
        hit = hit[hit != r]
        A[hit] ^= A[r]
    # Now A = [P | I_m] (after row ops), so parity p = P @ s.
    P = A[:, :k].copy()
    code._systematic_cache = (P, perm)
    return P, perm


def encode(code: LDPCCode, info: np.ndarray) -> np.ndarray:
    """Systematic encode. info: (..., k) in {0,1} -> codeword (..., n)."""
    P, perm = systematic_form(code)
    info = np.asarray(info, np.uint8)
    parity = (info @ P.T) % 2
    c_perm = np.concatenate([info, parity.astype(np.uint8)], axis=-1)
    c = np.empty_like(c_perm)
    c[..., perm] = c_perm
    return c
