"""Structured-QC utilities (the numpy part of `ldpc_tpu/codes/qcstruct.py`;
the batched encoder is `ops/encode.make_qc_encoder_t`): encodable parity detection, O(E) encoders, girth
repair, and seeded QC code generation.

The reference encodes 802.11n codes by dual-diagonal back-substitution
(BASELINE.json:5 'sparse parity-check encoding'; IEEE 802.11-2012 Annex F).
The same parity skeleton — one weight-3 parity column with equal top/bottom
shifts, a zero-shift staircase, optionally followed by identity extension
rows (the 3GPP TS 38.212 base-graph shape) — admits an O(E) block-circulant
encoder that scales to DVB-S2 frame lengths where the dense GF(2)
systematic-form encoder (golden/encoder.py) cannot (n=64800 would need a
multi-hundred-MB dense H).

detect_enc_struct() recognizes the skeleton in ANY base matrix (it matches
all 12 published 802.11n tables), so the fast path needs no side metadata.

gen_qc_code() builds '<standard>-like' codes for families whose exact shift
tables cannot be reconstructed offline (SURVEY.md §8.1 fallback policy):
exact structural skeleton + seeded shifts + deterministic 4-cycle repair,
always labeled standard_exact=False.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .code import LDPCCode, expand_qc


@dataclass(frozen=True)
class EncStruct:
    """Detected encodable parity structure of a QC base matrix.

    Block columns [0, kb) are information. Column kb is the weight-3 column
    (entries at core rows 0 and cb-1 with shift sigma, and one middle core row
    with shift 0). Columns kb+1 .. kb+cb-1 form the zero-shift staircase over
    core rows. Rows cb .. mb-1 (if any) are extension rows whose parity is a
    single zero-shift identity in column kb+cb+(row-cb); they may additionally
    touch information AND core-parity columns.
    """

    kb: int
    cb: int          # number of dual-diagonal core rows
    sigma: int       # shift of the weight-3 column's top/bottom entries
    rmid: int        # core row holding the zero-shift entry of column kb


def detect_enc_struct(base: np.ndarray) -> Optional[EncStruct]:
    mb, nb = base.shape
    kb = nb - mb
    if kb <= 0:
        return None
    # Find cb: either full dual-diagonal (cb = mb) or a core followed by
    # identity extension rows.
    cb = mb
    for i in range(mb - 1, 0, -1):
        col = kb + i  # identity column of ext row i (staircase cols share
        #               the same index map but have weight 2, not 1)
        if col < nb and base[i, col] == 0 and (base[:, col] >= 0).sum() == 1 \
                and (base[i, col + 1:] == -1).all():
            cb = i
        else:
            break
    # Weight-3 column checks.
    c0 = base[:cb, kb]
    nz = np.nonzero(c0 >= 0)[0]
    if len(nz) != 3 or nz[0] != 0 or nz[-1] != cb - 1:
        return None
    if c0[nz[0]] != c0[nz[-1]] or c0[nz[1]] != 0:
        return None
    sigma, rmid = int(c0[nz[0]]), int(nz[1])
    # Staircase columns.
    for t in range(1, cb):
        col = base[:cb, kb + t]
        nz_t = np.nonzero(col >= 0)[0]
        if not (len(nz_t) == 2 and tuple(nz_t) == (t - 1, t)
                and col[t - 1] == 0 and col[t] == 0):
            return None
        # (Extension rows MAY read staircase/core parity columns — the
        # encoder computes extension parities after all core parities, so
        # no structural restriction is needed here.)
    # Extension rows: single identity in their own column, nothing after.
    for e in range(cb, mb):
        col = kb + cb + (e - cb)
        if base[e, col] != 0 or (base[:, col] >= 0).sum() != 1:
            return None
        if (base[e, col + 1:] >= 0).any():
            return None
    return EncStruct(kb=kb, cb=cb, sigma=sigma, rmid=rmid)


def _lam(base: np.ndarray, row: int, blocks: np.ndarray, upto: int) -> np.ndarray:
    """Row syndrome lambda_row = sum_j C(s) x_j over block cols < upto.

    blocks: (..., nb_avail, Z) bit array; C(s) x = roll(x, -s) because check r
    reads variable (r+s) % Z."""
    out = np.zeros(blocks.shape[:-2] + blocks.shape[-1:], np.uint8)
    for j in range(upto):
        s = int(base[row, j])
        if s >= 0:
            out ^= np.roll(blocks[..., j, :], -s, axis=-1)
    return out


def qc_encode_numpy(code: LDPCCode, info: np.ndarray) -> np.ndarray:
    """Golden O(E) structured encoder. info: (..., k) -> codeword (..., n)."""
    st = detect_enc_struct(code.base)
    assert st is not None, f"{code.name}: no encodable structure"
    base, Z = code.base, int(code.Z)
    mb, nb = base.shape
    kb, cb = st.kb, st.cb
    info = np.asarray(info, np.uint8)
    x = info.reshape(info.shape[:-1] + (kb, Z)).copy()
    par = np.zeros(info.shape[:-1] + (mb, Z), np.uint8)
    lam_core = [
        _lam(base, i, x, kb) for i in range(cb)
    ]
    # p0 = sum of core-row lambdas (the two C(sigma) terms cancel; the middle
    # zero-shift term survives).
    p0 = np.zeros_like(lam_core[0])
    for l in lam_core:
        p0 = p0 ^ l
    par[..., 0, :] = p0

    def c(s, v):
        return np.roll(v, -s, axis=-1)

    # Staircase back-substitution over core rows.
    for t in range(cb - 1):
        acc = lam_core[t].copy()
        s0 = int(base[t, kb])
        if s0 >= 0:
            acc ^= c(s0, p0)
        if t > 0:
            acc ^= par[..., t, :]
        par[..., t + 1, :] = acc
    # Extension rows read info + all core parities.
    full = np.concatenate([x, par[..., :cb, :]], axis=-2)
    for e in range(cb, mb):
        par[..., e, :] = _lam(base, e, full, kb + cb)
    cw = np.concatenate([x, par], axis=-2)
    return cw.reshape(info.shape[:-1] + (nb * Z,))


# ---------------------------------------------------------------------------
# Generic base-level girth handling and code generation.
# ---------------------------------------------------------------------------

def base_collisions(B: np.ndarray, Z: int) -> List[Tuple[int, int, List[int]]]:
    """4-cycle collisions: row pairs sharing >= 2 columns with equal shift
    difference mod Z (expanded-graph 4-cycles for circulant blocks)."""
    mb, nb = B.shape
    out = []
    for i1 in range(mb):
        cols1 = np.nonzero(B[i1] >= 0)[0]
        for i2 in range(i1 + 1, mb):
            diffs: Dict[int, List[int]] = {}
            for j in cols1:
                if B[i2, j] >= 0:
                    diffs.setdefault(
                        int((B[i1, j] - B[i2, j]) % Z), []).append(int(j))
            for js in diffs.values():
                if len(js) > 1:
                    out.append((i1, i2, js))
    return out


def _row_coll_count(B: np.ndarray, Z: int, i: int) -> int:
    """Number of colliding (row-pair, shift-diff) column pairs involving row i."""
    mb = B.shape[0]
    cols_i = np.nonzero(B[i] >= 0)[0]
    total = 0
    for i2 in range(mb):
        if i2 == i:
            continue
        diffs: Dict[int, int] = {}
        for j in cols_i:
            if B[i2, j] >= 0:
                d = int((B[i, j] - B[i2, j]) % Z)
                diffs[d] = diffs.get(d, 0) + 1
        total += sum(c * (c - 1) // 2 for c in diffs.values())
    return total


def repair_girth(B: np.ndarray, Z: int, kb: int, rng: np.random.Generator,
                 max_rounds: int = 3000, strict: bool = True) -> np.ndarray:
    """Hill-climb info-column shifts to remove base-level 4-cycle collisions.
    Structural parity columns (>= kb) are never modified.

    strict=True raises if collisions remain (the 802.11n-size regime, where
    girth 6 is always achievable). strict=False returns the best effort —
    needed when a row pair shares more info columns than Z distinct shift
    differences (pigeonhole: 4-cycles are then unavoidable, as in real
    standards at small lifting sizes)."""
    B = B.copy()

    def total(Bx):
        return sum(_row_coll_count(Bx, Z, i) for i in range(Bx.shape[0])) // 2

    # Changing B[i, j] only affects pairs involving row i, so the global
    # objective moves by exactly the row-i delta — track it incrementally.
    cur_total = total(B)
    best_B, best_total = B.copy(), cur_total
    stall = 0
    for _ in range(max_rounds):
        if cur_total == 0:
            return B
        cols = base_collisions(B, Z)
        if not cols:
            return B
        i1, i2, js = cols[int(rng.integers(0, len(cols)))]
        cands = [(i, j) for j in js if j < kb
                 for i in (i2, i1) if B[i, j] >= 0]
        if not cands:
            raise ValueError(f"collision {(i1, i2, js)} involves only parity "
                             f"columns")
        i, j = cands[int(rng.integers(0, len(cands)))]
        cur = _row_coll_count(B, Z, i)
        best_s, best_c = int(B[i, j]), cur
        for s in range(Z):
            B[i, j] = s
            c = _row_coll_count(B, Z, i)
            if c < best_c:
                best_s, best_c = s, c
        B[i, j] = best_s
        cur_total += best_c - cur
        if cur_total < best_total:
            best_B, best_total = B.copy(), cur_total
            stall = 0
        else:
            stall += 1
            if stall > 25:
                # random kick to escape the plateau, keeping the global best
                ii, jj = cands[0]
                before = _row_coll_count(B, Z, ii)
                B[ii, jj] = int(rng.integers(0, Z))
                cur_total += _row_coll_count(B, Z, ii) - before
                stall = 0
    if best_total < cur_total:
        B = best_B
    remaining = base_collisions(B, Z)
    if remaining and strict:
        raise ValueError(f"girth repair did not converge: "
                         f"{len(remaining)} collisions remain")
    return B



def parity_skeleton(B: np.ndarray, kb: int, cb: int, mb: int, Z: int) -> None:
    """Write the encodable parity skeleton into B (in place): the weight-3
    column (sigma = 1 % Z at core rows 0 and cb-1, shift 0 in the middle),
    the zero-shift staircase over the cb core rows, and one zero-shift
    identity per extension row. This is the ONE structural shape
    detect_enc_struct recognizes — every generator (gen_qc_code, PEG, PBRL)
    must build it through this helper so the convention cannot drift."""
    sigma = 1 % Z
    B[0, kb] = sigma
    B[cb // 2, kb] = 0
    B[cb - 1, kb] = sigma
    for t in range(1, cb):
        B[t - 1, kb + t] = 0
        B[t, kb + t] = 0
    for e in range(cb, mb):
        B[e, kb + cb + (e - cb)] = 0


def gen_qc_code(
    row_info_cols: List[List[int]],
    kb: int,
    cb: int,
    Z: int,
    rng: np.random.Generator,
    name: str,
    ext_core_cols: Optional[List[List[int]]] = None,
    require_girth6: bool = True,
) -> LDPCCode:
    """Generate an encodable QC code from a topology.

    row_info_cols[i]: information block-columns touched by block row i
    (mb rows total). Rows < cb are the dual-diagonal core; rows >= cb are
    extension rows (identity parity), optionally also reading core-parity
    columns listed in ext_core_cols[row - cb] (absolute block-col indices in
    [kb, kb+cb)). Shifts are seeded-random with 4-cycle repair; the result is
    an explicitly '<standard>-like' code (standard_exact=False).
    """
    mb = len(row_info_cols)
    nb = kb + mb
    B = np.full((mb, nb), -1, np.int64)
    for i, cols in enumerate(row_info_cols):
        for j in cols:
            assert 0 <= j < kb
            B[i, j] = int(rng.integers(0, Z))
    parity_skeleton(B, kb, cb, mb, Z)
    if ext_core_cols is not None:
        for e in range(cb, mb):
            for j in ext_core_cols[e - cb]:
                assert kb <= j < kb + cb
                B[e, j] = int(rng.integers(0, Z))
    B = repair_girth(B, Z, kb, rng, strict=require_girth6)
    st = detect_enc_struct(B)
    assert st is not None and st.kb == kb and st.cb == cb
    return expand_qc(B, Z, name=name, standard_exact=False)
