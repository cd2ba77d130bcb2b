"""MacKay 'alist' sparse-matrix IO for parity-check matrices.

The reference class of fixed-point LDPC simulators stores H as row/column
adjacency in David MacKay's alist text format (SURVEY.md §2.1 C1: the
loader builds per-check and per-variable neighbor arrays from it), so a
user migrating from such a simulator arrives with .alist files. This
module round-trips them to/from LDPCCode:

    n m
    max_col_deg max_row_deg
    col degrees (n entries)
    row degrees (m entries)
    n lines: 1-based check indices per variable, 0-padded to max_col_deg
    m lines: 1-based variable indices per check, 0-padded to max_row_deg

Loaded codes are unstructured (Z=None): they decode through the general
edge-gather jnp decoder / greedy-layer layered schedule and encode through
the dense systematic-form encoder — no QC assumption anywhere. H must
have full row rank (checked over GF(2)); rank-deficient files are
rejected with a pointer at the dependent rows' removal.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from .code import LDPCCode


def _gf2_rank(cn_adj: List[np.ndarray], n: int) -> int:
    """Rank of H over GF(2), row-reduced on bit-packed uint64 words."""
    words = (n + 63) // 64
    rows = np.zeros((len(cn_adj), words), np.uint64)
    for i, vs in enumerate(cn_adj):
        # ufunc.at, NOT fancy-indexed |=: repeated word indices (two
        # variables in the same 64-bit block) would drop all but one bit.
        np.bitwise_or.at(
            rows[i], vs // 64,
            np.uint64(1) << (vs.astype(np.uint64) % np.uint64(64)))
    rank = 0
    for col in range(n):
        w, b = col // 64, np.uint64(col % 64)
        mask = np.uint64(1) << b
        pivot = next((r for r in range(rank, len(rows))
                      if rows[r, w] & mask), None)
        if pivot is None:
            continue
        rows[[rank, pivot]] = rows[[pivot, rank]]
        hit = (rows[:, w] & mask).astype(bool)
        hit[rank] = False
        rows[hit] ^= rows[rank]
        rank += 1
        if rank == len(rows):
            break
    return rank


def read_alist(path: str, name: str | None = None) -> LDPCCode:
    """Parse an alist file into an (unstructured) LDPCCode."""
    with open(path) as f:
        tok = f.read().split()
    it = iter(tok)

    def nxt() -> int:
        try:
            return int(next(it))
        except StopIteration:
            raise ValueError(f"{path}: truncated alist file") from None

    n, m = nxt(), nxt()
    if n <= 0 or m <= 0:
        raise ValueError(f"{path}: bad dimensions n={n} m={m}")
    dvmax, dcmax = nxt(), nxt()
    dv = np.array([nxt() for _ in range(n)], np.int64)
    dc = np.array([nxt() for _ in range(m)], np.int64)
    if dv.max(initial=0) > dvmax or dc.max(initial=0) > dcmax:
        raise ValueError(f"{path}: degree exceeds declared maximum")
    if dv.sum() != dc.sum():
        raise ValueError(f"{path}: column degrees sum {dv.sum()} != row "
                         f"degrees sum {dc.sum()}")
    # Column lists: only consistency-checked; the row lists are canonical.
    col_adj = []
    for j in range(n):
        ent = [nxt() for _ in range(dvmax)]
        vs = sorted(e for e in ent if e != 0)
        if (len(vs) != dv[j] or any(not (1 <= e <= m) for e in vs)
                or any(a == b for a, b in zip(vs, vs[1:]))):
            raise ValueError(f"{path}: bad column {j + 1} adjacency")
        col_adj.append(vs)
    cn_adj = []
    for i in range(m):
        ent = [nxt() for _ in range(dcmax)]
        vs = sorted(e for e in ent if e != 0)
        if (len(vs) != dc[i] or any(not (1 <= e <= n) for e in vs)
                or any(a == b for a, b in zip(vs, vs[1:]))):
            raise ValueError(f"{path}: bad row {i + 1} adjacency")
        cn_adj.append(np.array(vs, np.int64) - 1)
    # Cross-check the two adjacency views describe the same matrix.
    from_cols = [[] for _ in range(m)]
    for j, rows in enumerate(col_adj):
        for r in rows:
            from_cols[r - 1].append(j)
    for i in range(m):
        if not np.array_equal(np.array(from_cols[i], np.int64), cn_adj[i]):
            raise ValueError(f"{path}: row/column adjacency disagree at "
                             f"check {i + 1}")
    rank = _gf2_rank(cn_adj, n)
    if rank < m:
        # systematic_form (the encoder for unstructured codes) requires
        # full row rank; redundant checks would silently shrink k.
        raise ValueError(
            f"{path}: H is rank-deficient (rank {rank} < m={m}); remove "
            f"the dependent rows before loading")
    k = n - m
    if k <= 0:
        raise ValueError(f"{path}: H has no information positions (k={k})")
    return LDPCCode(
        name=name or f"alist_{os.path.basename(path)}_n{n}_m{m}",
        n=n, m=m, k=k, cn_adj=cn_adj)


def write_alist(code: LDPCCode, path: str) -> None:
    """Write a code's H matrix in alist format (any LDPCCode, QC or not)."""
    vn = code.vn_adj()
    dv = [len(a) for a in vn]
    dc = [len(a) for a in code.cn_adj]
    dvmax, dcmax = max(dv), max(dc)
    lines = [f"{code.n} {code.m}", f"{dvmax} {dcmax}",
             " ".join(map(str, dv)), " ".join(map(str, dc))]
    for a in vn:
        ent = [str(int(x) + 1) for x in a] + ["0"] * (dvmax - len(a))
        lines.append(" ".join(ent))
    for a in code.cn_adj:
        ent = [str(int(x) + 1) for x in a] + ["0"] * (dcmax - len(a))
        lines.append(" ".join(ent))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
