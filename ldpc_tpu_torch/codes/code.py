"""LDPC code representation.

The reference stores its parity-check matrix as row/column adjacency built from
802.11n QC base matrices (BASELINE.json:5 'sparse H matrix', :7 '802.11n ...
QC-LDPC'). Here the canonical in-memory form is:

- an optional QC description (base matrix of circulant shifts, lifting Z), and
- the expanded sparse H as per-check neighbor lists (the universal form every
  downstream layer consumes via the layout compiler in layout.py).

No scipy dependency: H is kept as plain int arrays.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class LDPCCode:
    """An LDPC code instance.

    Attributes:
      name: human-readable identifier (family + params + provenance label).
      n: codeword length (number of variable nodes actually transmitted may be
         smaller for punctured codes; n here is the decoder graph width).
      m: number of parity checks (rows of H).
      k: number of information bits.
      cn_adj: list of length m; cn_adj[c] = sorted int array of variable indices
         participating in check c.
      Z: QC lifting size, or None for unstructured codes.
      base: QC base matrix of shifts, shape (mb, nb), entries -1 for no edge,
         else shift in [0, Z). None for unstructured codes.
      punct_vns: variable indices NOT transmitted (receive LLR 0). Used by 5G NR.
      shortened_vns: variable indices known to be 0 (receive +qmax LLR).
      standard_exact: True when the table is believed to reproduce the published
         standard exactly; False for generated 'standard-like' fallbacks
         (SURVEY.md §8.1).
    """

    name: str
    n: int
    m: int
    k: int
    cn_adj: List[np.ndarray]
    Z: Optional[int] = None
    base: Optional[np.ndarray] = None
    punct_vns: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    shortened_vns: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    standard_exact: bool = True

    @property
    def k_eff(self) -> int:
        """Payload bits: k minus shortened (known-zero filler) info bits."""
        return self.k - len(self.shortened_vns)

    @property
    def n_tx(self) -> int:
        """Transmitted codeword length: n minus the union of punctured and
        shortened positions (5G NR heavy shortening can overlap the two sets —
        the union avoids double-subtracting, keeping Eb/N0 calibration honest)."""
        excluded = set(map(int, self.punct_vns)) | set(map(int, self.shortened_vns))
        return self.n - len(excluded)

    @property
    def rate(self) -> float:
        return self.k_eff / self.n_tx

    @property
    def num_edges(self) -> int:
        return int(sum(len(a) for a in self.cn_adj))

    def vn_adj(self) -> List[np.ndarray]:
        """Per-variable neighbor lists (checks touching each variable)."""
        out: List[List[int]] = [[] for _ in range(self.n)]
        for c, vs in enumerate(self.cn_adj):
            for v in vs:
                out[int(v)].append(c)
        return [np.asarray(a, np.int32) for a in out]

    def h_dense(self) -> np.ndarray:
        """Dense H (uint8) — for tests on small codes only."""
        H = np.zeros((self.m, self.n), np.uint8)
        for c, vs in enumerate(self.cn_adj):
            H[c, vs] = 1
        return H

    def _flat_edges(self):
        """(edge_vn[E], ptr_nz, nz_mask) flat-CSR view of cn_adj over the
        NONEMPTY checks, cached — the vectorized syndrome's gather/segment
        layout (trapping-set analysis calls syndrome thousands of times on
        DVB-S2-sized graphs). Degree-0 checks are excluded: reduceat
        cannot represent empty segments (their syndrome is 0)."""
        cached = getattr(self, "_flat_edges_cache", None)
        if cached is None:
            deg = np.asarray([len(a) for a in self.cn_adj], np.int64)
            nz = deg > 0
            edge_vn = (np.concatenate(
                [a for a in self.cn_adj if len(a)]).astype(np.int64)
                if nz.any() else np.zeros(0, np.int64))
            ptr = np.zeros(int(nz.sum()), np.int64)
            np.cumsum(deg[nz][:-1], out=ptr[1:])
            cached = self._flat_edges_cache = (edge_vn, ptr, nz)
        return cached

    def syndrome(self, bits: np.ndarray) -> np.ndarray:
        """GF(2) syndrome of hard bits, shape (..., n) -> (..., m)."""
        bits = np.asarray(bits).astype(np.uint8)
        out = np.zeros(bits.shape[:-1] + (self.m,), np.uint8)
        edge_vn, ptr, nz = self._flat_edges()
        if len(edge_vn):
            out[..., nz] = np.bitwise_xor.reduceat(
                bits[..., edge_vn], ptr, axis=-1)
        return out


def expand_qc(base: np.ndarray, Z: int, name: str = "qc",
              standard_exact: bool = True, k: Optional[int] = None) -> LDPCCode:
    """Expand a QC base matrix of circulant shifts into an LDPCCode.

    Entry base[i, j] = s >= 0 places the identity rotated by s (row r of the
    block connects check i*Z + r to variable j*Z + (r + s) % Z); -1 places the
    all-zero block. This is the standard QC-LDPC expansion used by IEEE
    802.11-2012 Annex F and 3GPP TS 38.212 §5.3.2.
    """
    mb, nb = base.shape
    m, n = mb * Z, nb * Z
    cn_adj: List[np.ndarray] = []
    r = np.arange(Z)
    for i in range(mb):
        cols_per_r: List[np.ndarray] = []
        for j in range(nb):
            s = int(base[i, j])
            if s < 0:
                continue
            cols_per_r.append(j * Z + (r + s) % Z)
        if cols_per_r:
            block = np.stack(cols_per_r, axis=1)  # (Z, deg_i)
        else:
            block = np.zeros((Z, 0), np.int64)
        for rr in range(Z):
            cn_adj.append(np.sort(block[rr]).astype(np.int32))
    if k is None:
        k = n - m
    return LDPCCode(name=name, n=n, m=m, k=k, cn_adj=cn_adj, Z=Z, base=base,
                    standard_exact=standard_exact)


def qc_block_cover(vns, Z: int, what: str = "punctured") -> set:
    """Base columns FULLY covered by the variable set `vns`.

    The per-column analyses (proto_de.column_channel_pmfs, exit.PEXIT)
    model rate matching as a whole-block property; bit-granular sets (e.g.
    codes/rate_compat puncture counts not a multiple of Z) cannot be
    represented there — classifying a block by 'any bit punctured' would
    silently over-puncture the model. Raises for partial blocks."""
    counts: dict = {}
    for v in vns:
        b = int(v) // Z
        counts[b] = counts.get(b, 0) + 1
    partial = sorted(b for b, c in counts.items() if c != Z)
    if partial:
        raise ValueError(
            f"{what} set covers base column(s) {partial[:8]} only "
            f"partially (Z={Z}); per-column analysis needs Z-aligned "
            f"rate matching — use puncture counts that are multiples of "
            f"Z, or Monte-Carlo the bit-granular code directly")
    return set(counts)


def has_4cycle(code: LDPCCode) -> bool:
    """True if the Tanner graph has a 4-cycle (two checks sharing >= 2 vars).

    O(sum dc^2) via pair hashing — fine for all supported sizes in tests.
    """
    seen = set()
    for vs in code.cn_adj:
        vs = np.asarray(vs)
        for a in range(len(vs)):
            for b in range(a + 1, len(vs)):
                p = (int(vs[a]), int(vs[b]))
                if p in seen:
                    return True
                seen.add(p)
    return False


def gf2_rank(H: np.ndarray) -> int:
    """Rank of a dense GF(2) matrix via bit-packed Gaussian elimination."""
    Hm = np.asarray(H, np.uint8) & 1
    m, n = Hm.shape
    words = (n + 63) // 64
    rows = np.zeros((m, words), np.uint64)
    for j in range(n):
        rows[:, j // 64] |= (Hm[:, j].astype(np.uint64) << np.uint64(j % 64))
    rank = 0
    for col in range(n):
        w, b = col // 64, np.uint64(col % 64)
        mask = (rows[rank:, w] >> b) & np.uint64(1)
        nz = np.nonzero(mask)[0]
        if len(nz) == 0:
            continue
        piv = rank + nz[0]
        rows[[rank, piv]] = rows[[piv, rank]]
        hit = np.nonzero((rows[:, w] >> b) & np.uint64(1))[0]
        hit = hit[hit != rank]
        rows[hit] ^= rows[rank]
        rank += 1
        if rank == m:
            break
    return rank
