"""Progressive-edge-growth (PEG) LDPC code construction.

The reference's MATLAB layer carries the H-matrix *generation* role
(SURVEY.md §1.2 'MATLAB analysis — scripts for H-matrix generation/
expansion'; §8.1 names PEG as the sanctioned fallback constructor). This
module provides that capability natively:

  * ``peg_construct`` — classic PEG (Hu/Eleftheriou/Arnold) for unstructured
    Tanner graphs: every edge is placed to maximize the shortest cycle it
    closes, given a per-variable degree sequence (e.g. from a density-
    evolution-optimized lambda spectrum, analysis/de.py).
  * ``qc_peg_construct`` — QC (circulant) PEG with the 802.11n-style
    dual-diagonal parity skeleton, so the result is ENCODABLE by the O(E)
    structured encoder (codes/qcstruct.py) and decodable by every kernel in
    the repo.  Info-column placements maximize the lifted-graph distance
    (one BFS per edge, exact under QC rotational symmetry); circulant
    shifts are chosen from the same BFS with an EXACT 4-cycle veto, so
    girth >= 6 is guaranteed and girth 8+ falls out where the topology
    admits it (vs. gen_qc_code's seeded-random shifts + repair, which only
    targets girth 6).
  * ``girth`` — exact Tanner-graph girth by BFS (per-orbit roots for QC
    codes), the validation oracle for both constructors.

Constructed codes are labeled ``standard_exact=False`` like every generated
table in codes/.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .code import LDPCCode, expand_qc, gf2_rank
from .qcstruct import detect_enc_struct, parity_skeleton

_INF = np.iinfo(np.int32).max


# ---------------------------------------------------------------------------
# Degree profiles
# ---------------------------------------------------------------------------

def parse_profile(spec: Optional[str], kb: int) -> np.ndarray:
    """Parse a CodeConfig.profile string into per-column base degrees.

    'deg:frac,...' (e.g. '2:0.5,3:0.25,8:0.25') is a node-perspective
    profile apportioned over kb columns; 'd0,d1,...' (no colons) is an
    explicit degree list of length kb; None/'' means uniform degree 3.
    """
    if not spec:
        return np.full(kb, 3, np.int32)
    if ":" in spec:
        prof = {}
        for part in spec.split(","):
            d, f = part.split(":")
            prof[int(d)] = float(f)
        return degrees_from_profile(kb, prof)
    degs = np.asarray([int(x) for x in spec.split(",")], np.int32)
    if len(degs) != kb:
        raise ValueError(f"explicit profile lists {len(degs)} degrees, "
                         f"need kb={kb}")
    return degs


def degrees_from_profile(n: int, profile: Dict[int, float]) -> np.ndarray:
    """Integer per-node degree sequence from a NODE-perspective profile.

    profile: {degree: fraction of nodes}. Fractions must sum to ~1; counts
    are apportioned by largest remainder so they sum to exactly n. Returns
    a sorted (ascending) int array of length n — the order PEG consumes.
    """
    degs = sorted(profile)
    fracs = np.asarray([profile[d] for d in degs], float)
    if fracs.min() < 0 or abs(fracs.sum() - 1.0) > 1e-6:
        raise ValueError(f"profile fractions must be >=0 and sum to 1, got "
                         f"sum {fracs.sum():.6f}")
    exact = fracs * n
    counts = np.floor(exact).astype(int)
    rem = n - counts.sum()
    order = np.argsort(-(exact - counts))
    counts[order[:rem]] += 1
    out = np.concatenate([np.full(c, d, np.int32)
                          for d, c in zip(degs, counts)])
    return np.sort(out)


# ---------------------------------------------------------------------------
# Exact girth (validation oracle)
# ---------------------------------------------------------------------------

def _shortest_cycle_through_vn(root: int, vn_adj: List[np.ndarray],
                               cn_adj: List[np.ndarray], n: int, m: int,
                               cutoff: int) -> int:
    """Shortest cycle through variable node `root` (BFS with branch labels).

    Vertices 0..n-1 are VNs, n..n+m-1 are CNs. Two BFS branches (distinct
    first-hop edges from the root) meeting at a vertex or crossing an edge
    close a cycle through the root. Returns cycle length or _INF; stops
    early once dist exceeds cutoff/2.
    """
    dist = {root: 0}
    branch = {root: -1}
    frontier = [root]
    best = _INF
    d = 0
    while frontier and 2 * d < min(best, cutoff):
        nxt = []
        for u in frontier:
            is_vn = u < n
            neigh = vn_adj[u] + n if is_vn else cn_adj[u - n]
            for w in map(int, neigh):
                bu = branch[u] if u != root else w
                if w not in dist:
                    dist[w] = d + 1
                    branch[w] = bu
                    nxt.append(w)
                elif branch[w] != bu and (dist[w] == d + 1 or dist[w] == d):
                    # two branches meet at w (same level) or cross an edge
                    best = min(best, dist[w] + d + 1)
        frontier = nxt
        d += 1
    return best


def girth(code: LDPCCode, cutoff: int = 32) -> int:
    """Exact Tanner-graph girth (min cycle length), or `cutoff` if none
    shorter is found. Every cycle in a bipartite graph passes through a VN,
    so BFS from each VN suffices; for QC codes the rotational symmetry cuts
    the roots to one VN per base column. Intended for construction-time
    validation (n up to a few thousand)."""
    vn = code.vn_adj()
    cn = [np.asarray(a) for a in code.cn_adj]
    if code.Z is not None and code.base is not None:
        roots = [j * code.Z for j in range(code.base.shape[1])]
    else:
        roots = range(code.n)
    best = cutoff
    for r in roots:
        best = min(best, _shortest_cycle_through_vn(
            r, vn, cn, code.n, code.m, best))
    return best


# ---------------------------------------------------------------------------
# Unstructured PEG
# ---------------------------------------------------------------------------

def _bfs_check_dists(v: int, vn_checks: List[List[int]],
                     cn_vars: List[List[int]], m: int) -> np.ndarray:
    """Distances from VN v to every CN in the current (partial) graph.
    Returns int array (m,) with _INF for unreachable checks."""
    dist_c = np.full(m, _INF, np.int64)
    seen_v = {v}
    frontier_v = [v]
    d = 0
    while frontier_v:
        d += 1
        frontier_c = []
        for u in frontier_v:
            for c in vn_checks[u]:
                if dist_c[c] == _INF:
                    dist_c[c] = d
                    frontier_c.append(c)
        d += 1
        frontier_v = []
        for c in frontier_c:
            for w in cn_vars[c]:
                if w not in seen_v:
                    seen_v.add(w)
                    frontier_v.append(w)
    return dist_c


def peg_construct(n: int, m: int,
                  vn_degrees: Sequence[int] | int | Dict[int, float],
                  seed: int = 0, name: Optional[str] = None,
                  require_full_rank: bool = True,
                  max_rank_retries: int = 8) -> LDPCCode:
    """Classic PEG construction of an (n, m) Tanner graph.

    vn_degrees: per-VN degree sequence (len n), a single int (regular), or a
    node-perspective profile dict (degrees_from_profile). VNs are processed
    in non-decreasing degree order; each edge connects to the check at
    maximal BFS distance (unreachable preferred), ties broken by minimum
    check degree then seeded-random.

    The expanded H is checked full-rank (systematic encodability); on a
    deficient draw the constructor retries with a folded seed.
    """
    if isinstance(vn_degrees, dict):
        degs = degrees_from_profile(n, vn_degrees)
    elif np.isscalar(vn_degrees):
        degs = np.full(n, int(vn_degrees), np.int32)
    else:
        degs = np.asarray(vn_degrees, np.int32)
        if degs.shape != (n,):
            raise ValueError(f"vn_degrees must have length n={n}")
    if degs.min() < 1 or degs.max() > m:
        raise ValueError("vn degrees must be in [1, m]")

    for attempt in range(max_rank_retries):
        rng = np.random.default_rng(seed + (attempt << 20))
        code = _peg_once(n, m, degs, rng, name or f"peg-{n}-{m}-s{seed}")
        if not require_full_rank or gf2_rank(code.h_dense()) == m:
            return code
    raise ValueError(f"PEG produced rank-deficient H in {max_rank_retries} "
                     f"attempts (n={n}, m={m}); adjust degrees/seed")


def _peg_once(n: int, m: int, degs: np.ndarray, rng: np.random.Generator,
              name: str) -> LDPCCode:
    order = np.argsort(degs, kind="stable")
    vn_checks: List[List[int]] = [[] for _ in range(n)]
    cn_vars: List[List[int]] = [[] for _ in range(m)]
    cn_deg = np.zeros(m, np.int64)
    for v in map(int, order):
        for t in range(int(degs[v])):
            if t == 0:
                cands = np.nonzero(cn_deg == cn_deg.min())[0]
            else:
                dist = _bfs_check_dists(v, vn_checks, cn_vars, m)
                unreached = np.nonzero(dist == _INF)[0]
                if len(unreached):
                    cands = unreached
                else:
                    # all reached: maximize distance, never re-picking a
                    # check already connected to v (those sit at dist 1)
                    dist[np.asarray(vn_checks[v])] = -1
                    dmax = dist.max()
                    cands = np.nonzero(dist == dmax)[0]
            sub = cands[cn_deg[cands] == cn_deg[cands].min()]
            c = int(sub[rng.integers(0, len(sub))])
            vn_checks[v].append(c)
            cn_vars[c].append(v)
            cn_deg[c] += 1
    cn_adj = [np.sort(np.asarray(a, np.int32)) for a in cn_vars]
    return LDPCCode(name=name, n=n, m=m, k=n - m, cn_adj=cn_adj,
                    standard_exact=False)


# ---------------------------------------------------------------------------
# QC (circulant) PEG with dual-diagonal parity skeleton
# ---------------------------------------------------------------------------

def _qc_bfs(B: np.ndarray, Z: int, j0: int) -> np.ndarray:
    """BFS in the lifted graph from variable (j0, 0).

    Returns D (mb, Z): D[i, q] = distance to lifted check (i, q), _INF if
    unreachable. Under QC symmetry dist((j0,r) -> (i,q+r)) = D[i,q] for all
    rotations r, so one BFS covers the whole orbit.
    """
    mb, nb = B.shape
    dist_c = np.full((mb, Z), _INF, np.int64)
    dist_v = np.full((nb, Z), _INF, np.int64)
    dist_v[j0, 0] = 0
    frontier_v: List[Tuple[int, int]] = [(j0, 0)]
    d = 0
    # Precompute adjacency at base level.
    col_rows = [np.nonzero(B[:, j] >= 0)[0] for j in range(nb)]
    row_cols = [np.nonzero(B[i] >= 0)[0] for i in range(mb)]
    while frontier_v:
        d += 1
        frontier_c: List[Tuple[int, int]] = []
        for (j, q) in frontier_v:
            for i in col_rows[j]:
                r = (q - int(B[i, j])) % Z
                if dist_c[i, r] == _INF:
                    dist_c[i, r] = d
                    frontier_c.append((int(i), r))
        d += 1
        frontier_v = []
        for (i, r) in frontier_c:
            for j in row_cols[i]:
                q = (r + int(B[i, j])) % Z
                if dist_v[j, q] == _INF:
                    dist_v[j, q] = d
                    frontier_v.append((int(j), q))
    return dist_c


def _qc_bfs_from_check(B: np.ndarray, Z: int, i0: int) -> np.ndarray:
    """BFS in the lifted graph from check (i0, 0).

    Returns D (nb, Z): D[j, q] = distance to lifted variable (j, q), _INF
    if unreachable. The check-rooted dual of _qc_bfs, used when placing a
    ROW's edges (PBRL extension rows)."""
    mb, nb = B.shape
    dist_c = np.full((mb, Z), _INF, np.int64)
    dist_v = np.full((nb, Z), _INF, np.int64)
    dist_c[i0, 0] = 0
    frontier_c: List[Tuple[int, int]] = [(i0, 0)]
    d = 0
    col_rows = [np.nonzero(B[:, j] >= 0)[0] for j in range(nb)]
    row_cols = [np.nonzero(B[i] >= 0)[0] for i in range(mb)]
    while frontier_c:
        d += 1
        frontier_v: List[Tuple[int, int]] = []
        for (i, r) in frontier_c:
            for j in row_cols[i]:
                q = (r + int(B[i, j])) % Z
                if dist_v[j, q] == _INF:
                    dist_v[j, q] = d
                    frontier_v.append((int(j), q))
        d += 1
        frontier_c = []
        for (j, q) in frontier_v:
            for i in col_rows[j]:
                r = (q - int(B[i, j])) % Z
                if dist_c[i, r] == _INF:
                    dist_c[i, r] = d
                    frontier_c.append((int(i), r))
    return dist_v


def _shift_collides(B: np.ndarray, Z: int, i: int, j: int, s: int) -> bool:
    """Exact test: does placing shift s at B[i, j] close a lifted 4-cycle?

    A 4-cycle exists iff some row i2 (with B[i2, j] >= 0) and column j2
    (with B[i, j2] >= 0 and B[i2, j2] >= 0) satisfy
    (s - B[i2, j]) == (B[i, j2] - B[i2, j2])  (mod Z).
    """
    mb = B.shape[0]
    cols_i = np.nonzero(B[i] >= 0)[0]
    for i2 in range(mb):
        if i2 == i or B[i2, j] < 0:
            continue
        lhs = (s - int(B[i2, j])) % Z
        for j2 in cols_i:
            if j2 != j and B[i2, j2] >= 0:
                if (int(B[i, j2]) - int(B[i2, j2])) % Z == lhs:
                    return True
    return False


def qc_peg_construct(kb: int, cb: int, Z: int,
                     col_degrees: Sequence[int] | int | Dict[int, float],
                     seed: int = 0, name: Optional[str] = None,
                     mb: Optional[int] = None) -> LDPCCode:
    """QC-PEG: encodable dual-diagonal QC code with PEG-placed info columns.

    Base matrix shape (mb, kb + mb) with the gen_qc_code parity skeleton
    (weight-3 column + zero-shift staircase over cb core rows, identity
    extension rows below). Each info column j gets col_degrees[j] circulant
    entries; rows and shifts are chosen from a lifted-graph BFS per edge
    (maximal distance = maximal new-cycle length) with an exact 4-cycle
    veto, so the expanded girth is >= 6 by construction.

    col_degrees: per-info-column BASE degree (int, sequence of len kb, or a
    node-perspective profile dict over base columns). mb defaults to cb (no
    extension rows). Result: n = (kb+mb)*Z, rate kb/(kb+mb), encoder-ready
    (detect_enc_struct passes), standard_exact=False.
    """
    mb = cb if mb is None else mb
    if mb < cb or cb < 3:
        raise ValueError("need mb >= cb >= 3")
    if isinstance(col_degrees, dict):
        degs = degrees_from_profile(kb, col_degrees)
    elif np.isscalar(col_degrees):
        degs = np.full(kb, int(col_degrees), np.int32)
    else:
        degs = np.asarray(col_degrees, np.int32)
        if degs.shape != (kb,):
            raise ValueError(f"col_degrees must have length kb={kb}")
    if degs.min() < 2 or degs.max() > mb:
        raise ValueError("info-column base degrees must be in [2, mb]")

    rng = np.random.default_rng(seed)
    nb = kb + mb
    B = np.full((mb, nb), -1, np.int64)
    parity_skeleton(B, kb, cb, mb, Z)

    # PEG over info columns, lowest base degree first (stable order).
    row_deg = (B >= 0).sum(axis=1)
    for j in map(int, np.argsort(degs, kind="stable")):
        for t in range(int(degs[j])):
            placed = _place_qc_edge(B, Z, j, row_deg, rng)
            if not placed:
                raise ValueError(
                    f"QC-PEG: no 4-cycle-free placement for column {j} edge "
                    f"{t} (kb={kb}, mb={mb}, Z={Z}) — lower the degrees or "
                    f"raise Z")
    st = detect_enc_struct(B)
    assert st is not None and st.kb == kb and st.cb == cb
    code = expand_qc(B, Z, name=name or f"qcpeg-{kb}x{mb}-Z{Z}-s{seed}",
                     standard_exact=False)
    return code


def _place_qc_edge(B: np.ndarray, Z: int, j: int, row_deg: np.ndarray,
                   rng: np.random.Generator,
                   rows: Optional[Sequence[int]] = None) -> bool:
    """Place one circulant entry in info column j: pick (row, shift) by
    maximal lifted-BFS distance with exact 4-cycle veto. Mutates B/row_deg.
    Returns False if every (row, shift) would close a 4-cycle.
    rows restricts the candidate base rows (PBRL core placement)."""
    mb = B.shape[0]
    cand_rows = range(mb) if rows is None else rows
    open_rows = [i for i in cand_rows if B[i, j] < 0]
    if not open_rows:
        raise ValueError(f"column {j}: degree exceeds row count")
    D = _qc_bfs(B, Z, j)  # (mb, Z); all-_INF when column j has no edges yet
    best: Tuple[int, int, int, int] = (-1, -1, -1, -1)  # (score, -deg, i, s)
    best_list: List[Tuple[int, int]] = []
    for i in open_rows:
        for s in range(Z):
            q = (-s) % Z  # new-cycle length via this lifted edge = 1 + D[i,q]
            d = D[i, q]
            score = _INF if d == _INF else d + 1
            key = (score, -int(row_deg[i]))
            if key < (best[0], best[1]):
                continue
            if _shift_collides(B, Z, i, j, s):
                continue
            if key > (best[0], best[1]):
                best = (key[0], key[1], i, s)
                best_list = [(i, s)]
            else:
                best_list.append((i, s))
    if not best_list:
        return False
    i, s = best_list[int(rng.integers(0, len(best_list)))]
    B[i, j] = s
    row_deg[i] += 1
    return True


def _place_row_edge(B: np.ndarray, Z: int, i: int, allowed_cols,
                    rng: np.random.Generator) -> bool:
    """Place one circulant entry in ROW i (PBRL extension rows): pick
    (column, shift) by maximal check-rooted lifted-BFS distance with the
    exact 4-cycle veto; ties prefer the lightest column. Mutates B."""
    col_deg = (B >= 0).sum(axis=0)
    open_cols = [j for j in allowed_cols if B[i, j] < 0]
    if not open_cols:
        raise ValueError(f"row {i}: degree exceeds allowed columns")
    D = _qc_bfs_from_check(B, Z, i)  # (nb, Z)
    best: Tuple[int, int, int, int] = (-1, -1, -1, -1)
    best_list: List[Tuple[int, int]] = []
    for j in open_cols:
        for s in range(Z):
            d = D[j, s]  # new-cycle length via lifted edge (i,0)-(j,s)
            score = _INF if d == _INF else d + 1
            key = (score, -int(col_deg[j]))
            if key < (best[0], best[1]):
                continue
            if _shift_collides(B, Z, i, j, s):
                continue
            if key > (best[0], best[1]):
                best = (key[0], key[1], j, s)
                best_list = [(j, s)]
            else:
                best_list.append((j, s))
    if not best_list:
        return False
    j, s = best_list[int(rng.integers(0, len(best_list)))]
    B[i, j] = s
    return True


def pbrl_construct(kb: int, cb: int, Z: int, n_ext: int,
                   core_col_degrees: Sequence[int] | int | Dict[int, float]
                   = 3,
                   ext_row_degree: int = 3, seed: int = 0,
                   name: Optional[str] = None) -> LDPCCode:
    """PBRL-style (protograph-based raptor-like) rate-compatible QC code.

    Structure (the 3GPP-NR base-graph shape, built here by PEG): a
    HIGH-RATE core — kb info columns PEG-placed over cb dual-diagonal
    parity rows — followed by n_ext EXTENSION rows, each carrying a
    weight-1 identity parity in its own column plus ext_row_degree
    PEG-placed circulants over the info + core-parity columns (chosen by
    check-rooted lifted BFS with the exact 4-cycle veto).

    Mother rate kb/(kb+cb+n_ext). Because every extension parity column
    has degree 1, tail-puncturing them (codes/rate_compat 'tail' order =
    last extension first) is exactly incremental redundancy: each
    untransmitted extension leaves a dangling check the decoder ignores,
    and each transmitted one adds a designed parity — unlike naive
    puncturing of a dual-diagonal code's staircase, whose degree-2 chain
    degrades the core graph. Encoder-ready (detect_enc_struct passes:
    core back-substitution then per-row extension XORs, O(E)).
    """
    if cb < 3 or n_ext < 0:
        raise ValueError("need cb >= 3 and n_ext >= 0")
    if isinstance(core_col_degrees, dict):
        degs = degrees_from_profile(kb, core_col_degrees)
    elif np.isscalar(core_col_degrees):
        degs = np.full(kb, int(core_col_degrees), np.int32)
    else:
        degs = np.asarray(core_col_degrees, np.int32)
        if degs.shape != (kb,):
            raise ValueError(f"core_col_degrees must have length kb={kb}")
    if degs.min() < 2 or degs.max() > cb:
        raise ValueError("core info degrees must be in [2, cb]")
    if not 1 <= ext_row_degree <= kb + cb:
        raise ValueError("ext_row_degree must be in [1, kb+cb]")

    rng = np.random.default_rng(seed)
    mb = cb + n_ext
    nb = kb + mb
    B = np.full((mb, nb), -1, np.int64)
    parity_skeleton(B, kb, cb, mb, Z)

    # 1. the high-rate core: PEG over info columns, core rows only
    row_deg = (B >= 0).sum(axis=1)
    core_rows = list(range(cb))
    for j in map(int, np.argsort(degs, kind="stable")):
        for t in range(int(degs[j])):
            if not _place_qc_edge(B, Z, j, row_deg, rng, rows=core_rows):
                raise ValueError(
                    f"PBRL core: no 4-cycle-free placement for column {j} "
                    f"(kb={kb}, cb={cb}, Z={Z})")
    # 2. extension rows, one at a time (incremental-redundancy order)
    allowed = list(range(kb + cb))  # info + core parity, never other exts
    for e in range(cb, mb):
        for _ in range(ext_row_degree):
            if not _place_row_edge(B, Z, e, allowed, rng):
                raise ValueError(
                    f"PBRL extension row {e}: no 4-cycle-free placement")
    st = detect_enc_struct(B)
    assert st is not None and st.kb == kb and st.cb == cb
    return expand_qc(B, Z,
                     name=name or f"pbrl-{kb}x{cb}+{n_ext}-Z{Z}-s{seed}",
                     standard_exact=False)


def count_6cycles(code: LDPCCode) -> int:
    """Exact number of 6-cycles in the Tanner graph.

    Girth says only whether short cycles exist; their MULTIPLICITY is the
    finer construction-quality metric (two girth-6 codes can differ by
    thousands of 6-cycles — the cycle census discriminates construction
    seeds where the greedy trapping census cannot, its spectrum being
    dominated by the shared parity chain). Enumeration: 6-cycles through
    one VN per orbit (QC rotation symmetry), each cycle touched by 3 VNs
    and walked in 2 directions; total = Z * sum_reps c(rep) / (3 * 2)
    (unstructured codes loop every VN with Z = 1).
    """
    vn = code.vn_adj()
    cn = code.cn_adj
    if code.Z is not None and code.base is not None:
        reps = [j * code.Z for j in range(code.base.shape[1])]
        mult = code.Z
    else:
        reps = range(code.n)
        mult = 1
    total_dir = 0
    for v in reps:
        checks_v = set(map(int, vn[v]))
        for ca in map(int, vn[v]):
            for w in map(int, cn[ca]):
                if w == v:
                    continue
                for cb in map(int, vn[w]):
                    if cb == ca:
                        continue
                    for x in map(int, cn[cb]):
                        if x == v or x == w:
                            continue
                        # closing checks: adjacent to both x and v,
                        # distinct from ca/cb
                        for cc in map(int, vn[x]):
                            if cc != ca and cc != cb and cc in checks_v:
                                total_dir += 1
    assert (mult * total_dir) % 6 == 0
    return mult * total_dir // 6


def qc_peg_best(kb: int, cb: int, Z: int,
                col_degrees, n_seeds: int = 8, seed0: int = 0,
                mb: Optional[int] = None, name: Optional[str] = None,
                use_absorbing: bool = True
                ) -> Tuple[LDPCCode, List[dict]]:
    """QC-PEG with construction-seed selection by
    (girth desc, 6-cycle count asc, EXACT absorbing spectrum asc).

    The ordering is the round-4 SILICON-measured verdict
    (results/census_ab.json, floor_ab.json — two falsified predictions,
    recorded in both artifacts):
      * the 6-cycle count is the strongest offline discriminator among
        same-geometry constructed seeds — it ordered them correctly at
        the 3.0 dB tail AND at the 5.0 dB deep floor (s7 c6=3888 beat
        s2 c6=4077 in both regimes, while the absorbing-class spectrum
        ranked s2 first and was wrong twice);
      * the exact absorbing spectrum (exhaustive native-C census,
        analysis/asenum.py, a<=8 b<=3 dv_cap=3, ~2 s/seed) breaks c6
        ties and explains the expert-table gap the cycle census cannot
        (the 802.11n standard has NO absorbing set below a=6 and beats
        every constructed seed despite a mid-pack c6);
      * class counts do NOT rank floors (per-set basin strength varies
        ~100x within a class): for floor-critical selection, feed the
        census sets to the mixture-IS floor estimator
        (sim/impsamp.py + radial ladder — minutes per code on a chip)
        and rank by the measured estimate.
    use_absorbing=False skips the census for quick scans."""
    table = []
    best = None
    for s in range(seed0, seed0 + n_seeds):
        code = qc_peg_construct(kb=kb, cb=cb, Z=Z, col_degrees=col_degrees,
                                seed=s, mb=mb, name=name)
        g = girth(code)
        c6 = count_6cycles(code) if g <= 6 else 0
        if use_absorbing:
            raise NotImplementedError(
                "qc_peg_best(use_absorbing=True): the exact absorbing-set "
                "census (analysis/asenum) is not ported yet (ROADMAP module "
                "item 17); pass use_absorbing=False")
        key_abs, n_abs, classes = (), 0, {}
        row = {"seed": s, "girth": g, "absorbing": n_abs,
               "absorbing_classes": classes, "cycles6": c6}
        table.append(row)
        key = (-g, c6, key_abs)
        if best is None or key < best[0]:
            best = (key, code)
    return best[1], table


def as_optimize(code: LDPCCode, a_max: int = 7, b_max: int = 3,
                dv_cap: int = 3, max_evals: int = 400,
                seed: int = 1) -> Tuple[LDPCCode, List[dict]]:
    """Absorbing-set-aware shift re-placement (round-5 closing of the
    design loop): greedily re-draw circulant shifts of info-column edges
    that participate in the SMALLEST absorbing classes, accepting only
    strict lexicographic improvements of (girth desc, exact absorbing
    spectrum asc — analysis/asenum.py census, the silicon-validated
    ordering of absorbing_spectrum_key). The parity skeleton (dual-
    diagonal staircase + weight-3 column) is never touched, so the
    result stays encoder-ready; every accepted move passes the exact
    lifted 4-cycle veto, so girth >= 6 is preserved.

    Strategy: emit the census's absorbing sets, rank candidate base
    edges by participation in the smallest (a+b) class, and for each try
    Z-1 alternative shifts (randomized order), evaluating the FULL exact
    census per candidate (~0.3 s at wifi-648 geometry with dv_cap=3 —
    cheap enough that the objective is the TRUE spectrum, not a proxy).
    First-improvement restarts the pass. Returns (optimized code, log)."""
    raise NotImplementedError(
        "as_optimize: the exact absorbing-set census (analysis/asenum) is "
        "not ported yet (ROADMAP module item 17)")


def count_8cycles(code: LDPCCode) -> int:
    """Exact number of 8-cycles (simple cycles: 4 distinct VNs, 4 distinct
    CNs). Same per-orbit enumeration as count_6cycles one level deeper;
    each cycle is touched by 4 VNs and walked in 2 directions, so
    total = mult * directed_count / (4 * 2) with mult = Z for QC codes."""
    vn = code.vn_adj()
    cn = code.cn_adj
    if code.Z is not None and code.base is not None:
        reps = [j * code.Z for j in range(code.base.shape[1])]
        mult = code.Z
    else:
        reps = range(code.n)
        mult = 1
    total_dir = 0
    for v in reps:
        checks_v = set(map(int, vn[v]))
        for c1 in map(int, vn[v]):
            for w in map(int, cn[c1]):
                if w == v:
                    continue
                for c2 in map(int, vn[w]):
                    if c2 == c1:
                        continue
                    for x in map(int, cn[c2]):
                        if x == v or x == w:
                            continue
                        for c3 in map(int, vn[x]):
                            if c3 == c1 or c3 == c2:
                                continue
                            for y in map(int, cn[c3]):
                                if y == v or y == w or y == x:
                                    continue
                                for c4 in map(int, vn[y]):
                                    if (c4 in checks_v and c4 != c1
                                            and c4 != c2 and c4 != c3):
                                        total_dir += 1
    assert (mult * total_dir) % 8 == 0
    return mult * total_dir // 8
