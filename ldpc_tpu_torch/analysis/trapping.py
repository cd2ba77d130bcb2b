"""Trapping-set analysis: classification, greedy graph search, and
refinement of harvested decoder-failure supports (a numpy copy of
`ldpc_tpu/analysis/trapping.py`, under the same names; the code objects
are the port's `codes.code.LDPCCode`).

Fixed-point min-sum error floors are dominated by small (a, b) trapping
sets — sets S of a variable nodes whose induced subgraph leaves b checks
with odd degree (Richardson's error-floor methodology). This module is the
graph side (pure NumPy); `sim/impsamp.py` is the Monte-Carlo side (failure
harvesting on the simulation step + mixture importance sampling whose
proposal is built from these sets).

Terminology: a = |S|; b = number of parity checks connected to S an odd
number of times. An (a, 0) set is a codeword-support (undetectable error);
small a with small b >= 1 are the classic error-floor culprits.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np

from ..codes.code import LDPCCode


def classify(code: LDPCCode, support: Sequence[int]) -> Tuple[int, int]:
    """(a, b) class of a VN set: a = |S|, b = # odd-degree induced checks."""
    s = np.zeros(code.n, np.uint8)
    s[np.asarray(list(support), np.int64)] = 1
    syn = code.syndrome(s)
    return int(s.sum()), int(syn.sum())


def odd_checks(code: LDPCCode, support: Sequence[int]) -> np.ndarray:
    """Indices of checks connected an odd number of times to the set."""
    s = np.zeros(code.n, np.uint8)
    s[np.asarray(list(support), np.int64)] = 1
    return np.nonzero(code.syndrome(s))[0].astype(np.int32)


def refine_support(code: LDPCCode, support: Sequence[int],
                   max_passes: int = 4) -> FrozenSet[int]:
    """Shrink a harvested failure support toward its trapping-set core:
    repeatedly drop the first VN (ascending order) whose removal does not
    increase b (removing a satellite bit strictly reduces a at
    equal-or-better b). All single-removal trials of a round are evaluated
    in ONE batched syndrome call, so this scales to DVB-S2-sized graphs."""
    del max_passes  # kept for API compatibility; the loop runs to fixpoint
    s = set(int(v) for v in support)
    # accept the first improving removal, re-evaluate until no removal
    # keeps b from rising (a fixpoint — a second sweep cannot find more)
    while len(s) > 1:
        order = sorted(s)
        svec = np.zeros(code.n, np.uint8)
        svec[order] = 1
        b = int(code.syndrome(svec).sum())
        stack = np.tile(svec, (len(order), 1))
        stack[np.arange(len(order)), order] = 0
        b2 = code.syndrome(stack).sum(axis=-1)
        ok = np.nonzero(b2 <= b)[0]
        if len(ok) == 0:
            break
        s.remove(order[int(ok[0])])
    return frozenset(s)


def _grow_greedy(code: LDPCCode, seed_set: FrozenSet[int], a_max: int,
                 vn_adj: List[np.ndarray]
                 ) -> List[Tuple[int, int, FrozenSet[int]]]:
    """Greedy expansion from a seed: at each step add the VN adjacent to an
    odd check that minimizes the resulting b. Records every intermediate
    (a, b, S)."""
    s = set(seed_set)
    out = []
    svec = np.zeros(code.n, np.uint8)
    svec[list(s)] = 1
    parity = code.syndrome(svec)
    out.append((len(s), int(parity.sum()), frozenset(s)))
    while len(s) < a_max:
        odd = np.nonzero(parity)[0]
        if len(odd) == 0:
            break  # reached a codeword support
        # candidates: VNs on odd checks, not already in S
        cand = set()
        for c in odd:
            cand.update(int(v) for v in code.cn_adj[c])
        cand -= s
        if not cand:
            break
        best_v, best_b = None, None
        b_cur = int(parity.sum())
        for v in sorted(cand):
            # adding v toggles the parity of its checks
            b2 = b_cur + len(vn_adj[v]) - 2 * int(parity[vn_adj[v]].sum())
            if best_b is None or b2 < best_b:
                best_v, best_b = v, b2
        s.add(best_v)
        parity[vn_adj[best_v]] ^= 1
        out.append((len(s), int(parity.sum()), frozenset(s)))
    return out


def search_trapping_sets(code: LDPCCode, a_max: int = 8, b_max: int = 4,
                         seeds: Sequence[Sequence[int]] = (),
                         per_vn_seeds: bool = True,
                         max_sets: int = 256
                         ) -> Dict[Tuple[int, int], List[FrozenSet[int]]]:
    """Greedy search for small (a, b) trapping sets.

    Seeds: every single VN (per_vn_seeds) plus any caller-provided sets
    (e.g. refined harvested failure supports from sim/impsamp.py). Each
    seed grows greedily by minimum-b; every visited (a <= a_max,
    b <= b_max) set is recorded, deduplicated. Heuristic (greedy search
    cannot be exhaustive) — intended to feed the IS proposal, where missing
    sets cost variance, not correctness.
    """
    vn_adj = code.vn_adj()
    found: Dict[Tuple[int, int], List[FrozenSet[int]]] = {}
    seen: set = set()
    all_seeds: List[FrozenSet[int]] = [frozenset(map(int, s)) for s in seeds]
    if per_vn_seeds:
        # On large graphs a growth per VN is hours of NumPy; an evenly
        # spaced sample keeps the search bounded (growths are local, so
        # coverage scales with sample count, not graph size).
        step = max(1, code.n // 4096)
        all_seeds += [frozenset([v]) for v in range(0, code.n, step)]
    for sd in all_seeds:
        for a, b, S in _grow_greedy(code, sd, a_max, vn_adj):
            if a <= a_max and b <= b_max and S not in seen:
                seen.add(S)
                found.setdefault((a, b), []).append(S)
                if len(seen) >= max_sets:
                    return dict(sorted(found.items()))
    return dict(sorted(found.items()))


def dominant_sets(found: Dict[Tuple[int, int], List[FrozenSet[int]]],
                  k: int = 32, min_a: int = 1) -> List[FrozenSet[int]]:
    """The k most error-floor-relevant sets: sort classes by (a + b) then a
    (small sets with few unsatisfied checks dominate the floor).

    min_a filters out tiny sets: an isolated 1-2 bit flip is trivially
    corrected by any BP decoder, so (1, b)/(2, b) classes make useless IS
    proposals even though they rank well on a + b — real floor culprits
    are a >= ~4 cores with small b (measured on 802.11n n=648: harvested
    failure cores classify as (6,4)/(7,3)-class, never (1,b))."""
    ranked = []
    for (a, b), sets in found.items():
        if a < min_a:
            continue
        for s in sets:
            ranked.append((a + b, a, s))
    ranked.sort(key=lambda t: (t[0], t[1], sorted(t[2])))
    return [s for _, _, s in ranked[:k]]


def is_absorbing(code: LDPCCode, support: Sequence[int]) -> bool:
    """True when the set is ABSORBING: every VN in S has strictly more
    satisfied (even-degree) than unsatisfied (odd-degree) neighboring
    checks under the induced subgraph — the condition that makes an (a,b)
    trapping set a stable bit-flipping/min-sum attractor (Dolecek et al.).
    The round-4 tail study showed the 802.11n expert table's remaining
    edge over census-optimal QC-PEG lies in exactly this structure (both
    exact short-cycle counts FAVORED the constructed code)."""
    s = np.zeros(code.n, np.uint8)
    idx = np.asarray(sorted(set(map(int, support))), np.int64)
    s[idx] = 1
    syn = code.syndrome(s)  # 1 = odd/unsatisfied check
    vn = code.vn_adj()
    for v in idx:
        odd = int(syn[vn[v]].sum())
        if 2 * odd >= len(vn[v]):
            return False
    return True
