"""Exact connected trapping/absorbing-set enumeration (a copy of
`ldpc_tpu/analysis/asenum.py` over `ldpc_tpu_torch/csrc/as_enum.c`, a copy
of `csrc/as_enum.c`; host C, no GPU kernel). The library is built with the
system compiler into `ldpc_tpu_torch/csrc/build/` by `utils.native`, whose
file name carries a hash of the source.

The greedy census (analysis/trapping.py::search_trapping_sets,
codes/peg.py absorbing census) can FIND small sets but cannot prove their
absence; this wrapper drives the native-C ESU enumerator, which visits
every connected VN subset up to a_max exactly once and tallies (a, b)
classes and absorbing sets exhaustively — the "remaining instrument gap"
named at the end of docs/ROUND4.md.

Scope knobs (both part of the reported result, never silent):
  * connectivity — only connected sets; a disconnected set's components
    are themselves enumerated (b adds across components).
  * dv_cap — only VNs of degree <= dv_cap participate (0 = all). The
    802.11n hub columns (degree 12) inflate the search space by orders of
    magnitude while a degree-d VN inside a size-a set forces at least
    d - 2*(a - 1) unpaired check slots on its own, so small-(a, b) sets
    avoid hubs; `hub_floor` quantifies the exclusion: a set containing an
    excluded VN has b >= min_over_excluded(d_v) - 2*(a - 1) (the
    conservative bound enumerate_sets actually computes — the weakest
    excluded degree governs the guarantee).
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..codes.code import LDPCCode

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
SOURCE = os.path.join(_CSRC, "as_enum.c")
BUILD_DIR = os.path.join(_CSRC, "build")


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from ..utils.native import load_native
    lib = load_native(SOURCE, BUILD_DIR)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.ldpc_enum_connected.argtypes = [
        ctypes.c_int, ctypes.c_int,
        i32p, i32p, i32p, i32p,
        u8p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i32p, i32p,
        i64p, i64p, i64p,
    ]
    lib.ldpc_enum_connected.restype = None
    return lib


def _vn_csr(code: LDPCCode) -> Tuple[np.ndarray, np.ndarray]:
    vn = code.vn_adj()
    indptr = np.zeros(code.n + 1, np.int32)
    indptr[1:] = np.cumsum([len(a) for a in vn])
    return indptr, np.concatenate(vn).astype(np.int32)


def _vn_adjacency(code: LDPCCode,
                  allowed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicated VN-VN adjacency (share >= 1 check), restricted to
    allowed VNs, CSR over all n rows (empty rows for excluded VNs)."""
    src: List[np.ndarray] = []
    dst: List[np.ndarray] = []
    for c in range(code.m):
        vs = np.asarray(code.cn_adj[c], np.int32)
        vs = vs[allowed[vs] != 0]
        if len(vs) < 2:
            continue
        a, b = np.meshgrid(vs, vs, indexing="ij")
        mask = a != b
        src.append(a[mask])
        dst.append(b[mask])
    if not src:
        indptr = np.zeros(code.n + 1, np.int32)
        return indptr, np.zeros(0, np.int32)
    s = np.concatenate(src)
    d = np.concatenate(dst)
    key = s.astype(np.int64) * code.n + d
    uniq = np.unique(key)
    s = (uniq // code.n).astype(np.int32)
    d = (uniq % code.n).astype(np.int32)
    indptr = np.zeros(code.n + 1, np.int32)
    np.add.at(indptr, s + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return indptr, d


@dataclasses.dataclass
class EnumResult:
    """Exhaustive census. class_counts[a, b] = number of connected sets of
    a allowed VNs inducing exactly b odd checks (b <= b_max); absorb_counts
    likewise for absorbing sets. hub_floor: minimum b forced on any set
    that CONTAINS an excluded VN (inf when nothing was excluded) — states
    precisely what the dv_cap scope excludes."""
    a_max: int
    b_max: int
    dv_cap: int
    class_counts: np.ndarray      # (a_max+1, b_max+1) int64
    absorb_counts: np.ndarray
    sets: List[Tuple[int, int, bool, Tuple[int, ...]]]  # (a, b, absorbing, S)
    nodes_visited: int
    n_allowed: int
    hub_floor: float
    emit_truncated: bool

    def absorbing_total(self, a_min: int = 1) -> int:
        return int(self.absorb_counts[a_min:].sum())

    def summary(self) -> Dict:
        nz = {f"({a},{b})": int(self.class_counts[a, b])
              for a in range(self.a_max + 1)
              for b in range(self.b_max + 1)
              if self.class_counts[a, b]}
        anz = {f"({a},{b})": int(self.absorb_counts[a, b])
               for a in range(self.a_max + 1)
               for b in range(self.b_max + 1)
               if self.absorb_counts[a, b]}
        return {"a_max": self.a_max, "b_max": self.b_max,
                "dv_cap": self.dv_cap, "n_allowed": self.n_allowed,
                "classes": nz, "absorbing": anz,
                "nodes_visited": self.nodes_visited,
                "hub_floor": (None if np.isinf(self.hub_floor)
                              else float(self.hub_floor)),
                "emit_truncated": self.emit_truncated}


def enumerate_sets(code: LDPCCode, a_max: int = 6, b_max: int = 3,
                   dv_cap: int = 0, emit_min_a: int = 3,
                   emit_cap: int = 4096,
                   threads: Optional[int] = None) -> EnumResult:
    """Exhaustively enumerate connected (a <= a_max, b <= b_max) sets.

    dv_cap: exclude VNs of degree > dv_cap (0 = include all). emit_cap
    bounds how many explicit sets are returned (counts are always exact;
    emit_truncated says whether the LIST is complete).
    """
    if a_max < 1 or a_max > 24:
        raise ValueError(f"a_max must be in [1, 24], got {a_max}")
    if b_max < 0:
        raise ValueError(f"b_max must be >= 0, got {b_max}")
    vn_indptr, vn_checks = _vn_csr(code)
    degs = np.diff(vn_indptr)
    allowed = (np.ones(code.n, np.uint8) if dv_cap <= 0
               else (degs <= dv_cap).astype(np.uint8))
    excluded_degs = degs[allowed == 0]
    hub_floor = (float("inf") if len(excluded_degs) == 0
                 else float(excluded_degs.min() - 2 * (a_max - 1)))
    adj_indptr, adj = _vn_adjacency(code, allowed)
    dv_eff = int(degs[allowed != 0].max()) if allowed.any() else 0

    out_sets = np.full((emit_cap, a_max), -1, np.int32)
    out_ab = np.zeros((emit_cap, 3), np.int32)
    n_emit = np.zeros(1, np.int32)
    cls = np.zeros((a_max + 1) * (b_max + 1), np.int64)
    acls = np.zeros((a_max + 1) * (b_max + 1), np.int64)
    nodes = np.zeros(1, np.int64)
    if threads is not None:
        # env var only matters before the OpenMP runtime initializes; the
        # runtime call works on every invocation (dlsym through the .so
        # handle reaches libgomp via the dependency chain)
        os.environ["OMP_NUM_THREADS"] = str(threads)
        try:
            setter = _lib().omp_set_num_threads
            setter.argtypes = [ctypes.c_int]
            setter.restype = None
            setter(int(threads))
        except AttributeError:
            pass  # built without OpenMP: single-threaded anyway
    _lib().ldpc_enum_connected(
        code.n, code.m,
        np.ascontiguousarray(vn_indptr), np.ascontiguousarray(vn_checks),
        np.ascontiguousarray(adj_indptr), np.ascontiguousarray(adj),
        np.ascontiguousarray(allowed), dv_eff,
        a_max, b_max, emit_min_a, emit_cap,
        out_sets, out_ab, n_emit, cls, acls, nodes)
    ne = int(n_emit[0])
    sets = [(int(out_ab[r, 0]), int(out_ab[r, 1]), bool(out_ab[r, 2]),
             tuple(int(v) for v in out_sets[r] if v >= 0))
            for r in range(ne)]
    cc = cls.reshape(a_max + 1, b_max + 1)
    # emission is capped; counts are not — truncated iff more sets
    # qualified (a >= emit_min_a, b <= b_max) than emit_cap holds
    qualifying = int(cc[emit_min_a:].sum())
    return EnumResult(
        a_max=a_max, b_max=b_max, dv_cap=dv_cap,
        class_counts=cc, absorb_counts=acls.reshape(a_max + 1, b_max + 1),
        sets=sets, nodes_visited=int(nodes[0]),
        n_allowed=int(allowed.sum()), hub_floor=hub_floor,
        emit_truncated=qualifying > ne)


def absorbing_spectrum_key(res: EnumResult) -> Tuple[int, ...]:
    """Lexicographic badness key over absorbing classes, smallest (a, b)
    first — compare codes by their SMALLEST absorbing sets before their
    counts at larger classes (small-a attractors dominate the floor).

    Validated on silicon (late round 4, reusing the tail A/B artifact
    results/designed_648.json): at the wifi-648 geometry the measured
    3.0 dB tail order standard (7.1e-6) < s7 (1.26e-5) < s1 (3.30e-5)
    is exactly the spectrum-key order — standard has NO absorbing set
    below a=6, s7 has 108 (5,3), s1 has 27 (5,2) + 108 (5,3). The greedy
    census had scored all three as 0-absorbing (the round-4 instrument
    gap this module closes)."""
    return tuple(int(res.absorb_counts[a, b])
                 for a in range(1, res.a_max + 1)
                 for b in range(res.b_max + 1))


def exact_absorbing_census(code: LDPCCode, a_max: int = 8, b_max: int = 3,
                           dv_cap: int = 3) -> Dict:
    """One-call exhaustive absorbing census for seed selection/reporting.
    Returns {"key": spectrum key, "total": count, "classes": {...},
    "a_max", "b_max", "dv_cap"}. dv_cap=3 is exact for small (a, b) on
    hub-profile codes (verified dv_cap=0 == dv_cap=3 on 802.11n n=648 at
    a <= 7) and orders of magnitude faster."""
    r = enumerate_sets(code, a_max=a_max, b_max=b_max, dv_cap=dv_cap,
                       emit_min_a=a_max + 1, emit_cap=1)
    s = r.summary()
    return {"key": absorbing_spectrum_key(r),
            "total": int(r.absorb_counts.sum()),
            "classes": s["absorbing"], "a_max": a_max, "b_max": b_max,
            "dv_cap": dv_cap}
