"""Orbit representatives for the symmetric error-floor estimator
(`impsamp.make_symmetric_run`), built as the reference's result scripts
build them, with the port's own census and rotation: the absorbing-orbit
cover of an exhaustive census (`scripts/make_wifi_floor_sym.py:33-45`, the
proposal of `results/wifi_floor_sym.json`) and the canonicalized
info-failure supports of a plain Monte-Carlo probe plus census orbits
(`scripts/make_dvb_floor_r5.py:57-100`, the proposal of
`results/dvb_floor_r5.json`). Host only: numpy and the census's C
enumerator (`analysis/asenum.py`)."""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

from ..analysis import asenum
from ..utils.native import omp_threads
from .impsamp import canonical_rotation


def absorbing_orbit_cover(code, a_max: int = 8) -> List[Tuple[int, ...]]:
    """The canonical rotations of the absorbing sets that the script's
    census (b <= 3, variables of degree <= 3, sets of 5 or more listed, at
    most 16,384 of them) emits, sorted. The census runs on one thread: its
    counts are exact, but where more sets qualify than it lists, which it
    keeps follows its threads' interleaving. The thread count is the
    process's again after the call."""
    with omp_threads(asenum._lib(), 1):
        r = asenum.enumerate_sets(code, a_max=a_max, b_max=3, dv_cap=3,
                                  emit_min_a=5, emit_cap=16384)
    return sorted({canonical_rotation(code, S)
                   for (_, _, absorbing, S) in r.sets if absorbing})


def harvested_orbit_reps(code, mc_points: Iterable[dict],
                         extra_sets: Sequence[Sequence[int]] = (),
                         max_size: int = 48) -> List[Tuple[int, ...]]:
    """Distinct canonical rotations, in the order first met, of the failure
    supports of a Monte-Carlo probe that hit an information bit and hold 1
    to `max_size` positions (`mc_points`: the `points` of a
    `results/dvb_mc_deep.json`-style file, each with its `supports`, dicts
    of `size`, `n_info` and `support`), then of `extra_sets`."""
    reps: List[Tuple[int, ...]] = []
    seen = set()

    def add(support):
        c = canonical_rotation(code, support)
        if c not in seen:
            seen.add(c)
            reps.append(c)
    for pt in mc_points:
        for s in pt["supports"]:
            if s["n_info"] > 0 and 1 <= s["size"] <= max_size:
                add(s["support"])
    for S in extra_sets:
        add(S)
    return reps
