"""Whether the timed path's answers are right: a sample of the window's
batches, drawn from the seed, each against the plain reference.

An answer is a batch's five counters (frames, information-bit errors, frame
errors, iteration sum, converged). `counter_gap` is the widest gap over the
sampled batches and the five counters, |program - reference| over
max(|reference|, 1). The reference is bit-exact to the fixed-point
semantics, so a sound run reads 0; the limit of each cell is in its traffic
file (`limits`), set from the sound runs' and the control's readings
(`control.py`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

SAMPLE_STREAM = 0x6770  # keeps the sample's draws apart from the batches'


def sample(seed: int, n_batches: int, count: int) -> List[int]:
    """The last batch of the window and `count` others drawn from the seed
    (fewer where the window holds fewer)."""
    if n_batches < 1:
        return []
    rng = np.random.default_rng([int(seed), SAMPLE_STREAM])
    rest = rng.choice(n_batches - 1, size=min(count, n_batches - 1),
                      replace=False) if n_batches > 1 else []
    return sorted({int(i) for i in rest} | {n_batches - 1})


def counter_gap(program: Sequence[int], reference: Sequence[int]) -> float:
    return max(abs(int(p) - int(r)) / max(abs(int(r)), 1)
               for p, r in zip(program, reference))


def judge(program: Dict[int, List[int]], reference: Dict[int, List[int]],
          limits: Dict[str, float]) -> Dict[str, dict]:
    """{number: {"value", "limit"}} over the sampled batches."""
    gap = max((counter_gap(program[i], reference[i]) for i in reference),
              default=None)
    return {"counter_gap": {"value": gap, "limit": limits["counter_gap"]}}


def passed(checks: Dict[str, dict]) -> bool:
    """Every number within its limit; a number not read (None) fails."""
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
