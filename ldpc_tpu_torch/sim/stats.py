"""BER/FER statistics (a copy of `ldpc_tpu/sim/stats.py`): SnrPoint
counters, Wilson intervals, rates_compatible. Tests hold the copy equal to
the original. The port adds `mean_compatible`.

The reference prints per-SNR BER/FER rows computed from accumulated counters;
this module owns the counter -> rate conversion plus binomial confidence
intervals (used by the integration tests to compare decoder implementations
within Monte-Carlo error, SURVEY.md §4.2 'Integration: BER')."""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional


@dataclass
class SnrPoint:
    """Accumulated counters for one Eb/N0 point."""
    ebn0_db: float
    frames: int = 0
    bit_errs: int = 0          # info-bit errors
    frame_errs: int = 0
    iter_sum: int = 0
    converged: int = 0
    batches: int = 0           # superbatches consumed (drives RNG folding)
    wall_s: float = 0.0

    @property
    def fer(self) -> float:
        return self.frame_errs / max(self.frames, 1)

    @property
    def avg_iters(self) -> float:
        return self.iter_sum / max(self.frames, 1)

    @property
    def early_term_rate(self) -> float:
        return self.converged / max(self.frames, 1)

    def row(self, k: int, n: int) -> Dict:
        info_bits = self.frames * k
        ber_lo, ber_hi = wilson_interval(self.bit_errs, max(info_bits, 1))
        fer_lo, fer_hi = wilson_interval(self.frame_errs,
                                         max(self.frames, 1))
        return {
            "ebn0_db": self.ebn0_db,
            "frames": self.frames,
            "bit_errs": self.bit_errs,
            "frame_errs": self.frame_errs,
            "ber": self.bit_errs / max(info_bits, 1),
            "ber_lo": ber_lo,  # 99% Wilson interval (SURVEY.md §5.5)
            "ber_hi": ber_hi,
            "fer": self.fer,
            "fer_lo": fer_lo,
            "fer_hi": fer_hi,
            "avg_iters": self.avg_iters,
            "early_term_rate": self.early_term_rate,
            "wall_s": self.wall_s,
            "info_bps": info_bits / self.wall_s if self.wall_s > 0 else 0.0,
        }


def wilson_interval(errs: int, trials: int, z: float = 2.576):
    """Wilson score interval for a binomial rate (z=2.576 -> 99%)."""
    if trials == 0:
        return 0.0, 1.0
    p = errs / trials
    den = 1 + z * z / trials
    center = (p + z * z / (2 * trials)) / den
    half = z * math.sqrt(p * (1 - p) / trials + z * z / (4 * trials ** 2)) / den
    return max(0.0, center - half), min(1.0, center + half)


def rates_compatible(errs_a: int, trials_a: int, errs_b: int, trials_b: int,
                     z: float = 2.576) -> bool:
    """True when two binomial observations have overlapping Wilson intervals —
    the decoder-equivalence oracle used by the BER integration tests."""
    lo_a, hi_a = wilson_interval(errs_a, trials_a, z)
    lo_b, hi_b = wilson_interval(errs_b, trials_b, z)
    return lo_a <= hi_b and lo_b <= hi_a


def mean_compatible(sum_a: float, n_a: int, sum_b: float, n_b: int,
                    var: float, z: float = 2.576) -> bool:
    """Two-sample z-test on per-frame means with a shared per-frame
    variance `var`: True when |sum_a/n_a - sum_b/n_b| <= z * sqrt(var/n_a
    + var/n_b).

    This is the comparison for BER: frames are independent, but the bit
    errors inside a failed frame come in bursts, so a Wilson interval over
    bits (rates_compatible) is too narrow by about the square root of the
    errors per failed frame. Pass bit-error totals, frame counts and the
    sample variance of bit errors per frame."""
    if n_a <= 0 or n_b <= 0:
        return False
    half = z * math.sqrt(var / n_a + var / n_b)
    return abs(sum_a / n_a - sum_b / n_b) <= half


def snr_at_ber(rows, target_ber: float, k: int = None):
    """Eb/N0 (dB) at which a measured waterfall crosses `target_ber`,
    log-linearly interpolated between the bracketing sweep points.

    rows: iterables with 'ebn0_db' and 'ber' keys (the results schema).
    Returns None if the curve never crosses the target. This is the
    BASELINE.md row-3 methodology: the fixed-point quantization bound is
    snr_at_ber(fixed) - snr_at_ber(float) at the same target BER.

    Zero-error points are kept (a clean curve falling to zero measured
    errors still brackets the crossing): with `k` (info bits/frame) they
    are clamped to the half-error upper bound 0.5/(frames*k) — which only
    brackets the target when enough frames were run to resolve it — and
    without `k` to one decade below the target.
    """
    pts = []
    for r in rows:
        b = float(r["ber"])
        if b <= 0:
            if k and float(r.get("frames", 0)) > 0:
                b = 0.5 / (float(r["frames"]) * k)
            else:
                b = target_ber / 10.0
        pts.append((float(r["ebn0_db"]), b))
    pts.sort(key=lambda t: t[0])
    for (x0, b0), (x1, b1) in zip(pts, pts[1:]):
        if (b0 - target_ber) * (b1 - target_ber) <= 0 and b0 != b1:
            l0, l1, lt = math.log10(b0), math.log10(b1), math.log10(target_ber)
            return x0 + (x1 - x0) * (lt - l0) / (l1 - l0)
    return None
