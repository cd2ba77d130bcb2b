"""AUTO two-phase early termination (counterpart of `ldpc_tpu/sim/tune.py`).

DecoderConfig.phase1_iters = -1 asks the sweep to choose (phase1_iters,
phase2_frac) per Eb/N0 point from a probe of the convergence CDF
(`Sweep._tuned_run_batch`). `pick_two_phase` is a copy of the reference's
cost model, constants included, and tests hold the two equal; the probe
runs the port's own chain. Two-phase decoding is exact (pipeline.
TwoPhaseDecoder), so the choice moves wall time, never counters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import SimConfig

from ..codes import CodeTensors
from .pipeline import make_lane_step

P1_CANDIDATES = (2, 3, 4, 5, 6, 8, 10, 12, 16)
CAP_QUANTUM = 1.0 / 16.0


def pick_two_phase(iters_sample, max_iter: int, tile_frac: float,
                   safety: float = 1.6, margin: float = 0.9,
                   ) -> Tuple[Optional[int], Optional[float]]:
    """Choose (phase1_iters, phase2_frac) from sampled per-lane
    first-convergence iteration counts (unconverged lanes report
    max_iter and count as unconverged at every t < max_iter).

    Cost model, in per-lane iterations:

        cost(t) = t + max_iter * cap(t)
        cap(t)  = min(0.5, max(safety * q(t) + 3 sigma_binomial, tile_frac))

    where q(t) is the sampled unconverged fraction after t iterations.
    Returns (None, None) unless the best candidate beats single-phase by
    the margin (cost < margin * max_iter)."""
    it = np.asarray(iters_sample)
    N = it.size
    assert N > 0
    best: Tuple[Optional[int], Optional[float]] = (None, None)
    best_cost = margin * float(max_iter)
    for t in P1_CANDIDATES:
        if t >= max_iter:
            break
        q = float(np.mean(it > t))
        slack = 3.0 * math.sqrt(max(q * (1.0 - q), 1.0 / N) / N)
        need = safety * q + slack
        if need > 0.5:
            # the overflow path would decode the full batch: decline t
            continue
        cap = math.ceil(need / CAP_QUANTUM) * CAP_QUANTUM
        cap = max(cap, tile_frac)
        cost = t + max_iter * cap
        if cost < best_cost:
            best, best_cost = (t, cap), cost
    return best


def make_iter_probe(ct: CodeTensors, cfg: SimConfig, batch: int = 2048,
                    backend: str = "auto"
                    ) -> Callable[[torch.Generator, float], torch.Tensor]:
    """probe(generator, sigma) -> per-lane first-convergence iteration
    counts (int32, (batch,), on ct's device) through the real chain (info
    bits, encode, modulate, AWGN, demap, quantize, single-phase early-
    terminating decode), with max_iter for lanes that did not converge, so
    the sampled CDF is what the sweep's batches see."""
    cfg1 = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, phase1_iters=None))
    step = make_lane_step(ct, cfg1, batch=batch, backend=backend)
    max_iter = cfg.decoder.max_iter

    def probe(generator: torch.Generator, sigma) -> torch.Tensor:
        _, _, iters, conv = step(generator, sigma)
        return torch.where(conv, iters, max_iter)

    return probe
