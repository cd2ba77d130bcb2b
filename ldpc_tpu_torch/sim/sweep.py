"""Monte-Carlo BER/FER sweep loop, the port's user entry point
(counterpart of `ldpc_tpu/sim/sweep.py`: `Sweep.run`, `SweepResult`).

For each Eb/N0 point, run batches until enough frame errors are collected
or the frame budget is spent. Batch i of point s draws from a
torch.Generator seeded from (cfg.run.seed, s, i), so a sweep is
reproducible on one device; the streams are torch's, not the reference's
threefry, so port and reference agree statistically, not bitwise.
Results use the `results/*.json` schema, so port output diffs against
the reference's artifacts.

With DecoderConfig.phase1_iters = -1 (AUTO two-phase early termination)
each point probes its convergence CDF once and runs with the (p1, cap)
that `tune.pick_two_phase` picks, or single-phase when two-phase is not
predicted to pay; counters do not depend on the choice.

Not ported yet: checkpoint/resume and fused multi-SNR sweeps (ROADMAP
module item 8).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ldpc_tpu.config import SimConfig

from ..codes import build_code, from_reference
from ..device import DeviceLike, resolve_device
from ..ops.channel import sigma_for
from .pipeline import make_run_batch
from .stats import SnrPoint

log = logging.getLogger("ldpc_tpu_torch.sweep")


@dataclass
class SweepResult:
    config: SimConfig
    code_name: str
    k: int
    n: int
    points: List[SnrPoint] = field(default_factory=list)
    decoder_backend: str = ""

    def rows(self) -> List[Dict]:
        return [p.row(self.k, self.n) for p in self.points]

    def to_json(self) -> str:
        return json.dumps({
            "config": json.loads(self.config.to_json()),
            "code": self.code_name, "k": self.k, "n": self.n,
            "decoder_backend": self.decoder_backend,
            "results": self.rows(),
        }, indent=1)


def batch_seed(seed: int, snr_idx: int, batch_idx: int) -> int:
    """64-bit generator seed for one batch, from (seed, point, batch)."""
    words = np.random.SeedSequence([seed, snr_idx, batch_idx]
                                   ).generate_state(2, np.uint32)
    return (int(words[0]) << 32) | int(words[1])


class Sweep:
    """Drives the BER/FER sweep for one SimConfig on one device.

    device: "cuda" (the default: the CUDA kernels) or "cpu" (the plain
    torch decoders); a CUDA request without a card raises. batch: codewords
    per batch (cfg.run.batch when None). After a run with AUTO two-phase,
    `auto_choice[snr_idx]` holds the (phase1_iters, phase2_frac) chosen
    for that point, (None, None) where single-phase was kept."""

    def __init__(self, cfg: SimConfig, device: DeviceLike = "cuda",
                 batch: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.code = build_code(cfg)
        self.ct = from_reference(self.code, self.device)
        self.batch = batch or cfg.run.batch
        self.run_batch = make_run_batch(self.ct, cfg, batch=self.batch)
        self.backend = self.run_batch.backend_label
        # phase1_iters == -1: AUTO two-phase early termination. The base
        # run_batch is single-phase; run() probes each point and swaps in
        # a tuned build, cached by (p1, cap), when it is predicted to pay.
        self._auto_phase = (cfg.decoder.phase1_iters == -1
                            and cfg.decoder.early_term)
        self._tuned_rb: Dict[Tuple[int, float], Callable] = {}
        self._probe = None
        self.auto_choice: Dict[int, Tuple[Optional[int],
                                          Optional[float]]] = {}

    def generator(self, snr_idx: int, batch_idx: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(batch_seed(self.cfg.run.seed, snr_idx, batch_idx))
        return g

    def tuned_run_batch(self, snr_idx: int, sigma) -> Callable:
        """AUTO two-phase (phase1_iters == -1; the reference's
        `Sweep._tuned_run_batch`): probe this point's convergence CDF once
        on min(batch, 2048) codewords drawn from a generator of its own
        (batch index 2**31 - 2, which no batch uses), pick (p1, cap) with
        tune.pick_two_phase, and return a cached run_batch built with it,
        or the single-phase base when two-phase is not predicted to pay.
        The capacity granularity is the kernel's codeword lanes per block
        (1 for the plain version)."""
        from .tune import make_iter_probe, pick_two_phase
        if self._probe is None:
            self._probe = make_iter_probe(self.ct, self.cfg,
                                          min(self.batch, 2048))
        it = self._probe(self.generator(snr_idx, 2 ** 31 - 2), sigma)
        it = it.cpu().numpy()
        g = self.run_batch.decoder.batch_tile
        p1, frac = pick_two_phase(it, self.cfg.decoder.max_iter,
                                  tile_frac=min(1.0, g / self.batch))
        self.auto_choice[snr_idx] = (p1, frac)
        log.info("auto two-phase @snr[%d]: unconv@%s -> p1=%s cap=%s",
                 snr_idx, {t: round(float(np.mean(it > t)), 3)
                           for t in (2, 4, 6, 8)}, p1, frac)
        if p1 is None:
            return self.run_batch
        key = (p1, round(frac, 4))
        if key not in self._tuned_rb:
            cfgv = dataclasses.replace(
                self.cfg, decoder=dataclasses.replace(
                    self.cfg.decoder, phase1_iters=p1, phase2_frac=frac))
            self._tuned_rb[key] = make_run_batch(self.ct, cfgv,
                                                 batch=self.batch)
        return self._tuned_rb[key]

    def run(self, ebn0_list: Sequence[float],
            target_frame_errors: Optional[int] = None,
            max_frames: Optional[int] = None) -> SweepResult:
        rc = self.cfg.run
        target_fe = (rc.target_frame_errors if target_frame_errors is None
                     else target_frame_errors)
        max_fr = rc.max_frames if max_frames is None else max_frames
        points = [SnrPoint(ebn0_db=float(e)) for e in ebn0_list]
        result = SweepResult(config=self.cfg, code_name=self.code.name,
                             k=self.code.k_eff, n=self.code.n,
                             points=points, decoder_backend=self.backend)
        for si, pt in enumerate(points):
            sigma = np.float32(sigma_for(pt.ebn0_db, self.code.rate,
                                         self.cfg.channel.modulation))
            run_batch = (self.tuned_run_batch(si, sigma)
                         if self._auto_phase else self.run_batch)
            t_last = time.perf_counter()
            while pt.frame_errs < target_fe and pt.frames < max_fr:
                out = run_batch(self.generator(si, pt.batches), sigma)
                frames, bit_e, frame_e, it_s, conv = out.tolist()  # syncs
                now = time.perf_counter()
                pt.wall_s += now - t_last
                t_last = now
                pt.frames += frames
                pt.bit_errs += bit_e
                pt.frame_errs += frame_e
                pt.iter_sum += it_s
                pt.converged += conv
                pt.batches += 1
            log.info("EbN0=%.2f dB: frames=%d BER=%.3e FER=%.3e avg_it=%.2f",
                     pt.ebn0_db, pt.frames,
                     pt.bit_errs / max(pt.frames * self.code.k_eff, 1),
                     pt.fer, pt.avg_iters)
        return result
