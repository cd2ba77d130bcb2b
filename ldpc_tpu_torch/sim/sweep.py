"""Monte-Carlo BER/FER sweep loop, the port's user entry point
(counterpart of `ldpc_tpu/sim/sweep.py`: `Sweep.run`, `SweepResult`).

For each Eb/N0 point, run batches until enough frame errors are collected
or the frame budget is spent. Batch i of point s draws from a
torch.Generator seeded from (cfg.run.seed, s, i), so a sweep is
reproducible on one device; the streams are torch's, not the reference's
threefry, so port and reference agree statistically, not bitwise.
Results use the `results/*.json` schema, so port output diffs against
the reference's artifacts.

Not ported yet: checkpoint/resume, fused multi-SNR sweeps, the two-phase
auto-tuner (ROADMAP module items 8 and 10).
"""
from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

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

    device: "cuda" (the default: the CUDA kernel) or "cpu" (the plain
    torch decoder); a CUDA request without a card raises. batch: codewords
    per batch (cfg.run.batch when None)."""

    def __init__(self, cfg: SimConfig, device: DeviceLike = "cuda",
                 batch: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.code = build_code(cfg)
        self.ct = from_reference(self.code, self.device)
        self.batch = batch or cfg.run.batch
        self.run_batch = make_run_batch(self.ct, cfg, batch=self.batch)
        self.backend = self.run_batch.backend_label

    def generator(self, snr_idx: int, batch_idx: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(batch_seed(self.cfg.run.seed, snr_idx, batch_idx))
        return g

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
            t_last = time.perf_counter()
            while pt.frame_errs < target_fe and pt.frames < max_fr:
                out = self.run_batch(self.generator(si, pt.batches), sigma)
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
