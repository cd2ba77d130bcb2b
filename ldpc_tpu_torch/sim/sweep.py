"""Monte-Carlo BER/FER sweep loop, the port's user entry point
(counterpart of `ldpc_tpu/sim/sweep.py`: `Sweep.run`, `Sweep.run_fused`,
`SweepResult`, `_config_compatible`).

For each Eb/N0 point, run batches until enough frame errors are collected
or the frame budget is spent. Batch i of point s is seeded from (cfg.run.
seed, s, i) (`batch_seed`): the host chain draws from a torch.Generator
with that seed, the Monte-Carlo megakernel keys its Philox stream with it.
A sweep is therefore reproducible (the megakernel's counters on any
device, the host chain's on one device type); the streams are not the
reference's, so port and reference agree statistically, not bitwise.
Results use the `results/*.json` schema, so port output diffs against the
reference's artifacts.

`run` keeps up to `lookahead` batches in flight and consumes them in
order, so counters and checkpoints stay sample-exact. `run_fused`
advances every point in each batch (lane b simulates slot b % P, P the
number of points; the fused batches are seeded (seed, 0, batch)), retires
a point's slots to the points still running once it reaches its target,
and keeps `lookahead` batches in flight. With `checkpoint_path` the state
is written after every consumed batch and a rerun resumes from it; the
run meta names the port's random streams, so a reference checkpoint is
refused (`checkpoint.py`).

With a mesh (`parallel.make_mesh`; the reference's `Sweep(mesh=)`,
sweep.py:188-221) every rank runs its lanes of each batch and reads the
global counters (`make_run_batch(mesh=)`), so every stopping decision is
the same on every rank and all ranks stop on the same batch; the AUTO
choice is made on rank 0 and broadcast; only rank 0 reads and writes the
checkpoint, and the other ranks take the state it read (their own paths,
which may differ or be absent, are never read). Counters do not depend on
the mesh, nor does the run meta, so a checkpoint written over a mesh
resumes on one device, and back, to the same final counters
(sweep.py:67-68).

With DecoderConfig.phase1_iters = -1 (AUTO two-phase early termination)
each point probes its convergence CDF once and runs with the (p1, cap)
that `tune.pick_two_phase` picks, or single-phase when two-phase is not
predicted to pay; counters do not depend on the choice. The megakernel
is kept as it is, as in the reference.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SimConfig

from . import checkpoint as ckpt
from ..codes import build_code, from_reference
from ..device import DeviceLike, resolve_device
from ..ops.channel import sigma_for
from ..parallel.mesh import is_rank0, on_rank0
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
    """64-bit seed of one batch, from (seed, point, batch)."""
    words = np.random.SeedSequence([seed, snr_idx, batch_idx]
                                   ).generate_state(2, np.uint32)
    return (int(words[0]) << 32) | int(words[1])


def _config_compatible(stored: dict, cfg: SimConfig) -> bool:
    """True when `stored` (the config dict a checkpoint was written with)
    describes the same simulation as `cfg` (the reference's rule,
    sweep.py:52-111): exact equality, except that a field missing from the
    stored dict is accepted at its dataclass default, and the stop rules,
    the mesh and the two-phase tuning are never compared."""
    IGNORE = {("run", "max_frames"), ("run", "target_frame_errors"),
              ("run", "mesh_shape"), ("run", "mesh_axes"),
              ("decoder", "phase1_iters"), ("decoder", "phase2_frac")}

    def jsonify(v):
        return json.loads(json.dumps(v, default=list))

    def walk(st: dict, obj, section: str = "") -> bool:
        if not isinstance(st, dict):  # corrupted/hand-edited section
            return False
        fields = {f.name: f for f in dataclasses.fields(obj)}
        if any(k not in fields for k in st):  # field removed since
            return False
        for name, f in fields.items():
            if (section, name) in IGNORE:
                continue
            cur = getattr(obj, name)
            if dataclasses.is_dataclass(cur):
                if not walk(st.get(name, {}), cur, section=name):
                    return False
                continue
            if name in st:
                if jsonify(st[name]) != jsonify(cur):
                    return False
            else:
                default = (f.default if f.default is not dataclasses.MISSING
                           else f.default_factory()
                           if f.default_factory is not dataclasses.MISSING
                           else dataclasses.MISSING)
                if (default is dataclasses.MISSING
                        or jsonify(cur) != jsonify(default)):
                    return False
        return True

    return walk(stored, cfg)


class Sweep:
    """Drives the BER/FER sweep for one SimConfig on one device, or on
this rank's device of a process mesh.

    device: "cuda" (the default: the CUDA kernels) or "cpu" (the plain
    torch versions); a CUDA request without a card raises. batch: codewords
    per batch (cfg.run.batch when None). checkpoint_path: JSON state
    written after every consumed batch; pass the same path again to
    resume. lookahead: batches kept in flight (at least 1).
    decoder_backend: "auto", or a route to force (`pipeline.resolve_route`;
    a route that cannot run raises). mesh: a `parallel.make_mesh` mesh
    over which each batch's lanes are split (every rank constructs the
    Sweep with the same arguments and runs the same calls). After a run
    with AUTO two-phase, `auto_choice[snr_idx]` holds the (phase1_iters,
    phase2_frac) chosen for that point, (None, None) where single-phase
    was kept."""

    def __init__(self, cfg: SimConfig, device: DeviceLike = "cuda",
                 batch: Optional[int] = None,
                 checkpoint_path: Optional[str] = None, lookahead: int = 4,
                 decoder_backend: str = "auto", mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.decoder_backend = decoder_backend
        self.device = resolve_device(device)
        self.code = build_code(cfg)
        self.ct = from_reference(self.code, self.device)
        self.batch = batch or cfg.run.batch
        self.checkpoint_path = checkpoint_path
        self.lookahead = max(1, lookahead)
        self.run_batch = make_run_batch(self.ct, cfg, batch=self.batch,
                                        backend=decoder_backend, mesh=mesh)
        self.backend = self.run_batch.backend_label
        self._fused_rb: Dict[int, Callable] = {}
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

    def draw(self, snr_idx: int, batch_idx: int):
        """The random source of one batch, as the step takes it: the
        megakernel's int batch seed, or the host chain's generator."""
        if self.run_batch.mc:
            return batch_seed(self.cfg.run.seed, snr_idx, batch_idx)
        return self.generator(snr_idx, batch_idx)

    @property
    def rng_stream(self) -> str:
        """The random family of this sweep's batches, part of the run
        meta: the megakernel's Philox stream is the same on every device,
        torch.Generator streams differ between device types."""
        if self.run_batch.mc:
            return "ldpc_tpu_torch:philox4x32-10"
        return f"ldpc_tpu_torch:torch.Generator({self.device.type})"

    def tuned_run_batch(self, snr_idx: int, sigma) -> Callable:
        """AUTO two-phase (phase1_iters == -1; the reference's
        `Sweep._tuned_run_batch`): probe this point's convergence CDF once
        on min(batch, 2048) codewords drawn from a generator of its own
        (batch index 2**31 - 2, which no batch uses), pick (p1, cap) with
        tune.pick_two_phase, and return a cached run_batch built with it,
        or the single-phase base when two-phase is not predicted to pay.
        The capacity granularity is the kernel's codeword lanes per block
        (1 for the plain version). The megakernel's base build is returned
        as it is: a two-phase build would leave it for the host chain and
        change the random stream mid-sweep. Over a mesh rank 0 probes and
        picks, every rank takes its choice; the capacity is a share of a
        rank's batch."""
        from .tune import make_iter_probe, pick_two_phase
        if self.run_batch.mc:
            return self.run_batch

        def probe_and_pick():
            if self._probe is None:
                self._probe = make_iter_probe(self.ct, self.cfg,
                                              min(self.batch, 2048),
                                              backend=self.decoder_backend)
            it = self._probe(self.generator(snr_idx, 2 ** 31 - 2), sigma)
            it = it.cpu().numpy()
            g = self.run_batch.decoder.batch_tile
            choice = pick_two_phase(
                it, self.cfg.decoder.max_iter,
                tile_frac=min(1.0, g / self.run_batch.local_batch))
            log.info("auto two-phase @snr[%d]: unconv@%s -> p1=%s cap=%s",
                     snr_idx, {t: round(float(np.mean(it > t)), 3)
                               for t in (2, 4, 6, 8)}, *choice)
            return choice

        p1, frac = on_rank0(probe_and_pick, self.mesh)
        self.auto_choice[snr_idx] = (p1, frac)
        if p1 is None:
            return self.run_batch
        key = (p1, round(frac, 4))
        if key not in self._tuned_rb:
            cfgv = dataclasses.replace(
                self.cfg, decoder=dataclasses.replace(
                    self.cfg.decoder, phase1_iters=p1, phase2_frac=frac))
            self._tuned_rb[key] = make_run_batch(
                self.ct, cfgv, batch=self.batch,
                backend=self.decoder_backend, mesh=self.mesh)
        return self._tuned_rb[key]

    def _meta(self, key: str, ebn0_list: Sequence[float]) -> Dict:
        return {"batch": self.batch, "superbatches": 1,
                "seed": self.cfg.run.seed, "code_name": self.code.name,
                key: [float(e) for e in ebn0_list],
                "rng_stream": self.rng_stream}

    def _resume(self, meta: Dict, points: List[SnrPoint]):
        """Checkpoint load and validation for run()/run_fused() (the
        reference's `Sweep._resume`): refuses to merge counters unless the
        run meta (batch, seed, code, point list, random streams) and the
        SimConfig match what the checkpoint was written with. Over a mesh
        rank 0 loads and checks, and every rank takes its state or its
        refusal. Returns (points with their saved counters, raw state or
        None)."""
        state = on_rank0(lambda: self._load_checkpoint(meta), self.mesh)
        if state is None:
            return points, None
        saved = {p.ebn0_db: p for p in state["points"]}
        return [saved.get(p.ebn0_db, p) for p in points], state

    def _load_checkpoint(self, meta: Dict) -> Optional[Dict]:
        state = ckpt.load(self.checkpoint_path)
        if state is None:
            return None
        core = {k: v for k, v in state.get("meta", {}).items()
                if k != "fused_batch_idx"}
        if core != meta:
            raise ValueError(
                f"checkpoint {self.checkpoint_path} was written with "
                f"{core}, resume requires the same batch/seed/code/point "
                f"list and random streams (got {meta}) for sample-exact "
                f"continuation")
        if not _config_compatible(state.get("config"), self.cfg):
            raise ValueError(
                f"checkpoint {self.checkpoint_path} was written for a "
                f"different SimConfig; resuming would merge counters from "
                f"a different simulation. Stored: {state.get('config')}")
        return state

    def _save(self, points: List[SnrPoint], meta: Dict) -> None:
        if self.checkpoint_path and is_rank0(self.mesh):
            ckpt.save(self.checkpoint_path, self.cfg.to_json(), points,
                      meta=meta)

    def _result(self, points: List[SnrPoint]) -> SweepResult:
        return SweepResult(config=self.cfg, code_name=self.code.name,
                           k=self.code.k_eff, n=self.code.n, points=points,
                           decoder_backend=self.backend)

    def _sigma(self, ebn0_db: float) -> np.float32:
        return np.float32(sigma_for(ebn0_db, self.code.rate,
                                    self.cfg.channel.modulation))

    def run(self, ebn0_list: Sequence[float],
            target_frame_errors: Optional[int] = None,
            max_frames: Optional[int] = None) -> SweepResult:
        rc = self.cfg.run
        target_fe = (rc.target_frame_errors if target_frame_errors is None
                     else target_frame_errors)
        max_fr = rc.max_frames if max_frames is None else max_frames
        points = [SnrPoint(ebn0_db=float(e)) for e in ebn0_list]
        # The point list (values and order) is part of the stream
        # contract: batch seeds use the positional point index.
        meta = self._meta("points", ebn0_list)
        if self.checkpoint_path:
            points, state = self._resume(meta, points)
            if state is not None:
                log.info("resumed checkpoint %s", self.checkpoint_path)
        result = self._result(points)
        for si, pt in enumerate(points):
            sigma = self._sigma(pt.ebn0_db)
            run_batch = (self.tuned_run_batch(si, sigma)
                         if self._auto_phase else self.run_batch)
            # Up to `lookahead` batches in flight (CUDA launches return at
            # once; only the host read of the counters waits). Batches are
            # consumed in seed order, so counters and checkpoints stay
            # sample-exact; batches issued past the stop are consumed too.
            inflight: deque = deque()
            issued, frames_issued = pt.batches, pt.frames

            def need_more() -> bool:
                return pt.frame_errs < target_fe and pt.frames < max_fr

            t_last = time.perf_counter()
            while need_more() or inflight:
                while (need_more() and len(inflight) < self.lookahead
                       and frames_issued < max_fr):
                    inflight.append(run_batch(self.draw(si, issued), sigma))
                    issued += 1
                    frames_issued += self.batch
                out = inflight.popleft().tolist()  # waits for the device
                now = time.perf_counter()
                pt.wall_s += now - t_last
                t_last = now
                frames, bit_e, frame_e, it_s, conv = out
                pt.frames += frames
                pt.bit_errs += bit_e
                pt.frame_errs += frame_e
                pt.iter_sum += it_s
                pt.converged += conv
                pt.batches += 1
                self._save(points, meta)
            log.info("EbN0=%.2f dB: frames=%d BER=%.3e FER=%.3e avg_it=%.2f",
                     pt.ebn0_db, pt.frames,
                     pt.bit_errs / max(pt.frames * self.code.k_eff, 1),
                     pt.fer, pt.avg_iters)
        return result

    def fused_run_batch(self, n_points: int) -> Callable:
        """The step of a fused sweep over n_points (cached): lane b
        simulates slot b % n_points, counters come back (5, n_points)."""
        if n_points not in self._fused_rb:
            self._fused_rb[n_points] = make_run_batch(
                self.ct, self.cfg, batch=self.batch, n_points=n_points,
                backend=self.decoder_backend, mesh=self.mesh)
        return self._fused_rb[n_points]

    def run_fused(self, ebn0_list: Sequence[float],
                  target_frame_errors: Optional[int] = None,
                  max_frames: Optional[int] = None) -> SweepResult:
        """Fused-SNR sweep (the reference's `Sweep.run_fused`): every
        batch advances all P points, its lanes striped over P sigma slots.
        Once a point reaches its frame-error target (or frame budget, with
        the frames in flight counted), its slots go to the points still
        running: slot s of a batch simulates active point act[s % len(act)],
        and the counters are attributed by the slot map recorded at
        dispatch. Batch i is seeded (seed, 0, i); resume recomputes the
        slot assignment from the saved counters and continues at the first
        batch not consumed."""
        rc = self.cfg.run
        target_fe = (rc.target_frame_errors if target_frame_errors is None
                     else target_frame_errors)
        max_fr = rc.max_frames if max_frames is None else max_frames
        P = len(ebn0_list)
        rb = self.fused_run_batch(P)
        base_sigmas = np.asarray([self._sigma(e) for e in ebn0_list],
                                 np.float32)
        points = [SnrPoint(ebn0_db=float(e)) for e in ebn0_list]
        meta = self._meta("fused_points", ebn0_list)
        batch_idx = 0
        if self.checkpoint_path:
            points, state = self._resume(meta, points)
            if state is not None:
                batch_idx = int(state["meta"].get("fused_batch_idx", 0))
                log.info("resumed fused checkpoint %s at batch %d",
                         self.checkpoint_path, batch_idx)
        result = self._result(points)
        frames_per_slot = self.batch // P
        pending = [0] * P  # frames issued but not yet consumed, per point
        inflight: deque = deque()

        def active_points() -> List[int]:
            return [i for i, p in enumerate(points)
                    if p.frame_errs < target_fe
                    and p.frames + pending[i] < max_fr]

        t_last = time.perf_counter()
        while active_points() or inflight:
            while len(inflight) < self.lookahead:
                act = active_points()
                if not act:
                    break
                slot_map = [act[s % len(act)] for s in range(P)]
                fut = rb(self.draw(0, batch_idx), base_sigmas[slot_map])
                for i in slot_map:
                    pending[i] += frames_per_slot
                inflight.append((slot_map, fut))
                batch_idx += 1
            slot_map, fut = inflight.popleft()
            frames, bit_e, frame_e, it_s, conv = fut.tolist()
            now = time.perf_counter()
            wall = now - t_last
            t_last = now
            for s, i in enumerate(slot_map):
                p = points[i]
                pending[i] -= frames_per_slot
                p.frames += frames[s]
                p.bit_errs += bit_e[s]
                p.frame_errs += frame_e[s]
                p.iter_sum += it_s[s]
                p.converged += conv[s]
            touched = sorted(set(slot_map))
            for i in touched:
                points[i].wall_s += wall / len(touched)
                points[i].batches += 1
            # batch_idx counts dispatched batches; persist the consumed
            # horizon, so a resume runs the in-flight batches again
            self._save(points, {**meta,
                                "fused_batch_idx": batch_idx - len(inflight)})
        return result
