"""The simulation step (counterpart of `ldpc_tpu/sim/pipeline.py`:
`make_run_batch`, `BatchCounters`, `select_decoder`,
`make_two_phase_decoder_t`).

Ported scope: the transposed step of `make_run_batch` for one Eb/N0 point
or for n_points striped over the batch (the fused multi-SNR sweep: lane b
simulates point b % n_points with its own sigma), no mesh, no
superbatching; any modulation of `ops.channel.MODULATIONS`; flooding or
layered decoding with the min-sum family or min*, fixed iterations or early
termination, and two-phase early termination. A call runs, batch last,
one of two chains:

  * host RNG (pipeline.py:600-644): info bits (k, B) -> encode -> modulate
    -> AWGN -> max-log demap -> decoder (quantizes in the kernel, and counts info-bit
    errors there when the info bits are the codeword's prefix), with the
    draws from a torch.Generator on the code's device;
  * device RNG, the Monte-Carlo megakernel (pipeline.py:520-599): one
    launch of `kernels.minsum.McDecoder` draws the words from Philox keyed
    by the 64-bit batch seed, encodes, adds the noise, quantizes, decodes
    and counts. Taken where the reference takes
    it (`use_mc`); elsewhere rng="device" runs the host chain, as in the
    reference, and `run_batch.mc` says which ran.

Either way the step returns the (5,) counter stack, or (5, n_points).
Configurations outside that scope raise NotImplementedError naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..config import SimConfig

from ..codes import CodeTensors
from ..kernels import minsum
from ..ops import channel as ch
from ..ops.encode import DENSE_MAX_N, has_qc_struct, make_encoder_t
from ..ops.mc import gain_for

MIN_SUM_FAMILY = ("min-sum", "offset-min-sum", "normalized-min-sum")
FIXED_POINT = MIN_SUM_FAMILY + ("min-star",)


@dataclass(frozen=True)
class BatchCounters:
    """Scalar results of one batch."""
    frames: int
    bit_errs: int        # info-bit errors
    frame_errs: int
    iter_sum: int
    converged: int

    def __add__(self, o: "BatchCounters") -> "BatchCounters":
        return BatchCounters(
            self.frames + o.frames, self.bit_errs + o.bit_errs,
            self.frame_errs + o.frame_errs, self.iter_sum + o.iter_sum,
            self.converged + o.converged)

    @staticmethod
    def zero() -> "BatchCounters":
        return BatchCounters(0, 0, 0, 0, 0)


def check_in_slice(ct: CodeTensors, cfg: SimConfig) -> None:
    """Raise NotImplementedError for configurations the port cannot run."""
    def no(what: str, item: str):
        raise NotImplementedError(f"{what} is not ported yet ({item})")

    dec = cfg.decoder
    if dec.algorithm not in FIXED_POINT:
        no(f"decoder algorithm {dec.algorithm!r}",
           "the float decoders run through the batch-first step, ROADMAP "
           "module item 13")
    mod = cfg.channel.modulation
    if mod not in ch.MODULATIONS:
        raise ValueError(f"unknown modulation {mod!r}")
    if ct.n % ch.BITS_PER_SYM[mod]:
        # the reference's refusal (pipeline.py:475-480)
        raise ValueError(
            f"{ct.code.name}: n={ct.n} is not a multiple of {mod}'s "
            f"{ch.BITS_PER_SYM[mod]} bits per symbol")
    code = ct.code
    if len(code.punct_vns) or len(code.shortened_vns):
        no("rate matching (puncturing/shortening)", "ROADMAP module item 13")
    if cfg.run.all_zeros:
        no("the all-zeros codeword shortcut",
           "it lives in the batch-first step of sim/pipeline.make_run_batch")
    if cfg.run.rng not in ("host", "device"):
        raise ValueError(f"rng={cfg.run.rng!r}: expected 'host' or 'device'")


def explicit_two_phase(cfg: SimConfig) -> bool:
    dc = cfg.decoder
    return bool(dc.phase1_iters and dc.phase1_iters > 0 and dc.early_term
                and dc.phase1_iters < dc.max_iter)


def use_mc(ct: CodeTensors, cfg: SimConfig) -> bool:
    """The reference's rule for the megakernel (pipeline.py:396-445): BPSK,
    rng == "device", no explicit two-phase (AUTO is fine: the sweep keeps
    the megakernel), the transposed path (n <= 4096), info bits the
    identity prefix, and the encodable QC parity structure."""
    return (cfg.channel.modulation == "bpsk" and cfg.run.rng == "device"
            and not explicit_two_phase(cfg) and ct.n <= DENSE_MAX_N
            and ct.ident_info and has_qc_struct(ct.code))


class TwoPhaseDecoder:
    """Two-phase early termination for the batch-last decoders
    (`make_two_phase_decoder_t`, pipeline.py:222-266, counting form
    included).

      phase 1: dec_p1 (early termination, p1 iterations) on the full batch;
      repack:  the unconverged lanes are gathered on the trailing axis into
               `capacity` lanes (float LLRs and info rows; the unused lanes
               read a zero padding lane appended to the batch);
      phase 2: dec_full (early termination, max_iter) on the repacked
               lanes, restarting from the channel LLRs, and its results are
               scattered back (the padding lane's writes are sliced off);
      overflow: more than `capacity` unconverged lanes decode the whole
               batch with dec_full.

    Exact: integer min-sum is deterministic, so the restart replays each
    lane's trajectory, and per-lane results equal the single-phase run.
    The unconverged count is read on the host (one .item() sync per call)
    to choose between repack and overflow."""

    def __init__(self, dec_p1: minsum.MinsumDecoder,
                 dec_full: minsum.MinsumDecoder, capacity: int):
        self.dec_p1, self.dec_full = dec_p1, dec_full
        self.capacity = capacity
        self.counting = dec_full.counting
        self.batch_tile = dec_full.batch_tile

    def __call__(self, chan: torch.Tensor,
                 info: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        args = (chan,) if info is None else (chan, info)
        out1 = self.dec_p1(*args)
        uncv = ~out1[-1]
        n_uncv = int(uncv.sum().item())
        if n_uncv > self.capacity:
            return self.dec_full(*args)
        B = chan.shape[-1]
        idx = torch.full((self.capacity,), B, dtype=torch.int64,
                         device=chan.device)
        idx[:n_uncv] = torch.nonzero(uncv).flatten()

        def pad_last(x):
            return torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)

        out2 = self.dec_full(*(pad_last(a)[..., idx].contiguous()
                               for a in args))
        merged = []
        for a, b in zip(out1, out2):
            ap = pad_last(a)
            ap[..., idx] = b
            merged.append(ap[..., :B])
        return tuple(merged)


Decoder = Union[minsum.MinsumDecoder, minsum.McDecoder, TwoPhaseDecoder]


def select_decoder(ct: CodeTensors, cfg: SimConfig,
                   batch: Optional[int] = None,
                   n_points: int = 1) -> Tuple[Decoder, str]:
    """The fused-IO min-sum decoder for the step: float32 LLRs in, the
    quantizer in the kernel; error counting in the kernel too when the info
    bits are the identity prefix (ct.ident_info), hard bits out otherwise.
    Where `use_mc` holds, the Monte-Carlo megakernel of `batch` codewords
    instead (per-lane sigma rows when n_points > 1).

    Returns (decoder, label). The label names where it runs, the CUDA
    kernel or the plain version, the CN update where it is min*, and the
    schedule, two-phase and megakernel forms (`cuda-minsum`,
    `cuda-minstar-layered`, `torch-plain-layered-2phase`,
    `torch-plain-minstar-mc`, `cuda-minsum-mc`, ...).
    decoder.batch_tile is its batch granularity (the Pallas batch tile's
    counterpart).

    A positive cfg.decoder.phase1_iters below max_iter, with early
    termination and a batch, wraps the decoder in `TwoPhaseDecoder` with
    capacity phase2_frac * batch rounded up to the tile; -1 is the sweep's
    AUTO sentinel and builds the single-phase decoder here, as the
    reference does (pipeline.py:194-219)."""
    def build(dec_cfg, **mc):
        return minsum.make_decoder(
            ct, dec_cfg, cfg.quant, input_scale=float(cfg.quant.scale),
            count_info_cols=ct.kb if ct.ident_info else None, **mc)

    dc = cfg.decoder
    star = dc.algorithm == "min-star"
    if ct.device.type == "cuda":
        label = "cuda-minstar" if star else "cuda-minsum"
    else:
        label = "torch-plain-minstar" if star else "torch-plain"
    if dc.schedule == "layered":
        label += "-layered"
    if use_mc(ct, cfg):
        if not batch:
            raise ValueError("the megakernel needs a batch size")
        return build(dc, mc_batch=batch,
                     mc_lane_sigma=n_points > 1), label + "-mc"
    dec = build(dc)
    p1 = dc.phase1_iters
    if p1 and p1 > 0 and dc.early_term and batch and p1 < dc.max_iter:
        dec_p1 = build(dataclasses.replace(dc, max_iter=p1))
        tile = dec.batch_tile
        want = max(int(batch * dc.phase2_frac), tile)
        cap = min(batch, -(-want // tile) * tile)
        return TwoPhaseDecoder(dec_p1, dec, cap), label + "-2phase"
    return dec, label


def make_lane_step(ct: CodeTensors, cfg: SimConfig,
                   batch: Optional[int] = None,
                   n_points: int = 1) -> Callable[..., Tuple]:
    """Returns step(rng, sigma, *, info_t=None, noise=None, words=None) ->
    per-lane (bit_errs, frame_err, iters, conv), each (B,) on ct's device.

    rng: for the host chain a torch.Generator on ct's device, from which
    it draws the info bits first, then the noise; for the megakernel
    (step.mc) the int batch seed that keys its Philox stream
    (`Sweep.draw` gives either). sigma: the noise standard deviation, taken to float32; with
    n_points > 1 a vector (n_points,), lane b taking sigma[b % n_points].
    Injected draws (tests): info_t (k, B) uint8 and noise float32 of the
    symbols' shape ((n, B) for BPSK, (n / m, 2, B) for m bits per symbol)
    for the host chain, words (W, B) int32 for the megakernel; with them
    no generator is needed. The step carries `decoder`, `backend_label`
    and `mc`."""
    check_in_slice(ct, cfg)
    B = batch or cfg.run.batch
    if n_points < 1 or B % n_points:
        raise ValueError(f"batch {B} not divisible by n_points {n_points}")
    mod = cfg.channel.modulation
    dec, label = select_decoder(ct, cfg, batch=B, n_points=n_points)
    mc = isinstance(dec, minsum.McDecoder)
    dev = ct.device
    n, k, nb, Z = ct.n, ct.k, ct.nb, ct.Z
    point = torch.arange(B, device=dev) % n_points
    scale = float(cfg.quant.scale)
    m = ch.BITS_PER_SYM[mod]
    sym_shape = (n, B) if mod == "bpsk" else (n // m, 2, B)

    def lane_sigma(sigma) -> torch.Tensor:
        s = torch.as_tensor(np.asarray(sigma, np.float32), device=dev)
        if tuple(s.shape) != (n_points,):
            raise ValueError(f"fused sweep expects sigma of shape "
                             f"({n_points},), got {tuple(s.shape)}")
        return s[point]

    if mc:
        def step(rng, sigma, *, words: Optional[torch.Tensor] = None
                 ) -> Tuple:
            if rng is None and words is None:
                raise ValueError("run_batch needs a seed or injected words")
            if rng is not None and not isinstance(rng, int):
                raise TypeError(f"the megakernel takes the int batch seed, "
                                f"got {type(rng).__name__}")
            if n_points > 1:
                sig = lane_sigma(sigma)
                return dec(rng, words=words, sigma_lane=sig,
                           gain_lane=gain_for(sig, scale))
            s32 = np.float32(sigma)
            return dec(rng, s32, gain_for(s32, scale), words=words)
    else:
        enc_t = make_encoder_t(ct)

        def step(rng, sigma, *, info_t: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> Tuple:
            if info_t is None:
                if rng is None:
                    raise ValueError("run_batch needs a torch.Generator")
                info_t = torch.randint(0, 2, (k, B), generator=rng,
                                       device=dev, dtype=torch.uint8)
            elif tuple(info_t.shape) != (k, B) or info_t.dtype != torch.uint8:
                raise ValueError(f"info_t must be ({k}, {B}) uint8")
            if noise is not None and (tuple(noise.shape) != sym_shape
                                      or noise.dtype != torch.float32):
                raise ValueError(f"noise must be {sym_shape} float32")
            sig = lane_sigma(sigma) if n_points > 1 else sigma
            x = ch.modulate_t(enc_t(info_t), mod)
            y = ch.awgn_t(rng, x, sig, noise=noise)
            llr = ch.demap_t(y, sig, mod).reshape(nb, Z, B)
            if dec.counting:
                return dec(llr, info_t.reshape(ct.kb, Z, B))
            hard_t, iters, conv = dec(llr)
            err = hard_t.reshape(n, B)[ct.info_positions] != info_t
            return err.sum(dim=0), err.any(dim=0), iters, conv

    step.backend_label = label
    step.decoder = dec
    step.mc = mc
    return step


def make_run_batch(ct: CodeTensors, cfg: SimConfig,
                   batch: Optional[int] = None,
                   n_points: int = 1) -> Callable[..., torch.Tensor]:
    """Returns run_batch(rng, sigma, **draws) -> int64 tensor on ct's
    device stacking (frames, bit_errs, frame_errs, iter_sum, converged):
    shape (5,) for one point, (5, n_points) summed per point (lane b
    counts for point b % n_points) for a fused sweep. The sums of
    `make_lane_step`'s per-lane results, with the same arguments and
    attributes (`backend_label`, `decoder`, `mc`)."""
    B = batch or cfg.run.batch
    step = make_lane_step(ct, cfg, batch=B, n_points=n_points)
    dev = ct.device
    i64 = torch.int64

    def run_batch(rng, sigma, **draws) -> torch.Tensor:
        bits, frame, iters, conv = step(rng, sigma, **draws)
        lanes = torch.stack([bits.to(i64), frame.to(i64), iters.to(i64),
                             conv.to(i64)])                       # (4, B)
        if n_points == 1:
            return torch.cat([torch.full((1,), B, dtype=i64, device=dev),
                              lanes.sum(dim=1)])
        per = lanes.reshape(4, B // n_points, n_points).sum(dim=1)
        frames = torch.full((1, n_points), B // n_points, dtype=i64,
                            device=dev)
        return torch.cat([frames, per])

    run_batch.backend_label = step.backend_label
    run_batch.decoder = step.decoder
    run_batch.mc = step.mc
    return run_batch
