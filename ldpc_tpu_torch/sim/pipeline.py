"""The simulation step (counterpart of `ldpc_tpu/sim/pipeline.py`:
`make_run_batch`, `BatchCounters`, `select_decoder`,
`make_two_phase_decoder_t`).

Ported scope: the transposed host-RNG step of `make_run_batch`
(pipeline.py:600-644) for one Eb/N0 point, no mesh, no superbatching;
flooding or layered min-sum, fixed iterations or early termination, and
two-phase early termination. One call runs, batch last:

  info bits (k, B) -> dense encode -> BPSK -> AWGN -> demap -> decoder
  (quantizes in the kernel, and counts info-bit errors there when the info
  bits are the codeword's prefix) -> (5,) counter stack

with the random draws from an explicit torch.Generator on the code's
device. Configurations outside that scope raise NotImplementedError
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import torch

from ldpc_tpu.config import SimConfig

from ..codes import CodeTensors
from ..kernels import minsum
from ..ops import channel as ch
from ..ops.encode import make_encoder_t

MIN_SUM_FAMILY = ("min-sum", "offset-min-sum", "normalized-min-sum")


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
    if dec.algorithm not in MIN_SUM_FAMILY:
        no(f"decoder algorithm {dec.algorithm!r}",
           "ROADMAP kernel K5 for min-star, module item 12 for float "
           "decoders")
    if cfg.channel.modulation != "bpsk":
        no(f"modulation {cfg.channel.modulation!r}", "ROADMAP module item 11")
    code = ct.code
    if len(code.punct_vns) or len(code.shortened_vns):
        no("rate matching (puncturing/shortening)", "ROADMAP module item 13")
    if cfg.run.all_zeros:
        no("the all-zeros codeword shortcut",
           "it lives in the batch-first step of sim/pipeline.make_run_batch")
    if cfg.run.rng != "host":
        no(f"rng={cfg.run.rng!r} (the Monte-Carlo megakernel)",
           "ROADMAP kernel K1-MC, module item 7")


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


Decoder = Union[minsum.MinsumDecoder, TwoPhaseDecoder]


def select_decoder(ct: CodeTensors, cfg: SimConfig,
                   batch: Optional[int] = None) -> Tuple[Decoder, str]:
    """The fused-IO min-sum decoder for the step: float32 LLRs in, the
    quantizer in the kernel; error counting in the kernel too when the info
    bits are the identity prefix (ct.ident_info), hard bits out otherwise.

    Returns (decoder, label). The label names where it runs, the CUDA
    kernel or the plain version, and the schedule and two-phase form as
    the reference's labels do (`cuda-minsum`, `cuda-minsum-layered`,
    `torch-plain-layered-2phase`, ...). decoder.batch_tile is its batch
    granularity (the Pallas batch tile's counterpart).

    A positive cfg.decoder.phase1_iters below max_iter, with early
    termination and a batch, wraps the decoder in `TwoPhaseDecoder` with
    capacity phase2_frac * batch rounded up to the tile; -1 is the sweep's
    AUTO sentinel and builds the single-phase decoder here, as the
    reference does (pipeline.py:194-219)."""
    def build(dec_cfg):
        return minsum.make_decoder(
            ct, dec_cfg, cfg.quant, input_scale=float(cfg.quant.scale),
            count_info_cols=ct.kb if ct.ident_info else None)

    dc = cfg.decoder
    dec = build(dc)
    label = "cuda-minsum" if ct.device.type == "cuda" else "torch-plain"
    if dc.schedule == "layered":
        label += "-layered"
    p1 = dc.phase1_iters
    if p1 and p1 > 0 and dc.early_term and batch and p1 < dc.max_iter:
        dec_p1 = build(dataclasses.replace(dc, max_iter=p1))
        tile = dec.batch_tile
        want = max(int(batch * dc.phase2_frac), tile)
        cap = min(batch, -(-want // tile) * tile)
        return TwoPhaseDecoder(dec_p1, dec, cap), label + "-2phase"
    return dec, label


def make_lane_step(ct: CodeTensors, cfg: SimConfig,
                   batch: Optional[int] = None) -> Callable[..., Tuple]:
    """Returns step(generator, sigma, *, info_t=None, noise=None) ->
    per-lane (bit_errs, frame_err, iters, conv), each (B,) on ct's device.

    generator: a torch.Generator on ct's device; info bits are drawn first,
    then the noise. sigma: the noise standard deviation, taken to float32.
    info_t (k, B) uint8 and noise (n, B) float32 inject the random draws
    (tests): with both given, no generator is needed. The step carries
    `decoder` and `backend_label` (select_decoder)."""
    check_in_slice(ct, cfg)
    B = batch or cfg.run.batch
    mod = cfg.channel.modulation
    enc_t = make_encoder_t(ct)
    dec, label = select_decoder(ct, cfg, batch=B)
    dev = ct.device
    n, k, nb, Z = ct.n, ct.k, ct.nb, ct.Z

    def step(generator: Optional[torch.Generator], sigma, *,
             info_t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> Tuple:
        if info_t is None:
            if generator is None:
                raise ValueError("run_batch needs a torch.Generator")
            info_t = torch.randint(0, 2, (k, B), generator=generator,
                                   device=dev, dtype=torch.uint8)
        elif tuple(info_t.shape) != (k, B) or info_t.dtype != torch.uint8:
            raise ValueError(f"info_t must be ({k}, {B}) uint8")
        if noise is not None and (tuple(noise.shape) != (n, B)
                                  or noise.dtype != torch.float32):
            raise ValueError(f"noise must be ({n}, {B}) float32")
        x = ch.modulate_t(enc_t(info_t), mod)
        y = ch.awgn_t(generator, x, sigma, noise=noise)
        llr = ch.demap_t(y, sigma, mod).reshape(nb, Z, B)
        if dec.counting:
            return dec(llr, info_t.reshape(ct.kb, Z, B))
        hard_t, iters, conv = dec(llr)
        err = hard_t.reshape(n, B)[ct.info_positions] != info_t
        return err.sum(dim=0), err.any(dim=0), iters, conv

    step.backend_label = label
    step.decoder = dec
    return step


def make_run_batch(ct: CodeTensors, cfg: SimConfig,
                   batch: Optional[int] = None
                   ) -> Callable[..., torch.Tensor]:
    """Returns run_batch(generator, sigma, *, info_t=None, noise=None) ->
    int64 tensor (5,) on ct's device stacking (frames, bit_errs,
    frame_errs, iter_sum, converged): the sums of `make_lane_step`'s
    per-lane results, with the same arguments and attributes."""
    B = batch or cfg.run.batch
    step = make_lane_step(ct, cfg, batch=B)
    dev = ct.device

    def run_batch(generator: Optional[torch.Generator], sigma, *,
                  info_t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        bits, frame, iters, conv = step(generator, sigma, info_t=info_t,
                                        noise=noise)
        i64 = torch.int64
        return torch.stack([
            torch.full((), B, dtype=i64, device=dev), bits.sum(dtype=i64),
            frame.sum(dtype=i64), iters.sum(dtype=i64), conv.sum(dtype=i64)])

    run_batch.backend_label = step.backend_label
    run_batch.decoder = step.decoder
    return run_batch
