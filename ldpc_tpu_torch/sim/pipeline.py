"""The simulation step (counterpart of `ldpc_tpu/sim/pipeline.py`:
`make_run_batch`, `BatchCounters`, `select_decoder`).

Ported scope: the transposed host-RNG step of `make_run_batch`
(pipeline.py:600-644) for one Eb/N0 point, no mesh, no superbatching, no
two-phase decoding. One call runs, batch last:

  info bits (k, B) -> dense encode -> BPSK -> AWGN -> demap -> decoder
  (quantizes in the kernel, and counts info-bit errors there when the info
  bits are the codeword's prefix) -> (5,) counter stack

with the random draws from an explicit torch.Generator on the code's
device. Configurations outside that scope raise NotImplementedError
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

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
    if dec.schedule != "flooding":
        no("the layered schedule", "ROADMAP kernel K3, module item 5")
    if dec.early_term:
        no("early termination", "ROADMAP kernel K2, module item 9")
    if dec.phase1_iters:
        no("two-phase decoding", "ROADMAP module item 10")
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


def select_decoder(ct: CodeTensors, cfg: SimConfig
                   ) -> Tuple[minsum.MinsumDecoder, str]:
    """The fused-IO min-sum decoder for the step: float32 LLRs in, the
    quantizer in the kernel; error counting in the kernel too when the info
    bits are the identity prefix (ct.ident_info), hard bits out otherwise.
    The label names where it runs: the CUDA kernel or the plain version."""
    dec = minsum.make_decoder(
        ct, cfg.decoder, cfg.quant, input_scale=float(cfg.quant.scale),
        count_info_cols=ct.kb if ct.ident_info else None)
    label = "cuda-minsum" if ct.device.type == "cuda" else "torch-plain"
    return dec, label


def make_run_batch(ct: CodeTensors, cfg: SimConfig,
                   batch: Optional[int] = None
                   ) -> Callable[..., torch.Tensor]:
    """Returns run_batch(generator, sigma, *, info_t=None, noise=None) ->
    int64 tensor (5,) on ct's device stacking (frames, bit_errs,
    frame_errs, iter_sum, converged).

    generator: a torch.Generator on ct's device; info bits are drawn first,
    then the noise. sigma: the noise standard deviation, taken to float32.
    info_t (k, B) uint8 and noise (n, B) float32 inject the random draws
    (tests): with both given, no generator is needed."""
    check_in_slice(ct, cfg)
    B = batch or cfg.run.batch
    mod = cfg.channel.modulation
    enc_t = make_encoder_t(ct)
    dec, label = select_decoder(ct, cfg)
    dev = ct.device
    n, k, nb, Z = ct.n, ct.k, ct.nb, ct.Z

    def run_batch(generator: Optional[torch.Generator], sigma, *,
                  info_t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
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
            bits, frame, iters, conv = dec(llr, info_t.reshape(ct.kb, Z, B))
        else:
            hard_t, iters, conv = dec(llr)
            err = hard_t.reshape(n, B)[ct.info_positions] != info_t
            bits, frame = err.sum(dim=0), err.any(dim=0)
        i64 = torch.int64
        return torch.stack([
            torch.full((), B, dtype=i64, device=dev), bits.sum(dtype=i64),
            frame.sum(dtype=i64), iters.sum(dtype=i64), conv.sum(dtype=i64)])

    run_batch.backend_label = label
    run_batch.decoder = dec
    return run_batch
