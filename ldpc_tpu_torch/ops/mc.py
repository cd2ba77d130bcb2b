"""The Monte-Carlo megakernel's prologue in plain torch: random words ->
info bits -> structured QC encode -> BPSK + Box-Muller AWGN + demap +
quantize (counterpart of `ldpc_tpu/kernels/minsum_pallas.py:484-556`, the
plain version of `kernels/csrc/mc_stage.cuh`).

The float stage follows the reference's op order exactly, one rounding
per op (no fused multiply-add), so that the CUDA stage, which pins the
same order with __fmul_rn/__fadd_rn, gives the same int8 LLRs on the card:

    to_unit(w) = float32(w >>> 8) * 2**-24 + 2**-25       in (0, 1]
    r = sqrt(-2 * log(to_unit(n1))),  theta = float32(2 pi) * to_unit(n2)
    nrm = r * cos(theta) for even block j = 2p, r * sin(theta) for 2p + 1
    xs = ((1 - 2 c) + sigma * nrm) * gain,   gain = 2 * scale / sigma**2
    q = clip(xs >= 0 ? floor(xs + 0.5) : ceil(xs - 0.5), -qmax, qmax)

sigma and gain are float32 scalars, or per-lane float32 rows (B,) (the
fused multi-SNR sweep). On the CPU, torch's vectorised log/sin/cos may
differ from XLA's by an ulp, which can move q by one LSB at a rounding
boundary; the tests bound that.
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

from ..codes.code import LDPCCode

from .encode import make_qc_encoder_t
from .rng import word_layout

Scalar = Union[float, np.floating, torch.Tensor]

TWO_PI = np.float32(2.0 * np.pi)


def gain_for(sigma, scale: float):
    """gain = 2 * scale / sigma**2 in float32 (numpy scalar or tensor),
    with a true division: torch computes `number / tensor` as a reciprocal
    times the number, which rounds differently."""
    if isinstance(sigma, torch.Tensor):
        s = sigma.to(torch.float32)
        num = torch.tensor(np.float32(2.0) * np.float32(scale),
                           device=s.device)
        return num / (s * s)
    s = np.float32(sigma)
    return np.float32(np.float32(2.0) * np.float32(scale) / (s * s))


def to_unit(w: torch.Tensor) -> torch.Tensor:
    """int32 words -> float32 in (0, 1] from their top 24 bits (never 0,
    so the log is finite)."""
    u = (w.to(torch.int64) & 0xFFFFFFFF) >> 8
    return u.to(torch.float32) * np.float32(2.0 ** -24) + np.float32(2.0 ** -25)


def make_prologue(code: LDPCCode, qmax: int
                  ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]]:
    """prologue(words (W, B) int32, sigma, gain) -> (info_t (k, B) uint8,
    cw (n, B) uint8, q (n, B) int8), on the words' device. W and the
    layout are `rng.word_layout(kb, nb, Z)`."""
    Z = int(code.Z)
    nb = code.base.shape[1]
    encode_t = make_qc_encoder_t(code)
    k, nph, W = word_layout(code.k // Z, nb, Z)
    assert k == code.k

    def prologue(words: torch.Tensor, sigma: Scalar, gain: Scalar):
        if words.ndim != 2 or words.shape[0] != W:
            raise ValueError(f"words shape {tuple(words.shape)}, expected "
                             f"({W}, B)")
        B = words.shape[1]
        dev = words.device
        info_t = (words[:k] & 1).to(torch.uint8)
        cw = encode_t(info_t)
        n1 = words[k: k + nph * Z].reshape(nph, Z, B)
        n2 = words[k + nph * Z:].reshape(nph, Z, B)
        r = torch.sqrt(np.float32(-2.0) * torch.log(to_unit(n1)))
        th = TWO_PI * to_unit(n2)
        nrm = torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=1
                          ).reshape(2 * nph, Z, B)[:nb]
        x = (1 - 2 * cw.reshape(nb, Z, B).to(torch.int32)).to(torch.float32)
        sig = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
        g = torch.as_tensor(gain, dtype=torch.float32, device=dev)
        xs = (x + sig * nrm) * g
        qf = torch.where(xs >= 0, torch.floor(xs + 0.5), torch.ceil(xs - 0.5))
        q = torch.clamp(qf, -qmax, qmax).to(torch.int8)
        return info_t, cw, q.reshape(nb * Z, B)

    prologue.n_words = W
    return prologue
