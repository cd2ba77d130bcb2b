"""BPSK over AWGN and its LLR demapper (counterpart of the BPSK subset of
`ldpc_tpu/ops/channel.py`).

Conventions are the reference's: bit 0 -> +1, LLR > 0 means bit 0,
sigma**2 = 1/(2 R EbN0_lin), LLR = 2 y / sigma**2 in float32. sigma is
taken to float32 before any arithmetic (the reference's Sweep passes
np.float32(sigma)); a float64 sigma would move LLRs by ulps and so move
the quantizer at its half-LSB boundaries.

The other modulations (QPSK/QAM/PSK/APSK) are ROADMAP module item 11 and
raise NotImplementedError.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

BITS_PER_SYM = {"bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6,
                "8psk": 3, "16apsk": 4, "32apsk": 5}


def sigma_for(ebn0_db: float, rate: float, modulation: str) -> float:
    """Per-real-dimension noise standard deviation for Es = 1."""
    ebn0 = 10.0 ** (ebn0_db / 10.0)
    m = BITS_PER_SYM[modulation]
    if modulation == "bpsk":
        return math.sqrt(1.0 / (2.0 * rate * ebn0))
    n0 = 1.0 / (rate * m * ebn0)
    return math.sqrt(n0 / 2.0)


def _bpsk_only(modulation: str) -> None:
    if modulation != "bpsk":
        raise NotImplementedError(
            f"modulation {modulation!r}: the port has BPSK only so far "
            f"(ROADMAP module item 11, the full channel set)")


def _sigma32(sigma, device: torch.device) -> torch.Tensor:
    """sigma (Python/numpy scalar, or (B,) per lane) as float32 on device."""
    if isinstance(sigma, torch.Tensor):
        return sigma.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(sigma, np.float32), device=device)


def _bcast_first(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-codeword sigma (B,) against batch-first x (B, ...)."""
    return s if s.ndim == 0 else s.reshape((-1,) + (1,) * (x.ndim - 1))


def modulate(bits: torch.Tensor, modulation: str) -> torch.Tensor:
    """bits (..., n) in {0,1} -> BPSK symbols (..., n) float32."""
    _bpsk_only(modulation)
    return (1 - 2 * bits.to(torch.int32)).to(torch.float32)


def modulate_t(bits_t: torch.Tensor, modulation: str) -> torch.Tensor:
    """Batch-last bits (n, B) -> BPSK symbols (n, B) float32."""
    return modulate(bits_t, modulation)


def _normal(generator: Optional[torch.Generator], x: torch.Tensor
            ) -> torch.Tensor:
    if generator is None:
        raise ValueError("awgn needs a torch.Generator or injected noise")
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=torch.float32)


def awgn(generator: Optional[torch.Generator], x: torch.Tensor, sigma,
         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch-first AWGN: x (B, ...) + sigma * N(0, 1). sigma scalar or
    per-codeword (B,). noise: injected standard-normal draws (tests)."""
    n = _normal(generator, x) if noise is None else noise
    return x + _bcast_first(_sigma32(sigma, x.device), x) * n


def awgn_t(generator: Optional[torch.Generator], x: torch.Tensor, sigma,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch-last AWGN: x (..., B) + sigma * N(0, 1); sigma scalar or
    per-lane (B,), which broadcasts on the trailing axis."""
    n = _normal(generator, x) if noise is None else noise
    return x + _sigma32(sigma, x.device) * n


def demap(y: torch.Tensor, sigma, modulation: str) -> torch.Tensor:
    """Batch-first received BPSK symbols -> float32 LLRs 2 y / sigma**2."""
    _bpsk_only(modulation)
    sb = _bcast_first(_sigma32(sigma, y.device), y)
    return 2.0 * y / (sb * sb)


def demap_t(y: torch.Tensor, sigma, modulation: str) -> torch.Tensor:
    """Batch-last received BPSK symbols (n, B) -> float32 LLRs (n, B)."""
    _bpsk_only(modulation)
    s = _sigma32(sigma, y.device)
    return 2.0 * y / (s * s)
