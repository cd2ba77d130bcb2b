"""The draws and the channel of one batch, in plain torch and numpy.

A batch is keyed by (seed, point, batch index) through numpy's SeedSequence,
as the sweep keys it. From that key come either

  * the host draws: a torch.Generator on the device, seeded with the key,
    draws the information bits (uint8 0/1) and then the standard normal
    noise. Codes of at most 4,096 bits are drawn bit axis first ((k, B) and
    (n, B)), longer codes batch first ((B, k) and (B, n)); with all-zero
    codewords no information bit is drawn and the noise comes first; or
  * the device draws: Philox4x32-10 (Salmon et al., SC'11) keyed by the key,
    word w of lane b at counter (w // 4, b, 0, 0), output w % 4. A lane's
    first k words give its information bits (word & 1); the next
    ceil(nb / 2) * Z pairs give Box-Muller normals, the cosine half to even
    base columns and the sine half to odd ones.

BPSK maps bit 0 to +1; y = x + sigma * noise; the LLR is 2 y / sigma**2,
quantized as round half away from zero of LLR * scale, clipped to +-qmax.
Every float operation is float32 and rounds once, in this order.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
DENSE_MAX_N = 4096


def batch_seed(seed: int, point: int, batch: int) -> int:
    words = np.random.SeedSequence([int(seed), int(point), int(batch)]
                                   ).generate_state(2, np.uint32)
    return (int(words[0]) << 32) | int(words[1])


def sigma_bpsk(ebn0_db: float, rate: float) -> np.float32:
    """Noise standard deviation of BPSK at Eb/N0 for unit symbol energy."""
    ebn0 = 10.0 ** (ebn0_db / 10.0)
    return np.float32(math.sqrt(1.0 / (2.0 * rate * ebn0)))


def _mul32(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * x, x int64 holding uint32: x is split
    into 16-bit halves so that no product passes 2**48."""
    a = m * (x >> 16)
    b = m * (x & 0xFFFF)
    low = (((a & 0xFFFF) << 16) + b) & MASK
    high = (a + (b >> 16)) >> 16
    return high, low


def philox(ctr, key: Tuple[int, int]):
    c0, c1, c2, c3 = ctr
    k0, k1 = key[0] & MASK, key[1] & MASK
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK
            k1 = (k1 + PHILOX_W[1]) & MASK
        h0, l0 = _mul32(PHILOX_M[0], c0)
        h1, l1 = _mul32(PHILOX_M[1], c2)
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
    return c0, c1, c2, c3


def philox_words(key64: int, n_words: int, batch: int, device
                 ) -> torch.Tensor:
    """(batch, n_words) int64 holding the uint32 words of lanes 0..B-1."""
    blocks = -(-n_words // 4)
    lane = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    blk = torch.arange(blocks, dtype=torch.int64, device=device)[None, :]
    shape = (batch, blocks)
    zero = torch.zeros(shape, dtype=torch.int64, device=device)
    out = philox((blk.expand(shape), (lane & MASK).expand(shape),
                  (lane >> 32).expand(shape), zero),
                 (key64 & MASK, key64 >> 32))
    return torch.stack(out, dim=2).reshape(batch, 4 * blocks)[:, :n_words]


def f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def quantize(llr: torch.Tensor, scale: float, qmax: int) -> torch.Tensor:
    xs = llr * scale
    r = torch.where(xs >= 0, torch.floor(xs + 0.5), torch.ceil(xs - 0.5))
    return torch.clamp(r, -qmax, qmax).to(torch.int8)


def host_draws(key64: int, k: int, n: int, batch: int, all_zeros: bool,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(info (B, k) uint8, noise (B, n) float32) from the batch's
    generator."""
    g = torch.Generator(device=device)
    g.manual_seed(key64)
    if all_zeros:
        info = torch.zeros((batch, k), dtype=torch.uint8, device=device)
        return info, torch.randn((batch, n), generator=g, device=device,
                                 dtype=torch.float32)
    if n <= DENSE_MAX_N:
        info = torch.randint(0, 2, (k, batch), generator=g, device=device,
                             dtype=torch.uint8).T
        noise = torch.randn((n, batch), generator=g, device=device,
                            dtype=torch.float32).T
        return info.contiguous(), noise.contiguous()
    info = torch.randint(0, 2, (batch, k), generator=g, device=device,
                         dtype=torch.uint8)
    return info, torch.randn((batch, n), generator=g, device=device,
                             dtype=torch.float32)


def host_llrs(cw: torch.Tensor, noise: torch.Tensor, sigma: np.float32,
              scale: float, qmax: int) -> torch.Tensor:
    s = f32(sigma, cw.device)
    x = (1 - 2 * cw.to(torch.int32)).to(torch.float32)
    y = x + s * noise
    return quantize(2.0 * y / (s * s), scale, qmax)


def device_words(key64: int, k: int, nb: int, Z: int, batch: int, device
                 ) -> torch.Tensor:
    nph = (nb + 1) // 2
    return philox_words(key64, k + 2 * nph * Z, batch, device)


def device_info(words: torch.Tensor, k: int) -> torch.Tensor:
    return (words[:, :k] & 1).to(torch.uint8)


def device_llrs(words: torch.Tensor, cw: torch.Tensor, k: int, nb: int,
                Z: int, sigma: np.float32, scale: float, qmax: int
                ) -> torch.Tensor:
    """The quantized LLRs (B, n) of codewords cw under the lanes' words."""
    dev, B = cw.device, cw.shape[0]
    nph = (nb + 1) // 2

    def unit(w: torch.Tensor) -> torch.Tensor:
        return ((w >> 8).to(torch.float32) * f32(2.0 ** -24, dev)
                + f32(2.0 ** -25, dev))

    u1 = unit(words[:, k:k + nph * Z]).reshape(B, nph, Z)
    u2 = unit(words[:, k + nph * Z:k + 2 * nph * Z]).reshape(B, nph, Z)
    r = torch.sqrt(f32(-2.0, dev) * torch.log(u1))
    th = f32(2.0 * math.pi, dev) * u2
    nrm = torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=2
                      ).reshape(B, 2 * nph, Z)[:, :nb].reshape(B, nb * Z)
    s = f32(sigma, dev)
    gain = f32(np.float32(2.0) * np.float32(scale)
               / (np.float32(sigma) * np.float32(sigma)), dev)
    x = (1 - 2 * cw.to(torch.int32)).to(torch.float32)
    xs = (x + s * nrm) * gain
    r8 = torch.where(xs >= 0, torch.floor(xs + 0.5), torch.ceil(xs - 0.5))
    return torch.clamp(r8, -qmax, qmax).to(torch.int8)
