"""Modulation, AWGN channel and LLR demapping (counterpart of
`ldpc_tpu/ops/channel.py`).

BPSK and Gray-mapped square QAM (QPSK/16/64), unit average symbol energy,
max-log per-bit LLRs computed per axis (exact for Gray-labeled square QAM),
and the DVB-S2 family's constellations, 8PSK and 16/32APSK (ring geometry
per EN 302 307-1; quasi-Gray labeling, see _quadrant_gray_rings), demapped
by generic full-constellation max-log. The BSC and its LLRs close the set.

Conventions are the reference's:
  * bit 0 -> +amplitude on its axis; LLR > 0 means bit 0.
  * BPSK over the real AWGN channel: sigma**2 = 1/(2 R EbN0_lin),
    LLR = 2 y / sigma**2.
  * QAM over the complex channel (I/Q as two reals): per-dimension noise
    variance sigma**2 = N0/2 with N0 = 1/(R m EbN0_lin), m bits/symbol,
    Es = 1. Per symbol the bits are the I bits, then the Q bits.
  * Batch-first symbols are (..., nsym, 2), batch-last (nsym, 2, B): I/Q in
    the middle, the batch the trailing axis through every intermediate, so
    a per-lane sigma (B,) broadcasts by itself.

All arithmetic is float32 and in the reference's order (d2, the minima
masked with 1e30, (m1 - m0) / n0 with n0 = 2 sigma sigma), so on equal y the
LLRs equal the reference's bit for bit. sigma is taken to float32 before
any arithmetic (the reference's Sweep passes np.float32(sigma)); a float64
sigma would move LLRs by ulps and so move the quantizer at its half-LSB
boundaries. These are elementwise passes outside any kernel in the
reference too, and stay plain torch ops.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

MODULATIONS = ("bpsk", "qpsk", "16qam", "64qam", "8psk", "16apsk", "32apsk")

BITS_PER_SYM = {"bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6,
                "8psk": 3, "16apsk": 4, "32apsk": 5}

# DVB-S2 ring-radius ratios (EN 302 307-1 Tables 9/10 give gamma per code
# rate; these defaults are the lowest-rate entries — 16APSK r2/3, 32APSK
# r3/4). The ratio only shapes the constellation geometry; the demapper is
# generic max-log over the point set, so changing it touches nothing else.
APSK_GAMMA = {"16apsk": (3.15,), "32apsk": (2.84, 5.27)}


def _gray_levels(bits_per_axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """PAM levels and their Gray bit labels for one axis.

    Returns (levels[L] float64 unnormalized odd integers ..-3,-1,1,3..,
             labels[L, bits_per_axis] uint8) where labels follow the standard
    reflected-Gray mapping with MSB first (bit 0 selects the sign half).
    """
    L = 1 << bits_per_axis
    levels = np.arange(-(L - 1), L, 2, dtype=np.float64)
    idx = np.arange(L)
    gray = idx ^ (idx >> 1)
    # level i (ascending) carries gray code of i, but with MSB inverted so that
    # bit pattern 0.. maps to the positive side (bit 0 -> +): flip order.
    labels = np.zeros((L, bits_per_axis), np.uint8)
    for i in range(L):
        g = gray[L - 1 - i]  # descending gray index on ascending levels
        for b in range(bits_per_axis):
            labels[i, b] = (g >> (bits_per_axis - 1 - b)) & 1
    return levels, labels


def _axis_norm(bits_per_axis: int) -> float:
    L = 1 << bits_per_axis
    levels = np.arange(-(L - 1), L, 2, dtype=np.float64)
    mean_sq = float(np.mean(levels**2))
    return 1.0 / math.sqrt(2.0 * mean_sq)  # two axes share Es = 1


def _quadrant_gray_rings(ring_counts: Tuple[int, ...],
                         radii: Tuple[float, ...], m: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Quasi-Gray labeled concentric-ring (APSK/PSK) constellation.

    Construction (quadrant-symmetric, like the DVB-S2 figures): the two MSBs
    Gray-code the quadrant (00,01,11,10 counter-clockwise); the remaining
    m-2 bits select the point inside the quadrant, swept boustrophedon per
    ring so labels at quadrant boundaries match across the seam — every
    angularly adjacent pair on a ring then differs in exactly one bit. Ring
    identity lives in the within-quadrant bits (rings get disjoint code
    sets). Labeling is implementation-defined quasi-Gray, NOT the published
    DVB-S2 bit map (standard_exact=False in the repo's convention); ring
    counts and radius ratios are the standard's, with every ring phased at
    (2t+1)*pi/count so no point sits on a quadrant boundary (for 8PSK that
    is the standard ring rotated pi/8 — performance-invariant on AWGN).

    Returns (points[M, 2] unit-Es float64, labels[M, m] uint8).
    """
    assert all(c % 4 == 0 for c in ring_counts)
    M = sum(ring_counts)
    assert M == 1 << m
    pts = np.zeros((M, 2), np.float64)
    labels = np.zeros((M, m), np.uint8)
    quad_gray = (0b00, 0b01, 0b11, 0b10)  # CCW quadrants
    inner_bits = m - 2
    # Within-quadrant code walk per ring: disjoint code sets covering
    # [0, 2**inner_bits), each listed in an order whose consecutive steps
    # (and endpoints, for the boustrophedon seam) flip exactly one bit.
    ring_walks = {
        (8,): ([0, 1],),                       # 8PSK: 2 per quadrant
        (4, 12): ([2], [0, 1, 3]),             # 16APSK: inner 1, outer 3
        (4, 12, 16): ([6], [4, 5, 7], [0, 1, 3, 2]),  # 32APSK: 1 + 3 + 4
    }[ring_counts]
    i = 0
    for cnt, rad, walk in zip(ring_counts, radii, ring_walks):
        per_quad = cnt // 4
        assert len(walk) == per_quad
        for q in range(4):
            idx = walk if q % 2 == 0 else walk[::-1]  # boustrophedon
            for j in range(per_quad):
                # DVB-S2-style ring phases: points at (2t+1)*pi/cnt (axis-
                # symmetric, none on a quadrant boundary)
                t = q * per_quad + j
                ang = (2 * t + 1) * math.pi / cnt
                pts[i] = (rad * math.cos(ang), rad * math.sin(ang))
                code = (quad_gray[q] << inner_bits) | idx[j]
                for b in range(m):
                    labels[i, b] = (code >> (m - 1 - b)) & 1
                i += 1
    es = float(np.mean(np.sum(pts**2, axis=-1)))
    assert len({tuple(l) for l in labels}) == M  # all labels distinct
    return pts / math.sqrt(es), labels


def _constellation(modulation: str) -> Tuple[np.ndarray, np.ndarray]:
    """(points[M, 2] unit-Es, labels[M, m]) for the generic (non-separable)
    constellations: 8PSK and DVB-S2-geometry 16/32APSK."""
    m = BITS_PER_SYM[modulation]
    if modulation == "8psk":
        return _quadrant_gray_rings((8,), (1.0,), m)
    if modulation == "16apsk":
        (g,) = APSK_GAMMA["16apsk"]
        return _quadrant_gray_rings((4, 12), (1.0, g), m)
    if modulation == "32apsk":
        g1, g2 = APSK_GAMMA["32apsk"]
        return _quadrant_gray_rings((4, 12, 16), (1.0, g1, g2), m)
    raise ValueError(f"no generic constellation for {modulation}")


def sigma_for(ebn0_db: float, rate: float, modulation: str) -> float:
    """Per-real-dimension noise standard deviation for Es = 1."""
    ebn0 = 10.0 ** (ebn0_db / 10.0)
    m = BITS_PER_SYM[modulation]
    if modulation == "bpsk":
        return math.sqrt(1.0 / (2.0 * rate * ebn0))
    n0 = 1.0 / (rate * m * ebn0)
    return math.sqrt(n0 / 2.0)


_GENERIC = ("8psk", "16apsk", "32apsk")
_BIG = 1e30


def _key_order(labels: np.ndarray) -> np.ndarray:
    """Integer formed by each label's bits, MSB first."""
    m = labels.shape[1]
    return (labels.astype(np.int64) << np.arange(m - 1, -1, -1)).sum(axis=1)


@lru_cache(maxsize=None)
def _tables(modulation: str):
    """(lut, points, labels) as numpy: lut maps the label integer to the
    point ((2**m, 2) for the generic constellations, (2**ba,) per axis for
    square QAM); points/labels are the demapper's reference set ((M, 2) and
    (M, m), or the (L,) axis levels and (L, ba))."""
    m = BITS_PER_SYM[modulation]
    if modulation in _GENERIC:
        pts, labels = _constellation(modulation)
        lut = np.zeros((1 << m, 2), np.float32)
        lut[_key_order(labels)] = pts
        return lut, pts.astype(np.float32), labels.astype(bool)
    ba = m // 2
    levels, labels = _gray_levels(ba)
    lev = levels * _axis_norm(ba)
    lut = np.zeros(1 << ba, np.float32)
    lut[_key_order(labels)] = lev
    return lut, lev.astype(np.float32), labels.astype(bool)


def _t(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def _check_bits(n: int, modulation: str) -> int:
    m = BITS_PER_SYM[modulation]
    if n % m:
        raise ValueError(f"{n} bits do not fill {modulation} symbols of "
                         f"{m} bits")
    return m


def _sigma32(sigma, device: torch.device) -> torch.Tensor:
    """sigma (Python/numpy scalar, or (B,) per lane) as float32 on device."""
    if isinstance(sigma, torch.Tensor):
        return sigma.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(sigma, np.float32), device=device)


def _bcast_first(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-codeword sigma (B,) against batch-first x (B, ...)."""
    return s if s.ndim == 0 else s.reshape((-1,) + (1,) * (x.ndim - 1))


def _keys(g: torch.Tensor, axis: int) -> torch.Tensor:
    """Label integers from bits along `axis` (MSB first)."""
    m = g.shape[axis]
    shape = [1] * g.ndim
    shape[axis] = m
    w = torch.tensor([1 << (m - 1 - b) for b in range(m)], dtype=torch.int64,
                     device=g.device).reshape(shape)
    return (g.to(torch.int64) * w).sum(dim=axis)


def modulate(bits: torch.Tensor, modulation: str) -> torch.Tensor:
    """bits (..., n) in {0,1} -> symbols, float32.

    BPSK: (..., n) real. Otherwise (..., n/m, 2) with I/Q as the trailing
    axis."""
    if modulation == "bpsk":
        return (1 - 2 * bits.to(torch.int32)).to(torch.float32)
    m = _check_bits(bits.shape[-1], modulation)
    lut = _t(_tables(modulation)[0], bits)
    if modulation in _GENERIC:
        g = bits.reshape(bits.shape[:-1] + (-1, m))        # (..., nsym, m)
        return lut[_keys(g, -1)]                           # (..., nsym, 2)
    g = bits.reshape(bits.shape[:-1] + (-1, 2, m // 2))    # (.., nsym, axis, ba)
    return lut[_keys(g, -1)]                               # (..., nsym, 2)


def modulate_t(bits_t: torch.Tensor, modulation: str) -> torch.Tensor:
    """bits_t (n, B) in {0,1}, bit axis first -> symbols batch-last.

    BPSK: (n, B) real. Otherwise (nsym, 2, B) with I/Q as the middle axis."""
    if modulation == "bpsk":
        return (1 - 2 * bits_t.to(torch.int32)).to(torch.float32)
    m = _check_bits(bits_t.shape[0], modulation)
    B = bits_t.shape[-1]
    lut = _t(_tables(modulation)[0], bits_t)
    if modulation in _GENERIC:
        keys = _keys(bits_t.reshape(-1, m, B), 1)          # (nsym, B)
        return torch.stack([lut[:, 0][keys], lut[:, 1][keys]], dim=1)
    return lut[_keys(bits_t.reshape(-1, 2, m // 2, B), 2)]  # (nsym, 2, B)


def standard_normal(generator: Optional[torch.Generator], shape,
                    device) -> torch.Tensor:
    """float32 N(0, 1) draws of `shape` from `generator`: the noise that
    `awgn`/`awgn_t` draw for symbols of that shape."""
    if generator is None:
        raise ValueError("awgn needs a torch.Generator or injected noise")
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32)


def awgn(generator: Optional[torch.Generator], x: torch.Tensor, sigma,
         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch-first AWGN: x (B, ...) + sigma * N(0, 1). sigma scalar or
    per-codeword (B,). noise: injected standard-normal draws of x's shape
    (tests)."""
    n = (standard_normal(generator, x.shape, x.device) if noise is None
         else noise)
    return x + _bcast_first(_sigma32(sigma, x.device), x) * n


def awgn_t(generator: Optional[torch.Generator], x: torch.Tensor, sigma,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch-last AWGN: x (..., B) + sigma * N(0, 1); sigma scalar or
    per-lane (B,), which broadcasts on the trailing axis."""
    n = (standard_normal(generator, x.shape, x.device) if noise is None
         else noise)
    return x + _sigma32(sigma, x.device) * n


def _maxlog(d2: torch.Tensor, lab: torch.Tensor, axis: int, n0, stack_axis
            ) -> torch.Tensor:
    """Per-bit max-log LLRs (m1 - m0) / n0 from squared distances d2 whose
    axis `axis` runs over the reference points; lab (points, bits) bool,
    shaped by the caller to broadcast against d2."""
    big = torch.tensor(_BIG, dtype=torch.float32, device=d2.device)
    llrs = []
    for b in range(lab.shape[-1]):
        one = lab[..., b]
        m0 = torch.where(~one, d2, big).amin(dim=axis)
        m1 = torch.where(one, d2, big).amin(dim=axis)
        llrs.append((m1 - m0) / n0)
    return torch.stack(llrs, dim=stack_axis)


def demap(y: torch.Tensor, sigma, modulation: str) -> torch.Tensor:
    """Batch-first received symbols -> per-bit float32 LLRs (..., n).
    Max-log beyond BPSK. sigma: scalar or per-codeword (B,)."""
    sb = _bcast_first(_sigma32(sigma, y.device), y)
    if modulation == "bpsk":
        return 2.0 * y / (sb * sb)
    n0 = 2.0 * sb * sb
    _, pts, labels = _tables(modulation)
    lab = _t(labels, y)
    if modulation in _GENERIC:
        pj = _t(pts, y)                                            # (M, 2)
        d2 = ((y[..., None, :] - pj) ** 2).sum(dim=-1)       # (..., nsym, M)
        n0b = n0 if n0.ndim == 0 else n0.squeeze(-1)
        return _maxlog(d2, lab, -1, n0b, -1).reshape(y.shape[:-2] + (-1,))
    d2 = (y[..., None] - _t(pts, y)) ** 2                 # (..., nsym, 2, L)
    return _maxlog(d2, lab, -1, n0, -1).reshape(y.shape[:-2] + (-1,))


def demap_t(y: torch.Tensor, sigma, modulation: str) -> torch.Tensor:
    """Batch-last received symbols -> per-bit float32 LLRs (n, B).

    y: (n, B) for BPSK, (nsym, 2, B) otherwise (modulate_t's layout).
    sigma: scalar or per-lane (B,). The same distances and masked minima
    as `demap`, so the two agree bit for bit."""
    s = _sigma32(sigma, y.device)
    if modulation == "bpsk":
        return 2.0 * y / (s * s)
    B = y.shape[-1]
    n0 = 2.0 * s * s
    _, pts, labels = _tables(modulation)
    lab = _t(labels, y)[:, None, :]                       # (points, 1, bits)
    if modulation in _GENERIC:
        pI, pQ = _t(pts[:, 0].copy(), y), _t(pts[:, 1].copy(), y)
        d2 = ((y[:, 0, None, :] - pI[:, None]) ** 2
              + (y[:, 1, None, :] - pQ[:, None]) ** 2)          # (nsym, M, B)
        return _maxlog(d2, lab, 1, n0, 1).reshape(-1, B)
    lev = _t(pts, y)
    d2 = (y[:, :, None, :] - lev[None, None, :, None]) ** 2    # (nsym,2,L,B)
    return _maxlog(d2, lab, 2, n0, 2).reshape(-1, B)


def bsc(generator: Optional[torch.Generator], bits: torch.Tensor, p,
        flips: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary symmetric channel: flip each bit independently with
    probability p (the hard fault injector). flips: injected 0/1 draws of
    bits' shape (tests)."""
    if flips is None:
        if generator is None:
            raise ValueError("bsc needs a torch.Generator or injected flips")
        u = torch.rand(bits.shape, generator=generator, device=bits.device,
                       dtype=torch.float32)
        flips = u < _sigma32(p, bits.device)
    return torch.bitwise_xor(bits.to(torch.uint8), flips.to(torch.uint8))


def bsc_llr(bits: torch.Tensor, p) -> torch.Tensor:
    """Channel LLRs for hard BSC observations: (1 - 2y) * log((1-p)/p)
    (> 0 favors bit 0, as the demappers)."""
    p = _sigma32(p, bits.device)
    mag = torch.log((1.0 - p) / p)
    return (1 - 2 * bits.to(torch.float32)) * mag
