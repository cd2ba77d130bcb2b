"""The Monte-Carlo megakernel's random stream (no file counterpart in
ldpc_tpu, whose megakernel draws from the TPU's hardware PRNG,
`kernels/minsum_pallas.py:437-482`): Philox4x32-10 in plain torch, the
plain version of `kernels/csrc/philox.cuh`.

Stream contract. A batch is keyed by one 64-bit seed: key = (seed & 0xffffffff,
seed >> 32). Word w of codeword lane b is output w % 4 of the Philox block
at counter (w // 4, b & 0xffffffff, b >> 32, 0). The words of a lane are
therefore a function of (seed, b, w) alone: they do not depend on the lanes
per block, the batch size or a later split of the batch over devices (the
reference's mesh-invariance contract, `sim/pipeline.py:415-434`, without
its tile-size proviso).

Word layout per lane (`word_layout`): k info words (bit = word & 1), then
nph * Z words n1 and nph * Z words n2 of the Box-Muller pairs, nph =
ceil(nb / 2) (`minsum_pallas.py:381,484-486,540-542`).

The arithmetic runs on int64 tensors holding uint32 values. A 32 x 32-bit
product overflows int64, so `_mulhilo` splits the multiplier into 16-bit
halves. The words come out the same on any device.
"""
from __future__ import annotations

from typing import Tuple

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments
ROUNDS = 10
_MASK = 0xFFFFFFFF


def word_layout(kb: int, nb: int, Z: int) -> Tuple[int, int, int]:
    """(k, nph, words per lane): info words [0, k), n1 words [k, k +
    nph*Z), n2 words [k + nph*Z, k + 2*nph*Z)."""
    nph = (nb + 1) // 2
    return kb * Z, nph, kb * Z + 2 * nph * Z


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of m * x for a uint32 constant m and int64 x
    holding uint32: m = mh * 2**16 + ml, so each partial product is < 2**48."""
    mh, ml = m >> 16, m & 0xFFFF
    a = x * ml
    c = x * mh
    lo = (((c & 0xFFFF) << 16) + a) & _MASK
    hi = (c + (a >> 16)) >> 16
    return hi, lo


def philox4x32(ctr: Tuple[torch.Tensor, ...], key: Tuple[int, int]
               ) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 on counters (c0, c1, c2, c3), int64 tensors of one
    shape holding uint32 values, under key (k0, k1): four int64 tensors of
    uint32 outputs (Random123's philox4x32_R(10, ...))."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & _MASK, (k1 + W1) & _MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def words(seed: int, n_words: int, batch: int, device, lane0: int = 0
          ) -> torch.Tensor:
    """(n_words, batch) int32 words of lanes [lane0, lane0 + batch) (the
    bits of each uint32 word, reinterpreted)."""
    dev = torch.device(device)
    seed = int(seed) & ((1 << 64) - 1)
    blocks = -(-n_words // 4)
    blk = torch.arange(blocks, dtype=torch.int64, device=dev)[:, None]
    lane = torch.arange(lane0, lane0 + batch, dtype=torch.int64,
                        device=dev)[None, :]
    shape = (blocks, batch)
    out = philox4x32((blk.expand(shape), (lane & _MASK).expand(shape),
                      (lane >> 32).expand(shape),
                      torch.zeros(shape, dtype=torch.int64, device=dev)),
                     (seed & _MASK, seed >> 32))
    w = torch.stack(out, dim=1).reshape(4 * blocks, batch)[:n_words]
    # uint32 -> the int32 of the same bits
    return (w - ((w >> 31) << 32)).to(torch.int32)
