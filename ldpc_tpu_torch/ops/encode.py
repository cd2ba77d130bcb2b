"""Batched GF(2) systematic encoders (counterpart of `ldpc_tpu/ops/encode.py`
and of `ldpc_tpu/codes/qcstruct.make_qc_encoder`).

Two paths:

  * dense, for n <= 4096 (every 802.11n code): parity = (P @ info) mod 2
    against the systematic form of `golden.encoder.systematic_form`. P is
    0/1 and every sum is at most k < 2**24, so a float32 matmul is exact;
  * structured, for QC codes with the dual-diagonal parity skeleton that
    `codes/qcstruct.detect_enc_struct` recognises: `make_qc_encoder_t`,
    rolls and XORs over (kb, Z, B) blocks, bit-exact with
    `qcstruct.qc_encode_numpy`. It encodes above n = 4096, where the dense
    systematic form is not built, and it is the encoder of the Monte-Carlo
    megakernel's plain version (`ops/mc.py`).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, List, Optional

import numpy as np
import torch

from ..codes.code import LDPCCode

if TYPE_CHECKING:
    from ..codes import CodeTensors

DENSE_MAX_N = 4096


def has_qc_struct(code: LDPCCode) -> bool:
    if code.base is None or code.Z is None:
        return False
    from ..codes.qcstruct import detect_enc_struct
    return detect_enc_struct(code.base) is not None


def info_positions(code: LDPCCode) -> np.ndarray:
    """Codeword positions of the k information bits."""
    if has_qc_struct(code) and code.n > DENSE_MAX_N:
        return np.arange(code.k)
    from ..golden.encoder import systematic_form
    _, perm = systematic_form(code)
    return np.asarray(perm[: code.k])


def make_qc_encoder_t(code: LDPCCode
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batch-last structured encoder: encode_t(info_t (k, B) uint8) ->
    codeword (n, B) uint8 on info_t's device; the info bits are the
    codeword's prefix. Check row r of circulant C(s) reads variable
    (r + s) % Z, so C(s) x = roll(x, -s) along Z."""
    from ..codes.qcstruct import detect_enc_struct
    st = detect_enc_struct(code.base) if code.base is not None else None
    if st is None:
        raise ValueError(f"{code.name}: no encodable QC parity structure")
    base, Z = code.base, int(code.Z)
    mb, nb = base.shape
    kb, cb = st.kb, st.cb

    def lam(row: int, blocks: List[torch.Tensor], upto: int) -> torch.Tensor:
        out: Optional[torch.Tensor] = None
        for j in range(upto):
            s = int(base[row, j])
            if s >= 0:
                v = torch.roll(blocks[j], -s, dims=0)
                out = v if out is None else out ^ v
        return out if out is not None else torch.zeros_like(blocks[0])

    def encode_t(info_t: torch.Tensor) -> torch.Tensor:
        B = info_t.shape[1]
        x = list(info_t.to(torch.uint8).reshape(kb, Z, B).unbind(0))
        lam_core = [lam(i, x, kb) for i in range(cb)]
        p0 = lam_core[0]
        for t in lam_core[1:]:
            p0 = p0 ^ t
        pars = [p0]
        for t in range(cb - 1):
            acc = lam_core[t]
            s0 = int(base[t, kb])
            if s0 >= 0:
                acc = acc ^ torch.roll(p0, -s0, dims=0)
            if t > 0:
                acc = acc ^ pars[t]
            pars.append(acc)
        full = x + pars
        for e in range(cb, mb):
            pars.append(lam(e, full, kb + cb))
        return torch.stack(x + pars).reshape(nb * Z, B)

    return encode_t


def make_encoder_t(ct: "CodeTensors"
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batch-last encoder: encode_t(info_t (k, B) uint8) -> codeword (n, B)
    uint8, on ct's device: dense up to n = 4096, structured above."""
    if ct.P is None:
        return make_qc_encoder_t(ct.code)
    P, perm = ct.P, ct.perm
    if ct.device.type == "cuda":
        # 0/1 products are exact even in TF32, but pin full float32 so the
        # parity product never depends on a caller's global setting.
        torch.backends.cuda.matmul.allow_tf32 = False

    def encode_t(info_t: torch.Tensor) -> torch.Tensor:
        acc = P @ info_t.to(torch.float32)                   # (m, B)
        parity = (acc.to(torch.int32) & 1).to(torch.uint8)
        c = torch.cat([info_t.to(torch.uint8), parity], dim=0)
        if perm is not None:
            out = torch.zeros_like(c)
            out[perm] = c
            c = out
        return c

    return encode_t


def make_encoder(ct: "CodeTensors"
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batch-first encoder: encode(info (B, k) uint8) -> codeword (B, n)."""
    encode_t = make_encoder_t(ct)
    return lambda info: encode_t(info.T).T.contiguous()
