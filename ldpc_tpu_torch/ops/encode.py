"""Batched GF(2) systematic encoders (counterpart of `ldpc_tpu/ops/encode.py`).

Only the dense path is ported: parity = (P @ info) mod 2 against the
systematic form of `golden.encoder.systematic_form`, for n <= 4096 (every
802.11n code). P is 0/1 and every sum is at most k < 2**24, so a float32
matmul is exact. The structured QC encoder that the reference uses above
n = 4096 (`codes/qcstruct.make_qc_encoder`) is ROADMAP module item 3 and
raises NotImplementedError here.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from ldpc_tpu.codes.code import LDPCCode

if TYPE_CHECKING:
    from ..codes import CodeTensors

DENSE_MAX_N = 4096


def has_qc_struct(code: LDPCCode) -> bool:
    if code.base is None or code.Z is None:
        return False
    from ldpc_tpu.codes.qcstruct import detect_enc_struct
    return detect_enc_struct(code.base) is not None


def info_positions(code: LDPCCode) -> np.ndarray:
    """Codeword positions of the k information bits."""
    if has_qc_struct(code) and code.n > DENSE_MAX_N:
        return np.arange(code.k)
    from ldpc_tpu.golden.encoder import systematic_form
    _, perm = systematic_form(code)
    return np.asarray(perm[: code.k])


def _dense_parts(ct: "CodeTensors"):
    if ct.P is None:
        raise NotImplementedError(
            f"{ct.code.name}: n={ct.n} > {DENSE_MAX_N} needs the structured "
            f"QC encoder (ROADMAP module item 3, codes/qcstruct."
            f"make_qc_encoder), which is not ported yet")
    if ct.device.type == "cuda":
        # 0/1 products are exact even in TF32, but pin full float32 so the
        # parity product never depends on a caller's global setting.
        torch.backends.cuda.matmul.allow_tf32 = False
    return ct.P, ct.perm


def make_encoder_t(ct: "CodeTensors"
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batch-last encoder: encode_t(info_t (k, B) uint8) -> codeword (n, B)
    uint8, on ct's device."""
    P, perm = _dense_parts(ct)

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
