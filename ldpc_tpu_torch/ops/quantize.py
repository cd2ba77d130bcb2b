"""Fixed-point LLR quantization (counterpart of `ldpc_tpu/ops/quantize.py`).

Bit-exact with `ldpc_tpu.ops.quantize.quantize` and
`ldpc_tpu.golden.decoder.quantize` on identical float32 inputs: scale in
float32, round half away from zero as where(x >= 0, floor(x + 0.5),
ceil(x - 0.5)), clip to +-qmax, cast to int8. `torch.round` rounds half to
even and is the wrong primitive here.
"""
from __future__ import annotations

import torch

from ..config import QuantConfig


def quantize(llr: torch.Tensor, quant: QuantConfig = QuantConfig()
             ) -> torch.Tensor:
    """Float LLRs (any shape) -> int8 fixed point, on llr's device."""
    qmax = quant.qmax
    scaled = llr.to(torch.float32) * quant.scale
    r = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                    torch.ceil(scaled - 0.5))
    return torch.clamp(r, -qmax, qmax).to(torch.int8)


def dequantize(q: torch.Tensor, quant: QuantConfig = QuantConfig()
               ) -> torch.Tensor:
    return q.to(torch.float32) / quant.scale
