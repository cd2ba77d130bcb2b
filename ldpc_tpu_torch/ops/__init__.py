"""Tensor ops of the port: quantizer, encoder, channels, reference and
hard-decision decoders (counterparts of `ldpc_tpu/ops/`)."""
from .decode_hard import make_hard_decoder  # noqa: F401

__all__ = ["make_hard_decoder"]
