"""Golden models of the port: bit-exact fixed-point and float NumPy decoders
and the GF(2) encoder (copies of `ldpc_tpu/golden/`)."""
from .decoder import (  # noqa: F401
    DecodeResult, decode_fixed, decode_float, decode_hard, quantize)
from .encoder import encode, systematic_form  # noqa: F401
