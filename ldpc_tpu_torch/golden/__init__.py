"""Golden GF(2) encoder of the port (the decoders of `ldpc_tpu/golden/` stay
the tests' witness and are not copied)."""
from .encoder import encode, systematic_form  # noqa: F401
