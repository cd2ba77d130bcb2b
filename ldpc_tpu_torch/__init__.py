"""ldpc_tpu_torch — the PyTorch/CUDA port of ldpc_tpu for NVIDIA Hopper.

Counterpart of `ldpc_tpu/__init__.py`. The port runs the canonical
simulation step (info bits -> dense GF(2) encode -> BPSK -> AWGN -> demap
-> quantize -> fixed-point min-sum flooding decode -> info-bit error
counters) with PyTorch tensors, and the decode as a hand-written CUDA
kernel (`kernels/csrc/minsum_flood.cu`) on a CUDA device.

It imports torch and numpy and the JAX-free layers of `ldpc_tpu`
(`config`, `codes`, `golden`); never `jax`. Configs are shared with the
reference, not copied: the names below are `ldpc_tpu.config`'s own.
"""

__version__ = "0.1.0"

from ldpc_tpu.config import (  # noqa: F401
    PRESETS,
    ChannelConfig,
    CodeConfig,
    DecoderConfig,
    QuantConfig,
    RunConfig,
    SimConfig,
    cn_params,
)

from .device import resolve_device  # noqa: F401

__all__ = ["PRESETS", "ChannelConfig", "CodeConfig", "DecoderConfig",
           "QuantConfig", "RunConfig", "SimConfig", "cn_params",
           "resolve_device"]
