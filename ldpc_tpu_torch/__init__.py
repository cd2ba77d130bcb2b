"""ldpc_tpu_torch — the PyTorch/CUDA port of ldpc_tpu for NVIDIA Hopper.

Counterpart of `ldpc_tpu/__init__.py`. The port runs the simulation step
(info bits -> GF(2) encode -> modulate -> AWGN -> demap -> quantize ->
fixed-point min-sum or min* decode, flooding or layered -> info-bit error
counters) with PyTorch tensors, and the decode, or with `rng="device"` the
whole step, as hand-written CUDA kernels (`kernels/csrc/`) on a CUDA device.

It imports torch and numpy only: never `jax`, and nothing of `ldpc_tpu`.
The configs, code tables and the golden encoder are the port's own copies
(`config.py`, `codes/`, `golden/`), under the reference's names; a config
or a code crosses between the packages by value
(`codes.config_from_reference`, `codes.from_reference`).
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    PRESETS,
    ChannelConfig,
    CodeConfig,
    DecoderConfig,
    QuantConfig,
    RunConfig,
    SimConfig,
    cn_params,
    minstar_thresholds,
)

from .device import resolve_device  # noqa: F401

__all__ = ["PRESETS", "ChannelConfig", "CodeConfig", "DecoderConfig",
           "QuantConfig", "RunConfig", "SimConfig", "cn_params",
           "minstar_thresholds", "resolve_device"]
