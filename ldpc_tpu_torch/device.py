"""Device resolution for the port (no counterpart file in ldpc_tpu, where
`sim/pipeline.select_decoder` reads `jax.default_backend()` instead).

The port never picks a device on its own and never falls back: a caller
that asks for CUDA gets CUDA or an error, so a run that was meant for the
card cannot silently measure the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """Return exactly the device that was asked for.

    Raises RuntimeError when a CUDA device is requested and PyTorch sees
    no CUDA device, and ValueError for device types the port does not run
    on (it runs on "cpu" and "cuda")."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but "
                f"torch.cuda.is_available() is False; the port does not "
                f"fall back to the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}: the port "
                         f"runs on 'cpu' and 'cuda'")
    return dev
