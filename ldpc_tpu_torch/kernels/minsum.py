"""On-chip min-sum decoders (counterpart of
`ldpc_tpu/kernels/minsum_pallas.py`).

`make_decoder` mirrors `minsum_pallas.make_decoder` for the min-sum family
of its VMEM kernel: flooding with fixed iterations (K1) or per-lane early
termination (K2), and the layered schedule with either (K3), each also in
the fused-IO form (K1-IO: float32 LLRs quantized in the kernel, per-lane
info-bit error counts out). It returns a `MinsumDecoder` that holds both
versions:

  * `kernel`: a hand-written CUDA kernel, `csrc/minsum_flood.cu` for
    flooding or `csrc/minsum_layered.cu` for layered, built with nvcc at
    first launch (`build.py`), on CUDA tensors only;
  * `plain`: the plain torch version, `ops/decode_ref` (+ `ops/quantize`
    and counting in fused-IO mode), on tensors of any device.

Calling the decoder dispatches by the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises. Nothing
falls back. The module counts `kernel_launches` (one per launch, and per
library in `library_launches`) and `plain_calls` (one per plain call).

Layout is the reference's pre-transposed one, batch last:
  decode(chan (nb, Z, B))            -> (hard (nb, Z, B) uint8,
                                         iters (B,) int32, conv (B,) bool)
  decode(chan (nb, Z, B), info (kb, Z, B) uint8), with count_info_cols=kb
                                     -> (bit_errs (B,) int32,
                                         frame_err (B,) int32, iters, conv)
chan is int8, or float32 when input_scale is set.

Not ported yet: the min* CN update (ROADMAP kernel K5), which raises
NotImplementedError.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ldpc_tpu.config import DecoderConfig, QuantConfig, cn_params

from ..codes import CodeTensors
from ..ops.decode_ref import make_decoder as make_plain_decoder
from ..ops.quantize import quantize
from . import build

# The kernel library of each schedule, its source and the Pallas code it
# replaces (the kernel body, and for layered its layered_iter).
LIBRARIES = {"flooding": "minsum_flood", "layered": "minsum_layered"}
SOURCES = {lib: f"ldpc_tpu_torch/kernels/csrc/{lib}.cu"
           for lib in LIBRARIES.values()}
REPLACES = {"minsum_flood": "ldpc_tpu/kernels/minsum_pallas.py:390",
            "minsum_layered": "ldpc_tpu/kernels/minsum_pallas.py:823"}

kernel_launches = 0
plain_calls = 0
library_launches = dict.fromkeys(SOURCES, 0)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0
    for lib in SOURCES:
        library_launches[lib] = 0


def load_library(name: str, rebuild: bool = False) -> build.Library:
    """Build (first use) and bind kernel library `name` (a value of
    LIBRARIES); both export <name>_launch, _config and _error_string."""
    lib = build.load(name, rebuild=rebuild)
    c = lib.cdll
    launch = getattr(c, f"{name}_launch")
    launch.argtypes = [_P, _I, _F, _P, _I, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    launch.restype = _I
    config = getattr(c, f"{name}_config")
    config.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I),
                       ctypes.POINTER(_I)]
    config.restype = _I
    err = getattr(c, f"{name}_error_string")
    err.argtypes = [_I]
    err.restype = ctypes.c_char_p
    return lib


def kernel_tables(ct: CodeTensors) -> np.ndarray:
    """The kernel's int32 entry tables: layer_ptr[mb+1], ent_col[E],
    ent_shift[E], col_ptr[nb+1], col_ent[E] (entry ids by base column)."""
    cols, shifts, layer_ptr = [], [], [0]
    for row in ct.entries:
        for col, shift, eid in row:
            assert eid == len(cols)
            cols.append(col)
            shifts.append(shift)
        layer_ptr.append(len(cols))
    cols_np = np.asarray(cols, np.int64)
    col_ent = np.argsort(cols_np, kind="stable")
    col_ptr = np.searchsorted(cols_np[col_ent], np.arange(ct.nb + 1))
    return np.concatenate([layer_ptr, cols, shifts, col_ptr,
                           col_ent]).astype(np.int32)


class MinsumDecoder:
    """Min-sum decoder (flooding or layered, fixed iterations or early
    termination) for one code and config."""

    def __init__(self, ct: CodeTensors, dec: DecoderConfig,
                 quant: QuantConfig, input_scale: Optional[float],
                 count_info_cols: Optional[int]):
        if dec.algorithm == "min-star":
            raise NotImplementedError(
                "min-star: the min* CN update is ROADMAP kernel K5, not "
                "ported yet")
        if dec.schedule not in LIBRARIES:
            raise ValueError(f"unknown schedule {dec.schedule!r}")
        if count_info_cols is not None:
            if not ct.ident_info:
                raise ValueError(f"{ct.code.name}: in-kernel counting needs "
                                 f"the info bits to be the identity prefix")
            if not 0 < count_info_cols <= ct.nb:
                raise ValueError(f"count_info_cols={count_info_cols} outside "
                                 f"(0, nb={ct.nb}]")
        self.ct = ct
        self.dec = dec
        self.quant = quant
        self.beta, self.alpha = cn_params(dec, quant)
        self.input_scale = input_scale
        self.count_info_cols = count_info_cols
        self.library = LIBRARIES[dec.schedule]
        self._plain = make_plain_decoder(ct.code, dec, quant)
        self._tables_np = kernel_tables(ct)
        self._tables: Dict[torch.device, torch.Tensor] = {}
        row_deg = np.diff(self._tables_np[: ct.mb + 1])
        col_deg = np.bincount([c for row in ct.entries for c, _, _ in row],
                              minlength=ct.nb)
        # The kernels keep totals (flooding) or posteriors (layered) in
        # int16: |chan| <= 128 plus dv messages of magnitude <= qmax must
        # stay below 2**15.
        self._kernel_domain = (
            None if row_deg.min() >= 2
            and 128 + int(col_deg.max()) * quant.qmax < 2 ** 15
            else f"{ct.code.name}: the kernel needs base-row degrees >= 2 "
                 f"and int16-safe posteriors")

    @property
    def counting(self) -> bool:
        return self.count_info_cols is not None

    @property
    def batch_tile(self) -> int:
        """The batch granularity: codeword lanes per block of the kernel
        on a CUDA code (builds the library), 1 for the plain version."""
        return self.launch_config()[0] if self.ct.device.type == "cuda" else 1

    def _check(self, chan: torch.Tensor, info: Optional[torch.Tensor]) -> int:
        ct = self.ct
        want = torch.float32 if self.input_scale is not None else torch.int8
        if chan.dtype != want:
            raise TypeError(f"chan dtype {chan.dtype}, expected {want}")
        if chan.ndim != 3 or tuple(chan.shape[:2]) != (ct.nb, ct.Z):
            raise ValueError(f"chan shape {tuple(chan.shape)}, expected "
                             f"({ct.nb}, {ct.Z}, B)")
        B = int(chan.shape[2])
        if (info is not None) != self.counting:
            raise ValueError("info must be given exactly when "
                             "count_info_cols is set")
        if info is not None:
            if info.dtype != torch.uint8:
                raise TypeError(f"info dtype {info.dtype}, expected uint8")
            if tuple(info.shape) != (self.count_info_cols, ct.Z, B):
                raise ValueError(f"info shape {tuple(info.shape)}, expected "
                                 f"({self.count_info_cols}, {ct.Z}, {B})")
            if info.device != chan.device:
                raise ValueError(f"info on {info.device}, chan on "
                                 f"{chan.device}")
        return B

    def __call__(self, chan: torch.Tensor,
                 info: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        if chan.device.type == "cpu":
            return self.plain(chan, info)
        return self.kernel(chan, info)

    def plain(self, chan: torch.Tensor,
              info: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        """The plain torch version, on chan's device."""
        global plain_calls
        B = self._check(chan, info)
        plain_calls += 1
        ct = self.ct
        q = chan
        if self.input_scale is not None:
            q = quantize(chan, dataclasses.replace(self.quant,
                                                   scale=self.input_scale))
        hard, iters, conv = self._plain(q.reshape(ct.n, B).T)   # (B, n)
        if not self.counting:
            return hard.T.reshape(ct.nb, ct.Z, B).contiguous(), iters, conv
        k = self.count_info_cols * ct.Z
        err = hard[:, :k] ^ info.reshape(k, B).T
        bits = err.sum(dim=1, dtype=torch.int32)
        return bits, (bits > 0).to(torch.int32), iters, conv

    def kernel(self, chan: torch.Tensor,
               info: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        """Launch the CUDA kernel on the current stream of chan's device."""
        global kernel_launches
        B = self._check(chan, info)
        if self._kernel_domain is not None:
            raise NotImplementedError(self._kernel_domain)
        dev = chan.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
        if not chan.is_contiguous() or (info is not None
                                        and not info.is_contiguous()):
            raise ValueError("the kernel needs contiguous chan and info")
        if B >= 2 ** 31:
            raise ValueError(f"batch {B} too large for one launch")
        name = self.library
        lib = load_library(name).cdll
        ct = self.ct
        if dev not in self._tables:
            self._tables[dev] = torch.as_tensor(self._tables_np, device=dev)
        tables = self._tables[dev]
        iters = torch.empty(B, dtype=torch.int32, device=dev)
        conv = torch.empty(B, dtype=torch.bool, device=dev)
        if self.counting:
            hard = None
            bits = torch.empty(B, dtype=torch.int32, device=dev)
            frame = torch.empty(B, dtype=torch.int32, device=dev)
        else:
            hard = torch.empty((ct.nb, ct.Z, B), dtype=torch.uint8,
                               device=dev)
            bits = frame = None

        def ptr(t):
            return None if t is None else t.data_ptr()

        num, shift = self.alpha if self.alpha is not None else (1, 0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, f"{name}_launch")(
                ptr(chan), int(self.input_scale is not None),
                float(self.input_scale or 0.0), ptr(info),
                self.count_info_cols or 0, ptr(hard), ptr(bits), ptr(frame),
                ptr(iters), ptr(conv), ptr(tables), B, ct.nb, ct.Z, ct.mb,
                ct.n_entries, self.dec.max_iter, int(self.dec.early_term),
                self.quant.qmax, self.beta, num, shift, stream)
        if err:
            msg = getattr(lib, f"{name}_error_string")(err).decode()
            raise RuntimeError(f"{name} launch failed: {msg} ({err})")
        kernel_launches += 1
        library_launches[name] += 1
        if self.counting:
            return bits, frame, iters, conv
        return hard, iters, conv

    def launch_config(self) -> Tuple[int, int]:
        """(codeword lanes per block, dynamic shared-memory bytes) that the
        kernel uses for this code; builds the library."""
        lanes, smem = ctypes.c_int(0), ctypes.c_int(0)
        config = getattr(load_library(self.library).cdll,
                         f"{self.library}_config")
        config(self.ct.nb, self.ct.Z, self.ct.mb, self.ct.n_entries,
               ctypes.byref(lanes), ctypes.byref(smem))
        return lanes.value, smem.value


def make_decoder(ct: CodeTensors, dec: DecoderConfig, quant: QuantConfig,
                 *, input_scale: Optional[float] = None,
                 count_info_cols: Optional[int] = None) -> MinsumDecoder:
    """Factory from configs, mirroring `minsum_pallas.make_decoder`;
    (beta, alpha) come from `config.cn_params`."""
    return MinsumDecoder(ct, dec, quant, input_scale, count_info_cols)
