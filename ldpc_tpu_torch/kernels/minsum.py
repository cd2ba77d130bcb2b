"""On-chip min-sum flooding decoder (counterpart of
`ldpc_tpu/kernels/minsum_pallas.py`).

`make_decoder` mirrors `minsum_pallas.make_decoder` for the fixed-iteration
flooding form of its kernel (K1), including the fused-IO form (K1-IO:
float32 LLRs quantized in the kernel, per-lane info-bit error counts
out). It returns a `MinsumDecoder` that holds both versions:

  * `kernel`: the hand-written CUDA kernel `csrc/minsum_flood.cu`, built
    with nvcc at first launch (`build.py`), on CUDA tensors only;
  * `plain`: the plain torch version, `ops/decode_ref` (+ `ops/quantize`
    and counting in fused-IO mode), on tensors of any device.

Calling the decoder dispatches by the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises. Nothing
falls back. The module counts `kernel_launches` (one per launch) and
`plain_calls` (one per plain call).

Layout is the reference's pre-transposed one, batch last:
  decode(chan (nb, Z, B))            -> (hard (nb, Z, B) uint8,
                                         iters (B,) int32, conv (B,) bool)
  decode(chan (nb, Z, B), info (kb, Z, B) uint8), with count_info_cols=kb
                                     -> (bit_errs (B,) int32,
                                         frame_err (B,) int32, iters, conv)
chan is int8, or float32 when input_scale is set.

Not ported yet, and raising NotImplementedError on CUDA: per-lane early
termination (ROADMAP kernel K2), the layered schedule (K3, which the plain
version lacks too) and min* (K5).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ldpc_tpu.config import DecoderConfig, QuantConfig, cn_params

from ..codes import CodeTensors
from ..ops.decode_ref import make_flooding_decoder
from ..ops.quantize import quantize
from . import build

kernel_launches = 0
plain_calls = 0

LIBRARY = "minsum_flood"
SOURCE = "ldpc_tpu_torch/kernels/csrc/minsum_flood.cu"
REPLACES = "ldpc_tpu/kernels/minsum_pallas.py:390"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0


def load_library(rebuild: bool = False) -> build.Library:
    """Build (first use) and bind the kernel library."""
    lib = build.load(LIBRARY, rebuild=rebuild)
    c = lib.cdll
    c.minsum_flood_launch.argtypes = [
        _P, _I, _F, _P, _I, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    c.minsum_flood_launch.restype = _I
    c.minsum_flood_config.argtypes = [_I, _I, _I, _I,
                                      ctypes.POINTER(_I), ctypes.POINTER(_I)]
    c.minsum_flood_config.restype = _I
    c.minsum_flood_error_string.argtypes = [_I]
    c.minsum_flood_error_string.restype = ctypes.c_char_p
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
    """Fixed-iteration flooding min-sum decoder for one code and config."""

    def __init__(self, ct: CodeTensors, dec: DecoderConfig,
                 quant: QuantConfig, input_scale: Optional[float],
                 count_info_cols: Optional[int]):
        if dec.algorithm == "min-star":
            raise NotImplementedError(
                "min-star: the min* CN update is ROADMAP kernel K5, not "
                "ported yet")
        if dec.schedule != "flooding":
            raise NotImplementedError(
                f"schedule {dec.schedule!r}: the layered decoder is ROADMAP "
                f"kernel K3 (and module item 5 for its plain version), not "
                f"ported yet")
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
        self._plain = make_flooding_decoder(
            ct.code, max_iter=dec.max_iter, beta=self.beta, qmax=quant.qmax,
            early_term=dec.early_term, alpha=self.alpha)
        self._tables_np = kernel_tables(ct)
        self._tables: Dict[torch.device, torch.Tensor] = {}
        row_deg = np.diff(self._tables_np[: ct.mb + 1])
        col_deg = np.bincount([c for row in ct.entries for c, _, _ in row],
                              minlength=ct.nb)
        # The kernel keeps totals in int16: |chan| <= 128 plus dv messages
        # of magnitude <= qmax must stay below 2**15.
        self._kernel_domain = (
            None if row_deg.min() >= 2
            and 128 + int(col_deg.max()) * quant.qmax < 2 ** 15
            else f"{ct.code.name}: the kernel needs base-row degrees >= 2 "
                 f"and int16-safe totals")

    @property
    def counting(self) -> bool:
        return self.count_info_cols is not None

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
        if self.dec.early_term:
            raise NotImplementedError(
                "early_term=True on CUDA: per-lane early termination is "
                "ROADMAP kernel K2, not ported yet")
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
        lib = load_library().cdll
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
            err = lib.minsum_flood_launch(
                ptr(chan), int(self.input_scale is not None),
                float(self.input_scale or 0.0), ptr(info),
                self.count_info_cols or 0, ptr(hard), ptr(bits), ptr(frame),
                ptr(iters), ptr(conv), ptr(tables), B, ct.nb, ct.Z, ct.mb,
                ct.n_entries, self.dec.max_iter, self.quant.qmax, self.beta,
                num, shift, stream)
        if err:
            msg = lib.minsum_flood_error_string(err).decode()
            raise RuntimeError(f"minsum_flood launch failed: {msg} ({err})")
        kernel_launches += 1
        if self.counting:
            return bits, frame, iters, conv
        return hard, iters, conv

    def launch_config(self) -> Tuple[int, int]:
        """(codeword lanes per block, dynamic shared-memory bytes) that the
        kernel uses for this code; builds the library."""
        lanes, smem = ctypes.c_int(0), ctypes.c_int(0)
        load_library().cdll.minsum_flood_config(
            self.ct.nb, self.ct.Z, self.ct.mb, self.ct.n_entries,
            ctypes.byref(lanes), ctypes.byref(smem))
        return lanes.value, smem.value


def make_decoder(ct: CodeTensors, dec: DecoderConfig, quant: QuantConfig,
                 *, input_scale: Optional[float] = None,
                 count_info_cols: Optional[int] = None) -> MinsumDecoder:
    """Factory from configs, mirroring `minsum_pallas.make_decoder`;
    (beta, alpha) come from `config.cn_params`."""
    return MinsumDecoder(ct, dec, quant, input_scale, count_info_cols)
