"""Streaming layered min-sum decoders for long codewords (counterpart of
`ldpc_tpu/kernels/minsum_stream.py`: `make_stream_decoder`,
`make_decoder`).

For codes whose state per codeword exceeds one SM's shared memory (DVB-S2
n=64,800: 129,600 B of int16 posteriors and 227,160 B of int8 messages),
the state lives in device memory. `make_stream_decoder` returns a
`StreamDecoder` that holds both versions:

  * `kernel`: the hand-written CUDA library `csrc/minsum_stream.cu`, one
    template kernel in four instances that answer the reference's five
    Pallas kernels (`INSTANCES`, `REPLACES`), built with nvcc at first
    launch (`build.py`), on CUDA tensors only;
  * `plain`: the plain torch version, `ops/decode_qc` (layered), on tensors
    of any device.

Calling the decoder dispatches by the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises. Nothing
falls back. The module counts `kernel_launches`, `instance_launches` (per
instance) and `plain_calls`.

Batch first, as the reference's:
  decode(chan (B, n) int8) -> (hard (B, n) uint8, iters (B,) int32,
                               conv (B,) bool)
Fixed form: iters = max_iter, conv = the syndrome of the final posteriors.
Early termination: hard bits latched at a lane's first syndrome success,
iters the iterations run until then (0 for a channel word that is a
codeword). min* has no streaming form, as in the reference.

`resident` places the posteriors: True keeps a block's posteriors in
shared memory for the whole decode (only the messages stream), False
streams both, None takes `resident_auto`'s rule.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..codes import CodeTensors
from ..config import DecoderConfig, QuantConfig, cn_params
from ..ops.decode_qc import make_qc_decoder
from . import build
from .minsum import (MAX_SMEM, MAX_THREADS, PREFERRED_SMEM, align16,
                     base_degrees, check_launch, kernel_tables, table_words)

LIBRARY = "minsum_stream"
SOURCE = f"ldpc_tpu_torch/kernels/csrc/{LIBRARY}.cu"
# (resident, early_term) -> the instance's name (`StreamDecoder.variant`)
INSTANCES = {(False, False): "stream", (True, False): "stream-resident",
             (True, True): "stream-resident-et", (False, True): "stream-et"}
# The Pallas kernels each instance answers: (id, pallas_call site).
_SITE = "ldpc_tpu/kernels/minsum_stream.py"
REPLACES = {
    "stream": (("K6b", f"{_SITE}:1295"),            # run-time layer tables
               ("K6c", f"{_SITE}:1279")),           # unrolled at trace time
    "stream-resident": (("K6d", f"{_SITE}:1261"),),
    "stream-resident-et": (("K6e", f"{_SITE}:1182"),),
    "stream-et": (("K6f", f"{_SITE}:1229"),),
}

kernel_launches = 0
plain_calls = 0
instance_launches = dict.fromkeys(INSTANCES.values(), 0)

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0
    for name in instance_launches:
        instance_launches[name] = 0


def load_library(rebuild: bool = False) -> build.Library:
    """Build (first use) and bind the library; it exports
    minsum_stream_launch, _config and _error_string."""
    return bind(build.load(LIBRARY, rebuild=rebuild))


def bind(lib: build.Library) -> build.Library:
    c = lib.cdll
    c.minsum_stream_launch.argtypes = [_P] * 7 + [_I] * 12 + [_P]
    c.minsum_stream_launch.restype = _I
    c.minsum_stream_config.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
    c.minsum_stream_config.restype = _I
    c.minsum_stream_error_string.argtypes = [_I]
    c.minsum_stream_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(ct: CodeTensors, resident: bool, early_term: bool) -> int:
    """Dynamic shared memory of a block, which decodes one codeword (the
    library's smem_bytes): the tables, the syndrome flag, the posteriors
    when they are resident, else, with early termination, a hard-bit byte
    per variable."""
    return (align16(4 * table_words(ct)) + align16(4)
            + (align16(2 * ct.n) if resident else 0)
            + (align16(ct.n) if early_term and not resident else 0))


def block_fits(ct: CodeTensors, resident: bool, early_term: bool) -> bool:
    """Whether the block of Z threads fits 1024 threads and the
    shared-memory opt-in (the library's block_fits)."""
    return (0 < ct.Z <= MAX_THREADS
            and smem_bytes(ct, resident, early_term) <= MAX_SMEM)


def resident_auto(ct: CodeTensors, early_term: bool) -> bool:
    """Where `resident=None` puts the posteriors: in shared memory when a
    block's share leaves room for two blocks an SM (113 KB), else in
    device memory. Measured (`probe_stream.py`, H100, B = 1,024, 20
    iterations): at n=16,200 (34 KB a block) resident 3.6 against 4.3 ms;
    at n=64,800 (138 KB: one 360-thread block an SM) resident 29.3
    against 19.4 ms streamed."""
    return smem_bytes(ct, True, early_term) <= PREFERRED_SMEM


def stream_domain(ct: CodeTensors, qmax: int) -> Optional[str]:
    """None when the streaming library takes the code, else why not: base
    rows of degree 1 (min2 would stay at its sentinel and be cut through
    int8), or posteriors that leave int16."""
    row_deg, col_deg = base_degrees(ct)
    if row_deg < 2:
        return (f"{ct.code.name}: degree-1 base rows unsupported in the "
                f"streaming kernel")
    if 128 + col_deg * qmax >= 2 ** 15:
        return (f"{ct.code.name}: posteriors of column degree "
                f"{col_deg} at qmax {qmax} leave int16")
    return None


class StreamDecoder:
    """Layered min-sum-family decoder with its state in device memory, for
    one code and configuration, in one of the four instances."""
    counting = False        # hard bits out, never in-kernel error counts
    batch_tile = 1          # a block decodes one codeword: any batch size

    def __init__(self, ct: CodeTensors, max_iter: int, beta: int, qmax: int,
                 alpha, resident: Optional[bool], early_term: bool):
        if ct.code.base is None or ct.code.Z is None:
            raise ValueError(f"{ct.code.name}: streaming decoder requires "
                             f"QC structure")
        why = stream_domain(ct, qmax)
        if why:
            raise ValueError(why)
        if resident is None:
            resident = resident_auto(ct, early_term)
        self.ct, self.max_iter, self.beta, self.qmax = ct, max_iter, beta, qmax
        self.alpha = alpha
        self.resident, self.early_term = bool(resident), bool(early_term)
        self.variant = INSTANCES[self.resident, self.early_term]
        if not block_fits(ct, self.resident, self.early_term):
            raise ValueError(
                f"{ct.code.name}: a block of the {self.variant} instance "
                f"does not fit {MAX_THREADS} threads and {MAX_SMEM} B of "
                f"shared memory")
        self._plain = make_qc_decoder(
            ct.code, max_iter=max_iter, beta=beta, qmax=qmax,
            schedule="layered", early_term=early_term, alpha=alpha)
        self._tables_np = kernel_tables(ct)
        self._tables: Dict[torch.device, torch.Tensor] = {}
        self._scratch: Dict[Tuple[torch.device, int], tuple] = {}

    def _check(self, chan: torch.Tensor) -> int:
        if chan.dtype != torch.int8:
            raise TypeError(f"chan dtype {chan.dtype}, expected torch.int8")
        if chan.ndim != 2 or chan.shape[1] != self.ct.n:
            raise ValueError(f"chan shape {tuple(chan.shape)}, expected "
                             f"(B, {self.ct.n})")
        return int(chan.shape[0])

    def __call__(self, chan: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if chan.device.type == "cpu":
            return self.plain(chan)
        return self.kernel(chan)

    def plain(self, chan: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The plain torch version, on chan's device."""
        global plain_calls
        self._check(chan)
        plain_calls += 1
        return self._plain(chan)

    def kernel(self, chan: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Launch the CUDA kernel on the current stream of chan's device."""
        global kernel_launches
        B = self._check(chan)
        if chan.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                             f"{chan.device}")
        if not chan.is_contiguous():
            raise ValueError("the kernel needs a contiguous chan")
        lib = load_library().cdll
        with torch.cuda.device(chan.device):
            stream = torch.cuda.current_stream(chan.device).cuda_stream
            out = self._launch(lib, chan, B, stream)
        kernel_launches += 1
        instance_launches[self.variant] += 1
        return out

    def _launch(self, lib: ctypes.CDLL, chan: torch.Tensor, B: int,
                stream) -> Tuple[torch.Tensor, ...]:
        ct, dev = self.ct, chan.device
        hard = torch.empty((B, ct.n), dtype=torch.uint8, device=dev)
        iters = torch.empty(B, dtype=torch.int32, device=dev)
        conv = torch.empty(B, dtype=torch.bool, device=dev)
        post, c2v = self.scratch_on(dev, B)
        num, shift = self.alpha if self.alpha is not None else (1, 0)
        err = lib.minsum_stream_launch(
            chan.data_ptr(), hard.data_ptr(), iters.data_ptr(),
            conv.data_ptr(), self.tables_on(dev).data_ptr(),
            None if post is None else post.data_ptr(), c2v.data_ptr(), B,
            ct.nb, ct.Z, ct.mb, ct.n_entries, self.max_iter,
            int(self.early_term), int(self.resident), self.qmax,
            self.beta, num, shift, stream)
        check_launch(lib, LIBRARY, err)
        return hard, iters, conv

    def scratch_on(self, dev: torch.device, B: int):
        """The kernel's private state for a batch of B on `dev`, allocated
        once and reused by later launches (they run in stream order):
        int16 posteriors (B, n) unless they are resident, int8 messages
        (B, E * Z). Neither needs zeroing."""
        if (dev, B) not in self._scratch:
            ct = self.ct
            post = (None if self.resident else
                    torch.empty((B, ct.n), dtype=torch.int16, device=dev))
            c2v = torch.empty((B, ct.n_entries * ct.Z), dtype=torch.int8,
                              device=dev)
            self._scratch[dev, B] = (post, c2v)
        return self._scratch[dev, B]

    def tables_on(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._tables:
            self._tables[dev] = torch.as_tensor(self._tables_np, device=dev)
        return self._tables[dev]

    def launch_smem(self) -> int:
        """The block's dynamic shared-memory bytes as the library computes
        them; builds the library."""
        smem = _I(0)
        ct = self.ct
        err = load_library().cdll.minsum_stream_config(
            ct.nb, ct.Z, ct.mb, ct.n_entries, int(self.resident),
            int(self.early_term), ctypes.byref(smem))
        check_launch(load_library().cdll, LIBRARY, err)
        return smem.value


def make_stream_decoder(ct: CodeTensors, max_iter: int = 20, beta: int = 0,
                        qmax: int = 127, alpha=None,
                        resident: Optional[bool] = None,
                        early_term: bool = False) -> StreamDecoder:
    """The streaming decoder of one code. resident and early_term pick the
    instance (`decoder.variant`); a forced instance that cannot run raises
    ValueError, as do codes outside the library's domain."""
    return StreamDecoder(ct, max_iter, beta, qmax, alpha, resident,
                         early_term)


def make_decoder(ct: CodeTensors, dec: DecoderConfig, quant: QuantConfig,
                 resident: Optional[bool] = None) -> StreamDecoder:
    """Factory from configs, mirroring `minsum_stream.make_decoder`."""
    if dec.algorithm not in ("min-sum", "offset-min-sum",
                             "normalized-min-sum"):
        raise ValueError(f"streaming decoder supports the min-sum family, "
                         f"got {dec.algorithm}")
    if dec.schedule != "layered":
        raise ValueError("streaming decoder is layered-only")
    beta, alpha = cn_params(dec, quant)
    return make_stream_decoder(ct, max_iter=dec.max_iter, beta=beta,
                               qmax=quant.qmax, alpha=alpha,
                               resident=resident,
                               early_term=dec.early_term)
