"""Streaming layered min-sum decoders for long codewords (counterpart of
`ldpc_tpu/kernels/minsum_stream.py`: `make_stream_decoder`,
`make_decoder`).

For codes whose state per codeword exceeds one SM's shared memory (DVB-S2
n=64,800: 129,600 B of int16 posteriors and 227,160 B of int8 messages),
the messages live in device memory. `make_stream_decoder` returns a
`StreamDecoder` that holds both versions:

  * `kernel`: the hand-written CUDA library `csrc/minsum_stream.cu`, built
    with nvcc at first launch (`build.py`), on CUDA tensors only. Two
    kernels, whose instances answer the reference's five Pallas kernels
    (`REPLACES`):
      - the pipelined kernel (`PIPELINED`, K6b/K6c and K6f): posteriors in
        shared memory, each layer's int8 messages copied in two layer steps
        ahead by cp.async (`stream-pipelined`, `stream-pipelined-et`; rows
        up to 24);
      - the template the library began with (`INSTANCES`): `stream` and
        `stream-et` (posteriors and messages in device memory; K6b/K6c,
        K6f), `stream-resident` and `stream-resident-et` (posteriors in
        shared memory, messages read on the critical path; K6d, K6e);
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

Which kernel decodes (`instance_auto`, the rule when nothing is forced): the
pipelined kernel where its block takes the code, unless its rows need the
24-entry register row while two blocks of the template fit an SM; else the
template, with the posteriors in shared memory where a block leaves room
for two an SM (`resident_auto`), else in device memory. `resident` forces
the template's placement of the posteriors (True: shared memory, False:
device memory; `resident` means the posteriors stay on chip for the whole
decode, which they also do in the pipelined kernel); `pipelined=True`
forces the pipelined kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
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
# The pipelined kernel: early_term -> the instance's name
PIPELINED = {False: "stream-pipelined", True: "stream-pipelined-et"}
# The Pallas kernels each instance answers: (id, pallas_call site).
_SITE = "ldpc_tpu/kernels/minsum_stream.py"
REPLACES = {
    "stream": (("K6b", f"{_SITE}:1295"),            # run-time layer tables
               ("K6c", f"{_SITE}:1279")),           # unrolled at trace time
    "stream-resident": (("K6d", f"{_SITE}:1261"),),
    "stream-resident-et": (("K6e", f"{_SITE}:1182"),),
    "stream-et": (("K6f", f"{_SITE}:1229"),),
    "stream-pipelined": (("K6b", f"{_SITE}:1295"), ("K6c", f"{_SITE}:1279")),
    "stream-pipelined-et": (("K6f", f"{_SITE}:1229"),),
}
# The pipelined kernel's constants (csrc/minsum_stream.cu)
RING_AHEAD = 2              # kRingAhead: layer steps copied in ahead
RING_STAGES = RING_AHEAD + 1
RING_TAB_WORDS = 4096       # kRingTabWords: table words in the parameters

kernel_launches = 0
plain_calls = 0
instance_launches = dict.fromkeys(
    (*INSTANCES.values(), *PIPELINED.values()), 0)

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0
    for name in instance_launches:
        instance_launches[name] = 0


def load_library(rebuild: bool = False) -> build.Library:
    """Build (first use) and bind the library; it exports
    minsum_stream_launch, _config, _pipelined_launch, _pipelined_config and
    _error_string."""
    return bind(build.load(LIBRARY, rebuild=rebuild))


def bind(lib: build.Library) -> build.Library:
    c = lib.cdll
    c.minsum_stream_launch.argtypes = [_P] * 7 + [_I] * 12 + [_P]
    c.minsum_stream_launch.restype = _I
    c.minsum_stream_config.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
    c.minsum_stream_config.restype = _I
    c.minsum_stream_pipelined_launch.argtypes = (
        [_P] * 5 + [_I, _P] + [_I] * 11 + [_P])
    c.minsum_stream_pipelined_launch.restype = _I
    c.minsum_stream_pipelined_config.argtypes = (
        [_I] * 6 + [ctypes.POINTER(_I)] * 3)
    c.minsum_stream_pipelined_config.restype = _I
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
    """Where the template puts the posteriors: in shared memory when a
    block's share leaves room for two blocks an SM (113 KB), else in device
    memory. Measured (`chip_smoke.py`, NVIDIA H100 80GB HBM3, 700.00 W, B =
    1,024, fixed-20, in turns): at n=16,200 (34 KB a block) resident
    3.5929 against 4.1956 ms; at n=64,800 (138 KB: one 360-thread block an
    SM) resident 29.3783 against 19.5741 ms streamed."""
    return smem_bytes(ct, True, early_term) <= PREFERRED_SMEM


def max_row_degree(ct: CodeTensors) -> int:
    return max(len(row) for row in ct.entries)


def pipelined_dmax(ct: CodeTensors) -> int:
    """The pipelined kernel's register row for this code (pipelined_dmax
    of the library): 8 or 24 entries, 0 when a row is longer."""
    d = max_row_degree(ct)
    return 8 if d <= 8 else 24 if d <= 24 else 0


def row_bytes(ct: CodeTensors) -> int:
    """Bytes of one check row's messages in the pipelined kernel: an int8
    message per entry of the register row."""
    return pipelined_dmax(ct)


def pipelined_smem(ct: CodeTensors) -> int:
    """Dynamic shared memory of a pipelined block (pipelined_smem of the
    library): the int16 posteriors, the ring of RING_STAGES layer steps of
    the block's rows and the block's mbarrier."""
    return align16(2 * ct.n) + align16(RING_STAGES * ct.Z * row_bytes(ct)) + 16


def pipelined_fits(ct: CodeTensors) -> bool:
    """Whether the pipelined kernel takes the code (pipelined_fits of the
    library): a register row (degree <= 24), Z threads within its launch
    bound (1024 at row 8, 512 at 24), more base rows than the ring looks
    ahead, the tables (mb + 1 + 2 E words) in the parameters, the block in
    shared memory."""
    dmax = pipelined_dmax(ct)
    return (dmax > 0 and 0 < ct.Z <= (1024 if dmax == 8 else 512)
            and ct.mb > RING_AHEAD
            and ct.mb + 1 + 2 * ct.n_entries <= RING_TAB_WORDS
            and pipelined_smem(ct) <= MAX_SMEM)


def instance_auto(ct: CodeTensors, early_term: bool) -> str:
    """The kernel that decodes when nothing is forced: "pipelined" where
    its block takes the code (`pipelined_fits`) and either its 8-entry
    register row holds the rows or the template cannot keep two resident
    blocks an SM; else the template, "resident" where a block of it leaves
    room for two an SM (`resident_auto`), else "stream" (posteriors in
    device memory).

    Measured (`chip_smoke.py`, NVIDIA H100 80GB HBM3, 700.00 W, B = 1,024,
    the instances in turns, CUDA-event medians; `stream`, pipelined,
    `stream-resident`): DVB-S2 n=64,800 fixed-20 at 1.0 dB 19.6036,
    9.1510, 29.4118 ms, with early termination at 1.25 dB 23.7381,
    6.2809, 25.2913; n=16,200 fixed-20 at 1.4 dB 4.2232, 2.0881, 3.6055,
    with early termination 3.0532, 1.2912, 2.4973; n=64,800 rate 5/6
    (rows of 22-23, the 24-entry register row) fixed-20 at 3.0 dB
    18.3601, 13.4773, 25.5863; NR BG1 Z=384 (20 of its 24 rows of degree
    5-7, four of 21-22: the 24-entry row, 128 registers, one 384-thread
    block an SM against the template's two) fixed-20 at 1.0 dB 5.2833,
    8.0220, 4.5118, with early termination at 1.25 dB 4.9234, 6.3869,
    3.5379. The 24-entry row pays for its 24 slots on every row, so it
    wins only where the template would stream the posteriors."""
    two_resident = resident_auto(ct, early_term)
    if pipelined_fits(ct) and (pipelined_dmax(ct) == 8 or not two_resident):
        return "pipelined"
    return "resident" if two_resident else "stream"


def pipelined_tables(ct: CodeTensors) -> np.ndarray:
    """The pipelined kernel's uint32 tables (its kernel parameters), by
    base row: layer_ptr[mb+1], base2[E] = 2 (col * Z + shift), thr[E] =
    Z - shift: row r of entry e reads the int16 posterior at byte 2 r +
    base2[e], less 2 Z when r >= thr[e]."""
    t = kernel_tables(ct).astype(np.int64)
    mb, E, Z = ct.mb, ct.n_entries, ct.Z
    cols, shifts = t[mb + 1: mb + 1 + E], t[mb + 1 + E: mb + 1 + 2 * E]
    return np.ascontiguousarray(np.concatenate(
        [t[: mb + 1], 2 * (cols * Z + shifts), Z - shifts]).astype(np.uint32))


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
    """Layered min-sum-family decoder of a long code, for one code and
    configuration, in one instance of the library (`variant`)."""
    counting = False        # hard bits out, never in-kernel error counts
    batch_tile = 1          # a block decodes one codeword: any batch size

    def __init__(self, ct: CodeTensors, max_iter: int, beta: int, qmax: int,
                 alpha, resident: Optional[bool], early_term: bool,
                 pipelined: Optional[bool] = None):
        if ct.code.base is None or ct.code.Z is None:
            raise ValueError(f"{ct.code.name}: streaming decoder requires "
                             f"QC structure")
        why = stream_domain(ct, qmax)
        if why:
            raise ValueError(why)
        if pipelined and resident is False:
            raise ValueError("the pipelined kernel keeps the posteriors "
                             "resident")
        if pipelined is None and resident is None:
            auto = instance_auto(ct, early_term)
            pipelined, resident = auto == "pipelined", auto == "resident"
        pipelined = bool(pipelined)
        if pipelined:
            resident = True
        elif resident is None:
            resident = resident_auto(ct, early_term)
        self.ct, self.max_iter, self.beta, self.qmax = ct, max_iter, beta, qmax
        self.alpha = alpha
        self.resident, self.early_term = bool(resident), bool(early_term)
        self.pipelined = pipelined
        if pipelined:
            self.variant = PIPELINED[self.early_term]
            fits = pipelined_fits(ct)
        else:
            self.variant = INSTANCES[self.resident, self.early_term]
            fits = block_fits(ct, self.resident, self.early_term)
        if not fits:
            raise ValueError(
                f"{ct.code.name}: a block of the {self.variant} instance "
                f"does not take this code (threads, register row, tables "
                f"or shared memory)")
        self._plain = make_qc_decoder(
            ct.code, max_iter=max_iter, beta=beta, qmax=qmax,
            schedule="layered", early_term=early_term, alpha=alpha)
        self._tables_np = (pipelined_tables(ct) if pipelined
                           else kernel_tables(ct))
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
        num, shift = self.alpha if self.alpha is not None else (1, 0)
        if self.pipelined:
            (msg,) = self.scratch_on(dev, B)
            tab = self._tables_np
            err = lib.minsum_stream_pipelined_launch(
                chan.data_ptr(), hard.data_ptr(), iters.data_ptr(),
                conv.data_ptr(), tab.ctypes.data, tab.size, msg.data_ptr(),
                B, ct.nb, ct.Z, ct.mb, ct.n_entries, self.max_iter,
                int(self.early_term), self.qmax, self.beta, num, shift,
                stream)
        else:
            post, c2v = self.scratch_on(dev, B)
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
        once and reused by later launches (they run in stream order). The
        template: int16 posteriors (B, n) unless they are resident, int8
        messages (B, E * Z); the pipelined kernel: the row messages (B, mb
        * Z * row_bytes). None needs zeroing."""
        if (dev, B) not in self._scratch:
            ct = self.ct
            if self.pipelined:
                self._scratch[dev, B] = (torch.empty(
                    (B, ct.mb * ct.Z * row_bytes(ct)),
                    dtype=torch.uint8, device=dev),)
            else:
                post = (None if self.resident else torch.empty(
                    (B, ct.n), dtype=torch.int16, device=dev))
                c2v = torch.empty((B, ct.n_entries * ct.Z),
                                  dtype=torch.int8, device=dev)
                self._scratch[dev, B] = (post, c2v)
        return self._scratch[dev, B]

    def tables_on(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._tables:
            self._tables[dev] = torch.as_tensor(self._tables_np, device=dev)
        return self._tables[dev]

    def launch_shape(self) -> Tuple[int, int, int]:
        """(dynamic shared-memory bytes, register row, blocks an SM keeps
        resident) of the block as the library computes them; the template
        reports its bytes and 0, 0. Builds the library."""
        ct, lib = self.ct, load_library().cdll
        smem, dmax, blocks = _I(0), _I(0), _I(0)
        if self.pipelined:
            err = lib.minsum_stream_pipelined_config(
                ct.nb, ct.Z, ct.mb, ct.n_entries, max_row_degree(ct),
                int(self.early_term), ctypes.byref(smem), ctypes.byref(dmax),
                ctypes.byref(blocks))
        else:
            err = lib.minsum_stream_config(
                ct.nb, ct.Z, ct.mb, ct.n_entries, int(self.resident),
                int(self.early_term), ctypes.byref(smem))
        check_launch(lib, LIBRARY, err)
        return smem.value, dmax.value, blocks.value

    def smem_bytes(self) -> int:
        """The same bytes by the wrapper's mirror of the library's rule."""
        if self.pipelined:
            return pipelined_smem(self.ct)
        return smem_bytes(self.ct, self.resident, self.early_term)


def make_stream_decoder(ct: CodeTensors, max_iter: int = 20, beta: int = 0,
                        qmax: int = 127, alpha=None,
                        resident: Optional[bool] = None,
                        early_term: bool = False,
                        pipelined: Optional[bool] = None) -> StreamDecoder:
    """The streaming decoder of one code. early_term and, when forced,
    resident and pipelined pick the instance (`decoder.variant`;
    `instance_auto` when neither resident nor pipelined is given); a forced
    instance that cannot run raises ValueError, as do codes outside the
    library's domain."""
    return StreamDecoder(ct, max_iter, beta, qmax, alpha, resident,
                         early_term, pipelined)


def make_decoder(ct: CodeTensors, dec: DecoderConfig, quant: QuantConfig,
                 resident: Optional[bool] = None,
                 pipelined: Optional[bool] = None) -> StreamDecoder:
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
                               resident=resident, early_term=dec.early_term,
                               pipelined=pipelined)
