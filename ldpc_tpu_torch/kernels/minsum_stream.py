"""Streaming layered min-sum decoders for long codewords (counterpart of
`ldpc_tpu/kernels/minsum_stream.py`: `make_stream_decoder`,
`make_decoder`).

For codes whose state per codeword exceeds one SM's shared memory (DVB-S2
n=64,800: 129,600 B of int16 posteriors and 227,160 B of int8 messages),
the messages live in device memory. `make_stream_decoder` returns a
`StreamDecoder` that holds both versions:

  * `kernel`: the hand-written CUDA library `csrc/minsum_stream.cu`, built
    with nvcc at first launch (`build.py`), on CUDA tensors only. Three
    kernels, whose instances answer the reference's five Pallas kernels
    (`REPLACES`):
      - the pipelined kernel (`PIPELINED`, K6b/K6c and K6f): posteriors in
        shared memory, each layer's int8 messages copied in two layer steps
        ahead by cp.async (`stream-pipelined`, `stream-pipelined-et`; rows
        up to 32 in register rows of 8, 24, 28 and 32 entries: DVB-S2
        n=64,800 at rates 1/2, 5/6 and 8/9);
      - the packed resident kernel (K6d, K6e: `stream-resident`,
        `stream-resident-et` wherever its block fits,
        `resident_packed_fits`): the posteriors of 2 or 4 codeword lanes
        in shared memory, a thread a check row of all of them, each
        layer's messages copied in one step ahead, rows of any degree
        (`resident_lanes` picks the lanes by the batch);
      - the template the library began with (`INSTANCES`): `stream` and
        `stream-et` (posteriors and messages in device memory; K6b/K6c,
        K6f) where forced (`resident=False`) or where rows exceed 32, and
        `stream-resident`, `stream-resident-et` (posteriors in shared
        memory, messages read on the critical path) for the codes no packed
        resident block takes (DVB-S2 n=64,800);
  * `plain`: the plain torch version, `ops/decode_qc` (layered), on tensors
    of any device.

Calling the decoder dispatches by the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises. Nothing
falls back. The module counts `kernel_launches`, `instance_launches` (per
instance), `packed_launches` (of them, the packed resident kernel's) and
`plain_calls`.

Batch first, as the reference's:
  decode(chan (B, n) int8) -> (hard (B, n) uint8, iters (B,) int32,
                               conv (B,) bool)
Fixed form: iters = max_iter, conv = the syndrome of the final posteriors.
Early termination: hard bits latched at a lane's first syndrome success,
iters the iterations run until then (0 for a channel word that is a
codeword). min* has no streaming form, as in the reference.

Which kernel decodes (`instance_auto`, the rule when nothing is forced, by
measurement): the packed resident kernel where its block fits, unless the
rows fit the pipelined kernel's 8-entry register row and the batch is too
small for four lanes a thread; else the pipelined kernel where it fits;
else the template, with the posteriors in shared memory where a block
leaves room for two an SM (`resident_auto`), else in device memory.
`resident` forces the posteriors' placement (True: shared memory, the
packed resident kernel where it fits, else the template; False: device
memory; `resident` means the posteriors stay on chip for the whole decode,
which they also do in the pipelined kernel); `pipelined=True` forces the
pipelined kernel. The packed kernel's lanes a thread follow the batch of
each launch (`resident_lanes`, with the SM count of the card the code
lives on: the rule `instance_auto` reads too).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..codes import CodeTensors
from ..config import DecoderConfig, QuantConfig, cn_params
from ..ops.decode_qc import make_qc_decoder
from . import build
from .minsum import (BLOCK_RESERVE, MAX_SMEM, MAX_THREADS, PREFERRED_SMEM,
                     SM_BLOCKS, SM_SMEM, SM_WARPS, TAB_WORDS, align16,
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
# its register rows (pipelined_dmax) -> their launch bounds (threads)
PIPELINED_ROWS = {8: 1024, 24: 512, 28: 384, 32: 256}
# The packed resident kernel's constants (csrc/minsum_stream.cu)
RESIDENT_ROW = 8            # kResidentRow: entries a row keeps in registers
RESIDENT_AHEAD = 1          # kResidentAhead: layer steps copied in ahead
RESIDENT_STAGES = RESIDENT_AHEAD + 1
RESIDENT_MAX_THREADS = 512  # kResidentMaxThreads: Z, the launch bound
RESIDENT_VOTE = 8           # kResidentVote: base rows between syndrome votes
RESIDENT_LANES = (2, 4)     # its instances' codeword lanes a thread
H100_SMS = 132              # the SMs the rule assumes off the card

kernel_launches = 0
plain_calls = 0
instance_launches = dict.fromkeys(
    (*INSTANCES.values(), *PIPELINED.values()), 0)
packed_launches = 0      # of them, the packed resident kernel's

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_counters() -> None:
    global kernel_launches, plain_calls, packed_launches
    kernel_launches = 0
    plain_calls = 0
    packed_launches = 0
    for name in instance_launches:
        instance_launches[name] = 0


def load_library(rebuild: bool = False) -> build.Library:
    """Build (first use) and bind the library; it exports
    minsum_stream_launch, _config, _pipelined_launch, _pipelined_config,
    _resident_launch, _resident_config and _error_string."""
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
    c.minsum_stream_resident_launch.argtypes = (
        [_P] * 5 + [_I, _P] + [_I] * 12 + [_P])
    c.minsum_stream_resident_launch.restype = _I
    c.minsum_stream_resident_config.argtypes = (
        [_I] * 4 + [_P] + [_I] * 3 + [ctypes.POINTER(_I)] * 2)
    c.minsum_stream_resident_config.restype = _I
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
    of the library): 8, 24, 28 or 32 entries, 0 when a row is longer."""
    d = max_row_degree(ct)
    return next((w for w in PIPELINED_ROWS if d <= w), 0)


def pipelined_threads(dmax: int) -> int:
    """The threads a block of the register row's instance may have (its
    launch bound; pipelined_threads of the library)."""
    return PIPELINED_ROWS[dmax]


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
    library): a register row (degree <= 32), Z threads within its launch
    bound (`pipelined_threads`), more base rows than the ring looks ahead,
    the tables (mb + 1 + 2 E words) in the parameters, the block in shared
    memory."""
    dmax = pipelined_dmax(ct)
    return (dmax > 0 and 0 < ct.Z <= pipelined_threads(dmax)
            and ct.mb > RING_AHEAD
            and ct.mb + 1 + 2 * ct.n_entries <= RING_TAB_WORDS
            and pipelined_smem(ct) <= MAX_SMEM)


def card_sms(dev: Optional[torch.device]) -> int:
    """SMs of the card `dev`; H100_SMS off the card, so that the rule
    reads the same on a CPU code."""
    if dev is None or dev.type != "cuda":
        return H100_SMS
    return _sms_of(torch.cuda.current_device() if dev.index is None
                   else dev.index)


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def straight_rows(ct: CodeTensors) -> bool:
    """Whether every base row of the code takes a straight-line body of
    the pipelined kernel (degrees 2-8 at its 8-entry register row, 27 and
    28 at its 28-entry row) rather than the guarded body, a guard an
    entry (the guarded 28-entry row took 1.6-1.8x as long on DVB-S2 rate
    8/9: PERF.md section 6)."""
    dmax = pipelined_dmax(ct)
    return dmax == 8 or (dmax == 28
                         and {len(row) for row in ct.entries} <= {27, 28})


def instance_auto(ct: CodeTensors, early_term: bool,
                  batch: Optional[int] = None) -> str:
    """The kernel that decodes a batch of `batch` on the card of `ct`
    when nothing is forced, by measurement; `pipeline.stream_first` and
    the packed kernel's lanes at launch (`resident_lanes`) read the same
    rule:

      * "resident" on the packed resident kernel, where its block fits and
        either the batch gives it four lanes a thread (`resident_lanes`)
        or the pipelined kernel has no straight-line body for the rows
        (`straight_rows`);
      * else "pipelined" where its block takes the code (one codeword a
        block; the 8-, 24-, 28- or 32-entry register row);
      * else the template: "resident" where a block of it leaves room for
        two an SM (`resident_auto`), else "stream" (posteriors in device
        memory).

    Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W, the
    instances in turns, CUDA-event medians, OMS; the packed resident
    kernel at the batch's lanes against the pipelined kernel and the
    template): DVB-S2 n=16,200 at B = 1,024 (four lanes) fixed-20 1.5702,
    1.5943 against 1.9443, 1.9695 and the template's 3.4884, 3.5437 ms,
    with early termination at 1.4 dB 1.2483, 1.2565 against 1.2666,
    1.2593 and 2.5079, 2.4948; at B = 256 (two lanes) the pipelined kernel
    won, fixed 0.6235 against 0.8426 and with early termination 0.3863
    against 0.5808 (`probe_stream`, at 1.4 and 1.65 dB); NR BG1 Z=384
    (rows of 5-7 and 21-22, the guarded 24-entry row) at B = 1,024
    fixed-20 2.2425, 2.1109 against 7.9868, 8.0416 and 4.4938, 4.4854,
    with early termination at 1.25 dB 2.0783, 2.0230 against 6.3860,
    6.3469 and 3.5010, 3.6239, at B = 256 fixed 1.0521, 1.0840 against
    2.0348, 2.0846 and 1.3549, 1.3746. n=16,200 rate 8/9 (rows of 27-28,
    the 28-entry row's straight-line bodies) at B = 256 (two lanes) the
    pipelined kernel won, fixed-20 at 3.5 dB 0.4126 against 0.6825 and
    with early termination at 3.75 dB 0.4914 against 0.7957; at B = 1,024
    (four lanes) fixed-20 1.3671 against 1.4312, with early termination
    1.3792 against the pipelined kernel's 1.1088: the rule keeps four
    lanes there. n=64,800 (no packed resident block): fixed-20 pipelined
    9.0135, 9.1181 against the template's 29.2290, 29.2891 resident and
    19.3491, 19.5269 streamed; at rate 8/9 (3.0 dB) at B = 256 fixed-20
    1.4089 against the template's 4.9460 streamed and with early
    termination 1.6877 against 8.3142, at B = 1,024 5.5634 against
    16.1696 and 6.6311 against 27.1084. Where no kernel above takes the
    code (rows above 32 with no packed resident block), the template."""
    if resident_packed_fits(ct, 2) and (
            not (pipelined_fits(ct) and straight_rows(ct))
            or (batch is not None
                and resident_lanes(ct, batch, ct.device) == 4)):
        return "resident"
    if pipelined_fits(ct):
        return "pipelined"
    return "resident" if resident_auto(ct, early_term) else "stream"


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


def resident_words(d: int, lanes: int) -> int:
    """Message words (4 bytes: 4 / lanes entries of `lanes` int8 lanes) of
    a check row of degree d in the packed resident kernel."""
    return -(-d * lanes // 4)


def resident_tables(ct: CodeTensors, lanes: int) -> np.ndarray:
    """The packed resident kernel's uint32 tables (its kernel parameters),
    by base row: layer_ptr[mb+1]; wptr[mb+1], the message words before each
    base row; off[E] = (2 lanes (col Z + shift)) << 11 | (Z - shift): row y
    of entry e reads the posterior pair at byte off[e] >> 11 plus 2 lanes
    y, less 2 lanes Z when y >= Z - shift."""
    t = kernel_tables(ct).astype(np.int64)
    mb, E, Z = ct.mb, ct.n_entries, ct.Z
    layer_ptr = t[: mb + 1]
    cols, shifts = t[mb + 1: mb + 1 + E], t[mb + 1 + E: mb + 1 + 2 * E]
    wptr = np.concatenate([[0], np.cumsum(
        [resident_words(int(d), lanes) for d in np.diff(layer_ptr)])])
    off = ((2 * lanes * (cols * Z + shifts)) << 11) | (Z - shifts)
    return np.ascontiguousarray(np.concatenate(
        [layer_ptr, wptr, off]).astype(np.uint32))


def resident_wmax(ct: CodeTensors, lanes: int) -> int:
    """The most message words of a base row (a ring stage's words)."""
    return resident_words(max_row_degree(ct), lanes)


def resident_packed_smem(ct: CodeTensors, lanes: int) -> int:
    """Dynamic shared memory of a packed resident block (resident_smem of
    the library): the syndrome vote's word, the int16 posteriors of `lanes`
    codewords, the ring of RESIDENT_STAGES steps of the longest row's words
    for every row, the block's mbarrier."""
    return (align16(4) + align16(2 * ct.n * lanes)
            + align16(RESIDENT_STAGES * resident_wmax(ct, lanes) * ct.Z * 4)
            + 16)


def resident_packed_fits(ct: CodeTensors, lanes: int) -> bool:
    """Whether a packed resident block of `lanes` lanes takes the code
    (resident_fits of the library): Z threads within the launch bound,
    more base rows than the ring looks ahead, the tables in the
    parameters, posterior offsets within 21 bits, the block in shared
    memory."""
    return (lanes in RESIDENT_LANES and 0 < ct.Z <= RESIDENT_MAX_THREADS
            and ct.mb > RESIDENT_AHEAD
            and 2 * (ct.mb + 1) + ct.n_entries <= TAB_WORDS
            and 2 * lanes * (ct.nb + 1) * ct.Z < 1 << 21
            and resident_packed_smem(ct, lanes) <= MAX_SMEM)


def resident_blocks(ct: CodeTensors, lanes: int) -> int:
    """Packed resident blocks an SM holds by shared memory (with the
    runtime's reserve a block), warps and blocks; registers not counted
    (the library's occupancy query counts them)."""
    return min(SM_SMEM // (resident_packed_smem(ct, lanes) + BLOCK_RESERVE),
               SM_WARPS // -(-ct.Z // 32), SM_BLOCKS)


def resident_lanes(ct: CodeTensors, B: int,
                   dev: Optional[torch.device] = None) -> int:
    """The packed resident kernel's lanes a thread for a batch of B on the
    card `dev` (`card_sms`): four where a block of four fits and their
    grid gives every SM its resident blocks at least once, else two (at B =
    256, 64 blocks of four would leave half of 132 SMs idle); 0 when no
    packed block takes the code."""
    if not resident_packed_fits(ct, 2):
        return 0
    if (resident_packed_fits(ct, 4)
            and -(-B // 4) >= card_sms(dev) * resident_blocks(ct, 4)):
        return 4
    return 2


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
    batch_tile = 1          # any batch size: a block is one codeword, or
                            # packed lanes past the batch are masked

    def __init__(self, ct: CodeTensors, max_iter: int, beta: int, qmax: int,
                 alpha, resident: Optional[bool], early_term: bool,
                 pipelined: Optional[bool] = None,
                 batch: Optional[int] = None):
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
            auto = instance_auto(ct, early_term, batch)
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
        # the packed resident kernel wherever its block of two lanes fits
        self.packed = (self.resident and not pipelined
                       and resident_packed_fits(ct, 2))
        if pipelined:
            self.variant = PIPELINED[self.early_term]
            fits = pipelined_fits(ct)
        else:
            self.variant = INSTANCES[self.resident, self.early_term]
            fits = (self.packed
                    or block_fits(ct, self.resident, self.early_term))
        if not fits:
            raise ValueError(
                f"{ct.code.name}: a block of the {self.variant} instance "
                f"does not take this code (threads, register row, tables "
                f"or shared memory)")
        self._plain = make_qc_decoder(
            ct.code, max_iter=max_iter, beta=beta, qmax=qmax,
            schedule="layered", early_term=early_term, alpha=alpha)
        self._tables_np = (pipelined_tables(ct) if pipelined
                           else None if self.packed else kernel_tables(ct))
        self._resident_tables: Dict[int, np.ndarray] = {}
        self._tables: Dict[torch.device, torch.Tensor] = {}
        self._scratch: Dict[Tuple[torch.device, int, int], tuple] = {}

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
        global kernel_launches, packed_launches
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
        packed_launches += self.packed
        return out

    def _launch(self, lib: ctypes.CDLL, chan: torch.Tensor, B: int,
                stream) -> Tuple[torch.Tensor, ...]:
        ct, dev = self.ct, chan.device
        hard = torch.empty((B, ct.n), dtype=torch.uint8, device=dev)
        iters = torch.empty(B, dtype=torch.int32, device=dev)
        conv = torch.empty(B, dtype=torch.bool, device=dev)
        num, shift = self.alpha if self.alpha is not None else (1, 0)
        if self.packed:
            L = self.lanes_for(B, dev)
            (msg,) = self.scratch_on(dev, B, L)
            tab = self.resident_tables(L)
            err = lib.minsum_stream_resident_launch(
                chan.data_ptr(), hard.data_ptr(), iters.data_ptr(),
                conv.data_ptr(), tab.ctypes.data, tab.size, msg.data_ptr(),
                B, ct.nb, ct.Z, ct.mb, ct.n_entries, self.max_iter,
                int(self.early_term), L, self.qmax, self.beta, num, shift,
                stream)
        elif self.pipelined:
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

    def lanes_for(self, B: int, dev: Optional[torch.device] = None) -> int:
        """Codeword lanes a thread of the instance at a batch of B on the
        card `dev` (the code's card when None): the packed resident
        kernel's `resident_lanes`; 1 for the other kernels, whose block is
        one codeword."""
        if not self.packed:
            return 1
        return resident_lanes(self.ct, B, self.ct.device if dev is None
                              else dev)

    def kernel_name(self, B: int) -> str:
        """The kernel template instance a batch of B launches."""
        et = "true" if self.early_term else "false"
        if self.pipelined:
            return f"stream_pipelined_kernel<{pipelined_dmax(self.ct)}, {et}>"
        if self.packed:
            return f"resident_packed_kernel<{self.lanes_for(B)}, {et}>"
        res = "true" if self.resident else "false"
        return f"minsum_stream_kernel<{res}, {et}>"

    def resident_tables(self, lanes: int) -> np.ndarray:
        if lanes not in self._resident_tables:
            self._resident_tables[lanes] = resident_tables(self.ct, lanes)
        return self._resident_tables[lanes]

    def scratch_on(self, dev: torch.device, B: int, lanes: int = 1):
        """The kernel's private state for a batch of B on `dev`, allocated
        once and reused by later launches (they run in stream order). The
        template: int16 posteriors (B, n) unless they are resident, int8
        messages (B, E * Z); the pipelined kernel: the row messages (B, mb
        * Z * row_bytes); the packed resident kernel at `lanes` lanes a
        thread: the message words of each block of lanes (ceil(B / lanes),
        words * Z * 4). None needs zeroing."""
        if (dev, B, lanes) not in self._scratch:
            ct = self.ct
            if self.packed:
                words = int(self.resident_tables(lanes)[2 * ct.mb + 1])
                self._scratch[dev, B, lanes] = (torch.empty(
                    (-(-B // lanes), words * ct.Z * 4), dtype=torch.uint8,
                    device=dev),)
            elif self.pipelined:
                self._scratch[dev, B, lanes] = (torch.empty(
                    (B, ct.mb * ct.Z * row_bytes(ct)),
                    dtype=torch.uint8, device=dev),)
            else:
                post = (None if self.resident else torch.empty(
                    (B, ct.n), dtype=torch.int16, device=dev))
                c2v = torch.empty((B, ct.n_entries * ct.Z),
                                  dtype=torch.int8, device=dev)
                self._scratch[dev, B, lanes] = (post, c2v)
        return self._scratch[dev, B, lanes]

    def tables_on(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._tables:
            self._tables[dev] = torch.as_tensor(self._tables_np, device=dev)
        return self._tables[dev]

    def launch_shape(self, B: int = 1) -> Tuple[int, int, int]:
        """(dynamic shared-memory bytes, register row or lanes a thread,
        blocks an SM keeps resident) of the block at a batch of B as the
        library computes them: the pipelined kernel reports its register
        row, the packed resident kernel its lanes a thread, the template
        its bytes and 0, 0. Builds the library."""
        ct, lib = self.ct, load_library().cdll
        smem, dmax, blocks = _I(0), _I(0), _I(0)
        if self.packed:
            L = self.lanes_for(B, torch.device("cuda"))
            tab = self.resident_tables(L)
            err = lib.minsum_stream_resident_config(
                ct.nb, ct.Z, ct.mb, ct.n_entries, tab.ctypes.data, tab.size,
                L, int(self.early_term), ctypes.byref(smem),
                ctypes.byref(blocks))
            dmax = _I(L)
        elif self.pipelined:
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

    def smem_bytes(self, B: int = 1) -> int:
        """The same bytes by the wrapper's mirror of the library's rule."""
        if self.packed:
            return resident_packed_smem(
                self.ct, self.lanes_for(B, torch.device("cuda")))
        if self.pipelined:
            return pipelined_smem(self.ct)
        return smem_bytes(self.ct, self.resident, self.early_term)


def make_stream_decoder(ct: CodeTensors, max_iter: int = 20, beta: int = 0,
                        qmax: int = 127, alpha=None,
                        resident: Optional[bool] = None,
                        early_term: bool = False,
                        pipelined: Optional[bool] = None,
                        batch: Optional[int] = None) -> StreamDecoder:
    """The streaming decoder of one code. early_term and, when forced,
    resident and pipelined pick the instance (`decoder.variant`;
    `instance_auto` when neither resident nor pipelined is given);
    `batch`, the batch the caller will decode, lets `instance_auto` see
    it. A forced instance that cannot run raises ValueError, as do codes
    outside the library's domain."""
    return StreamDecoder(ct, max_iter, beta, qmax, alpha, resident,
                         early_term, pipelined, batch)


def make_decoder(ct: CodeTensors, dec: DecoderConfig, quant: QuantConfig,
                 resident: Optional[bool] = None,
                 pipelined: Optional[bool] = None,
                 batch: Optional[int] = None) -> StreamDecoder:
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
                               pipelined=pipelined, batch=batch)
