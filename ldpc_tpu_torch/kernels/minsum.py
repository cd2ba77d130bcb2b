"""On-chip min-sum decoders (counterpart of
`ldpc_tpu/kernels/minsum_pallas.py`).

`make_decoder` mirrors `minsum_pallas.make_decoder` for the fixed-point
algorithms of its VMEM kernel, the min-sum family and min* (K5, the CN
update of `csrc/cn_minstar.cuh` in every instance below): flooding with
fixed iterations (K1) or per-lane early termination (K2), and the layered
schedule with either (K3), each also in the fused-IO form (K1-IO: float32
LLRs quantized in the kernel, per-lane info-bit error counts out). It
returns a `MinsumDecoder` that holds both versions:

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

With mc_batch=B (and input_scale, count_info_cols=kb) it returns an
`McDecoder`, the Monte-Carlo megakernel (K1-MC): the whole simulation step
of B codewords from a 64-bit seed, in the `MC` instance of either library
(`csrc/mc_stage.cuh`), or plainly (`ops/rng` + `ops/mc` + the plain
decoder + counting):
  decode(seed, sigma, gain)                        -> (bit_errs, frame_err,
                                                       iters, conv), (B,)
  decode(seed, sigma, gain, words=(W, B) int32)    (inject_random=True)
  decode(seed, sigma_lane=(B,), gain_lane=(B,))    (mc_lane_sigma=True)
The module also counts `mc_launches`, for launches of the min*
instances `star_launches`, for launches of a packed instance (four
lanes a thread, or two where a block of four does not fit,
`csrc/cn_packed.cuh`) `packed_launches`, and for launches of a one-lane
instance (`flood_quad_kernel`: four check rows of one codeword a word;
`layered_row_kernel`: a register row a thread; a codeword a block, where no
packed block takes the code or min* rows have 25-28 entries)
`one_lane_launches`, per library; the one-lane template counts in
neither. `make_decoder(..., template=True)` forces the one-lane template
on any code.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config import (DecoderConfig, QuantConfig, cn_params,
                      minstar_thresholds)

from ..codes import CodeTensors
from ..ops import rng
from ..ops.decode_ref import make_decoder as make_plain_decoder
from ..ops.mc import make_prologue
from ..ops.quantize import quantize
from . import build

# The kernel library of each schedule, its source and the Pallas code it
# replaces (the kernel body, and for layered its layered_iter).
LIBRARIES = {"flooding": "minsum_flood", "layered": "minsum_layered"}
SOURCES = {lib: f"ldpc_tpu_torch/kernels/csrc/{lib}.cu"
           for lib in LIBRARIES.values()}
REPLACES = {"minsum_flood": "ldpc_tpu/kernels/minsum_pallas.py:390",
            "minsum_layered": "ldpc_tpu/kernels/minsum_pallas.py:823"}
# The MC instance of both libraries: the megakernel's pallas_call.
MC_REPLACES = "ldpc_tpu/kernels/minsum_pallas.py:990"
# The min* instances of both libraries (K5): `_cn_minstar`.
STAR_SOURCE = "ldpc_tpu_torch/kernels/csrc/cn_minstar.cuh"
STAR_REPLACES = "ldpc_tpu/kernels/minsum_pallas.py:159"
MAX_THRESHOLDS = 8      # ldpc::kMaxThresholds of csrc/cn_minsum.cuh
MAX_THREADS = 1024      # ldpc::kMaxThreads
MAX_SMEM = 232448       # ldpc::kMaxSmem, the 227 KB opt-in of sm_90
PREFERRED_SMEM = 113 * 1024     # ldpc::kPreferredSmem, two blocks per SM
# The packed instances (csrc/cn_packed.cuh; flood_packed_kernel of
# csrc/minsum_flood.cu, layered_packed_kernel of csrc/minsum_layered.cu):
# an SM's shared memory for blocks, the runtime's reserve per resident
# block, warps and blocks an SM keeps, their lanes a thread (four wherever
# a block fits, else TWO_LANES: flood_two_lane_kernel and
# layered_two_lane_kernel, whose launch bound is TWO_LANE_THREADS), the
# row-degree (DMAX) instances, the table words their parameters hold, the
# layered kernel's launch bound (threads a block) and the flooding kernel's
# for its early-terminating and min* instances (its fixed min-sum instances
# take MAX_THREADS).
SM_SMEM = 233472
BLOCK_RESERVE = 1024
SM_WARPS = 64
SM_BLOCKS = 32
LANES_PER_THREAD = 4
TWO_LANES = 2
TWO_LANE_THREADS = 384
ROW_DEGREES = (8, 16, 24)
LAYERED_ROW_DEGREES = (8, 16, 20, 24)
TAB_WORDS = 8000
LAYERED_MAX_THREADS = 256
FLOOD_ET_STAR_THREADS = 256
# The one-lane instances (csrc/cn_packed.cuh; flood_quad_kernel of
# csrc/minsum_flood.cu, layered_row_kernel of csrc/minsum_layered.cu): a
# codeword a block, rows of at most ONE_LANE_ROW_DEGREES[-1] entries in a
# register row; the flooding instance holds QUAD_ROWS check rows (or
# variables) a word, Z % QUAD_ROWS == 0, up to QUAD_THREADS threads a block
# (QUAD_STAR_THREADS for min*); the layered instance Z threads, at most
# TWO_LANE_THREADS.
QUAD_ROWS = 4
QUAD_THREADS = 512
QUAD_STAR_THREADS = 384
ONE_LANE_ROW_DEGREES = (24, 28)

kernel_launches = 0
plain_calls = 0
library_launches = dict.fromkeys(SOURCES, 0)
mc_launches = dict.fromkeys(SOURCES, 0)
star_launches = dict.fromkeys(SOURCES, 0)
packed_launches = dict.fromkeys(SOURCES, 0)
one_lane_launches = dict.fromkeys(SOURCES, 0)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0
    for lib in SOURCES:
        library_launches[lib] = 0
        mc_launches[lib] = 0
        star_launches[lib] = 0
        packed_launches[lib] = 0
        one_lane_launches[lib] = 0


class McArgs(ctypes.Structure):
    """The Monte-Carlo stage's inputs, `ldpc::Mc` of csrc/cn_minsum.cuh."""
    _fields_ = [("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32),
                ("sigma", _F), ("gain", _F), ("sigma_lane", _P),
                ("gain_lane", _P), ("words", _P), ("cb", _I),
                ("lane0", ctypes.c_int64)]


def load_library(name: str, rebuild: bool = False) -> build.Library:
    """Build (first use) and bind kernel library `name` (a value of
    LIBRARIES); both export <name>_launch, _config and _error_string with
    the same arguments: the launch takes the packed instance's entry tables
    (host memory) and their words between `mc` and the stream, then the
    two-lane and quad flooding instances' channel buffer (device memory,
    `chan_q`) and `template_only`; the config the largest base-row degree
    and `template_only` before its four outputs."""
    lib = build.load(name, rebuild=rebuild)
    c = lib.cdll
    launch = getattr(c, f"{name}_launch")
    launch.argtypes = [_P, _I, _F, _P, _I, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, ctypes.POINTER(_I), _I,
                       ctypes.POINTER(McArgs), _P, _I, _P, _I, _P]
    launch.restype = _I
    config = getattr(c, f"{name}_config")
    config.argtypes = [_I] * 9 + [ctypes.POINTER(_I)] * 4
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


def packed_tables(ct: CodeTensors) -> np.ndarray:
    """The packed instances' uint32 entry tables (their kernel
    parameters): layer_ptr[mb+1], col_ptr[nb+1], ent[E] = (col * Z) << 11 |
    shift by base row, col_ent[E] = (e * Z) << 11 | shift by base
    column."""
    t = kernel_tables(ct).astype(np.int64)
    mb, nb, E, Z = ct.mb, ct.nb, ct.n_entries, ct.Z
    layer_ptr = t[: mb + 1]
    cols, shifts = t[mb + 1: mb + 1 + E], t[mb + 1 + E: mb + 1 + 2 * E]
    col_ptr, col_ent = t[mb + 1 + 2 * E: mb + nb + 2 + 2 * E], t[-E:]
    return np.concatenate([layer_ptr, col_ptr, (cols * Z) << 11 | shifts,
                           (col_ent * Z) << 11 | shifts[col_ent]]
                          ).astype(np.uint32)


def quad_tables(ct: CodeTensors) -> np.ndarray:
    """The quad flooding instance's uint32 entry tables (its kernel
    parameters; the entry words of csrc/cn_packed.cuh's quad section):
    layer_ptr[mb+1], col_ptr[nb+1], then with Q = Z / 4 and each shift s =
    a Q + b (b < Q), by base row ent[E] = (col Q + b) << 13 | (Q - b) << 2 |
    a, and by base column col_ent[E] = (e Q - b + Q) << 13 | b << 2 | a."""
    t = kernel_tables(ct).astype(np.int64)
    mb, nb, E, Q = ct.mb, ct.nb, ct.n_entries, ct.Z // QUAD_ROWS
    layer_ptr = t[: mb + 1]
    cols, shifts = t[mb + 1: mb + 1 + E], t[mb + 1 + E: mb + 1 + 2 * E]
    col_ptr, col_ent = t[mb + 1 + 2 * E: mb + nb + 2 + 2 * E], t[-E:]
    a, b = shifts // Q, shifts % Q
    ent = (cols * Q + b) << 13 | (Q - b) << 2 | a
    by_col = ((col_ent * Q - b[col_ent] + Q) << 13 | b[col_ent] << 2
              | a[col_ent])
    return np.concatenate([layer_ptr, col_ptr, ent, by_col]).astype(np.uint32)


def align16(x: int) -> int:
    return (x + 15) & ~15


def table_words(ct: CodeTensors) -> int:
    """int32 words of `kernel_tables` (ldpc::table_words)."""
    return (ct.mb + 1) + 3 * ct.n_entries + (ct.nb + 1)


def base_degrees(ct: CodeTensors) -> Tuple[int, int]:
    """(least base-row degree, largest base-column degree)."""
    col_deg = np.bincount([c for row in ct.entries for c, _, _ in row],
                          minlength=ct.nb)
    return min(len(row) for row in ct.entries), int(col_deg.max())


def is_packed(ct: CodeTensors, schedule: str, star_deg: int,
              early_term: bool) -> bool:
    """Whether this code and instance take a packed kernel (is_packed of
    csrc/minsum_flood.cu and csrc/minsum_layered.cu), at four or two lanes
    a thread, else a one-lane instance (`is_one_lane`) or the one-lane
    template decodes it. Both schedules: every
    instance where a block of four lanes fits (for flooding within the
    instance's threads a block, `flood_max_threads`) or else one of two
    lanes (within TWO_LANE_THREADS), min* only where its rows (star_deg)
    fit the largest register row."""
    rows = ROW_DEGREES if schedule == "flooding" else LAYERED_ROW_DEGREES
    return (packed_shape(ct, schedule, star_deg, early_term)[0] > 0
            and star_deg <= rows[-1])


def flood_max_threads(star_deg: int, early_term: bool) -> int:
    """Threads a block of the packed flooding instance (the launch bound of
    flood_packed_kernel): MAX_THREADS for the fixed min-sum family,
    FLOOD_ET_STAR_THREADS with early termination or min*."""
    return FLOOD_ET_STAR_THREADS if star_deg or early_term else MAX_THREADS


def packed_smem_bytes(ct: CodeTensors, lanes: int,
                      schedule: str = "flooding",
                      lpt: int = LANES_PER_THREAD) -> int:
    """Dynamic shared memory of one block of a packed instance at `lpt`
    lanes a thread (packed_smem of csrc/minsum_flood.cu, layered_packed_smem
    of csrc/minsum_layered.cu): two words a lane, int16 totals or
    posteriors, for flooding at four lanes a thread the int8 channel (the
    two-lane instances keep it in device memory), and the int8 messages; no
    tables."""
    chan = (align16(ct.n * lanes)
            if schedule == "flooding" and lpt != TWO_LANES else 0)
    return (align16(8 * lanes) + align16(2 * ct.n * lanes) + chan
            + align16(ct.n_entries * ct.Z * lanes))


def packed_shape(ct: CodeTensors, schedule: str = "flooding",
                 star_deg: int = 0, early_term: bool = False
                 ) -> Tuple[int, int, int, int]:
    """(lanes per block, lanes a thread, shared-memory bytes, blocks an SM
    holds by shared memory, warps and blocks) of the schedule's packed
    instance, as packed_shape of csrc/cn_packed.cuh gives them: of the
    block shapes (lanes a multiple of the lanes a thread, lanes / lpt * Z
    threads within the instance's bound, state within MAX_SMEM) the fewest
    lanes that keep at least 9/10 of the most codewords an SM holds; at
    LANES_PER_THREAD where a block fits, else at TWO_LANES. The bound at
    four lanes: LAYERED_MAX_THREADS for layered, else
    `flood_max_threads(star_deg, early_term)`; at two, TWO_LANE_THREADS.
    Zeros when no block fits."""
    four = (flood_max_threads(star_deg, early_term)
            if schedule == "flooding" else LAYERED_MAX_THREADS)
    for lpt, max_threads in ((LANES_PER_THREAD, four),
                             (TWO_LANES, TWO_LANE_THREADS)):
        shapes = []
        k = 1
        while k * ct.Z <= max_threads:
            lanes = k * lpt
            smem = packed_smem_bytes(ct, lanes, schedule, lpt)
            if smem > MAX_SMEM:
                break
            warps = -(-k * ct.Z // 32)
            blocks = min(SM_SMEM // (smem + BLOCK_RESERVE),
                         SM_WARPS // warps, SM_BLOCKS)
            shapes.append((lanes, lpt, smem, blocks))
            k += 1
        if shapes:
            most = max(s[3] * s[0] for s in shapes)
            return next(s for s in shapes if 10 * s[3] * s[0] >= 9 * most)
    return (0, 0, 0, 0)


def row_degree_instance(ct: CodeTensors, schedule: str = "flooding") -> int:
    """The packed instance's register row (DMAX) for this code: the least
    of ROW_DEGREES (LAYERED_ROW_DEGREES for layered) >= its largest
    base-row degree, 0 (the row read twice) above them."""
    d = max(len(row) for row in ct.entries)
    rows = ROW_DEGREES if schedule == "flooding" else LAYERED_ROW_DEGREES
    return next((r for r in rows if d <= r), 0)


def one_lane_shape(ct: CodeTensors, schedule: str = "flooding",
                   star_deg: int = 0) -> Tuple[int, int, int]:
    """(threads a block, shared-memory bytes, blocks an SM holds by
    shared memory, warps and blocks) of the schedule's one-lane instance for
    this code (quad_shape of csrc/minsum_flood.cu, row_shape of
    csrc/minsum_layered.cu), zeros where it does not take the code. Both:
    one codeword a block, rows of at most ONE_LANE_ROW_DEGREES[-1] entries,
    the state within MAX_SMEM. Flooding: Z % QUAD_ROWS == 0; 16 B, the int16
    totals and the int8 messages (the channel lives in device memory); of
    the threads within the bound (QUAD_STAR_THREADS for min*, else
    QUAD_THREADS), as few as keep the C phase's mb Z / 4 items to the
    rounds the bound needs, in whole warps. Layered: Z <= TWO_LANE_THREADS
    threads; 16 B, the int16 posteriors and the int8 messages."""
    d = max(len(row) for row in ct.entries)
    if d > ONE_LANE_ROW_DEGREES[-1]:
        return (0, 0, 0)
    if schedule == "flooding":
        Q = ct.Z // QUAD_ROWS
        if ct.Z % QUAD_ROWS or Q > 2047:
            return (0, 0, 0)
        bound = QUAD_STAR_THREADS if star_deg else QUAD_THREADS
        items = ct.mb * Q
        rounds = -(-items // bound)
        per_round = -(-items // rounds)
        threads = min(bound, -(-per_round // 32) * 32)
        smem = 16 + align16(8 * ct.nb * Q) + align16(4 * ct.n_entries * Q)
    else:
        threads = ct.Z
        if threads > TWO_LANE_THREADS:
            return (0, 0, 0)
        smem = 16 + align16(2 * ct.n) + align16(ct.n_entries * ct.Z)
    if smem > MAX_SMEM:
        return (0, 0, 0)
    blocks = min(SM_SMEM // (smem + BLOCK_RESERVE),
                 SM_WARPS // -(-threads // 32), SM_BLOCKS)
    return (threads, smem, blocks)


def is_one_lane(ct: CodeTensors, schedule: str, star_deg: int,
                early_term: bool) -> bool:
    """Whether this code and instance take the schedule's one-lane
    instance (is_quad of csrc/minsum_flood.cu, is_row of
    csrc/minsum_layered.cu): no packed instance takes it (`is_packed`) and
    `one_lane_shape` does."""
    return (not is_packed(ct, schedule, star_deg, early_term)
            and one_lane_shape(ct, schedule, star_deg)[0] > 0)


def onchip_smem_bytes(ct: CodeTensors, schedule: str, star_deg: int,
                      lanes: int, early_term: bool = False) -> int:
    """Dynamic shared memory of one block of `lanes` codewords of the
    on-chip kernels (smem_bytes of csrc/minsum_flood.cu and
    minsum_layered.cu): the tables, two words per lane, int16 totals or
    posteriors, for flooding the int8 channel, the int8 messages and the
    min* scratch; the packed instances keep no tables and no scratch
    (`packed_smem_bytes`), nor do the one-lane instances (`one_lane_shape`,
    one lane a block)."""
    if is_packed(ct, schedule, star_deg, early_term):
        lpt = packed_shape(ct, schedule, star_deg, early_term)[1]
        return packed_smem_bytes(ct, lanes, schedule, lpt)
    if is_one_lane(ct, schedule, star_deg, early_term):
        if lanes != 1:
            raise ValueError(f"the one-lane instance has 1 lane a block, "
                             f"not {lanes}")
        return one_lane_shape(ct, schedule, star_deg)[1]
    return (align16(4 * table_words(ct)) + align16(8 * lanes)
            + align16(2 * ct.n * lanes)
            + (align16(ct.n * lanes) if schedule == "flooding" else 0)
            + align16(ct.n_entries * ct.Z * lanes)
            + align16(star_deg * ct.Z * lanes))


def pick_lanes(ct: CodeTensors, schedule: str, star_deg: int = 0,
               early_term: bool = False) -> int:
    """Codeword lanes per block of the on-chip kernels for this code,
    without building them: for a packed instance `packed_shape`; 1 for a
    one-lane instance (`is_one_lane`); else ldpc::pick_lanes of
    csrc/cn_minsum.cuh, the most lanes (a power of two <= 32, lanes * Z <=
    1024 threads) whose state fits 113 KB, else the 227 KB opt-in. 0 when
    one block's state does not fit one SM's shared memory."""
    if is_packed(ct, schedule, star_deg, early_term):
        return packed_shape(ct, schedule, star_deg, early_term)[0]
    if is_one_lane(ct, schedule, star_deg, early_term):
        return 1
    for limit in (PREFERRED_SMEM, MAX_SMEM):
        lanes = 32
        while lanes >= 1:
            if (lanes * ct.Z <= MAX_THREADS and onchip_smem_bytes(
                    ct, schedule, star_deg, lanes) <= limit):
                return lanes
            lanes //= 2
    return 0


# Integer operations of one min-sum edge update and iteration, the count a
# decoder's bound rests on: subtract, |.|, the clip, two merges of
# min1/min2 and the sign XOR to reduce; subtract, compare, select, negate,
# store and the posterior update to emit.
OPS_PER_EDGE = 12


def iteration_ops(ct: CodeTensors, minstar: Optional[Tuple[int, ...]]
                  ) -> int:
    """Integer operations one codeword needs for one iteration:
    OPS_PER_EDGE an edge for the min-sum family; for min* (its thresholds `minstar`) a
    row of degree d takes 3d - 6 combines of 12 + 4 * len(minstar)
    operations plus 4 an edge."""
    degs = [len(row) for row in ct.entries]
    if minstar is None:
        return OPS_PER_EDGE * sum(degs) * ct.Z
    per_combine = 12 + 4 * len(minstar)
    return ct.Z * sum((3 * dg - 6) * per_combine + 4 * dg for dg in degs)


def star_degree(ct: CodeTensors, dec: DecoderConfig) -> int:
    """The min* instances' scratch degree, the largest base-row degree; 0
    for the min-sum update."""
    if dec.algorithm != "min-star":
        return 0
    return max(len(row) for row in ct.entries)


def kernel_domain(ct: CodeTensors, quant: QuantConfig) -> Optional[str]:
    """None when the kernels' arithmetic takes the code, else why not. The
    CN update needs base rows of degree >= 2, and the kernels keep totals
    (flooding) or posteriors (layered) in int16: |chan| <= 128 plus dv
    messages of magnitude <= qmax must stay below 2**15."""
    row_deg, col_deg = base_degrees(ct)
    if row_deg >= 2 and 128 + col_deg * quant.qmax < 2 ** 15:
        return None
    return (f"{ct.code.name}: the kernel needs base-row degrees >= 2 and "
            f"int16-safe posteriors")


def onchip_domain(ct: CodeTensors, dec: DecoderConfig,
                  quant: QuantConfig) -> Optional[str]:
    """None when an on-chip kernel (K1/K2/K3/K5) takes this code and
    decoder, else why not: `kernel_domain`, or a state per codeword above
    one SM's shared memory. Reads shapes only and builds nothing."""
    why = kernel_domain(ct, quant)
    if why is not None:
        return why
    star_deg = star_degree(ct, dec)
    if pick_lanes(ct, dec.schedule, star_deg, dec.early_term) == 0:
        need = onchip_smem_bytes(ct, dec.schedule, star_deg, 1,
                                 dec.early_term)
        return (f"{ct.code.name}: the state of one codeword ({need} B) "
                f"exceeds the {MAX_SMEM} B of shared memory a block can "
                f"use, or Z={ct.Z} exceeds {MAX_THREADS} threads")
    return None


class MinsumDecoder:
    """Min-sum family or min* decoder (flooding or layered, fixed
    iterations or early termination) for one code and config."""

    def __init__(self, ct: CodeTensors, dec: DecoderConfig,
                 quant: QuantConfig, input_scale: Optional[float],
                 count_info_cols: Optional[int], template: bool = False):
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
        if dec.algorithm == "min-star":
            # as the reference's make_decoder: min* has neither offset nor
            # scaling, whatever quant.beta_lsb says
            self.beta, self.alpha = 0, None
            self.minstar = tuple(int(t) for t in minstar_thresholds(quant))
            if len(self.minstar) > MAX_THRESHOLDS:
                raise ValueError(
                    f"min-star: scale {quant.scale} gives "
                    f"{len(self.minstar)} thresholds, the kernel holds "
                    f"{MAX_THRESHOLDS}")
        else:
            self.beta, self.alpha = cn_params(dec, quant)
            self.minstar = None
        self.input_scale = input_scale
        self.count_info_cols = count_info_cols
        self.library = LIBRARIES[dec.schedule]
        self._plain = make_plain_decoder(ct.code, dec, quant)
        self._tables_np = kernel_tables(ct)
        self._tables: Dict[torch.device, torch.Tensor] = {}
        # the min* instances' scratch degree; 0 selects the min-sum update
        self.star_deg = star_degree(ct, dec)
        self._kernel_domain = kernel_domain(ct, quant)
        # a packed instance, or a one-lane instance: their entry tables
        # travel in the kernel's parameters (the one-lane template, forced
        # by `template` or taking what neither takes, reads `tables_on`);
        # the lanes a block and a thread
        self.template = template
        self.packed = not template and is_packed(ct, dec.schedule,
                                                 self.star_deg,
                                                 dec.early_term)
        self.one_lane = not template and is_one_lane(ct, dec.schedule,
                                                     self.star_deg,
                                                     dec.early_term)
        self.packed_lanes, self.lanes_per_thread = (
            packed_shape(ct, dec.schedule, self.star_deg,
                         dec.early_term)[:2] if self.packed else (0, 1))
        self.quad = self.one_lane and dec.schedule == "flooding"
        self._ptab = (quad_tables(ct) if self.quad
                      else None if template else packed_tables(ct))
        self._launch_tables = ((None, 0) if self._ptab is None
                               else (self._ptab.ctypes.data, len(self._ptab)))

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
        B = self._check(chan, info)
        if not chan.is_contiguous() or (info is not None
                                        and not info.is_contiguous()):
            raise ValueError("the kernel needs contiguous chan and info")
        return self.launch(chan.device, B, chan=chan, info=info)

    def launch(self, dev: torch.device, B: int,
               chan: Optional[torch.Tensor] = None,
               info: Optional[torch.Tensor] = None,
               mc: Optional[McArgs] = None) -> Tuple[torch.Tensor, ...]:
        """The one launch of the library's kernel over B codewords on the
        current stream of `dev`, its MC instance when `mc` is given; counts
        it. Returns the counting outputs, or (hard, iters, conv)."""
        global kernel_launches
        if self._kernel_domain is not None:
            raise NotImplementedError(self._kernel_domain)
        ct = self.ct
        if (self.packed or self.one_lane) and (
                self.param_words() > TAB_WORDS
                or ct.n_entries * ct.Z >= 1 << 21):
            raise ValueError(
                f"{ct.code.name}: {self.param_words()} words of entry tables "
                f"(E * Z = {ct.n_entries * ct.Z}) exceed the {TAB_WORDS} "
                f"words (and 2**21) the kernel's parameters hold")
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
        if B >= 2 ** 31:
            raise ValueError(f"batch {B} too large for one launch")
        name = self.library
        lib = load_library(name).cdll
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

        # the quantized channel of the two-lane flooding instances,
        # [block][n][lanes], and of the quad instance, [B][n]
        chan_q = None
        if self.quad:
            chan_q = torch.empty(B * ct.n, dtype=torch.int8, device=dev)
        elif self.lanes_per_thread == TWO_LANES and self.library == \
                LIBRARIES["flooding"]:
            blocks = -(-B // self.packed_lanes)
            chan_q = torch.empty(blocks * self.packed_lanes * ct.n,
                                 dtype=torch.int8, device=dev)
        num, shift = self.alpha_pair
        thr = (_I * MAX_THRESHOLDS)(*(self.minstar or ()))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, f"{name}_launch")(
                ptr(chan), int(self.input_scale is not None),
                float(self.input_scale or 0.0), ptr(info),
                self.count_info_cols or 0, ptr(hard), ptr(bits), ptr(frame),
                ptr(iters), ptr(conv), ptr(self.tables_on(dev)), B, ct.nb,
                ct.Z, ct.mb, ct.n_entries, self.dec.max_iter,
                int(self.dec.early_term), self.quant.qmax, self.beta, num,
                shift, self.star_deg, thr, len(self.minstar or ()),
                None if mc is None else ctypes.byref(mc),
                *self._launch_tables, ptr(chan_q), int(self.template),
                stream)
        check_launch(lib, name, err)
        kernel_launches += 1
        library_launches[name] += 1
        if mc is not None:
            mc_launches[name] += 1
        if self.minstar is not None:
            star_launches[name] += 1
        if self.packed:
            packed_launches[name] += 1
        if self.one_lane:
            one_lane_launches[name] += 1
        if self.counting:
            return bits, frame, iters, conv
        return hard, iters, conv

    def param_words(self) -> int:
        """Table words of the packed or one-lane instance's parameters:
        `packed_tables` (`quad_tables` for the quad instance), and for the
        packed layered kernel the entries' posterior offsets
        (layered_tab_words of csrc/minsum_layered.cu)."""
        extra = (self.ct.n_entries
                 if self.dec.schedule == "layered" and self.packed else 0)
        return len(self._ptab) + extra

    @property
    def alpha_pair(self) -> Tuple[int, int]:
        """alpha as the kernel's (num, shift), (1, 0) for none."""
        return self.alpha if self.alpha is not None else (1, 0)

    def tables_on(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._tables:
            self._tables[dev] = torch.as_tensor(self._tables_np, device=dev)
        return self._tables[dev]

    def launch_config(self) -> Tuple[int, int]:
        """(codeword lanes per block, dynamic shared-memory bytes) that the
        kernel uses for this code; builds the library."""
        return self.launch_shape()[:2]

    def launch_shape(self, mc: bool = False) -> Tuple[int, int, int, int]:
        """(codeword lanes per block, dynamic shared-memory bytes, lanes a
        thread, blocks an SM keeps resident) of the instance for this code,
        from the library's `<name>_config` (the last by
        cudaOccupancyMaxActiveBlocksPerMultiprocessor); builds the library.
        A code no block shape takes raises, and so does the megakernel of a
        one-lane instance (not built)."""
        out = [ctypes.c_int(0) for _ in range(4)]
        lib = load_library(self.library).cdll
        err = getattr(lib, f"{self.library}_config")(
            self.ct.nb, self.ct.Z, self.ct.mb, self.ct.n_entries,
            self.star_deg, int(self.dec.early_term), int(mc),
            max(len(row) for row in self.ct.entries), int(self.template),
            *(ctypes.byref(o) for o in out))
        check_launch(lib, self.library, err)
        return tuple(o.value for o in out)


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


class McDecoder:
    """The Monte-Carlo megakernel (K1-MC) of `mc_batch` codewords for one
    code and config: random words -> info bits -> structured QC encode ->
    BPSK/AWGN/demap/quantize -> decode -> per-lane counters, in one launch
    of the `MC` instance of the schedule's library, or plainly.

    Words come from Philox4x32-10 keyed by the 64-bit `seed` (`ops/rng`)
    and counted from global lane `lane0` (a rank's first lane of a batch
    split over a process mesh; 0 otherwise), or, with inject_random, from
    `words` (W, B) int32 (the launch's own lanes), W =
    `rng.word_layout(kb, nb, Z)[2]`. sigma and gain (= 2 * scale /
    sigma**2, float32) are scalars, or with mc_lane_sigma float32 rows
    (B,) `sigma_lane` and `gain_lane`. Calls dispatch on the device of the
    tensor arguments (words, else sigma_lane), else of the code: the CPU
    runs the plain version, CUDA the kernel, anything else raises."""

    def __init__(self, ct: CodeTensors, dec: DecoderConfig,
                 quant: QuantConfig, input_scale: Optional[float],
                 count_info_cols: Optional[int], mc_batch: int,
                 inject_random: bool, mc_lane_sigma: bool):
        from ..codes.qcstruct import detect_enc_struct
        if input_scale is None or count_info_cols is None:
            raise ValueError("mc_batch requires input_scale and "
                             "count_info_cols")
        code = ct.code
        st = (detect_enc_struct(code.base) if code.base is not None
              else None)
        if st is None:
            raise ValueError(f"{code.name}: mc mode requires the encodable "
                             f"QC parity structure")
        if count_info_cols != st.kb:
            raise ValueError("mc mode: count_info_cols must equal the "
                             "structural kb (identity info prefix)")
        if not 0 < mc_batch < 2 ** 31:
            raise ValueError(f"mc_batch={mc_batch} outside [1, 2**31)")
        if float(input_scale) != float(quant.scale):
            raise ValueError("mc mode quantizes with gain = 2 * "
                             "quant.scale / sigma**2: input_scale must be "
                             "quant.scale")
        self.decoder = MinsumDecoder(ct, dec, quant, input_scale,
                                     count_info_cols)
        self.ct, self.dec, self.quant = ct, dec, quant
        self.library = self.decoder.library
        self.batch = mc_batch
        self.inject_random = inject_random
        self.lane_sigma = mc_lane_sigma
        self.cb = st.cb
        self._prologue = make_prologue(code, quant.qmax)
        self.n_words = self._prologue.n_words

    @property
    def counting(self) -> bool:
        return True

    @property
    def batch_tile(self) -> int:
        return self.decoder.batch_tile

    def launch_config(self) -> Tuple[int, int]:
        return self.decoder.launch_config()

    def launch_shape(self) -> Tuple[int, int, int, int]:
        return self.decoder.launch_shape(mc=True)

    def _check(self, words, sigma_lane, gain_lane) -> torch.device:
        B = self.batch
        if (words is not None) != self.inject_random:
            raise ValueError("words must be given exactly when "
                             "inject_random is set")
        if ((sigma_lane is not None) != self.lane_sigma
                or (gain_lane is not None) != self.lane_sigma):
            raise ValueError("sigma_lane and gain_lane must both be given "
                             "exactly when mc_lane_sigma is set")
        devs = set()
        if words is not None:
            if words.dtype != torch.int32:
                raise TypeError(f"words dtype {words.dtype}, expected int32")
            if tuple(words.shape) != (self.n_words, B):
                raise ValueError(f"words shape {tuple(words.shape)}, "
                                 f"expected ({self.n_words}, {B})")
            devs.add(words.device)
        for row in (sigma_lane, gain_lane):
            if row is not None:
                if row.dtype != torch.float32 or tuple(row.shape) != (B,):
                    raise ValueError(f"per-lane rows must be ({B},) "
                                     f"float32")
                devs.add(row.device)
        if len(devs) > 1:
            raise ValueError(f"arguments on several devices: {devs}")
        return devs.pop() if devs else self.ct.device

    def __call__(self, seed: int, sigma=None, gain=None, *,
                 words: Optional[torch.Tensor] = None,
                 sigma_lane: Optional[torch.Tensor] = None,
                 gain_lane: Optional[torch.Tensor] = None,
                 lane0: int = 0) -> Tuple[torch.Tensor, ...]:
        dev = self._check(words, sigma_lane, gain_lane)
        fn = self.plain if dev.type == "cpu" else self.kernel
        return fn(seed, sigma, gain, words=words, sigma_lane=sigma_lane,
                  gain_lane=gain_lane, lane0=lane0)

    def plain(self, seed: int, sigma=None, gain=None, *,
              words: Optional[torch.Tensor] = None,
              sigma_lane: Optional[torch.Tensor] = None,
              gain_lane: Optional[torch.Tensor] = None,
              lane0: int = 0) -> Tuple[torch.Tensor, ...]:
        """The plain torch version, on the arguments' device."""
        global plain_calls
        dev = self._check(words, sigma_lane, gain_lane)
        plain_calls += 1
        if words is None:
            words = rng.words(seed, self.n_words, self.batch, dev,
                              lane0=int(lane0))
        if self.lane_sigma:
            sigma, gain = sigma_lane, gain_lane
        else:
            sigma, gain = np.float32(sigma), np.float32(gain)
        info_t, _, q = self._prologue(words, sigma, gain)
        hard, iters, conv = self.decoder._plain(q.T)        # (B, n)
        err = hard[:, : self.ct.k] ^ info_t.T
        bits = err.sum(dim=1, dtype=torch.int32)
        return bits, (bits > 0).to(torch.int32), iters, conv

    def kernel(self, seed: int, sigma=None, gain=None, *,
               words: Optional[torch.Tensor] = None,
               sigma_lane: Optional[torch.Tensor] = None,
               gain_lane: Optional[torch.Tensor] = None,
               lane0: int = 0) -> Tuple[torch.Tensor, ...]:
        """Launch the MC instance on the current stream of the device."""
        dev = self._check(words, sigma_lane, gain_lane)
        for t in (words, sigma_lane, gain_lane):
            if t is not None and not t.is_contiguous():
                raise ValueError("the kernel needs contiguous arguments")
        seed = int(seed or 0) & ((1 << 64) - 1)

        def ptr(t):
            return None if t is None else t.data_ptr()

        mc = McArgs(seed & 0xFFFFFFFF, seed >> 32,
                    float(np.float32(sigma or 0.0)),
                    float(np.float32(gain or 0.0)), ptr(sigma_lane),
                    ptr(gain_lane), ptr(words), self.cb, int(lane0))
        return self.decoder.launch(dev, self.batch, mc=mc)


def make_decoder(ct: CodeTensors, dec: DecoderConfig, quant: QuantConfig,
                 *, input_scale: Optional[float] = None,
                 count_info_cols: Optional[int] = None,
                 mc_batch: Optional[int] = None,
                 inject_random: bool = False,
                 mc_lane_sigma: bool = False,
                 template: bool = False
                 ) -> Union[MinsumDecoder, McDecoder]:
    """Factory from configs, mirroring `minsum_pallas.make_decoder`;
    (beta, alpha) come from `config.cn_params`, the min* thresholds from
    `config.minstar_thresholds`. mc_batch selects the
    Monte-Carlo megakernel (`McDecoder`), as in the reference. template
    forces the one-lane template (the yardstick the packed and one-lane
    instances are held and timed against; not for the megakernel)."""
    if mc_batch is not None:
        if template:
            raise ValueError("template does not take mc_batch")
        return McDecoder(ct, dec, quant, input_scale, count_info_cols,
                         mc_batch, inject_random, mc_lane_sigma)
    if inject_random or mc_lane_sigma:
        raise ValueError("inject_random and mc_lane_sigma need mc_batch")
    return MinsumDecoder(ct, dec, quant, input_scale, count_info_cols,
                         template)
