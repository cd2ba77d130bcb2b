"""Microbenchmarks of the decoders' building blocks on one CUDA device
(counterpart of `scripts/microbench_rot.py` and `scripts/diag_gridstep.py`).

    python -m ldpc_tpu_torch.kernels.microbench <variant> [--batch N]
                                                [--device cuda|cpu]

Six hand-written CUDA kernels, one library `csrc/microbench.cu` built with
nvcc at first launch (`build.py`), each beside its plain torch version (and
two that measure the card for the floors of S3-S6: an empty kernel,
`launch_floor_ms`, and a clock64 probe of dependent chains, `chain_probe`):

  variant            kernel                       plain version
  rot, base          `sweep`  (make_sweep)        `sweep_plain`
  minsum, minsum16   `minsum` (make_minsum)       `minsum_plain`
  int16              `int16`  (int16_test)        `int16_plain`
  opshape            `opchain` (make_opchain)     `opchain_plain`
  gridstep           `grid32`, `grid1`            `gridstep_plain`

A wrapper dispatches by its tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. Nothing falls back.
`kernel_launches` and `plain_calls` count both per kernel name.

The reference times two TPU layouts of the same state, `flat` (Z, 512) and
`vreg` (Z, 8, 128): a sublane-alignment question that a GPU does not have.
Here the state is (nb, Z, B) with the batch innermost, a circulant shift is
the index (y + s) mod Z into shared memory, and the two tile widths remain
as batch sizes (`--batch 512`, `1024`) beside `--batch 16384`, the
decoders' batch. The two sweeps run the decoders' packed layout (four
codeword lanes a thread, int16 totals, the tables in the kernel's
parameters: `graph_tables`) in blocks of the decoders' shape rule
(`block_shape`). `minsum32v`, the same sweep under a raised VMEM limit, is
a knob of the TPU compiler and has no counterpart. The reference takes the
best of several host-clock trials and synchronises by fetching the result;
here every point is the median of CUDA-event times (`utils.profiling.timed`)
and, as there, the slope between two iteration counts cancels the launch.
`gridstep` has no slope: on the card it times the device alone
(`utils.profiling.device_timed`), with the event times beside.

Each run prints the card's `nvidia-smi` name and power limit, then one JSON
line with the reference's keys (three lines for `opshape`; for `int16` the
rate line, then the PASS/FAIL line). 13,824 to 55,296 elements (`opshape`)
and 442,368 (`gridstep`) do not fill an H100's 270,336 resident threads:
those variants give the rate of a thread, not of the card.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..codes import build_code, qc_entries
from ..config import PRESETS
from ..device import resolve_device
from ..utils.profiling import (bound, cuda_device, device_ms, device_timed,
                               timed)
from . import build
from .minsum import (BLOCK_RESERVE, LANES_PER_THREAD, MAX_SMEM, SM_BLOCKS,
                     SM_SMEM, SM_WARPS, align16, check_launch, packed_tables)

LIBRARY = "microbench"
SOURCE = f"ldpc_tpu_torch/kernels/csrc/{LIBRARY}.cu"
# kernel name -> the pallas_call site it answers
_ROT, _GRID = "scripts/microbench_rot.py", "scripts/diag_gridstep.py"
REPLACES = {"sweep": f"{_ROT}:91", "minsum": f"{_ROT}:165",
            "int16": f"{_ROT}:208", "opchain": f"{_ROT}:265",
            "grid32": f"{_GRID}:40", "grid1": f"{_GRID}:62"}
VARIANTS = ("rot", "base", "minsum", "minsum16", "int16", "opshape",
            "gridstep")

Z = 27                      # the circulant size of wifi-648
TILE_W, N_TILES = 512, 32   # diag_gridstep's tile and tile count
INNER = 400                 # its dependent steps a tile
QMAX = 127
MIN2_START = 1 << 14
# integer operations of the bounds: one add an entry (sweep), 12 an edge as
# the decoders' rows count them (minsum), 6 a pair of opchain statements
# (subtract, |.| as two, xor, max, min), 4 a gridstep step, 6 for the int16
# expression
MINSUM_OPS_PER_EDGE = 12
# the sweeps' instances (csrc/microbench.cu): threads a block (the launch
# bound), the register row (S2's base rows of 2..ROW_DEG entries), the
# unrolled columns (up to COL_DEG entries) and the table words the kernel
# parameters hold
SWEEP_THREADS = 256
ROW_DEG = 8
COL_DEG = 12
TAB_WORDS = 960
OPCHAIN_OPS_PER_PAIR = 6
GRIDSTEP_OPS_PER_STEP = 4
INT16_OPS = 6
# the register kernels' blocks (kThreads; grid1's kGridThreads)
THREADS = 128
GRID1_THREADS = 64
# the dependent instructions on one element's chain: a grid step (add, xor,
# max; v - 3 runs beside), an opchain pair (sub, abs, xor, max, min), an
# int16 iteration (compare, select, min)
GRIDSTEP_CHAIN = 3
OPCHAIN_CHAIN = 5
INT16_CHAIN = 3
# 32-bit integer lanes an SM a clock on each of the two pipes that issue
# integer work at compute capability 9.0 (the CUDA C Programming Guide's
# throughput table): the ALU pipe (add, logic, shift, compare, select,
# min/max, abs) and the FMA pipe (IMAD and its forms, IMUL, and VIADD:
# S5's loop of VIADD, LOP3 and VIADDMNMX runs faster on the H100 than three
# ALU instructions a step allow)
INT_LANES_PER_SM = 64
ALU_PIPE = frozenset({"IADD3", "LOP3", "IMNMX", "VIMNMX", "VIMNMX3",
                      "VIADDMNMX", "IABS", "ISETP", "SEL", "SHF", "LEA",
                      "PRMT", "PLOP3", "VABSDIFF", "VABSDIFF4", "FLO",
                      "POPC", "BMSK", "SGXT"})
FMA_PIPE = frozenset({"IMAD", "IMUL", "IDP", "VIADD"})
MINMAX_OPS = frozenset({"IMNMX", "VIMNMX", "VIADDMNMX"})

kernel_launches: Dict[str, int] = dict.fromkeys(REPLACES, 0)
plain_calls: Dict[str, int] = dict.fromkeys(REPLACES, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_counters() -> None:
    for name in REPLACES:
        kernel_launches[name] = 0
        plain_calls[name] = 0


class Graph(NamedTuple):
    """The base graph a sweep runs over: per base row the (column, shift,
    entry id) of its circulants."""
    nb: int
    Z: int
    mb: int
    entries: tuple

    @property
    def n_entries(self) -> int:
        return sum(len(row) for row in self.entries)

    @property
    def slots(self) -> Tuple[int, ...]:
        """The message slot of each entry, as the reference's `EIDX` keys
        it: by (column, shift), the last entry with that pair. Entries of
        different base rows that share both share a slot (17 pairs in
        wifi-648), so the later row reads what the earlier one wrote in the
        same sweep; the port keeps what the body computes."""
        last = {(j, s): e for row in self.entries for j, s, e in row}
        return tuple(last[j, s] for row in self.entries for j, s, _ in row)


@functools.lru_cache(maxsize=1)
def wifi648() -> Graph:
    """The 88 circulants of 802.11n n=648 rate 1/2 (12 x 24, Z=27), in the
    order of the reference's `ENTS`, `ROWS` and `EIDX`."""
    qc, entries = qc_entries(build_code(PRESETS["wifi-648-r12-minsum"]))
    g = Graph(int(qc.nb), int(qc.Z), int(qc.mb), entries)
    if min(len(row) for row in entries) < 2:
        raise AssertionError("a base row of degree 1 would emit min2's "
                             "start value")
    return g


def load_library(rebuild: bool = False) -> build.Library:
    """Build (first use) and bind the library: six `microbench_<kernel>_
    launch` entries, the empty kernel's and the chain probe's,
    `microbench_config` and `microbench_error_string`."""
    lib = build.load(LIBRARY, rebuild=rebuild)
    c = lib.cdll
    c.microbench_sweep_launch.argtypes = [_P] * 3 + [_I] * 8 + [_P]
    c.microbench_minsum_launch.argtypes = [_P] * 3 + [_I] * 10 + [_P]
    c.microbench_int16_launch.argtypes = [_P] * 3 + [_I] * 2 + [_P]
    c.microbench_opchain_launch.argtypes = [_P] * 2 + [_I] * 4 + [_P]
    c.microbench_grid32_launch.argtypes = [_P] * 2 + [_I] * 4 + [_P]
    c.microbench_grid1_launch.argtypes = [_P] * 2 + [_I] * 4 + [_P]
    c.microbench_empty_launch.argtypes = [_I] * 3 + [_P]
    c.microbench_chain_probe_launch.argtypes = [_P] * 3 + [_I, _P]
    c.microbench_config.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
    for name in (*REPLACES, "empty", "chain_probe"):
        getattr(c, f"microbench_{name}_launch").restype = _I
    c.microbench_config.restype = _I
    c.microbench_error_string.argtypes = [_I]
    c.microbench_error_string.restype = ctypes.c_char_p
    return lib


def library_config(g: Graph, c2v_bytes: int) -> Tuple[int, ...]:
    """`microbench_config` of the built library (on the card): lanes a
    block, shared-memory bytes and blocks an SM by the shape rule, then the
    blocks an SM by the occupancy API and the registers a thread of the
    instance (-1 where the runtime cannot say)."""
    lib = load_library().cdll
    out = (_I * 5)()
    check_launch(lib, LIBRARY, lib.microbench_config(
        g.nb, g.Z, g.n_entries, c2v_bytes, out))
    return tuple(out)


# ---------------------------------------------------------------------------
# S1, S2: sweeps over the circulants of a base graph
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def graph_tables(g: Graph, use_rot: bool = True) -> np.ndarray:
    """The library's uint32 tables, which travel in the kernel's parameters:
    `minsum.packed_tables` (layer_ptr, col_ptr, ent = (col * Z) << 11 |
    shift by base row, col_ent = (e * Z) << 11 | shift by base column), then
    slot[E] = `Graph.slots` times Z. Without use_rot every shift is 0: the
    kernel runs the same instructions on other addresses."""
    tables = np.concatenate([packed_tables(g), np.asarray(
        g.slots, np.uint32) * np.uint32(g.Z)]).astype(np.uint32)
    if not use_rot:
        E, o_ent = g.n_entries, g.mb + g.nb + 2
        tables[o_ent: o_ent + 2 * E] &= np.uint32(~0x7FF & 0xFFFFFFFF)
    tables.setflags(write=False)
    return tables


def graph_table_words(g: Graph) -> int:
    return g.mb + g.nb + 2 + 3 * g.n_entries


def smem_bytes(g: Graph, c2v_bytes: int, lanes: int) -> int:
    """Dynamic shared memory of a block of `lanes` codewords (state_bytes
    of csrc/microbench.cu), lane index innermost, no tables: for sweep
    (c2v_bytes 0) two int16 totals buffers and the int8 channel; for minsum
    one totals buffer, the channel and E * Z messages of c2v_bytes (2 or 4)
    a lane."""
    n = g.nb * g.Z
    return ((1 if c2v_bytes else 2) * align16(2 * n * lanes)
            + align16(n * lanes)
            + align16(c2v_bytes * g.n_entries * g.Z * lanes))


def block_shape(g: Graph, c2v_bytes: int) -> Tuple[int, int, int]:
    """(lanes a block, shared-memory bytes, blocks an SM) of the sweep
    (c2v_bytes 0) or minsum (2, 4) launch, as block_shape of
    csrc/microbench.cu gives them: the decoders' rule (`minsum.
    packed_shape`). Of the blocks of 4k lanes (LANES_PER_THREAD a thread,
    k * Z <= SWEEP_THREADS threads, state within MAX_SMEM), each holding
    min(SM_SMEM // (smem + BLOCK_RESERVE), SM_WARPS // warps, SM_BLOCKS)
    blocks an SM, the fewest lanes that keep at least 9/10 of the most
    codewords an SM holds; zeros when no block fits."""
    shapes = []
    k = 1
    while k * g.Z <= SWEEP_THREADS:
        lanes = k * LANES_PER_THREAD
        smem = smem_bytes(g, c2v_bytes, lanes)
        if smem > MAX_SMEM:
            break
        warps = -(-k * g.Z // 32)
        shapes.append((lanes, smem, min(SM_SMEM // (smem + BLOCK_RESERVE),
                                        SM_WARPS // warps, SM_BLOCKS)))
        k += 1
    if not shapes:
        return (0, 0, 0)
    most = max(lanes * blocks for lanes, _, blocks in shapes)
    return next(s for s in shapes if 10 * s[0] * s[2] >= 9 * most)


def pick_lanes(g: Graph, c2v_bytes: int) -> int:
    """Codeword lanes a block (`block_shape`), from the shapes alone; 0
    when one block of four lanes fits no SM."""
    return block_shape(g, c2v_bytes)[0]


def _check_chan(chan: torch.Tensor, g: Graph) -> int:
    if chan.dtype != torch.int8:
        raise TypeError(f"chan dtype {chan.dtype}, expected torch.int8")
    if chan.ndim != 3 or tuple(chan.shape[:2]) != (g.nb, g.Z):
        raise ValueError(f"chan shape {tuple(chan.shape)}, expected "
                         f"({g.nb}, {g.Z}, B)")
    if not 0 < chan.shape[2] < 2 ** 31:
        raise ValueError(f"batch {chan.shape[2]} outside (0, 2**31)")
    return int(chan.shape[2])


def _check_graph(name: str, g: Graph, qmax: int) -> None:
    """What the instances hold: columns of 1..COL_DEG entries, tables
    within TAB_WORDS, and for minsum rows of 2..ROW_DEG entries (a row of
    one would emit min2's start value, which no byte holds) and qmax <=
    127 (messages a byte)."""
    col_deg = np.bincount([c for row in g.entries for c, _, _ in row],
                          minlength=g.nb)
    why = []
    if not 1 <= col_deg.min() <= col_deg.max() <= COL_DEG:
        why.append(f"base columns of {col_deg.min()}-{col_deg.max()} "
                   f"entries (1..{COL_DEG})")
    if graph_table_words(g) > TAB_WORDS:
        why.append(f"{graph_table_words(g)} table words (> {TAB_WORDS})")
    if name == "minsum":
        degs = [len(row) for row in g.entries]
        if not 2 <= min(degs) <= max(degs) <= ROW_DEG:
            why.append(f"base rows of {min(degs)}-{max(degs)} entries "
                       f"(2..{ROW_DEG})")
        if not 0 <= qmax <= 127:
            why.append(f"qmax {qmax} (0..127)")
    if why:
        raise ValueError(f"{name}: the kernel takes no graph with "
                         + ", ".join(why))


def _launch_sweep(name: str, chan: torch.Tensor, g: Graph, c2v_bytes: int,
                  *tail: int, use_rot: bool = True) -> torch.Tensor:
    """One launch of the sweep or minsum kernel on chan's device; tail is
    (iters,) or (iters, qmax, c2v_bytes)."""
    B = _check_chan(chan, g)
    if not chan.is_contiguous():
        raise ValueError("the kernel needs a contiguous chan")
    lanes = pick_lanes(g, c2v_bytes)
    if lanes == 0:
        raise ValueError(
            f"{name}: a block of {LANES_PER_THREAD} codewords "
            f"({smem_bytes(g, c2v_bytes, LANES_PER_THREAD)} B at nb={g.nb}, "
            f"Z={g.Z}, E={g.n_entries}) fits no block of {SWEEP_THREADS} "
            f"threads and {MAX_SMEM} B of shared memory")
    _check_graph(name, g, tail[1] if len(tail) > 1 else 0)
    lib = load_library().cdll
    out = torch.empty_like(chan)
    tables = graph_tables(g, use_rot)
    with torch.cuda.device(chan.device):
        stream = torch.cuda.current_stream(chan.device).cuda_stream
        err = getattr(lib, f"microbench_{name}_launch")(
            chan.data_ptr(), out.data_ptr(), tables.ctypes.data, len(tables),
            B, g.nb, g.Z, g.mb, g.n_entries, lanes, *tail, stream)
    check_launch(lib, LIBRARY, err)
    kernel_launches[name] += 1
    return out


def _dispatch(name: str, tensor: torch.Tensor, plain: Callable,
              kernel: Callable) -> torch.Tensor:
    if tensor.device.type == "cpu":
        plain_calls[name] += 1
        return plain()
    if tensor.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{tensor.device}")
    return kernel()


def _rot(x: torch.Tensor, s: int) -> torch.Tensor:
    """The reference's rot_flat: out[y] = x[(y + s) mod Z]."""
    return torch.roll(x, -s, dims=0) if s else x


def sweep_plain(chan: torch.Tensor, iters: int, use_rot: bool = True,
                graph: Optional[Graph] = None) -> torch.Tensor:
    """`iters // 2` pairs of sweeps dst[j] = chan[j] + sum over the entries
    (j, s) of rot(src[j], s) (s = 0 without use_rot) between two int32
    buffers that start at chan; the totals wrap int32; out is their low
    byte. chan (nb, Z, B) int8 -> (nb, Z, B) int8."""
    g = graph or wifi648()
    _check_chan(chan, g)
    chan32 = chan.to(torch.int32)
    ents = [(j, s if use_rot else 0) for row in g.entries for j, s, _ in row]

    def one(src):
        dst = chan32.clone()
        for j, s in ents:
            dst[j] += _rot(src[j], s)
        return dst

    a = chan32
    for _ in range(iters // 2):
        a = one(one(a))
    return a.to(torch.int8)


def sweep(chan: torch.Tensor, iters: int, use_rot: bool = True,
          graph: Optional[Graph] = None) -> torch.Tensor:
    """S1. The gather-and-accumulate sweep (`sweep_plain`), by the CUDA
    kernel on a CUDA tensor."""
    g = graph or wifi648()
    return _dispatch(
        "sweep", chan, lambda: sweep_plain(chan, iters, use_rot, g),
        lambda: _launch_sweep("sweep", chan, g, 0, int(iters),
                              use_rot=bool(use_rot)))


def _c2v_bytes(c2v_dtype: torch.dtype) -> int:
    if c2v_dtype not in (torch.int32, torch.int16):
        raise ValueError(f"c2v dtype {c2v_dtype}: int32 or int16")
    return 4 if c2v_dtype == torch.int32 else 2


def minsum_plain(chan: torch.Tensor, iters: int,
                 c2v_dtype: torch.dtype = torch.int32, qmax: int = QMAX,
                 graph: Optional[Graph] = None) -> torch.Tensor:
    """`iters // 2` pairs of full flooding min-sum sweeps: per base row,
    v2c = clip(rot(src[j], s) - c2v[e], +-qmax); min1 and min2 (from 1 <<
    14) of the magnitudes; the sign from bit 31 of the XOR of the values (a
    zero counts as positive); the excluded minimum chosen by value; c2v[e]
    = new, and rot(new, Z - s) joins chan[j] in the next totals. The
    messages are stored as c2v_dtype, in the slots of `Graph.slots`. chan
    (nb, Z, B) int8 -> int8."""
    g = graph or wifi648()
    _check_chan(chan, g)
    _c2v_bytes(c2v_dtype)
    chan32 = chan.to(torch.int32)
    c2v = torch.zeros((g.n_entries,) + tuple(chan.shape[1:]),
                      dtype=c2v_dtype, device=chan.device)

    slots = g.slots

    def one(src):
        dst = chan32.clone()
        for row in g.entries:
            v2cs = [torch.clamp(
                _rot(src[j], s) - c2v[slots[e]].to(torch.int32), -qmax, qmax)
                for j, s, e in row]
            mags = [v.abs() for v in v2cs]
            min1 = mags[0]
            min2 = torch.full_like(min1, MIN2_START)
            negacc = v2cs[0]
            for v, m in zip(v2cs[1:], mags[1:]):
                min2 = torch.minimum(min2, torch.maximum(min1, m))
                min1 = torch.minimum(min1, m)
                negacc = negacc ^ v
            for (j, s, e), v, m in zip(row, v2cs, mags):
                mag = torch.where(m == min1, min2, min1)
                new = torch.where((negacc ^ v) < 0, -mag, mag)
                c2v[slots[e]] = new.to(c2v_dtype)
                dst[j] += _rot(new, (g.Z - s) % g.Z)
        return dst

    a = chan32
    for _ in range(iters // 2):
        a = one(one(a))
    return a.to(torch.int8)


def minsum(chan: torch.Tensor, iters: int,
           c2v_dtype: torch.dtype = torch.int32, qmax: int = QMAX,
           graph: Optional[Graph] = None) -> torch.Tensor:
    """S2. The full flooding min-sum sweep (`minsum_plain`), by the CUDA
    kernel on a CUDA tensor."""
    g = graph or wifi648()
    nbytes = _c2v_bytes(c2v_dtype)
    return _dispatch(
        "minsum", chan, lambda: minsum_plain(chan, iters, c2v_dtype, qmax, g),
        lambda: _launch_sweep("minsum", chan, g, nbytes, int(iters),
                              int(qmax), nbytes))


# ---------------------------------------------------------------------------
# S3-S6: register kernels
# ---------------------------------------------------------------------------

def _launch_flat(name: str, tensors, out: torch.Tensor, *ints: int
                 ) -> torch.Tensor:
    """One launch of a register kernel: device pointers of `tensors` and
    `out`, then `ints`, then the stream."""
    dev = out.device
    for t in tensors:
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: the kernel needs contiguous tensors "
                             f"on one device")
    lib = load_library().cdll
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"microbench_{name}_launch")(
            *(t.data_ptr() for t in tensors), out.data_ptr(), *ints, stream)
    check_launch(lib, LIBRARY, err)
    kernel_launches[name] += 1
    return out


def int16_plain(a: torch.Tensor, b: torch.Tensor, iters: int = 1
                ) -> torch.Tensor:
    """min(where(a < b, max(a, b), |a|), max(a, 3)) on int16 tensors; with
    iters > 1 the result is fed back as a."""
    three = torch.tensor(3, dtype=torch.int16, device=a.device)
    for _ in range(iters):
        sel = torch.where(a < b, torch.maximum(a, b), a.abs())
        a = torch.minimum(sel, torch.maximum(a, three))
    return a


def int16(a: torch.Tensor, b: torch.Tensor, iters: int = 1) -> torch.Tensor:
    """S3. `int16_plain`, by the CUDA kernel on packed int16 pairs
    (`__vmaxs2`, `__vmins2`, `__vcmplts2`, and `__vabs2`, which wraps as
    the reference's abs does) on CUDA tensors with an even element count."""
    if a.dtype != torch.int16 or b.dtype != torch.int16:
        raise TypeError(f"dtypes {a.dtype}, {b.dtype}, expected int16")
    if a.shape != b.shape or a.numel() == 0:
        raise ValueError(f"shapes {tuple(a.shape)}, {tuple(b.shape)}")

    def kernel():
        if a.numel() % 2:
            raise ValueError("the kernel packs two int16 a word: an even "
                             "element count is needed")
        return _launch_flat("int16", (a, b), torch.empty_like(a),
                            a.numel() // 2, int(iters))

    return _dispatch("int16", a, lambda: int16_plain(a, b, iters), kernel)


def opchain_plain(x: torch.Tensor, n_ops: int, iters: int) -> torch.Tensor:
    """a = x; b = a ^ 11; iters x (n_ops // 4) x (a = |b - a|; b = min(b,
    max(a, b ^ a))) in wrapping int32; out is a's low byte. x int8."""
    a = x.to(torch.int32)
    b = a ^ 11
    for _ in range(iters):
        for _ in range(n_ops // 4):
            a = (b - a).abs()
            b = torch.minimum(b, torch.maximum(a, b ^ a))
    return a.to(torch.int8)


def opchain_ilp(x: torch.Tensor) -> int:
    """Independent elements a thread for an operand of Z, 2Z or 4Z rows
    (the same thread count at every height); 1 for any other shape."""
    rows = x.shape[0] if x.ndim == 2 else 0
    return rows // Z if rows in (Z, 2 * Z, 4 * Z) else 1


def opchain(x: torch.Tensor, n_ops: int, iters: int) -> torch.Tensor:
    """S4. `opchain_plain`, by the CUDA kernel with `opchain_ilp(x)`
    independent chains a thread on a CUDA tensor."""
    if x.dtype != torch.int8 or x.numel() == 0:
        raise TypeError(f"x dtype {x.dtype}, expected non-empty int8")
    return _dispatch(
        "opchain", x, lambda: opchain_plain(x, n_ops, iters),
        lambda: _launch_flat("opchain", (x,), torch.empty_like(x), x.numel(),
                             opchain_ilp(x), int(n_ops) // 4, int(iters)))


def gridstep_plain(x: torch.Tensor, inner: int = INNER) -> torch.Tensor:
    """`inner` dependent v = max(v ^ (v + 1), v - 3) in wrapping int32 on
    every element; out is v's low byte. x int8."""
    v = x.to(torch.int32)
    for _ in range(inner):
        v = torch.maximum(v ^ (v + 1), v - 3)
    return v.to(torch.int8)


def _gridstep(name: str, x: torch.Tensor, inner: int, tile_w: int
              ) -> torch.Tensor:
    if x.dtype != torch.int8 or x.ndim != 2 or x.shape[1] % tile_w:
        raise ValueError(f"x {x.dtype} {tuple(x.shape)}, expected int8 "
                         f"(rows, tiles * {tile_w})")
    return _dispatch(
        name, x, lambda: gridstep_plain(x, inner),
        lambda: _launch_flat(name, (x,), torch.empty_like(x), x.shape[0],
                             tile_w, x.shape[1] // tile_w, int(inner)))


def grid32(x: torch.Tensor, inner: int = INNER, tile_w: int = TILE_W
           ) -> torch.Tensor:
    """S5. `gridstep_plain` with one group of blocks a tile of tile_w
    columns (the grid's second dimension walks the tiles)."""
    return _gridstep("grid32", x, inner, tile_w)


def grid1(x: torch.Tensor, inner: int = INNER, tile_w: int = TILE_W
          ) -> torch.Tensor:
    """S6. `gridstep_plain` with one group of blocks that loops over the
    tiles: a thread a (row, column) in blocks of GRID1_THREADS, stepping
    16 tiles at once (a ragged rest in groups of 8, 4, 2 and 1); inner ==
    INNER runs the instance whose step loop unrolls."""
    return _gridstep("grid1", x, inner, tile_w)


# ---------------------------------------------------------------------------
# Bounds: (bytes moved once, integer operations) of one call
# ---------------------------------------------------------------------------

def sweep_cost(B: int, iters: int, g: Optional[Graph] = None,
               ops_per_entry: int = 1) -> Tuple[int, int]:
    """S1 (one add an entry) or, with MINSUM_OPS_PER_EDGE, S2: int8 in and
    out once; ops_per_entry x E x Z x B a sweep."""
    g = g or wifi648()
    return (2 * g.nb * g.Z * B,
            ops_per_entry * g.n_entries * g.Z * B * 2 * (iters // 2))


SMEM_BYTES_PER_CLOCK = 128     # an SM's shared-memory bandwidth


def smem_bytes_per_sweep(g: Graph, c2v_bytes: int) -> int:
    """Shared-memory bytes a codeword and sweep that the packed S1 (c2v_bytes
    0) or S2 (2, 4) must move, each access counted once at its width a
    lane. S1: a total (2 B) an entry and row, the channel (1 B) and a new
    total (2 B) a variable. S2: in the C phase a total, an old message and
    a new one an entry and row, and the new one again where an entry's slot
    is another's; in the V phase a message an entry and row, and the
    channel and a total a variable."""
    n, EZ = g.nb * g.Z, g.n_entries * g.Z
    if not c2v_bytes:
        return EZ * 2 + n * (1 + 2)
    shared = sum(s != e for e, s in enumerate(g.slots)) * g.Z
    return (EZ * (2 + 2 * c2v_bytes) + shared * c2v_bytes
            + EZ * c2v_bytes + n * (1 + 2))


def smem_floor_ms(g: Graph, c2v_bytes: int, B: int, iters: int, sms: int,
                  clock_hz: float) -> float:
    """The least time of `iters` sweeps (as many as the kernel runs) of B
    codewords at SMEM_BYTES_PER_CLOCK a clock on each of `sms` SMs."""
    sweeps = 2 * (iters // 2)
    return (smem_bytes_per_sweep(g, c2v_bytes) * B * sweeps
            / (sms * SMEM_BYTES_PER_CLOCK * clock_hz) * 1e3)


def opchain_cost(numel: int, n_ops: int, iters: int) -> Tuple[int, int]:
    return 2 * numel, OPCHAIN_OPS_PER_PAIR * (n_ops // 4) * iters * numel


def gridstep_cost(numel: int, inner: int = INNER) -> Tuple[int, int]:
    return 2 * numel, GRIDSTEP_OPS_PER_STEP * inner * numel


def int16_cost(numel: int, iters: int = 1) -> Tuple[int, int]:
    return 3 * 2 * numel, INT16_OPS * iters * numel


# ---------------------------------------------------------------------------
# Floors of S3-S6 beside the bound: launch, integer issue, chain
# ---------------------------------------------------------------------------

def launch_grid(name: str, n: int, tiles: int = 1
                ) -> Tuple[Tuple[int, int], int]:
    """((grid x, grid y), threads a block) of a register kernel's launch,
    as csrc/microbench.cu makes it: n is the threads' work (int16: packed
    words; opchain: elements / elements a thread; grid32, grid1: rows *
    tile_w), tiles grid32's grid.y."""
    if name == "grid1":
        return (-(-n // GRID1_THREADS), 1), GRID1_THREADS
    if name in ("int16", "opchain", "grid32"):
        return (-(-n // THREADS), tiles if name == "grid32" else 1), THREADS
    raise ValueError(f"{name}: not a register kernel")


def empty_launch(grid: Tuple[int, int], threads: int,
                 device="cuda") -> None:
    """One launch of the library's empty kernel with (grid, threads) on the
    device's current stream; CUDA only."""
    dev = cuda_device(device)
    lib = load_library().cdll
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.microbench_empty_launch(int(grid[0]), int(grid[1]),
                                          int(threads), stream)
    check_launch(lib, LIBRARY, err)


def launch_floor_ms(grid: Tuple[int, int], threads: int, reps: int = 50,
                    device="cuda") -> float:
    """Launch floor: the median device-only time (`utils.profiling.
    device_ms`) of the empty kernel launched with a call's (grid,
    threads): what a launch of that shape costs the card with no work in
    it. Measured on the card; raises elsewhere."""
    dev = cuda_device(device)
    return statistics.median(device_ms(
        lambda: empty_launch(grid, threads, dev), reps, device=dev))


def issue_floor_ms(alu_ops: float, sms: int, clock_hz: float,
                   fma_ops: float = 0.0) -> float:
    """Integer-issue floor: the least time in which `sms` SMs at clock_hz
    issue a call's 32-bit integer instructions, each pipe's at
    INT_LANES_PER_SM lanes a clock (alu_ops on the ALU pipe, fma_ops on
    the FMA pipe, counted in lane operations: a thread's instruction counts
    one); the larger of the two pipes."""
    return max(alu_ops, fma_ops) / (INT_LANES_PER_SM * sms * clock_hz) * 1e3


def chain_floor_ms(links: float, latency_cycles: float,
                   clock_hz: float) -> float:
    """Chain floor: the time of one element's longest chain, `links`
    dependent instructions each waiting latency_cycles for the one before,
    at clock_hz: no design runs an element faster."""
    return links * latency_cycles / clock_hz * 1e3


def link_pipes(loop_ops: List[str], minmax_per_link: int
               ) -> Tuple[float, float]:
    """(ALU, FMA) instructions a link of a chain (an S5/S6 step: one
    max; an S4 pair: a max and a min), from the opcodes of the loop that
    runs the links (`cuobjdump -sass`, loop control included): the loop's
    instructions of each pipe over the links it holds, counted by its
    min/max instructions."""
    links = sum(op in MINMAX_OPS for op in loop_ops) / minmax_per_link
    if not links:
        raise ValueError("the loop holds no min/max instruction")
    return (sum(op in ALU_PIPE for op in loop_ops) / links,
            sum(op in FMA_PIPE for op in loop_ops) / links)


def chain_probe(device="cuda") -> Dict[str, float]:
    """Cycles (clock64) a link of one thread's chain of dependent links, by
    link: "grid_step" (an S5/S6 step), "opchain_pair" (an S4 pair). Run on
    the card; raises elsewhere."""
    dev = cuda_device(device)
    lib = load_library().cdll
    vals = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    per_link = torch.zeros(2, dtype=torch.float64, device=dev)
    sink = torch.zeros(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for _ in range(2):                 # the first run warms the code
            for pair in range(2):
                check_launch(lib, LIBRARY, lib.microbench_chain_probe_launch(
                    vals.data_ptr(), per_link[pair:].data_ptr(),
                    sink[pair:].data_ptr(), pair, stream))
    return dict(zip(("grid_step", "opchain_pair"), per_link.tolist()))


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def device_line(dev: torch.device) -> str:
    """The card's `nvidia-smi` name and power limit; "cpu" for the CPU."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[dev.index or torch.cuda.current_device()].strip()


def _slope(fn: Callable[[int], object], i1: int, i2: int, reps: int,
           dev: torch.device) -> Tuple[float, float, float]:
    """(t1, t2, seconds per iteration): medians at two iteration counts and
    their slope, which cancels the launch and the IO."""
    t1 = timed(fn, i1, reps=reps, device=dev)
    t2 = timed(fn, i2, reps=reps, device=dev)
    return t1, t2, (t2 - t1) / (i2 - i1)


def run_sweep(variant: str, batch: int, iters: Tuple[int, int], reps: int,
              dev: torch.device) -> dict:
    """`rot`, `base`, `minsum` or `minsum16` on `batch` codewords."""
    g = wifi648()
    rng = np.random.default_rng(0)
    chan = torch.as_tensor(rng.integers(
        -100, 100, size=(g.nb, g.Z, batch)).astype(np.int8)).to(dev)
    if variant in ("rot", "base"):
        fn = functools.partial(sweep, chan, use_rot=variant == "rot")
        ops = 1
    else:
        dt = torch.int16 if variant == "minsum16" else torch.int32
        fn = functools.partial(minsum, chan, c2v_dtype=dt)
        ops = MINSUM_OPS_PER_EDGE
    t1, t2, per = _slope(lambda i: fn(iters=i), *iters, reps, dev)
    kelem = g.nb * g.Z * batch / 1000.0
    bound_ms, bound_by = bound(*sweep_cost(batch, iters[1], g, ops))
    return {"variant": variant, "batch_tile": batch,
            "t_small_ms": round(t1 * 1e3, 3), "t_big_ms": round(t2 * 1e3, 3),
            "us_per_sweep": round(per * 1e6, 3),
            "ns_per_kelem": round(per * 1e9 / kelem, 3),
            "iters": list(iters), "bound_ms": bound_ms,
            "bound_by": bound_by}


def run_opshape(iters: Tuple[int, int], reps: int, dev: torch.device,
                shapes=((Z, 64), (2 * Z, 32), (4 * Z, 16))) -> List[dict]:
    """The same total element-ops at 1, 2 and 4 independent elements a
    thread (operands of Z, 2Z, 4Z rows of 512 lanes)."""
    rng = np.random.default_rng(0)
    records = []
    for rows, n_ops in shapes:
        x = torch.as_tensor(rng.integers(
            -100, 100, size=(rows, TILE_W)).astype(np.int8)).to(dev)
        t1, t2, per = _slope(lambda i: opchain(x, n_ops, i), *iters, reps,
                             dev)
        kelem = rows * TILE_W / 1000.0
        bound_ms, bound_by = bound(*opchain_cost(x.numel(), n_ops, iters[1]))
        records.append({
            "variant": f"opshape_{rows}x{TILE_W}", "ops_per_iter": n_ops,
            "us_per_iter": round(per * 1e6, 3),
            "ns_per_kelem_per_op": round(per * 1e9 / kelem / n_ops, 4),
            "elements_per_thread": opchain_ilp(x),
            "t_small_ms": round(t1 * 1e3, 3), "t_big_ms": round(t2 * 1e3, 3),
            "iters": list(iters), "bound_ms": bound_ms,
            "bound_by": bound_by})
    return records


def run_int16(iters: Tuple[int, int], reps: int, dev: torch.device
              ) -> List[dict]:
    """The rate of the packed int16 chain beside the int32 chain of
    `opshape` on the same element count, then the PASS/FAIL probe against
    numpy."""
    rng = np.random.default_rng(0)
    a = rng.integers(-120, 120, size=(64, 256)).astype(np.int16)
    b = rng.integers(-120, 120, size=(64, 256)).astype(np.int16)
    shape = (Z, TILE_W)
    ra, rb = (torch.as_tensor(rng.integers(-120, 120, size=shape).astype(
        np.int16)).to(dev) for _ in range(2))
    _, _, per16 = _slope(lambda i: int16(ra, rb, i), *iters, reps, dev)
    kelem = ra.numel() / 1000.0
    x32 = run_opshape(iters, reps, dev, shapes=((Z, 64),))[0]
    rate = {"variant": "int16_rate", "elements": ra.numel(),
            "ops_per_iter": INT16_OPS,
            "us_per_iter": round(per16 * 1e6, 4),
            "ns_per_kelem_per_op": round(per16 * 1e9 / kelem / INT16_OPS, 4),
            "int32_ns_per_kelem_per_op": x32["ns_per_kelem_per_op"],
            "iters": list(iters)}
    out = int16(torch.as_tensor(a).to(dev), torch.as_tensor(b).to(dev))
    ref = np.minimum(np.where(a < b, np.maximum(a, b), np.abs(a)),
                     np.maximum(a, np.int16(3)))
    ok = np.array_equal(out.cpu().numpy(), ref)
    return [rate, {"variant": "int16", "pass": bool(ok)}]


def run_gridstep(reps: int, dev: torch.device) -> dict:
    """The same work as 32 groups of blocks and as one group looping over
    32 tiles; the outputs must be equal bit for bit. On the card the times
    are the device's alone (`utils.profiling.device_timed`), with the
    CUDA-event times around each call, the host's dispatch inside, beside
    them (`*_event_ms`); on the CPU the plain versions' host-clock times."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(
        -100, 100, (Z, N_TILES * TILE_W)).astype(np.int8)).to(dev)
    if not torch.equal(grid32(x), grid1(x)):
        raise AssertionError("grid32 and grid1 differ")
    clock = device_timed if dev.type == "cuda" else timed
    t32 = clock(grid32, x, reps=reps, device=dev)
    t1 = clock(grid1, x, reps=reps, device=dev)
    bound_ms, bound_by = bound(*gridstep_cost(x.numel()))
    rec = {"variant": "grid_step_overhead",
           "grid32_ms": round(t32 * 1e3, 4), "grid1_ms": round(t1 * 1e3, 4),
           "per_step_us": round((t32 - t1) / (N_TILES - 1) * 1e6, 4),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if dev.type == "cuda":
        for name, fn in (("grid32", grid32), ("grid1", grid1)):
            rec[f"{name}_event_ms"] = round(
                timed(fn, x, reps=reps, device=dev) * 1e3, 4)
    return rec


# (small, big) iteration counts of the slopes, as the reference's
DEFAULT_ITERS = {"rot": (200, 800), "base": (200, 800),
                 "minsum": (200, 800), "minsum16": (200, 800),
                 "opshape": (20000, 80000), "int16": (20000, 80000)}


def main(argv=None) -> List[dict]:
    """Runs one variant, prints the device line and its JSON lines, and
    returns the records it printed (each also names its device)."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("variant", choices=VARIANTS)
    ap.add_argument("--batch", type=int, default=512,
                    help="codewords of rot/base/minsum/minsum16 (the "
                         "reference's tiles: 512, 1024; the decoders': "
                         "16384)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu, "
                         "which times the plain versions")
    ap.add_argument("--iters", type=int, nargs=2, metavar=("SMALL", "BIG"),
                    help="the slope's two iteration counts")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed calls a point (the median is kept)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    line = device_line(dev)
    print(line, flush=True)
    iters = tuple(args.iters or DEFAULT_ITERS.get(args.variant, (0, 0)))
    if args.variant == "gridstep":
        records = [run_gridstep(args.reps, dev)]
    elif args.variant == "opshape":
        records = run_opshape(iters, args.reps, dev)
    elif args.variant == "int16":
        records = run_int16(iters, args.reps, dev)
    else:
        records = [run_sweep(args.variant, args.batch, iters, args.reps,
                             dev)]
    for rec in records:
        if rec["variant"] != "int16":   # the PASS/FAIL line is the script's
            rec["device"] = line
        print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
