"""S6, `grid1_kernel` of ldpc_tpu_torch/kernels/csrc/microbench.cu, and the
floors that S3-S6 are held to, on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py holds it to the plain
version there, tolerance 0). Here a numpy emulation of its design is held
with tolerance 0 to the Pallas `grid1` of scripts/diag_gridstep.py in
interpret mode and to the port's plain version: a thread i < rows * tile_w
of blocks of GRID1_THREADS owns (row i // tile_w, column i % tile_w) of
every tile, and steps GROUP tiles at once (the source's kGroup), the
ragged rest in groups of 8, 4, 2 and 1; every element is written once. The
floors (`launch_grid`, `issue_floor_ms`, `chain_floor_ms`, `link_pipes`)
are checked at a stated SM count and clock; the device-only timer refuses
the CPU, as do the measurements on the card, and on a faked card calls its
function as often as asked whatever the host's dispatch takes.
"""
import contextlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu_torch.kernels import microbench as mb
from ldpc_tpu_torch.utils import profiling
from test_torch_microbench import _load_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP = 16          # tiles a thread of grid1 steps at once


@pytest.fixture(scope="module")
def gridstep():
    return _load_script("diag_gridstep")


def tile_groups(n_tiles, group=GROUP):
    """(first tile, tiles) of each group a thread steps at once: full
    groups, then the rest (fewer than `group`) in groups of group / 2, ...,
    1, as `tile_rest` takes them."""
    full = n_tiles - n_tiles % group
    out = [(t, group) for t in range(0, full, group)]
    t, g = full, group // 2
    while g:
        if n_tiles - t >= g:
            out.append((t, g))
            t += g
        g //= 2
    return out


def step(v):
    """grid_step on uint32 lanes: max(v ^ (v + 1), v - 3), wrapping int32."""
    p = v ^ (v + np.uint32(1))
    m = v - np.uint32(3)
    return np.where(p.view(np.int32) > m.view(np.int32), p, m)


def emulate_grid1(x, inner, tile_w):
    """The kernel's threads and groups over x (rows, n_tiles * tile_w) int8;
    returns the output and how often each element was written."""
    rows, width = x.shape
    n_tiles = width // tile_w
    n = rows * tile_w
    (blocks, _), threads = mb.launch_grid("grid1", n)
    i = np.arange(blocks * threads)            # blockIdx * threads + tid
    i = i[i < n]                               # the guard
    at = (i // tile_w) * (n_tiles * tile_w) + i % tile_w
    flat_x = x.reshape(-1)
    out = np.full(x.size, 0x55, np.int8)
    writes = np.zeros(x.size, np.int64)
    for t0, g in tile_groups(n_tiles):
        idx = at[:, None] + (t0 + np.arange(g))[None, :] * tile_w
        v = flat_x[idx].astype(np.int32).view(np.uint32)
        for _ in range(inner):
            v = step(v)
        out[idx] = (v & np.uint32(0xFF)).astype(np.uint8).view(np.int8)
        np.add.at(writes, idx, 1)
    return out.reshape(x.shape), writes.reshape(x.shape)


def _x(rows, width, seed=0):
    return np.random.default_rng(seed).integers(
        -128, 128, (rows, width)).astype(np.int8)


@pytest.mark.parametrize("n_tiles", [*range(1, 18), 31, 32, 33, 47])
def test_groups_cover_every_tile_once(n_tiles):
    groups = tile_groups(n_tiles)
    tiles = [t0 + k for t0, g in groups for k in range(g)]
    assert tiles == list(range(n_tiles))
    sizes = [g for _, g in groups]
    assert set(sizes) <= {16, 8, 4, 2, 1}
    assert sizes == sorted(sizes, reverse=True)
    assert sizes.count(16) == n_tiles // 16
    assert len([g for g in sizes if g < 16]) == bin(n_tiles % 16).count("1")


@pytest.mark.parametrize("rows,n_tiles,inner", [
    (27, 32, 400), (1, 3, 7), (26, 33, 400), (26, 1, 7), (2, 31, 400)])
def test_emulation_equals_pallas_grid1_and_plain(gridstep, monkeypatch,
                                                 rows, n_tiles, inner):
    """The reference's shape and ragged ones (its module constants set
    for the call), through the Pallas grid1 in interpret mode."""
    monkeypatch.setattr(gridstep, "Z", rows)
    monkeypatch.setattr(gridstep, "T", n_tiles)
    monkeypatch.setattr(gridstep, "INNER", inner)
    x = _x(rows, n_tiles * gridstep.BT, seed=rows + n_tiles)
    want = np.asarray(gridstep.grid1()(jnp.asarray(x)))
    got, writes = emulate_grid1(x, inner, gridstep.BT)
    np.testing.assert_array_equal(got, want)
    assert (writes == 1).all()
    np.testing.assert_array_equal(
        mb.grid1(torch.as_tensor(x), inner).numpy(), want)


@pytest.mark.parametrize("inner", [400, 7])
@pytest.mark.parametrize("rows", [1, 26])
@pytest.mark.parametrize("n_tiles", [1, 3, 33])
def test_ragged_shapes_through_the_plain_version(rows, n_tiles, inner):
    x = _x(rows, n_tiles * mb.TILE_W, seed=n_tiles)
    got, writes = emulate_grid1(x, inner, mb.TILE_W)
    assert (writes == 1).all()
    t = torch.as_tensor(x)
    mb.reset_counters()
    want = mb.grid1(t, inner)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(mb.grid32(t, inner).numpy(), want.numpy())
    np.testing.assert_array_equal(mb.gridstep_plain(t, inner).numpy(),
                                  want.numpy())
    assert mb.plain_calls["grid1"] == 1
    assert sum(mb.kernel_launches.values()) == 0


@pytest.mark.parametrize("rows,tile_w,n_tiles", [(3, 100, 5), (5, 13, 9)])
def test_a_partial_last_block(rows, tile_w, n_tiles):
    """rows * tile_w not a multiple of the block: the guard drops the last
    block's extra threads."""
    assert rows * tile_w % mb.GRID1_THREADS
    x = _x(rows, n_tiles * tile_w, seed=tile_w)
    got, writes = emulate_grid1(x, 9, tile_w)
    assert (writes == 1).all()
    np.testing.assert_array_equal(
        got, mb.grid1(torch.as_tensor(x), 9, tile_w).numpy())


def test_the_step_wraps_at_int32_max():
    """v = 127 doubles to 2^31 - 1 within 24 steps, where v + 1 wraps: the
    emulation follows the plain version there."""
    x = np.full((1, 8), 127, np.int8)
    v = x.astype(np.int32).view(np.uint32)
    for _ in range(24):
        v = step(v)
    assert v.view(np.int32)[0, 0] == 2 ** 31 - 1
    got, _ = emulate_grid1(x, 40, 8)
    np.testing.assert_array_equal(
        got, mb.gridstep_plain(torch.as_tensor(x), 40).numpy())


def test_launch_grid_is_the_sources():
    n = mb.Z * mb.TILE_W                                    # 13,824 threads
    assert mb.launch_grid("grid1", n) == ((216, 1), 64)     # 432 warps
    assert mb.launch_grid("grid32", n, mb.N_TILES) == ((108, 32), 128)
    assert mb.launch_grid("opchain", n) == ((108, 1), 128)
    assert mb.launch_grid("int16", 64 * 256 // 2) == ((64, 1), 128)
    assert mb.launch_grid("grid1", 65) == ((2, 1), 64)
    with pytest.raises(ValueError):
        mb.launch_grid("sweep", n)


def test_issue_floor_at_132_sms_and_1980_mhz():
    ops = mb.gridstep_cost(mb.Z * mb.N_TILES * mb.TILE_W)[1]
    assert ops == 707_788_800                        # 4 a step
    floor = mb.issue_floor_ms(ops, 132, 1.98e9)
    assert floor == pytest.approx(ops / (64 * 132 * 1.98e9) * 1e3)
    assert round(floor, 4) == 0.0423
    # two of the four on the FMA pipe: each pipe issues half
    assert mb.issue_floor_ms(ops / 2, 132, 1.98e9, ops / 2) == \
        pytest.approx(floor / 2)
    assert mb.issue_floor_ms(ops / 4, 132, 1.98e9, 3 * ops / 4) == \
        pytest.approx(3 * floor / 4)


def test_chain_floor_at_1980_mhz():
    links = mb.OPCHAIN_CHAIN * (64 // 4) * 2000       # S4: 160,000
    assert links == 160_000
    assert mb.chain_floor_ms(links, 4.0, 1.98e9) == pytest.approx(0.32323,
                                                                  rel=1e-4)
    assert mb.chain_floor_ms(links, 4.9, 1.98e9) == pytest.approx(0.39596,
                                                                  rel=1e-4)
    s6 = mb.GRIDSTEP_CHAIN * mb.INNER                 # one element's steps
    assert mb.chain_floor_ms(s6, 4.0, 1.98e9) == pytest.approx(
        1200 * 4 / 1.98e9 * 1e3)


def test_link_pipes_count_each_pipe_a_link():
    step_ops = ["IADD3", "LOP3", "IADD3", "IMNMX"]
    loop = step_ops * 16 + ["IADD3", "ISETP", "BRA"]
    alu, fma = mb.link_pipes(loop, 1)
    assert (alu, fma) == ((4 * 16 + 2) / 16, 0.0)
    moved = ["IMAD", "LOP3", "IADD3", "VIMNMX"] * 8
    assert mb.link_pipes(moved, 1) == (3.0, 1.0)
    pair = ["IADD3", "IABS", "LOP3", "IMNMX", "IMNMX"] * 4
    assert mb.link_pipes(pair, 2) == (5.0, 0.0)
    with pytest.raises(ValueError):
        mb.link_pipes(["IADD3", "BRA"], 1)


def test_link_pipes_of_the_fused_step():
    """The step as nvcc emits it for the H100: v + 1 on the FMA pipe
    (VIADD), v - 3 folded into the max (VIADDMNMX), one link each."""
    loop = ["VIADD", "LOP3", "VIADDMNMX"] * 16 + ["IADD3", "ISETP", "BRA"]
    assert mb.link_pipes(loop, 1) == ((2 * 16 + 2) / 16, 1.0)


class _Event:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


@pytest.mark.parametrize("dispatch_ms,kept", [
    ([0.1, 0.9, 0.1, 0.1, 5.0], 3), ([0.1] * 4, 4), ([0.6, 0.1, 0.1], 2)])
def test_the_device_only_timer_calls_fn_reps_times(monkeypatch, dispatch_ms,
                                                   kept):
    """A call whose dispatch outlasts the spin is left out of the times and
    doubles the spin; it is never repeated, so the launches a caller counts
    do not depend on the host's timing (a fake card and host clock)."""
    now, calls, seq = [0.0], [], list(dispatch_ms)

    def fn():
        now[0] += seq[len(calls)] / 1e3
        calls.append(1)

    monkeypatch.setattr(profiling, "cuda_device", lambda device: device)
    monkeypatch.setattr(profiling, "time",
                        type("T", (), {"perf_counter": lambda: now[0]}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    times = profiling.device_ms(fn, len(dispatch_ms), device="fake")
    assert len(calls) == len(dispatch_ms) and len(times) == kept
    calls.clear()
    seq[:] = [2.0, 2.0]
    with pytest.raises(RuntimeError, match="outlasted every spin"):
        profiling.device_ms(fn, 2, device="fake")
    assert len(calls) == 2


def test_the_device_only_timer_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device only"):
        profiling.device_ms(lambda: None, 1, device="cpu")
    with pytest.raises(ValueError, match="CUDA device only"):
        profiling.device_timed(lambda: None, reps=1, device="cpu")
    with pytest.raises(RuntimeError, match="does not fall back"):
        profiling.device_ms(lambda: None, 1)            # no card here


@pytest.mark.parametrize("call", [
    lambda: mb.launch_floor_ms((1, 1), 32, device="cpu"),
    lambda: mb.empty_launch((1, 1), 32, device="cpu"),
    lambda: mb.chain_probe("cpu"),
])
def test_measurements_on_the_card_refuse_the_cpu(call):
    with pytest.raises(ValueError, match="CUDA device only"):
        call()


def test_grid1_on_a_device_that_is_not_cuda_raises():
    x = torch.zeros((2, 3 * mb.TILE_W), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        mb.grid1(x)


@pytest.mark.parametrize("py,cu", [
    ("THREADS", "kThreads"), ("GRID1_THREADS", "kGridThreads"),
])
def test_constants_mirror_the_source(py, cu):
    """`launch_grid` (hence the launch floor) reads the blocks the source
    launches with."""
    src = open(os.path.join(ROOT, mb.SOURCE)).read()
    m = re.search(r"constexpr int " + re.escape(cu) + r" = ([0-9]+);", src)
    assert m, cu
    assert getattr(mb, py) == int(m.group(1))
