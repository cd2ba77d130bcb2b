"""The packed sweep and minsum kernels (S1 `sweep_kernel`, S2 `minsum_kernel`
of ldpc_tpu_torch/kernels/csrc/microbench.cu) against the references, on
the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them to the plain
versions there). Here a numpy emulation of their datapaths, over the whole
batch, is held with tolerance 0 to the Pallas bodies of
scripts/microbench_rot.py in interpret mode and to the port's plain versions:
four codeword lanes a 32-bit word (byte k = lane k), the totals as 16x2
pairs that wrap per half, the entry tables read from the words the kernel's
parameters hold (`graph_tables`), S2's check row kept as one byte a lane
(min(|v|, qmax) in 7 bits and the sign of v) and emitted from those bytes,
its messages stored negated at their declared width (int32 or int16) in
the script's shared slots, read and written in base-row order. The shape rule
(`block_shape`, `smem_bytes`, `pick_lanes`) is checked against
hand-computed lanes and bytes, and the wrapper's constants against the
source's.
"""
import functools
import importlib.util
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ldpc_tpu_torch.kernels import microbench as mb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = np.uint32(0x80808080)


# --- the kernel's word operations on uint32 arrays -------------------------

def prmt(a, b, sel):
    """PTX prmt.b32 in its default mode: byte k of the result is byte
    (nibble k & 7) of (b:a), or that byte's sign replicated when nibble k
    has bit 3 set."""
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32)
    src = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    out = np.zeros(np.broadcast(a, b).shape, np.uint32)
    for k in range(4):
        s = (sel >> (4 * k)) & 0xF
        byte = ((src >> np.uint64(8 * (s & 7))) & np.uint64(0xFF)).astype(
            np.uint32)
        if s & 8:
            byte = np.where(byte & 0x80, 0xFF, 0).astype(np.uint32)
        out |= byte << np.uint32(8 * k)
    return out


def _halves(x):
    x = np.asarray(x, np.uint32)
    return ((x & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int32),
            (x >> 16).astype(np.uint16).view(np.int16).astype(np.int32))


def _pack(lo, hi):
    return ((lo.astype(np.int64).astype(np.uint32) & np.uint32(0xFFFF))
            | ((hi.astype(np.int64).astype(np.uint32) & np.uint32(0xFFFF))
               << np.uint32(16)))


def vadd2(a, b):
    """__vadd2: a + b per 16-bit half, wrapping, no carry between halves."""
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _pack(al + bl, ah + bh)


def vsub2(a, b):
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _pack(al - bl, ah - bh)


def vneg2(a):
    (al, ah) = _halves(a)
    return _pack(-al, -ah)


def vmins2(a, b):
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _pack(np.minimum(al, bl), np.minimum(ah, bh))


def vmaxs2(a, b):
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _pack(np.maximum(al, bl), np.maximum(ah, bh))


def widen(w):
    """int8 lanes 0, 1 and 2, 3 of w as sign-extended 16x2 pairs."""
    return prmt(w, 0, 0x9180), prmt(w, 0, 0xB3A2)


def bytes_of(lo, hi, sel=0x6420):
    return prmt(lo, hi, sel)


def _words(chan):
    """chan (nb, Z, B) int8 -> (nb * Z, W) uint32 words of four lanes,
    lanes past B zero (the kernel loads 0 there)."""
    nb, Z, B = chan.shape
    W = -(-B // 4)
    ch = np.zeros((nb * Z, 4 * W), np.int8)
    ch[:, :B] = chan.reshape(nb * Z, B)
    return np.ascontiguousarray(ch).view(np.uint32)


def _out(lo, hi, shape):
    """The totals' low bytes, the lanes of the batch only."""
    nb, Z, B = shape
    w = np.ascontiguousarray(bytes_of(lo, hi))
    return w.view(np.int8)[:, :B].reshape(nb, Z, B)


def _rot(y, s, Z):
    """row + s, less Z where that reaches Z (s < Z), as the kernels index."""
    c = y + s
    return np.where(c >= Z, c - Z, c)


# --- the datapaths ---------------------------------------------------------

def emulate_sweep(chan, iters, use_rot=True, g=None):
    """sweep_kernel over the batch: two buffers of 16x2 totals, each column
    gathered from its entries' rotated rows (table words col_ent), the
    low byte out. Returns (out int8 (nb, Z, B), the last totals as int16
    halves)."""
    g = g or mb.wifi648()
    tw = mb.graph_tables(g, use_rot)
    nb, Z = g.nb, g.Z
    o_col, o_cent = g.mb + 1, g.mb + nb + 2 + g.n_entries
    chw = _words(chan)
    src = widen(chw)
    y = np.arange(Z)
    for _ in range(2 * (iters // 2)):
        dst = (np.empty_like(src[0]), np.empty_like(src[1]))
        for j in range(nb):
            rows = slice(j * Z, (j + 1) * Z)
            lo, hi = widen(chw[rows])
            for q in range(int(tw[o_col + j]), int(tw[o_col + j + 1])):
                c = j * Z + _rot(y, int(tw[o_cent + q] & 0x7FF), Z)
                lo, hi = vadd2(lo, src[0][c]), vadd2(hi, src[1][c])
            dst[0][rows], dst[1][rows] = lo, hi
        src = dst
    return _out(*src, chan.shape), src


def emulate_minsum(chan, iters, c2v_bytes=4, qmax=127, g=None, tw=None):
    """minsum_kernel over the batch, on the table words tw (default
    `graph_tables`). Returns (out int8 (nb, Z, B), the largest |total| any
    half held)."""
    g = g or mb.wifi648()
    tw = mb.graph_tables(g) if tw is None else tw
    nb, Z, mbr, E = g.nb, g.Z, g.mb, g.n_entries
    o_col, o_ent = mbr + 1, mbr + nb + 2
    o_cent, o_slot = o_ent + E, o_ent + 2 * E
    chw = _words(chan)
    W = chw.shape[1]
    tot = widen(chw)
    # shared memory of the negated messages: c2v_bytes uint32 words a lane
    # word
    msg = np.zeros((E * Z, W, c2v_bytes), np.uint32)

    def ld_msg(idx):
        w = msg[idx]
        if c2v_bytes == 4:
            return (prmt(w[..., 0], w[..., 1], 0x5410),
                    prmt(w[..., 2], w[..., 3], 0x5410))
        return w[..., 0], w[..., 1]

    def st_msg(idx, nv):
        if c2v_bytes == 4:
            msg[idx] = np.stack([prmt(nv, 0, s) for s in
                                 (0x8880, 0x9991, 0xAAA2, 0xBBB3)], -1)
        else:
            msg[idx] = np.stack(widen(nv), -1)

    y = np.arange(Z)
    q2 = np.uint32(qmax * 0x00010001)
    most = max(np.abs(h).max() for t in tot for h in _halves(t))
    for _ in range(2 * (iters // 2)):
        # C phase: every check row y of every base row, base rows in order
        for li in range(mbr):
            e0, e1 = int(tw[li]), int(tw[li + 1])
            min1 = [np.full((Z, W), 0x40004000, np.uint32) for _ in range(2)]
            min2 = [np.full((Z, W), 0x40004000, np.uint32) for _ in range(2)]
            ns = np.zeros((Z, W), np.uint32)
            rb = []
            for e in range(e0, e1):
                en = int(tw[o_ent + e])
                var = (en >> 11) + _rot(y, en & 0x7FF, Z)
                neg = ld_msg(int(tw[o_slot + e]) + y)     # -old
                raw, m = [], []
                for k in range(2):
                    raw.append(vadd2(tot[k][var], neg[k]))
                    m.append(vmins2(vmaxs2(raw[k], vneg2(raw[k])), q2))
                    min2[k] = vmins2(min2[k], vmaxs2(min1[k], m[k]))
                    min1[k] = vmins2(min1[k], m[k])
                w = bytes_of(m[0], m[1]) | (bytes_of(raw[0], raw[1], 0x7531)
                                            & H)
                ns ^= w
                rb.append(w)
            m1, m2 = bytes_of(*min1), bytes_of(*min2)
            for e, w in zip(range(e0, e1), rb):
                x = (w & np.uint32(0x7F7F7F7F)) ^ m1
                ne = prmt(x + np.uint32(0x7F7F7F7F), 0, 0xBA98)
                mag = (m1 & ne) | (m2 & ~ne)
                sm = prmt(w ^ ns, 0, 0xBA98)
                negm = (H - mag) ^ H
                nw = (mag & sm) | (negm & ~sm)            # -new
                st_msg(e * Z + y, nw)
                sz = int(tw[o_slot + e])
                if sz != e * Z:
                    st_msg(sz + y, nw)
        # V phase: chan - the sum of each column's negated messages
        new = (np.empty_like(tot[0]), np.empty_like(tot[1]))
        for j in range(nb):
            rows = slice(j * Z, (j + 1) * Z)
            s_lo = s_hi = np.zeros((Z, W), np.uint32)
            for q in range(int(tw[o_col + j]), int(tw[o_col + j + 1])):
                ce = int(tw[o_cent + q])
                r = y - (ce & 0x7FF)
                m_lo, m_hi = ld_msg((ce >> 11) + np.where(r < 0, r + Z, r))
                s_lo, s_hi = vadd2(s_lo, m_lo), vadd2(s_hi, m_hi)
            c_lo, c_hi = widen(chw[rows])
            new[0][rows], new[1][rows] = vsub2(c_lo, s_lo), vsub2(c_hi, s_hi)
        tot = new
        most = max(most, *(np.abs(h).max() for t in tot for h in _halves(t)))
    return _out(*tot, chan.shape), most


# --- the references --------------------------------------------------------

@pytest.fixture(scope="module")
def rot():
    """scripts/microbench_rot.py, loaded from its file, its pallas_call
    bound to interpret=True."""
    path = os.path.join(ROOT, "scripts", "microbench_rot.py")
    spec = importlib.util.spec_from_file_location("_script_rot_packed", path)
    mod = importlib.util.module_from_spec(spec)
    cwd = os.getcwd()
    os.chdir(ROOT)          # the script puts "." on sys.path
    try:
        spec.loader.exec_module(mod)
    finally:
        os.chdir(cwd)
    attrs = {k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")}
    attrs["pallas_call"] = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = types.SimpleNamespace(**attrs)
    return mod


def _chan(bt, seed=0, lo=-100, hi=100):
    rng = np.random.default_rng(seed)
    g = mb.wifi648()
    return rng.integers(lo, hi, size=(g.nb, g.Z, bt)).astype(np.int8)


def _exact_sweep(chan, iters, use_rot=True):
    """S1's totals as Python integers (no wrap)."""
    g = mb.wifi648()
    c = chan.astype(object)
    a = c.copy()
    for _ in range(2 * (iters // 2)):
        dst = c.copy()
        for row in g.entries:
            for j, s, _ in row:
                dst[j] = dst[j] + np.roll(a[j], -(s if use_rot else 0),
                                          axis=0)
        a = dst
    return a


# --- the emulation against the Pallas bodies (4 sweeps, B = 7) -------------

@pytest.mark.parametrize("use_rot", [True, False], ids=["rot", "base"])
def test_sweep_emulation_equals_pallas(rot, use_rot):
    """B = 7: the second lane word holds three lanes and a padded one."""
    chan = _chan(7, seed=11)
    fn, full = rot.make_sweep((mb.Z, 7), use_rot, iters=4)
    assert full == chan.shape
    want = np.asarray(fn(jnp.asarray(chan)))
    got, _ = emulate_sweep(chan, 4, use_rot)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c2v", ["int32", "int16"])
def test_minsum_emulation_equals_pallas(rot, c2v):
    chan = _chan(7, seed=12)
    fn, _ = rot.make_minsum((mb.Z, 7), c2v_dtype=getattr(jnp, c2v), iters=4)
    want = np.asarray(fn(jnp.asarray(chan)))
    got, most = emulate_minsum(chan, 4, 4 if c2v == "int32" else 2)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got.astype(int)).max() > 0
    assert most <= 128 + 12 * 127


# --- the emulation against the plain versions ------------------------------

@pytest.mark.parametrize("use_rot", [True, False], ids=["rot", "base"])
def test_sweep_emulation_wraps_as_int32_at_44_sweeps(use_rot):
    """44 sweeps: the exact totals leave int32 and int16 many times over;
    the low byte of the 16-bit wrap is the low byte of the 32-bit one."""
    chan = _chan(9, seed=13)
    got, _ = emulate_sweep(chan, 44, use_rot)
    want = mb.sweep_plain(torch.as_tensor(chan), 44, use_rot).numpy()
    np.testing.assert_array_equal(got, want)
    exact = _exact_sweep(chan[:, :, :2], 44, use_rot)
    assert max(abs(int(v)) for v in exact.ravel()) > 2 ** 40


@pytest.mark.parametrize("use_rot", [True, False], ids=["rot", "base"])
def test_sweep_emulation_wraps_int16_where_int32_does_not(use_rot):
    """6 sweeps take the totals past 2^16 but not past 2^31: the 16-bit
    totals wrap where the plain version's int32 ones do not, and the low
    bytes agree."""
    chan = _chan(5, seed=14)
    got, (lo, hi) = emulate_sweep(chan, 6, use_rot)
    want = mb.sweep_plain(torch.as_tensor(chan), 6, use_rot).numpy()
    np.testing.assert_array_equal(got, want)
    exact = np.array([int(v) for v in _exact_sweep(chan, 6, use_rot).ravel()])
    assert 2 ** 16 < np.abs(exact).max() < 2 ** 31
    halves = np.stack(_halves(lo) + _halves(hi))
    assert np.abs(halves).max() < 2 ** 15 <= np.abs(exact).max()


@pytest.mark.parametrize("c2v,bytes_", [("int32", 4), ("int16", 2)])
@pytest.mark.parametrize("B", [1, 6, 8])
def test_minsum_emulation_equals_plain(c2v, bytes_, B):
    chan = _chan(B, seed=20 + B)
    got, most = emulate_minsum(chan, 20, bytes_)
    want = mb.minsum_plain(torch.as_tensor(chan), 20,
                           getattr(torch, c2v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert most <= 128 + 12 * 127


def test_minsum_emulation_at_the_int8_extremes_and_a_smaller_qmax():
    """chan at -128 and 127, and qmax 31: the clip and the totals' bound
    hold."""
    chan = _chan(4, seed=30, lo=-128, hi=128)
    chan[0, :3, 0] = [-128, 127, -128]
    for qmax in (127, 31):
        got, most = emulate_minsum(chan, 6, 2, qmax)
        want = mb.minsum_plain(torch.as_tensor(chan), 6, torch.int16,
                               qmax).numpy()
        np.testing.assert_array_equal(got, want)
        assert most <= 128 + 12 * qmax


def test_shared_slots_change_the_result():
    """The 17 pairs of entries that share a slot are what the body computes:
    tables that gave every entry its own slot give another result."""
    g = mb.wifi648()
    assert sum(s != e for e, s in enumerate(g.slots)) == 17
    chan = _chan(4, seed=31)
    got, _ = emulate_minsum(chan, 4, 4)
    own = mb.graph_tables(g).copy()
    own[-g.n_entries:] = np.arange(g.n_entries) * g.Z
    unshared, _ = emulate_minsum(chan, 4, 4, tw=own)
    assert not np.array_equal(got, unshared)


# --- the tables, the shape rule, the constants ------------------------------

def test_table_words_decode_to_the_graph():
    g = mb.wifi648()
    tw = mb.graph_tables(g)
    E, Z = g.n_entries, g.Z
    o_ent = g.mb + g.nb + 2
    assert tw.dtype == np.uint32 and len(tw) == mb.graph_table_words(g) == 302
    assert not tw.flags.writeable
    flat = [(j, s) for row in g.entries for j, s, _ in row]
    assert [(int(w >> 11) // Z, int(w & 0x7FF))
            for w in tw[o_ent: o_ent + E]] == flat
    np.testing.assert_array_equal(tw[-E:], np.asarray(g.slots) * Z)
    base = mb.graph_tables(g, use_rot=False)
    assert not (base[o_ent: o_ent + 2 * E] & 0x7FF).any()
    np.testing.assert_array_equal(base[o_ent: o_ent + 2 * E] >> 11,
                                  tw[o_ent: o_ent + 2 * E] >> 11)


@pytest.mark.parametrize("c2v,want", [
    # S1: two int16 totals buffers + the int8 channel, 5 * 648 B a lane:
    # four lanes 12,960 B, 16 blocks an SM (233,472 // 13,984), 64
    # codewords, as many as any larger block keeps
    (0, (4, 12960, 16)),
    # S2, int16 messages: one totals buffer, the channel, 2 * 2,376 B of
    # messages: 6,696 B a lane; four lanes 26,784 B, 8 blocks, 32 codewords
    (2, (4, 26784, 8)),
    # S2, int32 messages: 11,448 B a lane; four lanes 45,792 B, 4 blocks
    # (16 codewords); twenty lanes 228,960 B, one block of 135 threads, 20
    # codewords: the most, so the fewest lanes within 9/10 of it are 20
    (4, (20, 228960, 1)),
])
def test_block_shape_hand_computed(c2v, want):
    g = mb.wifi648()
    assert mb.block_shape(g, c2v) == want
    assert mb.pick_lanes(g, c2v) == want[0]
    assert mb.smem_bytes(g, c2v, want[0]) == want[1]


def test_shared_memory_floor_hand_computed():
    """Bytes a codeword and sweep: S1 88 * 27 totals of 2 B, 648 channel
    bytes and 648 new totals of 2 B; S2 a total, an old and a new message a
    gathered entry, 17 * 27 second stores to a shared slot, a message again
    in the V phase, the channel and a total a variable."""
    g = mb.wifi648()
    assert mb.smem_bytes_per_sweep(g, 0) == 2376 * 2 + 648 * 3 == 6696
    assert mb.smem_bytes_per_sweep(g, 4) == (2376 * 10 + 459 * 4 + 2376 * 4
                                             + 648 * 3) == 37044
    assert mb.smem_bytes_per_sweep(g, 2) == (2376 * 6 + 459 * 2 + 2376 * 2
                                             + 648 * 3) == 21870
    # 200 sweeps of 16,384 codewords at 128 B a clock on 132 SMs, 1.755 GHz
    assert mb.smem_floor_ms(g, 0, 16384, 200, 132, 1.755e9) == pytest.approx(
        6696 * 16384 * 200 / (132 * 128 * 1.755e9) * 1e3)
    assert 0.73 < mb.smem_floor_ms(g, 0, 16384, 201, 132, 1.755e9) < 0.75


def test_block_shape_refuses_what_fits_no_block():
    long = mb.Graph(180, 360, 2, (((0, 1, 0), (1, 2, 1)),
                                  ((0, 3, 2), (2, 0, 3))))
    assert mb.block_shape(long, 0) == (0, 0, 0)       # 360 threads > 256
    big = mb.Graph(2400, 27, 1, (((0, 1, 0), (1, 2, 1)),))
    assert mb.smem_bytes(big, 0, 4) == 5 * 2400 * 27 * 4 > mb.MAX_SMEM
    assert mb.pick_lanes(big, 0) == 0


def test_graphs_the_instances_do_not_hold_are_refused():
    chan = torch.zeros((2, 5, 4), dtype=torch.int8, device="meta")
    one = mb.Graph(2, 5, 1, (((0, 1, 0),),))
    with pytest.raises(ValueError, match="base rows of 1-1"):
        mb._launch_sweep("minsum", chan, one, 4, 2, 127, 4)
    two = mb.Graph(2, 5, 1, (((0, 1, 0), (1, 2, 1)),))
    with pytest.raises(ValueError, match="qmax 200"):
        mb._launch_sweep("minsum", chan, two, 4, 2, 200, 4)
    tall = mb.Graph(2, 5, 13, tuple(((0, i % 5, 2 * i), (1, 0, 2 * i + 1))
                                    for i in range(13)))
    gap = mb.Graph(3, 5, 1, (((0, 1, 0), (1, 2, 1)),))
    with pytest.raises(ValueError, match="base columns of 0-1"):
        mb._launch_sweep("sweep", torch.zeros((3, 5, 4), dtype=torch.int8,
                                              device="meta"), gap, 0, 2)
    with pytest.raises(ValueError, match="base columns of 13-13"):
        mb._launch_sweep("sweep", chan, tall, 0, 2)


@pytest.mark.parametrize("py,cu", [
    ("SWEEP_THREADS", "kSweepThreads"), ("ROW_DEG", "kRowDeg"),
    ("COL_DEG", "kColDeg"), ("TAB_WORDS", "kTabWords"),
    ("LANES_PER_THREAD", "kLanesPerThread"), ("SM_SMEM", "kSmSmem"),
    ("BLOCK_RESERVE", "kBlockReserve"), ("SM_WARPS", "kSmWarps"),
    ("SM_BLOCKS", "kSmBlocks"),
])
def test_constants_mirror_the_source(py, cu):
    src = open(os.path.join(ROOT, mb.SOURCE)).read()
    m = re.search(r"constexpr int " + re.escape(cu) + r" = ([0-9]+);", src)
    assert m, cu
    assert getattr(mb, py) == int(m.group(1))


def test_the_source_keeps_the_design():
    """Four lanes a thread, int16 totals that wrap (never the saturating
    add), the tables in the parameters, two barriers a minsum sweep and no
    atomics."""
    src = re.sub(r"//[^\n]*", "", open(os.path.join(ROOT, mb.SOURCE)).read())
    sweeps = src[src.index("__global__ void __launch_bounds__(kSweepThreads)"):
                 src.index("__global__ void int16_kernel")]
    assert "__vaddss2" not in src and "atomic" not in sweeps
    assert sweeps.count("const __grid_constant__ SweepArgs a") == 2
    minsum = sweeps[sweeps.index("minsum_kernel("):]
    assert minsum.count("__syncthreads()") == 3        # load + two a sweep
    assert "s.tab" not in src and "tables_at" not in src
