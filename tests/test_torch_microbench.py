"""The port's microbenchmark kernels (`ldpc_tpu_torch/kernels/microbench.py`)
against the Pallas bodies of `scripts/microbench_rot.py` and
`scripts/diag_gridstep.py`.

On the CPU a wrapper runs its plain torch version (the CUDA kernels are held
to the same plain versions on the card by `chip_smoke.py`); the Pallas
bodies run in interpret mode. The scripts pass no `interpret=` flag and are
not edited: each is loaded from its file and the loaded module's `pl` is
replaced by a stand-in whose `pallas_call` has `interpret=True` bound.
Inputs are numpy-seeded and go through both; every output is an integer
array and the tolerance is 0.
"""
import functools
import importlib.util
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ldpc_tpu_torch.kernels import build
from ldpc_tpu_torch.kernels import microbench as mb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    path = os.path.join(ROOT, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    cwd = os.getcwd()
    os.chdir(ROOT)          # the scripts put "." on sys.path
    try:
        spec.loader.exec_module(mod)
    finally:
        os.chdir(cwd)
    attrs = {k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")}
    attrs["pallas_call"] = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = types.SimpleNamespace(**attrs)
    return mod


@pytest.fixture(scope="module")
def rot():
    return _load_script("microbench_rot")


@pytest.fixture(scope="module")
def gridstep():
    return _load_script("diag_gridstep")


def _chan(bt, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-100, 100, size=(mb.wifi648().nb, mb.Z, bt)).astype(
        np.int8)


def test_graph_is_the_scripts(rot):
    g = mb.wifi648()
    assert (g.nb, g.Z, g.mb, g.n_entries) == (rot.NB, rot.Z, 12, 88)
    assert [(j, s) for row in g.entries for j, s, _ in row] == rot.ENTS
    assert [[(j, s) for j, s, _ in row] for row in g.entries] == rot.ROWS
    # the script keys its message slots by (column, shift): 17 pairs of
    # entries share one, and the port keeps what the body computes
    assert g.slots == tuple(rot.EIDX[p] for p in rot.ENTS)
    assert len(set(g.slots)) == 71 and g.slots[-1] == 87
    assert min(len(row) for row in g.entries) >= 2


@pytest.mark.parametrize("use_rot", [True, False], ids=["rot", "base"])
def test_sweep_equals_pallas(rot, use_rot):
    chan = _chan(8)
    fn, full = rot.make_sweep((mb.Z, 8), use_rot, iters=4)
    assert full == chan.shape
    want = np.asarray(fn(jnp.asarray(chan)))
    mb.reset_counters()
    got = mb.sweep(torch.as_tensor(chan), 4, use_rot)
    assert got.dtype == torch.int8 and mb.plain_calls["sweep"] == 1
    np.testing.assert_array_equal(got.numpy(), want)
    if use_rot:     # the shift matters
        base = mb.sweep(torch.as_tensor(chan), 4, False)
        assert not torch.equal(got, base)


def test_sweep_with_wrapped_totals_equals_pallas(rot):
    """44 sweeps multiply the totals by up to 12 each: they wrap int32 many
    times over, and the int8 output is the low byte of what is left."""
    chan = _chan(8, seed=1)
    iters = 44
    fn, _ = rot.make_sweep((mb.Z, 8), True, iters=iters)
    want = np.asarray(fn(jnp.asarray(chan)))
    got = mb.sweep(torch.as_tensor(chan), iters)
    np.testing.assert_array_equal(got.numpy(), want)
    # the totals did leave int32: exact integers disagree with the wrap
    g = mb.wifi648()
    a = chan[:, :, 0].astype(object)
    for _ in range(iters):
        dst = chan[:, :, 0].astype(object)
        for row in g.entries:
            for j, s, _ in row:
                dst[j] = dst[j] + np.roll(a[j], -s)
        a = dst
    assert max(abs(int(v)) for v in a.ravel()) > 2 ** 40
    low = np.array([((int(v) + 128) % 256) - 128 for v in a.ravel()],
                   np.int8).reshape(a.shape)
    np.testing.assert_array_equal(got.numpy()[:, :, 0], low)


@pytest.mark.parametrize("c2v", ["int32", "int16"])
def test_minsum_equals_pallas(rot, c2v):
    chan = _chan(8, seed=2)
    fn, _ = rot.make_minsum((mb.Z, 8), c2v_dtype=getattr(jnp, c2v), iters=4)
    want = np.asarray(fn(jnp.asarray(chan)))
    mb.reset_counters()
    got = mb.minsum(torch.as_tensor(chan), 4, getattr(torch, c2v))
    assert mb.plain_calls["minsum"] == 1
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(got.numpy().astype(int)).max() > 0


@pytest.mark.slow
def test_minsum_vreg_layout_is_the_same_function(rot):
    """The reference's second layout, (Z, 8, 128), differs in tiling only:
    the port's one layout answers both."""
    chan = _chan(16, seed=3)
    fn, _ = rot.make_minsum((mb.Z, 2, 8), iters=2)
    want = np.asarray(fn(jnp.asarray(chan.reshape(24, mb.Z, 2, 8))))
    got = mb.minsum(torch.as_tensor(chan), 2)
    np.testing.assert_array_equal(got.numpy(), want.reshape(chan.shape))


def test_int16_equals_pallas_and_numpy(rot, capsys):
    rot.int16_test()
    assert json.loads(capsys.readouterr().out.strip())["pass"] is True
    rng = np.random.default_rng(0)
    a = rng.integers(-120, 120, size=(64, 256)).astype(np.int16)
    b = rng.integers(-120, 120, size=(64, 256)).astype(np.int16)
    ref = np.minimum(np.where(a < b, np.maximum(a, b), np.abs(a)),
                     np.maximum(a, np.int16(3)))
    got = mb.int16(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the extremes, where a saturating |.| would differ from the wrapping one
    a[0, :4] = [-32768, -32767, 32767, 0]
    b[0, :4] = [5, -32768, -32768, -32768]
    ref = np.minimum(np.where(a < b, np.maximum(a, b), np.abs(a)),
                     np.maximum(a, np.int16(3)))
    got = mb.int16(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(got.numpy(), ref)
    twice = mb.int16(torch.as_tensor(a), torch.as_tensor(b), iters=2)
    np.testing.assert_array_equal(
        twice.numpy(), mb.int16_plain(got, torch.as_tensor(b)).numpy())


@pytest.mark.parametrize("rows,n_ops", [(27, 64), (54, 32), (108, 16)])
def test_opchain_equals_pallas(rot, rows, n_ops):
    rng = np.random.default_rng(rows)
    x = rng.integers(-100, 100, size=(rows, 16)).astype(np.int8)
    want = np.asarray(rot.make_opchain((rows, 16), n_ops, iters=3)(
        jnp.asarray(x)))
    got = mb.opchain(torch.as_tensor(x), n_ops, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert mb.opchain_ilp(torch.as_tensor(x)) == rows // 27


def test_grid32_equals_grid1_equals_plain(gridstep):
    rng = np.random.default_rng(0)
    x = rng.integers(-100, 100, (gridstep.Z, gridstep.T * gridstep.BT)
                     ).astype(np.int8)
    w32 = np.asarray(gridstep.grid32()(jnp.asarray(x)))
    w1 = np.asarray(gridstep.grid1()(jnp.asarray(x)))
    np.testing.assert_array_equal(w32, w1)
    assert (mb.Z, mb.TILE_W, mb.N_TILES, mb.INNER) == (
        gridstep.Z, gridstep.BT, gridstep.T, gridstep.INNER)
    t = torch.as_tensor(x)
    mb.reset_counters()
    np.testing.assert_array_equal(mb.grid32(t).numpy(), w32)
    np.testing.assert_array_equal(mb.grid1(t).numpy(), w1)
    assert mb.plain_calls["grid32"] == mb.plain_calls["grid1"] == 1
    assert sum(mb.kernel_launches.values()) == 0


def test_refusals():
    chan = torch.as_tensor(_chan(4))
    with pytest.raises(RuntimeError, match="does not fall back"):
        mb.main(["minsum", "--batch", "4"])          # cuda, and no card here
    with pytest.raises(TypeError):
        mb.sweep(chan.to(torch.int32), 2)
    with pytest.raises(ValueError, match="expected"):
        mb.minsum(chan[:, :5], 2)
    with pytest.raises(ValueError, match="int32 or int16"):
        mb.minsum(chan, 2, torch.int8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mb.sweep(chan.to("meta"), 2)
    with pytest.raises(ValueError):
        mb.grid32(torch.zeros((27, 100), dtype=torch.int8))


def test_a_state_that_fits_no_block_is_refused():
    """Lanes come from the shapes, by the decoders' packed rule (four lanes
    a thread; the fewest lanes within 9/10 of the most codewords an SM
    holds); a code whose block of four codewords exceeds the 227 KB of a
    block, or whose Z exceeds the 256 threads of the launch bound, gets no
    launch."""
    g = mb.wifi648()
    assert mb.pick_lanes(g, 0) == 4 and mb.pick_lanes(g, 2) == 4
    assert mb.pick_lanes(g, 4) == 20
    for c2v in (0, 2, 4):
        lanes, smem, blocks = mb.block_shape(g, c2v)
        assert smem == mb.smem_bytes(g, c2v, lanes) <= mb.MAX_SMEM
        assert blocks * (smem + mb.BLOCK_RESERVE) <= mb.SM_SMEM
        assert lanes % mb.LANES_PER_THREAD == 0
        assert lanes // mb.LANES_PER_THREAD * g.Z <= mb.SWEEP_THREADS
    long = mb.Graph(180, 360, 2, (((0, 1, 0), (1, 2, 1)),
                                  ((0, 3, 2), (2, 0, 3))))
    assert mb.pick_lanes(long, 0) == 0
    wide = mb.Graph(2, 2000, 1, (((0, 1, 0), (1, 2, 1)),))
    assert mb.pick_lanes(wide, 4) == 0
    chan = torch.zeros((180, 360, 2), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="fits no block"):
        mb._launch_sweep("sweep", chan, long, 0, 2)


REFERENCE_KEYS = {
    "rot": {"variant", "batch_tile", "t_small_ms", "t_big_ms",
            "us_per_sweep", "ns_per_kelem"},
    "minsum16": {"variant", "batch_tile", "t_small_ms", "t_big_ms",
                 "us_per_sweep", "ns_per_kelem"},
    "opshape": {"variant", "ops_per_iter", "us_per_iter",
                "ns_per_kelem_per_op"},
    "gridstep": {"variant", "grid32_ms", "grid1_ms", "per_step_us"},
}


@pytest.mark.parametrize("variant", sorted(REFERENCE_KEYS))
def test_entry_point_prints_the_reference_keys(variant, capsys):
    argv = {"rot": ["--batch", "4", "--iters", "2", "4"],
            "minsum16": ["--batch", "4", "--iters", "2", "4"],
            "opshape": ["--iters", "1", "2"],
            "gridstep": []}[variant]
    records = mb.main([variant, *argv, "--device", "cpu", "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    assert [json.loads(line) for line in lines[1:]] == records
    assert len(records) == (3 if variant == "opshape" else 1)
    for rec in records:
        assert REFERENCE_KEYS[variant] <= set(rec) and rec["device"] == "cpu"
        assert rec["bound_by"] in ("bytes", "operations")
    if variant == "opshape":
        assert [r["variant"] for r in records] == [
            "opshape_27x512", "opshape_54x512", "opshape_108x512"]
    if variant == "gridstep":
        assert records[0]["variant"] == "grid_step_overhead"


def test_int16_entry_prints_rate_then_pass(capsys):
    records = mb.main(["int16", "--iters", "1", "2", "--device", "cpu",
                       "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"variant": "int16", "pass": True}
    assert records[0]["variant"] == "int16_rate"
    assert {"ns_per_kelem_per_op", "int32_ns_per_kelem_per_op"} <= set(
        records[0])


def test_base_variant_differs_in_the_tables_shifts_only():
    g = mb.wifi648()
    rot, base = mb.graph_tables(g), mb.graph_tables(g, use_rot=False)
    E = g.n_entries
    ents = slice(g.mb + g.nb + 2, g.mb + g.nb + 2 + 2 * E)   # ent, col_ent
    assert rot.dtype == base.dtype == np.uint32
    assert len(rot) == mb.graph_table_words(g) == 13 + 25 + 3 * 88
    assert not (base[ents] & 0x7FF).any() and (rot[ents] & 0x7FF).any()
    np.testing.assert_array_equal(rot[ents] >> 11, base[ents] >> 11)
    keep = np.ones(len(rot), bool)
    keep[ents] = False
    np.testing.assert_array_equal(rot[keep], base[keep])
    np.testing.assert_array_equal(rot[-E:], np.asarray(g.slots) * g.Z)


def test_bounds_count_what_the_call_needs():
    g = mb.wifi648()
    nbytes, ops = mb.sweep_cost(16384, 800)
    assert nbytes == 2 * 648 * 16384 and ops == 88 * 27 * 16384 * 800
    assert mb.sweep_cost(16384, 801, g, 12)[1] == 12 * ops
    assert mb.opchain_cost(27 * 512, 64, 10) == (2 * 13824,
                                                 6 * 16 * 10 * 13824)
    assert mb.gridstep_cost(27 * 16384) == (2 * 442368, 4 * 400 * 442368)
    assert mb.int16_cost(16384) == (6 * 16384, 6 * 16384)


def test_build_hash_covers_the_source(tmp_path, monkeypatch):
    """The library's file name moves with `microbench.cu`, which includes no
    header of the decoders."""
    srcs = build.sources(mb.LIBRARY)
    assert [p.name for p in srcs] == ["microbench.cu"]
    assert os.path.join(ROOT, mb.SOURCE) == str(srcs[0])
    before = build.library_path(mb.LIBRARY)
    copy = tmp_path / "csrc"
    copy.mkdir()
    (copy / "microbench.cu").write_text(srcs[0].read_text() + "\n// edit\n")
    monkeypatch.setattr(build, "CSRC", copy)
    assert build.library_path(mb.LIBRARY).name != before.name
    text = srcs[0].read_text()
    for name in mb.REPLACES:
        assert f"int microbench_{name}_launch(" in text
    assert "minsum_flood" not in text.replace("minsum_flood.cu", "")
