"""The port's C oracle (`ldpc_tpu_torch/oracle.py`, built from
`ldpc_tpu_torch/csrc/ldpc_oracle.c` by `utils/native.load_native`).

It is held equal, exactly, to the reference's oracle (`ldpc_tpu.oracle`),
to the golden scalars and to the port's plain torch decoders on small
codes; it raises where the reference's library aborts the process; its
loader survives six processes that build at once; and it is the third
witness on the DVB-S2 code beside `ops/decode_qc` and the streaming
decoder's plain version.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldpc_tpu import oracle as ref_oracle
from ldpc_tpu_torch import PRESETS, oracle
from ldpc_tpu_torch.codes import build_code, from_reference
from ldpc_tpu_torch.codes.code import LDPCCode
from ldpc_tpu_torch.codes.ieee80211n import make_code
from ldpc_tpu_torch.codes.toy import hamming74, toy_qc
from ldpc_tpu_torch.golden import decode_fixed
from ldpc_tpu_torch.kernels import minsum_stream
from ldpc_tpu_torch.ops.decode_qc import make_qc_decoder
from ldpc_tpu_torch.ops.decode_ref import (make_flooding_decoder,
                                           make_layered_decoder)
from ldpc_tpu_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODES = {"toy4": lambda: toy_qc(4), "hamming74": hamming74,
         "wifi648": lambda: make_code(648, "1/2")}
# (schedule, early_term, max_iter, CN update)
CASES = [
    ("flooding", False, 6, dict(beta=0)),
    ("flooding", True, 8, dict(beta=2)),
    ("layered", True, 6, dict(beta=0)),
    ("layered", False, 5, dict(beta=2)),
    ("flooding", True, 7, dict(alpha=(3, 2))),
    ("layered", True, 7, dict(alpha=(7, 3), beta=1)),
    ("flooding", True, 6, dict(minstar=(8, 3, 0))),
    ("layered", False, 5, dict(minstar=(8, 3, 0))),
    ("layered", True, 6, dict(minstar=())),
]


def _llrs(rng, B, n, qmax=127):
    x = rng.normal(0, 40, size=(B, n))
    x[: B // 2] = rng.normal(30, 25, size=(B // 2, n))
    return np.clip(np.round(x), -qmax, qmax).astype(np.int8)


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[3]}")
@pytest.mark.parametrize("name", sorted(CODES))
def test_oracle_four_witnesses(name, case, rng):
    """port oracle == reference oracle == port plain torch decoder on the
    batch, == golden.decode_fixed on the first lanes."""
    schedule, early_term, max_iter, cn = case
    code = CODES[name]()
    B = 16
    chan = _llrs(rng, B, code.n)
    kw = dict(max_iter=max_iter, qmax=127, early_term=early_term, **cn)
    got = oracle.decode_batch(chan, code, schedule=schedule, **kw)
    _same(got, ref_oracle.decode_batch(chan, code, schedule=schedule, **kw))
    make = (make_flooding_decoder if schedule == "flooding"
            else make_layered_decoder)
    _same(got, [t.numpy() for t in make(code, **kw)(torch.as_tensor(chan))])
    for b in range(4):
        g = decode_fixed(chan[b].astype(np.int32), code, schedule=schedule,
                         **kw)
        np.testing.assert_array_equal(got[0][b], g.hard)
        assert got[1][b] == g.iters and got[2][b] == g.converged
    assert got[0].dtype == np.uint8 and got[1].dtype == np.int32
    assert got[2].dtype == bool


def test_minstar_does_not_compose_with_beta_or_alpha(rng):
    code = toy_qc(4)
    chan = _llrs(rng, 2, code.n)
    with pytest.raises(ValueError, match="compose"):
        oracle.decode_batch(chan, code, beta=1, minstar=(8, 3, 0))
    with pytest.raises(ValueError, match="compose"):
        oracle.decode_batch(chan, code, alpha=(3, 2), minstar=())


def test_minstar_check_degree_above_64_raises_and_the_process_lives(rng):
    """The reference's library aborts here; the port's returns a status."""
    n = 70
    wide = LDPCCode(name="wide", n=n, m=2, k=n - 2,
                    cn_adj=[np.arange(n), np.arange(0, n, 2)])
    chan = _llrs(rng, 3, n)
    with pytest.raises(ValueError, match="degree <= 64, got 70"):
        oracle.decode_batch(chan, wide, minstar=(8, 3, 0))
    # min-sum takes the same graph, and the library is still loaded
    hard, iters, conv = oracle.decode_batch(chan, wide, max_iter=3)
    g = decode_fixed(chan[0].astype(np.int32), wide, max_iter=3)
    np.testing.assert_array_equal(hard[0], g.hard)
    assert iters[0] == g.iters and conv[0] == g.converged


def test_library_name_follows_the_source(tmp_path):
    src = tmp_path / "x.c"
    src.write_text("int f(void) { return 1; }\n")
    a = native.library_path(str(src), str(tmp_path / "b"))
    src.write_text("int f(void) { return 2; }\n")
    b = native.library_path(str(src), str(tmp_path / "b"))
    assert a != b and os.path.basename(a).startswith("x-")
    lib = native.load_native(str(src), str(tmp_path / "b"))
    assert lib.f() == 2 and os.listdir(tmp_path / "b") == [
        os.path.basename(b)]
    bad = tmp_path / "bad.c"
    bad.write_text("this is not C\n")
    with pytest.raises(RuntimeError, match="failed"):
        native.load_native(str(bad), str(tmp_path / "b"))
    assert os.path.basename(oracle.BUILD_DIR) == "build"
    assert os.path.dirname(oracle.BUILD_DIR) == os.path.dirname(oracle.SOURCE)


def test_six_processes_build_at_once(tmp_path):
    """Six fresh interpreters load the oracle's source into one empty build
    directory at the same time: every one builds to a temporary name,
    renames it into place and decodes; one library file is left."""
    build_dir = str(tmp_path / "build")
    code = (
        "import sys, numpy as np\n"
        "from ldpc_tpu_torch import oracle\n"
        "from ldpc_tpu_torch.codes.toy import toy_qc\n"
        f"oracle.BUILD_DIR = {build_dir!r}\n"
        "code = toy_qc(4)\n"
        "chan = np.full((2, code.n), 9, np.int8)\n"
        "hard, iters, conv = oracle.decode_batch(chan, code)\n"
        "assert not hard.any() and conv.all() and (iters == 0).all()\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0 and out.strip() == "ok", err
    left = os.listdir(build_dir)
    assert len(left) == 1 and left[0].startswith("ldpc_oracle-")
    assert left[0].endswith(".so")


def _third_witness(n, B, early_term, rng):
    """oracle == ops/decode_qc == the streaming decoder's plain version on
    DVB-S2 frames (OMS beta 2, layered), near the waterfall so that lanes
    converge at different iterations."""
    cfg = PRESETS["dvbs2-64800-r12"]
    cfg = dataclasses.replace(cfg, code=dataclasses.replace(cfg.code, n=n))
    code = build_code(cfg)
    sigma = 0.80
    y = 1.0 + sigma * rng.standard_normal((B, code.n))
    chan = np.clip(np.round(2.0 * y / sigma ** 2 * cfg.quant.scale), -127,
                   127).astype(np.int8)
    kw = dict(max_iter=8, beta=2, qmax=127, early_term=early_term)
    want = oracle.decode_batch(chan, code, schedule="layered", **kw)
    t = torch.as_tensor(chan)
    _same(want, [x.numpy() for x in make_qc_decoder(
        code, schedule="layered", **kw)(t)])
    dec = minsum_stream.make_stream_decoder(
        from_reference(code, "cpu"), **kw)
    _same(want, [x.numpy() for x in dec(t)])
    assert want[1].max() > 0
    return want


@pytest.mark.parametrize("early_term", [False, True], ids=["fixed", "et"])
def test_dvbs2_16200_third_witness(early_term, rng):
    _third_witness(16200, 3, early_term, rng)


@pytest.mark.parametrize("early_term", [False, True], ids=["fixed", "et"])
def test_dvbs2_64800_third_witness(early_term, rng):
    """At 8 iterations and this noise some lanes converge and some do not."""
    hard, iters, conv = _third_witness(64800, 3, early_term, rng)
    if early_term:
        assert conv.any() and not conv.all()
