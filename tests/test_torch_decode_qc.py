"""The port's QC-structured plain decoder (ldpc_tpu_torch.ops.decode_qc),
the plain version of the streaming CUDA library and the `torch-qc` route:
against the JAX QC decoder (ldpc_tpu.ops.decode_qc) and golden
(`decode_fixed`) on equal int8 inputs made from a numpy seed. Tolerance 0 on
hard bits, iteration counts and convergence flags: a fixed-point decoder is
an integer program.

Also the random-QC-topology fuzz of the port's two plain decoders
(`decode_ref`, edge gathers, and `decode_qc`, rolls), after
tests/test_kernels.py's fuzz of the Pallas kernel: random base matrices
with row degrees down to 2 and zero shifts, against golden."""
import functools

import jax
import numpy as np
import pytest
import torch

from ldpc_tpu.codes.code import expand_qc
from ldpc_tpu.codes.ieee80211n import make_code
from ldpc_tpu.codes.nr_bg import make_code as make_nr
from ldpc_tpu.codes.toy import toy_qc
from ldpc_tpu.golden.decoder import decode_fixed
from ldpc_tpu.ops import decode_qc as jqc
from ldpc_tpu_torch import DecoderConfig, QuantConfig
from ldpc_tpu_torch.codes import own_code
from ldpc_tpu_torch.ops import decode_qc as tqc
from ldpc_tpu_torch.ops import decode_ref as tref

torch.set_num_threads(2)

CODES = {
    "toy": lambda: toy_qc(8),
    "wifi648": lambda: make_code(648, "1/2"),
    "nr-bg2-z16": lambda: make_nr(base_graph=2, Z=16),
}
# name -> (beta, alpha, min* thresholds)
CN = {"oms": (2, None, None), "nms": (0, (3, 2), None),
      "minstar": (0, None, (8, 3, 0))}


@functools.lru_cache(maxsize=None)
def _code(name):
    return CODES[name]()


def _llrs(rng, B, n, qmax):
    """Half easy lanes, half noisy; lane 0 a clean codeword."""
    x = rng.normal(0, 40, size=(B, n))
    x[: B // 2] = rng.normal(30, 25, size=(B // 2, n))
    x[0] = 60
    scale = qmax / 127.0
    return np.clip(np.round(x * scale), -qmax, qmax).astype(np.int8)


def _golden(chan, code, **kw):
    rs = [decode_fixed(row.astype(np.int32), code, **kw) for row in chan]
    return (np.stack([r.hard for r in rs]), np.array([r.iters for r in rs]),
            np.array([r.converged for r in rs]))


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(g.numpy().dtype))


# The whole matrix on the toy code; on the real codes, whose JAX decoder
# takes 5-20 s to compile, cases that cover every value of every axis (min*
# there is `slow`: 20 s and more each; tests/test_torch_minstar.py holds the
# plain min* decoders to the JAX QC decoder on n=648 in the fast lane).
CASES = [("toy", s, et, cn, bits) for s in ("flooding", "layered")
         for et in (False, True) for cn in sorted(CN) for bits in (8, 6)] + [
    ("wifi648", "flooding", False, "oms", 8),
    ("wifi648", "layered", True, "nms", 6),
    pytest.param("wifi648", "layered", False, "minstar", 8,
                 marks=pytest.mark.slow),
    pytest.param("wifi648", "flooding", True, "minstar", 6,
                 marks=pytest.mark.slow),
    ("nr-bg2-z16", "layered", True, "oms", 8),
    ("nr-bg2-z16", "flooding", False, "nms", 8),
    pytest.param("nr-bg2-z16", "layered", False, "minstar", 6,
                 marks=pytest.mark.slow),
]


@pytest.mark.parametrize("code_name,schedule,early_term,cn,bits", CASES)
def test_qc_decoder_equals_jax_and_golden(code_name, schedule, early_term, cn,
                                          bits):
    """port decode_qc == JAX make_qc_decoder on every lane, == golden on
    the first lanes (golden decodes one codeword at a time)."""
    code = _code(code_name)
    beta, alpha, minstar = CN[cn]
    qmax = (1 << (bits - 1)) - 1
    kw = dict(max_iter=5, beta=beta, qmax=qmax, schedule=schedule,
              early_term=early_term, alpha=alpha, minstar=minstar)
    rng = np.random.default_rng(17)
    B = 16 if code_name == "toy" else 8
    chan = _llrs(rng, B, code.n, qmax)
    got = tqc.make_qc_decoder(own_code(code), **kw)(torch.as_tensor(chan))
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int32
    assert got[2].dtype == torch.bool
    want = jax.jit(jqc.make_qc_decoder(code, **kw))(chan)
    _assert_equal(got, want)
    n_gold = 4 if code_name == "toy" else 2
    gold = _golden(chan[:n_gold], code, **kw)
    _assert_equal([g[:n_gold] for g in got], gold)
    if early_term:
        assert int(got[1][0]) == 0 and bool(got[2][0])
    else:
        assert (got[1] == 5).all()


@pytest.mark.parametrize("algorithm,beta_lsb,schedule", [
    ("min-sum", 0, "flooding"), ("offset-min-sum", 2, "layered"),
    ("normalized-min-sum", 0, "layered"), ("min-star", 2, "layered"),
])
def test_make_decoder_reads_the_configs_as_the_reference(algorithm, beta_lsb,
                                                         schedule):
    """`make_decoder(code, DecoderConfig, QuantConfig)` of both packages:
    cn_params' (beta, alpha), min* thresholds from the scale, and min*
    ignoring beta_lsb."""
    import ldpc_tpu.config as rcfg
    code = _code("toy")
    chan = _llrs(np.random.default_rng(3), 12, code.n, 127)
    dec = dict(algorithm=algorithm, schedule=schedule, max_iter=4,
               early_term=True)
    quant = dict(bits=8, scale=4.0, beta_lsb=beta_lsb, alpha_num=3,
                 alpha_shift=2)
    got = tqc.make_decoder(own_code(code), DecoderConfig(**dec),
                           QuantConfig(**quant))(torch.as_tensor(chan))
    want = jqc.make_decoder(code, rcfg.DecoderConfig(**dec),
                            rcfg.QuantConfig(**quant))(chan)
    _assert_equal(got, want)


def test_qc_decoder_refusals():
    code = own_code(_code("toy"))
    with pytest.raises(ValueError, match="min-star does not compose"):
        tqc.make_qc_decoder(code, beta=2, minstar=(8, 3, 0))
    with pytest.raises(ValueError):
        tqc.make_qc_decoder(code, schedule="serial")
    with pytest.raises(ValueError, match="min-sum family"):
        tqc.make_decoder(code, DecoderConfig(algorithm="sum-product"),
                         QuantConfig())
    import dataclasses
    no_qc = dataclasses.replace(code, base=None, Z=None)
    with pytest.raises(ValueError, match="QC structure"):
        tqc.make_qc_decoder(no_qc)


def _random_qc(seed):
    """A random QC code as tests/test_kernels.py draws them: mb x nb base
    matrix, every row of degree >= 2, every column covered, shift 0 among
    the shifts."""
    rng = np.random.default_rng(seed)
    Z = int(rng.choice([3, 5, 8, 16]))
    mb, nb = int(rng.integers(2, 5)), int(rng.integers(5, 9))
    base = np.full((mb, nb), -1, np.int64)
    for i in range(mb):
        deg = int(rng.integers(2, nb + 1))
        cols = rng.choice(nb, size=deg, replace=False)
        base[i, cols] = rng.integers(0, Z, size=deg)
    for j in range(nb):
        if (base[:, j] < 0).all():
            base[rng.integers(mb), j] = 0
    base[0, np.nonzero(base[0] >= 0)[0][0]] = 0
    return expand_qc(base, Z, name=f"fuzz{seed}", standard_exact=False)


@pytest.mark.parametrize("seed", range(12))
def test_plain_decoders_on_random_qc_topologies(seed):
    """decode_ref (edge gathers) == decode_qc (rolls) == golden on a random
    QC topology, schedule, CN update and termination mode."""
    code = _random_qc(seed)
    rng = np.random.default_rng(1000 + seed)
    schedule = ("flooding", "layered")[seed % 2]
    beta, alpha, minstar = CN[sorted(CN)[seed % 3]]
    early_term = bool((seed // 2) % 2)
    kw = dict(max_iter=4, beta=beta, qmax=127, early_term=early_term,
              alpha=alpha, minstar=minstar)
    chan = _llrs(rng, 6, code.n, 127)
    own = own_code(code)
    qc = tqc.make_qc_decoder(own, schedule=schedule, **kw)(
        torch.as_tensor(chan))
    maker = (tref.make_layered_decoder if schedule == "layered"
             else tref.make_flooding_decoder)
    ref = maker(own, **kw)(torch.as_tensor(chan))
    gold = _golden(chan, code, schedule=schedule, **kw)
    _assert_equal(qc, gold)
    _assert_equal(ref, gold)
