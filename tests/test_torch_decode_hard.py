"""Hard-decision decoders of the port (`ldpc_tpu_torch/ops/decode_hard.py`).

Four witnesses on the same numpy-seeded received words, equal exactly (hard
bits, iteration counts, convergence flags; boolean and integer arithmetic,
so the tolerance is 0): the port's batched torch decoders, the port's golden
scalars (`golden.decode_hard`), the reference's JAX ops
(`ldpc_tpu.ops.decode_hard.make_hard_decoder`) and the port's C oracle
(`oracle.decode_hard_batch`). After `tests/test_decode_hard.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.ops.decode_hard import make_hard_decoder as ref_make_hard_decoder
from ldpc_tpu_torch import oracle
from ldpc_tpu_torch.codes.ieee80211n import make_code
from ldpc_tpu_torch.codes.toy import array_qc, hamming74, toy_qc
from ldpc_tpu_torch.golden import decode_hard, encode
from ldpc_tpu_torch.ops import make_hard_decoder
from ldpc_tpu_torch.ops.channel import bsc
from ldpc_tpu_torch.ops.decode_hard import ALGORITHMS

CODES = {"hamming74": hamming74, "toy4": lambda: toy_qc(4),
         "array_qc": array_qc, "wifi648": lambda: make_code(648, "1/2")}


def _received(code, rng, B, p, encodable=True):
    """Codewords through a BSC(p) by injected flips (the all-zeros word
    where the code has no systematic form); word 0 stays clean, so every
    batch holds a lane that is valid on arrival."""
    if encodable:
        clean = np.stack([
            encode(code, rng.integers(0, 2, code.k).astype(np.uint8))
            for _ in range(B)])
    else:
        clean = np.zeros((B, code.n), np.uint8)
    flips = rng.random(clean.shape) < p
    flips[0] = False
    y = bsc(None, torch.as_tensor(clean), p, flips=torch.as_tensor(flips))
    return clean, y.numpy()


def _hold(code, y, golden_lanes=None, **kw):
    """port torch == port oracle == reference JAX op on the batch, == the
    port's golden scalars on `golden_lanes` (all lanes when None)."""
    hard, iters, conv = make_hard_decoder(code, **kw)(torch.as_tensor(y))
    assert (hard.dtype, iters.dtype, conv.dtype) == (torch.uint8,
                                                     torch.int32, torch.bool)
    hard, iters, conv = hard.numpy(), iters.numpy(), conv.numpy()
    ho, io, co = oracle.decode_hard_batch(y, code, **kw)
    np.testing.assert_array_equal(hard, ho)
    np.testing.assert_array_equal(iters, io)
    np.testing.assert_array_equal(conv, co)
    hr, ir, cr = map(np.asarray, jax.jit(ref_make_hard_decoder(code, **kw))(
        jnp.asarray(y)))
    np.testing.assert_array_equal(hard, hr)
    np.testing.assert_array_equal(iters, ir)
    np.testing.assert_array_equal(conv, cr)
    lanes = range(len(y)) if golden_lanes is None else golden_lanes
    for b in lanes:
        g = decode_hard(y[b], code, **kw)
        np.testing.assert_array_equal(hard[b], g.hard)
        assert int(iters[b]) == g.iters and bool(conv[b]) == g.converged
    return hard, iters, conv


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("name", ["hamming74", "toy4", "array_qc"])
def test_small_codes_four_witnesses(name, algorithm, rng):
    code = CODES[name]()
    _, y = _received(code, rng, 48, 0.035 if name == "array_qc" else 0.12,
                     encodable=name != "array_qc")
    _, iters, conv = _hold(code, y, max_iter=12, algorithm=algorithm)
    assert iters[0] == 0 and conv[0]          # the lane valid on arrival
    assert iters.max() > 0


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_wifi648_four_witnesses(algorithm, rng):
    code = CODES["wifi648"]()
    clean, y = _received(code, rng, 12, 0.03)
    hard, iters, conv = _hold(code, y, max_iter=20, algorithm=algorithm)
    np.testing.assert_array_equal(hard[0], clean[0])
    assert iters[0] == 0 and conv[0] and iters.max() > 0


@pytest.mark.parametrize("algorithm,threshold", [
    ("gallager-b", 2), ("gallager-a", 1), ("bit-flip", 2), ("bit-flip", 1)])
def test_threshold_override(algorithm, threshold, rng):
    code = toy_qc(4)
    _, y = _received(code, rng, 32, 0.1)
    _hold(code, y, max_iter=10, algorithm=algorithm, threshold=threshold)
    code = array_qc()
    _, y = _received(code, rng, 32, 0.035, encodable=False)
    _hold(code, y, golden_lanes=range(8), max_iter=12, algorithm=algorithm,
          threshold=threshold)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("name", ["toy4", "wifi648"])
def test_without_early_termination(name, algorithm, rng):
    code = CODES[name]()
    _, y = _received(code, rng, 8, 0.1 if name == "toy4" else 0.02)
    _, iters, _ = _hold(code, y, max_iter=6, algorithm=algorithm,
                        early_term=False)
    assert (iters == 6).all()


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_noiseless_batch_takes_zero_iterations(algorithm, rng):
    code = CODES["wifi648"]()
    clean, _ = _received(code, rng, 4, 0.0)
    hard, iters, conv = make_hard_decoder(code, algorithm=algorithm)(
        torch.as_tensor(clean))
    np.testing.assert_array_equal(hard.numpy(), clean)
    assert (iters == 0).all() and conv.all()


def test_behaviour_on_the_regular_code(rng):
    """Where Gallager's analysis applies (the (3,6)-regular array code, the
    all-zeros word, p = 0.02) message passing beats bit-flipping, and a
    converged lane satisfies every check."""
    code = array_qc()
    _, y = _received(code, rng, 256, 0.02, encodable=False)
    conv = {}
    for alg in ("gallager-b", "bit-flip"):
        hard, _, c = make_hard_decoder(code, max_iter=30, algorithm=alg)(
            torch.as_tensor(y))
        conv[alg] = int(c.sum())
        for b in np.nonzero(c.numpy())[0][:16]:
            assert not code.syndrome(hard[b].numpy()).any()
    assert conv["gallager-b"] > conv["bit-flip"]


def test_bad_algorithm_is_refused():
    with pytest.raises(ValueError):
        make_hard_decoder(toy_qc(4), algorithm="nope")
    with pytest.raises(ValueError):
        decode_hard(np.zeros(24, np.int32), toy_qc(4), algorithm="nope")
    with pytest.raises(KeyError):
        oracle.decode_hard_batch(np.zeros((1, 24), np.uint8), toy_qc(4),
                                 algorithm="nope")
