"""The Monte-Carlo megakernel's random stream (ldpc_tpu_torch.ops.rng):
the plain Philox4x32-10 against an independent numpy uint64 version and
Random123's published known answers, and the stream contract (a lane's
words depend on (seed, lane, word) only). Tolerance 0 throughout."""
import numpy as np
import pytest
import torch

from ldpc_tpu_torch.ops import rng as trng

M = np.uint64(0xFFFFFFFF)


def _philox_numpy(ctr, key, rounds=10):
    """Philox4x32 on uint64 arrays: the products fit 64 bits exactly."""
    c = [np.atleast_1d(np.asarray(x, np.uint64)) for x in ctr]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + np.uint64(0x9E3779B9)) & M, \
                (k1 + np.uint64(0xBB67AE85)) & M
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & M,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & M]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's kat_vectors for philox4x32, 10 rounds."""
    got = trng.philox4x32(tuple(torch.tensor([c], dtype=torch.int64)
                                for c in ctr), key)
    assert [int(x) for x in got] == list(want)
    assert [int(x[0]) for x in _philox_numpy(ctr, key)] == list(want)


def test_philox_matches_numpy_reference(rng):
    """Random counters and keys, extremes included: the 16-bit split
    multiply of the int64 version equals the exact uint64 products."""
    n = 5000
    ctr = rng.integers(0, 1 << 32, (4, n), dtype=np.uint64)
    ctr[:, :4] = 0xFFFFFFFF
    ctr[:, 4:8] = 0
    for key in ((0, 0), (0xFFFFFFFF, 0xFFFFFFFF),
                tuple(int(x) for x in rng.integers(0, 1 << 32, 2))):
        got = trng.philox4x32(tuple(torch.as_tensor(c.astype(np.int64))
                                    for c in ctr), key)
        want = _philox_numpy(ctr, key)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
            assert int(g.min()) >= 0 and int(g.max()) <= 0xFFFFFFFF


def test_words_layout_is_the_counter_contract():
    """Word w of lane b is output w % 4 of the block at counter (w // 4,
    b lo, b hi, 0) under key (seed lo, seed hi), as int32 bits."""
    seed, W, B, lane0 = 0x0123456789ABCDEF, 11, 5, (1 << 32) - 2
    w = trng.words(seed, W, B, "cpu", lane0=lane0)
    assert w.dtype == torch.int32 and w.shape == (W, B)
    for b in range(B):
        lane = lane0 + b
        for j in range(W):
            out = _philox_numpy((j // 4, lane & 0xFFFFFFFF, lane >> 32, 0),
                                (seed & 0xFFFFFFFF, seed >> 32))
            want = out[j % 4].astype(np.uint32).view(np.int32)[0]
            assert int(w[j, b]) == int(want)


def test_lane_invariance():
    """Lanes [0, 32) of a B=64 draw equal a B=32 draw, and lanes [32, 64)
    equal a draw that starts at lane 32: no dependence on the batch size
    or the split of the batch."""
    W = trng.word_layout(12, 24, 27)[2]
    big = trng.words(77, W, 64, "cpu")
    np.testing.assert_array_equal(big[:, :32].numpy(),
                                  trng.words(77, W, 32, "cpu").numpy())
    np.testing.assert_array_equal(big[:, 32:].numpy(),
                                  trng.words(77, W, 32, "cpu",
                                             lane0=32).numpy())
    assert not torch.equal(big, trng.words(78, W, 64, "cpu"))


def test_word_layout():
    assert trng.word_layout(12, 24, 27) == (324, 12, 324 + 2 * 12 * 27)
    assert trng.word_layout(20, 24, 81) == (1620, 12, 1620 + 24 * 81)
    assert trng.word_layout(3, 7, 4) == (12, 4, 12 + 2 * 4 * 4)


def test_words_are_uniform_enough():
    """A coarse check of the family: bit 0 (the info bits) is balanced and
    the top byte is spread over all values."""
    w = trng.words(2024, 400, 256, "cpu").numpy().view(np.uint32)
    assert abs((w & 1).mean() - 0.5) < 0.01
    top = np.bincount((w >> 24).ravel(), minlength=256)
    assert top.min() > 0.7 * top.mean() and top.max() < 1.3 * top.mean()
