"""The port's threefry draws against jax.random, bit for bit, at the shapes
the group kernel draws: (B, 2+2G+2F) link jitter and (B, G) relay choice
with G=32, F=1024 (the N=1025/R=32 cell), under per-cell keys
PRNGKey(seed * 1_000_003 + ci) up to seed 127; and ``randint`` at the
EPaxos kernel's coordinator draw (a scalar below n) and wider spans."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

B, G, F = 8, 32, 1024
SEEDS = (0, 1, 2, 63 * 1_000_003 + 1, 127 * 1_000_003 + 8)


def _keys():
    return np.stack([np.asarray(jax.random.PRNGKey(s)) for s in SEEDS])


def _t(keys):
    return torch.from_numpy(keys.astype(np.int64))


def test_prngkey_matches():
    for s in SEEDS:
        want = np.asarray(jax.random.key_data(jax.random.key(s)))
        assert np.array_equal(prng.PRNGKey(s).numpy(), want), s


@pytest.mark.parametrize("i", [0, 1, 339, 1364, 400_000])
def test_fold_in_and_split_match(i):
    keys = _keys()
    want_f = np.stack([np.asarray(jax.random.fold_in(k, i)) for k in keys])
    got_f = prng.fold_in(_t(keys), i)
    assert np.array_equal(got_f.numpy(), want_f)
    want_s = np.stack([np.asarray(jax.random.split(k)) for k in want_f])
    assert np.array_equal(prng.split(got_f).numpy(), want_s)
    # the batched form the scan uses: one key per (cell, step)
    steps = torch.arange(i, i + 3)
    got_b = prng.split(prng.fold_in(_t(keys)[:, None, :], steps))
    want_b = np.stack([[np.asarray(jax.random.split(jax.random.fold_in(k, j)))
                        for j in range(i, i + 3)] for k in keys])
    assert np.array_equal(got_b.numpy(), want_b)


@pytest.mark.parametrize("shape", [(B, 2 + 2 * G + 2 * F), (B, G), (3,)])
def test_bits_and_uniform_match(shape):
    keys = np.stack([np.asarray(jax.random.split(
        jax.random.fold_in(k, 7))[1]) for k in _keys()])
    want_bits = np.stack([np.asarray(jax.random.bits(k, shape))
                          for k in keys])
    assert np.array_equal(prng.bits(_t(keys), shape).numpy(),
                          want_bits.astype(np.int64))
    want_u = np.stack([np.asarray(jax.random.uniform(k, shape))
                       for k in keys])
    got_u = prng.uniform(_t(keys), shape)
    assert got_u.dtype == torch.float32
    assert np.array_equal(got_u.numpy(), want_u)


def test_exponential_matches_to_last_ulp():
    """XLA's and torch's log1p may differ in the last ulp (the port rounds
    a float64 log1p; measured: ~7% of draws differ, by at most 1.2e-7
    relative), hence rtol 1e-6 instead of bit equality."""
    shape = (B, 2 + 2 * G + 2 * F)
    keys = np.stack([np.asarray(jax.random.split(
        jax.random.fold_in(k, 3))[0]) for k in _keys()])
    want = np.stack([np.asarray(jax.random.exponential(k, shape))
                     for k in keys])
    got = prng.exponential(_t(keys), shape)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_uniform_is_the_mantissa_construction():
    k = _t(_keys()[:1])
    b = prng.bits(k, (64,))
    u = prng.uniform(k, (64,))
    want = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    assert torch.equal(u, want)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert float(jnp.asarray(0.0)) == 0.0   # jax stays importable alongside


@pytest.mark.parametrize("span", [1, 5, 25, 49, 1000, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(), (7,), (3, 4)])
def test_randint_matches(span, shape):
    """``jax.random.randint(key, shape, 0, span)`` bit for bit: the two
    split halves' bits, each reduced mod span, combined with the
    multiplier (2**16 % span)**2 % span, whose square wraps to 0 at spans
    above 2**16, as JAX's uint32 arithmetic does."""
    keys = np.stack([np.asarray(jax.random.split(
        jax.random.fold_in(k, 11))[0]) for k in _keys()])
    want = np.stack([np.asarray(jax.random.randint(k, shape, 0, span))
                     for k in keys])
    got = prng.randint(_t(keys), shape, 0, span)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert int(got.min()) >= 0 and int(got.max()) < span


def test_randint_batched_keys_and_bounds():
    """The EPaxos kernel's form: one scalar draw per (cell, step) key of
    ``split(fold_in(key, i), 5)[0]``; and minval/maxval other than 0, an
    empty range (minval returned), spans at 2**16."""
    keys = _keys()
    steps = torch.arange(5, 9)
    ks = prng.split(prng.fold_in(_t(keys)[:, None, :], steps), 5)
    got = prng.randint(ks[:, :, 0], (), 0, 25)
    want = np.stack([[int(jax.random.randint(jax.random.split(
        jax.random.fold_in(k, i), 5)[0], (), 0, 25)) for i in range(5, 9)]
        for k in keys])
    assert np.array_equal(got.numpy(), want)
    k = keys[1]
    for lo, hi in ((-7, 20), (3, 2), (5, 5), (0, 2 ** 16), (0, 2 ** 16 + 1),
                   (-(2 ** 30), 2 ** 30 - 1)):
        want = np.asarray(jax.random.randint(k, (6,), lo, hi))
        assert np.array_equal(prng.randint(_t(k), (6,), lo, hi).numpy(),
                              want), (lo, hi)
    with pytest.raises(ValueError, match="span"):
        prng.randint(_t(k), (), 0, 2 ** 31)
