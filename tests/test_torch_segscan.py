"""The port's log-step segmented scans equal repro.core.segscan exactly
(max is exact, so the doubling scan and XLA's associative scan agree bit
for bit) on random ragged layouts."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import segscan as ref
from repro_torch.core import segscan

_cummax = jax.jit(ref.seg_cummax, static_argnames="axis")
_start = jax.jit(functools.partial(ref.seg_start_index, axis=0))


def _layout(rng, n):
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.integers(1, 9)))
    sizes[-1] -= sum(sizes) - n
    first = np.zeros(n, bool)
    first[np.cumsum([0] + sizes[:-1])] = True
    return first


@pytest.mark.parametrize("n", [1, 2, 7, 24, 33, 256, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_seg_cummax_matches_reference(n, seed):
    rng = np.random.default_rng(seed * 1000 + n)
    first = _layout(rng, n)
    x = rng.normal(size=(5, n)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.inf
    x[rng.random(x.shape) < 0.1] = -np.inf
    want = np.asarray(_cummax(jnp.asarray(x), jnp.asarray(first), axis=1))
    got = segscan.seg_cummax(torch.from_numpy(x), torch.from_numpy(first),
                             dim=1)
    assert np.array_equal(got.numpy(), want)
    # axis 0, with per-row start flags broadcast against the columns
    xt = np.ascontiguousarray(x.T)
    want0 = np.asarray(_cummax(jnp.asarray(xt), jnp.asarray(first[:, None]),
                               axis=0))
    got0 = segscan.seg_cummax(torch.from_numpy(xt),
                              torch.from_numpy(first[:, None]), dim=0)
    assert np.array_equal(got0.numpy(), want0)


@pytest.mark.parametrize("n", [1, 5, 24, 1024])
def test_seg_start_index_matches_reference(n):
    first = _layout(np.random.default_rng(n), n)
    want = np.asarray(_start(jnp.asarray(first)))
    got = segscan.seg_start_index(torch.from_numpy(first), dim=0)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
