"""The port's Pig relay aggregation against the JAX package, on the CPU.

``repro_torch.kernels.ops.pig_aggregate`` on a CPU tensor runs the plain
version (``ref.pig_aggregate_ref``: an ascending loop over g from 0.0); it
is held against ``repro.kernels.ops.pig_aggregate``, the Pallas kernel in
interpret mode as ``tests/test_kernels.py`` runs it, to that test's own
rtol/atol of 1e-6: XLA:CPU fuses the kernel's product into its sum and
contracts the last step into an FMA (at G = 2 it computes
fma(q1, s1, q0 * s0), one f32 ulp off in about a quarter of the
elements), and for G > 2 it may sum in another order.  At G <= 2 the port
equals the reference's plain version (``repro.kernels.ref
.pig_aggregate_ref``: 0 + p0 + p1, each product rounded once) bit for
bit.  ``quantize_blockwise`` is compared bit for bit.  The CUDA kernel
runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.pig_aggregate import quantize_blockwise as jquantize
from repro_torch.kernels import ops, pig_aggregate
from repro_torch.kernels.ref import pig_aggregate_ref

torch.set_num_threads(1)

SHAPES = [(2, 2048, 1024), (5, 8192, 512), (16, 4096, 256)]


def _rows(seed, G, N):
    """G rows of N normal f32 values from a numpy seed; the last block of
    row 0 is all zeros (amax 0: the 1e-12 / 127 scale)."""
    x = np.random.default_rng(seed).standard_normal((G, N)).astype(np.float32)
    x[0, -256:] = 0.0
    return x


def _quantized(x, block):
    """Both packages' quantization of each row: (jax shards, jax scales),
    (torch shards, torch scales)."""
    jq, js = zip(*(jquantize(jnp.asarray(r), block) for r in x))
    tq, ts = zip(*(pig_aggregate.quantize_blockwise(torch.from_numpy(r),
                                                    block) for r in x))
    return (jnp.stack(jq), jnp.stack(js)), (torch.stack(tq), torch.stack(ts))


@pytest.mark.parametrize("N,block", [(2048, 1024), (8192, 512), (4096, 256),
                                     (1024, 16)])
def test_quantize_blockwise_matches_jax_bit_for_bit(N, block):
    x = _rows(N + block, 1, N)[0]
    # ties: values that land exactly on a half step round to even on both
    x[:8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0],
                     np.float32) * (np.abs(x[:block]).max() / 127.0)
    jq, js = jquantize(jnp.asarray(x), block)
    tq, ts = pig_aggregate.quantize_blockwise(torch.from_numpy(x), block)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("G,N,block", SHAPES)
def test_pig_aggregate_matches_pallas_kernel(G, N, block):
    x = _rows(G * N, G, N)
    (jq, js), (tq, ts) = _quantized(x, block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    before = pig_aggregate.launches
    got = ops.pig_aggregate(tq, ts, block=block)
    assert pig_aggregate.launches == before     # the CPU runs no kernel
    assert got.dtype == torch.float32 and got.shape == (N,)
    want = np.asarray(jops.pig_aggregate(jq, js, block=block))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    plain = np.asarray(jref.pig_aggregate_ref(jq, js, block=block))
    if G <= 2:
        np.testing.assert_array_equal(got.numpy(), plain)
    np.testing.assert_allclose(got.numpy(), plain, rtol=1e-6, atol=1e-6)
    # the dequantized sum approximates the true sum to int8 precision
    err = np.abs(got.numpy() - x.sum(0)).max()
    assert err <= G * np.abs(x).max() / 127.0 * 0.6


def test_plain_version_sums_in_ascending_order_from_zero():
    """The fixed order the card's kernel is held to: 0 + p0 + p1 + ...,
    each product rounded on its own; -0 products give +0."""
    shards = torch.tensor([[-1, 0, 127, 3], [0, 0, -127, 5],
                           [1, 0, 1, -7]], dtype=torch.int8)
    scales = torch.tensor([[0.1], [0.3], [1e-8]], dtype=torch.float32)
    got = pig_aggregate_ref(shards, scales, block=4)
    want = torch.zeros(4)
    for g in range(3):
        want = want + shards[g].float() * scales[g, 0]
    assert torch.equal(got, want)
    zero = pig_aggregate_ref(torch.zeros(2, 4, dtype=torch.int8),
                             -torch.ones(2, 1), block=4)
    assert not torch.signbit(zero).any()


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 8), st.integers(1, 6))
def test_pig_aggregate_property(G, nb):
    """Quantize -> aggregate error is bounded by the per-block quant step
    (the bound of ``tests/test_kernels.py::test_pig_aggregate_property``),
    and the port agrees with the Pallas kernel."""
    block = 256
    N = nb * block
    x = np.random.default_rng(G * 31 + nb).standard_normal(
        (G, N)).astype(np.float32)
    (jq, js), (tq, ts) = _quantized(x, block)
    got = ops.pig_aggregate(tq, ts, block=block).numpy()
    step = ts.max().item()
    assert np.abs(got - x.sum(0)).max() <= G * step * 0.51 + 1e-6
    np.testing.assert_allclose(
        got, np.asarray(jops.pig_aggregate(jq, js, block=block)),
        rtol=1e-6, atol=1e-6)


def test_wrapper_refusals():
    shards = torch.zeros(2, 2048, dtype=torch.int8)
    scales = torch.ones(2, 2)
    f = pig_aggregate.pig_aggregate
    assert f(shards, scales, 1024).shape == (2048,)
    with pytest.raises(TypeError, match="shards must be torch.int8"):
        f(shards.float(), scales, 1024)
    with pytest.raises(TypeError, match="scales must be torch.float32"):
        f(shards, scales.double(), 1024)
    with pytest.raises(ValueError, match="not a multiple of block"):
        f(torch.zeros(2, 2000, dtype=torch.int8), scales, 1024)
    with pytest.raises(ValueError, match="scales has shape"):
        f(shards, torch.ones(2, 4), 1024)
    with pytest.raises(ValueError, match="expected \\(G, N\\)"):
        f(shards[0], scales, 1024)
    with pytest.raises(ValueError, match="not contiguous"):
        f(torch.zeros(2048, 2, dtype=torch.int8).t(), scales, 1024)
    with pytest.raises(ValueError, match="unsupported device"):
        f(shards.to("meta"), scales.to("meta"), 1024)
    with pytest.raises(ValueError, match="scales on meta"):
        f(shards, scales.to("meta"), 1024)
