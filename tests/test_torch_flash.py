"""The port's flash attention against the JAX package, on the CPU.

``repro_torch.kernels.ops.flash_attention`` on a CPU tensor runs the plain
version (``ref.flash_attention_ref``, the model's ``attention_ref``); it is
held against ``repro.kernels.ops.flash_attention``, the Pallas kernel in
interpret mode as ``tests/test_kernels.py`` runs it.  Tolerances: f32
rel 1e-5, atol 1e-6 (the two sum in other orders: measured below 1e-6);
bf16 within one bf16 ulp of the output (both compute in f32 and round once
at the end) plus the same atol.  The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention, ops, ref

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shape_q, shape_kv, dtype):
    """Identical inputs for both sides, rounded to ``dtype`` once."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    out = []
    for shape in (shape_q, shape_kv, shape_kv):
        a = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16_ulp(x):
    """One bf16 ulp at each value (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _assert_close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        # one ulp of the larger of the two (a value next to a power of two
        # rounds to either side of it), plus the f32 comparison's atol:
        # where the output cancels to near zero the two f32 sums differ by
        # ~1e-7 before rounding (measured: 3.4e-8)
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= ulp + 1e-6), \
            np.abs(got - want).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,Dh", [
    (2, 64, 4, 2, 32),       # GQA
    (2, 100, 4, 2, 32),      # ragged S
    (1, 48, 4, 4, 64),       # MHA, gemma-smoke's head dim
])
def test_ops_flash_attention_matches_pallas_kernel(B, S, Hq, Hkv, Dh, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(S + Dh, (B, S, Hq, Dh),
                                           (B, S, Hkv, Dh), dtype)
    before = flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert flash_attention.launches == before     # the CPU never launches
    assert got.dtype == tq.dtype and got.shape == (B, S, Hq, Dh)
    _assert_close(got, jops.flash_attention(jq, jk, jv, causal=True), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bhsd_non_causal_matches_pallas_kernel(dtype):
    B, Hq, Hkv, S, Dh = 2, 4, 2, 64, 64
    (jq, tq), (jk, tk), (jv, tv) = _inputs(7, (B, Hq, S, Dh),
                                           (B, Hkv, S, Dh), dtype)
    got = flash_attention.flash_attention_bhsd(tq, tk, tv, causal=False)
    want = jflash.flash_attention_bhsd(jq, jk, jv, causal=False, block_q=32,
                                       block_k=32, interpret=True)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_reference_oracle(dtype, causal):
    B, Hq, Hkv, Sq, Sk, Dh = 2, 4, 2, 40, 56, 32
    (jq, tq), (jk, tk), (jv, tv) = _inputs(11, (B, Hq, Sq, Dh),
                                           (B, Hkv, Sk, Dh), dtype)
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    _assert_close(got, want, dtype)


def test_wrapper_refuses_what_the_plain_version_cannot_do():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="sm_scale"):
        flash_attention.flash_attention_bhsd(q, q, q, sm_scale=0.5)
    m = torch.empty(1, 2, 8, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention.flash_attention_bhsd(m, m, m)


def _attend_plain(q, k, v, causal=True, sm_scale=None):
    """Attention in f32 with an explicit scale on (B, S, H, Dh), rounded
    once to q's dtype: the plain stand-in for the kernel behind
    ``flash_attention_padded`` (which calls it with the padded Dh)."""
    rep = q.shape[2] // k.shape[2]
    t = lambda a: a.float().transpose(1, 2)
    qf = t(q)
    kf, vf = (t(a).repeat_interleave(rep, dim=1) for a in (k, v))
    s = (qf @ kf.transpose(-1, -2)) * sm_scale
    if causal:
        S = q.shape[1]
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
    return (torch.softmax(s, dim=-1) @ vf).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Dh,Hq,Hkv", [
    (80, 4, 2),       # h2o-danube's head dim, GQA
    (112, 4, 4),      # zamba2-7b's shared attention
])
def test_padded_head_dims_match_pallas_kernel(Dh, Hq, Hkv, dtype):
    """What ``ops.flash_attention`` does on a CUDA tensor whose head dim no
    kernel takes, rehearsed with a plain attention in the kernel's place:
    q, k, v padded with zeros to 128 and scaled by 1/sqrt of the unpadded
    Dh, the output sliced back; against the JAX package's wrapper, which
    pads to 128 the same way, in interpret mode.  On the CPU the entry
    point itself runs the plain version at the unpadded Dh."""
    B, S = 2, 96
    (jq, tq), (jk, tk), (jv, tv) = _inputs(Dh, (B, S, Hq, Dh),
                                           (B, S, Hkv, Dh), dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True)
    seen = []

    def attend(q, k, v, causal=True, sm_scale=None):
        seen.append((tuple(q.shape), sm_scale))
        assert not q[..., Dh:].any() and not v[..., Dh:].any()
        return _attend_plain(q, k, v, causal, sm_scale)

    got = flash_attention.flash_attention_padded(tq, tk, tv, attend=attend)
    assert seen == [((B, S, Hq, 128), 1.0 / np.sqrt(Dh))]
    assert got.shape == (B, S, Hq, Dh) and got.dtype == tq.dtype
    _assert_close(got, want, dtype)
    before = flash_attention.launches
    _assert_close(ops.flash_attention(tq, tk, tv, causal=True), want, dtype)
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype,Dh,size", [
    (torch.bfloat16, 80, 128), (torch.bfloat16, 112, 128),
    (torch.bfloat16, 16, 64),        # the sm90 kernel's least
    (torch.bfloat16, 32, 32),        # the CUDA-core kernel takes it
    (torch.bfloat16, 200, 256),
    (torch.float32, 16, 32), (torch.float32, 80, 128),
    (torch.float32, 128, 128),       # taken: passed through unchanged
])
def test_padded_head_dim(dtype, Dh, size):
    assert flash_attention.padded_head_dim(dtype, Dh) == size


def test_head_dims_above_256_raise():
    with pytest.raises(ValueError, match="limit of 256"):
        flash_attention.padded_head_dim(torch.bfloat16, 320)
    q = torch.zeros(1, 8, 2, 64)
    calls = []
    out = flash_attention.flash_attention_padded(
        q, q, q, attend=lambda *a, **kw: calls.append(kw) or a[0])
    assert out is q and calls == [{"causal": True}]   # no copy, no scale
