"""The sm90 flash-attention kernel's arithmetic and arguments, on the CPU.

``csrc/flash_attention_sm90.cu`` runs only on the card, so its arithmetic
is rehearsed here by a rounding model kept in this file: f32 scores from
bf16 q and k, the online softmax over key tiles of the kernel's width (64
keys) with the running max m in units of log2 (``sm_scale * log2(e)``
folded into one fused multiply-add a score, then ``exp2``), P split into
bf16 hi + lo (hi rounds P to nearest even, lo rounds the rest) for two
products P_hi.V + P_lo.V, l summed from the f32 probabilities, and o
rounded once to bf16.  The model is held
against the JAX package's ``flash_attention_bhsd`` in interpret mode (as
``tests/test_kernels.py`` runs it) under the bound that ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` hold the kernel to on the card:
``|d| <= 2e-3 + 1.6e-2 |ref|``.

Also here: the pure-Python tensor-map arguments of both layouts and their
16-byte checks, and the model-layout entry point on the CPU."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention, ops

torch.set_num_threads(1)

ATOL, RTOL = 2e-3, 1.6e-2         # chip_smoke.FLASH_ATOL, FLASH_RTOL
BLOCK_N = 64                      # keys per tile of the kernel
LOG2E = np.float32(1.4426950408889634)
NEG_INF = -1e30


def _inputs(seed, shape_q, shape_kv):
    """Identical bf16 inputs for both sides (numpy, rounded once)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in (shape_q, shape_kv, shape_kv):
        a = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(a).astype(jnp.bfloat16),
                    torch.from_numpy(a).to(torch.bfloat16)))
    return out


def _p_split(p):
    """The kernel's P operands: bf16 hi + bf16 lo, as f32."""
    hi = p.to(torch.bfloat16).float()
    return hi + (p - hi).to(torch.bfloat16).float()


P_MODES = {"split": _p_split,                                # the kernel
           "bf16": lambda p: p.to(torch.bfloat16).float(),   # one bf16 P
           "f32": lambda p: p}


def sm90_model(q, k, v, causal=True, sm_scale=None, p_mode="split",
               out_dtype=torch.bfloat16):
    """The sm90 kernel's arithmetic in (B, H, S, Dh), bf16 in; P as
    ``P_MODES[p_mode]`` (the kernel: "split") and o rounded to
    ``out_dtype`` (the kernel: bf16)."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(Dh) if sm_scale is None else sm_scale
    c = torch.tensor(np.float32(scale) * LOG2E)     # one f32 product
    rep = Hq // Hkv
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = q.float() @ kf.transpose(-1, -2)                # (B, Hq, Sq, Sk)
    if causal:
        cols = torch.arange(Sk)
        s = s.masked_fill(cols[None, :] > torch.arange(Sq)[:, None], NEG_INF)
    m = torch.full((B, Hq, Sq, 1), NEG_INF)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, Dh))
    for k0 in range(0, Sk, BLOCK_N):
        st = s[..., k0:k0 + BLOCK_N]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True) * c)
        alpha = torch.exp2(m - m_new)
        # s * c - m rounded once, as the kernel's fused multiply-add
        p = torch.exp2((st.double() * c.double() - m_new.double()).float())
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + P_MODES[p_mode](p) @ vf[..., k0:k0 + BLOCK_N, :]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(out_dtype)


def _assert_within_bound(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    ratio = np.abs(got - want) / (ATOL + RTOL * np.abs(want))
    assert ratio.max() <= 1.0, ratio.max()


def _bshd_model(tq, tk, tv):
    t = lambda a: a.transpose(1, 2)
    return t(sm90_model(t(tq), t(tk), t(tv)))


@pytest.mark.parametrize("B,S,Hq,Hkv,Dh", [
    (2, 64, 4, 2, 32),       # GQA (test_torch_flash.py's bf16 shapes)
    (2, 100, 4, 2, 32),      # ragged S
    (1, 48, 4, 4, 64),       # MHA, gemma-smoke's head dim
])
def test_rounding_model_matches_pallas_kernel(B, S, Hq, Hkv, Dh):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(S + Dh, (B, S, Hq, Dh),
                                           (B, S, Hkv, Dh))
    want = jops.flash_attention(jq, jk, jv, causal=True)
    _assert_within_bound(_bshd_model(tq, tk, tv).float().numpy(), want)


@pytest.mark.parametrize("causal,B,Hq,Hkv,S,Dh,block", [
    (False, 2, 4, 2, 64, 64, 32),    # test_torch_flash.py's bhsd case
    (True, 1, 4, 2, 512, 128, 128),  # causal GQA over four key tiles
    (True, 1, 2, 1, 256, 256, 128),  # gemma-7b's head dim
])
def test_rounding_model_matches_pallas_kernel_bhsd(causal, B, Hq, Hkv, S, Dh,
                                                   block):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(S * Dh, (B, Hq, S, Dh),
                                           (B, Hkv, S, Dh))
    want = jflash.flash_attention_bhsd(jq, jk, jv, causal=causal,
                                       block_q=block, block_k=block,
                                       interpret=True)
    got = sm90_model(tq, tk, tv, causal=causal)
    _assert_within_bound(got.float().numpy(), want)


def test_split_p_holds_the_bound_where_one_bf16_p_does_not():
    """Why the kernel splits P, at granite's heads (B 4, Hq 32, Hkv 8,
    Dh 128) over one key tile.  With o kept in f32, one bf16 P moves o by
    up to 2^-9 of each weighted value: where a query row sees few keys and
    their values cancel, that is ~4e-3 against an output near 0, over the
    2e-3 + 1.6e-2 |o| bound (measured here: 1.09 of it).  P_hi + P_lo
    carries ~16 bits: o moves by < 1e-5, under 1% of the bound."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(7, (4, 32, 128, 128),
                                           (4, 8, 128, 128))
    f32 = torch.float32
    exact = sm90_model(tq, tk, tv, p_mode="f32", out_dtype=f32)
    bound = ATOL + RTOL * exact.abs()
    off = lambda mode: ((sm90_model(tq, tk, tv, p_mode=mode, out_dtype=f32)
                         - exact).abs() / bound).max().item()
    assert off("split") < 0.01 and off("bf16") > 1.0
    # and against the Pallas kernel, each rounded once to bf16
    want = torch.from_numpy(np.asarray(jflash.flash_attention_bhsd(
        jq, jk, jv, causal=True, interpret=True), np.float32))
    err = lambda mode: ((sm90_model(tq, tk, tv, p_mode=mode).float() - want)
                        .abs() / (ATOL + RTOL * want.abs())).max().item()
    assert err("split") <= 1.0 < err("bf16")


# ------------------------------------------------------- tensor-map arguments
def test_tensor_map_args_of_both_layouts():
    B, H, S, Dh = 2, 3, 1000, 128      # a ragged S
    bhsd = torch.zeros(B, H, S, Dh, dtype=torch.bfloat16)
    bshd = torch.zeros(B, S, H, Dh, dtype=torch.bfloat16)
    assert flash_attention.tensor_map_args(bhsd, "bhsd") == (
        (Dh, S, H, B), (2 * Dh, 2 * S * Dh, 2 * H * S * Dh))
    assert flash_attention.tensor_map_args(bshd, "bshd") == (
        (Dh, S, H, B), (2 * H * Dh, 2 * Dh, 2 * S * H * Dh))
    # a view of the first 600 rows keeps the parent's strides
    assert flash_attention.tensor_map_args(bshd[:, :600], "bshd") == (
        (Dh, 600, H, B), (2 * H * Dh, 2 * Dh, 2 * S * H * Dh))
    # the model's q, k, v as views of one fused projection
    qkv = torch.zeros(B, S, 3 * H * Dh, dtype=torch.bfloat16)
    k = qkv[..., H * Dh:2 * H * Dh].unflatten(-1, (H, Dh))
    assert flash_attention.tensor_map_args(k, "bshd") == (
        (Dh, S, H, B), (6 * H * Dh, 2 * Dh, 6 * S * H * Dh))


def test_tensor_map_args_refuse_what_tma_cannot_read():
    B, S, H, Dh = 1, 64, 2, 64
    flat = torch.zeros(B * S * H * Dh + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + B * S * H * Dh].view(B, S, H, Dh)   # 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention.tensor_map_args(shifted, "bshd")
    wide = torch.zeros(B, S, H * Dh + 4, dtype=torch.bfloat16)
    narrow = wide[..., :H * Dh].unflatten(-1, (H, Dh))   # S stride 264 bytes
    with pytest.raises(ValueError, match="S stride of 264 bytes"):
        flash_attention.tensor_map_args(narrow, "bshd")
    with pytest.raises(ValueError, match="head dim is not contiguous"):
        flash_attention.tensor_map_args(
            torch.zeros(B, H, Dh, S, dtype=torch.bfloat16).transpose(2, 3),
            "bhsd")


# ------------------------------------------------------------ the model layout
def test_bshd_entry_matches_pallas_kernel_on_the_cpu():
    """``ops.flash_attention`` on the model's (B, S, H, Dh) tensors, and
    ``flash_attention_bshd`` itself, against the JAX package's wrapper;
    the CPU launches no kernel."""
    B, S, Hq, Hkv, Dh = 1, 512, 4, 2, 128
    (jq, tq), (jk, tk), (jv, tv) = _inputs(5, (B, S, Hq, Dh), (B, S, Hkv, Dh))
    want = jops.flash_attention(jq, jk, jv, causal=True)
    n0, n90 = flash_attention.launches, flash_attention.launches_sm90
    for got in (ops.flash_attention(tq, tk, tv, causal=True),
                flash_attention.flash_attention_bshd(tq, tk, tv)):
        assert got.shape == (B, S, Hq, Dh) and got.dtype == torch.bfloat16
        _assert_within_bound(got.float().numpy(), want)
    assert (flash_attention.launches, flash_attention.launches_sm90) == (
        n0, n90)


def test_bshd_entry_refuses_what_the_plain_version_cannot_do():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="sm_scale"):
        flash_attention.flash_attention_bshd(q, q, q, sm_scale=0.5)
    m = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention.flash_attention_bshd(m, m, m)
