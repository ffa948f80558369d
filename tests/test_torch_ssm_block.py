"""The port's Mamba2 block (``repro_torch.models.ssm.ssm_block``) against
the JAX package's, on the CPU, at zamba2-smoke's width (d_model 128,
d_inner 256, 4 heads of 64, state 16, conv width 4).

The block's parameters are the JAX ``init_ssm``'s, carried across by
name, with ``A_log`` spread over [-2, 3] (A = -e^{A_log} from -0.14 to
-20), and ``dt_bias`` and ``D`` drawn: the JAX init's A = -1 for every
head would leave the scan's decays mild.  The strongest heads decay by
more than e^88 within a chunk of 64, so exp(A_t - A_s) is +inf above the
diagonal: the causal mask must be applied before the product, as in the
reference, or the output is NaN.  T = 100 is ragged against the chunk
(padded on the right to 128), T = 128 is not, T = 1 is the decode step.

Tolerances, each with its reason:
- f32: y, the final state and the conv shift within 1e-5 of the
  reference's largest |value| (the same algorithm, summed in other
  orders: measured 1.0e-6 of it for y, 1.9e-6 for the state).  The
  reference's own jit and op-by-op runs differ by 6e-8 of it.
- bf16: y within ``BF16_REL`` = 2**-6 of its largest |value|.  Here the
  reference's jit and op-by-op runs agree bit for bit, but the two
  frameworks round bf16 in other places: ``jax.nn.silu`` on bf16 differs
  from ``F.silu`` by an ulp in 37% of elements (measured on 200,000
  normal values), and the in-projection's f32 sums round to bf16 apart
  where they sit next to a rounding boundary.  Measured: 0.125 of 30.6
  (one bf16 ulp there; 2**-7.9 of the largest) for a prefill, 0.0156 of
  2.05 (2**-7.0) for a decode step.  The state (f32 sums of bf16
  products) within 1e-5 of its largest (measured 1.4e-6); the conv shift
  (bf16 projections) within one bf16 ulp of each value (2**-7 relative)
  plus 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs, convert
from repro_torch.models import ssm

torch.set_num_threads(1)

ARCH = "zamba2_7b"
B = 2
F32_REL = 1e-5
BF16_REL = 2.0 ** -6
CASES = [(100, False), (100, True), (128, True), (1, True)]
IDS = ["prefill-ragged", "prefill-ragged-cached", "prefill-cached",
       "decode"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _block(dtype):
    """The JAX block's parameters (decays spread, D and dt_bias drawn) and
    the port's block holding the same values."""
    cfg = jconfigs.get_smoke_config(ARCH)
    jdt, tdt = DTYPES[dtype]
    jp = jssm.init_ssm(jax.random.PRNGKey(1), cfg, jdt)
    H = jp["A_log"].shape[0]
    rng = np.random.default_rng(7)
    jp["A_log"] = jnp.asarray(np.linspace(-2, 3, H).astype(np.float32))
    jp["dt_bias"] = jnp.asarray(rng.standard_normal(H).astype(np.float32))
    jp["D"] = jnp.asarray(rng.standard_normal(H).astype(np.float32))
    tp = ssm.SSMBlock(configs.get_smoke_config(ARCH), tdt, "cpu")
    tp.load_state_dict({n: convert.tensor_from_numpy(a, "cpu")
                        for n, a in jax.tree.map(np.asarray, jp).items()},
                       strict=True)
    return cfg, jp, tp


def _inputs(cfg, T, cached, dtype):
    jdt, tdt = DTYPES[dtype]
    d_inner, H, P, N = ssm._ssm_dims(cfg)
    rng = np.random.default_rng(T + 10 * cached)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    if not cached:
        return (jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt),
                None, None)
    conv = rng.standard_normal((B, cfg.conv_width - 1, d_inner))
    state = rng.standard_normal((B, H, N, P)) * 0.3
    jc = {"conv": jnp.asarray(conv, jnp.float32).astype(jdt),
          "state": jnp.asarray(state, jnp.float32)}
    tc = {"conv": torch.from_numpy(conv.astype(np.float32)).to(tdt),
          "state": torch.from_numpy(state.astype(np.float32))}
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt), jc, tc


def _run(cfg, jp, tp, T, cached, dtype):
    xj, xt, jc, tc = _inputs(cfg, T, cached, dtype)
    want, wc = jax.jit(lambda p, x, c: jssm.ssm_block(p, x, cfg, cache=c))(
        jp, xj, jc)
    with torch.no_grad():
        got, gc = ssm.ssm_block(tp, xt, cfg, cache=tc)
    assert gc is tc                     # the cache is written in place
    assert got.dtype == DTYPES[dtype][1] and got.shape == xt.shape
    return _np(got), _np(want), gc, wc


def _within(got, want, rel):
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert np.isfinite(got).all()
    assert err <= rel * top, (err, top)


def _max_chunk_decay(cfg, jp, T):
    """The largest decay exp(A_t - A_s) exponent inside a chunk of 64 that
    the inputs give, from the block's dt in numpy."""
    x = _inputs(cfg, T, False, "f32")[1].numpy()
    H = jp["A_log"].shape[0]
    dt = x @ np.asarray(jp["in_proj"], np.float32)[:, -H:]
    dt = np.logaddexp(dt + np.asarray(jp["dt_bias"]), 0.0)
    log_a = -np.exp(np.asarray(jp["A_log"])) * dt          # (B,T,H)
    return (-log_a[:, :64].sum(axis=1)).max()


@pytest.mark.parametrize("T,cached", CASES, ids=IDS)
def test_ssm_block_f32_matches(T, cached):
    cfg, jp, tp = _block("f32")
    if T > 1:
        assert _max_chunk_decay(cfg, jp, T) > 88.8     # e^x overflows f32
    got, want, gc, wc = _run(cfg, jp, tp, T, cached, "f32")
    _within(got, want, F32_REL)
    if cached:
        for n in ("conv", "state"):
            _within(_np(gc[n]), _np(wc[n]), F32_REL)


@pytest.mark.parametrize("T,cached", CASES, ids=IDS)
def test_ssm_block_bf16_matches(T, cached):
    cfg, jp, tp = _block("bf16")
    got, want, gc, wc = _run(cfg, jp, tp, T, cached, "bf16")
    _within(got, want, BF16_REL)
    if cached:
        assert gc["conv"].dtype == torch.bfloat16
        assert gc["state"].dtype == torch.float32
        _within(_np(gc["state"]), _np(wc["state"]), F32_REL)
        np.testing.assert_allclose(_np(gc["conv"]), _np(wc["conv"]),
                                   rtol=2.0 ** -7, atol=1e-6)


def test_decode_steps_continue_a_prefill():
    """A ragged prefill from a cache, then six decode steps, each fed the
    next input: the per-step outputs and the cache after the last step,
    in f32."""
    cfg, jp, tp = _block("f32")
    xj, xt, jc, tc = _inputs(cfg, 40, True, "f32")
    step = jax.jit(lambda p, x, c: jssm.ssm_block(p, x, cfg, cache=c))
    want, jc = step(jp, xj[:, :34], jc)
    with torch.no_grad():
        got, _ = ssm.ssm_block(tp, xt[:, :34], cfg, cache=tc)
        _within(_np(got), _np(want), F32_REL)
        for t in range(34, 40):
            want, jc = step(jp, xj[:, t:t + 1], jc)
            got, _ = ssm.ssm_block(tp, xt[:, t:t + 1], cfg, cache=tc)
            _within(_np(got), _np(want), F32_REL)
    for n in ("conv", "state"):
        _within(_np(tc[n]), _np(jc[n]), F32_REL)


def test_prefill_state_equals_token_by_token_decode():
    """The port alone, in f32: the state and conv shift a ragged prefill
    leaves equal those of the same tokens fed one decode step at a time
    from an empty cache (the padding leaves the final state exact), and
    the outputs agree."""
    cfg = configs.get_smoke_config(ARCH)
    tp = _block("f32")[2]
    x = _inputs(cfg, 21, False, "f32")[1]
    empty = lambda: {n: t[0] for n, t in ssm.empty_ssm_cache(
        cfg, B, n_layers=1, dtype=torch.float32, device="cpu").items()}
    pre, seq = empty(), empty()
    with torch.no_grad():
        y, _ = ssm.ssm_block(tp, x, cfg, cache=pre)
        ys = [ssm.ssm_block(tp, x[:, t:t + 1], cfg, cache=seq)[0]
              for t in range(x.shape[1])]
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(y), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(seq["state"]), _np(pre["state"]),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(seq["conv"], pre["conv"])


def test_init_ssm_scales_and_cache_layout():
    cfg = configs.get_smoke_config(ARCH)
    p = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jssm.init_ssm(jax.random.PRNGKey(0), jconfigs.get_smoke_config(ARCH))
    for n, a in jp.items():
        t = getattr(p, n)
        assert tuple(t.shape) == a.shape, n
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name, n
    d_inner = ssm._ssm_dims(cfg)[0]
    assert abs(p.in_proj.float().std().item() * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(p.out_proj.float().std().item() * d_inner ** 0.5 - 1) < 0.05
    assert abs(p.conv_w.float().std().item() - 0.5) < 0.05
    assert bool((p.A_log == 0).all()) and bool((p.dt_bias == 0).all())
    assert bool((p.D == 1).all())
    jc = jssm.empty_ssm_cache(jconfigs.get_smoke_config(ARCH), 3)
    tc = ssm.empty_ssm_cache(cfg, 3, device="cpu")
    assert set(tc) == set(jc) == {"conv", "state"}
    for n, a in jc.items():
        assert tuple(tc[n].shape) == a.shape, n
        assert str(tc[n].dtype).removeprefix("torch.") == a.dtype.name, n
        assert not tc[n].any()
