"""The port's RWKV6 family against the JAX package, on the CPU, at
rwkv6-smoke (2 layers, d_model 128, 2 heads of 64), from parameters
carried across by ``params_from_jax``.

LoRA-B of the decay is drawn non-zero (the JAX init's zero makes every
decay the constant -e^0.5), so the decay depends on the data and reaches
both ends of the clamp [-2.3, -1e-4].  Both routes of the prefill scan are
held: ``impl="ref"`` (``chunked_linear_scan``) and ``impl="auto"``
(``kernels.ops.ssm_scan``, the plain version on the CPU).

Tolerances, each with its reason:
- f32 layer functions and model: rel/abs 1e-5 (the same algorithm, summed
  in other orders; measured below 2e-6), logits 1e-4 of the largest.
- bf16 (the serving default): logits abs ``LOGIT_TOL`` and greedy tokens
  under the margin rule of ``tests/test_torch_models.py``.  The dense
  models' 0.08 is below the reference's own spread here: with the decay
  data-dependent, a bf16 ulp of a projection moves exp(-exp(z)), and the
  JAX package's jit and op-by-op (``jax.disable_jit``) runs of this test's
  prefill and 6 decode steps differ by up to 0.0918 (measured; logits up
  to 3.6).  The port sits within 0.1045 of the jit run and 0.0859 of the
  op-by-op run, so ``LOGIT_TOL`` = 0.15 (ROADMAP queue 3).  The cache
  (token shifts: the layers' bf16 inputs; f32 states: sums of products of
  bf16 k and v) carries every earlier layer's rounding: each layer's entry
  is held to max |d| <= ``CACHE_TOL`` = 0.05 of the reference's largest.
  Measured after the prefill and after the decode steps: layer 0's state
  equals the op-by-op reference (max |d| 0.0000) and differs from the jit
  run by 0.022 of 6.8, as the two reference runs do; the worst ratios are
  0.027 for a state (0.287 of 10.7; the reference's own jit/op-by-op
  ratio there 0.014) and 0.019 for a shift (0.0605 of 3.23; own 0.015).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import rwkv as jrwkv
from repro_torch import configs, convert
from repro_torch.kernels import ssm_scan
from repro_torch.models import model, rwkv

torch.set_num_threads(1)

ARCH = "rwkv6_3b"
B, S, STEPS = 2, 37, 6          # S ragged against the scan's chunk of 16
LOGIT_TOL = 0.15
CACHE_TOL = 0.05
LORA_B_STD = 1.0


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _lora_b(shape, seed=11):
    return (np.random.default_rng(seed).standard_normal(shape)
            * LORA_B_STD).astype(np.float32)


def _jax_block(cfg):
    """One f32 block of JAX parameters with a non-zero LoRA-B, and the
    port's block holding the same values."""
    jp = jrwkv.init_rwkv_block(jax.random.PRNGKey(1), cfg, jnp.float32)
    jp["time"]["w_lora_b"] = jnp.asarray(
        _lora_b(jp["time"]["w_lora_b"].shape))
    tp = rwkv.RWKVBlock(cfg, torch.float32, "cpu")
    tp.load_state_dict({n: torch.from_numpy(np.array(a))
                        for n, a in _flat(jp).items()}, strict=True)
    return jp, tp


def _logw(jp, x):
    """The clamp's input, -exp(w0 + tanh(mix(mu_w) @ A) @ B), in numpy."""
    t = jax.tree.map(np.asarray, jp["time"])
    xx = np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
    xw = x + (xx - x) * t["mu_w"]
    return -np.exp(t["w0"] + np.tanh(xw @ t["w_lora_a"]) @ t["w_lora_b"])


def _cache_pair(cfg, rng):
    """A non-empty layer cache (token shifts and state), for both."""
    H, N = rwkv._dims(cfg)
    c = {"shift_t": rng.standard_normal((B, 1, cfg.d_model)),
         "shift_c": rng.standard_normal((B, 1, cfg.d_model)),
         "state": rng.standard_normal((B, H, N, N)) * 0.3}
    c = {n: a.astype(np.float32) for n, a in c.items()}
    return ({n: jnp.asarray(a) for n, a in c.items()},
            {n: torch.from_numpy(a.copy()) for n, a in c.items()})


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("T,cached", [(S, False), (S, True), (1, True)],
                         ids=["prefill", "prefill-cached", "decode"])
@pytest.mark.parametrize("impl", ["ref", "auto"])
def test_time_mix_f32_matches(T, cached, impl):
    cfg = configs.get_smoke_config(ARCH)
    jp, tp = _jax_block(cfg)
    rng = np.random.default_rng(T)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    if T > 1:
        lw = _logw(jp, x)
        assert (lw < -2.3).mean() > 0.01 and (lw > -1e-4).mean() > 0.01
    jc, tc = _cache_pair(cfg, rng) if cached else (None, None)
    want, wc = jrwkv.time_mix(jp["time"], jnp.asarray(x), cfg, cache=jc)
    n0 = ssm_scan.launches
    got, gc = rwkv.time_mix(tp.time, torch.from_numpy(x), cfg, cache=tc,
                            impl=impl)
    assert ssm_scan.launches == n0             # the CPU never launches
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    if cached:
        assert gc is tc
        for n in ("shift_t", "state"):
            np.testing.assert_allclose(_np(gc[n]), _np(wc[n]), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("cached", [False, True])
def test_channel_mix_f32_matches(cached):
    cfg = configs.get_smoke_config(ARCH)
    jp, tp = _jax_block(cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jc, tc = _cache_pair(cfg, rng) if cached else (None, None)
    want, wc = jrwkv.channel_mix(jp["chan"], jnp.asarray(x), cfg, cache=jc)
    got, gc = rwkv.channel_mix(tp.chan, torch.from_numpy(x), cfg, cache=tc)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    if cached:
        np.testing.assert_allclose(_np(gc["shift_c"]), _np(wc["shift_c"]))


@pytest.mark.parametrize("impl", ["ref", "auto"])
def test_rwkv_block_f32_matches(impl):
    cfg = configs.get_smoke_config(ARCH)
    jp, tp = _jax_block(cfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jc, tc = _cache_pair(cfg, rng)
    want, wc = jrwkv.rwkv_block(jp, jnp.asarray(x), cfg, cache=jc)
    got, _ = rwkv.rwkv_block(tp, torch.from_numpy(x), cfg, cache=tc,
                             impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    for n in ("shift_t", "shift_c", "state"):
        np.testing.assert_allclose(_np(tc[n]), _np(wc[n]), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------------------ model
def _jax_params(dtype=jnp.bfloat16):
    cfg = jconfigs.get_smoke_config(ARCH)
    jp = jmodels.init_params(cfg, jax.random.PRNGKey(0), dtype)
    lb = jp["layers"]["time"]["w_lora_b"]
    jp["layers"]["time"]["w_lora_b"] = jnp.asarray(
        _lora_b(lb.shape)).astype(lb.dtype)
    return cfg, jp


def test_params_from_jax_maps_every_rwkv_leaf():
    cfg, jp = _jax_params()
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert isinstance(tp, model.RWKVModel)
    ours = dict(tp.named_parameters())
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        rows = range(cfg.n_layers) if keys[0] == "layers" else [None]
        for i in rows:
            name = ".".join(keys if i is None
                            else ["layers", str(i)] + keys[1:])
            a = np.asarray(leaf if i is None else leaf[i])
            t = ours[name]
            assert tuple(t.shape) == a.shape, name
            assert str(t.dtype).removeprefix("torch.") == a.dtype.name, name
            if a.dtype.name == "bfloat16":
                assert np.array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16)), name
            else:
                assert np.array_equal(t.detach().numpy(), a), name
            n += 1
    assert n == len(ours)
    assert sum(t.numel() for t in ours.values()) == cfg.param_count()


def test_init_params_scales_and_cache_layout():
    cfg = configs.get_smoke_config(ARCH)
    p = model.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert isinstance(p, model.RWKVModel)
    assert sum(t.numel() for t in p.parameters()) == cfg.param_count()
    t = p.layers[1].time
    assert t.wr.dtype == torch.bfloat16 and t.u.dtype == torch.float32
    assert bool((t.w_lora_b == 0).all()) and bool((t.w0 == 0.5).all())
    assert abs(t.wr.float().std().item() * cfg.d_model ** 0.5 - 1) < 0.1
    jc = jmodels.make_cache(cfg, 3, 8)
    tc = model.make_cache(cfg, 3, 8, device="cpu")
    assert set(tc) == set(jc) == {"rwkv"}
    for n, a in jc["rwkv"].items():
        assert tuple(tc["rwkv"][n].shape) == a.shape, n
        assert str(tc["rwkv"][n].dtype).removeprefix("torch.") == \
            a.dtype.name, n


def test_forward_f32_matches():
    cfg, jp = _jax_params()
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp32 = convert.params_from_jax(jax.tree.map(np.asarray, jp32), cfg,
                                   "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    want = _np(jax.jit(lambda p, t: jmodels.forward(p, cfg, tokens=t))(
        jp32, jnp.asarray(toks, jnp.int32)))
    got = _np(model.forward(tp32, cfg, tokens=torch.from_numpy(toks)))
    assert got.shape == want.shape == (B, S, cfg.vocab)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _assert_logits(got, want):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGIT_TOL, np.abs(got - want).max()
    top2 = np.sort(want, axis=-1)[:, -2:]
    ok = top2[:, 1] - top2[:, 0] > LOGIT_TOL
    assert np.array_equal(got.argmax(-1)[ok], want.argmax(-1)[ok])


def _assert_cache(tc, jc):
    for n in ("shift_t", "shift_c", "state"):
        got, want = _np(tc["rwkv"][n]), _np(jc["rwkv"][n])
        for g, w in zip(got, want):              # layer by layer
            assert np.abs(g - w).max() <= CACHE_TOL * np.abs(w).max(), \
                (n, np.abs(g - w).max(), np.abs(w).max())


@pytest.mark.parametrize("impl", ["ref", "auto"])
def test_prefill_then_decode_bf16_matches(impl):
    """Prefill a ragged prompt, then STEPS teacher-forced decode steps from
    identical params, caches and tokens; the cache is compared after the
    prefill and after the last step."""
    cfg, jp = _jax_params()
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    jc = jmodels.make_cache(cfg, B, S + STEPS)
    tc = convert.cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    for n, a in jc["rwkv"].items():
        assert tc["rwkv"][n].dtype == (torch.float32 if n == "state"
                                       else torch.bfloat16)
    jl, jc = jax.jit(lambda p, c, t: jmodels.prefill(
        p, cfg, tokens=t, cache=c))(jp, jc, jnp.asarray(toks[:, :S]))
    tl, tc = model.prefill(tp, cfg, tokens=torch.from_numpy(toks[:, :S]),
                           cache=tc, impl=impl)
    _assert_logits(tl, jl)
    _assert_cache(tc, jc)
    dec = jax.jit(lambda p, c, t, pos: jmodels.decode_step(p, cfg, c, t, pos))
    for i in range(STEPS):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = dec(jp, jc, jnp.asarray(toks[:, S + i]), jnp.asarray(pos))
        tl, tc = model.decode_step(tp, cfg, tc, torch.from_numpy(
            toks[:, S + i]), torch.from_numpy(pos), impl=impl)
        _assert_logits(tl, jl)
    _assert_cache(tc, jc)


def test_prefill_decode_equals_forward():
    """The port alone, in f32: prefill(t0..tn) + decode(t_{n+1}) equals
    forward over the full sequence, and the prefill's state equals a
    token-by-token decode from an empty cache (the state carried from
    prefill into decode)."""
    cfg = configs.get_smoke_config(ARCH)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for lp in params.layers:
            lp.time.w_lora_b.copy_(torch.from_numpy(
                _lora_b(lp.time.w_lora_b.shape)))
    T = 21
    toks = torch.randint(0, cfg.vocab, (B, T),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full = model.forward(params, cfg, tokens=toks)
    cache = model.make_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    last, cache = model.prefill(params, cfg, tokens=toks[:, :T - 1],
                                cache=cache, impl="auto")
    np.testing.assert_allclose(_np(last), _np(full[:, T - 2]),
                               rtol=1e-4, atol=1e-4)
    step, _ = model.decode_step(params, cfg, cache, toks[:, T - 1],
                                torch.full((B,), T - 1, dtype=torch.int32))
    np.testing.assert_allclose(_np(step), _np(full[:, T - 1]),
                               rtol=1e-4, atol=1e-4)
    seq = model.make_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    for t in range(T):
        model.decode_step(params, cfg, seq, toks[:, t],
                          torch.full((B,), t, dtype=torch.int32))
    np.testing.assert_allclose(_np(seq["rwkv"]["state"]),
                               _np(cache["rwkv"]["state"]),
                               rtol=1e-4, atol=1e-4)


def test_reference_own_bf16_spread_is_inside_the_tolerance():
    """What ``LOGIT_TOL`` rests on: the reference's prefill and decode
    steps of ``test_prefill_then_decode_bf16_matches``, run under ``jit``
    and op by op (``jax.disable_jit``), differ by more than the dense
    models' 0.08 (measured 0.0918) and stay inside ``LOGIT_TOL``; the port
    stays inside it against either run."""
    cfg, jp = _jax_params()
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    jc0 = jmodels.make_cache(cfg, B, S + STEPS)
    pre = lambda p, c, t: jmodels.prefill(p, cfg, tokens=t, cache=c)
    dec = lambda p, c, t, pos: jmodels.decode_step(p, cfg, c, t, pos)
    runs = []
    for jit in (True, False):
        wrap = jax.jit if jit else (lambda f: f)
        with jax.disable_jit(not jit):
            lg, c = wrap(pre)(jp, jc0, jnp.asarray(toks[:, :S]))
            out = [_np(lg)]
            for i in range(STEPS):
                lg, c = wrap(dec)(jp, c, jnp.asarray(toks[:, S + i]),
                                  jnp.full((B,), S + i, jnp.int32))
                out.append(_np(lg))
        runs.append(np.stack(out))
    tc = convert.cache_from_jax(jax.tree.map(np.asarray, jc0), "cpu")
    lg, tc = model.prefill(tp, cfg, tokens=torch.from_numpy(toks[:, :S]),
                           cache=tc)
    out = [_np(lg)]
    for i in range(STEPS):
        lg, tc = model.decode_step(tp, cfg, tc, torch.from_numpy(
            toks[:, S + i]), torch.full((B,), S + i, dtype=torch.int32))
        out.append(_np(lg))
    port, (jit, eager) = np.stack(out), runs
    own = np.abs(jit - eager).max()
    assert 0.08 < own <= LOGIT_TOL, own
    assert np.abs(port - jit).max() <= LOGIT_TOL
    assert np.abs(port - eager).max() <= LOGIT_TOL
