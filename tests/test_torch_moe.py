"""The port's MoE sublayer and the ``moe`` family (qwen2-moe-smoke,
qwen3-moe-smoke) against the JAX package, on the CPU, from parameters
carried across by ``params_from_jax`` and inputs made with numpy.

Routing: the f32 router's products are summed in other orders by the two
frameworks, so a near-tie between the k-th and the (k+1)-th gate could
pick another expert.  So dispatch is held bit for bit on *identical*
``topi`` (with drops: capacities below what the choices need), and a
whole block is compared only after its top-k sets are asserted equal on
both sides (they are, at these inputs).  The smoke configs are dropless
(``capacity_factor`` 8); the blocks run at 0.5 as well, which drops
about half of the (token, choice) pairs.

Tolerances, each with its reason:
- f32 blocks: rel 1e-5 of the largest |value| (measured 5e-7 of 3.1).
- bf16 blocks: ``BF16_REL`` = 2**-6 of the largest |value|: one bf16 ulp
  apart (measured 0.0156 of 3.11, 0.0078 of 1.46, 2**-7.6 of the
  largest).  The reference's jit and op-by-op runs agree bit for bit
  here; the frameworks round the expert products' bf16 outputs and the
  silu apart (``tests/test_torch_ssm_block.py``).
- models: f32 logits within 1e-4 of the largest.  In bf16 the
  reference's own jit and op-by-op runs of the same prefill and decode
  steps route some token to another expert (a near-tie of gates computed
  from hidden states rounded apart) and then differ by up to 0.47 on that
  row (``test_reference_own_bf16_spread``); on every other row they stay
  within 0.039, inside the dense models' ``LOGIT_TOL`` = 0.08.  So the
  port is held to the reference's jit run on the rows and steps where
  the reference agrees with itself (every one of qwen2-moe-smoke's, whose
  op-by-op run is therefore not made): logits within ``LOGIT_TOL``, greedy
  tokens under the margin rule of ``tests/test_torch_models.py``, the
  cache's k and v within its ``CACHE_RTOL``/``CACHE_ATOL``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import moe as jmoe
from repro_torch import configs, convert
from repro_torch.kernels import flash_attention
from repro_torch.models import model, moe

torch.set_num_threads(1)

ARCHS = ["qwen2_moe_a2_7b", "qwen3_moe_235b_a22b"]
SELF_SPREAD_ARCH = "qwen3_moe_235b_a22b"
B, S, STEPS = 2, 16, 4
BF16_REL = 2.0 ** -6
LOGIT_TOL = 0.08
TIE = 1e-3
CACHE_RTOL, CACHE_ATOL = 2.0 ** -6, 0.05
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ dispatch
def _choices(rng, G, S_, k, E, skew):
    """k distinct experts a token; with ``skew`` every token's first
    choice is expert 0 (its queue overflows)."""
    topi = np.stack([np.stack([rng.permutation(E)[:k] for _ in range(S_)])
                     for _ in range(G)]).astype(np.int32)
    if skew:
        topi[..., 0] = 0
        topi[..., 1:] = np.where(topi[..., 1:] == 0, E - 1, topi[..., 1:])
    return topi


@pytest.mark.parametrize("G,S_,k,E,C,skew", [
    (1, 16, 2, 8, 2, False), (3, 37, 4, 16, 5, False),
    (2, 64, 8, 128, 3, False), (4, 1, 4, 60, 1, False),
    (2, 24, 4, 60, 2, True)],
    ids=["smoke", "ragged", "qwen3-like", "decode", "skewed"])
def test_dispatch_indices_bit_exact(G, S_, k, E, C, skew):
    topi = _choices(np.random.default_rng(S_ + k), G, S_, k, E, skew)
    ws, wk = jax.vmap(lambda t: jmoe._group_dispatch_indices(t, E, C))(
        jnp.asarray(topi))
    gs, gk = moe._group_dispatch_indices(torch.from_numpy(topi), E, C)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    if skew or C * E < S_ * k:
        assert not gk.all()                         # some pairs dropped
    # one group alone, the reference function's own signature
    s1, k1 = moe._group_dispatch_indices(torch.from_numpy(topi[0]), E, C)
    assert torch.equal(s1, gs[0]) and torch.equal(k1, gk[0])


# ------------------------------------------------------------------ block
def _block(arch, cf, dtype):
    cfg = jconfigs.get_smoke_config(arch).replace(capacity_factor=cf)
    jdt, tdt = DTYPES[dtype]
    jp = jmoe.init_moe(jax.random.PRNGKey(3), cfg, jdt)
    tp = moe.MoE(configs.get_smoke_config(arch), tdt, "cpu")
    tp.load_state_dict({n: convert.tensor_from_numpy(a, "cpu")
                        for n, a in _flat(jax.tree.map(np.asarray, jp))},
                       strict=True)
    return cfg, jp, tp


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["dropless", "drops"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches(arch, dtype, cf):
    cfg, jp, tp = _block(arch, cf, dtype)
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    gates = jax.nn.softmax(xj.astype(jnp.float32) @ jp["router"], axis=-1)
    want_topi = np.sort(np.asarray(jax.lax.top_k(gates, cfg.top_k)[1]), -1)
    with torch.no_grad():
        _, _, topi = moe.route(tp, xt, cfg.top_k)
        keep = moe._group_dispatch_indices(
            topi, cfg.n_experts, moe.capacity(cfg, S))[1]
        got = moe.moe_block(tp, xt, cfg)
    # identical routing on both sides (no near-tie at these inputs)
    np.testing.assert_array_equal(np.sort(topi.numpy(), -1), want_topi)
    assert bool(keep.all()) == (cf == 8.0)
    want = jax.jit(lambda p, x: jmoe.moe_block(p, x, cfg))(jp, xj)
    got, want = _np(got), _np(want)
    assert got.shape == want.shape == (B, S, cfg.d_model)
    assert np.isfinite(got).all()
    rel = 1e-5 if dtype == "f32" else BF16_REL
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_aux_load_balance_loss_matches():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((64, 60)).astype(np.float32) * 2
    gates = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = float(jmoe.aux_load_balance_loss(jnp.asarray(gates), 4))
    got = moe.aux_load_balance_loss(torch.from_numpy(gates), 4)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(got.item() - want) <= 1e-6 * abs(want)


def test_init_moe_scales_and_dtypes():
    cfg = configs.get_config("qwen2_moe_a2_7b").replace(
        n_experts=6, d_model=256)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jax.eval_shape(lambda k: jmoe.init_moe(k, cfg),
                        jax.random.PRNGKey(0))
    ours = dict(p.named_parameters())
    theirs = {".".join(k.key for k in path): a for path, a in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert set(ours) == set(theirs)
    for n, a in theirs.items():
        assert tuple(ours[n].shape) == a.shape, n
        assert str(ours[n].dtype).removeprefix("torch.") == a.dtype.name, n
    d, f = cfg.d_model, cfg.moe_d_ff
    assert abs(p.router.std().item() * d ** 0.5 - 1) < 0.05
    for w, fan_in in ((p.w1, d), (p.w3, d), (p.w2, f)):
        for e in (0, cfg.n_experts - 1):
            assert abs(w[e].float().std().item() * fan_in ** 0.5 - 1) < 0.05
    assert not torch.equal(p.w1[0], p.w1[1])


# ------------------------------------------------------------------ models
@functools.cache
def _jax_params(arch):
    cfg = jconfigs.get_smoke_config(arch)
    return cfg, jmodels.init_params(cfg, jax.random.PRNGKey(0))


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S + STEPS)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_f32_matches(arch):
    cfg, jp = _jax_params(arch)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp32 = convert.params_from_jax(jax.tree.map(np.asarray, jp32), cfg,
                                   "cpu")
    toks = _tokens(cfg)[:, :S]
    want = _np(jax.jit(lambda p, t: jmodels.forward(p, cfg, tokens=t))(
        jp32, jnp.asarray(toks)))
    got = _np(model.forward(tp32, cfg, tokens=torch.from_numpy(toks)))
    assert got.shape == want.shape == (B, S, cfg.vocab)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@functools.cache
def _reference_run(arch, impl, jit=True):
    """The reference's prefill and STEPS teacher-forced decode steps, under
    ``jit`` or op by op (``jax.disable_jit``): each step's logits and the
    cache after the prefill and after the last step.  The two ways round
    bf16 in other places, and where a token's k-th and (k+1)-th gates
    nearly tie, they route it to other experts."""
    cfg, jp = _jax_params(arch)
    toks = _tokens(cfg, 1)
    pre = lambda p, c, t: jmodels.prefill(p, cfg, tokens=t, cache=c,
                                          impl=impl)
    dec = lambda p, c, t, pos: jmodels.decode_step(p, cfg, c, t, pos,
                                                   impl=impl)
    wrap = jax.jit if jit else (lambda f: f)
    with jax.disable_jit(not jit):
        step = wrap(dec)
        lg, c = wrap(pre)(jp, jmodels.make_cache(cfg, B, S + STEPS),
                          jnp.asarray(toks[:, :S]))
        logits, caches = [_np(lg)], [jax.tree.map(_np, c)]
        for i in range(STEPS):
            lg, c = step(jp, c, jnp.asarray(toks[:, S + i]),
                         jnp.full((B,), S + i, jnp.int32))
            logits.append(_np(lg))
    return np.stack(logits), caches + [jax.tree.map(_np, c)]


def _port_run(arch, impl):
    """The port's run of ``_reference_run``'s steps, and the smallest
    top-k gate margin (k-th largest gate less the (k+1)-th) that its
    router saw, for each row up to each step."""
    cfg, jp = _jax_params(arch)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = _tokens(cfg, 1)
    tc = convert.cache_from_jax(jax.tree.map(
        np.asarray, jmodels.make_cache(cfg, B, S + STEPS)), "cpu")
    margins = []
    route = moe.route

    def recording_route(p, x, k):
        gates, topv, topi = route(p, x, k)
        g = torch.sort(gates, dim=-1, descending=True).values
        margins.append((g[..., k - 1] - g[..., k]).amin(dim=-1).numpy())
        return gates, topv, topi

    n0 = flash_attention.launches
    moe.route = recording_route
    try:
        lg, tc = model.prefill(tp, cfg, tokens=torch.from_numpy(
            toks[:, :S]), cache=tc, impl=impl)
        logits = [_np(lg)]
        caches = [{n: _np(t) for n, t in tc["kv"].items()}]
        for i in range(STEPS):
            lg, tc = model.decode_step(tp, cfg, tc, torch.from_numpy(
                toks[:, S + i]), torch.full((B,), S + i, dtype=torch.int32),
                impl=impl)
            logits.append(_np(lg))
    finally:
        moe.route = route
    assert flash_attention.launches == n0          # the CPU never launches
    caches.append({n: _np(t) for n, t in tc["kv"].items()})
    per_step = np.stack(margins).reshape(STEPS + 1, cfg.n_layers, B).min(1)
    return np.stack(logits), caches, np.minimum.accumulate(per_step, axis=0)


def _unstable(arch):
    """(step, row) where the reference's own jit and op-by-op runs part by
    more than ``LOGIT_TOL``.  Only qwen3-moe-smoke's do
    (``test_reference_own_bf16_spread``); qwen2-moe-smoke's stay within
    0.039 of each other on every row and step (measured), so its op-by-op
    run, some 18 s of the CPU, is not made and every row is held."""
    jit = _reference_run(arch, "ref")[0]
    if arch != SELF_SPREAD_ARCH:
        return np.zeros(jit.shape[:2], bool)
    eager = _reference_run(arch, "ref", jit=False)[0]
    return np.abs(jit - eager).max(axis=-1) > LOGIT_TOL


@pytest.mark.parametrize("arch,impl", [(a, "ref") for a in ARCHS]
                         + [("qwen2_moe_a2_7b", "flash")])
def test_prefill_then_decode_bf16_matches(arch, impl):
    """Prefill, then STEPS teacher-forced decode steps from identical
    params, caches and tokens (``impl="flash"``: the reference's Pallas
    kernel in interpret mode against the port's plain version on the
    CPU), held to the reference's jit run on every row and step where the
    reference's own two runs agree within ``LOGIT_TOL``: logits within it,
    greedy tokens under the margin rule, the cache's k and v (after the
    prefill and after the last step) within ``CACHE_RTOL``/``CACHE_ATOL``.
    Where the reference parts from itself (a routing near-tie,
    ``test_reference_own_bf16_spread``) the row is held to finite logits
    alone."""
    jit, jcaches = _reference_run(arch, impl)
    logits, caches, _ = _port_run(arch, impl)
    held = ~_unstable(arch)
    assert held.sum() >= STEPS                 # rows and steps left to hold
    assert np.isfinite(logits).all()
    for s, b in zip(*np.nonzero(held)):
        got, want = logits[s, b], jit[s, b]
        assert np.abs(got - want).max() <= LOGIT_TOL, (s, b)
        top2 = np.sort(want)[-2:]
        if top2[1] - top2[0] > LOGIT_TOL:
            assert got.argmax() == want.argmax(), (s, b)
    for when, step in ((0, 0), (1, STEPS)):
        rows = held[step]
        for name in ("k", "v"):
            np.testing.assert_allclose(
                caches[when][name][:, rows], jcaches[when]["kv"][name][:, rows],
                rtol=CACHE_RTOL, atol=CACHE_ATOL)
        np.testing.assert_array_equal(caches[when]["pos"],
                                      jcaches[when]["kv"]["pos"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_equals_forward(arch):
    """The port alone, in f32: prefill(t0..tn) + decode(t_{n+1}) equals
    forward over the full sequence (dropless: the capacity of a group of S
    and of one token both hold every choice)."""
    cfg = configs.get_smoke_config(arch)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               dtype=torch.float32, device="cpu")
    T = 9
    toks = torch.randint(0, cfg.vocab, (B, T),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full = model.forward(params, cfg, tokens=toks)
    cache = model.make_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    last, cache = model.prefill(params, cfg, tokens=toks[:, :T - 1],
                                cache=cache)
    np.testing.assert_allclose(_np(last), _np(full[:, T - 2]), rtol=1e-4,
                               atol=1e-4)
    step, _ = model.decode_step(params, cfg, cache, toks[:, T - 1],
                                torch.full((B,), T - 1, dtype=torch.int32))
    np.testing.assert_allclose(_np(step), _np(full[:, T - 1]), rtol=1e-4,
                               atol=1e-4)


def test_reference_own_bf16_spread():
    """What the rule above rests on.  The reference's own jit and op-by-op
    runs part by more than ``LOGIT_TOL`` only on rows whose routing had a
    near-tie: a top-k gate margin below ``TIE`` = 1e-3 in the port's router
    at that row's tokens, at that step or before (the cache carries an
    earlier route on).  Measured: qwen3-moe-smoke parts on row 1 from the
    prefill on (by 0.15-0.37; margin 4.5e-5) and on row 0 at the third
    decode step (0.47; margin 6.3e-4); elsewhere, and everywhere for
    qwen2-moe-smoke, the two runs stay within 0.039 and the port within
    0.047 of the jit run."""
    unstable = _unstable(SELF_SPREAD_ARCH)
    margins = _port_run(SELF_SPREAD_ARCH, "ref")[2]         # (step, row)
    assert unstable.any()
    assert (margins[unstable] < TIE).all()
