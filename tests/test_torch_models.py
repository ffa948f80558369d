"""The port's model zoo against the JAX package, on the CPU: every config's
parameter tree, and the dense families at the smoke configs, from
parameters carried across by ``params_from_jax`` (the ``moe``, ``ssm`` and
``hybrid`` families' runs are in ``tests/test_torch_moe.py`` and
``tests/test_torch_hybrid.py``).

Tolerances, each with its reason:
- f32 (parameters and inputs cast to f32 on both sides, which holds the
  algorithm): logits rel 1e-4 of the largest logit (measured ~1e-6);
  layer functions rel/abs 1e-5.
- bf16 (the serving default): the frameworks round bf16 intermediates in
  different places, so logits of magnitude ~3.5 differ by up to 0.043
  after 2 layers (measured); logits are held to abs ``LOGIT_TOL`` = 0.08.
  Cached k and v (projections of bf16-rounded normed activations) differ
  by up to 0.031 abs (measured, gemma-smoke): held to rel 2**-6 plus abs
  ``CACHE_ATOL`` = 0.05.
- Greedy tokens are equal wherever the reference's top-2 logit margin
  exceeds ``LOGIT_TOL``, the margin rule.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import layers as jlayers
from repro_torch import configs, convert
from repro_torch.kernels import flash_attention
from repro_torch.models import layers, model, moe, ssm
from repro_torch.models.config import param_count_shortfall

torch.set_num_threads(1)

DENSE = ["granite_8b", "gemma_7b", "qwen2_5_32b", "h2o_danube_1_8b",
         "musicgen_large", "internvl2_76b"]
# every config of the zoo, and zamba2's test-only ``ssm`` variant
ZOO = [(a, None) for a in configs.ARCHS] + [("zamba2_7b", "ssm")]
B, S, STEPS = 2, 16, 8
LOGIT_TOL = 0.08
CACHE_RTOL, CACHE_ATOL = 2.0 ** -6, 0.05


@functools.cache
def _jax_params(arch):
    cfg = jconfigs.get_smoke_config(arch)
    return cfg, jmodels.init_params(cfg, jax.random.PRNGKey(0))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _data(cfg, seed=0):
    """Prompt tokens (or f32 embeddings for a stub frontend) and the
    teacher-forced decode tokens, from numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    emb = (rng.standard_normal((B, S, cfg.d_model)) * 0.1).astype(np.float32)
    return toks, emb


# ------------------------------------------------------------------ configs
def test_configs_are_copies_of_the_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in configs.ARCHS + configs.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            ours = getattr(configs, get)(arch)
            theirs = getattr(jconfigs, get)(arch)
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
            assert ours.param_count() == theirs.param_count()
            assert ours.active_param_count() == theirs.active_param_count()
            assert (ours.dh, ours.q_dim, ours.kv_dim) == \
                (theirs.dh, theirs.q_dim, theirs.kv_dim)


# ------------------------------------------------------------------ layers
def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(1)
    x, w = _rand(rng, 2, 5, 64), _rand(rng, 64)
    np.testing.assert_allclose(
        _np(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))),
        _np(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)
    pos = np.arange(40, dtype=np.int32).reshape(2, 20) * 7
    xq = _rand(rng, 2, 20, 4, 32)
    for theta in (1e4, 1e7):
        tc, ts = layers.rope_tables(torch.from_numpy(pos), 32, theta)
        jc, js = jlayers.rope_tables(jnp.asarray(pos), 32, theta)
        np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            _np(layers.apply_rope(torch.from_numpy(xq), tc, ts)),
            _np(jlayers.apply_rope(jnp.asarray(xq), jc, js)),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,valid,chunk", [
    (None, False, 16), (24, False, 16), (None, True, 32), (8, True, 64)])
def test_attention_ref_and_chunked_match(window, valid, chunk):
    rng = np.random.default_rng(2)
    Sq = Sk = 40
    q, k, v = (_rand(rng, 2, Sq, 4, 32), _rand(rng, 2, Sk, 2, 32),
               _rand(rng, 2, Sk, 2, 32))
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (2, Sq)).copy()
    kv = (np.arange(Sk)[None] < 30).repeat(2, 0) if valid else None
    t = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
    j = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    tkv = None if kv is None else torch.from_numpy(kv)
    jkv = None if kv is None else jnp.asarray(kv)
    want = jlayers.attention_ref(*j, window=window, k_valid=jkv)
    np.testing.assert_allclose(
        _np(layers.attention_ref(*t, window=window, k_valid=tkv)),
        _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(layers.attention_chunked(*t, window=window, k_valid=tkv,
                                     chunk=chunk)),
        _np(jlayers.attention_chunked(*j, window=window, k_valid=jkv,
                                      chunk=chunk)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp_matches(act):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 5, 32)
    w = {"w1": _rand(rng, 32, 48), "w3": _rand(rng, 32, 48),
         "w2": _rand(rng, 48, 32)}
    p = layers.GatedMLP(32, 48, torch.float32, "cpu")
    p.load_state_dict({n: torch.from_numpy(a) for n, a in w.items()})
    np.testing.assert_allclose(
        _np(layers.gated_mlp(p, torch.from_numpy(x), act)),
        _np(jlayers.gated_mlp({n: jnp.asarray(a) for n, a in w.items()},
                              jnp.asarray(x), act)),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ params
def _config(package, arch, family, smoke):
    cfg = (package.get_smoke_config if smoke else package.get_config)(arch)
    return cfg if family is None else cfg.replace(family=family)


def _id(case):
    arch, family = case
    return arch if family is None else f"{arch}-{family}"


@pytest.mark.parametrize("case", ZOO, ids=_id)
def test_every_config_builds_the_reference_tree(case):
    """At full width on the meta device, the port's model for each config
    has one parameter for each leaf of the reference's ``init_params`` tree
    (``jax.eval_shape``: no weights made) and each layer's slice, in shape
    and dtype, and ``param_tree_shapes`` gives that tree."""
    arch, family = case
    cfg = _config(configs, arch, family, smoke=False)
    jcfg = _config(jconfigs, arch, family, smoke=False)
    tree = jax.eval_shape(lambda k: jmodels.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    ours = dict(model.model_class(cfg)(cfg, device="meta").named_parameters())
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        rows = range(cfg.n_layers) if keys[0] == "layers" else [None]
        for i in rows:
            name = ".".join(keys if i is None
                            else ["layers", str(i)] + keys[1:])
            shape = leaf.shape if i is None else leaf.shape[1:]
            assert tuple(ours[name].shape) == shape, name
            assert str(ours[name].dtype).removeprefix("torch.") == \
                leaf.dtype.name, name
            n += 1
    assert n == len(ours)
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype.name), tree)
    got = jax.tree.map(
        lambda t: (t[0], str(t[1]).removeprefix("torch.")),
        model.param_tree_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    assert got == shapes
    total = sum(t.numel() for t in ours.values())
    assert total == cfg.param_count() + param_count_shortfall(cfg)


def test_param_count_fault_of_the_reference():
    """The reference's ``param_count`` is short by n_layers * ((H - h) d +
    3H - 2h) for the Mamba2 families: 20 at zamba2-smoke, 24,408,216 for
    zamba2-7b (81 x 301,336); the port's copy of the formula keeps it."""
    for smoke, short in ((True, 20), (False, 24_408_216)):
        cfg = _config(configs, "zamba2_7b", None, smoke)
        jcfg = _config(jconfigs, "zamba2_7b", None, smoke)
        tree = jax.eval_shape(lambda k: jmodels.init_params(jcfg, k),
                              jax.random.PRNGKey(0))
        leaves = sum(a.size for a in jax.tree.leaves(tree))
        assert param_count_shortfall(cfg) == short
        assert leaves - jcfg.param_count() == short
        assert cfg.param_count() == jcfg.param_count()
    assert configs.get_config("zamba2_7b").param_count() == 6_725_509_560


@pytest.mark.parametrize("case", [(a, None) for a in DENSE] + [
    ("qwen2_moe_a2_7b", None), ("qwen3_moe_235b_a22b", None),
    ("zamba2_7b", None), ("zamba2_7b", "ssm")], ids=_id)
def test_params_from_jax_maps_every_leaf(case):
    arch, family = case
    cfg = _config(jconfigs, arch, family, smoke=True)
    jp = (_jax_params(arch)[1] if family is None
          else jmodels.init_params(cfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert type(tp) is model.model_class(cfg)
    ours = dict(tp.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    n = 0
    for path, leaf in flat:
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
    assert sum(t.numel() for t in ours.values()) == \
        cfg.param_count() + param_count_shortfall(cfg)


def test_init_params_scales():
    cfg = configs.get_smoke_config("granite_8b")
    p = model.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert p.embed.dtype == torch.bfloat16
    assert p.layers[0].ln1.dtype == torch.float32
    assert abs(p.embed.float().std().item() - 0.02) < 0.002
    assert abs(p.head.float().std().item() * cfg.d_model ** 0.5 - 1) < 0.05
    wo = p.layers[1].attn.wo.float()
    assert abs(wo.std().item() * cfg.q_dim ** 0.5 - 1) < 0.1
    q = model.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert torch.equal(p.layers[1].mlp.w2, q.layers[1].mlp.w2)


@pytest.mark.parametrize("arch,make", [
    ("granite_8b", lambda cfg: model.init_params(cfg, torch.Generator())),
    ("granite_8b", lambda cfg: model.make_cache(cfg, 1, 8)),
    ("granite_8b", lambda cfg: layers.empty_kv_cache(cfg, 1, 8)),
    ("granite_8b", lambda cfg: model.DenseModel(cfg)),
    ("granite_8b", lambda cfg: layers.Attention(cfg)),
    ("granite_8b", lambda cfg: layers.GatedMLP(cfg.d_model, cfg.d_ff)),
    ("zamba2_7b", lambda cfg: model.init_params(cfg, torch.Generator())),
    ("zamba2_7b", lambda cfg: model.make_cache(cfg, 1, 8)),
    ("zamba2_7b", lambda cfg: ssm.empty_ssm_cache(cfg, 1)),
    ("zamba2_7b", lambda cfg: ssm.SSMBlock(cfg)),
    ("zamba2_7b", lambda cfg: model.HybridModel(cfg)),
    ("qwen2_moe_a2_7b", lambda cfg: moe.MoE(cfg)),
    ("qwen2_moe_a2_7b", lambda cfg: model.init_params(cfg,
                                                      torch.Generator())),
], ids=["init_params", "make_cache", "empty_kv_cache", "DenseModel",
        "Attention", "GatedMLP", "init_params-hybrid", "make_cache-hybrid",
        "empty_ssm_cache", "SSMBlock", "HybridModel", "MoE",
        "init_params-moe"])
def test_default_device_is_cuda(arch, make, monkeypatch):
    """``device=None`` is the CUDA device, as at every entry point of the
    port: without one these raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        make(configs.get_smoke_config(arch))


def test_unknown_family_raises():
    cfg = configs.get_smoke_config("granite_8b").replace(family="mystery")
    for make in (lambda: model.model_class(cfg),
                 lambda: model.make_cache(cfg, 1, 8, device="cpu"),
                 lambda: model.init_params(cfg, torch.Generator(),
                                           device="cpu")):
        with pytest.raises(ValueError, match="unknown family mystery"):
            make()


def test_init_params_rejects_a_generator_elsewhere(monkeypatch):
    """A CPU generator does not carry the weights to the CPU: the target
    device is asked for, and the generator must live on it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = configs.get_smoke_config("granite_8b")
    with pytest.raises(ValueError, match="generator is on cpu"):
        model.init_params(cfg, torch.Generator().manual_seed(0))


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("arch", DENSE)
def test_forward_f32_matches(arch):
    cfg, jp = _jax_params(arch)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp32 = convert.params_from_jax(jax.tree.map(np.asarray, jp32), cfg,
                                   "cpu")
    toks, emb = _data(cfg)
    if cfg.frontend:
        want = jax.jit(lambda p, e: jmodels.forward(p, cfg, embeds=e))(
            jp32, jnp.asarray(emb))
        got = model.forward(tp32, cfg, embeds=torch.from_numpy(emb))
    else:
        want = jax.jit(lambda p, t: jmodels.forward(p, cfg, tokens=t))(
            jp32, jnp.asarray(toks[:, :S]))
        got = model.forward(tp32, cfg, tokens=torch.from_numpy(toks[:, :S]))
    want = _np(want)
    assert got.shape == want.shape == (B, S, cfg.vocab)
    assert np.abs(_np(got) - want).max() <= 1e-4 * np.abs(want).max()


def _margin_ok(logits):
    """Rows whose top-2 logit margin exceeds the bf16 logit tolerance."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > LOGIT_TOL


def _assert_logits(got, want):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGIT_TOL, np.abs(got - want).max()
    ok = _margin_ok(want)
    assert np.array_equal(got.argmax(-1)[ok], want.argmax(-1)[ok])


def _assert_cache(tc, jc):
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc["kv"][name]), _np(jc["kv"][name]),
                                   rtol=CACHE_RTOL, atol=CACHE_ATOL)
    assert np.array_equal(tc["kv"]["pos"].numpy(),
                          np.asarray(jc["kv"]["pos"]))


@pytest.mark.parametrize("arch,impl", [(a, "ref") for a in DENSE]
                         + [("granite_8b", "flash"), ("gemma_7b", "flash")])
def test_prefill_then_decode_bf16_matches(arch, impl):
    """Prefill, then STEPS teacher-forced decode steps from identical
    params, caches and tokens; the cache is compared after prefill and
    after the last step."""
    cfg, jp = _jax_params(arch)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks, emb = _data(cfg)
    jc = jmodels.make_cache(cfg, B, S + STEPS)
    tc = convert.cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    pre = jax.jit(lambda p, c, t, e: jmodels.prefill(
        p, cfg, tokens=t, embeds=e, cache=c, impl=impl))
    n0 = flash_attention.launches
    if cfg.frontend:
        e16 = torch.from_numpy(emb).to(torch.bfloat16)
        jl, jc = pre(jp, jc, None, jnp.asarray(emb).astype(jnp.bfloat16))
        tl, tc = model.prefill(tp, cfg, embeds=e16, cache=tc, impl=impl)
    else:
        jl, jc = pre(jp, jc, jnp.asarray(toks[:, :S]), None)
        tl, tc = model.prefill(tp, cfg, tokens=torch.from_numpy(toks[:, :S]),
                               cache=tc, impl=impl)
    assert flash_attention.launches == n0          # the CPU never launches
    _assert_logits(tl, jl)
    _assert_cache(tc, jc)
    dec = jax.jit(lambda p, c, t, pos: jmodels.decode_step(
        p, cfg, c, t, pos, impl=impl))
    for i in range(STEPS):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = dec(jp, jc, jnp.asarray(toks[:, S + i]), jnp.asarray(pos))
        tl, tc = model.decode_step(tp, cfg, tc, torch.from_numpy(
            toks[:, S + i]), torch.from_numpy(pos), impl=impl)
        _assert_logits(tl, jl)
    _assert_cache(tc, jc)


@pytest.mark.parametrize("arch", [a for a in DENSE
                                  if not configs.get_smoke_config(a).frontend])
def test_prefill_decode_equals_forward(arch):
    """The port alone: prefill(t0..tn) + decode(t_{n+1}) equals forward
    over the full sequence, position by position (the mirror of
    ``tests/test_arch_smoke.py::test_prefill_decode_consistency``)."""
    cfg = configs.get_smoke_config(arch)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    T = 8
    toks = torch.randint(0, cfg.vocab, (B, T),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full = model.forward(params, cfg, tokens=toks)
    cache = model.make_cache(cfg, B, max_len=T, device="cpu")
    last, cache = model.prefill(params, cfg, tokens=toks[:, :T - 1],
                                cache=cache)
    np.testing.assert_allclose(_np(last), _np(full[:, T - 2]),
                               rtol=2e-2, atol=2e-2)
    step, _ = model.decode_step(params, cfg, cache, toks[:, T - 1],
                                torch.full((B,), T - 1, dtype=torch.int32))
    np.testing.assert_allclose(_np(step), _np(full[:, T - 1]),
                               rtol=2e-2, atol=2e-2)
