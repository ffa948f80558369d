"""The port's Mamba2 families against the JAX package, on the CPU, from
parameters carried across by ``params_from_jax``: zamba2-smoke (``hybrid``:
5 Mamba2 layers, the shared attention block after layers 1 and 3, a tail
of one) and its ``ssm`` variant (the same config with ``family="ssm"``, a
test-only config: no shared block).

Tolerances, each with its reason:
- f32 (parameters cast to f32 on both sides): logits within 1e-4 of the
  largest (measured 9e-6 and 1.1e-5).
- bf16: each Mamba2 block rounds like the reference to an ulp
  (``tests/test_torch_ssm_block.py``), but a random stack amplifies one
  ulp: the port against itself, with every bf16 silu rounded another way
  (``silu(z)`` as ``z * sigmoid(z)``, 28% of its elements an ulp apart),
  moves the logits by up to 0.52 (hybrid) and 0.20 (ssm), a relative L2
  of up to 0.116 and 0.047 a step
  (``test_one_ulp_of_rounding_moves_the_logits_as_far``).  ``jax.nn.silu``
  on bf16 differs from ``F.silu`` by an ulp in 37% of elements, and the
  port sits 0.73 / 0.25 from the reference's jit run (relative L2 up to
  0.146 / 0.060).  The reference's own jit and op-by-op runs differ by
  0.133 on the hybrid (where XLA fuses the attention block differently)
  and not at all on the ssm variant (measured), so they do not bound
  this: the one-ulp spread does.  So each step's logits are held to a
  relative L2 of ``REL_L2_TOL`` = 0.2 and a max |d| of ``LOGIT_TOL`` =
  1.0, and every layer's cache entry (conv shift, state; the hybrid's k
  and v) to a relative L2 of ``REL_L2_TOL``.  Layer 0 sees identical
  inputs, so its state is held to 1e-5 of its largest and its conv shift
  to a bf16 ulp of each value (measured 4.8e-7 and one ulp).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro import models as jmodels
from repro_torch import configs, convert
from repro_torch.kernels import flash_attention
from repro_torch.launch import serve
from repro_torch.models import model, ssm

torch.set_num_threads(1)

ARCH = "zamba2_7b"
FAMILIES = ["hybrid", "ssm"]
B, S, STEPS = 2, 16, 6          # S ragged against the scan's chunk of 64
REL_L2_TOL = 0.2
LOGIT_TOL = 1.0


def _np(x):
    """A float32 numpy copy (a snapshot: caches are written in place)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(x, np.float32)


def _cfg(family, package=configs):
    return package.get_smoke_config(ARCH).replace(family=family)


@functools.cache
def _jax_params(family):
    cfg = _cfg(family, jconfigs)
    return cfg, jmodels.init_params(cfg, jax.random.PRNGKey(0))


def _tokens(cfg):
    return np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S + STEPS)).astype(np.int32)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_f32_matches(family):
    cfg, jp = _jax_params(family)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp32 = convert.params_from_jax(jax.tree.map(np.asarray, jp32), cfg,
                                   "cpu")
    assert isinstance(tp32, model.HybridModel if family == "hybrid"
                      else model.SSMModel)
    toks = _tokens(cfg)[:, :S]
    want = _np(jax.jit(lambda p, t: jmodels.forward(p, cfg, tokens=t))(
        jp32, jnp.asarray(toks)))
    got = _np(model.forward(tp32, cfg, tokens=torch.from_numpy(toks)))
    assert got.shape == want.shape == (B, S, cfg.vocab)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@functools.cache
def _reference_run(family, impl):
    """The reference's jit prefill and STEPS teacher-forced decode steps:
    each step's logits and the cache after the prefill and the last
    step."""
    cfg, jp = _jax_params(family)
    toks = _tokens(cfg)
    jc = jmodels.make_cache(cfg, B, S + STEPS)
    lg, jc = jax.jit(lambda p, c, t: jmodels.prefill(
        p, cfg, tokens=t, cache=c, impl=impl))(jp, jc, jnp.asarray(
            toks[:, :S]))
    logits, caches = [_np(lg)], [jax.tree.map(_np, jc)]
    step = jax.jit(lambda p, c, t, pos: jmodels.decode_step(
        p, cfg, c, t, pos, impl=impl))
    for i in range(STEPS):
        lg, jc = step(jp, jc, jnp.asarray(toks[:, S + i]),
                      jnp.full((B,), S + i, jnp.int32))
        logits.append(_np(lg))
    return np.stack(logits), caches + [jax.tree.map(_np, jc)]


def _port_run(family, impl):
    cfg, jp = _jax_params(family)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = _tokens(cfg)
    tc = convert.cache_from_jax(jax.tree.map(
        np.asarray, jmodels.make_cache(cfg, B, S + STEPS)), "cpu")
    assert set(tc) == ({"ssm", "kv"} if family == "hybrid" else {"ssm"})
    n0 = flash_attention.launches
    lg, tc = model.prefill(tp, cfg, tokens=torch.from_numpy(toks[:, :S]),
                           cache=tc, impl=impl)
    logits = [_np(lg)]
    caches = [{g: {n: _np(t) for n, t in c.items()} for g, c in tc.items()}]
    for i in range(STEPS):
        lg, tc = model.decode_step(tp, cfg, tc, torch.from_numpy(
            toks[:, S + i]), torch.full((B,), S + i, dtype=torch.int32),
            impl=impl)
        logits.append(_np(lg))
    assert flash_attention.launches == n0          # the CPU never launches
    caches.append({g: {n: _np(t) for n, t in c.items()}
                   for g, c in tc.items()})
    return np.stack(logits), caches


@pytest.mark.parametrize("family,impl", [("hybrid", "ref"),
                                         ("hybrid", "flash"),
                                         ("ssm", "ref")])
def test_prefill_then_decode_bf16_matches(family, impl):
    """Prefill, then STEPS teacher-forced decode steps from identical
    params, caches and tokens (``impl="flash"``: the reference's Pallas
    kernel in interpret mode on the shared block's attention, against the
    port's plain version on the CPU); the cache is compared after the
    prefill and after the last step, layer by layer."""
    want, wcaches = _reference_run(family, impl)
    got, gcaches = _port_run(family, impl)
    assert np.isfinite(got).all()
    for s in range(STEPS + 1):
        assert _rel_l2(got[s], want[s]) <= REL_L2_TOL, s
        assert np.abs(got[s] - want[s]).max() <= LOGIT_TOL, s
    for gc, wc in zip(gcaches, wcaches):
        for group, arrays in gc.items():
            for name, a in arrays.items():
                w = wc[group][name]
                assert a.shape == w.shape, (group, name)
                if name == "pos":
                    np.testing.assert_array_equal(a, w)
                    continue
                for layer in range(a.shape[0]):
                    assert _rel_l2(a[layer], w[layer]) <= REL_L2_TOL, \
                        (group, name, layer)
        d = np.abs(gc["ssm"]["state"][0] - wc["ssm"]["state"][0]).max()
        assert d <= 1e-5 * np.abs(wc["ssm"]["state"][0]).max()
        np.testing.assert_allclose(gc["ssm"]["conv"][0], wc["ssm"]["conv"][0],
                                   rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("family", FAMILIES)
def test_one_ulp_of_rounding_moves_the_logits_as_far(family, monkeypatch):
    """What ``REL_L2_TOL`` and ``LOGIT_TOL`` rest on: the port against
    itself with every bf16 silu (the Mamba2 gate's; the hybrid's shared
    MLP's) rounded twice (``z * sigmoid(z)``) instead of once, an ulp
    apart in 28% of its elements,
    moves the logits as far as the port sits from the reference (at least
    half its relative L2 at the worst step), and within the tolerances."""
    base = _port_run(family, "ref")[0]
    silu = F.silu
    monkeypatch.setattr(ssm.F, "silu", lambda z: (
        z * torch.sigmoid(z) if z.dtype == torch.bfloat16 else silu(z)))
    moved = _port_run(family, "ref")[0]
    monkeypatch.undo()
    want = _reference_run(family, "ref")[0]
    own = max(_rel_l2(moved[s], base[s]) for s in range(STEPS + 1))
    gap = max(_rel_l2(base[s], want[s]) for s in range(STEPS + 1))
    assert 0.5 * gap <= own <= REL_L2_TOL, (own, gap)
    assert np.abs(moved - base).max() <= LOGIT_TOL


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_decode_equals_forward(family):
    """The port alone, in f32: prefill(t0..tn) + decode(t_{n+1}) equals
    forward over the full sequence, and the caches they leave equal those
    of the same tokens decoded one step at a time from an empty cache."""
    cfg = _cfg(family)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               dtype=torch.float32, device="cpu")
    T = 21
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
    seq = model.make_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    for t in range(T):
        model.decode_step(params, cfg, seq, toks[:, t],
                          torch.full((B,), t, dtype=torch.int32))
    for n in ("conv", "state"):
        np.testing.assert_allclose(_np(seq["ssm"][n]), _np(cache["ssm"][n]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_make_cache_matches_the_reference_layout(family):
    """Groups, shapes and dtypes of ``make_cache`` against the reference's
    (the hybrid's KV cache has one layer a super-block, 5 // 2 = 2), and
    ``cache_from_jax`` on a filled cache of that layout, bit for bit."""
    cfg = _cfg(family)
    jc = jmodels.make_cache(_cfg(family, jconfigs), 3, 12)
    tc = model.make_cache(cfg, 3, 12, device="cpu")
    assert set(tc) == set(jc)
    for g in jc:
        assert set(tc[g]) == set(jc[g])
        for n, a in jc[g].items():
            assert tuple(tc[g][n].shape) == a.shape, (g, n)
            assert str(tc[g][n].dtype).removeprefix("torch.") == \
                a.dtype.name, (g, n)
            assert np.array_equal(_np(tc[g][n]), _np(a)), (g, n)
    if family == "hybrid":
        assert tc["kv"]["k"].shape[0] == model.n_super(cfg) == 2
    # cache_from_jax carries a filled cache across bit for bit
    rng = np.random.default_rng(6)
    filled = {g: {n: np.asarray(jnp.asarray(
        rng.standard_normal(a.shape) * 100).astype(a.dtype))
        for n, a in arrays.items()} for g, arrays in jc.items()}
    got = convert.cache_from_jax(filled, "cpu")
    for g, arrays in filled.items():
        for n, a in arrays.items():
            t = got[g][n]
            assert str(t.dtype).removeprefix("torch.") == a.dtype.name
            if a.dtype.name == "bfloat16":
                assert np.array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16)), (g, n)
            else:
                assert np.array_equal(t.numpy(), a), (g, n)


def test_generate_serves_a_two_group_cache():
    """``launch.serve.generate`` on the hybrid's {"ssm", "kv"} cache: the
    greedy tokens of the prefill step and a decode loop written out here,
    bit for bit, both caches written in place."""
    cfg = _cfg("hybrid")
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    prompts = torch.randint(0, cfg.vocab, (B, 24),
                            generator=torch.Generator().manual_seed(3))
    cache = model.make_cache(cfg, B, 24 + 5, device="cpu")
    out = serve.generate(params, cfg, cache, tokens=prompts, gen=5,
                         impl="flash")
    assert out.tokens.shape == (B, 5) and out.tokens.dtype == torch.int32
    assert bool((cache["kv"]["pos"][:, :, 24 + 3] == 24 + 3).all())
    assert bool(cache["ssm"]["state"].any())
    ref = model.make_cache(cfg, B, 24 + 5, device="cpu")
    logits, ref = model.prefill(params, cfg, tokens=prompts, cache=ref)
    tok = logits.argmax(-1).to(torch.int32)
    want = [tok]
    for i in range(4):
        logits, ref = model.decode_step(
            params, cfg, ref, tok, torch.full((B,), 24 + i, dtype=torch.int32))
        tok = logits.argmax(-1).to(torch.int32)
        want.append(tok)
    assert torch.equal(out.tokens, torch.stack(want, dim=1))
    for g in cache:
        for n in cache[g]:
            assert torch.equal(cache[g][n], ref[g][n]), (g, n)


@pytest.mark.parametrize("arch", ["zamba2-7b", "qwen2-moe-a2.7b",
                                  "qwen3-moe-235b-a22b"])
def test_serve_cli_runs_the_new_families(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert f"family={configs.get_config(arch).family}" in out
    assert "generated token ids (first sequence):" in out
