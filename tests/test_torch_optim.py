"""The port's AdamW (``repro_torch.optim``) against ``repro.optim``, on the
CPU: the schedule and bias corrections for steps 0-250, the global norm,
one update on a reference-shaped tree (rwkv6-smoke and zamba2-smoke: bf16
matrices, f32 vectors, stacked per-layer leaves), and the weight-decay
rule.

Tolerances, each with its reason:
- The reference run op by op (``jax.disable_jit``) rounds each operation
  once, as the port does: the bias corrections and the updated moments
  and parameters are held bit for bit (with the global norm under 1, so
  the clip scale is exactly 1).  The schedule too, except where XLA's f32
  ``cos`` is not correctly rounded (the port rounds once from f64): there
  its lr is within 2 f32 ulps, and those steps are few.
- The global norm sums leaves (stacked in JAX, per layer here) in other
  orders: within 1e-6 relative of the float64 norm, and of the
  reference's within that plus the reference's own error (XLA:CPU sums a
  leaf's squares with an error up to ~1.2e-6 relative here, where the
  port's pairwise sums stay ~5e-8 from the float64 norm).
- Under ``jit`` XLA:CPU contracts multiply-adds into FMAs and divides by
  a reciprocal (ROADMAP §3): moments within 2 f32 ulps of their two
  summands (where the summands cancel, the result's own ulps say
  nothing: one element moved 6,280 of them), parameters within 1 bf16
  ulp of |before| + |after| the step.  A clipped update (global norm > 1) carries the norm's relative
  gap (up to ~1.2e-6, above) into every gradient: 4e-6 more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import optim as joptim
from repro_torch import configs, convert, optim
from repro_torch.models import reference_leaf

torch.set_num_threads(1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat):
    out = {}
    for name, v in flat.items():
        *parents, leaf = name.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _bits(x):
    """An array's bits, to compare bf16 and f32 exactly."""
    a = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    if str(a.dtype) == "bfloat16":
        return a.view(np.uint16)
    if a.dtype == np.uint16:
        return a
    raise TypeError(a.dtype)


def _torch_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy().view(np.uint32)


def _ulps_f32(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b).max()


def _check_norm(got, want, tree):
    truth = np.sqrt(sum((np.asarray(a, np.float64) ** 2).sum()
                        for a in _flat(tree).values()))
    assert abs(got - truth) <= 1e-6 * truth
    assert abs(got - want) <= abs(want - truth) + 1e-6 * truth


# ------------------------------------------------------------- schedule
SCHED = dict(lr=3e-3, warmup_steps=10, total_steps=250)


def test_config_and_state_mirror_the_reference():
    assert (dataclasses.asdict(optim.AdamWConfig())
            == dataclasses.asdict(joptim.AdamWConfig()))
    assert optim.OptState._fields == joptim.adamw.OptState._fields


def test_cosine_schedule_matches_for_steps_0_to_250():
    steps = np.arange(251, dtype=np.int32)
    jcfg, cfg = joptim.AdamWConfig(**SCHED), optim.AdamWConfig(**SCHED)
    with jax.disable_jit():
        want = np.asarray(joptim.cosine_schedule(jcfg, jnp.asarray(steps)))
        # the reference's own cos argument and cos, to find where XLA's
        # f32 cos is not correctly rounded
        prog = jnp.clip((jnp.asarray(steps) - jcfg.warmup_steps)
                        / jnp.maximum(jcfg.total_steps - jcfg.warmup_steps,
                                      1), 0.0, 1.0)
        arg = np.asarray(jnp.pi * prog)
        jcos = np.asarray(jnp.cos(arg))
    got = optim.cosine_schedule(cfg, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    off = jcos != np.cos(arg.astype(np.float64)).astype(np.float32)
    assert off.sum() <= 5, np.nonzero(off)
    np.testing.assert_array_equal(got[~off], want[~off])
    assert _ulps_f32(got[off], want[off]) <= 2


@pytest.mark.parametrize("beta", [0.9, 0.95, 0.999])
def test_bias_correction_matches_for_steps_0_to_250(beta):
    steps = np.arange(251, dtype=np.int32)
    with jax.disable_jit():
        want = np.asarray(1.0 - beta ** jnp.asarray(steps).astype(
            jnp.float32))
    got = optim.adamw.bias_correction(beta, torch.from_numpy(steps))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_global_norm_matches():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((7, 33)).astype(np.float32),
            "b": {"c": (rng.standard_normal((5, 64, 3)) * 1e-3).astype(
                np.float32)}, "d": rng.standard_normal(11).astype(np.float32)}
    want = float(joptim.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = optim.global_norm({n: torch.from_numpy(a)
                             for n, a in _flat(tree).items()})
    assert got.dtype == torch.float32
    _check_norm(float(got), want, tree)


# ------------------------------------------------------------- the update
def _tree_case(arch, seed, grad_scale):
    """A bf16 reference tree of ``arch``'s smoke config, its gradients
    (bf16 matrices, f32 vectors), non-zero moments at step 7, and the
    port's copies."""
    cfg = jconfigs.get_smoke_config(arch)
    params = jax.tree.map(np.asarray, jmodels.init_params(
        cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    flat = _flat(params)
    norms = {n: (rng.standard_normal(a.shape) * 0.5).astype(np.float32)
             for n, a in flat.items() if a.dtype == np.float32}
    flat.update(norms)                       # non-zero norm weights
    n_el = sum(a.size for a in flat.values())
    grads = {n: (rng.standard_normal(a.shape) * grad_scale
                 / np.sqrt(n_el)).astype(a.dtype) for n, a in flat.items()}
    mu = {n: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32)
          for n, a in flat.items()}
    nu = {n: (rng.uniform(0, 1e-4, a.shape)).astype(np.float32)
          for n, a in flat.items()}
    jopt = joptim.adamw.OptState(mu=_nest(mu), nu=_nest(nu),
                                 step=jnp.asarray(7, jnp.int32))
    pcfg = configs.get_smoke_config(arch)
    model = convert.params_from_jax(_nest(flat), pcfg, "cpu")
    opt = optim.OptState(
        mu={n: torch.from_numpy(a.copy()) for n, a in mu.items()},
        nu={n: torch.from_numpy(a.copy()) for n, a in nu.items()},
        step=torch.tensor(7, dtype=torch.int32))
    tg = {}
    for name, _ in model.named_parameters():
        leaf, layer = reference_leaf(name)
        a = grads[leaf] if layer is None else grads[leaf][layer]
        tg[name] = convert.tensor_from_numpy(a, "cpu")
    return (_nest(flat), _nest(grads), jopt), (model, tg, opt)


def _port_update(port, cfg):
    model, grads, opt = port
    _, opt, stats = optim.adamw_update(grads, opt, model, cfg)
    return convert.stacked_params(model), opt, stats


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_7b"])
def test_adamw_update_bit_for_bit_op_by_op(arch):
    cfg = dict(lr=1e-2, warmup_steps=5, total_steps=40)
    ref, port = _tree_case(arch, 3, grad_scale=0.5)
    with jax.disable_jit():
        jp, jo, js = joptim.adamw_update(ref[1], ref[2], ref[0],
                                         joptim.AdamWConfig(**cfg))
    assert float(js["grad_norm"]) < 1.0       # the clip scale is 1
    params, opt, stats = _port_update(port, optim.AdamWConfig(**cfg))
    assert int(opt.step) == int(jo.step) == 8
    assert _bits(stats["lr"]) == _bits(js["lr"])
    _check_norm(float(stats["grad_norm"]), float(js["grad_norm"]), ref[1])
    for name, want in _flat(jp).items():
        np.testing.assert_array_equal(_torch_bits(params[name]), _bits(want),
                                      err_msg=name)
    for field in ("mu", "nu"):
        for name, want in _flat(getattr(jo, field)).items():
            np.testing.assert_array_equal(
                _torch_bits(getattr(opt, field)[name]), _bits(want),
                err_msg=f"{field}/{name}")


@pytest.mark.parametrize("grad_scale", [0.5, 40.0], ids=["unclipped",
                                                          "clipped"])
def test_adamw_update_within_ulps_of_jit(grad_scale):
    cfg = dict(lr=1e-2, warmup_steps=5, total_steps=40)
    ref, port = _tree_case("rwkv6_3b", 4, grad_scale)
    jp, jo, js = jax.jit(joptim.adamw_update, static_argnums=3)(
        ref[1], ref[2], ref[0], joptim.AdamWConfig(**cfg))
    clipped = float(js["grad_norm"]) > 1.0
    assert clipped == (grad_scale > 1)
    params, opt, _ = _port_update(port, optim.AdamWConfig(**cfg))
    # each moment is b * old + (1 - b) * term: held to 2 f32 ulps of the
    # two summands' magnitudes (an FMA rounds once where the port rounds
    # three times, and where they cancel the result's own ulps are
    # smaller), plus the clip scale's relative gap when clipped
    grads = {n: np.asarray(a, np.float32) for n, a in _flat(ref[1]).items()}
    rel = 2.0 ** -22 + (4e-6 if clipped else 0.0)
    for field, b, term in (("mu", 0.9, lambda g: g),
                           ("nu", 0.95, np.square)):
        old = _flat(getattr(ref[2], field))
        for name, want in _flat(getattr(jo, field)).items():
            got = getattr(opt, field)[name].numpy()
            bound = rel * (b * np.abs(np.asarray(old[name]))
                           + (1 - b) * np.abs(term(grads[name])))
            assert (np.abs(got - np.asarray(want)) <= bound).all(), \
                (field, name)
    # parameters: within a bf16 ulp (f32: 2 f32 ulps) of |before| + |after|,
    # the scale of the f32 sum p - lr * delta (where the update cancels the
    # parameter, the result's own ulps are smaller)
    before = {n: np.asarray(a, np.float32) for n, a in _flat(ref[0]).items()}
    for name, want in _flat(jp).items():
        got, want = params[name].float().numpy(), np.asarray(want, np.float32)
        ulp = (2.0 ** -7 if params[name].dtype == torch.bfloat16
               else 2.0 ** -22 + (4e-6 if clipped else 0.0))
        scale = np.abs(before[name]) + np.abs(want)
        assert (np.abs(got - want) <= ulp * scale).all(), name


@pytest.mark.parametrize("arch", ["granite_8b", "rwkv6_3b", "zamba2_7b",
                                  "qwen2_moe_a2_7b"])
def test_decay_rule_pinned_against_the_reference(arch):
    """With zero gradients and moments, only decayed leaves move: the JAX
    package decays every leaf of rank >= 2 of its tree, per-layer vectors
    (stacked) included (``layers/ln1``, rwkv's ``mu_*``, ``w0``), and
    spares only top-level vectors (``final_norm``, the hybrid's
    ``shared_attn`` norms).  The port decides the same set by name."""
    cfg = jconfigs.get_smoke_config(arch)
    flat = _flat(jax.tree.map(np.asarray, jmodels.init_params(
        cfg, jax.random.PRNGKey(0))))
    flat = {n: np.ones_like(a) for n, a in flat.items()}
    zeros = {n: np.zeros(a.shape, np.float32) for n, a in flat.items()}
    acfg = joptim.AdamWConfig(lr=0.5, warmup_steps=1, total_steps=10)
    jp, _, _ = joptim.adamw_update(
        _nest({n: np.zeros_like(a) for n, a in flat.items()}),
        joptim.adamw.OptState(_nest(zeros), _nest(zeros),
                              jnp.asarray(0, jnp.int32)), _nest(flat), acfg)
    moved = {n for n, a in _flat(jp).items()
             if not np.array_equal(np.asarray(a, np.float32),
                                   np.asarray(flat[n], np.float32))}
    model = convert.params_from_jax(_nest(flat), configs.get_smoke_config(
        arch), "cpu")
    decayed = {reference_leaf(n)[0] for n, p in model.named_parameters()
               if optim.decayed(n, p)}
    spared = {reference_leaf(n)[0] for n, p in model.named_parameters()
              if not optim.decayed(n, p)}
    assert moved == decayed and not (decayed & spared)
    assert "final_norm" in spared
    stacked_vectors = {n for n in decayed if n.startswith("layers/")
                       and flat[n].ndim == 2}
    assert stacked_vectors, "no per-layer vector is decayed"
    if cfg.family == "hybrid":
        assert {"shared_attn/ln1", "shared_attn/ln2"} <= spared
    # and the port's own update moves exactly that set
    zg = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    before = convert.stacked_params(model)
    optim.adamw_update(zg, optim.adamw_init(model), model,
                       optim.AdamWConfig(**dataclasses.asdict(acfg)))
    after = convert.stacked_params(model)
    assert {n for n in before if not torch.equal(before[n], after[n])} \
        == decayed
