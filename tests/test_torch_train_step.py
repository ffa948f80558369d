"""The port's train step (``repro_torch.train.build_train_step``) against
``repro.train.build_train_step``, on the CPU, at smoke sizes: one step
single-shot and with ``microbatch=4`` from the same state and batch
(f32), the loss over 30 steps, and the bf16 loss and gradients against
the JAX package's own spread.

Tolerances, each with its reason:
- f32 (the same algorithm, summed in other orders): the loss and the
  global norm to 1e-5 relative, the learning rate bit for bit, the
  moments and each updated parameter leaf to 1e-4 relative L2 (at step 1
  each element moves by about lr x sign(g); a gradient element that f32
  noise flips moves by 2 lr: measured ``UPDATE`` below).
- bf16 (the serving and training default): the frameworks round bf16
  intermediates, and their gradients, in different places.  The JAX
  package's own jit and op-by-op runs differ by up to 0.011 (granite) and
  0.055 (rwkv) relative L2 in a gradient leaf; the port sits within 0.010
  and 0.101 of the op-by-op run (measured), so each leaf is held to 3x the
  reference's worst own spread, and the loss to 2^-8 relative (a bf16
  rounding of the logits; measured <= 2.6e-4).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import optim as joptim
from repro import train as jtrain
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMStream as JStream
from repro_torch import configs, convert, optim, train
from repro_torch.data import DataConfig, SyntheticLMStream

torch.set_num_threads(1)

B, S = 4, 16
LOSS_REL, UPDATE = 1e-5, 1e-4
SPREAD_FACTOR, BF16_LOSS_REL = 3.0, 2.0 ** -8
ADAMW = dict(lr=3e-3, warmup_steps=10, total_steps=50)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@functools.cache
def _jax_state(arch, dtype):
    cfg = jconfigs.get_smoke_config(arch)
    params = jax.tree.map(np.asarray, jmodels.init_params(
        cfg, jax.random.PRNGKey(0), dtype=dtype))
    if cfg.family == "rwkv":
        lb = params["layers"]["time"]["w_lora_b"]
        params["layers"]["time"]["w_lora_b"] = np.random.default_rng(
            11).standard_normal(lb.shape).astype(lb.dtype)
    return cfg, params


@pytest.mark.parametrize("microbatch", [1, 4])
@pytest.mark.parametrize("arch", ["granite_8b", "rwkv6_3b",
                                  "qwen2_moe_a2_7b"])
def test_train_step_matches_the_reference(arch, microbatch):
    jcfg, params = _jax_state(arch, jnp.float32)
    jopts = jtrain.TrainOptions(microbatch=microbatch, remat=True,
                                impl="auto",
                                adamw=joptim.AdamWConfig(**ADAMW))
    jstate = jtrain.TrainState(params, joptim.adamw_init(params))
    batch = JStream(jcfg, JDataConfig(B, S, seed=2)).batch_at(3)
    js, jm = jax.jit(jtrain.build_train_step(jcfg, jopts))(jstate, batch)

    cfg = configs.get_smoke_config(arch)
    state = convert.train_state_from_jax(jstate, cfg, "cpu")
    opts = train.TrainOptions(microbatch=microbatch, remat=True, impl="auto",
                              adamw=optim.AdamWConfig(**ADAMW))
    pb = SyntheticLMStream(cfg, DataConfig(B, S, seed=2),
                           device="cpu").batch_at(3)
    out, m = train.build_train_step(cfg, opts)(state, pb)
    assert out is state and int(state.opt.step) == int(js.opt.step) == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        LOSS_REL * float(jm["loss"])
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        LOSS_REL * float(jm["grad_norm"])
    assert np.asarray(m["lr"]).view(np.uint32) == \
        np.asarray(jm["lr"]).view(np.uint32)
    got, before = convert.stacked_params(state.params), _flat(params)
    for name, want in _flat(js.params).items():
        assert _rel(got[name], want) <= UPDATE, name
        # the step moved every leaf
        assert not np.array_equal(got[name].numpy(), before[name]), name
    for field in ("mu", "nu"):
        for name, want in _flat(getattr(js.opt, field)).items():
            assert _rel(getattr(state.opt, field)[name], want) <= UPDATE, \
                (field, name)


def test_microbatch_accumulates_in_f32_like_the_single_shot():
    """The port's own microbatch=4 step against its single-shot step
    (``tests/test_runtime.py::test_microbatch_equivalence``'s check, in
    f32: 1e-5 on the loss, 1e-4 relative L2 on each parameter leaf)."""
    cfg = configs.get_smoke_config("granite_8b").replace(n_layers=1,
                                                         vocab=128)
    batch = SyntheticLMStream(cfg, DataConfig(8, 16),
                              device="cpu").batch_at(0)
    results = []
    for k in (1, 4):
        state = train.init_train_state(cfg, torch.Generator().manual_seed(1),
                                       "cpu")
        state.params.float()
        state = train.TrainState(state.params, optim.adamw_init(state.params))
        opts = train.TrainOptions(remat=False, microbatch=k,
                                  adamw=optim.AdamWConfig(lr=1e-3))
        _, m = train.build_train_step(cfg, opts)(state, batch)
        results.append((float(m["loss"]),
                        convert.stacked_params(state.params)))
    (l1, p1), (lk, pk) = results
    assert abs(l1 - lk) <= LOSS_REL * l1
    for name in p1:
        assert _rel(pk[name], p1[name]) <= UPDATE, name


def test_training_loss_decreases():
    """``tests/test_runtime.py::test_training_loss_decreases`` on the port:
    h2o-danube-smoke at 2 layers and vocab 128, bf16, 30 steps."""
    cfg = configs.get_smoke_config("h2o_danube_1_8b").replace(n_layers=2,
                                                              vocab=128)
    stream = SyntheticLMStream(cfg, DataConfig(4, 32), device="cpu")
    opts = train.TrainOptions(remat=False, adamw=optim.AdamWConfig(
        lr=1e-2, warmup_steps=5, total_steps=200))
    step = train.build_train_step(cfg, opts)
    state = train.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    losses = [float(step(state, stream.batch_at(s))[1]["loss"])
              for s in range(30)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8, losses


@pytest.mark.parametrize("arch", ["granite_8b", "rwkv6_3b"])
def test_bf16_loss_and_grads_within_the_reference_spread(arch):
    jcfg, params = _jax_state(arch, jnp.bfloat16)
    batch = JStream(jcfg, JDataConfig(2, 24)).batch_at(0)
    f = jax.value_and_grad(jmodels.lm_loss)
    lj, gj = jax.jit(f, static_argnums=(1,), static_argnames=(
        "impl", "remat"))(params, jcfg, batch, impl="auto", remat=True)
    with jax.disable_jit():
        lo, go = f(params, jcfg, batch, impl="auto", remat=True)
    gj, go = _flat(gj), _flat(go)
    spread = max(_rel(go[n], gj[n]) for n in gj)

    cfg = configs.get_smoke_config(arch)
    model = convert.params_from_jax(params, cfg, "cpu")
    pb = SyntheticLMStream(cfg, DataConfig(2, 24), device="cpu").batch_at(0)
    loss, grads = train.loss_and_grads(model, cfg, pb, "auto", True)
    got = convert.stack_leaves(grads.items())
    assert abs(loss.item() - float(lo)) <= BF16_LOSS_REL * float(lo)
    for name in gj:
        assert got[name].dtype == torch.bfloat16 or \
            np.asarray(gj[name]).dtype == np.float32
        assert _rel(got[name].float(), go[name]) <= SPREAD_FACTOR * spread, \
            (name, spread)


def test_options_and_state_mirror_the_reference():
    assert train.TrainOptions.__dataclass_fields__.keys() == \
        jtrain.TrainOptions.__dataclass_fields__.keys()
    assert train.TrainOptions().microbatch == 1
    assert train.TrainOptions().remat is True
    assert train.TrainOptions().impl == jtrain.TrainOptions().impl
    assert train.TrainState._fields == jtrain.TrainState._fields
