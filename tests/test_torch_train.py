"""The port's training loss and gradients (``repro_torch.models.lm_loss``,
``remat``, ``kernels.autograd``) against ``repro.models.lm_loss``, on the
CPU, at every config's smoke size (and zamba2's ``ssm`` variant) in f32,
from parameters carried across by ``params_from_jax`` and the batch of
both packages' data stream.

rwkv's decay LoRA-B is drawn non-zero (the JAX init's zero makes every
decay the constant -e^0.5), so the gradient reaches the LoRA and the
decay depends on the data.

Tolerances, each with its reason: f32 on both sides, the same algorithm
summed in other orders: the loss to 1e-5 relative (measured <= 2.3e-7)
and each gradient leaf to 1e-4 relative L2 (measured <= 6.5e-5, zamba2's
``D`` through its random Mamba2 stack; <= 6.2e-6 elsewhere).  ``remat``
on and off are bit-identical (the same operations recomputed).  The scan's
autograd Function is held bit for bit against the plain version's own
autograd (its backward rebuilds exactly that graph).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMStream as JStream
from repro_torch import configs, convert, train
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.kernels import autograd, ops
from repro_torch.kernels.ref import ssm_scan_ref
from repro_torch.models import lm_loss

torch.set_num_threads(1)

B, S = 2, 24
ZOO = [(a, None) for a in configs.ARCHS] + [("zamba2_7b", "ssm")]
IDS = [a if f is None else f"{a}-{f}" for a, f in ZOO]
LOSS_REL, GRAD_REL = 1e-5, 1e-4
LORA_B_STD = 1.0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _cfgs(arch, family):
    jc, pc = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    if family:
        jc, pc = jc.replace(family=family), pc.replace(family=family)
    return jc, pc


@functools.cache
def _case(arch, family):
    """(JAX config, port config, f32 JAX params as numpy, JAX batch, port
    batch): the stream's step-0 batch, a frontend's bf16 embeddings in
    f32 on both sides."""
    jc, pc = _cfgs(arch, family)
    params = jax.tree.map(np.asarray, jmodels.init_params(
        jc, jax.random.PRNGKey(0), dtype=jnp.float32))
    if jc.family == "rwkv":
        lb = params["layers"]["time"]["w_lora_b"]
        params["layers"]["time"]["w_lora_b"] = (
            np.random.default_rng(11).standard_normal(lb.shape)
            * LORA_B_STD).astype(np.float32)
    jb = JStream(jc, JDataConfig(B, S)).batch_at(0)
    pb = SyntheticLMStream(pc, DataConfig(B, S), device="cpu").batch_at(0)
    if "embeds" in jb:
        jb["embeds"] = jb["embeds"].astype(jnp.float32)
        pb["embeds"] = pb["embeds"].float()
    return jc, pc, params, jb, pb


@functools.cache
def _reference(arch, family):
    """The JAX package's loss and gradients (jit, remat, impl="auto")."""
    jc, _, params, jb, _ = _case(arch, family)
    f = jax.jit(jax.value_and_grad(jmodels.lm_loss), static_argnums=(1,),
                static_argnames=("impl", "remat"))
    loss, grads = f(params, jc, jb, impl="auto", remat=True)
    return float(loss), {n: np.asarray(g) for n, g in _flat(grads).items()}


def _port(arch, family, remat=True, impl="auto"):
    _, pc, params, _, pb = _case(arch, family)
    model = convert.params_from_jax(params, pc, "cpu")
    loss, grads = train.loss_and_grads(model, pc, pb, impl, remat)
    return loss, convert.stack_leaves(grads.items())


@pytest.mark.parametrize("arch,family", ZOO, ids=IDS)
def test_lm_loss_and_grads_f32_match(arch, family):
    want_loss, want = _reference(arch, family)
    loss, grads = _port(arch, family)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        g = grads[name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        ref_norm = np.linalg.norm(w)
        assert ref_norm > 0 or name == "embed", name   # embed: frontends
        assert np.linalg.norm(g - w) <= GRAD_REL * ref_norm, name


@pytest.mark.parametrize("arch,family", ZOO, ids=IDS)
def test_remat_is_bit_identical(arch, family):
    l1, g1 = _port(arch, family, remat=True)
    l0, g0 = _port(arch, family, remat=False)
    assert torch.equal(l1, l0)
    for name in g0:
        assert torch.equal(g1[name], g0[name]), name


def test_flash_refused_in_both_packages():
    """The flash kernels have no backward: the port's ``lm_loss`` raises
    before any work, on any device, and the JAX package's ``jax.grad``
    through its Pallas kernel fails too."""
    arch = "granite_8b"                  # no sliding window: flash applies
    jc, pc, params, jb, pb = _case(arch, None)
    model = convert.params_from_jax(params, pc, "cpu")
    with pytest.raises(ValueError, match="no backward"):
        lm_loss(model, pc, pb, impl="flash")
    with pytest.raises(AssertionError):
        jax.value_and_grad(jmodels.lm_loss)(params, jc, jb, impl="flash")


# ------------------------------------------------ the scan's autograd
def _scan_inputs(dtype, T=37, bonus=True, s0=True, seed=0):
    rng = np.random.default_rng(seed)
    Bq, H, D = 2, 2, 16
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    q, k, v = (f(Bq, T, H, D).to(dtype) for _ in range(3))
    log_a = torch.from_numpy(rng.uniform(-2.3, -1e-4, (Bq, T, H, D)).astype(
        np.float32))
    u = f(H, D) * 0.1 if bonus else None
    st = f(Bq, H, D, D) * 0.3 if s0 else None
    return [q, k, v, log_a, u, st]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("return_state,state_grad", [
    (False, False), (True, False), (True, True)])
@pytest.mark.parametrize("bonus,s0", [(True, True), (False, False)])
def test_scan_function_backward_equals_plain_autograd(dtype, return_state,
                                                      state_grad, bonus, s0):
    """``autograd.ssm_scan`` with the plain version standing in for the
    kernel as its forward: outputs and every input gradient bit for bit
    against the plain version's own autograd (a ``None`` gradient of the
    unused state skipped)."""
    base = _scan_inputs(dtype, bonus=bonus, s0=s0)

    def run(fn):
        rng = np.random.default_rng(9)
        ins = [None if t is None else t.clone().requires_grad_(True)
               for t in base]
        out = fn(*ins[:4], u=ins[4], chunk=16, s0=ins[5],
                 return_state=return_state)
        y, st = out if return_state else (out, None)
        gy = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
            np.float32)).to(y.dtype)
        outs, gouts = [y], [gy]
        if state_grad:
            outs.append(st)
            gouts.append(torch.from_numpy(rng.standard_normal(
                tuple(st.shape)).astype(np.float32)))
        torch.autograd.backward(outs, gouts)
        return out, [None if t is None else t.grad for t in ins]

    def through_function(*a, **kw):
        return autograd.ssm_scan(ssm_scan_ref, *a, **kw)

    want_out, want = run(ssm_scan_ref)
    got_out, got = run(through_function)
    pairs = zip(got_out, want_out) if return_state else [(got_out, want_out)]
    for g, w in pairs:
        assert g.grad_fn is not None and torch.equal(g, w)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_ops_on_the_cpu_keep_the_plain_autograd():
    """On the CPU ``ops.ssm_scan`` and ``ops.flash_attention`` run their
    plain versions, gradients included (only a CUDA tensor reaches the
    Function or the refusal)."""
    q, k, v, log_a, u, s0 = _scan_inputs(torch.float32)
    q.requires_grad_(True)
    y = ops.ssm_scan(q, k, v, log_a, u=u, chunk=16, s0=s0)
    y.sum().backward()
    assert q.grad is not None and q.grad.abs().sum() > 0
    x = torch.randn(1, 8, 2, 16, requires_grad=True)
    ops.flash_attention(x, x, x).sum().backward()
    assert x.grad is not None
