"""The port's serving loop against the JAX package's, on the CPU.

``repro_torch.launch.serve.generate`` (prefill, then greedy decode) runs
from the same parameters and prompts as the JAX ``prefill_step`` /
decode loop of ``repro.launch.serve``.  Greedy decoding feeds each token
back, so the two sequences are compared under the margin rule of
``tests/test_torch_models.py``: token by token while the reference's top-2
logit margin exceeds the bf16 logit tolerance; after the first step whose
margin is inside it, the two may legitimately part.

The tolerance is the bf16 logit tolerance of each family's model tests:
0.08 for the dense models (``tests/test_torch_models.py``), 0.15 for
rwkv6 (``tests/test_torch_rwkv.py``, where
``test_reference_own_bf16_spread_is_inside_the_tolerance`` shows the
reference's own jit and op-by-op runs differing by more than 0.08).  On
this loop too, the two reference runs pick different greedy tokens at a
top-2 margin above 0.08."""
import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import train as jtrain
from repro_torch import convert
from repro_torch.kernels import flash_attention, ssm_scan
from repro_torch.launch import serve

torch.set_num_threads(1)

LOGIT_TOL = {"granite_8b": 0.08, "rwkv6_3b": 0.15}


@pytest.mark.parametrize("arch", ["granite_8b", "rwkv6_3b"])
def test_generate_matches_the_reference_loop(arch):
    cfg = jconfigs.get_smoke_config(arch)
    jp = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    B, Lp, gen = 4, 32, 12
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab, (B, Lp)).astype(np.int32)
    emb = (rng.standard_normal((B, Lp, cfg.d_model)) * 0.1).astype(np.float32)
    jargs = ({"embeds": jnp.asarray(emb).astype(jnp.bfloat16)}
             if cfg.frontend else {"tokens": jnp.asarray(prompts)})
    targs = ({"embeds": torch.from_numpy(emb).to(torch.bfloat16)}
             if cfg.frontend else {"tokens": torch.from_numpy(prompts)})

    jc = jmodels.make_cache(cfg, B, max_len=Lp + gen)
    logits, jc = jax.jit(jtrain.build_prefill_step(cfg, impl="auto"))(
        jp, jc, **jargs)
    dec = jax.jit(lambda p, c, t, pos: jmodels.decode_step(
        p, cfg, c, t, pos, impl="auto"))
    want, margins = [], []
    for i in range(gen):
        lg = np.asarray(logits, np.float32)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        want.append(lg.argmax(-1))
        if i < gen - 1:
            pos = jnp.full((B,), Lp + i, jnp.int32)
            logits, jc = dec(jp, jc, jnp.asarray(want[-1], jnp.int32), pos)
    want, margins = np.stack(want, 1), np.stack(margins, 1)

    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tc = convert.cache_from_jax(
        jax.tree.map(np.asarray, jmodels.make_cache(cfg, B, Lp + gen)), "cpu")
    n0 = flash_attention.launches + ssm_scan.launches
    out = serve.generate(tp, cfg, tc, gen=gen, **targs)
    got = out.tokens
    assert got.shape == (B, gen) and got.dtype == torch.int32
    # the CPU never launches
    assert flash_attention.launches + ssm_scan.launches == n0
    assert out.prefill_s > 0 and out.decode_s > 0
    got = got.numpy()
    compared = 0
    for b in range(B):
        for i in range(gen):
            if margins[b, i] <= LOGIT_TOL[arch]:
                break
            assert got[b, i] == want[b, i], (b, i, got[b], want[b])
            compared += 1
    # random smoke weights give small top-2 margins: 16 of the 48 tokens
    # fall before a row's first close call
    assert compared >= 8, compared


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=granite-smoke family=dense device=cpu" in out
    ids = out.split("generated token ids (first sequence):")[1]
    assert len(ast.literal_eval(ids.strip())) == 4


def test_serve_main_runs_rwkv_on_the_cpu(capsys):
    """The JAX CLI's own example (``repro.launch.serve``'s docstring)."""
    serve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=rwkv6-smoke family=rwkv device=cpu" in out
    ids = out.split("generated token ids (first sequence):")[1]
    assert len(ast.literal_eval(ids.strip())) == 4
