"""The port's serving loop against the JAX package's, on the CPU.

``repro_torch.launch.serve.generate`` (prefill, then greedy decode) runs
from the same parameters and prompts as the JAX ``prefill_step`` /
decode loop of ``repro.launch.serve``.  Greedy decoding feeds each token
back, so the two sequences are compared under the margin rule of
``tests/test_torch_models.py``: token by token while the reference's top-2
logit margin exceeds the bf16 logit tolerance; after the first step whose
margin is inside it, the two may legitimately part."""
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
from repro_torch.kernels import flash_attention
from repro_torch.launch import serve

torch.set_num_threads(1)

LOGIT_TOL = 0.08     # the bf16 logit tolerance of tests/test_torch_models.py


@pytest.mark.parametrize("arch", ["granite_8b"])
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
    n0 = flash_attention.launches
    out = serve.generate(tp, cfg, tc, gen=gen, **targs)
    got = out.tokens
    assert got.shape == (B, gen) and got.dtype == torch.int32
    assert flash_attention.launches == n0        # the CPU never launches
    assert out.prefill_s > 0 and out.decode_s > 0
    got = got.numpy()
    compared = 0
    for b in range(B):
        for i in range(gen):
            if margins[b, i] <= LOGIT_TOL:
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
