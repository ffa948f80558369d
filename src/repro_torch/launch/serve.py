"""Batched serving: prefill a batch of prompts, then greedy-decode.
The port of ``repro.launch.serve``, with the same flags and defaults plus
``--device`` (default: the CUDA device).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..models import init_params, make_cache
from ..train import build_prefill_step, build_serve_step


class Generation(NamedTuple):
    tokens: torch.Tensor      # (B, gen) int32
    prefill_s: float          # host seconds, the device synchronised
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg, cache: dict, tokens=None, embeds=None,
             gen: int = 16, impl: str = "auto") -> Generation:
    """Prefill ``tokens`` (B, Lp) or ``embeds`` (B, Lp, D) into ``cache``,
    then greedy-decode ``gen`` tokens, the first from the prefill's logits
    and one per decode step after it.  The device is synchronised at the
    end of each phase, which is timed."""
    prefill_step = build_prefill_step(cfg, impl=impl)
    serve_step = build_serve_step(cfg, impl=impl)
    x = tokens if embeds is None else embeds
    B, Lp = x.shape[:2]
    dev = x.device
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, cache, tokens=tokens, embeds=embeds)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(dev)
    t1 = time.perf_counter()
    out = [tok]
    for i in range(gen - 1):
        pos = torch.full((B,), Lp + i, dtype=torch.int32, device=dev)
        cache, tok = serve_step(params, cache, tok, pos)
        out.append(tok)
    _sync(dev)
    return Generation(torch.stack(out, dim=1), t1 - t0,
                      time.perf_counter() - t1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} family={cfg.family} device={device}")
    params = init_params(cfg, torch.Generator(device).manual_seed(args.seed),
                         device=device)

    B, Lp = args.batch, args.prompt_len
    g = torch.Generator(device).manual_seed(args.seed + 1)
    cache = make_cache(cfg, B, max_len=Lp + args.gen, device=device)
    if cfg.frontend:
        emb = (torch.randn((B, Lp, cfg.d_model), generator=g, device=device)
               * 0.1).to(torch.bfloat16)
        out = generate(params, cfg, cache, embeds=emb, gen=args.gen)
    else:
        prompts = torch.randint(0, cfg.vocab, (B, Lp), generator=g,
                                device=device)
        out = generate(params, cfg, cache, tokens=prompts, gen=args.gen)
    t_decode = out.decode_s
    print(f"prefill: {out.prefill_s*1e3:.0f}ms for {B}x{Lp} tokens")
    print(f"decode: {t_decode*1e3:.0f}ms for {args.gen-1} steps "
          f"({(args.gen-1)*B/max(t_decode,1e-9):.0f} tok/s)")
    print("generated token ids (first sequence):", out.tokens[0].tolist())


if __name__ == "__main__":
    main()
