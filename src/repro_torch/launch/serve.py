"""Serving launcher of the port: batched prefill + autoregressive decode.

Port of ``repro/launch/serve.py``.  ``serve`` fills a decode cache with
the prompts (``prefill_serve_step``), then generates one token a request
and step (``decode_serve_step``): greedy (``argmax``) at temperature 0,
else sampled from ``softmax(logits / temperature)`` with an explicit
``torch.Generator`` (its tokens are not JAX's ``jax.random`` draws).  The
cache is f32 and its ring sized for the whole prompt as one prefill
chunk, as JAX's launcher makes it.  Runs on the card unless ``--device
cpu``; there every RG-LRU scan, RWKV-6 WKV and flash-attention call of the
served path runs its CUDA kernel.  Prints the JAX launcher's three lines.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --smoke --requests 8 --prompt-len 48 --gen 24 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs import ARCH_NAMES, get_config, reduce_for_smoke
from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import init_params
from repro_torch.serve.steps import (
    decode_serve_step,
    make_serve_cache,
    prefill_serve_step,
)


@dataclasses.dataclass
class Served:
    """What ``serve`` returns: the generated tokens [B, gen], the logits
    each was chosen from [B, gen, V] (the prefill's last position, then
    each decode step's), and the host seconds of the prefill and of the
    ``gen - 1`` decode steps, each ending in a device synchronise."""
    tokens: torch.Tensor
    logits: torch.Tensor
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _next_token(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def serve(cfg: ArchConfig, params, prompts: torch.Tensor, gen: int, *,
          memory: Optional[torch.Tensor] = None, temperature: float = 0.0,
          generator: Optional[torch.Generator] = None) -> Served:
    """Serve the prompts [B, P] (on the params' device) for ``gen`` new
    tokens a request: one prefill, then ``gen - 1`` decode steps at
    positions P, P + 1, ...  ``memory`` [B, M, d] is a non-text config's
    stub-frontend memory (encoded first in an encoder-decoder)."""
    b, prompt_len = prompts.shape
    device = prompts.device
    cache = make_serve_cache(cfg, b, prompt_len + gen, device=device,
                             dtype=torch.float32, prefill_chunk=prompt_len)
    t0 = time.perf_counter()
    logits = prefill_serve_step(params, prompts, cache, cfg=cfg,
                                memory=memory)
    token = _next_token(logits, temperature, generator)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    out_tokens, out_logits = [token], [logits]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits = decode_serve_step(params, token, cache, prompt_len + i,
                                   cfg=cfg)
        token = _next_token(logits, temperature, generator)
        out_tokens.append(token)
        out_logits.append(logits)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return Served(tokens=torch.stack(out_tokens, dim=1),
                  logits=torch.stack(out_logits, dim=1),
                  prefill_s=prefill_s, decode_s=decode_s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    device = torch.device(args.device)
    b = args.requests
    params = init_params(cfg, seed=args.seed, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (b, args.prompt_len),
                            generator=gen, device=device)
    memory = None
    if cfg.modality != "text":
        memory = torch.randn((b, max(cfg.n_modal_tokens, 1), cfg.d_model),
                             generator=gen, device=device)
    out = serve(cfg, params, prompts, args.gen, memory=memory,
                temperature=args.temperature, generator=gen)
    print(f"arch={cfg.name} requests={b} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"prefill {out.prefill_s*1e3:.1f}ms; decode "
          f"{out.decode_s / max(args.gen - 1, 1) * 1e3:.1f}ms/token "
          f"({b * (args.gen - 1) / max(out.decode_s, 1e-9):.0f} tok/s)")
    print("first request tokens:", out.tokens[0].tolist())


if __name__ == "__main__":
    main()
