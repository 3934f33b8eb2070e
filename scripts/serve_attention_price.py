"""Price the served path's cached attention for a decode-attention kernel.

recurrentgemma-9b's local layers served as ``chip_smoke.py``'s
``serve_path`` serves them (4 requests, a 1024-token prompt, 64 tokens:
a ring of 1088 slots, 16 query heads over 1 kv head of 256, window
2048) attend through ``attention_reference``, plain PyTorch as JAX's
ring is plain jnp.  This times that call, on random f32 inputs at the
path's shapes, at the prefill (1024 queries from position 0) and at the
first decode step (1 query at position 1024), beside its bound (the
larger of the bytes it must move at the HBM rate and of 4·D flops a
visible pair at the TF32 rate), and, at the prefill, the f32 flash
kernel computing the same function (every prompt position lies inside
the window).  Then it prices the plain call over ``serve_path``'s 12
local layers: the decode's time above the bound in 63 steps, the
prefill's above the flash kernel.

    python3 scripts/serve_attention_price.py [--out chiprun_out/serve_attention_price.json]

Needs one CUDA card; prints the card's name and power limit and one JSON
object.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import (HBM_BYTES_PER_S, SERVE_ARCH, SERVE_GEN,
                            SERVE_PROMPT, SERVE_REQUESTS, TF32_FLOPS_PER_S,
                            card_line, time_ms, visible_pairs)
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        attention_reference,
        flash_fwd_cuda,
    )
    from repro_torch.models.attention import ring_positions

    if not torch.cuda.is_available():
        sys.exit("serve_attention_price: no CUDA card")
    card = card_line()
    cfg = get_config(SERVE_ARCH)
    b, p_len, hd = SERVE_REQUESTS, SERVE_PROMPT, cfg.resolved_head_dim
    window = cfg.sliding_window
    size = min(p_len + SERVE_GEN, window + p_len - 1)   # make_kv_cache's ring
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    ring = [torch.randn((b, size, cfg.n_kv_heads, hd), device="cuda",
                        generator=gen) for _ in "kv"]
    timed = {}
    for what, s_q, pos in (("prefill", p_len, 0), ("decode", 1, p_len)):
        q = torch.randn((b, s_q, cfg.n_heads, hd), device="cuda",
                        generator=gen)
        slot_pos, oldest = ring_positions(pos, s_q, size, "cuda")
        ms = time_ms(torch, lambda: attention_reference(
            q, *ring, window=window, q_offset=pos, k_pos=slot_pos,
            oldest=oldest), args.iters)
        pairs = (visible_pairs(pos + s_q, True, window)
                 - visible_pairs(pos, True, window))
        flops = 4.0 * hd * pairs * cfg.n_heads * b
        nbytes = 4.0 * (2 * q.numel() + sum(x.numel() for x in ring))
        timed[what] = dict(
            queries=s_q, ms=ms,
            bound_ms=max(flops / TF32_FLOPS_PER_S,
                         nbytes / HBM_BYTES_PER_S) * 1e3)
        if what == "prefill":
            k, v = (x[:, :p_len] for x in ring)
            timed[what]["flash_ms"] = time_ms(torch, lambda: flash_fwd_cuda(
                q, k, v, causal=True, window=window), args.iters)
    n_local = [sp.kind for sp in cfg.layer_specs()].count("local_attn")
    steps = SERVE_GEN - 1
    out = dict(
        card=card, arch=SERVE_ARCH, ring_slots=size, local_layers=n_local,
        ring_attention=timed,
        decode_above_bound_ms=n_local * steps * (timed["decode"]["ms"]
                                                 - timed["decode"]["bound_ms"]),
        prefill_above_flash_ms=n_local * (timed["prefill"]["ms"]
                                          - timed["prefill"]["flash_ms"]))
    print(card)
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
