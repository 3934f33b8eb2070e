#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py      # one CUDA card

1. Builds every CUDA kernel from this checkout's sources (one ``nvcc`` per
   source, all started together) and prints the compiler's register and
   spill counts.
2. Holds each kernel against its plain PyTorch version on the card:
   flash attention at head dims 128 and 256 with GQA, causal, window,
   softcap and a ragged length (out, lse and autograd gradients within
   1e-4), then at the main path's shapes; the bucket update bitwise for
   AdamW and SGD, uniform and per-element, masked tail, fused zeroing.
   Times each kernel, its plain version and a PyTorch library call that
   computes the same function and that the port never calls (compiled
   ``flex_attention`` with the softcap as ``score_mod`` and the causal /
   window mask as a block mask; ``torch._fused_adamw_``), beside the least
   time the card could take.
3. Drives the DeFT main path through ``repro_torch.launch.train.train``:
   gemma2-2b at full width with its depth cut to 8 of 26 layers, batch 1,
   sequence 8192 (the 4096 window really masks), coverage rate 1.8.  The
   first schedule period runs once with the plain versions forced; the
   main run (launch counters zeroed just before it) must agree with it
   (every bucket's params within 1e-4, at most 1000 elements beyond
   1e-5), launch both kernels, issue exactly ``phase_collectives`` per phase,
   and keep the loss finite.
4. Prints the kernels line, the card's name and power limit, and last the
   contract line ``{"ok": true, "device": {...}}``.  Any failure, or no
   card, exits non-zero before that line.  The full report goes to
   ``chiprun_out/chip_smoke.json``.

Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
FLASH_TOL = 1e-4              # f32, another summation order than cuBLAS
PARAM_TOL = 1e-5              # per-element agreement after an update
PARAM_MAX_DIFF = 1e-4         # no param may differ more than this ...
PARAM_MAX_OVER = 1000         # ... and at most this many beyond PARAM_TOL
ARCH, N_LAYERS, SEQ, BATCH = "gemma2-2b", 8, 8192, 1
COVERAGE_RATE, PARTITION_ELEMS, LOSS_CHUNK, LR = 1.8, 200_000, 1024, 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def flex_call(torch, q, k, v, window: int, cap: float):
    """One compiled ``flex_attention`` call computing the same function as
    the flash kernel: GQA, causal (and window) block mask, softcap
    ``cap * tanh(s / cap)`` as ``score_mod``, scale 1/sqrt(D)."""
    from torch.nn.attention.flex_attention import (
        create_block_mask,
        flex_attention,
    )

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki
        return keep & (ki > qi - window) if window else keep

    s = q.shape[1]
    mask = create_block_mask(mask_mod, None, None, s, s, device=q.device)
    fn = torch.compile(flex_attention)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: fn(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                      enable_gqa=True).transpose(1, 2)


def visible_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs a length-``s`` self-attention computes."""
    if not causal:
        return s * s
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def flash_phase(torch, report):
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_fwd_cuda,
        flash_fwd_plain,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def qkv(b, s, h, kvh, d):
        mk = lambda n: torch.randn((b, s, n, d), device="cuda", generator=gen)
        return mk(h), mk(kvh), mk(kvh)

    max_err = 0.0
    # (B, S, H, KV, D, causal, window, softcap)
    cases = [
        (2, 333, 8, 4, 256, True, 100, 50.0),   # ragged S, window, softcap
        (1, 520, 8, 4, 256, True, 0, 50.0),     # gemma2 global layer
        (2, 200, 8, 2, 128, True, 0, 0.0),      # qwen3 head dim, GQA 4:1
        (2, 130, 4, 4, 128, False, 0, 0.0),     # bidirectional, ragged
    ]
    for b, s, h, kvh, d, causal, window, cap in cases:
        kw = dict(causal=causal, window=window, softcap=cap)
        q, k, v = qkv(b, s, h, kvh, d)
        out, lse = flash_fwd_cuda(q, k, v, **kw)
        ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and lse.shape == ref_lse.shape,
              f"flash shapes {tuple(out.shape)} {tuple(lse.shape)}")
        err = max((out - ref).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        check(torch.allclose(out, ref, rtol=FLASH_TOL, atol=FLASH_TOL)
              and torch.allclose(lse, ref_lse, rtol=FLASH_TOL, atol=FLASH_TOL),
              f"flash kernel disagrees with plain at {b, s, h, kvh, d, kw}: "
              f"max err {err:.3g}")
        w = torch.randn(q.shape, device="cuda", generator=gen)
        grads = []
        for impl in ("cuda", "plain"):
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
            torch.sum(flash_attention(*xs, impl=impl, **kw) * w).backward()
            grads.append([x.grad for x in xs])
        for a, g in zip(*grads):
            err = max(err, (a - g).abs().max().item())
            check(torch.allclose(a, g, rtol=FLASH_TOL, atol=FLASH_TOL),
                  f"flash gradients disagree at {b, s, h, kvh, d, kw}")
        max_err = max(max_err, err)
        print(f"flash D={d} S={s} H={h}/{kvh} {kw}: ok (max err {err:.3g})")

    # the main path's shapes: gemma2-2b, B=1, S=8192, 8 heads over 4, D=256
    b, s, h, kvh, d = BATCH, SEQ, 8, 4, 256
    q, k, v = qkv(b, s, h, kvh, d)
    shapes = {}
    for layer, window in (("global", 0), ("local", 4096)):
        kw = dict(causal=True, window=window, softcap=50.0)
        out, lse = flash_fwd_cuda(q, k, v, **kw)
        ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max((out - ref).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        check(torch.allclose(out, ref, rtol=FLASH_TOL, atol=FLASH_TOL)
              and torch.allclose(lse, ref_lse, rtol=FLASH_TOL, atol=FLASH_TOL),
              f"flash kernel disagrees with plain at the {layer} main-path "
              f"shape: max err {err:.3g}")
        max_err = max(max_err, err)
        del out, lse, ref, ref_lse
        ms = time_ms(torch, lambda: flash_fwd_cuda(q, k, v, **kw), 5)
        plain_ms = time_ms(torch, lambda: flash_fwd_plain(q, k, v, **kw), 3)
        lib = flex_call(torch, q, k, v, window, 50.0)
        lib_err = (lib() - flash_fwd_cuda(q, k, v, **kw)[0]).abs().max().item()
        library_ms = time_ms(torch, lib, 3)
        del lib
        flops = 4.0 * d * visible_pairs(s, True, window) * h * b
        nbytes = 4.0 * (2 * q.numel() + k.numel() + v.numel() + b * h * s)
        bound_ops = flops / F32_FLOPS_PER_S * 1e3
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        shapes[layer] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(bound_ops, bound_bytes),
            bound_by="operations" if bound_ops >= bound_bytes else "bytes",
            flops=flops, bytes=nbytes, max_abs_err=err,
            library_max_abs_err=lib_err)
        print(f"flash main-path {layer} (B={b} S={s} H={h}/{kvh} D={d} "
              f"window={window}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"flex_attention {library_ms:.3f} ms (max diff to the kernel "
              f"{lib_err:.3g}), bound {shapes[layer]['bound_ms']:.3f} "
              f"ms ({shapes[layer]['bound_by']}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    report["flash"] = dict(cases=len(cases), max_abs_err=max_err, **shapes)
    torch.cuda.empty_cache()
    g = shapes["global"]
    return {
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "launches": None, "max_abs_err": max_err,
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "shape": "B=1 S=8192 H=8 KV=4 D=256 causal softcap=50 (global layer)",
        "local_ms": shapes["local"]["ms"],
        "local_plain_ms": shapes["local"]["plain_ms"],
        "local_bound_ms": shapes["local"]["bound_ms"],
        "library_note": "compiled flex_attention, softcap score_mod",
    }


# ---------------------------------------------------------------------------
# bucket update
# ---------------------------------------------------------------------------
def bucket_phase(torch, layout, report):
    from repro_torch.kernels.bucket_update import (
        bucket_update_cuda,
        bucket_update_ref,
        pack_scalars,
    )
    from repro_torch.optim.optimizers import adamw, sgd_momentum

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rnd = lambda n: torch.randn(n, device="cuda", generator=gen)
    step = torch.tensor(3, dtype=torch.int32, device="cuda")
    n_cases = 0
    for spec in (adamw(1e-2, weight_decay=0.01),
                 sgd_momentum(3e-2, momentum=0.85, weight_decay=0.02)):
        adam = spec.name == "adamw"
        for elem in (False, True):
            for zero in (False, True):
                padded, n_valid = 4096 + 640, 4096 + 533
                p, m, v, g = rnd(padded), rnd(padded), rnd(padded).abs(), rnd(padded)
                sc = torch.rand(padded, device="cuda", generator=gen) + 0.5
                wd = torch.rand(padded, device="cuda", generator=gen) * 0.1
                scal = pack_scalars(spec, step, grad_scale=0.5,
                                    clip=torch.tensor(0.9, device="cuda"))
                kw = dict(n_valid=n_valid,
                          uniform=None if elem else (1.0, spec.weight_decay),
                          elem_hparams=(sc, wd) if elem else None)
                g0 = g.clone()
                want = bucket_update_ref(spec, p, m, v if adam else None, g,
                                         scal, **kw)
                bucket_update_cuda(spec, p, m, v if adam else None, g, scal,
                                   zero_grads=zero, **kw)
                torch.cuda.synchronize()
                ok = (torch.equal(p, want[0]) and torch.equal(m, want[1])
                      and (not adam or torch.equal(v, want[2]))
                      and (torch.equal(g, torch.zeros_like(g)) if zero
                           else torch.equal(g, g0)))
                check(ok, f"bucket update not bitwise: {spec.name} "
                          f"elem={elem} zero_grads={zero}")
                n_cases += 1
    print(f"bucket update: {n_cases} cases bitwise equal to the plain version")

    # the main path's buffers: one AdamW update over every bucket
    spec = adamw(LR)
    sizes = layout.buf_sizes
    bufs = [dict(p=rnd(n) * 0.02, m=torch.zeros(n, device="cuda"),
                 v=torch.zeros(n, device="cuda"), g=rnd(n) * 1e-3)
            for n in sizes]
    scal = pack_scalars(spec, torch.tensor(1, dtype=torch.int32, device="cuda"),
                        grad_scale=1.0, clip=torch.tensor(1.0, device="cuda"))
    big = max(range(len(sizes)), key=lambda i: sizes[i])
    x = bufs[big]
    kw = dict(n_valid=layout.sizes[big], uniform=(1.0, 0.0))
    want = bucket_update_ref(spec, x["p"], x["m"], x["v"], x["g"], scal, **kw)
    bucket_update_cuda(spec, x["p"], x["m"], x["v"], x["g"], scal, **kw)
    torch.cuda.synchronize()
    err = max((x["p"] - want[0]).abs().max().item(),
              (x["m"] - want[1]).abs().max().item(),
              (x["v"] - want[2]).abs().max().item())
    check(err == 0.0, f"bucket update not bitwise on the {sizes[big]}-element "
                      f"bucket: max err {err:.3g}")
    del want

    def kernel_all():
        for b, x in enumerate(bufs):
            bucket_update_cuda(spec, x["p"], x["m"], x["v"], x["g"], scal,
                               n_valid=layout.sizes[b], uniform=(1.0, 0.0),
                               zero_grads=True)

    def plain_all():
        for b, x in enumerate(bufs):
            bucket_update_ref(spec, x["p"], x["m"], x["v"], x["g"], scal,
                              n_valid=layout.sizes[b], uniform=(1.0, 0.0),
                              zero_grads=True)

    ms = time_ms(torch, kernel_all, 5)
    plain_ms = time_ms(torch, plain_all, 3)
    steps = [torch.ones((), device="cuda") for _ in bufs]
    library_ms = time_ms(torch, lambda: torch._fused_adamw_(
        [x["p"] for x in bufs], [x["g"] for x in bufs],
        [x["m"] for x in bufs], [x["v"] for x in bufs], [], steps,
        lr=LR, beta1=spec.beta1, beta2=spec.beta2, weight_decay=0.0,
        eps=spec.eps, amsgrad=False, maximize=False), 5)
    n = sum(sizes)
    nbytes = 4.0 * n * 8           # read p, m, v, g; write p, m, v, zeroed g
    flops = 17.0 * n               # the AdamW expression per element
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = flops / F32_FLOPS_PER_S * 1e3
    print(f"bucket update main path ({len(sizes)} buckets, {n:,} elements, "
          f"largest {sizes[big]:,}): kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, _fused_adamw_ {library_ms:.3f} ms, bound {bound_b:.3f} ms "
          f"(bytes), {nbytes / ms / 1e6:.0f} GB/s achieved")
    report["bucket_update"] = dict(
        cases=n_cases, elements=n, buckets=len(sizes), ms=ms,
        plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(bound_b, bound_o),
        bytes=nbytes, max_abs_err=err)
    del bufs
    torch.cuda.empty_cache()
    return {
        "name": "bucket_update", "route": "cuda",
        "source": "src/repro_torch/kernels/bucket_update/csrc/bucket_update.cu",
        "replaces": "src/repro/kernels/bucket_update/kernel.py:129",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_b, bound_o),
        "bound_by": "bytes" if bound_b >= bound_o else "operations",
        "library_ms": library_ms,
        "shape": f"AdamW over all {len(sizes)} buckets of the main path "
                 f"({n} f32 elements), zero_grads",
    }


# ---------------------------------------------------------------------------
# the DeFT main path
# ---------------------------------------------------------------------------
def main_path(torch, cfg, schedule, report):
    from repro_torch.kernels.bucket_update import bucket_update_cuda
    from repro_torch.kernels.flash_attention import flash_fwd_cuda
    from repro_torch.launch.train import train
    from repro_torch.train.runtime import phase_collectives

    period = schedule.period
    kw = dict(scheduler="deft", batch=BATCH, seq=SEQ,
              coverage_rate=COVERAGE_RATE, partition_elems=PARTITION_ELEMS,
              seed=0, device="cuda", lr=LR, loss_chunk=LOSS_CHUNK)

    # reference: the first period with the plain versions forced
    ref = train(cfg, steps=period, attn_impl="plain", update_impl="plain",
                log=lambda s: print("  plain: " + s), **kw)
    ref_losses = ref["losses"]
    ref_params = [b.cpu() for b in ref["state"]["pbuf"]]
    del ref
    torch.cuda.empty_cache()

    agree = {}

    def on_step(step, runtime, state, metrics):
        if step != period - 1:
            return
        per_bucket = []
        for buf, want in zip(state["pbuf"], ref_params):
            d = (buf - want.cuda()).abs()
            per_bucket.append((d.max().item(),
                               int((d > PARAM_TOL).sum().item())))
        agree.update(
            max_param_diff=max(m for m, _ in per_bucket),
            n_params_over_tol=sum(n for _, n in per_bucket),
            n_params=sum(b.numel() for b in ref_params),
            bucket_max_diff=[m for m, _ in per_bucket])

    steps = 2 * period + 2
    torch.cuda.reset_peak_memory_stats()
    flash_fwd_cuda.launches = 0
    bucket_update_cuda.launches = 0
    res = train(cfg, steps=steps, on_step=on_step,
                log=lambda s: print("  " + s), **kw)
    launches = {"flash_fwd": flash_fwd_cuda.launches,
                "bucket_update": bucket_update_cuda.launches}
    peak = torch.cuda.max_memory_allocated()

    losses = res["losses"]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    for i, got in enumerate(res["collectives"]):
        want = phase_collectives(schedule.phases[i % period])
        check(got == want, f"step {i}: issued {got}, schedule says {want}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    check(rel <= 1e-4, f"losses vs the plain run: rel diff {rel:.3g} "
                       f"({losses[:period]} vs {ref_losses})")
    # a bucket whose update went wrong or did not happen moves by ~LR, ten
    # times PARAM_MAX_DIFF; the two runs differ only by rounding
    bad = [b for b, m in enumerate(agree["bucket_max_diff"])
           if m > PARAM_MAX_DIFF]
    check(not bad and agree["n_params_over_tol"] <= PARAM_MAX_OVER,
          f"params after the first period vs the plain run: buckets {bad} "
          f"beyond {PARAM_MAX_DIFF}, {agree['n_params_over_tol']} elements "
          f"beyond {PARAM_TOL}")
    step_s = statistics.median(res["step_s"][1:])
    out = dict(
        config=dict(arch=ARCH, n_layers=N_LAYERS, of_layers=26,
                    params=cfg.total_params(), batch=BATCH, seq=SEQ,
                    coverage_rate=COVERAGE_RATE,
                    partition_elems=PARTITION_ELEMS, loss_chunk=LOSS_CHUNK),
        n_buckets=res["layout"].n_buckets, period=period,
        updates_per_period=schedule.updates_per_period,
        batch_size_sequence=list(schedule.batch_size_sequence),
        steps=steps, losses=losses, ref_losses=ref_losses,
        loss_rel_diff=rel, step_s=res["step_s"], median_step_s=step_s,
        tokens_per_s=BATCH * SEQ / step_s, peak_bytes=peak,
        launches=launches, collectives=res["collectives"], **agree)
    report["main_path"] = out
    print(f"main path: {steps} steps, median step {step_s:.3f} s, "
          f"{BATCH * SEQ / step_s:.0f} tok/s, peak memory "
          f"{peak / 2**30:.2f} GiB, launches {launches}, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, vs plain: loss rel "
          f"{rel:.2g}, params max diff {agree['max_param_diff']:.3g} "
          f"({agree['n_params_over_tol']} of {agree['n_params']} over "
          f"{PARAM_TOL})")
    return launches


def run() -> int:
    # torch.compile (the flex_attention yardstick) caches inside the
    # checkout and compiles in this process, starting no worker pool
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.launch.train import build_schedule
        from repro_torch.models.model import init_params
        from repro_torch.train.bucketing import build_bucket_layout
    except ImportError as e:
        print(f"chip_smoke: the port is not in this checkout ({e})",
              file=sys.stderr)
        return 2
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    per_lib = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {sorted(per_lib)} in {build_s:.1f} s (parallel nvcc)")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    report["build_s"] = build_s

    cfg = dataclasses.replace(get_config(ARCH), n_layers=N_LAYERS)
    print(f"config: {ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads}H/{cfg.n_kv_heads}KV, head_dim {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), depth cut to "
          f"{N_LAYERS} of 26 layers: {cfg.total_params():,} params")
    meta = init_params(cfg, device="meta")
    bucket_of, nb, _, plan = build_schedule(
        meta, cfg, dp=1, seq_len=SEQ, per_device_batch=BATCH,
        partition_elems=PARTITION_ELEMS, coverage_rate=COVERAGE_RATE)
    schedule = plan.schedule
    layout = build_bucket_layout(meta, bucket_of, nb)
    check(any(ph.update_k > 1 or ph.rotate for ph in schedule.phases),
          "degenerate schedule (no merged update, no rotation)")

    entries = [flash_phase(torch, report), bucket_phase(torch, layout, report)]
    launches = main_path(torch, cfg, schedule, report)
    for e in entries:
        e["launches"] = launches[e["name"]]
    report["kernels"] = entries
    report["wall_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
