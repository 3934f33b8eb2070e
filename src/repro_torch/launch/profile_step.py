"""Where a DeFT training step's device time goes, from ``torch.profiler``.

Builds the same run as ``launch.train.train`` (one rank), steps through
``--warm`` steps, then profiles one whole schedule period and prints one
JSON object: wall time, summed kernel time, the device's idle share, and
kernel time by category (this port's kernels, matrix products,
everything else) with the top kernels by name.  ``--wire-precision`` and
``--master-dtype`` are ``launch.train``'s; the engine is the arch's
default (the sharded flat engine, at one shard, where ``needs_fsdp``
names the arch).

    python -m repro_torch.launch.profile_step --layers 8 --seq 8192 \
        --loss-chunk 1024 --out chiprun_out/profile_step.json
    python -m repro_torch.launch.profile_step --wire-precision int8 \
        --master-dtype bf16sr --out chiprun_out/profile_precision.json
    python -m repro_torch.launch.profile_step --arch recurrentgemma-9b \
        --layers 6 --out chiprun_out/profile_recurrent.json
    python -m repro_torch.launch.profile_step --arch rwkv6-1.6b \
        --layers 24 --out chiprun_out/profile_rwkv6.json
    python -m repro_torch.launch.profile_step --arch seamless-m4t-large-v2 \
        --layers 24 --seq 4096 --out chiprun_out/profile_encdec.json
    python -m repro_torch.launch.profile_step --arch deepseek-v2-236b \
        --layers 1 --seq 4096 --out chiprun_out/profile_mla.json

``--layers`` sets the decoder's depth (deepseek-v2-236b at 1: its dense
layer 0); an encoder-decoder keeps its config's encoder layers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.train import build_schedule, init_distributed
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.sharding import needs_fsdp
from repro_torch.train.bucketing import build_bucket_layout
from repro_torch.train.runtime import DeftRuntime

_CATEGORIES = (
    ("flash_fwd f32, split-TF32 tensor cores (this port)",
     ("flash_fwd_tf32_kernel", "flash_split_kernel")),
    ("flash_fwd bf16, tensor cores (this port)", ("flash_fwd_sm90_kernel",)),
    ("bucket_update (this port)", ("bucket_update_kernel",)),
    ("int8 quantize / dequantize (this port)", ("quant_int8_kernel",)),
    ("stochastic rounding (this port)", ("sr_bf16_kernel",)),
    ("RG-LRU scan forward (this port)", ("rglru_fwd_kernel",)),
    ("RG-LRU scan backward (this port)", ("rglru_bwd_kernel",)),
    ("RWKV-6 WKV forward (this port)", ("rwkv6_fwd_state_kernel",
                                        "rwkv6_fwd_scan_kernel",
                                        "rwkv6_fwd_out_kernel")),
    ("RWKV-6 WKV backward (this port)", ("rwkv6_bwd_state_kernel",
                                         "rwkv6_bwd_scan_kernel",
                                         "rwkv6_bwd_chunk_kernel",
                                         "rwkv6_bwd_du_kernel")),
    ("matrix products", ("gemm", "Gemm", "cutlass", "cublas", "xmma", "sm90",
                         "nvjet")),
    ("collectives", ("nccl",)),
)


def _category(name: str) -> str:
    for cat, keys in _CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other (elementwise, reductions, copies)"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="gemma2-2b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--coverage-rate", type=float, default=1.8)
    ap.add_argument("--partition-elems", type=int, default=200_000)
    ap.add_argument("--loss-chunk", type=int, default=1024)
    ap.add_argument("--wire-precision", choices=["auto", "f32", "bf16", "int8"],
                    default="f32")
    ap.add_argument("--master-dtype", choices=["f32", "bf16sr"], default="f32")
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="steps profiled (0 = one schedule period)")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    init_distributed(dev)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    meta = init_params(cfg, device="meta")
    bucket_of, nb, _, plan = build_schedule(
        meta, cfg, dp=1, seq_len=args.seq, per_device_batch=args.batch,
        partition_elems=args.partition_elems, coverage_rate=args.coverage_rate,
        wire_precision=args.wire_precision, master_dtype=args.master_dtype)
    layout = build_bucket_layout(meta, bucket_of, nb)
    if plan.precision is not None:
        layout = layout.with_precision(plan.precision)
    rt = DeftRuntime(cfg, adamw(1e-3), plan.schedule, layout, device=dev,
                     loss_chunk=args.loss_chunk, master_dtype=args.master_dtype,
                     fsdp=needs_fsdp(cfg.name))
    state = rt.init_state(0)
    n_prof = args.profile_steps or rt.period
    batches = [make_batch(cfg, 0, i, args.batch, args.seq, device=dev)
               for i in range(args.warm + n_prof)]
    for i in range(args.warm):
        state, m = rt.step(i, state, batches[i])
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.warm, args.warm + n_prof):
            state, m = rt.step(i, state, batches[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] += e.time_range.elapsed_us() / 1e3   # ms
    busy = sum(kernels.values())
    cats = defaultdict(float)
    for name, ms in kernels.items():
        cats[_category(name)] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:args.top]
    out = {
        "device": torch.cuda.get_device_name(0),
        "config": dict(arch=args.arch, layers=args.layers, seq=args.seq,
                       batch=args.batch, loss_chunk=args.loss_chunk,
                       wire_precision=rt.stats()["wire_precision"],
                       master_dtype=rt.master_dtype,
                       sharded=rt.stats()["sharded_state"]),
        "period": rt.period,
        "steps_profiled": n_prof,
        "wall_ms_per_step": wall * 1e3 / n_prof,
        "kernel_ms_per_step": busy / n_prof,
        "idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "by_category_ms_per_step": {k: v / n_prof for k, v in
                                    sorted(cats.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [(n[:120], v / n_prof) for n, v in top],
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
