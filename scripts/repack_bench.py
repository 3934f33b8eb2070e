"""Time one layout change's repack of a flat train state on the card:
``repack_buffers`` (one ``torch.cat`` of slices per bucket) against
``repack_placed`` (the pieces copied into each new bucket, zeros where
none lands), one state component at a time, on gemma2-2b at full width
cut to 8 layers (``chip_smoke.py``'s configuration), from the greedy fill
at a sixteenth of the params (8 buckets) to 1 bucket, in bf16 (the
bf16sr master) and f32 (moments and accumulators).  Both results are
checked bitwise equal.  Then a whole resident state of the sharded
precision engine at one shard (bf16 master, f32 moments and accumulators,
the gradient buffers and the bf16 gather cache: 27.2 GiB) is repacked
component by component as ``DeftRuntime._repack`` does, by each method in
the order cat, placed, placed, cat, from an emptied allocator cache, with
and without ``torch.cuda.memory._record_memory_history`` recording (as
``chip_smoke.py``'s adapt paths record over their install).

    python3 scripts/repack_bench.py [--reps 3] [--out chiprun_out/repack_bench.json]

Needs one CUDA card; prints one JSON object.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.train.bucketing import (
        assign_buckets,
        build_bucket_layout,
        build_layout_transition,
        repack_buffers,
    )
    from repro_torch.train.runtime import Placement, repack_placed
    from repro_torch.tree import tree_leaves

    if not torch.cuda.is_available():
        sys.exit("repack_bench: no CUDA card")
    dist.init_process_group("gloo", init_method="tcp://localhost:29531",
                            world_size=1, rank=0)
    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=8)
    meta = init_params(cfg, device="meta")
    n = sum(x.numel() for x in tree_leaves(meta))
    bo, nb = assign_buckets(meta, cfg, partition_elems=-(-n // 16))
    src = build_bucket_layout(meta, bo, nb)
    dst = build_bucket_layout(meta, (0,) * len(bo), 1)
    tr = build_layout_transition(src, dst)
    a = Placement((0,), None, src, False)
    b = Placement((0,), None, dst, False)
    dev = torch.device("cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        bufs = [torch.randn((s,), device=dev).to(dtype)
                for s in src.buf_sizes]
        cat_s, placed_s = [], []
        for _ in range(args.reps):
            s1, o1 = timed(lambda: repack_buffers(tr, bufs))
            cat_s.append(s1)
            s2, o2 = timed(lambda: repack_placed(tr, bufs, a, b, dtype=dtype,
                                                 device=dev))
            placed_s.append(s2)
            assert all(torch.equal(x, y) for x, y in zip(o1, o2))
            del o1, o2
        rows.append(dict(dtype=str(dtype).replace("torch.", ""),
                         elements=sum(src.buf_sizes),
                         cat_ms=[x * 1e3 for x in cat_s],
                         placed_ms=[x * 1e3 for x in placed_s]))
        del bufs
        torch.cuda.empty_cache()

    def make_state():
        f32 = lambda: [torch.randn((s,), device=dev) for s in src.buf_sizes]
        return {"pbuf": [x.to(torch.bfloat16) for x in f32()], "m": f32(),
                "v": f32(), "cur": f32(), "fut": f32(),
                "gbuf": f32(), "pgather": [x.to(torch.bfloat16)
                                           for x in f32()]}

    def repack(state, method):
        state.pop("gbuf")
        state.pop("pgather")
        for key in ("pbuf", "m", "v", "cur", "fut"):
            bufs = state.pop(key)
            dtype = bufs[0].dtype
            out = (repack_buffers(tr, bufs) if method == "cat" else
                   repack_placed(tr, bufs, a, b, dtype=dtype, device=dev))
            del bufs
            state[key] = tuple(out)
        state["gbuf"] = [torch.zeros((s,), device=dev) for s in dst.buf_sizes]
        state["pgather"] = [torch.zeros((s,), dtype=torch.bfloat16,
                                        device=dev) for s in dst.buf_sizes]
        return state

    whole = []
    for record in (False, True):
        for method in ("cat", "placed", "placed", "cat"):
            torch.cuda.empty_cache()
            state = make_state()
            if record:
                torch.cuda.memory._record_memory_history(
                    enabled="all", context="alloc", stacks="python",
                    max_entries=200_000)
            s, state = timed(lambda: repack(state, method))
            if record:
                torch.cuda.memory._record_memory_history(enabled=None)
            whole.append(dict(method=method, recording=record, ms=s * 1e3))
            del state
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    res = dict(card=card.strip(), src_buckets=src.n_buckets,
               dst_buckets=dst.n_buckets,
               copies=sum(len(c) for c in tr.copies), rows=rows,
               whole_state=whole)
    print(json.dumps(res))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
