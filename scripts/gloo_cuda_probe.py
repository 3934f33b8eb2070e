#!/usr/bin/env python3
"""Which collectives gloo runs on the card's tensors, and how fast: the
transport of ``chip_smoke.py``'s ``tp_path`` (two model ranks on the one
card, where NCCL refuses two ranks on one device).

    python3 scripts/gloo_cuda_probe.py [--iters 5]

Two processes on card 0 join a gloo group and try, on CUDA f32 tensors,
``all_reduce`` (SUM and MAX), ``all_gather_into_tensor`` and
``reduce_scatter_tensor``, each checked against the sum, max or
concatenation of both ranks' inputs.  Then they time an all-reduce of
one residual-stream activation of ``tp_path`` ([1, 8192, 2304] f32, 75.5
MB) straight on the card's tensor and staged through pinned host buffers
(device -> host, gloo on the host tensor, host -> device), the device
synchronised around each, median of ``--iters``.  Prints one JSON line a
rank-0 result and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import socket
import statistics
import subprocess
import time

SHAPE = (1, 8192, 2304)


def _try(name, fn, results):
    """Run one collective; record whether it ran and agreed."""
    try:
        results[name] = "ok" if fn() else "wrong result"
    except RuntimeError as e:            # gloo refuses a device or an op
        results[name] = f"refused: {str(e).splitlines()[0][:200]}"


def _rank(rank: int, port: int, iters: int, queue) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    mine = lambda r: torch.arange(8, dtype=torch.float32, device=dev) \
        * (r + 1) + r
    both = [mine(r) for r in range(2)]
    res = {}

    def all_reduce(op, want):
        x = mine(rank).clone()
        dist.all_reduce(x, op=op)
        torch.cuda.synchronize()
        return torch.equal(x, want)

    _try("all_reduce_sum_cuda",
         lambda: all_reduce(dist.ReduceOp.SUM, both[0] + both[1]), res)
    _try("all_reduce_max_cuda",
         lambda: all_reduce(dist.ReduceOp.MAX,
                            torch.maximum(both[0], both[1])), res)

    def all_gather():
        out = torch.empty(16, dtype=torch.float32, device=dev)
        dist.all_gather_into_tensor(out, mine(rank))
        torch.cuda.synchronize()
        return torch.equal(out, torch.cat(both))

    def reduce_scatter():
        out = torch.empty(4, dtype=torch.float32, device=dev)
        dist.reduce_scatter_tensor(out, mine(rank))
        torch.cuda.synchronize()
        return torch.equal(out, (both[0] + both[1])[4 * rank:4 * rank + 4])

    _try("all_gather_into_tensor_cuda", all_gather, res)
    _try("reduce_scatter_tensor_cuda", reduce_scatter, res)

    x = torch.randn(SHAPE, device=dev)
    host = torch.empty(SHAPE, dtype=torch.float32, pin_memory=True)

    def timed(fn):
        out = []
        for _ in range(iters + 1):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(out[1:])

    def staged():
        host.copy_(x)
        dist.all_reduce(host)
        x.copy_(host, non_blocking=True)

    if res["all_reduce_sum_cuda"] == "ok":
        res["all_reduce_cuda_ms"] = timed(lambda: dist.all_reduce(x))
    res["all_reduce_staged_ms"] = timed(staged)
    res["bytes"] = x.numel() * 4
    if rank == 0:
        queue.put(res)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, args.iters, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    res = queue.get(timeout=600)
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
            p.join()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(res))
    print(card)
    if any(p.exitcode for p in procs):
        raise SystemExit(f"a rank failed: {[p.exitcode for p in procs]}")


if __name__ == "__main__":
    main()
