#!/usr/bin/env python3
"""Where a step of ``chip_smoke.py``'s sharded model-2 cut goes:
deepseek-v2-236b's dense layer 0 at full width on its sharded flat engine
at data 1 x model 2, two processes on card 0 over gloo (``tp_path``'s
cut, the same schedule, batch, sequence and seed).

    python3 scripts/tp_step_split.py [--steps 4]

Each rank times, the device synchronised before and after each call, its
'model' collectives (``ModelParallel.timed``) and its 'data' line's: the
engine's ``DataParallel`` param gathers and trailing all-gathers,
reduce-scatters, norm and metric sums, timed here by wrapping those
methods.  Over the steps after the first it sums the seconds of each kind
and takes the median step.  Prints one JSON line per rank and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
DATA_LINE = ("all_gather", "reduce_scatter", "norm", "metrics")


def _rank(rank: int, port: int, steps: int, queue) -> None:
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.train.runtime import DataParallel

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    on = [False]
    secs = dict.fromkeys(DATA_LINE, 0.0)

    def timed(name):
        fn = getattr(DataParallel, name)

        def call(self, *args, **kw):
            if not on[0]:
                return fn(self, *args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *args, **kw)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            return out
        return call

    for name in DATA_LINE:
        setattr(DataParallel, name, timed(name))
    got = {}

    def on_step(step, runtime, state, metrics):
        if step == 0:                      # the first step warms up
            on[0] = True
            runtime.tp.reset()
            runtime.tp.timed = True
        if step == steps - 1:
            on[0] = False
            got.update(model_s=runtime.tp.seconds,
                       model_calls=dict(runtime.tp.calls))

    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=1)
    res = train(cfg, steps=steps, data=1, model=2, scheduler="deft",
                batch=1, seq=4096, coverage_rate=1.8,
                partition_elems=200_000, seed=0, device="cuda", lr=1e-3,
                loss_chunk=1024, on_step=on_step, log=lambda s: None)
    timed_s = sum(res["step_s"][1:])
    data_s = sum(secs.values())
    queue.put(dict(
        rank=rank, steps=steps, sharded=res["runtime"].fsdp,
        median_step_s=statistics.median(res["step_s"][1:]),
        timed_steps_s=timed_s, data_line_s=secs, data_line_total_s=data_s,
        rest_s=timed_s - data_s - got["model_s"], **got))
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, args.steps, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        out = sorted((queue.get(timeout=900) for _ in procs),
                     key=lambda r: r["rank"])
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r in out:
        print(json.dumps(r))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    if any(p.exitcode for p in procs):
        sys.exit(1)


if __name__ == "__main__":
    main()
