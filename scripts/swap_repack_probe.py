"""Time the hot swap's repack inside the launcher's adaptive loop on the
card, with the caching allocator's counters around it: gemma2-2b at full
width cut to 8 layers, the sharded delayed precision run (int8 wires,
bf16sr master, bf16 compute, coverage rate 7.2), a synthetic 3x drop at
step 4 and a repartition (16 -> 1 buckets at step 6), as
``chip_smoke.py``'s ``adapt_precision_path`` drives it.

    python3 scripts/swap_repack_probe.py [--src DIR] [--record] [--out FILE]

``--src`` imports ``repro_torch`` from another checkout's ``src`` (an
older tree unpacked with ``git archive``), so two versions compare in one
call; ``--record`` turns ``torch.cuda.memory._record_memory_history`` on
from the step before the install, as ``chip_smoke.py`` does.  The
allocator's counters are read before the install and after the first
step of the new layout.  Needs one CUDA card; prints one JSON object.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("allocated_bytes.all.current", "reserved_bytes.all.current",
        "num_alloc_retries", "num_device_alloc", "num_device_free")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    from repro_torch.adapt import AdaptConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    if not torch.cuda.is_available():
        sys.exit("swap_repack_probe: no CUDA card")
    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=8)
    stats = {}

    def snap():
        s = torch.cuda.memory_stats()
        return {k: s.get(k) for k in KEYS}

    def on_step(step, runtime, state, metrics):
        if runtime.swap_ready() and not runtime.hot_swaps \
                and runtime.phase_in_cycle(step + 1) == 0:
            torch.cuda.synchronize()
            stats["before_install"] = snap()
            if args.record:
                torch.cuda.memory._record_memory_history(
                    enabled="all", context="alloc", stacks="python",
                    max_entries=200_000)
        elif runtime.hot_swaps and "after_first_new_step" not in stats:
            torch.cuda.synchronize()
            stats["after_first_new_step"] = snap()
            if args.record:
                torch.cuda.memory._record_memory_history(enabled=None)

    with tempfile.TemporaryDirectory() as d:
        res = train(
            cfg, steps=8, on_step=on_step, adapt=True,
            adapt_config=AdaptConfig(
                eta=1e-3, warmup_steps=2, check_every=2, cooldown_steps=100,
                min_loss_samples=10**9, wire_precision="int8"),
            adapt_drop_step=4, adapt_drop_scale=3.0, adapt_repartition=True,
            trace=os.path.join(d, "trace.json"), scheduler="deft", batch=1,
            seq=8192, seed=0, device="cuda", lr=1e-3, loss_chunk=1024,
            partition_elems=200_000, coverage_rate=7.2,
            wire_precision="int8", master_dtype="bf16sr", fsdp=True,
            compute_dtype="bf16", log=lambda s: None)
    installs = [e for e in res["runtime"].swap_log if "event" not in e]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = dict(src=args.src, record=args.record, card=card.strip(),
               installs=[dict(step=e["step"], n_buckets=e["n_buckets"],
                              repack_s=e["repack_s"]) for e in installs],
               losses=res["losses"], allocator=stats)
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
