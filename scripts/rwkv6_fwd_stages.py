#!/usr/bin/env python3
"""Where the RWKV-6 WKV forward's time goes, and whether two revisions of
its source agree bit for bit, on one card.

    python3 scripts/rwkv6_fwd_stages.py [--source OLD.cu] [--out report.json]

* ``--source`` (default: the shipped ``rwkv6.cu``) names a revision of the
  kernel source, for example an older one taken from git
  (``git show <commit>:src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu``).
  Where its forward kernel is the single chunk walk, whose stages are
  marked ``// 1.`` to ``// 4.`` and each closed by ``__syncthreads();``,
  the script builds it once whole, once with each stage cut out, and once
  with all four cut (the loads and the barriers left), and times each at
  the rwkv6-1.6b path's [1, 8192, 32, 64] f32 with the chunk-start states
  written, as the path calls it.  A cut build computes garbage: only its
  time means something.
* The whole build's o, S_final and states are compared with
  ``_chunked_forward`` (bit for bit, and max |diff| / max |plain|) at that
  shape and at small ones, with and without s0.
* When the shipped source differs from ``--source``, it is built too: the
  two are compared bit for bit on o, S_final and states at every shape,
  timed in turns (source, shipped, shipped, source), and the shipped
  forward's kernels are timed one by one with ``torch.profiler`` (also
  when ``--source`` is the shipped source).

Each source is called through its own ``extern "C"`` signature, so
revisions with other scratch arguments compare.  Needs nvcc and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = ROOT / "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu"
OUT_DIR = ROOT / "build" / "rwkv6_fwd_stages"
PATH_SHAPE = (1, 8192, 32, 64)
SMALL = [(2, 64, 2, 32), (1, 96, 4, 64), (3, 40, 2, 64), (1, 32, 1, 64),
         (1, 1000, 3, 64), (1, 5, 2, 64), (1, 1, 2, 64), (3, 70, 5, 32)]
STAGES = {"decays": "// 1.", "A": "// 2.", "o": "// 3.", "state": "// 4."}


def cut_stages(text: str, names) -> str:
    """``text`` with the named stages of the single-walk forward kernel
    removed (each from its marker to, not including, its barrier)."""
    lines = text.split("\n")
    start = next(i for i, l in enumerate(lines) if "rwkv6_fwd_kernel(" in l)
    end = next(i for i in range(start, len(lines)) if lines[i] == "}")
    out, i, found = lines[:start], start, set()
    while i < end:
        s = lines[i].strip()
        hit = [n for n in names if s.startswith(STAGES[n])]
        if hit:
            found.update(hit)
            while lines[i].strip() != "__syncthreads();":
                i += 1
        out.append(lines[i])
        i += 1
    if found != set(names):
        raise KeyError(f"stages {set(names) - found} not found")
    return "\n".join(out + lines[end:])


def has_stages(text: str) -> bool:
    try:
        cut_stages(text, list(STAGES))
        return True
    except (KeyError, StopIteration):
        return False


def build_all(variants):
    """{name: source text} -> {name: (entry point, its params, ptxas)},
    one nvcc each, all started together."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kb

    built = {}
    for name, (lib, log) in kb.build_sources(variants, "rwkv6",
                                             OUT_DIR).items():
        fn = lib.rwkv6_fwd_f32
        params = kb.c_params(variants[name], "rwkv6_fwd_f32")
        fn.restype = ctypes.c_int
        fn.argtypes = [t for t, _ in params]
        built[name] = (fn, [n for _, n in params], kb.ptxas_report(log))
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=str(SHIPPED))
    ap.add_argument("--out", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("rwkv6_fwd_stages: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, kernel_ms, time_ms
    from repro_torch.kernels.rwkv6.ops import CHUNK, _chunked_forward

    card = card_line()
    print(card)
    source = Path(args.source).read_text()
    shipped = SHIPPED.read_text()
    variants = {"source": source}
    if has_stages(source):
        for n in STAGES:
            variants[f"cut_{n}"] = cut_stages(source, [n])
        variants["cut_all"] = cut_stages(source, list(STAGES))
    if shipped != source:
        variants["shipped"] = shipped
    built = build_all(variants)
    report = {"card": card, "source": args.source, "builds": {}}
    for name, (_, params, ptxas) in built.items():
        report["builds"][name] = {"ptxas": ptxas}
        print(f"{name}:\n  " + "\n  ".join(ptxas))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def inputs(b, s, h, d):
        mk = lambda *shape: torch.randn(shape, device="cuda", generator=gen)
        w = torch.sigmoid(mk(b, s, h, d)) * 0.9 + 0.05
        return mk(b, s, h, d), mk(b, s, h, d), mk(b, s, h, d), w, mk(h, d), \
            mk(b, h, d, d)

    def caller(name, r, k, v, w, u, s0):
        """A call of build ``name`` and its (o, S_final, states)."""
        fn, params, _ = built[name]
        b, s, h, d = r.shape
        nc = -(-s // CHUNK)
        new = lambda *shape: torch.empty(shape, device="cuda")
        o, sf, states = new(b, s, h, d), new(b, h, d, d), new(b, h, nc, d, d)
        given = dict(r=r, k=k, v=v, w=w, u=u, s0=s0, o=o, sfin=sf,
                     states=states)
        vals = []
        for p in params:
            if p in given:
                x = given[p]
                vals.append(None if x is None else x.data_ptr())
            elif p in ("B", "S", "H", "D"):
                vals.append(dict(B=b, S=s, H=h, D=d)[p])
            elif p == "device":
                vals.append(r.device.index)
            elif p == "stream":
                vals.append(torch.cuda.current_stream().cuda_stream)
            else:                          # a scratch buffer of the kernel
                given[p] = new(b, h, nc, d, d)
                vals.append(given[p].data_ptr())

        def call():
            err = fn(*vals)
            if err:
                raise RuntimeError(f"{name}: launch failed with code {err}")
        return call, (o, sf, states)

    def rel(x, y):
        return ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()

    whole = [n for n in ("source", "shipped") if n in built]
    checks = []
    for shape in SMALL + [PATH_SHAPE]:
        r, k, v, w, u, s0 = inputs(*shape)
        for use_s0 in ((False, True) if shape != PATH_SHAPE else (False,)):
            x0 = s0 if use_s0 else None
            want = _chunked_forward(r, k, v, w, u, x0)
            got = {}
            for n in whole:
                call, outs = caller(n, r, k, v, w, u, x0)
                call()
                got[n] = outs
            torch.cuda.synchronize()
            row = {"shape": list(shape), "s0": use_s0}
            for n in whole:
                for what, x, y in zip(("o", "S_final", "states"), got[n],
                                      want):
                    row[f"{n}_vs_plain_{what}_equal"] = bool(torch.equal(x, y))
                    row[f"{n}_vs_plain_{what}_rel"] = rel(x, y)
            if len(whole) == 2:
                for what, x, y in zip(("o", "S_final", "states"),
                                      got["shipped"], got["source"]):
                    row[f"shipped_vs_source_{what}_equal"] = bool(
                        torch.equal(x, y))
            checks.append(row)
            print(json.dumps(row))
            del want, got
        torch.cuda.empty_cache()
    report["checks"] = checks

    r, k, v, w, u, _ = inputs(*PATH_SHAPE)

    order = (["source", "shipped", "shipped", "source"] if len(whole) == 2
             else ["source"])
    order += [n for n in built if n.startswith("cut_")] + ["source"]
    times = {}
    for n in order:
        call = caller(n, r, k, v, w, u, None)[0]
        times.setdefault(n, []).append(time_ms(torch, call, args.iters, 3))
    report["ms"] = times
    for n, t in times.items():
        print(f"{n} at {list(PATH_SHAPE)}: " + " / ".join(f"{x:.4f}" for x in t)
              + " ms")
    ship = "shipped" if "shipped" in built else (
        "source" if source == shipped else None)
    if ship:
        call, _ = caller(ship, r, k, v, w, u, None)
        per = kernel_ms(torch, call, args.iters, "rwkv6")
        report["shipped_per_kernel_ms"] = per
        for n, t in per.items():
            print(f"shipped kernel {n}: {t:.4f} ms a launch")
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
