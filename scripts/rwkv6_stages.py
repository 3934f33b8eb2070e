#!/usr/bin/env python3
"""Where the RWKV-6 WKV forward's or backward's time goes, and whether two
revisions of its source agree bit for bit, on one card.

    python3 scripts/rwkv6_stages.py [--bwd] [--source OLD.cu] [--out report.json]

* ``--source`` (default: the shipped ``rwkv6.cu``) names a revision of the
  kernel source, for example an older one taken from git
  (``git show <commit>:src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu``).
  Where the direction's staged kernel is in it (the forward: the single
  chunk walk ``rwkv6_fwd_kernel``, stages ``// 1.`` to ``// 4.``; the
  backward, ``--bwd``: the per-chunk gradient pass
  ``rwkv6_bwd_chunk_kernel``, stages ``// 1.`` to ``// 3.``), each stage
  closed by ``__syncthreads();``, the script builds the source once whole,
  once with each stage cut out, and once with all of them cut (the loads
  and the barriers left), and times each at the rwkv6-1.6b path's
  [1, 8192, 32, 64] f32 as the path calls it.  A cut build computes
  garbage: only its time means something.
* The whole builds' outputs are compared with the plain versions
  (``_chunked_forward``; ``rwkv6_bwd_plain``) as max |diff| / max |plain|
  and bit for bit, at that shape and at small ones, with and without s0
  (and, backward, ds_final).
* When the shipped source differs from ``--source``, it is built too: the
  two are compared bit for bit on every output (forward: o, S_final,
  states; backward: dr, dk, dv, dw, du, ds0 and the state cotangents
  ``dstates``), with max |diff| where they differ, and timed in turns
  (source, shipped, shipped, source).  Every whole build's kernels are
  timed one by one with ``torch.profiler``.

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
OUT_DIR = ROOT / "build" / "rwkv6_stages"
PATH_SHAPE = (1, 8192, 32, 64)
SMALL = [(2, 64, 2, 32), (1, 96, 4, 64), (3, 40, 2, 64), (1, 32, 1, 64),
         (1, 1000, 3, 64), (1, 5, 2, 64), (1, 1, 2, 64), (3, 70, 5, 32),
         (1, 32, 2, 64), (1, 224, 2, 64), (1, 256, 2, 32), (1, 280, 2, 64),
         (2, 1056, 2, 64)]
# direction -> (C entry point, staged kernel, {stage: marker}, outputs)
DIRECTIONS = {
    "fwd": ("rwkv6_fwd_f32", "rwkv6_fwd_kernel",
            {"decays": "// 1.", "A": "// 2.", "o": "// 3.", "state": "// 4."},
            ("o", "sfin", "states")),
    "bwd": ("rwkv6_bwd_f32", "rwkv6_bwd_chunk_kernel",
            {"decays": "// 1.", "A": "// 2.", "grads": "// 3."},
            ("dr", "dk", "dv", "dw", "du", "ds0", "dstates")),
}


def cut_stages(text: str, kernel: str, stages: dict, names) -> str:
    """``text`` with the named stages of the ``kernel`` removed (each from
    its marker to, not including, its barrier)."""
    lines = text.split("\n")
    start = next(i for i, l in enumerate(lines) if f"{kernel}(" in l)
    end = next(i for i in range(start, len(lines)) if lines[i] == "}")
    out, i, found = lines[:start], start, set()
    while i < end:
        s = lines[i].strip()
        hit = [n for n in names if s.startswith(stages[n])]
        if hit:
            found.update(hit)
            while lines[i].strip() != "__syncthreads();":
                i += 1
                if i >= end:
                    raise KeyError(f"stage {hit} of {kernel} has no barrier")
        out.append(lines[i])
        i += 1
    if found != set(names):
        raise KeyError(f"stages {set(names) - found} not found")
    return "\n".join(out + lines[end:])


def has_stages(text: str, kernel: str, stages: dict) -> bool:
    try:
        cut_stages(text, kernel, stages, list(stages))
        return True
    except (KeyError, StopIteration):
        return False


def build_all(variants, entry):
    """{name: source text} -> {name: (entry point, its params, ptxas)},
    one nvcc each, all started together."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kb

    built = {}
    for name, (lib, log) in kb.build_sources(variants, "rwkv6",
                                             OUT_DIR).items():
        fn = getattr(lib, entry)
        params = kb.c_params(variants[name], entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [t for t, _ in params]
        built[name] = (fn, [n for _, n in params],
                       kb.ptxas_report(log, "rwkv6"))
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bwd", action="store_true",
                    help="the backward (default: the forward)")
    ap.add_argument("--source", default=str(SHIPPED))
    ap.add_argument("--out", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("rwkv6_stages: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, kernel_ms, time_ms
    from repro_torch.kernels.rwkv6.ops import (CHUNK, _chunked_forward,
                                               rwkv6_bwd_plain)

    direction = "bwd" if args.bwd else "fwd"
    entry, kernel, stages, outs = DIRECTIONS[direction]
    card = card_line()
    print(card)
    source = Path(args.source).read_text()
    shipped = SHIPPED.read_text()
    variants = {"source": source}
    if has_stages(source, kernel, stages):
        for n in stages:
            variants[f"cut_{n}"] = cut_stages(source, kernel, stages, [n])
        variants["cut_all"] = cut_stages(source, kernel, stages, list(stages))
    if shipped != source:
        variants["shipped"] = shipped
    built = build_all(variants, entry)
    report = {"card": card, "direction": direction, "source": args.source,
              "builds": {}}
    for name, (_, params, ptxas) in built.items():
        report["builds"][name] = {"ptxas": ptxas}
        print(f"{name}:\n  " + "\n  ".join(ptxas))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def inputs(b, s, h, d):
        """r, k, v, w, u, s0, do, ds_final"""
        mk = lambda *shape: torch.randn(shape, device="cuda", generator=gen)
        w = torch.sigmoid(mk(b, s, h, d)) * 0.9 + 0.05
        return (mk(b, s, h, d), mk(b, s, h, d), mk(b, s, h, d), w, mk(h, d),
                mk(b, h, d, d), mk(b, s, h, d), mk(b, h, d, d))

    def caller(name, given):
        """A call of build ``name`` on the named tensors ``given`` (the
        inputs; the outputs and the scratch are allocated here) and the
        outputs it writes, by name."""
        fn, params, _ = built[name]
        b, s, h, d = given["r"].shape
        nc = -(-s // CHUNK)
        new = lambda *shape: torch.empty(shape, device="cuda")
        shapes = {"o": (b, s, h, d), "dr": (b, s, h, d), "dk": (b, s, h, d),
                  "dv": (b, s, h, d), "dw": (b, s, h, d), "du": (h, d),
                  "sfin": (b, h, d, d), "ds0": (b, h, d, d)}
        given = dict(given)
        if given["s0"] is None:
            given["ds0"] = None        # the backward writes no ds0 then
        vals = []
        for p in params:
            if p in ("B", "S", "H", "D"):
                vals.append(dict(B=b, S=s, H=h, D=d)[p])
            elif p == "device":
                vals.append(given["r"].device.index)
            elif p == "stream":
                vals.append(torch.cuda.current_stream().cuda_stream)
            elif p in given:
                x = given[p]
                vals.append(None if x is None else x.data_ptr())
            else:                  # an output, or a scratch buffer
                given[p] = new(*shapes.get(p, (b, h, nc, d, d)))
                vals.append(given[p].data_ptr())

        def call():
            err = fn(*vals)
            if err:
                raise RuntimeError(f"{name}: launch failed with code {err}")
        return call, {n: given.get(n) for n in outs}

    def rel(x, y):
        return ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()

    whole = [n for n in ("source", "shipped") if n in built]
    checks, differ = [], set()
    for shape in SMALL + [PATH_SHAPE]:
        r, k, v, w, u, s0, do, dsf = inputs(*shape)
        for use_s0 in (False, True):
            for use_dsf in ((False, True) if args.bwd else (False,)):
                if shape == PATH_SHAPE and use_s0 != use_dsf:
                    continue
                x0 = s0 if use_s0 else None
                fo, fsf, states = _chunked_forward(r, k, v, w, u, x0)
                given = dict(r=r, k=k, v=v, w=w, u=u, s0=x0)
                if args.bwd:
                    given.update(states=states, dout=do,
                                 dsfin=dsf if use_dsf else None)
                    want = dict(zip(
                        ("dr", "dk", "dv", "dw", "du", "ds0"),
                        rwkv6_bwd_plain(r, k, v, w, u, x0, do, given["dsfin"],
                                        states=states)))
                else:
                    want = dict(o=fo, sfin=fsf, states=states)
                got = {}
                for n in whole:
                    call, res = caller(n, given)
                    call()
                    got[n] = res
                torch.cuda.synchronize()
                row = {"shape": list(shape), "s0": use_s0}
                if args.bwd:
                    row["ds_final"] = use_dsf
                for n in whole:
                    for what, y in want.items():
                        x = got[n][what]
                        if x is None or y is None:
                            continue
                        row[f"{n}_vs_plain_{what}_rel"] = rel(x, y)
                        row[f"{n}_vs_plain_{what}_equal"] = bool(
                            torch.equal(x, y))
                if len(whole) == 2:
                    for what in outs:
                        x, y = got["shipped"][what], got["source"][what]
                        if x is None:
                            continue
                        same = bool(torch.equal(x, y))
                        row[f"shipped_vs_source_{what}_equal"] = same
                        if not same:
                            differ.add(what)
                            row[f"shipped_vs_source_{what}_max_abs"] = (
                                (x - y).abs().max().item())
                checks.append(row)
                print(json.dumps(row))
                del want, got, states
        torch.cuda.empty_cache()
    report["checks"] = checks
    if len(whole) == 2:
        report["outputs_not_bitwise"] = sorted(differ)
        print("shipped vs source, outputs not bit for bit equal: "
              f"{sorted(differ) or 'none'}")

    r, k, v, w, u, _, do, _ = inputs(*PATH_SHAPE)
    path_given = dict(r=r, k=k, v=v, w=w, u=u, s0=None)
    if args.bwd:
        states = _chunked_forward(r, k, v, w, u)[2]
        path_given.update(states=states, dout=do, dsfin=None)

    order = (["source", "shipped", "shipped", "source"] if len(whole) == 2
             else ["source"])
    order += [n for n in built if n.startswith("cut_")] + ["source"]
    times = {}
    for n in order:
        call = caller(n, path_given)[0]
        times.setdefault(n, []).append(time_ms(torch, call, args.iters, 3))
        torch.cuda.empty_cache()
    report["ms"] = times
    for n, t in times.items():
        print(f"{n} at {list(PATH_SHAPE)}: " + " / ".join(f"{x:.4f}" for x in t)
              + " ms")
    report["per_kernel_ms"] = {}
    for n in whole:
        call, _ = caller(n, path_given)
        per = kernel_ms(torch, call, args.iters, "rwkv6")
        report["per_kernel_ms"][n] = per
        for kname, t in per.items():
            print(f"{n} kernel {kname}: {t:.4f} ms a launch")
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
