#!/usr/bin/env python3
"""Two revisions of the bf16 tensor-core flash forward (``flash_fwd_sm90.cu``)
side by side on one card, and text cuts of the shipped one.

    python3 scripts/flash_sm90_layouts.py [--source OLD.cu] [--cut NAME]...
        [--out report.json]

* ``--source`` (default: the shipped ``flash_fwd_sm90.cu``) names a
  revision of the kernel source, for example an older one taken from git
  (``git show <commit>:src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu``)
  into a git-ignored path such as ``build/parent/``.  It is built, and the
  shipped source too where the two differ, and each ``--cut`` of the
  shipped source: one ``nvcc`` each, started together, with
  ``kernels/build.py``'s flags.  Each build's registers and spills are
  printed.
* Cuts (``CUTS``): ``heads_first`` and ``query_first`` launch the grid in
  one order at every shape, in place of the choice by kv heads against
  the CTAs in flight; ``no_pingpong`` drops the named barriers that give
  the two warpgroups turns at the tensor cores (each still overlaps its
  softmax with its own P.V); ``mla_bk64`` runs (192, 128) at 64 keys a
  block and 4 stages.  The first three compute bit for bit what the
  shipped source computes, only their time differs.
* Each build is held against ``flash_fwd_plain`` under ``chip_smoke.py``'s
  bf16 checks (out within rtol 2^-7, atol 1e-5; lse within 1e-4) at its
  small bf16 cases and at the timed shapes; out and lse of every build
  whose key block is the source's are compared bit for bit with the
  source's (all but ``mla_bk64`` at MLA).
* Timed shapes: gemma2-2b's global and local layers ([1, 8192], 8 heads
  over 4 of 256, softcap 50, window 0 / 4096) and MLA's [1, 4096, 128]
  causal at (192, 128), in turns with CUDA events: source, shipped,
  shipped, source, then the cuts forth and back, then source, shipped,
  shipped, source again.  Beside each, the HBM bytes of K and V as
  modelled from the shapes (unshared: every query block reads its visible
  keys, as heads first does at MLA; shared: each kv head once), the
  TFLOP/s of the split work (2 D + 4 DV flops a visible pair), and the
  SM clock and power draw ``nvidia-smi`` reads every 250 ms meanwhile
  (lowest and highest).

Needs nvcc and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu"
OUT_DIR = ROOT / "build" / "flash_sm90_layouts"
ENTRY = "flash_fwd_sm90_bf16"

# text cuts of the shipped source: {name: [(old, new, occurrences)]}
CUTS = {
    "heads_first": [("const int qfast = in_flight[device] < QFAST_SHARE * KVH;",
                     "const int qfast = 0;", 1)],
    "query_first": [("const int qfast = in_flight[device] < QFAST_SHARE * KVH;",
                     "const int qfast = 1;", 1)],
    "no_pingpong": [("constexpr bool PINGPONG = true;",
                     "constexpr bool PINGPONG = false;", 1)],
    "mla_bk64": [("static constexpr int BK = D == 256 ? 64 : 128;",
                  "static constexpr int BK = D == 256 || D == 192 ? 64 : 128;",
                  1)],
}
# cuts whose key block differs from the shipped one at (D, DV)
OTHER_BK = {"mla_bk64": {(192, 128)}}
# the timed shapes: (B, S, H, KV, D, DV, window, softcap), all causal
SHAPES = {
    "global": (1, 8192, 8, 4, 256, 256, 0, 50.0),
    "local": (1, 8192, 8, 4, 256, 256, 4096, 50.0),
    "mla": (1, 4096, 128, 128, 192, 128, 0, 0.0),
}


def cut(text: str, name: str) -> str:
    for old, new, count in CUTS[name]:
        if text.count(old) != count:
            raise KeyError(f"{name}: {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    return text


def kv_hbm_bytes(b, s, h, kvh, d, dv, window, bq=128):
    """(unshared, shared): bytes of K and V (bf16) read from HBM when every
    query block reads its visible key blocks itself (heads first where
    each kv head has about one CTA in flight: MLA), and when each kv
    head's K and V are read once and then shared through L2 (query first
    there; heads first where many CTAs share a kv head: gemma2)."""
    bk = 64 if d == 256 else 128
    blocks = 0
    for q0 in range(0, s, bq):
        lo = max(0, q0 - window + 1) if window else 0
        hi = min(s, q0 + bq)
        blocks += -(-hi // bk) - lo // bk
    return (blocks * b * h * bk * (d + dv) * 2, b * kvh * s * (d + dv) * 2)


def clock_samples(proc) -> dict:
    """Lowest and highest SM clock (MHz) and power draw (W) of the
    ``nvidia-smi -lms`` samples ``proc`` printed before it was stopped."""
    proc.terminate()
    rows = []
    for line in proc.communicate()[0].splitlines():
        try:
            mhz, watts = (float(x.split()[0]) for x in line.split(","))
        except (ValueError, IndexError):
            continue
        rows.append((mhz, watts))
    if not rows:
        return {}
    return dict(samples=len(rows), sm_mhz_min=min(r[0] for r in rows),
                sm_mhz_max=max(r[0] for r in rows),
                watts_max=max(r[1] for r in rows))


def build_all(variants):
    """{name: source text} -> {name: (entry point, ptxas lines)}."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kb
    from repro_torch.kernels.flash_attention.ops import BF16_ARGTYPES

    built = {}
    for name, (lib, log) in kb.build_sources(variants, "flash_fwd_sm90",
                                             OUT_DIR).items():
        fn = getattr(lib, ENTRY)
        fn.restype = ctypes.c_int
        fn.argtypes = BF16_ARGTYPES
        built[name] = (fn, kb.ptxas_report(log))
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=str(SHIPPED))
    ap.add_argument("--cut", action="append", default=[], choices=sorted(CUTS))
    ap.add_argument("--out", default="")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_sm90_layouts: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (BF16_FLOPS_PER_S, BF16_OUT_RTOL, FLASH_BF16_CASES,
                            FLASH_TOL, card_line, time_ms, visible_pairs)
    from repro_torch.kernels.flash_attention.ops import (_tma_strides,
                                                         flash_fwd_plain)

    card = card_line()
    print(card)
    source = Path(args.source).read_text()
    shipped = SHIPPED.read_text()
    variants = {"source": source}
    if shipped != source:
        variants["shipped"] = shipped
    variants.update((n, cut(shipped, n)) for n in args.cut)
    built = build_all(variants)
    report = {"card": card, "source": args.source, "builds": {}}
    for name, (_, ptxas) in built.items():
        report["builds"][name] = {"ptxas": ptxas}
        print(f"{name}:\n  " + "\n  ".join(ptxas))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def qkv(b, s, h, kvh, d, dv):
        mk = lambda n, w: torch.randn((b, s, n, w), device="cuda",
                                      generator=gen).bfloat16()
        return mk(h, d), mk(kvh, d), mk(kvh, dv)

    def caller(name, q, k, v, causal, window, cap):
        """A call of build ``name`` and its (out, lse)."""
        fn = built[name][0]
        b, sq, h, d = q.shape
        sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
        out = torch.empty((b, sq, h, dv), dtype=torch.bfloat16, device="cuda")
        lse = torch.empty((b, h, sq), device="cuda")
        vals = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, h, kvh, sq, sk, d, dv, *_tma_strides(q),
                *_tma_strides(k), *_tma_strides(v), *out.stride()[:3],
                int(causal), window, cap, 1.0 / d ** 0.5, q.device.index,
                torch.cuda.current_stream().cuda_stream)

        def call():
            err = fn(*vals)
            if err:
                raise RuntimeError(f"{name}: launch failed with code {err}")
        return call, (out, lse)

    failed = False
    checks = []
    cases = [(f"{c[:5]}{'/' + str(c[8]) if len(c) > 8 else ''} causal={c[5]} "
              f"window={c[6]} softcap={c[7]}",
              (c[0], c[1], c[2], c[3], c[4], c[8] if len(c) > 8 else c[4],
               c[5], c[6], c[7])) for c in FLASH_BF16_CASES]
    cases += [(layer, (b, s, h, kvh, d, dv, True, window, cap))
              for layer, (b, s, h, kvh, d, dv, window, cap) in SHAPES.items()]
    for label, (b, s, h, kvh, d, dv, causal, window, cap) in cases:
        q, k, v = qkv(b, s, h, kvh, d, dv)
        ref, ref_lse = flash_fwd_plain(q, k, v, causal=causal, window=window,
                                       softcap=cap)
        row, got = {"case": label}, {}
        for n in built:
            call, (out, lse) = caller(n, q, k, v, causal, window, cap)
            call()
            torch.cuda.synchronize()
            ok = (torch.allclose(out.float(), ref.float(), rtol=BF16_OUT_RTOL,
                                 atol=1e-5)
                  and torch.allclose(lse, ref_lse, rtol=FLASH_TOL,
                                     atol=FLASH_TOL))
            row[n] = dict(ok=ok,
                          out_err=(out.float() - ref.float()).abs().max().item(),
                          lse_err=(lse - ref_lse).abs().max().item())
            if (d, dv) not in OTHER_BK.get(n, ()):
                if got:
                    o0, l0 = got["source"]
                    row[n]["bitwise_source"] = bool(
                        torch.equal(out, o0) and torch.equal(lse, l0))
                    ok &= row[n]["bitwise_source"]
                else:
                    got["source"] = (out, lse)
            row[n]["ok"] = ok
            failed |= not ok
        checks.append(row)
        print(json.dumps(row))
        del q, k, v, ref, ref_lse, got
        torch.cuda.empty_cache()
    report["checks"] = checks

    names = [n for n in built if n not in CUTS]
    order = (["source", "shipped", "shipped", "source"] if len(names) == 2
             else ["source", "source"])
    cuts = [n for n in built if n in CUTS]
    report["ms"] = {}
    for layer, (b, s, h, kvh, d, dv, window, cap) in SHAPES.items():
        q, k, v = qkv(b, s, h, kvh, d, dv)
        calls = {n: caller(n, q, k, v, True, window, cap)[0] for n in built}
        times = {}
        smi = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader", "-lms", "250"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        for n in order + cuts + cuts[::-1] + order:
            times.setdefault(n, []).append(time_ms(torch, calls[n],
                                                   args.iters))
        clocks = clock_samples(smi)
        flops = (2 * d + 4 * dv) * visible_pairs(s, True, window) * h * b
        unshared, shared = kv_hbm_bytes(b, s, h, kvh, d, dv, window)
        report["ms"][layer] = dict(
            times=times, split_flops=flops, split_bound_ms=flops
            / BF16_FLOPS_PER_S * 1e3, kv_hbm_bytes_unshared=unshared,
            kv_hbm_bytes_shared=shared, clocks=clocks,
            split_tflops={n: flops / (sum(t) / len(t)) / 1e9
                          for n, t in times.items()})
        print(f"{layer} {(b, s, h, kvh, d, dv)} window={window} softcap={cap}"
              f": " + ", ".join(f"{n} " + " / ".join(f"{t:.4f}" for t in ts)
                                for n, ts in times.items()) + " ms")
        print(f"  split work {flops / 1e12:.3f} TFLOP, bound "
              f"{flops / BF16_FLOPS_PER_S * 1e3:.3f} ms; K/V from HBM "
              f"{unshared / 1e9:.3f} GB unshared, {shared / 1e9:.3f} GB "
              f"once a kv head; clocks {clocks}")
        del q, k, v, calls
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    if failed:
        print("flash_sm90_layouts: a build disagrees with the plain version "
              "or with the source", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
