#!/usr/bin/env python3
"""Two revisions of the f32 flash-attention forward (``flash_fwd.cu``) side
by side on one card.

    python3 scripts/flash_f32_revisions.py [--source OLD.cu] [--out report.json]

* ``--source`` (default: the shipped ``flash_fwd.cu``) names a revision of
  the kernel source, for example an older one taken from git
  (``git show <commit>:src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu``)
  into a git-ignored path such as ``build/parent/``.  It is built, and the
  shipped source too where the two differ: one ``nvcc`` each, started
  together, with ``kernels/build.py``'s flags.  Each build's registers and
  spills are printed.
* Each build's out and lse are held against ``flash_fwd_plain`` within
  ``chip_smoke.FLASH_TOL`` at ``chip_smoke.py``'s five small f32 cases and
  at its path shapes (gemma2-2b's global and local layers,
  recurrentgemma-9b's MQA layer, seamless-m4t-large-v2's three D 64
  shapes, MLA's d_qk / d_v 192 / 128 and 48 / 32); a build whose entry
  point takes no ``DV`` (an older source) skips the MLA shapes.
* At the path shapes the builds are timed in turns (source, shipped,
  shipped, source, then the cuts forth and back, then source, shipped,
  shipped, source again) with CUDA events, and the shipped build's kernels one
  by one with ``torch.profiler`` (ms a launch), beside the bytes of K and
  V hi + lo its main kernel streams through L2 and their rate.
* ``--cuts`` also builds the shipped source once for each text cut and
  times each (``--cut NAME``, repeatable, builds only those):
  ``heads_first`` and ``query_first`` launch the grid in one order at
  every shape, in place of the choice by kv heads against the CTAs in
  flight (they compute the same, only their time differs); ``cut_loads`` refills no ring stage after
  the first ones (the
  wgmmas run on stale tiles: the time without the L2 stream); ``cut_mma``
  issues no wgmma (the stream and the softmax alone); ``raw_split_consumers``
  and ``raw_split_producer`` bring each stage as half its bytes, as raw f32
  K and V would be, and split it into hi and lo in shared memory, by the
  consumer warpgroup before the stage's wgmmas or by the producer warp
  before it marks the stage full (in place: a raw V tile would also need
  a transpose, so this is the least such a design could cost).  Those
  four compute garbage: only their time means something.

Each source is called through its own ``extern "C"`` signature
(``build.c_params``), so revisions with other scratch arguments compare:
a pointer the signature names beyond q, k, v, o and lse gets a scratch
buffer from ``ops.split_buffer``.  Needs nvcc and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu"
OUT_DIR = ROOT / "build" / "flash_f32_revisions"
ENTRY = "flash_fwd_f32"


def entry_params(kb, text: str):
    """The entry point's (ctypes type, name) list; older sources declare
    it through a macro, ``FLASH_ENTRY(flash_fwd_f32, float)``, whose
    ``extern "C" int NAME(...)`` carries the parameters."""
    try:
        return kb.c_params(text, ENTRY)
    except KeyError:
        return kb.c_params(text.replace("\\\n", "\n"), "NAME")


# the split of one ring stage in place: its first half holds raw f32 (the
# bytes a raw K or V tile would bring), which THREADS threads from ID on
# split into hi (kept in place) and lo (the second half)
SPLIT_STAGE = r"""
        {
          float4* st = reinterpret_cast<float4*>(smem_raw + (sSt + s * C::STAGE - raw));
          for (int i = ID; i < C::HALF / 16; i += THREADS) {
            float4 hi, lo;
            split4(st[i], hi, lo);
            st[i] = hi;
            st[i + C::HALF / 16] = lo;
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
"""
HALF_LOAD = (
    "        mbar_expect_tx(full0 + 8 * s, C::STAGE);\n"
    "        bulk_load(sSt + s * C::STAGE, src + (int64_t)n * C::STAGE, "
    "C::STAGE,\n",
    "        mbar_expect_tx(full0 + 8 * s, C::HALF);\n"
    "        bulk_load(sSt + s * C::STAGE, src + (int64_t)n * C::STAGE, "
    "C::HALF,\n", 1)
PRODUCER = """    if (tid == NC) {
      const uint8_t* src = reinterpret_cast<const uint8_t*>(split) +
                           ((int64_t)(b * KVH + kvh) * nkb + kb_lo) * C::NCH *
                               (int64_t)C::STAGE;
      const int items = nblk * C::NCH;
      for (int n = 0; n < items; ++n) {
        const int s = n % STAGES;
        if (n >= STAGES) mbar_wait(empty0 + 8 * s, (n / STAGES - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, C::STAGE);
        bulk_load(sSt + s * C::STAGE, src + (int64_t)n * C::STAGE, C::STAGE,
                  full0 + 8 * s);
      }
    }
"""
# the producer warp splits: lane 0 loads a stage's raw half, completion on a
# barrier of its own (raw[s] = empty0 + 8 (STAGES + s)); the warp splits it
# and lane 0 then arrives on the stage's full barrier
PRODUCER_SPLITS = """    {
      const int lane = tid - NC;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(split) +
                           ((int64_t)(b * KVH + kvh) * nkb + kb_lo) * C::NCH *
                               (int64_t)C::STAGE;
      const int items = nblk * C::NCH;
      for (int n = 0; n < items; ++n) {
        const int s = n % STAGES;
        const uint32_t rawbar = empty0 + 8 * (STAGES + s);
        if (n >= STAGES) mbar_wait(empty0 + 8 * s, (n / STAGES - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(rawbar, C::HALF);
          bulk_load(sSt + s * C::STAGE, src + (int64_t)n * C::STAGE, C::HALF,
                    rawbar);
        }
        mbar_wait(rawbar, (n / STAGES) & 1);
""" + SPLIT_STAGE.replace("ID", "lane").replace("THREADS", "32") + """        __syncwarp();
        if (lane == 0) mbar_arrive(full0 + 8 * s);
      }
    }
"""

# text cuts of the shipped source: {name: [(old, new, occurrences)]}
CUTS = {
    "heads_first": [("const int qfast = in_flight[device] < QFAST_SHARE * KVH;",
                     "const int qfast = 0;", 1)],
    "query_first": [("const int qfast = in_flight[device] < QFAST_SHARE * KVH;",
                     "const int qfast = 1;", 1)],
    "cut_loads": [("        mbar_expect_tx(full0 + 8 * s, C::STAGE);\n",
                   "        if (n >= STAGES) {\n"
                   "          mbar_arrive(full0 + 8 * s);\n"
                   "          continue;\n"
                   "        }\n"
                   "        mbar_expect_tx(full0 + 8 * s, C::STAGE);\n", 1)],
    "cut_mma": [('  asm volatile(\n      "{\\n.reg .pred p;',
                 '  return;\n  asm volatile(\n      "{\\n.reg .pred p;', 2)],
    # K and V brought as raw f32 (half the bytes) and split in shared
    # memory: by the consumer warpgroup on its serial chain, before each
    # stage's wgmmas ...
    "raw_split_consumers": [
        HALF_LOAD,
        ("      mbar_wait(full0 + 8 * s, ph);\n",
         "      mbar_wait(full0 + 8 * s, ph);\n"
         + SPLIT_STAGE.replace("ID", "tid").replace("THREADS", "NC")
         + '        asm volatile("bar.sync 1, %0;\\n" ::"n"(NC) : "memory");\n',
         2)],
    # ... or by the producer warp, off that chain
    "raw_split_producer": [
        ("constexpr int BAR_BYTES = 256;", "constexpr int BAR_BYTES = 512;", 1),
        ("16 * STAGES <= BAR_BYTES", "24 * STAGES <= BAR_BYTES", 1),
        ("      mbar_init(empty0 + 8 * s, NC);\n",
         "      mbar_init(empty0 + 8 * s, NC);\n"
         "      mbar_init(empty0 + 8 * (STAGES + s), 1);\n", 1),
        (PRODUCER, PRODUCER_SPLITS, 1)],
}


def cut(text: str, name: str) -> str:
    for old, new, count in CUTS[name]:
        if text.count(old) != count:
            raise KeyError(f"{name}: {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    return text


def streamed_bytes(b, sq, sk, h, d, dv, causal, window, bq=64, bk=64):
    """Bytes of K and V hi + lo (8 B an element of each) the main kernel's
    CTAs of 64 query rows stream: every visible 64-key block."""
    blocks = 0
    for q0 in range(0, sq, bq):
        lo = max(0, q0 - window + 1) if window else 0
        hi = min(sk, q0 + bq) if causal else sk
        blocks += -(-hi // bk) - lo // bk
    return blocks * b * h * bk * (d + dv) * 8


def build_all(variants):
    """{name: source text} -> {name: (entry point, param names, ptxas)}."""
    from repro_torch.kernels import build as kb

    built = {}
    for name, (lib, log) in kb.build_sources(variants, "flash_fwd",
                                             OUT_DIR).items():
        params = entry_params(kb, variants[name])
        fn = getattr(lib, ENTRY)
        fn.restype = ctypes.c_int
        fn.argtypes = [t for t, _ in params]
        built[name] = (fn, [n for _, n in params], kb.ptxas_report(log))
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=str(SHIPPED))
    ap.add_argument("--out", default="")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cuts", action="store_true")
    ap.add_argument("--cut", action="append", default=[], choices=sorted(CUTS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_f32_revisions: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (FLASH_CASES, FLASH_ED_SHAPES, FLASH_MLA_SHAPES,
                            FLASH_PATH_SHAPES, FLASH_TOL, card_line,
                            kernel_ms, time_ms)
    from repro_torch.kernels.flash_attention import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    source = Path(args.source).read_text()
    shipped = SHIPPED.read_text()
    variants = {"source": source}
    if shipped != source:
        variants["shipped"] = shipped
    variants.update((n, cut(shipped, n)) for n in CUTS
                    if args.cuts or n in args.cut)
    built = build_all(variants)
    report = {"card": card, "source": args.source, "builds": {}}
    for name, (_, params, ptxas) in built.items():
        report["builds"][name] = {"ptxas": ptxas}
        print(f"{name}:\n  " + "\n  ".join(ptxas))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def qkv(b, sq, sk, h, kvh, d, dv):
        mk = lambda s, n, w: torch.randn((b, s, n, w), device="cuda",
                                         generator=gen)
        return mk(sq, h, d), mk(sk, kvh, d), mk(sk, kvh, dv)

    def caller(name, q, k, v, causal, window, cap):
        """A call of build ``name`` and its (out, lse)."""
        fn, params, _ = built[name]
        b, sq, h, d = q.shape
        sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
        out = torch.empty((b, sq, h, dv), device="cuda")
        lse = torch.empty((b, h, sq), device="cuda")
        given = dict(q=q, k=k, v=v, o=out, lse=lse)
        scalars = dict(B=b, H=h, KVH=kvh, Sq=sq, Sk=sk, D=d, DV=dv,
                       causal=int(causal), window=window, softcap=cap,
                       sm_scale=1.0 / d ** 0.5, device=q.device.index)
        for x, pre in ((q, "q"), (k, "k"), (v, "v"), (out, "o")):
            scalars.update(zip((pre + "sb", pre + "ss", pre + "sh"),
                               x.stride()[:3]))
        vals = []
        for p in params:
            if p in given:
                vals.append(given[p].data_ptr())
            elif p in scalars:
                vals.append(scalars[p])
            elif p == "stream":
                vals.append(torch.cuda.current_stream().cuda_stream)
            else:                          # a scratch buffer of the kernel
                given[p] = ops.split_buffer(b, kvh, sk, d, q.device, dv)
                vals.append(given[p].data_ptr())

        def call():
            err = fn(*vals)
            if err:
                raise RuntimeError(f"{name}: launch failed with code {err}")
        return call, (out, lse)

    def err_vs_plain(name, q, k, v, causal, window, cap):
        call, (out, lse) = caller(name, q, k, v, causal, window, cap)
        call()
        ref, ref_lse = ops.flash_fwd_plain(q, k, v, causal=causal,
                                           window=window, softcap=cap)
        torch.cuda.synchronize()
        ok = (torch.allclose(out, ref, rtol=FLASH_TOL, atol=FLASH_TOL)
              and torch.allclose(lse, ref_lse, rtol=FLASH_TOL,
                                 atol=FLASH_TOL))
        return ok, (out - ref).abs().max().item(), \
            (lse - ref_lse).abs().max().item()

    # the path shapes: (B, Sq, Sk, H, KV, D, DV, causal, window, softcap)
    paths = {layer: (b, s, s, h, kvh, d, d, True, window, cap)
             for layer, (b, s, h, kvh, d, window, cap)
             in FLASH_PATH_SHAPES.items()}
    paths.update((layer, (b, sq, sk, h, kvh, d, d, causal, 0, 0.0))
                  for layer, (b, sq, sk, h, kvh, d, causal)
                  in FLASH_ED_SHAPES.items())
    # the kernel's own dims (kernel_dims pads the smoke 48 / 32 to 64 / 32)
    paths.update((layer, (b, s, s, h, h, *ops.kernel_dims(d, dv), True, 0,
                          0.0))
                 for layer, (b, s, h, d, dv) in FLASH_MLA_SHAPES.items())
    takes_dv = {n for n in built if "DV" in built[n][1]}
    names = [n for n in built if n not in CUTS]
    checks, failed = [], False
    cases = [(f"{c[:5]} causal={c[5]} window={c[6]} softcap={c[7]}",
              (c[0], c[1], c[1], c[2], c[3], c[4], c[4], *c[5:]))
             for c in FLASH_CASES]
    cases += list(paths.items())
    for label, (b, sq, sk, h, kvh, d, dv, causal, window, cap) in cases:
        q, k, v = qkv(b, sq, sk, h, kvh, d, dv)
        row = {"case": label}
        for n in names:
            if dv != d and n not in takes_dv:
                continue
            ok, e_out, e_lse = err_vs_plain(n, q, k, v, causal, window, cap)
            row[n] = dict(ok=ok, out_err=e_out, lse_err=e_lse)
            failed |= not ok
        checks.append(row)
        print(json.dumps(row))
        del q, k, v
        torch.cuda.empty_cache()
    report["checks"] = checks

    order = (["source", "shipped", "shipped", "source"] if len(names) == 2
             else ["source", "source"])
    ship = "shipped" if "shipped" in built else "source"
    report["ms"], report["shipped_per_kernel_ms"] = {}, {}
    for layer, (b, sq, sk, h, kvh, d, dv, causal, window, cap) in \
            paths.items():
        q, k, v = qkv(b, sq, sk, h, kvh, d, dv)
        runs = [n for n in built if dv == d or n in takes_dv]
        calls = {n: caller(n, q, k, v, causal, window, cap)[0] for n in runs}
        times = {}
        cuts = [n for n in runs if n in CUTS]
        for n in [n for n in order if n in runs] + cuts + cuts[::-1] + [
                n for n in order[::-1] if n in runs]:
            times.setdefault(n, []).append(
                time_ms(torch, calls[n], args.iters))
        report["ms"][layer] = times
        print(f"{layer} {(b, sq, sk, h, kvh, d, dv)} causal={causal} "
              f"window={window} softcap={cap}: "
              + ", ".join(f"{n} " + " / ".join(f"{t:.4f}" for t in ts)
                          for n, ts in times.items()) + " ms")

        per = kernel_ms(torch, calls[ship], args.iters, "flash")
        report["shipped_per_kernel_ms"][layer] = per
        for n, t in per.items():
            print(f"  {ship} kernel {n}: {t:.4f} ms a launch")
        main_ms = [t for n, t in per.items() if "flash_fwd_tf32_kernel" in n]
        if main_ms:
            nbytes = streamed_bytes(b, sq, sk, h, d, dv, causal, window)
            report.setdefault("streamed", {})[layer] = dict(
                bytes=nbytes, main_ms=main_ms[0],
                tb_per_s=nbytes / main_ms[0] / 1e9)
            print(f"  main kernel streams {nbytes / 1e9:.3f} GB of K/V hi + "
                  f"lo: {nbytes / main_ms[0] / 1e9:.2f} TB/s")
        del q, k, v, calls
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    if failed:
        print("flash_f32_revisions: a build disagrees with the plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
