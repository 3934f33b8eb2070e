#!/usr/bin/env python3
"""Build the bf16 tensor-core flash forward in two thread layouts and time
both on one card.

    python3 scripts/flash_sm90_layouts.py [--out report.json]

* ``shipped``: ``flash_fwd_sm90.cu`` as it is: 256 threads, two
  warpgroups of 64 query rows, one of whose threads issues every TMA load.
* ``producer``: the same source turned into the warp-specialised layout:
  a third warpgroup (384 threads) whose first thread issues every TMA load
  after ``setmaxnreg.dec`` to 24 registers, while the two row warpgroups
  raise theirs with ``setmaxnreg.inc`` to 240.

For each it prints ptxas's register and spill lines per head dim, holds
the kernel against ``flash_fwd_plain`` at the main path's shapes (B 1,
S 8192, H 8 over 4, D 256, softcap 50, window 0 and 4096) under the bf16
checks of ``chip_smoke.py``, and times the two in turns (shipped,
producer, producer, shipped) with CUDA events.  Needs nvcc and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu"
OUT_DIR = ROOT / "build" / "flash_sm90_layouts"

# shipped -> producer warpgroup: (old, new) text, each present exactly once
PRODUCER_EDITS = [
    ("constexpr int NT = 256;", "constexpr int NT = 384;"),
    ("mbar_init(empty0 + 8 * s, NT);", "mbar_init(empty0 + 8 * s, 256);"),
    ("""  if (tid == 0) {
    mbar_expect_tx(q_bar, C::Q_BYTES);
    for (int c = 0; c < D / C::CE; ++c)
      tma_load_4d(sQ + c * BQ * SW, &tm_q, q_bar, c * C::CE, h, q0, b);
    for (int i = 0; i < min(nblk, C::STAGES); ++i) load_block(i);
  }

  {
""", """  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n");
    if (tid == 256) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
      for (int c = 0; c < D / C::CE; ++c)
        tma_load_4d(sQ + c * BQ * SW, &tm_q, q_bar, c * C::CE, h, q0, b);
      for (int i = 0; i < nblk; ++i) {
        const int s = i % C::STAGES;
        mbar_wait(empty0 + 8 * s, ((i / C::STAGES) & 1) ^ 1);
        load_block(i);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n");
"""),
    ("""      if (tid == 0 && i + C::STAGES < nblk) {
        mbar_wait(empty0 + 8 * s, (i / C::STAGES) & 1);
        load_block(i + C::STAGES);
      }
""", ""),
]


def producer_source(text: str) -> str:
    for old, new in PRODUCER_EDITS:
        if text.count(old) != 1:
            raise SystemExit(f"flash_fwd_sm90.cu changed; edit not found: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(name: str, text: str):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kb

    lib, log = kb.build_sources({name: text}, "flash_fwd_sm90",
                                OUT_DIR)[name]
    fn = lib.flash_fwd_sm90_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn, kb.ptxas_report(log)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_sm90_layouts: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import flash_fwd_plain
    from repro_torch.kernels.flash_attention.ops import _tma_strides

    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, time_ms

    card = card_line()
    print(card)
    shipped = SRC.read_text()
    fns, report = {}, {"card": card, "layouts": {}}
    for name, text in (("shipped", shipped),
                       ("producer", producer_source(shipped))):
        fns[name], lines = build(name, text)
        report["layouts"][name] = {"ptxas": lines}
        print(f"{name}:\n  " + "\n  ".join(lines))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    mk = lambda n: torch.randn((1, 8192, n, 256), device="cuda",
                               generator=gen).bfloat16()
    q, k, v = mk(8), mk(4), mk(4)
    out = torch.empty_like(q)
    lse = torch.empty((1, 8, 8192), device="cuda")

    def call(fn, window):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), 1, 8, 4, 8192, 8192, 256, *_tma_strides(q),
                 *_tma_strides(k), *_tma_strides(v), *out.stride()[:3], 1,
                 window, 50.0, 1 / 16.0, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with code {err}")

    ok = True
    for window in (0, 4096):
        ref, ref_lse = flash_fwd_plain(q, k, v, causal=True, window=window,
                                       softcap=50.0)
        for name, fn in fns.items():
            call(fn, window)
            torch.cuda.synchronize()
            good = (torch.allclose(out.float(), ref.float(), rtol=2 ** -7,
                                   atol=1e-5)
                    and torch.allclose(lse, ref_lse, rtol=1e-4, atol=1e-4))
            ok &= good
            report["layouts"][name][f"window{window}_ok"] = good
        del ref, ref_lse
        turns = [(n, time_ms(torch, lambda: call(fns[n], window),
                             args.iters, 3))
                 for n in ("shipped", "producer", "producer", "shipped")]
        for name in fns:
            ms = [t for n, t in turns if n == name]
            report["layouts"][name][f"window{window}_ms"] = ms
            print(f"window {window}: {name} {ms[0]:.4f} / {ms[1]:.4f} ms "
                  f"(checks {'pass' if report['layouts'][name][f'window{window}_ok'] else 'FAIL'})")
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
