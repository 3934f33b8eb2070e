#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py      # one CUDA card

1. Builds every CUDA kernel from this checkout's sources (one ``nvcc`` per
   source, all started together) and prints the compiler's register and
   spill counts (and any ptxas performance warning).
2. Holds each kernel against its plain PyTorch version on the card:
   flash attention on f32 (the split-TF32 tensor-core kernel) at head dims
   128 and 256 with GQA (MQA 16:1 too), causal, window, softcap and a
   ragged length (out, lse and autograd gradients within 1e-4; its split
   pass's K/V hi + lo bitwise), then at the paths' shapes (gemma2-2b's
   global and local layers, recurrentgemma-9b's MQA local layer) and at
   the encoder-decoder path's three D 64 shapes (the decoder's causal
   self-attention [1, 4096, 16, 64], the encoder's bidirectional one over
   1024 frames, the cross-attention of 4096 queries over 1024 frames;
   gradients too) and at MLA's d_qk != d_v (deepseek-v2-236b's [1, 4096,
   128] at 192 / 128, and the smoke config's [2, 64, 4] at 48 / 32, run
   zero-padded at the instantiated 64 / 32; gradients and the split
   bytes too) and at one query (a decode step's cross-attention: 4 x 1
   query over seamless's 1024 frames, 16 heads of 64, and over the VLM's
   1601 patches, 64 heads over 8 of 128; timed against
   ``scaled_dot_product_attention``), with its
   bound at the TF32 rate for the three products beside the CUDA-core
   bound and the kernel's registers and spills; the bucket
   update bitwise for AdamW and SGD, uniform and per-element, masked
   tail, fused zeroing; the int8 quantize, dequantize and bf16
   stochastic-rounding kernels bitwise, at 128, 1280 and 4096 elements
   with ragged NaN/inf tails, an all-zero row and two seeds, and on the
   main path's largest bucket (589,824,000 elements); flash attention on
   bf16 inputs through the tensor-core kernel (flash_fwd_sm90.cu) at
   head dims 32, 64, 128 and 256, MQA 16:1, bidirectional, S below one
   key block, windows below one key block, softcap on and off (out within
   one bf16 rounding step, lse 1e-4, gradients 1.6e-2 relative with
   max|g| / 128 absolute), then at the main path's global and local
   shapes under the same checks, timed in turns with compiled flex_attention (kernel, flex,
   kernel; the kernel must not be slower), with its TFLOP/s and share of
   the bound, then at MLA's d_qk != d_v (its (192, 128) instantiation at
   deepseek-v2-236b's [1, 4096, 128] causal, and the smoke 48 / 32 run
   by the 64 / 32 instantiation with q and k read at 48) under the same
   checks, timed in turns with one ``scaled_dot_product_attention`` call
   on the same bf16 inputs, its bound 2 (D + DV) flops a visible pair at
   the bf16 rate and the split work's (2 D + 4 DV) beside it; the small
   cases include (192, 128) and one square case at KV = H >= 40, where
   the grid runs query blocks first; the RG-LRU scan's forward and reverse-scan backward kernels
   bitwise, at (B, S, W) (2, 64, 128), (1, 128, 256), (3, 33, 100) and
   (1, 1, 4096) with and without h0 and an h_final cotangent (S 1 from h0
   is a decode step's scan), at serve_path's [4, 1024, 4096] and [4, 1,
   4096] from h0, and at the recurrent path's [1, 8192, 4096]; the RWKV-6 WKV forward and backward
   kernels within max |diff| / max |plain| <= 1e-4 on
   o, S_final and every gradient, the forward's S_final and chunk-start
   states and the backward's ds0 bitwise, at (B, S, H, D) (2, 64, 2, 32),
   (1, 96, 4, 64), (3, 40, 2, 64), (1, 32, 1, 64), (1, 1000, 3, 64), (1,
   5, 2, 64), (1, 1, 2, 64), (3, 70, 5, 32) and, for 1, 7, 8, 9 and 33
   chunks around the scans' 8-chunk look-ahead, (1, 32, 2, 64), (1, 224,
   2, 64), (1, 256, 2, 32), (1, 280, 2, 64), (2, 1056, 2, 64), with and
   without s0 and a dS_final cotangent (S 1 from s0 is a decode step's
   WKV, S 5 a ragged prefill), and at the RWKV path's [1, 8192,
   32, 64] (where each direction's own traffic is printed beside its
   bound's, and each launch of the two C calls is timed).  Times
   each kernel, its plain version and a PyTorch library call that
   computes the same function and that the port never calls (compiled
   ``flex_attention`` with the softcap as ``score_mod`` and the causal /
   window mask as a block mask, on f32 and on bf16 inputs;
   ``torch._fused_adamw_``, which moves 28 B an element to the kernel's
   32 as it leaves the gradients unzeroed, so both bytes bounds are
   printed; ``torch.mul`` of the int8 rows by their scales
   for dequantize; none for quantize, stochastic rounding, the scan and
   the WKV), beside the least time the card could take.  Then the bucket
   update on the spans of the sharded flat engine: the main path's layout
   rebuilt at 4 shards, its largest bucket (589,824,000 elements) and its
   bucket with per-element hyperparameters updated span by span through
   ``apply_bucket_updates(shard_id=s)`` with NaN/inf in the last span's
   padded gradient tail, reassembled bitwise to the full-buffer kernel
   apply with clipping off and within 1e-6 with it on (the norm summed on
   the host from the spans' sums), and bf16sr spans bitwise against the
   plain version.
3. Drives the DeFT main path through ``repro_torch.launch.train.train``:
   gemma2-2b at full width with its depth cut to 8 of 26 layers, batch 1,
   sequence 8192 (the 4096 window really masks), coverage rate 1.8.  The
   first schedule period runs once with the plain versions forced; the
   main run (launch counters zeroed just before it) must agree with it
   (every bucket's params within 1e-4, at most 1000 elements beyond
   1e-5), launch each kernel exactly as often as its layers and updates
   say (flash twice per attention layer per step: forward and remat
   recompute; the bucket update once per bucket per update), issue
   exactly ``phase_collectives`` per phase, and keep the loss finite.
   Then the same configuration on the sharded flat engine (``fsdp=True``,
   one shard on the one card, the gather skip on: the period-3 schedule
   reuses the gather at one position), held the same way to its own plain
   run and to the replicated run (step-0 loss bitwise, params after the
   first period within the same limits), with the same launches and
   exactly ``phase_collectives_sharded`` per phase; its peak memory is
   printed beside the replicated run's.  Then the same sharded run with
   its param gathers streamed into the forward (``decoupled=True``,
   ``decoupled_path``), every loss and param bitwise the sharded run's,
   printing the buckets' first-touch order and the param gathers issued
   before the forward's first compute; then ``chain_path``: the
   replicated run and the streamed sharded run with ``secondary_chain=
   (0,)``, every synced bucket forced onto the secondary link and every
   param gather onto link 1 (``route_all_secondary``), each bitwise its
   unrouted run, with its collectives chained and no P2P round (one rank:
   the chain is the identity).  Each of these runs has its own plain run,
   launch counts and collectives checked as above.
3a. Drives the two baseline engines on the main path's configuration
   (``baselines_path``, after the paths of 3-7a): the per-leaf steps
   (``make_deft_step_fns``) for two schedule periods, then the tree-state
   engine (``DeftRuntime(flat_state=False)``) for two, each from the
   seed-0 params over the main path's batches and held to the main path's
   stored run (the step-0 loss equal, the params after the first period
   within the limits above, whether bitwise anyway printed), with the
   counters zeroed just before: 16 f32 flash launches a step and no
   bucket update (both update through ``apply_updates_``), the per-leaf
   steps issuing one collective a synced leaf and one a metric (the loss,
   ce and aux), the tree engine the flat engine's; each prints its median
   step, tokens/s, peak and collectives per phase beside the main path's.
4. Drives DeFT's precision path the same way, with int8 gradient wires on
   every bucket and a bf16sr resident master (forward and backward in
   bf16): its first steps once with every plain version forced, then the
   run with the counters zeroed, which must launch all five kernels
   (quantize = dequantize = synced buckets, stochastic rounding = buckets
   x (init + updates), the bf16 tensor-core flash twice per attention
   layer per step and the f32 flash never), keep every master buffer
   bf16 and the loss finite, and agree with the plain run within the
   limits PERF.md gives with their readings.  At coverage rate 1.8 the
   int8 wire leaves a one-step period; a second run at 4 x 1.8, whose
   schedule merges and delays updates and rotates generations, is held
   to the same checks over its first period.  A third runs that delayed
   configuration on the sharded flat engine with bf16 compute and the
   gather skip on, held to the same limits against its plain run, where
   every gathered bucket's int8 values and scales also go through the
   quantize and dequantize kernels (quantize = dequantize = synced plus
   gathered buckets) and the collectives equal
   ``phase_collectives_sharded``.  A fourth streams that run's gathers
   (``decoupled_precision_path``): bitwise the third, with the same
   launches.
5. Drives recurrentgemma-9b (Griffin) the same way as 3: full width
   (d_model and lru_width 4096, MQA 16 heads over 1, head_dim 256, d_ff
   12288, window 2048), depth cut to 6 of 38 layers (two periods of
   rglru, rglru, local attention), 8 steps, held to the same limits
   against its plain run; per step it must launch the scan forward 8
   times (4 RG-LRU layers, forward and recompute), its backward 4 times
   and flash 4 times.
6. Drives rwkv6-1.6b the same way at full width and full depth (d_model
   2048, 32 time-mix heads of 64, d_ff 7168, vocab 65536, 24 of 24
   layers), 8 steps (two periods), held to the same limits against its
   plain run with a limit of its own: first one step's per-leaf gradients
   through the kernels, the plain pair and a float64 WKV, the kernels'
   no farther from the float64 ones than twice the plain pair's; then
   every param within 1e-2 and at most 1% of any bucket beyond 1e-4
   after the first period (see RWKV_PARAM_MAX_DIFF).  Per step it must
   launch the WKV forward 48 times (forward and recompute), its backward
   24 times and flash never.  Each path
   prints its parameter count as the sum of its leaves beside
   ``cfg.total_params()``'s formula (which undercounts rwkv6).
7. Drives seamless-m4t-large-v2 (``encdec_path``) the same way as 3, at
   full width and full depth: 24 encoder and 24 decoder layers, d_model
   1024, 16 heads of 64, d_ff 8192, vocab 256,206, tied embeddings,
   layernorm, a plain GELU MLP; sequence 4096 over the config's 1024 stub
   frames (``make_batch``'s memory), 2 x period + 2 steps, held to the
   same limits against its plain run.  Per step it must launch flash 120
   times: 4 in each decoder layer (self and cross, forward and remat
   recompute) and 1 in each encoder layer (no remat).  Then
   ``encdec_precision_path``: the same config on its default (replicated)
   engine on the delayed precision path (int8 wires on every bucket, a
   bf16sr master, bf16 compute, 4 x 1.8 coverage rate), held to the
   precision limits against its plain run over PREC_REF_STEPS steps.  The
   stub memory stays f32 as JAX's does, so jnp's promotion runs the
   encoder and the cross-attention K/V in f32 beside the bf16 params: per
   step the bf16 flash launches 48 times (the decoder's self-attention,
   forward and recompute) and the f32 flash 72 (each cross-attention,
   forward and recompute, and the encoder), and one forward records the
   encoder's output and the cross K/V f32, each cross-attention's output
   and the decoder's residual bf16.
7a. Drives deepseek-v2-236b (``mla_path``) the same way as 3, on its
   default sharded engine at one shard, at full width cut to its dense
   layer 0: MLA (128 heads, q_lora 1536, kv_lora 512, d_qk 192 over d_v
   128) and the 12288-wide SwiGLU, vocab 102,400 untied; sequence 4096,
   MLA_STEPS steps, held to the same limits against its plain run, peak
   under 80 GB, the flash twice a step; then ``mla_precision_path``, the
   same cut on the delayed precision path (as ``encdec_precision_path``)
   on its sharded engine at one shard, held to the precision limits, peak
   under 80 GB, the bf16 flash at its (192, 128) instantiation twice a
   step and the f32 flash never.  Then ``moe_smoke_path``:
   deepseek-v2-236b-smoke (MLA 48 / 32 + MoE, 4 experts top-2, 1 shared)
   and llama4-maverick-400b-a17b-smoke (top-1 MoE) at smoke size on their
   sharded engines, each run twice bitwise equal (losses, aux and params)
   and held to its plain run; each step's aux loss is printed.  Then
   ``moe_width_phase``: one deepseek-v2-236b MoE FFN at its published
   widths (160 experts of 1536, top-6, 2 shared, d_model 5120; 3.8 B
   params) over 4096 tokens, forward and backward twice bitwise equal and
   within MOE_WIDTH_TOL of a float64 reference in out, aux and every
   gradient, some queues overflowing; prints its ms and peak.
8. Checkpoints and resumes mid-cycle (``checkpoint_path``,
   ``checkpoint_precision_path``): the main path's configuration and the
   sharded delayed precision run's (int8 wires, bf16sr master, bf16
   compute, the gather skip) run through ``train`` up to cycle position 2
   (where ``fut`` holds a generation and the gather cache is read), go
   through ``state_to_tree`` and the checkpoint module's ``encode`` into
   host memory (the full-width state would take tens of minutes to
   deflate to disk), come back on a fresh runtime through ``decode``,
   ``tree_to_state`` and ``reset_cycle``, and finish the period bitwise
   the stored uninterrupted runs (``main_path``,
   ``sharded_precision_path``), the peak within the stored run's plus one
   bucket; each prints its bytes, encode and decode seconds and host
   memory.  Then real files at smoke size through ``train(ckpt=...)``:
   saved every 2 steps, resumed, and resumed again after truncating the
   newest npz (falling back to the step before), every resumed loss
   bitwise the uninterrupted run's; and the host's
   ``np.savez_compressed`` rate on 50,000,000 random f32 values with
   the full-width disk save it implies.
9. Drives the adaptive control plane on the card (``adapt_path``,
   ``adapt_precision_path``): the main path's configuration and the
   sharded delayed precision run's through ``train(adapt=True)`` with the
   tracer on, the copied controller fed the synthetic walls of a 3x
   bandwidth drop at step 4 and a repartitioner (where its replan keeps
   the partition, the planner's partition at the first of 3, 10, 30, 100
   x 200,000 elements that differs is staged at the same step), until
   one period of the new schedule has passed after the swap.  One
   layout-changing hot swap must land on a cycle boundary, re-packing the
   resident state component by component; every step issues its
   schedule's collectives and every kernel launches as its layers,
   updates and layouts say; the Chrome trace (``chiprun_out/
   adapt_trace.json``, ``adapt_precision_trace.json``) carries the
   planned wire bytes on both sides of the swap; each run's peak stays
   within its stored run's plus the larger of one state component and
   the update's f32 temporaries of the new layout's largest bucket, and
   the allocations live at the peak of the swap's window (the install
   and the new layout's first step) are named; and every loss and param
   is bitwise a run that switches layouts by hand (``repack_state``
   between two sibling runtimes).  Prints the replan and swap steps, the
   buckets, the elements moved, ``repack_s``, the step time on both sides
   and the peak.
10. Drives the elastic control plane's bottom rungs on the card (one
   card is one rank, so scale-downs across ranks and straggler detection
   are held on CPU gloo ranks only): ``elastic_fallback_path`` and
   ``elastic_fallback_precision_path``, the sharded f32 run and the
   sharded delayed precision run to the first cycle boundary after a
   period and a step, then ``migrate_state`` onto ``spawn(fsdp=False)``
   (the fallback-replicated move) and two more periods, each held to its
   stored runs before the move and bitwise, after it, a replicated
   runtime rebuilt from the pre-move snapshot; the wire policy and
   master unchanged, each step's collectives and each kernel's launches
   as the two engines' schedules say, the peak within the stored sharded
   run's plus one component; prints ``repack_s``, ``migrate_s``, the
   peak and the step time before and after.  Then ``elastic_halt_phase``
   at smoke size through ``train(elastic=True, elastic_drop_step=4,
   ckpt=...)``: the only shard drops, the run halts with the emergency
   checkpoint, and ``train(resume=True)`` finishes it bitwise an
   uninterrupted run; prints the save and restore times.
11. Serves (``serve_path``) recurrentgemma-9b at full width and full
   depth (38 layers: 26 RG-LRU, 12 local attention at window 2048, MQA 16
   heads over 1 of 256; 8,578,199,552 params in f32) through
   ``repro_torch.launch.serve.serve``: 4 requests of a 1024-token prompt, 64
   greedy tokens each (one prefill, 63 decode steps), an f32 cache.  Every
   served position's logits (the prefill's last, each decode step's)
   against the training forward on the plain versions (no kernel) over
   the prompt plus the generated tokens, the head applied to those
   positions: max |diff| / max |ref| <= SERVE_BOUND, the bound of the JAX
   package's decode-equivalence test.  During ``serve`` the RG-LRU scan
   kernel launches 26 x 64 times (once a layer at the prefill and at each
   decode step, from the carried h0) and no other kernel (the cached
   attention is plain, as it is plain jnp in JAX); prints prefill ms,
   decode ms a token, tokens/s and the peak beside the card, and a
   profile of the prefill and of 8 decode steps (device ms by kernel
   kind, the decode's idle share).  Then ``serve_smoke_path``: the seven
   families of that test (qwen3-4b, gemma2-2b, deepseek-v2-236b with
   MLA's absorbed decode and MoE, rwkv6-1.6b, recurrentgemma-9b,
   seamless-m4t-large-v2, llama-3.2-vision-90b, and the VLM again at 5
   layers, one gated cross block with its gate opened) at smoke size (B
   2, S 24, prefill 16, capacity factor 16), each served through its
   kernels (the WKV at S 16 and 1 from s0, the scan from h0, the flash in
   the encoder and in each cross-attention, a decode step's one query
   included) and held within the same bound of its forward and of the
   same served run on the plain versions, then gemma2's ring cache
   decoding 134 steps past its 64-token window.  The flash phase (2.)
   holds the f32 kernel at that one query (seamless's and the VLM's
   cross-attention at decode); the scan at S 1 with h0 and the WKV at S 1
   with s0 are among the kernels' small cases there, and the scan phase
   holds serve_path's own scans bitwise: the prefill's [4, 1024, 4096]
   and a decode step's [4, 1, 4096], each from h0.  The cached attention's
   price for a later decode kernel is ``scripts/serve_attention_price.py``.
11a. Drives the 'model' axis at data 1 x model 2 (``tp_path``): this
   process becomes rank 0 of a gloo group (its NCCL group destroyed) and
   spawns rank 1, both on the one card; each holds its shards of the
   leaves the port's ``spec_tree`` splits over 'model' and trains its
   cuts in turn through ``train(data=1, model=2)``, tensor-parallel, every
   launch counter zeroed just before each.  First the main path's
   configuration for one period of its schedule (the f32 flash on its
   heads 16 times a step, the bucket update on buckets of its shards as
   often as the main path), held to the main path's stored run.  Then the
   recurrent and encoder-decoder families, each at full width: one
   pattern period of recurrentgemma-9b (lru 2048 and 8 gate blocks a
   rank, 8 query heads over the gathered kv head: the f32 flash at 8:1),
   4 layers of rwkv6-1.6b (16 WKV heads a rank) and 2 + 2 of
   seamless-m4t-large-v2 (8 heads of 64 a rank in the encoder, the
   decoder and the cross-attention), one schedule period each, at most 4
   steps, each held to a model-1 run of its cut made first in this
   process.  Per cut: the losses equal across the ranks and within 1e-4
   relative of the reference's (another order of the row-parallel sums),
   the params gathered over 'model' after the steps within the limits of
   3 (rwkv6: of 6), every launch as the layers and updates say with the
   scan, the WKV, the flash and the bucket update launched where the cut
   has them, the data collectives ``phase_collectives``, and the two
   ranks' peaks together below 80 GB; each rank's peak, the median step
   and the share of the steps in the 'model' collectives are printed.
12. Prints the kernels line, the card's name and power limit, and last the
   contract line ``{"ok": true, "device": {...}}``.  Any failure, or no
   card, exits non-zero before that line.  The full report goes to
   ``chiprun_out/chip_smoke.json``.

Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
TF32_FLOPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
FLASH_TOL = 1e-4              # f32, another summation order than cuBLAS
BF16_OUT_RTOL = 2 ** -7       # bf16 out: one rounding step of bf16
BF16_GRAD_RTOL = 1.6e-2       # bf16 grads, with atol max|g| / 128
PARAM_TOL = 1e-5              # per-element agreement after an update
PARAM_MAX_DIFF = 1e-4         # no param may differ more than this ...
PARAM_MAX_OVER = 1000         # ... and at most this many beyond PARAM_TOL
TP_MODEL = 2                  # tp_path: the 'model' axis, two ranks on the card
TP_TIMEOUT_S = 180            # its gloo collectives' limit
ARCH, N_LAYERS, SEQ, BATCH = "gemma2-2b", 8, 8192, 1
COVERAGE_RATE, PARTITION_ELEMS, LOSS_CHUNK, LR = 1.8, 200_000, 1024, 1e-3
# the precision path: int8 wires, bf16sr master, its steps and the window
# compared with the plain run.  At coverage rate 1.8 the int8 wire makes the
# planner drop to period 1; at 4 x 1.8 its schedule again merges and delays
# updates (period 3, update_k 2), so a second run drives the quantize and
# rounding kernels through those edges too.
WIRE, MASTER, PREC_STEPS, PREC_REF_STEPS = "int8", "bf16sr", 6, 3
DELAYED_COVERAGE_RATE = 4 * COVERAGE_RATE
# the recurrent path: recurrentgemma-9b (Griffin) at full width, depth cut to
# two periods of (rglru, rglru, local_attn), 8 steps (two DeFT schedule
# periods at coverage rate 1.8); its local-attention window
RG_ARCH, RG_LAYERS, RG_OF_LAYERS, RG_STEPS = "recurrentgemma-9b", 6, 38, 8
RG_WINDOW = 2048
RG_WIDTH = 4096                 # lru_width: the scan's W
# the f32 flash forward's small cases: (B, S, H, KV, D, causal, window, softcap)
FLASH_CASES = [
    (2, 333, 8, 4, 256, True, 100, 50.0),   # ragged S, window, softcap
    (1, 520, 8, 4, 256, True, 0, 50.0),     # gemma2 global layer
    (2, 200, 8, 2, 128, True, 0, 0.0),      # qwen3 head dim, GQA 4:1
    (2, 130, 4, 4, 128, False, 0, 0.0),     # bidirectional, ragged
    (1, 300, 16, 1, 256, True, 64, 0.0),    # recurrentgemma MQA 16:1
]
# the bf16 flash forward's small cases: key blocks of 64 at D = 256, of
# 128 below; 128 query rows per CTA;
# (B, S, H, KV, D, causal, window, softcap[, DV])
FLASH_BF16_CASES = [
    (2, 333, 8, 4, 256, True, 100, 50.0),   # ragged S, window, softcap
    (1, 520, 8, 4, 256, True, 0, 50.0),     # gemma2 global layer
    (2, 200, 8, 2, 128, True, 0, 0.0),      # qwen3 head dim, GQA 4:1
    (2, 130, 4, 4, 128, False, 0, 0.0),     # bidirectional, ragged
    (1, 300, 16, 1, 256, True, 64, 0.0),    # recurrentgemma MQA 16:1
    (2, 128, 4, 2, 32, True, 0, 0.0),       # D 32: 64-byte swizzle
    (2, 300, 4, 1, 32, True, 90, 30.0),     # window < key block
    (2, 100, 4, 4, 64, False, 0, 0.0),      # S < key block
    (2, 257, 8, 2, 64, True, 77, 50.0),     # window < key block, ragged
    (2, 40, 8, 8, 128, True, 0, 50.0),      # S < key block, softcap
    (2, 150, 8, 4, 256, True, 37, 0.0),     # window < key block
    # KV = H >= 40: more kv heads than 132 CTAs in flight share four
    # ways, so the grid runs query blocks first; MLA's (192, 128) with
    # its 2 stages of 128 keys, and one square case
    (1, 333, 40, 40, 192, True, 0, 0.0, 128),    # ragged S
    (2, 100, 48, 48, 192, False, 0, 0.0, 128),   # S < key block
    (1, 256, 40, 40, 192, True, 0, 0.0, 128),    # blocks = stages
    (2, 200, 40, 40, 192, False, 0, 0.0, 128),   # blocks = stages, ragged
    (1, 520, 40, 40, 192, True, 77, 0.0, 128),   # window < key block
    (1, 300, 40, 40, 192, True, 0, 50.0, 128),   # softcap
    (1, 300, 40, 40, 128, True, 100, 50.0),      # square, query first
]
# the paths' attention shapes, all causal: (B, S, H, KV, D, window, softcap)
# for gemma2-2b's global and local layers (8 heads over 4, softcap 50) and
# recurrentgemma-9b's local attention layer (MQA 16 over 1, no softcap)
FLASH_PATH_SHAPES = {
    "global": (BATCH, SEQ, 8, 4, 256, 0, 50.0),
    "local": (BATCH, SEQ, 8, 4, 256, 4096, 50.0),
    "recurrentgemma": (BATCH, SEQ, 16, 1, 256, RG_WINDOW, 0.0),
}
# the encoder-decoder path: seamless-m4t-large-v2 at full width and full
# depth (24 encoder and 24 decoder layers), sequence 4096 (the train_4k
# length) over the config's 1024 stub frames; 2 x period + 2 steps.  Its
# f32 flash shapes, all D 64 over 16 heads: the decoder's causal
# self-attention, the encoder's bidirectional one and the decoder's
# cross-attention (queries over the sequence, keys over the frames):
# (B, Sq, Sk, H, KV, D, causal)
ED_ARCH, ED_LAYERS, ED_ENC_LAYERS, ED_SEQ, ED_FRAMES = (
    "seamless-m4t-large-v2", 24, 24, 4096, 1024)
FLASH_ED_SHAPES = {
    "encdec_self": (BATCH, ED_SEQ, ED_SEQ, 16, 16, 64, True),
    "encdec_encoder": (BATCH, ED_FRAMES, ED_FRAMES, 16, 16, 64, False),
    "encdec_cross": (BATCH, ED_SEQ, ED_FRAMES, 16, 16, 64, False),
}
# the MLA path: deepseek-v2-236b cut to its dense layer 0 (MLA + the
# 12288-wide SwiGLU) at full width, sequence 4096 (train_4k), batch 1, on
# its default sharded engine at one shard, MLA_STEPS steps (three periods).
# Its f32 flash shape, causal, d_qk = qk_nope + qk_rope 192 over d_v 128,
# 128 heads each with its own K and V; and the smoke config's 48 / 32 (run
# zero-padded at 64 / 32) at moe_smoke_path's batch and sequence:
# (B, S, H, D, DV)
MLA_ARCH, MLA_LAYERS, MLA_OF_LAYERS, MLA_SEQ, MLA_STEPS = (
    "deepseek-v2-236b", 1, 60, 4096, 12)
MOE_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
MOE_BATCH, MOE_SEQ, MOE_STEPS = 2, 64, 6
# one deepseek-v2-236b MoE FFN at its published widths over the JAX
# package's train_4k sequence, held against a float64 reference: each
# tensor's max |diff| over its max |f64| element.  A token sent to a wrong
# slot or weighted wrongly moves out and the expert gradients by a tenth
# of that scale or more; f32 sums over d_model 5120 stay near 1e-6.
MOE_WIDTH_SEQ = 4096
MOE_WIDTH_TOL = 1e-4
FLASH_MLA_SHAPES = {
    "mla": (BATCH, MLA_SEQ, 128, 192, 128),
    "mla_smoke": (MOE_BATCH, MOE_SEQ, 4, 48, 32),
    # a rank's at model 2 (tp_path's MLA cut): 64 of the 128 heads
    "mla_model2": (BATCH, MLA_SEQ, 64, 192, 128),
}
# tp_path's family and smoke cuts at model 2, a rank's attention:
# recurrentgemma-9b's 8 query heads over the gathered kv head (D 256,
# window 2048), seamless-m4t-large-v2's 8 heads of 64 (self, encoder,
# cross), and at the MoE smoke batch and sequence deepseek-v2-236b-smoke's
# 2 MLA heads at 48 / 32, llama4's and the VLM's 2 self-attention heads of
# 32 and the VLM's gated cross-attention over its 16 stub tokens, each held
# to the plain version with its gradients:
# (B, Sq, Sk, H, KV, D, causal, window[, DV])
FLASH_TP_SHAPES = {
    "recurrentgemma_model2": (BATCH, SEQ, SEQ, 8, 1, 256, True, RG_WINDOW),
    "encdec_self_model2": (BATCH, ED_SEQ, ED_SEQ, 8, 8, 64, True, 0),
    "encdec_encoder_model2": (BATCH, ED_FRAMES, ED_FRAMES, 8, 8, 64, False,
                              0),
    "encdec_cross_model2": (BATCH, ED_SEQ, ED_FRAMES, 8, 8, 64, False, 0),
    "mla_smoke_model2": (MOE_BATCH, MOE_SEQ, MOE_SEQ, 2, 2, 48, True, 0, 32),
    "smoke_self_model2": (MOE_BATCH, MOE_SEQ, MOE_SEQ, 2, 2, 32, True, 0),
    "vlm_cross_smoke_model2": (MOE_BATCH, MOE_SEQ, 16, 2, 2, 32, False, 0),
}
# serving: recurrentgemma-9b at full width and full depth (38 layers: 26
# RG-LRU, 12 local attention), 4 requests of a 1024-token prompt, 64 tokens
# generated greedily (one prefill, 63 decode steps), an f32 cache; each
# served position's logits against the training forward's, max |diff| /
# max |ref| <= SERVE_BOUND (the bound of the JAX package's
# tests/test_decode_equivalence.py).  Then the seven families of that test at
# smoke size (B 2, S 24, prefill 16, capacity factor 16) and gemma2's ring
# decode past its smoke window (one prompt token, 2 x 64 + 6 decode steps).
SERVE_ARCH, SERVE_LAYERS, SERVE_RGLRU = "recurrentgemma-9b", 38, 26
SERVE_REQUESTS, SERVE_PROMPT, SERVE_GEN = 4, 1024, 64
SERVE_BOUND = 2e-4
# (arch, smoke layers): at smoke size the VLM's 3 layers hold no gated cross
# block, so it runs at 5 (one pattern period) with its gate opened to 0.5
SERVE_FAMILIES = (("qwen3-4b", 2), ("gemma2-2b", 2), ("deepseek-v2-236b", 2),
                  ("rwkv6-1.6b", 2), ("recurrentgemma-9b", 2),
                  ("seamless-m4t-large-v2", 2), ("llama-3.2-vision-90b", 2),
                  ("llama-3.2-vision-90b", 5))
SERVE_GATE = 0.5
SERVE_SMOKE = dict(batch=2, seq=24, prefill=16, capacity_factor=16.0)
# the f32 flash at one query: the cross-attention of a decode step, over
# seamless-m4t-large-v2's 1024 frames (16 heads of 64) and over
# llama-3.2-vision-90b's 1601 patches (64 heads over 8 of 128), at
# serve_path's batch: (B, Sq, Sk, H, KV, D, causal)
FLASH_DECODE_SHAPES = {
    "encdec_cross_decode": (SERVE_REQUESTS, 1, ED_FRAMES, 16, 16, 64, False),
    "vlm_cross_decode": (SERVE_REQUESTS, 1, 1601, 64, 8, 128, False),
}
# the RWKV-6 path: rwkv6-1.6b at full width and full depth (24 of 24 layers),
# 8 steps (two DeFT schedule periods at coverage rate 1.8); its time-mix has
# 32 heads of size 64.  The WKV kernels against the plain pair: both f32,
# with another summation order inside the small products, so max |diff| /
# max |plain| <= 1e-4 for o, S_final and every gradient.
RWKV_ARCH, RWKV_LAYERS, RWKV_STEPS = "rwkv6-1.6b", 24, 8
RWKV_HEADS, RWKV_HEAD_SIZE = 32, 64
RWKV_TOL = 1e-4
# rwkv6-1.6b's params against its plain run.  At this init the model's
# backward amplifies the WKV's f32 rounding ~1e5-fold: one step's per-leaf
# gradients differ kernel vs plain by up to 1.5e-2 of max |g|, and the plain
# run itself differs from a float64 WKV by 2.6e-2 (PERF.md).  AdamW then
# steps the elements whose gradient sits inside that noise by up to ~lr
# apart: after one period the readings were max |diff| 2.75e-3 and at most
# 0.025% of a bucket beyond 1e-4.  A bucket whose update went wrong moves
# nearly all its elements by ~lr.  So: every param within 1e-2, and at most
# 1% of any bucket's elements beyond 1e-4.
RWKV_PARAM_MAX_DIFF = 1e-2
RWKV_BUCKET_SHARE = 1e-2
# ``tp_path``'s cuts at data 1 x model TP_MODEL, (arch, depth overrides, of
# layers, seq, kind): the main path's, then the recurrent and
# encoder-decoder families at full width (one pattern period of
# recurrentgemma-9b, 4 of rwkv6-1.6b's layers, 2 + 2 of
# seamless-m4t-large-v2's), each of those one schedule period, at most
# TP_MAX_STEPS steps, held to a model-1 run of the same cut made first in
# the same call; then the FSDP archs: deepseek-v2-236b's dense layer 0 at
# full width on its sharded engine (``mla_path``'s cut, held to its stored
# run), one of its MoE FFNs at published width (``moe_width_phase``'s
# input, forward and backward, held to its model-1 result), and the three
# FSDP archs' smoke configs at ``moe_smoke_path``'s batch and sequence
# (the VLM at one pattern period of 5 layers, so that its gated cross block
# is there), each held to a model-1 run made first.  ``kind``: "full" (the
# config at full width), "smoke" (``reduce_for_smoke``) or "moe_width".
TP_MAIN_CUT = (ARCH, dict(n_layers=N_LAYERS), 26, SEQ, "full")
TP_FAMILY_CUTS = (
    (RG_ARCH, dict(n_layers=3), RG_OF_LAYERS, SEQ, "full"),
    (RWKV_ARCH, dict(n_layers=4), RWKV_LAYERS, SEQ, "full"),
    (ED_ARCH, dict(n_layers=2, n_encoder_layers=2), ED_LAYERS, ED_SEQ,
     "full"),
)
VLM_ARCH = "llama-3.2-vision-90b"
TP_MLA_CUT = (MLA_ARCH, dict(n_layers=MLA_LAYERS), MLA_OF_LAYERS, MLA_SEQ,
              "full")
TP_MOE_WIDTH_CUT = (MLA_ARCH, {}, MLA_OF_LAYERS, MOE_WIDTH_SEQ, "moe_width")
TP_SMOKE_CUTS = (
    (MLA_ARCH, {}, 2, MOE_SEQ, "smoke"),
    ("llama4-maverick-400b-a17b", {}, 2, MOE_SEQ, "smoke"),
    (VLM_ARCH, dict(n_layers=5), 5, MOE_SEQ, "smoke"),
)
TP_MAX_STEPS = 4
TP_CHILD_TIMEOUT_S = 900      # rank 1's limit over the cuts
# the MoE FFN's expert gradients go from rank 1 to rank 0 over gloo in
# slices of this many experts (252 MB at deepseek-v2-236b's widths)
TP_MOE_CHUNK = 8
CARD_BYTES = 80e9             # the two ranks' peaks together stay below it
# limits against the plain run, from two runs on two cards that read loss
# rel 1.6e-4 and 3,353,277 params (0.28%) beyond 1e-4 + |p| / 128 (one
# bf16 ulp at the value) both times, and params max |diff| 2.69e-3 (PERF.md)
PREC_LOSS_RTOL = 2e-3
PREC_PARAM_MAX_DIFF = 1e-2    # in every bucket
PREC_PARAM_MAX_OVER = 1e-2    # share of all params beyond one bf16 ulp ...
PREC_BUCKET_MAX_OVER = 0.1    # ... and of any one bucket's
# the sharded flat engine: the bucket update on the spans of a layout of
# SHARDS shards, held to the full-buffer apply within the JAX package's own
# bound with clipping on (the squared norm sums in another order); the
# sharded paths run at one shard on the one card
SHARDS, SHARD_CLIP_TOL = 4, 1e-6


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kernel_ms(torch, fn, iters: int, match: str) -> dict:
    """Device time a launch of each kernel whose name holds ``match``, over
    ``iters`` calls of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if match in e.key:
            t = getattr(e, "device_time_total", None)
            per[e.key] = (e.cuda_time_total if t is None else t) / 1e3 / e.count
    return per


def flex_call(torch, q, k, v, window: int, cap: float, causal: bool = True):
    """One compiled ``flex_attention`` call computing the same function as
    the flash kernel: GQA, causal (and window) block mask, softcap
    ``cap * tanh(s / cap)`` as ``score_mod``, scale 1/sqrt(D); without
    ``causal`` no mask, over q's and k's own lengths."""
    from torch.nn.attention.flex_attention import (
        create_block_mask,
        flex_attention,
    )

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki
        return keep & (ki > qi - window) if window else keep

    mask = None
    if causal:
        s = q.shape[1]
        mask = create_block_mask(mask_mod, None, None, s, s, device=q.device)
    # a fresh compile for each yardstick: a recompile for another cap would
    # otherwise turn the captured float dynamic, which flex cannot lower
    torch._dynamo.reset()
    fn = torch.compile(flex_attention)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: fn(qt, kt, vt, score_mod=score_mod if cap else None,
                      block_mask=mask, enable_gqa=True).transpose(1, 2)


def sdpa_call(torch, q, k, v, causal: bool):
    """One ``scaled_dot_product_attention`` call computing the same function
    (GQA, scale 1/sqrt(D), causal or not, no window or softcap): the
    yardstick of every shape without a window or softcap, uncompiled, and
    where compiled ``flex_attention`` cannot take the shape."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True).transpose(1, 2)


def visible_pairs(s: int, causal: bool, window: int,
                  sk: int = 0) -> int:
    """(query, key) pairs a length-``s`` self-attention computes (a
    non-causal one over ``sk`` keys when given)."""
    if not causal:
        return s * (sk or s)
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def flash_phase(torch, report):
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_fwd_cuda,
        flash_fwd_plain,
    )
    from repro_torch.kernels.flash_attention.ops import (
        flash_split_plain,
        kernel_dims,
        split_buffer,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def qkv(b, s, h, kvh, d):
        mk = lambda n: torch.randn((b, s, n, d), device="cuda", generator=gen)
        return mk(h), mk(kvh), mk(kvh)

    def split_bitwise(k, v, split, what):
        """The split scratch against the plain version of the (padded, at
        ``kernel_dims``) K and V."""
        dq, dv = kernel_dims(k.shape[-1], v.shape[-1])
        pad = lambda x, n: torch.nn.functional.pad(x, (0, n - x.shape[-1]))
        want = flash_split_plain(pad(k, dq), pad(v, dv))
        torch.cuda.synchronize()
        check(torch.equal(split.view(torch.int32), want.view(torch.int32)),
              f"flash split pass not bitwise equal to its plain version at "
              f"{what}")

    def grad_err(q, k, v, kw, what):
        """Max |diff| between the autograd gradients through the kernel and
        through the plain version, held to FLASH_TOL."""
        w = torch.randn((*q.shape[:-1], v.shape[-1]), device="cuda",
                        generator=gen)
        grads = []
        for impl in ("cuda", "plain"):
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
            torch.sum(flash_attention(*xs, impl=impl, **kw) * w).backward()
            grads.append([x.grad for x in xs])
        err = 0.0
        for a, g in zip(*grads):
            err = max(err, (a - g).abs().max().item())
            check(torch.allclose(a, g, rtol=FLASH_TOL, atol=FLASH_TOL),
                  f"flash gradients disagree at {what}")
        return err

    max_err = 0.0
    for b, s, h, kvh, d, causal, window, cap in FLASH_CASES:
        kw = dict(causal=causal, window=window, softcap=cap)
        q, k, v = qkv(b, s, h, kvh, d)
        split = split_buffer(b, kvh, s, d, "cuda")
        out, lse = flash_fwd_cuda(q, k, v, split=split, **kw)
        ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        split_bitwise(k, v, split, (b, s, h, kvh, d))
        check(out.shape == ref.shape and lse.shape == ref_lse.shape,
              f"flash shapes {tuple(out.shape)} {tuple(lse.shape)}")
        err = max((out - ref).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        check(torch.allclose(out, ref, rtol=FLASH_TOL, atol=FLASH_TOL)
              and torch.allclose(lse, ref_lse, rtol=FLASH_TOL, atol=FLASH_TOL),
              f"flash kernel disagrees with plain at {b, s, h, kvh, d, kw}: "
              f"max err {err:.3g}")
        err = max(err, grad_err(q, k, v, kw, (b, s, h, kvh, d, kw)))
        max_err = max(max_err, err)
        print(f"flash D={d} S={s} H={h}/{kvh} {kw}: ok (max err {err:.3g})")

    def shape_inputs(b, sq, sk, h, kvh, d, dv):
        return (torch.randn((b, sq, h, d), device="cuda", generator=gen),
                torch.randn((b, sk, kvh, d), device="cuda", generator=gen),
                torch.randn((b, sk, kvh, dv), device="cuda", generator=gen))

    def held(q, k, v, kw, what, grads):
        """The kernel's out and lse (and, with ``grads``, the autograd
        gradients) against the plain version's, its split scratch bitwise:
        the largest max |diff|."""
        dq_k, dv_k = kernel_dims(q.shape[-1], v.shape[-1])
        split = split_buffer(k.shape[0], k.shape[2], k.shape[1], dq_k,
                             "cuda", dv_k)
        out, lse = flash_fwd_cuda(q, k, v, split=split, **kw)
        ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max((out - ref).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        check(torch.allclose(out, ref, rtol=FLASH_TOL, atol=FLASH_TOL)
              and torch.allclose(lse, ref_lse, rtol=FLASH_TOL, atol=FLASH_TOL),
              f"flash kernel disagrees with plain at {what}: max err "
              f"{err:.3g}")
        del out, lse, ref, ref_lse
        split_bitwise(k, v, split, what)
        del split
        return max(err, grad_err(q, k, v, kw, what)) if grads else err

    # tp_path's family and smoke cuts, a model rank's shapes: checked, not
    # timed (MLA's at full width is timed with the paths' shapes below)
    tp_errs = {}
    for layer, shape in FLASH_TP_SHAPES.items():
        b, sq, sk, h, kvh, d, causal, window = shape[:8]
        dv = shape[8] if len(shape) > 8 else d
        q, k, v = shape_inputs(b, sq, sk, h, kvh, d, dv)
        tp_errs[layer] = held(q, k, v, dict(causal=causal, window=window,
                                            softcap=0.0),
                              f"the {layer} shape", grads=True)
        print(f"flash {layer} (B={b} Sq={sq} Sk={sk} H={h} KV={kvh} D={d} "
              f"DV={dv} {'causal' if causal else 'non-causal'} "
              f"window={window}): out, lse and gradients within {FLASH_TOL} "
              f"of plain (max err {tp_errs[layer]:.3g})")
        del q, k, v
    max_err = max(max_err, *tp_errs.values())
    torch.cuda.empty_cache()

    # the paths' shapes, each against its plain version, its bound and
    # compiled flex_attention; the encoder-decoder's D 64 shapes and MLA's
    # d_v != d_qk ones with their gradients too
    shapes = {}
    graded = (*FLASH_ED_SHAPES, *FLASH_MLA_SHAPES)
    cases = [(layer, b, s, s, h, kvh, d, d, True, window, cap) for layer,
             (b, s, h, kvh, d, window, cap) in FLASH_PATH_SHAPES.items()]
    cases += [(layer, b, sq, sk, h, kvh, d, d, causal, 0, 0.0) for layer,
              (b, sq, sk, h, kvh, d, causal) in FLASH_ED_SHAPES.items()]
    cases += [(layer, b, s, s, h, h, d, dv, True, 0, 0.0) for layer,
              (b, s, h, d, dv) in FLASH_MLA_SHAPES.items()]
    cases += [(layer, b, sq, sk, h, kvh, d, d, causal, 0, 0.0) for layer,
              (b, sq, sk, h, kvh, d, causal) in FLASH_DECODE_SHAPES.items()]
    for layer, b, sq, sk, h, kvh, d, dv, causal, window, cap in cases:
        q, k, v = shape_inputs(b, sq, sk, h, kvh, d, dv)
        kw = dict(causal=causal, window=window, softcap=cap)
        dq_k, dv_k = kernel_dims(d, dv)
        err = held(q, k, v, kw, f"the {layer} shape", layer in graded)
        max_err = max(max_err, err)
        ms = time_ms(torch, lambda: flash_fwd_cuda(q, k, v, **kw), 10)
        plain_ms = time_ms(torch, lambda: flash_fwd_plain(q, k, v, **kw), 3)
        lib_name, lib_note = "flex_attention", None
        if not window and not cap:
            # no window and no softcap: one sdpa call computes it,
            # uncompiled (flex_attention's compile is kept for the shapes
            # that need its mask or score_mod)
            lib_name = "scaled_dot_product_attention"
            lib = sdpa_call(torch, q, k, v, causal)
        else:
            try:
                lib = flex_call(torch, q, k, v, window, cap, causal=causal)
                lib()
            except Exception as e:    # the yardstick only, never the port
                lib_name = "scaled_dot_product_attention"
                lib_note = (f"compiled flex_attention cannot run this shape "
                            f"({type(e).__name__}: {str(e)[:200]}); "
                            f"{lib_name} instead")
                lib = sdpa_call(torch, q, k, v, causal)
        lib_err = (lib() - flash_fwd_cuda(q, k, v, **kw)[0]).abs().max().item()
        library_ms = time_ms(torch, lib, 3)
        del lib
        # the function's 2 (D + DV) flops a visible pair (S = Q.K^T and
        # P.V) at the card's TF32 rate (the least the tensor cores can do
        # it in); beside it the kernel's own split-TF32 work (three
        # products each) at that rate, and the function at the f32 rate of
        # the CUDA cores.  Bytes: q, k, v and lse read or written once, out
        # [B, Sq, H, DV] written once
        flops = 2.0 * (d + dv) * visible_pairs(sq, causal, window, sk) * h * b
        nbytes = 4.0 * (q.numel() + b * sq * h * dv + k.numel() + v.numel()
                        + b * h * sq)
        bound_ops = flops / TF32_FLOPS_PER_S * 1e3
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        shapes[layer] = sh = dict(
            # MLA's grid order (flash_fwd.cu: query blocks first where a
            # kv head would get fewer than 4 of the CTAs in flight, one an
            # SM at its tiles: 132 on the H100)
            grid=(None if layer not in FLASH_MLA_SHAPES
                  else "query blocks first" if 4 * kvh > 132
                  else "heads first"),
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(bound_ops, bound_bytes),
            bound_by="operations" if bound_ops >= bound_bytes else "bytes",
            bound_split_tf32_ms=max(3 * bound_ops, bound_bytes),
            bound_f32_cuda_core_ms=max(flops / F32_FLOPS_PER_S * 1e3,
                                       bound_bytes),
            flops=flops, bytes=nbytes, max_abs_err=err,
            library=lib_name, library_max_abs_err=lib_err,
            library_note=lib_note,
            shape=f"B={b} Sq={sq} Sk={sk} H={h} KV={kvh} D={d} DV={dv} "
                  f"{'causal' if causal else 'non-causal'} window={window} "
                  f"softcap={cap}" + (f" (run at {dq_k} / {dv_k})"
                                      if (dq_k, dv_k) != (d, dv) else ""))
        lib_text = (f"{lib_name} {library_ms:.3f} ms (max diff to the kernel "
                    f"{lib_err:.3g})")
        print(f"flash {layer} ({sh['shape']}"
              + (f"; {sh['grid']}" if sh["grid"] else "") + f"): kernel "
              f"{ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, {lib_text}, bound {sh['bound_ms']:.3f} "
              f"ms ({sh['bound_by']}, TF32), {sh['bound_ms'] / ms:.1%} of it; "
              f"split-TF32 work {sh['bound_split_tf32_ms']:.3f} ms "
              f"({sh['bound_split_tf32_ms'] / ms:.1%}); CUDA-core bound "
              f"{sh['bound_f32_cuda_core_ms']:.3f} ms; "
              f"{flops / ms / 1e9:.1f} TFLOP/s of the function's, "
              f"{3 * flops / ms / 1e9:.1f} TF32 TFLOP/s issued; max err "
              f"{err:.3g}" + (" (gradients included)"
                              if layer in graded else ""))
    log = build.build_log("flash_fwd")
    ptxas, ptxas_d64, ptxas_mla = (
        build.ptxas_report(log, f"flash_fwd_tf32_kernel<{dims}>")
        for dims in ("256,256", "64,64", "192,128"))
    print("; ".join(ptxas + ptxas_d64 + ptxas_mla))
    report["flash"] = dict(cases=len(FLASH_CASES), max_abs_err=max_err,
                           model2_max_abs_err=tp_errs,
                           ptxas_d256=ptxas, ptxas_d64=ptxas_d64,
                           ptxas_mla=ptxas_mla, **shapes)
    torch.cuda.empty_cache()
    g = shapes["global"]
    return {
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "launches": None, "max_abs_err": max_err,
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "bound_split_tf32_ms": g["bound_split_tf32_ms"],
        "bound_f32_cuda_core_ms": g["bound_f32_cuda_core_ms"],
        "shape": "B=1 S=8192 H=8 KV=4 D=256 causal softcap=50 (global layer)",
        "local_ms": shapes["local"]["ms"],
        "local_plain_ms": shapes["local"]["plain_ms"],
        "local_bound_ms": shapes["local"]["bound_ms"],
        "rg_ms": shapes["recurrentgemma"]["ms"],
        "rg_plain_ms": shapes["recurrentgemma"]["plain_ms"],
        "rg_bound_ms": shapes["recurrentgemma"]["bound_ms"],
        "rg_library_ms": shapes["recurrentgemma"]["library_ms"],
        "rg_shape": f"B=1 S=8192 H=16 KV=1 D=256 causal window={RG_WINDOW} "
                    f"(recurrentgemma-9b local layer)",
        **{f"{layer}_{k}": shapes[layer][k]
           for layer in (*FLASH_ED_SHAPES, *FLASH_MLA_SHAPES,
                         *FLASH_DECODE_SHAPES)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "shape")},
        "model2_max_abs_err": tp_errs,
        "ptxas": ptxas, "ptxas_mla": ptxas_mla,
        "note": "a split pass writes K and V as TF32 hi + lo; S = Q.K^T and "
                "P.V each run as three TF32 wgmmas (hi.hi + hi.lo + lo.hi); "
                "bound: 2 (D + DV) flops a visible pair at 495 TFLOP/s TF32 "
                "(the kernel's split-TF32 work, three times that, stands in "
                "bound_split_tf32_ms)",
        "library_note": "compiled flex_attention, softcap score_mod and "
                        "window mask; scaled_dot_product_attention, "
                        "uncompiled, at the shapes without a window or "
                        "softcap (see each shape's library)",
    }


# ---------------------------------------------------------------------------
# bucket update
# ---------------------------------------------------------------------------
def bucket_phase(torch, layout, report):
    from repro_torch.kernels.bucket_update import (
        bucket_update_cuda,
        bucket_update_ref,
        pack_scalars,
    )
    from repro_torch.optim.optimizers import adamw, sgd_momentum

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rnd = lambda n: torch.randn(n, device="cuda", generator=gen)
    step = torch.tensor(3, dtype=torch.int32, device="cuda")
    n_cases = 0
    for spec in (adamw(1e-2, weight_decay=0.01),
                 sgd_momentum(3e-2, momentum=0.85, weight_decay=0.02)):
        adam = spec.name == "adamw"
        for elem in (False, True):
            for zero in (False, True):
                padded, n_valid = 4096 + 640, 4096 + 533
                p, m, v, g = rnd(padded), rnd(padded), rnd(padded).abs(), rnd(padded)
                sc = torch.rand(padded, device="cuda", generator=gen) + 0.5
                wd = torch.rand(padded, device="cuda", generator=gen) * 0.1
                scal = pack_scalars(spec, step, grad_scale=0.5,
                                    clip=torch.tensor(0.9, device="cuda"))
                kw = dict(n_valid=n_valid,
                          uniform=None if elem else (1.0, spec.weight_decay),
                          elem_hparams=(sc, wd) if elem else None)
                g0 = g.clone()
                want = bucket_update_ref(spec, p, m, v if adam else None, g,
                                         scal, **kw)
                bucket_update_cuda(spec, p, m, v if adam else None, g, scal,
                                   zero_grads=zero, **kw)
                torch.cuda.synchronize()
                ok = (torch.equal(p, want[0]) and torch.equal(m, want[1])
                      and (not adam or torch.equal(v, want[2]))
                      and (torch.equal(g, torch.zeros_like(g)) if zero
                           else torch.equal(g, g0)))
                check(ok, f"bucket update not bitwise: {spec.name} "
                          f"elem={elem} zero_grads={zero}")
                n_cases += 1
    print(f"bucket update: {n_cases} cases bitwise equal to the plain version")

    # the main path's buffers: one AdamW update over every bucket
    spec = adamw(LR)
    sizes = layout.buf_sizes
    bufs = [dict(p=rnd(n) * 0.02, m=torch.zeros(n, device="cuda"),
                 v=torch.zeros(n, device="cuda"), g=rnd(n) * 1e-3)
            for n in sizes]
    scal = pack_scalars(spec, torch.tensor(1, dtype=torch.int32, device="cuda"),
                        grad_scale=1.0, clip=torch.tensor(1.0, device="cuda"))
    big = max(range(len(sizes)), key=lambda i: sizes[i])
    x = bufs[big]
    kw = dict(n_valid=layout.sizes[big], uniform=(1.0, 0.0))
    want = bucket_update_ref(spec, x["p"], x["m"], x["v"], x["g"], scal, **kw)
    bucket_update_cuda(spec, x["p"], x["m"], x["v"], x["g"], scal, **kw)
    torch.cuda.synchronize()
    err = max((x["p"] - want[0]).abs().max().item(),
              (x["m"] - want[1]).abs().max().item(),
              (x["v"] - want[2]).abs().max().item())
    check(err == 0.0, f"bucket update not bitwise on the {sizes[big]}-element "
                      f"bucket: max err {err:.3g}")
    del want

    def kernel_all():
        for b, x in enumerate(bufs):
            bucket_update_cuda(spec, x["p"], x["m"], x["v"], x["g"], scal,
                               n_valid=layout.sizes[b], uniform=(1.0, 0.0),
                               zero_grads=True)

    def plain_all():
        for b, x in enumerate(bufs):
            bucket_update_ref(spec, x["p"], x["m"], x["v"], x["g"], scal,
                              n_valid=layout.sizes[b], uniform=(1.0, 0.0),
                              zero_grads=True)

    ms = time_ms(torch, kernel_all, 5)
    plain_ms = time_ms(torch, plain_all, 3)
    steps = [torch.ones((), device="cuda") for _ in bufs]
    library_ms = time_ms(torch, lambda: torch._fused_adamw_(
        [x["p"] for x in bufs], [x["g"] for x in bufs],
        [x["m"] for x in bufs], [x["v"] for x in bufs], [], steps,
        lr=LR, beta1=spec.beta1, beta2=spec.beta2, weight_decay=0.0,
        eps=spec.eps, amsgrad=False, maximize=False), 5)
    n = sum(sizes)
    nbytes = 4.0 * n * 8           # read p, m, v, g; write p, m, v, zeroed g
    lib_bytes = 4.0 * n * 7        # _fused_adamw_ leaves g as it is
    flops = 17.0 * n               # the AdamW expression per element
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = flops / F32_FLOPS_PER_S * 1e3
    lib_bound = lib_bytes / HBM_BYTES_PER_S * 1e3
    print(f"bucket update main path ({len(sizes)} buckets, {n:,} elements, "
          f"largest {sizes[big]:,}): kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, _fused_adamw_ {library_ms:.3f} ms, bound {bound_b:.3f} ms "
          f"(bytes), {nbytes / ms / 1e6:.0f} GB/s achieved")
    print(f"  bytes: the kernel moves 32 B an element (zero_grads writes g), "
          f"{bound_b / ms:.1%} of its bound; _fused_adamw_ does not zero the "
          f"gradients and moves 28 B an element: bound {lib_bound:.3f} ms, "
          f"{lib_bound / library_ms:.1%} of it")
    report["bucket_update"] = dict(
        cases=n_cases, elements=n, buckets=len(sizes), ms=ms,
        plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(bound_b, bound_o),
        bytes=nbytes, max_abs_err=err, library_bytes=lib_bytes,
        library_bound_ms=lib_bound)
    del bufs
    torch.cuda.empty_cache()
    return {
        "name": "bucket_update", "route": "cuda",
        "source": "src/repro_torch/kernels/bucket_update/csrc/bucket_update.cu",
        "replaces": "src/repro/kernels/bucket_update/kernel.py:129",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_b, bound_o),
        "bound_by": "bytes" if bound_b >= bound_o else "operations",
        "library_ms": library_ms, "library_bound_ms": lib_bound,
        "library_note": "torch._fused_adamw_ does not zero the gradients: "
                        "28 B an element against the kernel's 32",
        "shape": f"AdamW over all {len(sizes)} buckets of the main path "
                 f"({n} f32 elements), zero_grads",
    }


def sharded_update_phase(torch, meta, bucket_of, nb, report):
    """The bucket update on the spans of the sharded flat engine: the main
    path's layout rebuilt with SHARDS shards; its largest bucket and its
    bucket with per-element hyperparameters updated once per span through
    ``apply_bucket_updates(shard_id=s)`` (the norm summed on the host from
    the four spans' sums) and reassembled, against one full-buffer apply:
    bitwise with clipping off, within SHARD_CLIP_TOL with it on.  NaN/inf
    ride the padded tail of the last span.  bf16sr spans are held bitwise
    against the plain version (update and rounding)."""
    from repro_torch.kernels.bucket_update import (
        apply_bucket_updates,
        bucket_update_cuda,
        build_segments,
    )
    from repro_torch.kernels.quantize import stochastic_round_bf16_cuda
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train.bucketing import build_bucket_layout
    from repro_torch.tree import tree_leaves

    full = build_bucket_layout(meta, bucket_of, nb, shard_count=SHARDS)
    hp = dict(weight_decay=0.01, decay_mask="matrix", ndim1_lr_scale=0.5)
    seg = build_segments(full, adamw(LR, **hp))
    big = max(range(nb), key=lambda b: full.buf_sizes[b])
    elem = next(b for b in range(nb) if seg.uniform(b) is None)
    chosen = (big, elem)
    leaves = tree_leaves(meta)
    lay = build_bucket_layout(
        tuple(leaves[i] for b in chosen for i in full.leaves[b]),
        tuple(j for j, b in enumerate(chosen) for _ in full.leaves[b]), 2,
        shard_count=SHARDS)
    check(lay.buf_sizes == tuple(full.buf_sizes[b] for b in chosen)
          and lay.sizes == tuple(full.sizes[b] for b in chosen)
          and lay.sizes[1] < lay.buf_sizes[1],
          f"the sharded update's buckets {chosen}: {lay.sizes} of "
          f"{lay.buf_sizes}, the layout's {full.buf_sizes}")
    spans = lay.shard_sizes
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    tail = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30],
                        device="cuda")
    start = {}
    for name, scale in (("p", 0.02), ("m", 1e-3), ("v", 1e-6), ("g", 1e-3)):
        start[name] = []
        for n, v in zip(lay.buf_sizes, lay.sizes):
            x = torch.randn(n, device="cuda", generator=gen) * scale
            x = x.abs() if name == "v" else x
            x[v:] = 0.0
            start[name].append(x)
    # hostile values in the padded tail (the last span's) of the gradient
    for b in range(2):
        t = lay.buf_sizes[b] - lay.sizes[b]
        start["g"][b][lay.sizes[b]:] = tail.repeat((t + 3) // 4)[:t]
    step0 = torch.tensor(2, dtype=torch.int32, device="cuda")
    gscale = 0.5

    def state(master="f32"):
        p = [x.clone() for x in start["p"]]
        if master == "bf16sr":
            p = [x.to(torch.bfloat16) for x in p]
        return p, [x.clone() for x in start["g"]], {
            "step": step0.clone(), "m": [x.clone() for x in start["m"]],
            "v": [x.clone() for x in start["v"]]}

    def span(bufs, s):
        return [x[s * spans[b]:(s + 1) * spans[b]] for b, x in enumerate(bufs)]

    masked = [g.clone() for g in start["g"]]
    for b, g in enumerate(masked):
        g[lay.sizes[b]:] = 0.0
    # the norm the engine's all-reduce sums: each span's squared sum, on
    # the host
    total = sum(float(torch.sum(torch.square(g * gscale)))
                for s in range(SHARDS) for g in span(masked, s))
    total_t = torch.tensor(total, dtype=torch.float32, device="cuda")
    del masked

    def by_spans(spec, master="f32", impl=None):
        p, g, opt = state(master)
        launches = bucket_update_cuda.launches
        for s in range(SHARDS):
            o = {"step": opt["step"].clone(), "m": span(opt["m"], s),
                 "v": span(opt["v"], s)}
            apply_bucket_updates(
                spec, build_segments(lay, spec), span(p, s), span(g, s), o,
                grad_scale=gscale, impl=impl, shard_id=s,
                norm_psum=(lambda t: total_t) if spec.grad_clip else None,
                master_dtype=master,
                quantize_impl="plain" if impl == "plain" else None)
        check(bucket_update_cuda.launches - launches
              == (0 if impl == "plain" else 2 * SHARDS),
              f"sharded update launches: {bucket_update_cuda.launches - launches}")
        torch.cuda.synchronize()
        return p, opt

    out = {}
    for clip in (0.0, 1.0):
        spec = adamw(LR, grad_clip=clip, **hp)
        p_full, g_full, opt_full = state()
        apply_bucket_updates(spec, build_segments(lay, spec), p_full, g_full,
                             opt_full, grad_scale=gscale)
        p_sh, opt_sh = by_spans(spec)
        err = 0.0
        for b in range(2):
            for got, want in ((p_sh[b], p_full[b]), (opt_sh["m"][b],
                                                     opt_full["m"][b]),
                              (opt_sh["v"][b], opt_full["v"][b])):
                check(bool(torch.isfinite(got).all()),
                      f"sharded update (clip {clip}): a non-finite value in "
                      f"bucket {chosen[b]}")
                d = (got - want).abs()
                err = max(err, d.max().item())
                if clip:
                    ok = bool((d <= SHARD_CLIP_TOL
                               + SHARD_CLIP_TOL * want.abs()).all())
                else:
                    ok = torch.equal(got, want)
                check(ok, f"sharded update (clip {clip}) vs the full-buffer "
                          f"apply on bucket {chosen[b]}: max err {d.max():.3g}")
        out[f"clip{clip:g}_max_abs_err"] = err
        del p_full, g_full, opt_full, p_sh, opt_sh
        torch.cuda.empty_cache()
    spec = adamw(LR, **hp)
    sr = stochastic_round_bf16_cuda.launches
    p_k, opt_k = by_spans(spec, "bf16sr")
    check(stochastic_round_bf16_cuda.launches - sr == 2 * SHARDS,
          "bf16sr spans did not launch the stochastic-rounding kernel")
    p_pl, opt_pl = by_spans(spec, "bf16sr", impl="plain")
    for b in range(2):
        check(torch.equal(p_k[b].view(torch.int16), p_pl[b].view(torch.int16))
              and torch.equal(opt_k["m"][b], opt_pl["m"][b])
              and torch.equal(opt_k["v"][b], opt_pl["v"][b]),
              f"bf16sr spans not bitwise the plain version on bucket "
              f"{chosen[b]}")
    del p_k, opt_k, p_pl, opt_pl, start
    torch.cuda.empty_cache()
    report["sharded_update"] = dict(
        shards=SHARDS, buckets=list(chosen), sizes=list(lay.sizes),
        buf_sizes=list(lay.buf_sizes), span=list(spans), **out)
    print(f"sharded update: {SHARDS} spans of buckets {chosen} "
          f"({lay.sizes[0]:,} elements; {lay.sizes[1]:,} of "
          f"{lay.buf_sizes[1]:,} with per-element hyperparameters and NaN/inf "
          f"in the last span's tail) reassemble to the full-buffer apply "
          f"bitwise with clipping off, within {SHARD_CLIP_TOL} with it on "
          f"(max err {out['clip1_max_abs_err']:.3g}); bf16sr spans bitwise "
          f"equal to the plain version")


# ---------------------------------------------------------------------------
# wire-precision kernels: int8 quantize / dequantize, bf16 stochastic rounding
# ---------------------------------------------------------------------------
LIB_NOTE = {
    "quantize_int8": "no single PyTorch call computes this blockwise int8 "
                     "grid (per-128-lane-row absmax scale, round half to "
                     "even, zeroed tail)",
    "dequantize_int8": "torch.mul(q.view(-1, 128), scale[:, None]), the "
                       "main path's call (no ragged tail)",
    "stochastic_round_bf16": "no PyTorch call does this hashed stochastic "
                             "rounding",
}


def quantize_phase(torch, layout, report):
    from repro_torch.kernels.quantize import (
        dequantize_int8_cuda,
        dequantize_int8_plain,
        quantize_int8_cuda,
        quantize_int8_plain,
        stochastic_round_bf16_cuda,
        stochastic_round_bf16_plain,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    tail = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30],
                        device="cuda")

    def hostile(n, n_valid):
        x = torch.randn(n, device="cuda", generator=gen) * 3
        if n >= 256 and n_valid >= 256:
            x[128:256] = 0.0                      # an all-zero row
        x[n_valid:] = tail.repeat((n - n_valid + 3) // 4)[:n - n_valid]
        return x

    def compare(x, n_valid, seeds):
        """Every kernel against its plain version, bitwise."""
        q, s = quantize_int8_cuda(x, n_valid)
        q2, s2 = quantize_int8_plain(x, n_valid)
        torch.cuda.synchronize()
        check(torch.equal(q, q2) and torch.equal(s, s2),
              f"quantize_int8 not bitwise at {x.numel()}/{n_valid}")
        del q2, s2
        y = dequantize_int8_cuda(q, s, n_valid)
        y2 = dequantize_int8_plain(q, s, n_valid)
        torch.cuda.synchronize()
        check(torch.equal(y, y2),
              f"dequantize_int8 not bitwise at {x.numel()}/{n_valid}")
        del y, y2, q, s
        for seed in seeds:
            a = stochastic_round_bf16_cuda(x, seed, n_valid)
            b = stochastic_round_bf16_plain(x, seed, n_valid)
            torch.cuda.synchronize()
            check(torch.equal(a.view(torch.int16), b.view(torch.int16)),
                  f"stochastic_round_bf16 not bitwise at {x.numel()}/"
                  f"{n_valid}, seed {seed}")
            del a, b

    n_cases = 0
    for n, n_valid in ((128, 128), (1280, 1000), (4096, 4096), (4096, 1)):
        compare(hostile(n, n_valid), n_valid, (7, 2**32 - 1))
        n_cases += 1
    print(f"quantize kernels: {n_cases} small cases (ragged tails of "
          f"NaN/inf, an all-zero row, seeds 7 and 2**32-1) bitwise equal to "
          f"the plain versions")

    # the main path's largest bucket (the tied embedding): a gradient-like
    # buffer, its valid length as the layout has it
    big = max(range(layout.n_buckets), key=lambda b: layout.buf_sizes[b])
    n, n_valid = layout.buf_sizes[big], layout.sizes[big]
    x = torch.randn(n, device="cuda", generator=gen) * 1e-3
    x[n_valid:] = 0.0
    compare(x, n_valid, (12345,))
    print(f"quantize kernels: the {n:,}-element bucket bitwise equal to the "
          f"plain versions")
    torch.cuda.empty_cache()

    rows = n // 128
    q, s = quantize_int8_cuda(x, n_valid)
    out32 = torch.empty_like(x)
    out16 = torch.empty(n, dtype=torch.bfloat16, device="cuda")
    seed = torch.tensor(12345, dtype=torch.int64, device="cuda")
    nbytes = {"quantize_int8": 4.0 * n + n + 4.0 * rows,
              "dequantize_int8": 1.0 * n + 4.0 * rows + 4.0 * n,
              "stochastic_round_bf16": 4.0 * n + 2.0 * n}
    # the main path dequantizes whole buffers (n_valid None); q's tail is
    # zero, so the library's product is the kernel's output bit for bit
    deq_lib = lambda: torch.mul(q.view(-1, 128), s[:, None])
    check(torch.equal(deq_lib().view(-1),
                      dequantize_int8_cuda(q, s, None, out=out32)),
          "torch.mul is not the dequantize kernel's function")
    runs = {
        "quantize_int8": (lambda: quantize_int8_cuda(x, n_valid),
                          lambda: quantize_int8_plain(x, n_valid), None),
        "dequantize_int8": (
            lambda: dequantize_int8_cuda(q, s, None, out=out32),
            lambda: dequantize_int8_plain(q, s, None), deq_lib),
        "stochastic_round_bf16": (
            lambda: stochastic_round_bf16_cuda(x, seed, n_valid, out=out16),
            lambda: stochastic_round_bf16_plain(x, seed, n_valid), None),
    }
    entries = []
    src = "src/repro_torch/kernels/quantize/csrc/quantize.cu"
    line = {"quantize_int8": 112, "dequantize_int8": 149,
            "stochastic_round_bf16": 69}
    report["quantize"] = {"cases": n_cases, "elements": n, "n_valid": n_valid}
    for name, (kern, plain, lib) in runs.items():
        ms = time_ms(torch, kern, 10)
        plain_ms = time_ms(torch, plain, 3)
        library_ms = time_ms(torch, lib, 10) if lib is not None else None
        torch.cuda.empty_cache()
        bound = nbytes[name] / HBM_BYTES_PER_S * 1e3
        lib_txt = (f"{library_ms:.3f} ms" if library_ms is not None
                   else "none")
        print(f"{name} ({n:,} elements): kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, library {lib_txt}, bound {bound:.3f} ms "
              f"(bytes), {nbytes[name] / ms / 1e6:.0f} GB/s achieved")
        report["quantize"][name] = dict(ms=ms, plain_ms=plain_ms,
                                        library_ms=library_ms,
                                        bound_ms=bound, bytes=nbytes[name])
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/quantize/kernel.py:{line[name]}",
            "launches": None, "max_abs_err": 0.0,      # bitwise, checked
            "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library_ms, "library_note": LIB_NOTE[name],
            "shape": f"one flat bucket of {n} elements (the main path's "
                     f"largest, the tied embedding)",
        })
    del x, q, s, out32, out16
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# flash attention on bf16 inputs
# ---------------------------------------------------------------------------
def flash_bf16_phase(torch, report):
    """The bf16 tensor-core flash forward (flash_fwd_sm90.cu): the small
    cases, then the main path's shapes, timed in turns with compiled
    ``flex_attention`` (kernel, flex, kernel), then MLA's d_qk != d_v
    (``FLASH_MLA_SHAPES``: the (192, 128) instantiation at
    deepseek-v2-236b's shape, and the smoke 48 / 32 run at 64 / 32 with q
    and k read at 48), timed in turns with one ``scaled_dot_product_attention`` call on
    the same bf16 inputs.  Returns the kernels line's two rows: the main
    path's shapes and the (192, 128) instantiation."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_fwd_cuda,
        flash_fwd_plain,
    )
    from repro_torch.kernels.flash_attention.ops import kernel_dims

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def qkv(b, s, h, kvh, d, dv=None):
        mk = lambda n, w: torch.randn((b, s, n, w), device="cuda",
                                      generator=gen).bfloat16()
        return mk(h, d), mk(kvh, d), mk(kvh, dv or d)

    def grad_rel(q, k, v, kw, what):
        """Autograd through the kernel against the plain forward (the
        backward is plain in both): the largest |diff| / max |g|."""
        w = torch.randn((*q.shape[:-1], v.shape[-1]), device="cuda",
                        generator=gen)
        grads = []
        for impl in ("cuda", "plain"):
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
            torch.sum(flash_attention(*xs, impl=impl, **kw).float()
                      * w).backward()
            grads.append([x.grad for x in xs])
        rel = 0.0
        for a, g in zip(*grads):
            scale = g.float().abs().max().item()
            d_max = (a.float() - g.float()).abs().max().item()
            rel = max(rel, d_max / scale)
            check(a.dtype == torch.bfloat16 and torch.allclose(
                a.float(), g.float(), rtol=BF16_GRAD_RTOL, atol=scale / 128),
                f"flash bf16 gradients disagree at {what}: max |diff| "
                f"{d_max:.3g} of max |g| {scale:.3g}")
        return rel

    worst = dict(out=0.0, lse=0.0, grad_rel=0.0)
    cases = FLASH_BF16_CASES
    for b, s, h, kvh, d, causal, window, cap, *dv in cases:
        kw = dict(causal=causal, window=window, softcap=cap)
        q, k, v = qkv(b, s, h, kvh, d, *dv)
        out, lse = flash_fwd_cuda(q, k, v, **kw)
        ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        check(out.dtype == torch.bfloat16 and lse.dtype == torch.float32,
              f"flash bf16 dtypes {out.dtype} {lse.dtype}")
        o_err = (out.float() - ref.float()).abs().max().item()
        l_err = (lse - ref_lse).abs().max().item()
        check(torch.allclose(out.float(), ref.float(), rtol=BF16_OUT_RTOL,
                             atol=1e-5)
              and torch.allclose(lse, ref_lse, rtol=FLASH_TOL, atol=FLASH_TOL),
              f"flash bf16 kernel disagrees with plain at "
              f"{b, s, h, kvh, d, kw}: out {o_err:.3g}, lse {l_err:.3g}")
        g_rel = grad_rel(q, k, v, kw, (b, s, h, kvh, d, kw))
        worst = dict(out=max(worst["out"], o_err), lse=max(worst["lse"], l_err),
                     grad_rel=max(worst["grad_rel"], g_rel))
        print(f"flash bf16 D={d}{'/' + str(dv[0]) if dv else ''} S={s} "
              f"H={h}/{kvh} {kw}: ok (out {o_err:.3g}, "
              f"lse {l_err:.3g}, grads {g_rel:.3g} of max |g|)")

    b, s, h, kvh, d = BATCH, SEQ, 8, 4, 256
    q, k, v = qkv(b, s, h, kvh, d)
    shapes = {}
    for layer, window in (("global", 0), ("local", 4096)):
        kw = dict(causal=True, window=window, softcap=50.0)
        out, lse = flash_fwd_cuda(q, k, v, **kw)
        ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        l_err = (lse - ref_lse).abs().max().item()
        check(torch.allclose(out.float(), ref.float(), rtol=BF16_OUT_RTOL,
                             atol=1e-5)
              and torch.allclose(lse, ref_lse, rtol=FLASH_TOL, atol=FLASH_TOL),
              f"flash bf16 kernel disagrees with plain at the {layer} "
              f"main-path shape: out {err:.3g}, lse {l_err:.3g}")
        del out, lse, ref, ref_lse
        g_rel = grad_rel(q, k, v, kw, f"the {layer} main-path shape")
        worst = dict(out=max(worst["out"], err), lse=max(worst["lse"], l_err),
                     grad_rel=max(worst["grad_rel"], g_rel))
        torch.cuda.empty_cache()
        kern = lambda: flash_fwd_cuda(q, k, v, **kw)
        lib = flex_call(torch, q, k, v, window, 50.0)
        lib_err = (lib().float() - kern()[0].float()).abs().max().item()
        # in turns on one card: kernel, flex, kernel
        ms_a = time_ms(torch, kern, 10)
        library_ms = time_ms(torch, lib, 10)
        ms_b = time_ms(torch, kern, 10)
        ms = (ms_a + ms_b) / 2
        plain_ms = time_ms(torch, lambda: flash_fwd_plain(q, k, v, **kw), 3)
        del lib
        flops = 4.0 * d * visible_pairs(s, True, window) * h * b
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) + 4.0 * b * h * s
        bound_ops = flops / BF16_FLOPS_PER_S * 1e3
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(bound_ops, bound_bytes)
        shapes[layer] = dict(
            ms=ms, ms_turns=[ms_a, ms_b], plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound,
            bound_by="operations" if bound_ops >= bound_bytes else "bytes",
            flops=flops, tflops=flops / ms / 1e9, bound_share=bound / ms,
            max_abs_err=err, lse_err=l_err, grad_rel=g_rel,
            library_max_abs_err=lib_err)
        print(f"flash bf16 main-path {layer}: out {err:.3g}, lse "
              f"{l_err:.3g}, grads {g_rel:.3g} of max |g|; kernel {ms_a:.3f} / "
              f"{ms_b:.3f} ms (flex between them {library_ms:.3f} ms, max "
              f"diff to the kernel {lib_err:.3g}), plain {plain_ms:.3f} ms, "
              f"bound {bound:.3f} ms ({shapes[layer]['bound_by']}, bf16 "
              f"tensor-core peak): {flops / ms / 1e9:.1f} TFLOP/s of the "
              f"bound's 4*D flops a pair, {bound / ms:.1%} of the bound")
        check(ms <= library_ms,
              f"flash bf16 {layer}: kernel {ms:.3f} ms slower than "
              f"flex_attention {library_ms:.3f} ms")
    # MLA: each head its own K and V, causal, at the (192, 128)
    # instantiation and the smoke 48 / 32 (run at 64 / 32, q and k read at
    # 48 by their tensor maps)
    for layer, (b, s, h, d, dv) in FLASH_MLA_SHAPES.items():
        mk = lambda n: torch.randn((b, s, h, n), device="cuda",
                                   generator=gen).bfloat16()
        q, k, v = mk(d), mk(d), mk(dv)
        kw = dict(causal=True)
        out, lse = flash_fwd_cuda(q, k, v, **kw)
        ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        l_err = (lse - ref_lse).abs().max().item()
        check(out.shape == ref.shape
              and torch.allclose(out.float(), ref.float(), rtol=BF16_OUT_RTOL,
                                 atol=1e-5)
              and torch.allclose(lse, ref_lse, rtol=FLASH_TOL, atol=FLASH_TOL),
              f"flash bf16 kernel disagrees with plain at the {layer} shape "
              f"({d} / {dv}): out {err:.3g}, lse {l_err:.3g}")
        del out, lse, ref, ref_lse
        g_rel = grad_rel(q, k, v, kw, f"the {layer} shape")
        worst = dict(out=max(worst["out"], err), lse=max(worst["lse"], l_err),
                     grad_rel=max(worst["grad_rel"], g_rel))
        torch.cuda.empty_cache()
        kern = lambda: flash_fwd_cuda(q, k, v, **kw)
        lib_note = None
        try:                      # the yardstick only, never the port
            lib = sdpa_call(torch, q, k, v, True)
            lib_err = (lib().float() - kern()[0].float()).abs().max().item()
        except Exception as e:
            lib, lib_err = None, None
            lib_note = (f"scaled_dot_product_attention cannot run this "
                        f"shape ({type(e).__name__}: {str(e)[:200]})")
        # in turns on one card: kernel, sdpa, kernel
        ms_a = time_ms(torch, kern, 10)
        library_ms = time_ms(torch, lib, 10) if lib is not None else None
        ms_b = time_ms(torch, kern, 10)
        ms = (ms_a + ms_b) / 2
        plain_ms = time_ms(torch, lambda: flash_fwd_plain(q, k, v, **kw), 3)
        del lib
        # the function's 2 (D + DV) flops a visible pair (S = Q.K^T and P.V);
        # bytes: q, k, v and out (bf16) and lse (f32) once each
        flops = 2.0 * (d + dv) * visible_pairs(s, True, 0) * h * b
        nbytes = 2.0 * (q.numel() + k.numel() + 2 * v.numel()) + 4.0 * b * h * s
        bound_ops = flops / BF16_FLOPS_PER_S * 1e3
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(bound_ops, bound_bytes)
        dq_k, dv_k = kernel_dims(d, dv)
        # the kernel's own work: S at its d_qk and P.V twice (P's bf16 hi
        # and lo), 2 d_qk + 4 d_v flops a visible pair
        split_flops = (2.0 * dq_k + 4.0 * dv_k) * visible_pairs(s, True, 0) \
            * h * b
        split_bound = max(split_flops / BF16_FLOPS_PER_S * 1e3, bound_bytes)
        shapes[layer] = dict(
            ms=ms, ms_turns=[ms_a, ms_b], plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound,
            bound_by="operations" if bound_ops >= bound_bytes else "bytes",
            flops=flops, tflops=flops / ms / 1e9, bound_share=bound / ms,
            split_bound_ms=split_bound, split_tflops=split_flops / ms / 1e9,
            max_abs_err=err, lse_err=l_err, grad_rel=g_rel,
            library="scaled_dot_product_attention",
            library_max_abs_err=lib_err, library_note=lib_note,
            shape=f"bf16 B={b} S={s} H={h} D={d} DV={dv} causal"
                  + (f" (run at {dq_k} / {dv_k})" if (dq_k, dv_k) != (d, dv)
                     else ""))
        lib_text = (f"sdpa between them {library_ms:.3f} ms (max diff to the "
                    f"kernel {lib_err:.3g})" if lib_note is None else lib_note)
        print(f"flash bf16 {layer} ({shapes[layer]['shape']}): out {err:.3g}, "
              f"lse {l_err:.3g}, grads {g_rel:.3g} of max |g|; kernel "
              f"{ms_a:.3f} / {ms_b:.3f} ms ({lib_text}), plain "
              f"{plain_ms:.3f} ms, bound {bound:.3f} ms "
              f"({shapes[layer]['bound_by']}, bf16 tensor-core peak): "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} of the bound; "
              f"the split work's bound {split_bound:.3f} ms, "
              f"{split_flops / ms / 1e9:.1f} TFLOP/s of it")
        del q, k, v
    ptxas_mla = build.ptxas_report(build.build_log("flash_fwd_sm90"),
                                   "flash_fwd_sm90_kernel<192,128>")
    print("flash bf16 (192, 128): " + "; ".join(ptxas_mla))
    report["flash_bf16"] = dict(cases=len(cases), **worst, **shapes,
                                ptxas_mla=ptxas_mla)
    torch.cuda.empty_cache()
    g, loc = shapes["global"], shapes["local"]
    mla, smoke = shapes["mla"], shapes["mla_smoke"]
    source = "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu"
    mla_row = {
        "name": "flash_fwd_sm90_mla", "route": "cuda", "source": source,
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "launches": None, "max_abs_err": max(mla["max_abs_err"],
                                             smoke["max_abs_err"]),
        "ms": mla["ms"], "plain_ms": mla["plain_ms"],
        "bound_ms": mla["bound_ms"], "bound_by": mla["bound_by"],
        "library_ms": mla["library_ms"], "shape": mla["shape"]
        + " (deepseek-v2-236b MLA, the (192, 128) instantiation)",
        "tflops": mla["tflops"], "bound_share": mla["bound_share"],
        "split_bound_ms": mla["split_bound_ms"],
        "split_tflops": mla["split_tflops"],
        "smoke_ms": smoke["ms"], "smoke_plain_ms": smoke["plain_ms"],
        "smoke_bound_ms": smoke["bound_ms"],
        "smoke_library_ms": smoke["library_ms"], "smoke_shape": smoke["shape"],
        "grad_err_of_max": max(mla["grad_rel"], smoke["grad_rel"]),
        "ptxas": ptxas_mla,
        "library_note": mla["library_note"]
        or "scaled_dot_product_attention on bf16 (compiled flex_attention "
           "cannot take d_qk 192)",
    }
    return [{
        "name": "flash_fwd_sm90", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_fwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "launches": None, "max_abs_err": worst["out"],
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "shape": "bf16 B=1 S=8192 H=8 KV=4 D=256 causal softcap=50 "
                 "(global layer)",
        "tflops": g["tflops"], "bound_share": g["bound_share"],
        "local_ms": loc["ms"], "local_plain_ms": loc["plain_ms"],
        "local_bound_ms": loc["bound_ms"],
        "local_library_ms": loc["library_ms"],
        "local_bound_share": loc["bound_share"],
        "lse_err": worst["lse"], "grad_err_of_max": worst["grad_rel"],
        "library_note": "compiled flex_attention on bf16, softcap score_mod",
    }, mla_row]


# ---------------------------------------------------------------------------
# RG-LRU scan: forward and reverse-scan backward
# ---------------------------------------------------------------------------
def rglru_phase(torch, report):
    from repro_torch.kernels.rglru import (
        rglru_bwd_cuda,
        rglru_fwd_cuda,
        rglru_scan_bwd_plain,
        rglru_scan_plain,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)

    def inputs(b, s, w):
        mk = lambda *shape: torch.randn(shape, device="cuda", generator=gen)
        a = torch.rand((b, s, w), device="cuda", generator=gen) * 0.85 + 0.1
        return mk(b, s, w), a, mk(b, w), mk(b, s, w), mk(b, w)

    def compare(b, a, h0, dh, dh_final, what):
        """Both kernels against their plain versions, bitwise."""
        h, hfin = rglru_fwd_cuda(b, a, h0)
        ref, ref_fin = rglru_scan_plain(b, a, h0)
        torch.cuda.synchronize()
        check(torch.equal(h, ref) and torch.equal(hfin, ref_fin),
              f"rglru forward not bitwise at {what}")
        got = rglru_bwd_cuda(a, h, h0, dh, dh_final)
        want = rglru_scan_bwd_plain(a, ref, h0, dh, dh_final)
        torch.cuda.synchronize()
        check(all((x is None and y is None) or torch.equal(x, y)
                  for x, y in zip(got, want)),
              f"rglru backward not bitwise at {what}")

    n_cases = 0
    for shape in ((2, 64, 128), (1, 128, 256), (3, 33, 100), (1, 1, 4096)):
        b, a, h0, dh, dh_final = inputs(*shape)
        for use_h0 in (False, True):
            for use_dhf in (False, True):
                compare(b, a, h0 if use_h0 else None, dh,
                        dh_final if use_dhf else None,
                        f"{shape} h0={use_h0} dh_final={use_dhf}")
                n_cases += 1
    print(f"rglru kernels: {n_cases} small cases bitwise equal to the plain "
          f"versions")

    # serve_path's scans, each from the carried h0: the prefill's and a
    # decode step's
    for shape in ((SERVE_REQUESTS, SERVE_PROMPT, RG_WIDTH),
                  (SERVE_REQUESTS, 1, RG_WIDTH)):
        b, a, h0, dh, _ = inputs(*shape)
        compare(b, a, h0, dh, None, f"serve_path's shape {shape} from h0")
    print("rglru kernels: serve_path's shapes from h0 bitwise equal to the "
          "plain versions")

    # the recurrent path's shape: one RG-LRU layer's scan, B=1, S=8192,
    # W=4096; the path passes no h0 and no h_final cotangent
    shape = (BATCH, SEQ, RG_WIDTH)
    b, a, _, dh, _ = inputs(*shape)
    compare(b, a, None, dh, None, f"the path's shape {shape}")
    print(f"rglru kernels: the path's shape {shape} bitwise equal to the "
          f"plain versions")
    # tp_path's recurrentgemma cut at model 2: the second rank's W / 2
    # 'lru' channels, sliced from these whole-width tensors and made
    # contiguous (the wrappers refuse a strided view)
    w2 = RG_WIDTH // TP_MODEL
    rank_part = lambda x: x[..., RG_WIDTH - w2:].contiguous()
    compare(rank_part(b), rank_part(a), None, rank_part(dh), None,
            f"a model rank's slice [{BATCH}, {SEQ}, {w2}]")
    print(f"rglru kernels: a model rank's slice [{BATCH}, {SEQ}, {w2}] of "
          f"the path's tensors bitwise equal to the plain versions")
    h, _ = rglru_fwd_cuda(b, a)
    n = b.numel()
    runs = {
        # bytes: read b and a, write h (+ h_final); 2 flops an element
        "rglru_fwd": (lambda: rglru_fwd_cuda(b, a),
                      lambda: rglru_scan_plain(b, a),
                      12.0 * n + 4.0 * n // SEQ, 2.0 * n),
        # bytes: read dh, a and h, write db and da; 3 flops an element
        "rglru_bwd": (lambda: rglru_bwd_cuda(a, h, None, dh),
                      lambda: rglru_scan_bwd_plain(a, h, None, dh),
                      20.0 * n, 3.0 * n),
    }
    note = {"rglru_fwd": "the forward scan of rglru_scan_pallas",
            "rglru_bwd": "the scan's reverse-scan backward: the TPU kernel "
                         "has none (JAX differentiates its plain scan, "
                         "rglru/ops.py:20), so this kernel is the port's own"}
    entries = []
    report["rglru"] = {"cases": n_cases, "shape": list(shape)}
    for name, (kern, plain, nbytes, flops) in runs.items():
        ms = time_ms(torch, kern, 20)
        plain_ms = time_ms(torch, plain, 2)
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = flops / F32_FLOPS_PER_S * 1e3
        bound = max(bound_b, bound_o)
        print(f"{name} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"library none, bound {bound:.3f} ms (bytes), "
              f"{nbytes / ms / 1e6:.0f} GB/s achieved")
        report["rglru"][name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                     bytes=nbytes, flops=flops)
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru/kernel.py:49",
            "replaces_note": note[name],
            "launches": None, "max_abs_err": 0.0,      # bitwise, checked
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if bound_b >= bound_o else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call computes this linear "
                            "recurrence",
            "shape": f"b, a [B, S, W] = {list(shape)} f32, no h0 (one RG-LRU "
                     f"layer of the recurrent path)",
        })
    del b, a, dh, h
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# RWKV-6 WKV: chunked forward and backward
# ---------------------------------------------------------------------------
def rwkv6_phase(torch, report):
    from repro_torch.kernels.rwkv6 import (
        rwkv6_bwd_cuda,
        rwkv6_bwd_plain,
        rwkv6_fwd_cuda,
    )
    from repro_torch.kernels.rwkv6.ops import CHUNK, _chunked_forward

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def inputs(b, s, h, d):
        """r, k, v, do, u, s0, dS_final; w by the JAX package's decay law
        sigmoid(N) * 0.9 + 0.05."""
        mk = lambda *shape: torch.randn(shape, device="cuda", generator=gen)
        w = torch.sigmoid(mk(b, s, h, d)) * 0.9 + 0.05
        return (mk(b, s, h, d), mk(b, s, h, d), mk(b, s, h, d), w,
                mk(h, d), mk(b, h, d, d), mk(b, s, h, d), mk(b, h, d, d))

    names = ("o", "S_final", "dr", "dk", "dv", "dw", "du", "ds0")

    def compare(r, k, v, w, u, s0, do, dsf, what):
        """Both kernels against the chunked plain pair: the largest
        max |diff| / max |plain| over o, S_final and every gradient; the
        chunk-start states, S_final and ds0 bitwise (the state updates sum
        ke^T v and rd^T do over t in order, as the plain products do)."""
        o, sf, states = rwkv6_fwd_cuda(r, k, v, w, u, s0, save_states=True)
        ro, rsf, rstates = _chunked_forward(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        check(torch.equal(states, rstates) and torch.equal(sf, rsf),
              f"rwkv6 forward: states or S_final not bitwise equal to the "
              f"plain pair's at {what}")
        got = [o, sf] + list(rwkv6_bwd_cuda(r, k, v, w, u, states, do, dsf,
                                            need_ds0=s0 is not None))
        want = [ro, rsf] + list(rwkv6_bwd_plain(r, k, v, w, u, s0, do, dsf,
                                                states=rstates))
        torch.cuda.synchronize()
        check(s0 is None or torch.equal(got[-1], want[-1]),
              f"rwkv6 backward: ds0 not bitwise equal to the plain pair's at "
              f"{what}")
        errs, abs_err = {}, {}
        for name, x, y in zip(names, got, want):
            check((x is None) == (y is None), f"rwkv6 {name} at {what}")
            if x is not None:
                check(x.shape == y.shape and bool(torch.isfinite(x).all()),
                      f"rwkv6 {name}: shape or non-finite values at {what}")
                abs_err[name] = (x - y).abs().max().item()
                errs[name] = abs_err[name] / max(y.abs().max().item(), 1e-30)
        worst = max(errs.values())
        check(worst <= RWKV_TOL, f"rwkv6 kernels disagree with the plain "
                                 f"pair at {what}: {errs}")
        return worst, errs, abs_err

    n_cases, max_err = 0, 0.0
    for shape in ((2, 64, 2, 32), (1, 96, 4, 64), (3, 40, 2, 64),
                  (1, 32, 1, 64), (1, 1000, 3, 64), (1, 5, 2, 64),
                  (1, 1, 2, 64), (3, 70, 5, 32), (1, 32, 2, 64),
                  (1, 224, 2, 64), (1, 256, 2, 32), (1, 280, 2, 64),
                  (2, 1056, 2, 64)):
        r, k, v, w, u, s0, do, dsf = inputs(*shape)
        for use_s0 in (False, True):
            for use_dsf in (False, True):
                err, _, _ = compare(r, k, v, w, u, s0 if use_s0 else None,
                                    do, dsf if use_dsf else None,
                                    f"{shape} s0={use_s0} "
                                    f"dS_final={use_dsf}")
                max_err = max(max_err, err)
                n_cases += 1
    print(f"rwkv6 kernels: {n_cases} small cases within {RWKV_TOL} of the "
          f"plain pair (max |diff| / max |plain| {max_err:.3g}), states, "
          f"S_final and ds0 bitwise")

    # the path's shape: one time-mix layer of rwkv6-1.6b at batch 1,
    # sequence 8192; the path passes no s0 and no dS_final
    shape = (BATCH, SEQ, RWKV_HEADS, RWKV_HEAD_SIZE)
    r, k, v, w, u, _, do, _ = inputs(*shape)
    path_err, errs, path_abs = compare(r, k, v, w, u, None, do, None,
                                       f"the path's shape {shape}")
    print(f"rwkv6 kernels: the path's shape {shape} within {RWKV_TOL} of the "
          f"plain pair: " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
          + "; states and S_final bitwise")
    max_err = max(max_err, path_err)
    # tp_path's rwkv6 cut at model 2: the second rank's H / 2 heads, sliced
    # from these whole-width tensors and made contiguous (the wrappers
    # refuse a strided view)
    h2 = RWKV_HEADS // TP_MODEL
    rank_part = lambda x: x[..., RWKV_HEADS - h2:, :].contiguous()
    rank_err, rank_errs, rank_abs = compare(
        *map(rank_part, (r, k, v, w, u)), None, rank_part(do), None,
        f"a model rank's heads {(BATCH, SEQ, h2, RWKV_HEAD_SIZE)}")
    print(f"rwkv6 kernels: a model rank's heads "
          f"{(BATCH, SEQ, h2, RWKV_HEAD_SIZE)} within {RWKV_TOL} of the "
          f"plain pair: " + ", ".join(f"{n} {e:.3g}"
                                      for n, e in rank_errs.items())
          + "; states and S_final bitwise")
    max_err = max(max_err, rank_err)
    _, _, states = rwkv6_fwd_cuda(r, k, v, w, u, save_states=True)
    b, s, h, d = shape
    n = b * s * h * d
    nc = -(-s // CHUNK)
    state_bytes = 4.0 * b * h * nc * d * d
    # what the forward's three passes move: pass 1 reads k, v, w and writes
    # every chunk's dS and e^{lw_end}; the scan reads and rewrites the
    # states, reads e^{lw_end} and writes S_final; pass 3 reads r, k, v, w
    # and the states and writes o.  The backward's four: pass 1 reads r, w,
    # do and writes every chunk's rd^T do and e^{lw_end}; the scan reads and
    # rewrites those products and reads e^{lw_end}; pass 3 reads r, k, v,
    # w, do, the states and the cotangents and writes dr, dk, dv, dw and
    # du's partials; pass 4 reads the partials and writes du.  The bound
    # counts each byte once.
    ew_bytes = 4.0 * b * h * nc * d
    design_bytes = {
        "rwkv6_fwd": (32.0 * n + 4 * state_bytes + 2 * ew_bytes
                      + 4.0 * b * h * d * d),
        "rwkv6_bwd": (48.0 * n + 5 * state_bytes + 4 * ew_bytes
                      + 4.0 * h * d)}
    passes = {"rwkv6_fwd": "three", "rwkv6_bwd": "four"}
    # flops a (b, h, chunk): forward A, A v, rd S, ke^T v; backward rd^T do,
    # A again, A^T do, ke dS, do v^T, dA kd, do S^T, dA^T rd, v dS^T
    tt, dd = 2.0 * CHUNK * CHUNK * d, 2.0 * CHUNK * d * d
    runs = {
        # read r, k, v, w; write o, the chunk-start states and S_final
        "rwkv6_fwd": (
            lambda: rwkv6_fwd_cuda(r, k, v, w, u, save_states=True),
            lambda: _chunked_forward(r, k, v, w, u),
            20.0 * n + state_bytes + 4.0 * b * h * d * d,
            (2 * tt + 2 * dd) * b * h * nc),
        # read r, k, v, w, do and the states; write dr, dk, dv, dw, du
        "rwkv6_bwd": (
            lambda: rwkv6_bwd_cuda(r, k, v, w, u, states, do),
            lambda: rwkv6_bwd_plain(r, k, v, w, u, None, do, states=states),
            36.0 * n + state_bytes + 4.0 * h * d,
            (5 * tt + 4 * dd) * b * h * nc),
    }
    note = {"rwkv6_fwd": "the chunked WKV forward of rwkv6_pallas: state "
                         "contributions, elementwise state scan, outputs",
            "rwkv6_bwd": "the WKV backward: the TPU kernel has none (JAX "
                         "differentiates rwkv6/ops.py::_chunked_jnp), so "
                         "this kernel is the port's own: rd^T do "
                         "contributions, elementwise reverse scan, "
                         "gradients at two CTAs an SM, du's sum"}
    fwd_outs = ("o", "S_final")
    both_abs = {n: max(e, rank_abs[n]) for n, e in path_abs.items()}
    abs_by = {"rwkv6_fwd": max(both_abs[n] for n in fwd_outs),
              "rwkv6_bwd": max(v for n, v in both_abs.items()
                               if n not in fwd_outs)}
    entries = []
    report["rwkv6"] = {"cases": n_cases, "shape": list(shape),
                       "max_rel_err": max_err, "path_rel_err": errs,
                       "model2_rel_err": rank_errs,
                       "model2_max_abs_err": rank_abs,
                       "path_max_abs_err": path_abs, "tolerance": RWKV_TOL}
    for name, (kern, plain, nbytes, flops) in runs.items():
        ms = time_ms(torch, kern, 10)
        plain_ms = time_ms(torch, plain, 2)
        torch.cuda.empty_cache()
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = flops / F32_FLOPS_PER_S * 1e3
        bound = max(bound_b, bound_o)
        by = "bytes" if bound_b >= bound_o else "operations"
        print(f"{name} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"library none, bound {bound:.3f} ms ({by}; bytes "
              f"{bound_b:.3f}, operations {bound_o:.3f}), "
              f"{flops / ms / 1e9:.2f} TFLOP/s, {nbytes / ms / 1e6:.0f} GB/s")
        report["rwkv6"][name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                     bound_bytes_ms=bound_b,
                                     bound_ops_ms=bound_o, bytes=nbytes,
                                     flops=flops)
        own = design_bytes[name]
        gbs = own / ms / 1e6
        print(f"{name}: its {passes[name]} passes move {own / 1e9:.3f} GB "
              f"({own / nbytes:.2f}x the bound's {nbytes / 1e9:.3f} GB), "
              f"{gbs:.0f} GB/s of that traffic, "
              f"{own / HBM_BYTES_PER_S * 1e3:.3f} ms at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
        per_launch = {re.search(r"rwkv6_\w+", k).group(0): v for k, v in
                      kernel_ms(torch, kern, 10, name).items()}
        print(f"{name} per launch: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in per_launch.items()))
        report["rwkv6"][name].update(design_bytes=own, design_gb_s=gbs,
                                     per_launch_ms=per_launch)
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:85",
            "replaces_note": note[name],
            "launches": None, "max_abs_err": abs_by[name],
            "max_rel_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None,
            "library_note": "no single PyTorch call computes this chunked "
                            "recurrence",
            "per_launch_ms": per_launch,
            "shape": f"r, k, v, w [B, S, H, D] = {list(shape)} f32, no s0 "
                     f"(one time-mix layer of rwkv6-1.6b)",
        })
    del r, k, v, w, u, do, states
    torch.cuda.empty_cache()
    return entries


def rwkv_grad_phase(torch, cfg, report):
    """One step's per-leaf gradients of the rwkv path (its params at seed 0,
    its first batch) three ways: through the WKV kernels, through the plain
    pair, and through the plain pair in float64 (inputs widened, outputs
    rounded back to f32; everything else the same f32 code).  The third is
    the yardstick: the kernels' gradients must lie no farther from it than
    twice the plain pair's, leaf by leaf (max |diff| / max |g|)."""
    import repro_torch.models.recurrent as rec
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.rwkv6.ops import _RWKV6
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    def mix_f64(r, k, v, w, u, s0=None, *, impl=None):
        o, sf = _RWKV6.apply(*(t.double() for t in (r, k, v, w, u)), None,
                             "chunked")
        return o.float(), sf.float()

    params = init_params(cfg, seed=0, device="cuda")
    batch = make_batch(cfg, 0, 0, BATCH, SEQ, device="cuda")
    grads, losses = {}, {}
    kernel_mix = rec.rwkv6_mix
    try:
        for tag in ("kernels", "plain", "f64"):
            for p in tree_leaves(params):
                p.grad = None
                p.requires_grad_(True)
            rec.rwkv6_mix = mix_f64 if tag == "f64" else kernel_mix
            loss, _ = loss_fn(params, cfg, batch, loss_chunk=LOSS_CHUNK,
                              scan_impl=None if tag == "kernels" else "plain")
            loss.backward()
            losses[tag] = loss.item()
            grads[tag] = [p.grad for p in tree_leaves(params)]
    finally:
        rec.rwkv6_mix = kernel_mix
    rows = {}
    for i, (path, _) in enumerate(tree_flatten_with_path(params)):
        ref = grads["f64"][i]
        scale = max(ref.abs().max().item(), 1e-30)
        rel = lambda a, b: (a - b).abs().max().item() / scale
        rows["/".join(path)] = dict(
            kernels_vs_plain=rel(grads["kernels"][i], grads["plain"][i]),
            kernels_vs_f64=rel(grads["kernels"][i], ref),
            plain_vs_f64=rel(grads["plain"][i], ref))
    del grads, params
    torch.cuda.empty_cache()
    worst = {k: max(r[k] for r in rows.values())
             for k in ("kernels_vs_plain", "kernels_vs_f64", "plain_vs_f64")}
    report["rwkv_grads"] = dict(losses=losses, worst=worst, leaves=rows)
    print(f"rwkv grads, one step, max |diff| / max |g| over the leaves: "
          f"kernels vs plain {worst['kernels_vs_plain']:.3g}, kernels vs "
          f"float64 WKV {worst['kernels_vs_f64']:.3g}, plain vs float64 WKV "
          f"{worst['plain_vs_f64']:.3g} (losses {losses})")
    bad = [p for p, r in rows.items()
           if r["kernels_vs_f64"] > 2 * r["plain_vs_f64"] + 1e-5]
    check(not bad, f"rwkv grads: the kernels' gradients of {bad} lie more "
                   f"than twice as far from the float64 WKV as the plain "
                   f"pair's: {[rows[p] for p in bad]}")


# ---------------------------------------------------------------------------
# the DeFT main path
# ---------------------------------------------------------------------------
def expected_launches(cfg, schedule, layout, steps, bucket_update=True):
    """Launches of each f32-path kernel in ``steps`` steps: every decoder
    layer (MLA ones with the attention ones) runs its forward twice (once
    more in the remat recompute) and
    its backward once, an encoder layer its forward once (the encoder has
    no remat); an encoder-decoder's ``cross_attn`` layer attends twice
    (self and cross), a VLM's once; every update launches the bucket
    update once per bucket, unless ``bucket_update`` is False (the
    baseline engines update with ``apply_updates_``, as JAX's tree and
    per-leaf engines never reach the Pallas update)."""
    kinds = [spec.kind for spec in cfg.layer_specs()]
    attn = sum(k in ("attn", "local_attn", "mla") for k in kinds)
    attn += (2 if cfg.is_encoder_decoder else 1) * kinds.count("cross_attn")
    rec = kinds.count("rglru")
    rwkv = kinds.count("rwkv")
    updates = sum(schedule.phases[i % schedule.period].do_update
                  for i in range(steps))
    flash = (2 * attn + cfg.n_encoder_layers) * steps
    return {"flash_fwd": flash, "flash_fwd_sm90": 0, "flash_fwd_sm90_mla": 0,
            "rglru_fwd": 2 * rec * steps,
            "rglru_bwd": rec * steps, "rwkv6_fwd": 2 * rwkv * steps,
            "rwkv6_bwd": rwkv * steps,
            "bucket_update": layout.n_buckets * updates if bucket_update
            else 0,
            "quantize_int8": 0, "dequantize_int8": 0,
            "stochastic_round_bf16": 0}


def zero_counters():
    """Set every kernel wrapper's launch count to 0 (``launches_bf16`` and
    ``launches_bf16_dims`` of the flash wrapper too) and return the
    wrappers, for :func:`kernel_launches` after the run they count."""
    from repro_torch.kernels.bucket_update import bucket_update_cuda
    from repro_torch.kernels.flash_attention import flash_fwd_cuda
    from repro_torch.kernels.quantize import (
        dequantize_int8_cuda,
        quantize_int8_cuda,
        stochastic_round_bf16_cuda,
    )
    from repro_torch.kernels.rglru import rglru_bwd_cuda, rglru_fwd_cuda
    from repro_torch.kernels.rwkv6 import rwkv6_bwd_cuda, rwkv6_fwd_cuda

    counters = (flash_fwd_cuda, bucket_update_cuda, quantize_int8_cuda,
                dequantize_int8_cuda, stochastic_round_bf16_cuda,
                rglru_fwd_cuda, rglru_bwd_cuda, rwkv6_fwd_cuda,
                rwkv6_bwd_cuda)
    for c in counters:
        c.launches = 0
    flash_fwd_cuda.launches_bf16 = 0
    flash_fwd_cuda.launches_bf16_dims.clear()
    return counters


def kernel_launches(counters):
    """Each kernel's launches from its wrapper's count; ``flash_fwd_cuda``
    counts both flash kernels, ``launches_bf16`` the tensor-core one's, of
    which ``flash_fwd_sm90_mla`` are its (192, 128) instantiation's."""
    from repro_torch.kernels.flash_attention import flash_fwd_cuda

    launches = {c.__name__.replace("_cuda", ""): c.launches for c in counters}
    launches["flash_fwd_sm90"] = flash_fwd_cuda.launches_bf16
    launches["flash_fwd_sm90_mla"] = \
        flash_fwd_cuda.launches_bf16_dims.get((192, 128), 0)
    launches["flash_fwd"] -= flash_fwd_cuda.launches_bf16
    return launches


def leaf_params(cfg) -> int:
    """The parameter count as the sum of the model's leaves (what the
    planner buckets), beside ``cfg.total_params()``'s formula."""
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_leaves

    return sum(x.numel() for x in tree_leaves(init_params(cfg, device="meta")))


def sharded_collectives(schedule, layout, steps, need_reuse=True):
    """What ``phase_collectives_sharded`` says each of ``steps`` steps of
    the sharded engine with the gather skip on issues: a position reuses
    its gather when it is not the first and the one before did not update;
    AdamW's grad clipping is on.  ``need_reuse``: the schedule must have
    such a position (the gemma2 runs, which exercise the skip)."""
    from repro_torch.train.runtime import phase_collectives_sharded

    period = schedule.period
    reuse = [(t > 0 and not schedule.phases[t - 1].do_update,) * layout.n_buckets
             for t in range(period)]
    check(not need_reuse or any(any(r) for r in reuse),
          "the sharded path's schedule has no position that reuses a gather")
    return [phase_collectives_sharded(schedule.phases[i % period], layout,
                                      reuse[i % period], True)
            for i in range(steps)]


def route_all_secondary(schedule, times):
    """The chain path's (schedule, AG plan): every synced bucket on the
    secondary link and every param gather on link 1, as the JAX package's
    4-device chain test forces them (``train(reroute=...)``)."""
    from repro_torch.core.deft import plan_ag_stream

    nb = len(schedule.phases[0].route_new)
    schedule = dataclasses.replace(schedule, phases=tuple(
        dataclasses.replace(ph, secondary=tuple(
            (ph.route_new[b] == "sync" and ph.rotate) or ph.sync_cur[b]
            for b in range(nb))) for ph in schedule.phases))
    ag = plan_ag_stream(schedule, times)
    return schedule, dataclasses.replace(ag, items=tuple(
        dataclasses.replace(i, link=1) for i in ag.items))


def stored_run(state, losses):
    """What a later path is held to: the losses up to and every param
    buffer after the first period (on the host)."""
    return {"losses": list(losses),
            "params": [b.to("cpu", copy=True) for b in state["pbuf"]]}


def held_to(key, against, state, losses):
    """Hold a run to ``against`` = (name, stored run, bitwise): every
    stored loss and every param buffer equal, or (not bitwise) the step-0
    loss equal and the params within PARAM_MAX_DIFF with at most
    PARAM_MAX_OVER elements beyond PARAM_TOL.  ``state["pbuf"]`` may make
    each bucket as it is read (a tree state's params flattened one bucket
    at a time, ``tree_buckets``).  Returns the distances, with whether
    the run came out bitwise anyway."""
    name, want, bitwise = against
    n = len(want["losses"])
    got = dict(against=name, bitwise=bitwise, max_param_diff=0.0,
               n_params_over_tol=0, n_params_differing=0)
    same_dtypes = True
    for buf, w in zip(state["pbuf"], want["params"]):
        # one bucket at a time, so the check adds one bucket to the peak
        d = (buf.float() - w.cuda().float()).abs()
        got["max_param_diff"] = max(got["max_param_diff"], d.max().item())
        got["n_params_over_tol"] += int((d > PARAM_TOL).sum().item())
        got["n_params_differing"] += int((d > 0).sum().item())
        same_dtypes &= buf.dtype == w.dtype
        del d, buf
    got["came_out_bitwise"] = (losses[:n] == want["losses"]
                               and got["n_params_differing"] == 0
                               and same_dtypes)
    if bitwise:
        check(got["came_out_bitwise"],
              f"{key} is not bitwise {name}: losses {losses[:n]} vs "
              f"{want['losses']}, {got['n_params_differing']} params differ "
              f"(max |diff| {got['max_param_diff']:.3g})")
    else:
        check(losses[0] == want["losses"][0],
              f"{key} step-0 loss {losses[0]!r} is not {name}'s "
              f"{want['losses'][0]!r}")
        check(got["max_param_diff"] <= PARAM_MAX_DIFF
              and got["n_params_over_tol"] <= PARAM_MAX_OVER,
              f"{key} params after the first period vs {name}: max |diff| "
              f"{got['max_param_diff']:.3g}, {got['n_params_over_tol']} "
              f"elements beyond {PARAM_TOL}")
    return got


def print_against(report, against, dist_):
    """One line: how a run compares with the stored one, beside that
    run's step time, tokens/s and peak."""
    name, _, bitwise = against
    rep = report[name]
    print(f"  vs {name}: "
          + ("every loss and param bitwise equal" if bitwise else
             f"step-0 loss bitwise equal, params max diff "
             f"{dist_['max_param_diff']:.3g} "
             f"({dist_['n_params_over_tol']} over {PARAM_TOL})")
          + f"; its median step {rep['median_step_s']:.3f} s, "
          f"{rep['tokens_per_s']:.0f} tok/s, peak "
          f"{rep['peak_bytes'] / 2**30:.2f} GiB")


def main_path(torch, cfg, schedule, report, key, arch, of_layers, steps,
              bucket_share=None, fsdp=False, decoupled=False, chain=False,
              store=None, against=None, seq=SEQ, need_reuse=True):
    """One f32 DeFT path at sequence ``seq``: the first schedule period
    once with every plain version forced, then ``steps`` steps with every
    launch counter set to 0 just before and read just after, held to the
    plain run.

    ``bucket_share`` replaces the element-count limit on the params by a
    share of each bucket's elements beyond 10 * PARAM_TOL, with every
    param within RWKV_PARAM_MAX_DIFF (the rwkv path: see its limits).

    ``fsdp`` runs the sharded flat engine (one shard on the one card) with
    the gather skip on (``need_reuse``: its schedule must reuse a gather
    somewhere); ``decoupled`` streams its param gathers into the
    forward (and prints the buckets' first-touch order and the gathers
    issued before the forward's first compute); ``chain`` routes every
    synced bucket and every param gather along the one-rank chain (0,)
    (``route_all_secondary``), which must run no P2P op.  ``store`` (a
    dict) receives the run's losses over and params after the first
    period; ``against`` = (name, stored run, bitwise) holds the run to one
    stored earlier (``held_to``)."""
    from repro_torch.launch.train import train
    from repro_torch.train.runtime import phase_collectives

    gc.collect()                 # an earlier path's state is gone first
    torch.cuda.empty_cache()
    period = schedule.period
    check(not decoupled or steps > period,
          f"{key}: a streamed run records its order at the second cycle's "
          f"first step, so it needs more than {period} steps")
    kw = dict(scheduler="deft", batch=BATCH, seq=seq,
              coverage_rate=COVERAGE_RATE, partition_elems=PARTITION_ELEMS,
              seed=0, device="cuda", lr=LR, loss_chunk=LOSS_CHUNK, fsdp=fsdp)
    if fsdp:
        kw.update(decoupled=decoupled)
    if chain:
        kw.update(secondary_chain=(0,), reroute=route_all_secondary)

    # reference: the first period with the plain versions forced
    ref = train(cfg, steps=period, attn_impl="plain", scan_impl="plain",
                update_impl="plain", log=lambda s: print("  plain: " + s),
                **kw)
    ref_losses = ref["losses"]
    ref_params = [b.cpu() for b in ref["state"]["pbuf"]]
    del ref
    torch.cuda.empty_cache()

    agree = {}
    vs_stored = {}
    stream = {}
    p2p = []
    run_losses = []

    def on_step(step, runtime, state, metrics):
        p2p.extend(runtime.last_p2p)
        run_losses.append(float(metrics["loss"]))
        if decoupled and step == period:      # position 0, order recorded
            stream.update(runtime.last_stream)
        if step != period - 1:
            return
        if fsdp:
            st = runtime.stats()
            check(st["sharded_state"]
                  and st["gather_skip"] == need_reuse
                  and st["decoupled"] == decoupled
                  and [b.numel() for b in state["pbuf"]]
                  == list(runtime.layout.shard_sizes),
                  f"{key} is not the sharded engine with the gather skip "
                  f"{'on' if need_reuse else 'off'}"
                  f"{' streamed' if decoupled else ''}")
        if store is not None:
            store.update(stored_run(state, run_losses))
        if against is not None:
            vs_stored.update(held_to(key, against, state, run_losses))
        per_bucket = []
        for buf, want in zip(state["pbuf"], ref_params):
            d = (buf - want.cuda()).abs()
            per_bucket.append((d.max().item(),
                               int((d > PARAM_TOL).sum().item()),
                               int((d > 10 * PARAM_TOL).sum().item()),
                               int((d > LR).sum().item())))
        agree.update(
            max_param_diff=max(x[0] for x in per_bucket),
            n_params_over_tol=sum(x[1] for x in per_bucket),
            n_params=sum(b.numel() for b in ref_params),
            bucket_max_diff=[x[0] for x in per_bucket],
            bucket_over_tol=[x[1] for x in per_bucket],
            bucket_over_1e4=[x[2] for x in per_bucket],
            bucket_over_lr=[x[3] for x in per_bucket],
            bucket_sizes=[b.numel() for b in ref_params])

    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    res = train(cfg, steps=steps, on_step=on_step,
                log=lambda s: print("  " + s), **kw)
    launches = kernel_launches(counters)
    peak = torch.cuda.max_memory_allocated()

    losses = res["losses"]
    want = expected_launches(cfg, schedule, res["layout"], steps)
    check(launches == want, f"{key} launches {launches}, expected {want}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(against is None or vs_stored,
          f"{key} was not held to {against and against[0]}")
    if chain:
        # the rerouted schedule's counts, with every chained collective
        routed = res["schedule"]
        check(all(ph.secondary[b] == ((ph.route_new[b] == "sync"
                                       and ph.rotate) or ph.sync_cur[b])
                  for ph in routed.phases for b in range(len(ph.secondary))),
              f"{key}: not every synced bucket is on the secondary link")
        per_phase = res["runtime"].collectives_per_phase()
        wants = [per_phase[i % period] for i in range(steps)]
        chained = sum(c["chained"] for c in res["collectives"])
        check(chained > 0 and not p2p
              and all(c["chain_rounds"] == 0 for c in res["collectives"]),
              f"{key}: {chained} chained collectives, {len(p2p)} P2P rounds "
              f"(one rank: the chain must route and move nothing)")
    elif fsdp:
        wants = sharded_collectives(schedule, res["layout"], steps,
                                    need_reuse)
    else:
        wants = [phase_collectives(schedule.phases[i % period])
                 for i in range(steps)]
    for i, (got, want) in enumerate(zip(res["collectives"], wants)):
        check(got == want, f"step {i}: issued {got}, schedule says {want}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    check(rel <= 1e-4, f"{key} losses vs the plain run: rel diff {rel:.3g} "
                       f"({losses[:period]} vs {ref_losses})")
    # a bucket whose update went wrong or did not happen moves by ~LR, ten
    # times PARAM_MAX_DIFF, nearly every element of it; the two runs differ
    # only by rounding
    agree["bucket_share_over_1e4"] = [
        n / size for n, size in zip(agree["bucket_over_1e4"],
                                    agree["bucket_sizes"])]
    if bucket_share is None:
        bad = [b for b, m in enumerate(agree["bucket_max_diff"])
               if m > PARAM_MAX_DIFF]
        ok = not bad and agree["n_params_over_tol"] <= PARAM_MAX_OVER
    else:
        bad = [b for b, (m, f) in enumerate(zip(
            agree["bucket_max_diff"], agree["bucket_share_over_1e4"]))
            if m > RWKV_PARAM_MAX_DIFF or f > bucket_share]
        ok = not bad
    check(ok, f"{key} params after the first period vs the plain run: "
              f"buckets {bad} beyond their limits (max |diff| "
              f"{agree['bucket_max_diff']}, shares beyond {10 * PARAM_TOL} "
              f"{agree['bucket_share_over_1e4']}), "
              f"{agree['n_params_over_tol']} elements beyond {PARAM_TOL}")
    step_s = statistics.median(res["step_s"][1:])
    out = dict(
        config=dict(arch=arch, n_layers=cfg.n_layers, of_layers=of_layers,
                    params=leaf_params(cfg),
                    params_formula=cfg.total_params(), batch=BATCH, seq=seq,
                    coverage_rate=COVERAGE_RATE,
                    partition_elems=PARTITION_ELEMS, loss_chunk=LOSS_CHUNK),
        n_buckets=res["layout"].n_buckets, period=period,
        updates_per_period=schedule.updates_per_period,
        batch_size_sequence=list(schedule.batch_size_sequence),
        steps=steps, losses=losses, ref_losses=ref_losses,
        loss_rel_diff=rel, step_s=res["step_s"], median_step_s=step_s,
        tokens_per_s=BATCH * seq / step_s, peak_bytes=peak,
        launches=launches, collectives=res["collectives"], **agree)
    if fsdp:
        out.update(
            gathered_bytes=4 * sum(res["layout"].buf_sizes),
            stats={k: v for k, v in res["runtime"].stats().items()
                   if k != "phases"})
    if against is not None:
        out["against"] = vs_stored
    if decoupled:
        out["stream"] = {k: list(v) if isinstance(v, tuple) else v
                         for k, v in stream.items()}
    if chain:
        out.update(chained=chained, p2p_rounds=len(p2p))
    report[key] = out
    print(f"{key} ({arch}, {cfg.n_layers} of {of_layers} layers): {steps} "
          f"steps, median step {step_s:.3f} s, "
          f"{BATCH * seq / step_s:.0f} tok/s, peak memory "
          f"{peak / 2**30:.2f} GiB [{report['card']}], launches {launches}, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, vs plain: loss rel "
          f"{rel:.2g}, params max diff {agree['max_param_diff']:.3g} "
          f"({agree['n_params_over_tol']} of {agree['n_params']} over "
          f"{PARAM_TOL})")
    if against is not None:
        print_against(report, against, vs_stored)
    if fsdp and not decoupled:
        print(f"  the gathered f32 params: "
              f"{out['gathered_bytes'] / 2**30:.2f} GiB")
    if decoupled:
        print(f"  streamed: buckets first touched in the order "
              f"{list(stream['touched'])}; {stream['issued_at_first_touch']} "
              f"param gathers issued before the forward's first compute "
              f"(the burst engine: every bucket's, "
              f"{res['layout'].n_buckets})")
    if chain:
        print(f"  chain (0,): {chained} collectives routed onto it, "
              f"{len(p2p)} P2P rounds")
    del res
    torch.cuda.empty_cache()
    return launches


def tree_buckets(layout, params):
    """The param buffers ``held_to`` reads, made from a tree state's
    params one bucket at a time (``flatten_bucket``)."""
    from repro_torch.train.bucketing import flatten_bucket
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(params)
    return (flatten_bucket(layout, leaves, b) for b in range(layout.n_buckets))


def baselines_path(torch, cfg, schedule, bucket_of, layout, report, against):
    """The two baseline engines on the main path's configuration, each for
    two schedule periods from the seed-0 params over the main path's
    batches, with every launch counter set to 0 just before and read just
    after: the per-leaf steps (``make_deft_step_fns``: one collective a
    synced leaf, one all-reduce a metric), then the tree-state engine
    (``DeftRuntime(flat_state=False)``: the flat engine's collectives).
    Each is held to the main path's stored run (``against``, not bitwise:
    the step-0 loss equal, the params after the first period within
    PARAM_MAX_DIFF / PARAM_MAX_OVER; whether they came out bitwise anyway
    is printed), launches the f32 flash 16 times a step and the bucket
    update never (``apply_updates_`` takes its place, as JAX's tree and
    per-leaf engines never reach the Pallas update), and prints its median
    step, tokens/s, peak and collectives per phase beside the main
    path's."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train.runtime import DeftRuntime, phase_collectives
    from repro_torch.train.steps import (
        init_train_state,
        make_deft_step_fns,
        phase_collectives_per_leaf,
    )

    period = schedule.period
    steps = 2 * period
    out = report.setdefault("baselines_path", {})
    all_launches = {}
    for engine in ("per_leaf", "tree"):
        gc.collect()
        torch.cuda.empty_cache()
        key = f"baselines_path {engine}"
        if engine == "per_leaf":
            fns = make_deft_step_fns(cfg, adamw(LR), schedule, bucket_of,
                                     loss_chunk=LOSS_CHUNK)
            state = init_train_state(cfg, adamw(LR), deft=True, seed=0,
                                     device="cuda")
            wants = [phase_collectives_per_leaf(ph, bucket_of, 2)
                     for ph in schedule.phases]
        else:
            rt = DeftRuntime(cfg, adamw(LR), schedule, layout, device="cuda",
                             loss_chunk=LOSS_CHUNK, flat_state=False)
            state = rt.init_state(0)
            wants = [phase_collectives(ph) for ph in schedule.phases]
            check(rt.collectives_per_phase() == wants,
                  f"{key}: not the flat engine's collectives")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = zero_counters()
        losses, step_s, colls, vs = [], [], [], {}
        for i in range(steps):
            batch = make_batch(cfg, 0, i, BATCH, SEQ, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if engine == "per_leaf":
                fn = fns[i % period]
                state, m = fn(state, batch)
                colls.append(fn.last_collectives)
            else:
                state, m = rt.step(i, state, batch)
                colls.append(rt.last_collectives)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            del batch
            if i == period - 1:
                vs = held_to(key, against, {"pbuf": tree_buckets(
                    layout, state["params"])}, losses)
        launches = kernel_launches(counters)
        peak = torch.cuda.max_memory_allocated()
        want = expected_launches(cfg, schedule, layout, steps,
                                 bucket_update=False)
        check(launches == want, f"{key} launches {launches}, expected {want}")
        check(all(math.isfinite(x) for x in losses),
              f"{key}: non-finite loss {losses}")
        for i, c in enumerate(colls):
            check(c == wants[i % period],
                  f"{key} step {i}: issued {c}, schedule says "
                  f"{wants[i % period]}")
        med = statistics.median(step_s[1:])
        out[engine] = dict(
            steps=steps, losses=losses, step_s=step_s, median_step_s=med,
            tokens_per_s=BATCH * SEQ / med, peak_bytes=peak,
            launches=launches, collectives_per_phase=wants, against=vs)
        print(f"{key} ({ARCH}, {cfg.n_layers} of 26 layers): {steps} steps, "
              f"median step {med:.3f} s, {BATCH * SEQ / med:.0f} tok/s, peak "
              f"memory {peak / 2**30:.2f} GiB [{report['card']}], launches "
              f"{launches}, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"collectives per phase {wants}; params after the first "
              f"period {'bitwise' if vs['came_out_bitwise'] else 'not bitwise'}"
              f" the stored run's")
        print_against(report, against, vs)
        all_launches[engine] = launches
        del state, m
        if engine == "per_leaf":
            del fns
        else:
            del rt
    gc.collect()
    torch.cuda.empty_cache()
    return all_launches


def moe_smoke_path(torch, report):
    """The MoE families at smoke size (``reduce_for_smoke``): deepseek-v2-
    236b-smoke (a dense layer 0, then MLA at d_qk / d_v 48 / 32 with a MoE
    of 4 experts, top-2, one shared) and llama4-maverick-400b-a17b-smoke
    (attention with a dense FFN, then with a top-1 MoE), each through
    ``train`` on its default sharded engine, MOE_STEPS steps: once with the
    plain versions forced, then twice with the counters zeroed just before
    and read just after each.  The two runs must be bitwise equal (every
    loss and param: no float sum of the MoE routing depends on the order
    of atomics), launch each kernel as ``expected_launches`` says, and
    agree with the plain run (every loss within 1e-4 relative, params
    within PARAM_MAX_DIFF with at most PARAM_MAX_OVER beyond PARAM_TOL).
    Prints each step's aux loss.  Returns the two configs' launches summed
    over their first runs."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.train import train

    total = {}
    report["moe_smoke_path"] = out = {}
    for arch in MOE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = reduce_for_smoke(get_config(arch))
        kw = dict(scheduler="deft", batch=MOE_BATCH, seq=MOE_SEQ,
                  coverage_rate=COVERAGE_RATE,
                  partition_elems=PARTITION_ELEMS, seed=0, device="cuda",
                  lr=LR, log=lambda s: None)
        ref = train(cfg, steps=MOE_STEPS, attn_impl="plain",
                    update_impl="plain", **kw)
        ref_losses = ref["losses"]
        ref_params = [b.cpu() for b in ref["state"]["pbuf"]]
        del ref
        runs = []
        for _ in range(2):
            aux = []
            counters = zero_counters()
            res = train(cfg, steps=MOE_STEPS, on_step=lambda s, rt, st, m:
                        aux.append(float(m["aux"])), **kw)
            launches = kernel_launches(counters)
            check(res["runtime"].stats()["sharded_state"],
                  f"{cfg.name} did not run the sharded engine")
            runs.append(dict(losses=res["losses"], launches=launches,
                             aux=aux, schedule=res["schedule"],
                             layout=res["layout"],
                             params=[b.cpu() for b in res["state"]["pbuf"]]))
            del res
        a, b = runs
        want = expected_launches(cfg, a["schedule"], a["layout"], MOE_STEPS)
        check(a["schedule"].period * 2 <= MOE_STEPS,
              f"{cfg.name}: {MOE_STEPS} steps short of two periods")
        check(a["losses"] == b["losses"] and a["aux"] == b["aux"]
              and all(torch.equal(x, y) for x, y in zip(a["params"],
                                                        b["params"])),
              f"{cfg.name}: two runs on the card differ: losses {a['losses']} "
              f"vs {b['losses']}")
        check(a["launches"] == b["launches"] == want,
              f"{cfg.name} launches {a['launches']} / {b['launches']}, "
              f"expected {want}")
        check(all(math.isfinite(x) for x in a["losses"]) and min(a["aux"]) > 0,
              f"{cfg.name}: losses {a['losses']}, aux {a['aux']}")
        rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], ref_losses))
        diffs = [(x - y).abs() for x, y in zip(a["params"], ref_params)]
        max_diff = max(d.max().item() for d in diffs)
        over = sum(int((d > PARAM_TOL).sum().item()) for d in diffs)
        check(rel <= 1e-4 and max_diff <= PARAM_MAX_DIFF
              and over <= PARAM_MAX_OVER,
              f"{cfg.name} vs its plain run: loss rel {rel:.3g}, params max "
              f"|diff| {max_diff:.3g}, {over} beyond {PARAM_TOL}")
        for k_, n in a["launches"].items():
            total[k_] = total.get(k_, 0) + n
        out[cfg.name] = dict(
            steps=MOE_STEPS, batch=MOE_BATCH, seq=MOE_SEQ,
            n_buckets=a["layout"].n_buckets, period=a["schedule"].period,
            losses=a["losses"], ref_losses=ref_losses, aux=a["aux"],
            loss_rel_diff=rel, max_param_diff=max_diff,
            n_params_over_tol=over, launches=a["launches"])
        print(f"moe_smoke_path {cfg.name} (sharded, {MOE_STEPS} steps, batch "
              f"{MOE_BATCH}, seq {MOE_SEQ}, {a['layout'].n_buckets} buckets, "
              f"period {a['schedule'].period}): two runs bitwise equal; vs "
              f"plain: loss rel {rel:.2g}, params max diff {max_diff:.3g} "
              f"({over} over {PARAM_TOL}); launches {a['launches']}; loss "
              f"{a['losses'][0]:.4f} -> {a['losses'][-1]:.4f}; aux by step "
              f"{[round(x, 6) for x in a['aux']]} [{report['card']}]")
    return total


def moe_width_phase(torch, report):
    """``apply_moe`` at deepseek-v2-236b's published widths (160 routed
    experts of d_expert 1536, top-6, 2 shared, d_model 5120) on one
    [1, MOE_WIDTH_SEQ, 5120] input: 24,576 (token, choice) pairs into 160
    queues of capacity ceil(T k / E 1.25) = 192, some of which must
    overflow.  Forward
    and backward (loss sum(out * g) + aux, gradients of the input and
    every weight) run twice and must be bitwise equal; the second is timed
    with CUDA events and the first's peak memory read.  Then a float64
    reference written apart from the module: the choices by a lexsort of
    the f32 router probabilities (ties to the lower expert), the queues
    filled by a loop over the pairs in token-major order, each expert's
    SwiGLU on its kept tokens, the router, renormalisation, aux loss and
    shared experts, all in float64 with autograd.  out, aux and every
    gradient must be within MOE_WIDTH_TOL of it (max |diff| over the
    reference's max |element|).  Returns the first run's out, aux and
    gradients on the host by name, what ``tp_path``'s model-2 cut of this
    FFN is held to."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.models.moe import apply_moe

    gc.collect()
    torch.cuda.empty_cache()
    cfg, p, x, g = moe_width_inputs(torch)
    me = cfg.moe
    e, k, d, de = me.n_experts, me.experts_per_token, cfg.d_model, me.d_expert
    t = MOE_WIDTH_SEQ
    cap = math.ceil(t * k / e * 1.25)
    names = MOE_WIDTH_NAMES
    leaves = moe_width_leaves(p, x)
    n_params = sum(leaf.numel() for leaf in leaves[1:])

    def run():
        y, aux = apply_moe(p, x, cfg=cfg)
        grads = torch.autograd.grad(torch.sum(y * g) + aux, leaves)
        return [y.detach(), aux.detach(), *grads]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    second = run()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "apply_moe at deepseek-v2-236b's widths: two runs on the card "
          "differ")
    del second
    y, aux, *grads = first

    # the float64 reference
    x64 = x.detach().reshape(t, d).double()
    g64 = g.detach().reshape(t, d).double()
    with torch.no_grad():
        probs32 = torch.softmax(x.detach().reshape(t, d) @ p["router"].detach(),
                                -1).cpu().numpy()
    sel = np.lexsort((np.broadcast_to(np.arange(e), (t, e)), -probs32),
                     axis=-1)[:, :k]
    queues = [[] for _ in range(e)]
    for i in range(t):
        for j in range(k):
            if len(queues[sel[i, j]]) < cap:
                queues[sel[i, j]].append((i, j))
    kept = sum(len(q) for q in queues)
    check(kept < t * k, f"apply_moe at deepseek-v2-236b's widths: no queue "
          f"overflowed (capacity {cap})")
    sel_t = torch.from_numpy(np.ascontiguousarray(sel)).cuda()
    xr = x64.clone().requires_grad_(True)
    r64 = p["router"].detach().double().requires_grad_(True)
    probs = torch.softmax(xr @ r64, -1)
    top = probs.gather(1, sel_t)
    w = top / top.sum(-1, keepdim=True)
    density = F.one_hot(sel_t, e).sum(1).double().mean(0)
    aux64 = me.router_aux_coef * e * torch.sum(density / k * probs.mean(0))
    out64 = torch.zeros_like(x64)
    dx64 = torch.zeros_like(x64)
    dw64 = torch.zeros_like(w)
    diff = {n: torch.zeros((), dtype=torch.float64, device="cuda")
            for n in names[2:5]}
    scale = dict(diff)

    def swiglu(x_, wg, wu, wd):
        return (F.silu(x_ @ wg) * (x_ @ wu)) @ wd

    for ex in range(e):
        ws = [p["experts"][n][ex].detach().double().requires_grad_(True)
              for n in ("gate", "up", "down")]
        if queues[ex]:
            ti, tj = (torch.tensor(c, device="cuda")
                      for c in zip(*queues[ex]))
            xe = x64[ti].requires_grad_(True)
            ye = swiglu(xe, *ws)
            we = w.detach()[ti, tj][:, None]
            out64.index_add_(0, ti, we * ye.detach())
            dw64[ti, tj] = torch.sum(ye.detach() * g64[ti], -1)
            gx, *gws = torch.autograd.grad(ye, (xe, *ws), g64[ti] * we)
            dx64.index_add_(0, ti, gx)
        else:
            gws = [torch.zeros_like(w_) for w_ in ws]
        for n, gw, mine in zip(names[2:5], gws, grads[2:5]):
            diff[n] = torch.maximum(diff[n], (mine[ex].double() - gw).abs().max())
            scale[n] = torch.maximum(scale[n], gw.abs().max())
    dxr, dr = torch.autograd.grad(torch.sum(w * dw64) + aux64, (xr, r64))
    xs = x64.clone().requires_grad_(True)
    sh = [p["shared"][n].detach().double().requires_grad_(True)
          for n in ("gate", "up", "down")]
    ys = swiglu(xs, *sh)
    gxs, *gsh = torch.autograd.grad(ys, (xs, *sh), g64)
    out64 += ys.detach()
    want = {"out": out64, "x": dx64 + dxr + gxs, "router": dr,
            **dict(zip(names[5:], gsh))}
    mine = {"out": y.reshape(t, d), "x": grads[0].reshape(t, d),
            "router": grads[1], **dict(zip(names[5:], grads[5:]))}
    errs = {n: ((mine[n].double() - want[n]).abs().max()
                / want[n].abs().max()).item() for n in want}
    errs.update({n: (diff[n] / scale[n]).item() for n in diff})
    errs["aux"] = abs(aux.item() - aux64.item()) / aux64.item()
    worst = max(errs, key=errs.get)
    check(errs[worst] <= MOE_WIDTH_TOL,
          f"apply_moe at deepseek-v2-236b's widths against float64: {worst} "
          f"off by {errs[worst]:.3g} of its scale (limit {MOE_WIDTH_TOL})")
    # the experts' three bmms, 2 E C d de flops each, backward twice that
    flops = 18 * e * cap * d * de
    report["moe_width"] = dict(
        seq=t, n_experts=e, top_k=k, capacity=cap, kept=kept,
        dropped=t * k - kept, n_params=n_params, ms=ms, peak_bytes=peak,
        expert_tflops=flops / ms / 1e9, rel_err=errs)
    print(f"moe_width {MLA_ARCH} MoE FFN (d_model {d}, {e} experts of "
          f"{de} top-{k} + {me.n_shared_experts} shared, {n_params:,} params; "
          f"1 x {t} tokens, capacity {cap}, {t * k - kept} of {t * k} choices "
          f"dropped): forward + backward {ms:.3f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s in the experts' products), peak "
          f"{peak / 2 ** 30:.2f} GiB; two runs bitwise equal; against float64 "
          f"(max |diff| / max |f64|): "
          f"{', '.join(f'{n} {v:.2g}' for n, v in errs.items())} "
          f"[{report['card']}]")
    host = {"out": y.cpu(), "aux": aux.cpu(),
            **{n: gr.cpu() for n, gr in zip(names, grads)}}
    del first, y, grads, p, leaves, x, g
    gc.collect()
    torch.cuda.empty_cache()
    return host


MOE_WIDTH_NAMES = ("x", "router", "experts/gate", "experts/up",
                   "experts/down", "shared/gate", "shared/up", "shared/down")


def moe_width_inputs(torch):
    """``moe_width_phase``'s config, MoE params, input and output
    cotangent, drawn from seed 0 on the card (every caller draws the same)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import init_moe

    cfg = get_config(MLA_ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    p = init_moe(gen, cfg, device="cuda")
    # a direction shared by every token (0.1 of the noise's scale) skews
    # the random router's load as a residual stream's mean does: about 20
    # queues overflow, where iid inputs often fill none past capacity
    x = torch.randn((1, MOE_WIDTH_SEQ, cfg.d_model), device="cuda",
                    generator=gen)
    x += 0.1 * torch.randn((cfg.d_model,), device="cuda", generator=gen)
    g = torch.randn((1, MOE_WIDTH_SEQ, cfg.d_model), device="cuda",
                    generator=gen)
    return cfg, p, x, g


def moe_width_leaves(p, x):
    """The tensors ``moe_width_phase`` differentiates, in
    MOE_WIDTH_NAMES's order, each made to require grad."""
    leaves = [x, p["router"], *(p["experts"][n] for n in ("gate", "up", "down")),
              *(p["shared"][n] for n in ("gate", "up", "down"))]
    for leaf in leaves:
        leaf.requires_grad_(True)
    return leaves


def promotion_dtypes(torch, cfg, params, seq):
    """One forward of ``loss_fn`` (no gradient) on ``params`` over step 0's
    batch, recording the dtypes at jnp's promotion points: the encoder's
    output, the cross-attention K/V, each cross-attention's output and
    each decoder block's residual stream.  Returns {point: sorted dtype
    names}."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import blocks, model

    seen = {"encoder": set(), "cross_kv": set(), "cross_out": set(),
            "residual": set()}
    orig = (model.encode, blocks.cross_kv, blocks.apply_cross_attention,
            model.apply_block)

    def encode(*a, **kw):
        out = orig[0](*a, **kw)
        seen["encoder"].add(out.dtype)
        return out

    def cross_kv(*a, **kw):
        k, v = orig[1](*a, **kw)
        seen["cross_kv"].update((k.dtype, v.dtype))
        return k, v

    def cross(*a, **kw):
        out = orig[2](*a, **kw)
        seen["cross_out"].add(out.dtype)
        return out

    def block(*a, **kw):
        x, aux = orig[3](*a, **kw)
        if "memory" in kw:           # a decoder block (the encoder's has none)
            seen["residual"].add(x.dtype)
        return x, aux

    model.encode, blocks.cross_kv = encode, cross_kv
    blocks.apply_cross_attention, model.apply_block = cross, block
    try:
        batch = make_batch(cfg, 0, 0, BATCH, seq, device="cuda")
        with torch.no_grad():
            model.loss_fn(params, cfg, batch, remat=False,
                          loss_chunk=LOSS_CHUNK)
    finally:
        (model.encode, blocks.cross_kv, blocks.apply_cross_attention,
         model.apply_block) = orig
    return {k: sorted(str(d).replace("torch.", "") for d in v)
            for k, v in seen.items()}


def precision_path(torch, cfg, report, key, coverage_rate, delayed,
                   fsdp=False, decoupled=False, store=None, against=None,
                   seq=SEQ, compute_dtype=None, need_reuse=True,
                   f32_key="main_path"):
    """DeFT's precision path at ``cfg``'s cut and sequence ``seq`` (batch
    BATCH): int8 gradient wires on every bucket and a bf16sr resident
    master (so the forward and backward run in bf16 on the bf16 params),
    ``compute_dtype`` when given.  ``delayed`` requires a schedule that
    merges (update_k > 1) and rotates generations, with a merged update in
    the comparison window.  Each flash call runs the kernel of the dtype
    jnp's promotion gives it: every self-attention (and MLA's, at its
    (192, 128) instantiation) the bf16 kernel, an encoder's attention and
    each cross-attention to the f32 stub memory the f32 kernel; a config
    with a stub memory also has its promotion points' dtypes recorded in
    one forward (``promotion_dtypes``).

    ``fsdp`` runs it on the sharded flat engine (one shard) with the gather
    skip on where the schedule reuses a gather (``need_reuse``) and bf16
    compute (that engine reads params at the compute dtype): each gathered
    bucket then runs int8 through the quantize and dequantize kernels too,
    as its values and scales are all-gathered; ``decoupled`` streams those
    gathers into the forward.  ``store`` and ``against`` are
    ``main_path``'s, over the comparison window; ``f32_key`` names the
    same config's f32 run it is printed beside."""
    from repro_torch.launch.train import train
    from repro_torch.train.runtime import phase_collectives

    gc.collect()                 # the f32 path's state is gone first
    torch.cuda.empty_cache()
    kw = dict(scheduler="deft", batch=BATCH, seq=seq,
              coverage_rate=coverage_rate, partition_elems=PARTITION_ELEMS,
              seed=0, device="cuda", lr=LR, loss_chunk=LOSS_CHUNK,
              wire_precision=WIRE, master_dtype=MASTER)
    if compute_dtype is not None:
        kw.update(compute_dtype=compute_dtype)
    if fsdp:
        kw.update(fsdp=True, compute_dtype="bf16", decoupled=decoupled)
    window = PREC_REF_STEPS

    # reference: the first steps with every kernel's plain version forced
    ref = train(cfg, steps=window, attn_impl="plain", update_impl="plain",
                quantize_impl="plain", log=lambda s: print("  plain: " + s),
                **kw)
    ref_losses = ref["losses"]
    ref_params = [b.cpu() for b in ref["state"]["pbuf"]]
    del ref
    torch.cuda.empty_cache()

    agree = {}
    vs_stored = {}
    stream = {}
    run_losses = []

    def on_step(step, runtime, state, metrics):
        run_losses.append(float(metrics["loss"]))
        if decoupled and step == window:      # position 0, order recorded
            stream.update(runtime.last_stream)
        if step != window - 1:
            return
        if store is not None:
            store.update(stored_run(state, run_losses))
        if against is not None:
            vs_stored.update(held_to(key, against, state, run_losses))
        per_bucket = []
        for buf, want in zip(state["pbuf"], ref_params):
            w = want.cuda().float()
            d = (buf.float() - w).abs()
            per_bucket.append((d.max().item(),
                               int((d > 1e-4 + w.abs() / 128).sum().item()),
                               int((d > 0).sum().item())))
        agree.update(
            max_param_diff=max(m for m, _, _ in per_bucket),
            n_params_over_ulp=sum(n for _, n, _ in per_bucket),
            n_params_differing=sum(n for _, _, n in per_bucket),
            n_params=sum(b.numel() for b in ref_params),
            bucket_max_diff=[m for m, _, _ in per_bucket],
            bucket_share_over_ulp=[n / b.numel() for (_, n, _), b
                                   in zip(per_bucket, ref_params)])

    steps = PREC_STEPS
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    res = train(cfg, steps=steps, on_step=on_step,
                log=lambda s: print("  " + s), **kw)
    launches = kernel_launches(counters)
    peak = torch.cuda.max_memory_allocated()

    rt, state, schedule = res["runtime"], res["state"], res["schedule"]
    layout = res["layout"]
    period, nb = schedule.period, layout.n_buckets
    losses = res["losses"]
    check(layout.precision is not None
          and set(layout.precision.wire) == {WIRE}
          and layout.precision.master == MASTER,
          f"the precision path did not take the {WIRE}/{MASTER} policy")
    check(all(p.dtype == torch.bfloat16 for p in state["pbuf"]),
          "a bf16sr master buffer is not bf16")
    check(not delayed or (any(ph.update_k > 1 for ph in schedule.phases)
                          and any(ph.rotate for ph in schedule.phases)),
          f"the {key} schedule neither merges updates nor rotates")
    check(window <= steps and (not delayed or any(
        ph.do_update and ph.update_k > 1
        for ph in schedule.phases[:window])),
          f"the {key} comparison window of {window} steps holds no merged "
          f"update (period {period})")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    if fsdp:
        wants = sharded_collectives(schedule, layout, steps, need_reuse)
    else:
        wants = [phase_collectives(schedule.phases[i % period])
                 for i in range(steps)]
    for i, (got, want) in enumerate(zip(res["collectives"], wants)):
        check(got == want, f"step {i}: issued {got}, schedule says {want}")
    check(against is None or vs_stored,
          f"{key} was not held to {against and against[0]}")
    if fsdp:
        check(rt.stats()["sharded_state"]
              and rt.stats()["gather_skip"] == need_reuse
              and rt.stats()["decoupled"] == decoupled,
              f"{key} is not the sharded engine with the gather skip "
              f"{'on' if need_reuse else 'off'}"
              f"{' streamed' if decoupled else ''}")
        synced = sum(c["reduce_scatter"] for c in res["collectives"])
        # an int8 param gather is two all-gathers: values and scales
        gathered = sum(c["param_gather"] for c in res["collectives"]) // 2
    else:
        synced = sum(c["primary"] + c["secondary"]
                     for c in res["collectives"])
        gathered = 0
    updates = sum(schedule.phases[i % period].do_update for i in range(steps))
    check(launches["quantize_int8"] == launches["dequantize_int8"]
          == synced + gathered,
          f"int8 wire launches {launches} != {synced} synced + {gathered} "
          f"gathered buckets")
    check(launches["stochastic_round_bf16"] == nb * (1 + updates),
          f"stochastic rounding launches {launches['stochastic_round_bf16']} "
          f"!= {nb} buckets x (init + {updates} updates)")
    check(launches["bucket_update"] == nb * updates,
          f"bucket update launches {launches['bucket_update']} != {nb} x "
          f"{updates}")
    # each decoder self-attention (forward and remat recompute) on bf16;
    # an encoder layer (no remat) and each cross-attention (forward and
    # recompute) over the f32 memory on f32
    kinds = [sp.kind for sp in cfg.layer_specs()]
    cross = kinds.count("cross_attn")
    attn = sum(k in ("attn", "local_attn", "mla") for k in kinds)
    attn += cross if cfg.is_encoder_decoder else 0
    want_flash = {"flash_fwd": (2 * cross + cfg.n_encoder_layers) * steps,
                  "flash_fwd_sm90": 2 * attn * steps,
                  "flash_fwd_sm90_mla": 2 * attn * steps if cfg.mla else 0}
    check(all(launches[k] == n for k, n in want_flash.items()),
          f"flash launches {({k: launches[k] for k in want_flash})}, "
          f"expected {want_flash}")
    check(launches["rglru_fwd"] == launches["rglru_bwd"] == 0
          and launches["rwkv6_fwd"] == launches["rwkv6_bwd"] == 0,
          f"recurrent-kernel launches {launches} on a model without "
          f"recurrent layers")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    print(f"{key} vs the plain run over {window} steps: losses "
          f"{losses[:window]} vs {ref_losses} (rel {rel:.3g}); params max "
          f"|diff| {agree['max_param_diff']:.3g} (buckets "
          f"{[round(m, 6) for m in agree['bucket_max_diff']]}; shares "
          f"beyond one ulp "
          f"{[round(f, 5) for f in agree['bucket_share_over_ulp']]}), "
          f"{agree['n_params_over_ulp']} beyond 1e-4 + |p|/128, "
          f"{agree['n_params_differing']} differing, of {agree['n_params']}")
    check(rel <= PREC_LOSS_RTOL,
          f"{key} losses vs the plain run: rel diff {rel:.3g}")
    # a bucket whose update went wrong or did not happen moves nearly all
    # its elements by ~lr per update, far beyond one bf16 ulp of most
    bad = [b for b, (m, f) in enumerate(zip(agree["bucket_max_diff"],
                                            agree["bucket_share_over_ulp"]))
           if m > PREC_PARAM_MAX_DIFF or f > PREC_BUCKET_MAX_OVER]
    check(not bad and agree["n_params_over_ulp"]
          <= PREC_PARAM_MAX_OVER * agree["n_params"],
          f"{key} params vs the plain run: buckets {bad} beyond "
          f"{PREC_PARAM_MAX_DIFF} or {PREC_BUCKET_MAX_OVER:.0%} of their "
          f"elements beyond one bf16 ulp, "
          f"{agree['n_params_over_ulp']} elements beyond one bf16 ulp")
    dtypes = None
    if cfg.modality != "text":
        # JAX never casts the memory: the encoder and the cross K/V run in
        # f32, the cross-attention's output and the residual in bf16
        f32, bf16 = ["float32"], ["bfloat16"]
        params = rt.params_tree(state)
        dtypes = promotion_dtypes(torch, cfg, params, seq)
        del params
        want = dict(encoder=f32 if cfg.is_encoder_decoder else [],
                    cross_kv=f32, cross_out=bf16, residual=bf16)
        check(dtypes == want, f"{key} dtypes at the promotion points "
                              f"{dtypes}, expected {want}")
        print(f"  promotion points in one forward: {dtypes}")
    step_s = statistics.median(res["step_s"][1:])
    gscratch = 2 * sum(layout.buf_sizes)
    out = dict(
        arch=cfg.name, seq=seq, promotion_dtypes=dtypes,
        wire=WIRE, master=MASTER, coverage_rate=coverage_rate,
        n_buckets=nb, period=period,
        updates_per_period=schedule.updates_per_period,
        batch_size_sequence=list(schedule.batch_size_sequence),
        steps=steps, updates=updates, synced_buckets=synced,
        gathered_buckets=gathered, losses=losses, ref_losses=ref_losses, ref_steps=window,
        loss_rel_diff=rel, step_s=res["step_s"], median_step_s=step_s,
        tokens_per_s=BATCH * seq / step_s, peak_bytes=peak,
        bf16_grad_scratch_bytes=gscratch, launches=launches,
        collectives=res["collectives"],
        stats={k: v for k, v in rt.stats().items() if k != "phases"},
        **agree)
    if against is not None:
        out["against"] = vs_stored
    if decoupled:
        out["stream"] = {k: list(v) if isinstance(v, tuple) else v
                         for k, v in stream.items()}
    report[key] = out
    f32 = report[f32_key]
    print(f"{key} ({cfg.name}, {WIRE} wires, {MASTER} master, compute "
          f"{rt.stats()['compute_dtype']}, coverage rate "
          f"{coverage_rate}): {steps} steps, period {period}, "
          f"updates/period {schedule.updates_per_period}, batch-size seq "
          f"{tuple(schedule.batch_size_sequence)}, median step {step_s:.3f} s, "
          f"{BATCH * seq / step_s:.0f} tok/s, peak memory "
          f"{peak / 2**30:.2f} GiB [{report['card']}] (bf16 gradient scratch "
          f"{gscratch / 2**30:.2f} GiB), launches {launches}, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; vs plain over {window} "
          f"steps: loss rel {rel:.2g}, params max diff "
          f"{agree['max_param_diff']:.3g}, {agree['n_params_over_ulp']} "
          f"beyond one bf16 ulp, {agree['n_params_differing']} differing "
          f"of {agree['n_params']}")
    print(f"  beside {f32_key} (f32): median step "
          f"{f32['median_step_s']:.3f} s, {f32['tokens_per_s']:.0f} tok/s, "
          f"peak {f32['peak_bytes'] / 2**30:.2f} GiB")
    if fsdp and f32_key == "main_path":
        rep = report["precision_path_delayed"]
        print(f"  beside the replicated engine's delayed run: median step "
              f"{rep['median_step_s']:.3f} s, {rep['tokens_per_s']:.0f} "
              f"tok/s, peak {rep['peak_bytes'] / 2**30:.2f} GiB")
    if against is not None:
        print_against(report, against, vs_stored)
    if decoupled:
        print(f"  streamed: buckets first touched in the order "
              f"{list(stream['touched'])}; {stream['issued_at_first_touch']} "
              f"param gathers issued before the forward's first compute")
    del res, rt, state
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Checkpoint and mid-cycle resume
# ---------------------------------------------------------------------------
DEFLATE_ELEMS = 50_000_000       # the host's np.savez_compressed rate probe
SMOKE_STEPS, SMOKE_EVERY = 6, 2  # the real-file resume at smoke size


def host_rss() -> int:
    """This process's resident host memory, in bytes."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def checkpoint_path(torch, cfg, report, key, against, **kw):
    """Resume a run mid-cycle from an in-memory checkpoint and hold it
    bitwise to the run stored earlier (``against`` = (name, stored run,
    True)), which ran the same configuration (``kw``, ``train``'s
    options) uninterrupted.

    The first ``k`` steps run through ``train``, ``k`` being the first
    cycle position whose predecessor does not update (a gather-skip run
    reads its saved cache there), with ``cur`` or ``fut`` nonzero; the
    state goes through ``state_to_tree`` and the checkpoint module's
    ``encode`` into host numpy, and the runtime and state are dropped.  A
    fresh runtime of the same schedule and layout ``decode``s it, takes it
    with ``tree_to_state`` and ``reset_cycle``s from the saved position,
    then finishes the period.  The peak device memory over both halves
    may exceed the stored run's by at most one bucket's f32 buffer."""
    from repro_torch.checkpoint import decode, encode
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.train import build_schedule, train
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train.runtime import DeftRuntime

    name, want, bitwise = against
    check(bitwise, f"{key} must be held bitwise")
    kw = dict(scheduler="deft", batch=BATCH, seq=SEQ, seed=0, device="cuda",
              lr=LR, loss_chunk=LOSS_CHUNK, partition_elems=PARTITION_ELEMS,
              **kw)
    schedule = build_schedule(
        init_params(cfg, device="meta"), cfg, dp=1, seq_len=SEQ,
        per_device_batch=BATCH, partition_elems=PARTITION_ELEMS,
        coverage_rate=kw["coverage_rate"],
        wire_precision=kw.get("wire_precision", "f32"),
        master_dtype=kw.get("master_dtype", "f32"))[3].schedule
    period = schedule.period
    k = next((t for t in range(1, period)
              if not schedule.phases[t - 1].do_update), None)
    check(k is not None and len(want["losses"]) == period,
          f"{key}: no mid-cycle position after a phase without an update "
          f"in {[ph.do_update for ph in schedule.phases]}, or the stored "
          f"run is not one period")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    res = train(cfg, steps=k, log=lambda s: print("  " + s),
                on_step=lambda i, rt, st, m: losses.append(float(m["loss"])),
                **kw)
    rt, state = res["runtime"], res["state"]
    check(res["schedule"] == schedule, f"{key}: train planned another "
                                       f"schedule")
    check(any(bool(x.any()) for x in state["cur"] + state["fut"]),
          f"{key}: cur and fut are zero at cycle position {k}")
    layout, next_phase = res["layout"], rt.phase_in_cycle(k)
    build = dict(loss_chunk=rt.loss_chunk, compute_dtype=rt.compute_dtype,
                 master_dtype=rt.master_dtype, fsdp=rt.fsdp,
                 decoupled=rt.decoupled)
    rss0 = host_rss()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = encode(rt.state_to_tree(state))
    encode_s = time.perf_counter() - t0
    host_bytes = host_rss() - rss0
    ckpt_bytes = sum(a.nbytes for a in arrays.values())
    has_pg = any(n.startswith("pgather") for n in arrays)
    check(has_pg == rt.gather_skip, f"{key}: gather cache saved {has_pg}, "
                                    f"gather skip {rt.gather_skip}")
    del res, rt, state
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    rt = DeftRuntime(cfg, adamw(LR), schedule, layout, device="cuda", **build)
    t0 = time.perf_counter()
    state = rt.tree_to_state(
        decode(arrays, rt.checkpoint_struct(layout), device="cpu"),
        src_layout=layout)
    rt.reset_cycle(k - next_phase)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    del arrays
    check(all(t.device.type == "cuda" for t in
              state["pbuf"] + state["cur"] + state["fut"] + state["gbuf"]
              + state["opt"]["m"] + state.get("pgather", ())),
          f"{key}: a restored buffer is not on the card")
    for step in range(k, period):
        batch = make_batch(cfg, 0, step, BATCH, SEQ, device="cuda")
        state, m = rt.step(step, state, batch)
        losses.append(float(m["loss"]))
    peak = max(peak, torch.cuda.max_memory_allocated())
    held = held_to(key, against, state, losses)
    stored_peak = report[name]["peak_bytes"]
    bucket = 4 * max(layout.buf_sizes)
    check(peak <= stored_peak + bucket,
          f"{key}: peak {peak} beyond {name}'s {stored_peak} + one bucket "
          f"{bucket}")
    report[key] = dict(
        saved_at=k, next_phase=next_phase, period=period,
        pgather_saved=has_pg, ckpt_bytes=ckpt_bytes,
        host_bytes=host_bytes, encode_s=encode_s, decode_s=decode_s,
        peak_bytes=peak, stored_peak_bytes=stored_peak,
        bucket_bytes=bucket, losses=losses, against=held)
    print(f"{key} ({name}'s configuration): saved at cycle position {k} of "
          f"{period}{' with the gather cache' if has_pg else ''}, "
          f"{ckpt_bytes / 2**30:.2f} GiB of arrays (host memory "
          f"{host_bytes / 2**30:.2f} GiB); state_to_tree + encode "
          f"{encode_s:.2f} s, decode + tree_to_state {decode_s:.2f} s; "
          f"peak {peak / 2**30:.2f} GiB against {name}'s "
          f"{stored_peak / 2**30:.2f} GiB + one bucket "
          f"{bucket / 2**30:.2f} GiB [{report['card']}]")
    print_against(report, against, held)
    del rt, state
    torch.cuda.empty_cache()


def checkpoint_files_phase(torch, report):
    """Real checkpoint files at smoke size (``reduce_for_smoke`` of the
    main path's arch) through ``train``: a run saving every SMOKE_EVERY
    steps, its resume, and a resume after the newest npz was truncated
    (a writer killed mid-save), which must fall back to the step before;
    every resumed loss bitwise the uninterrupted run's.  Then the host's
    ``np.savez_compressed`` rate on DEFLATE_ELEMS random f32 values, and
    what it makes of a full-width save of ``checkpoint_path``'s arrays."""
    import numpy as np

    from repro_torch.checkpoint import latest_step, valid_steps
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.train import train

    cfg = reduce_for_smoke(get_config(ARCH))
    quiet = dict(device="cuda", batch=2, seq=64, log=lambda s: None)
    t_start = time.perf_counter()
    whole = train(cfg, steps=SMOKE_STEPS, **quiet)["losses"]
    half = SMOKE_STEPS // 2
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        first = train(cfg, steps=half, ckpt=d, ckpt_every=SMOKE_EVERY,
                      **quiet)
        check(valid_steps(d) == [SMOKE_EVERY, half],
              f"saved steps {valid_steps(d)}")
        logs = []
        rest = train(cfg, steps=SMOKE_STEPS - half, ckpt=d, resume=True,
                     ckpt_every=SMOKE_EVERY, **dict(quiet, log=logs.append))
        check(rest["start_step"] == half and first["losses"]
              + rest["losses"] == whole,
              f"resumed at {rest['start_step']}: {rest['losses']} vs the "
              f"uninterrupted {whole[half:]}")
        newest = latest_step(d)
        path = os.path.join(d, f"ckpt_{newest:08d}.npz")
        with open(path, "rb+") as f:          # a writer killed mid-save
            f.truncate(96)
        prev = latest_step(d)
        check(prev is not None and prev < newest,
              f"step {newest} still counts after its npz was truncated")
        logs = []
        again = train(cfg, steps=1, ckpt=d, resume=True,
                      **dict(quiet, log=logs.append))
        check(again["start_step"] == prev
              and f"resumed checkpoint step {prev}" in logs
              and again["losses"] == whole[prev:prev + 1],
              f"after truncating step {newest}: resumed at "
              f"{again['start_step']} ({logs}), loss {again['losses']} vs "
              f"{whole[prev:prev + 1]}")
        files = sorted(os.listdir(d))
    files_s = time.perf_counter() - t_start
    print(f"checkpoint files (smoke {ARCH}, {SMOKE_STEPS} steps): saved "
          f"every {SMOKE_EVERY}, resumed at {half} and, after truncating "
          f"step {newest}'s npz, at {prev}: every resumed loss bitwise the "
          f"uninterrupted run's ({files_s:.1f} s; files {files})")

    x = np.random.default_rng(0).standard_normal(DEFLATE_ELEMS,
                                                 dtype=np.float32)
    buf = io.BytesIO()
    t0 = time.perf_counter()
    np.savez_compressed(buf, x=x)
    deflate_s = time.perf_counter() - t0
    rate = x.nbytes / deflate_s
    ratio = buf.getbuffer().nbytes / x.nbytes
    full = report["checkpoint_path"]["ckpt_bytes"]
    report["checkpoint_files"] = dict(
        steps=SMOKE_STEPS, every=SMOKE_EVERY, resumed_at=half,
        truncated=newest, fell_back_to=prev, seconds=files_s,
        deflate_bytes=x.nbytes, deflate_s=deflate_s,
        deflate_bytes_per_s=rate, deflate_ratio=ratio,
        full_width_save_s_est=full / rate)
    print(f"host deflate: np.savez_compressed of {DEFLATE_ELEMS:,} random "
          f"f32 in {deflate_s:.2f} s, {rate / 1e6:.1f} MB/s, ratio "
          f"{ratio:.3f}: a full-width disk save of checkpoint_path's "
          f"{full / 2**30:.2f} GiB would take about {full / rate:.0f} s "
          f"[{report['card']}]")


# ---------------------------------------------------------------------------
# The adaptive control plane: replan, hot swap, repack on the card
# ---------------------------------------------------------------------------
ADAPT_DROP_STEP, ADAPT_DROP_SCALE = 4, 3.0
# steps of each run: the swap lands at 9 (f32) and 6 (precision) by the
# controller's replay on the host, and one period of the new schedule
# must pass after it (checked)
ADAPT_STEPS = {"adapt_path": 14, "adapt_precision_path": 8}
# the planner's partition the f32 swap falls back on where the controller
# keeps its own: the first of these multiples of PARTITION_ELEMS whose
# partition differs (at 3x every gemma2-2b leaf still fills a bucket)
FALLBACK_SCALES = (3, 10, 30, 100)


def peak_of_history(torch, base):
    """The peak of allocated device bytes in the memory-history window now
    ending (``torch.cuda.memory._record_memory_history``), which began
    with ``base`` bytes allocated, and the window's own allocations live
    at that peak, largest first: (bytes, the ``repro_torch`` frames that
    made it, innermost first).  Bytes are counted as
    ``max_memory_allocated`` counts them: an allocation at ``alloc``, its
    release at ``free_requested``."""
    snap = torch.cuda.memory._snapshot()
    trace = snap["device_traces"][torch.cuda.current_device()]

    def replay(stop):
        live, cur, top, at = {}, base, base, -1
        for k, ev in enumerate(trace[:stop]):
            if ev["action"] == "alloc":
                live[ev["addr"]] = ev
                cur += ev["size"]
                if cur > top:
                    top, at = cur, k
            elif ev["action"] == "free_requested":
                live.pop(ev["addr"], None)
                cur -= ev["size"]
        return top, at, live

    top, at, _ = replay(len(trace))
    live = replay(at + 1)[2]
    rows = []
    for ev in sorted(live.values(), key=lambda e: -e["size"])[:8]:
        frames = [f"{fr['filename'].split('repro_torch/')[-1]}:{fr['line']}"
                  for fr in ev.get("frames", ())
                  if "repro_torch" in fr["filename"]]
        rows.append((ev["size"], frames[:4]))
    return top, rows


def adapt_path(torch, cfg, report, key, against, **kw):
    """The launcher's adaptive loop on the card (``train(adapt=True)``):
    the main path's configuration (``kw``: ``train``'s options) with the
    tracer on, the copied controller with the settings of
    ``tests/test_repack.py::test_adaptive_repartition_end_to_end`` (timing
    trigger only) and a repartitioner, fed the synthetic walls of a 3x
    bandwidth drop at step 4.  Where its replan keeps the partition, the
    planner's partition at the first of FALLBACK_SCALES that changes it is
    staged through ``prepare_swap(layout=)`` at the same step.

    Checks that one layout-changing hot swap lands on a cycle boundary of
    the old schedule and one new period passes after it; that each step
    issues its schedule's collectives and each kernel launches as its
    layers, updates and layouts say; that the trace's wire bytes equal the
    plan before and after the swap (``obs.wire_bytes_report``); that the
    peak exceeds ``against``'s (the stored run of the same configuration)
    by at most the larger of one state component and the update's f32
    temporaries of the new layout's largest bucket; and that every loss and
    param is bitwise a run that switches layouts by hand: a sibling of the
    first layout to the swap step, ``repack_state``, a sibling of the
    second.  That repack's own peak may exceed the resident state by at
    most one component (it moves one at a time)."""
    from repro_torch.adapt import AdaptConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.train import build_schedule, train
    from repro_torch.models.model import init_params
    from repro_torch.obs import Tracer, wire_bytes_report
    from repro_torch.train.bucketing import (
        build_bucket_layout,
        build_layout_transition,
    )

    gc.collect()
    torch.cuda.empty_cache()
    steps = ADAPT_STEPS[key]
    kw = dict(scheduler="deft", batch=BATCH, seq=SEQ, seed=0, device="cuda",
              lr=LR, loss_chunk=LOSS_CHUNK, partition_elems=PARTITION_ELEMS,
              **kw)
    precision = dict(wire_precision=kw.get("wire_precision", "f32"),
                     master_dtype=kw.get("master_dtype", "f32"))
    meta = init_params(cfg, device="meta")
    plan_of = lambda pe: build_schedule(
        meta, cfg, dp=1, seq_len=SEQ, per_device_batch=BATCH,
        partition_elems=pe, coverage_rate=kw["coverage_rate"], **precision)
    base = plan_of(PARTITION_ELEMS)
    fb_scale, fb = next(((k, p) for k in FALLBACK_SCALES
                         for p in [plan_of(k * PARTITION_ELEMS)]
                         if p[0] != base[0]), (None, None))
    check(fb is not None, f"{key}: no partition of {FALLBACK_SCALES} x "
                          f"{PARTITION_ELEMS} differs from the base one")
    fb_layout = build_bucket_layout(meta, fb[0], fb[1]).with_precision(
        fb[3].precision)
    kept, planned, window = [], {}, {}

    def on_step(step, runtime, state, metrics):
        if step == 0:
            planned["before"] = (runtime.wire_bytes_per_phase,
                                 runtime.wire_bytes_split_per_phase,
                                 runtime.collectives_per_phase())
        if "base" in window and runtime.hot_swaps:
            # the window closes after the install and the first step of
            # the new layout
            window["top"], window["live"] = peak_of_history(
                torch, window.pop("base"))
            window["run_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.memory._record_memory_history(enabled=None)
        replans = [sp for sp in runtime.tracer.spans("replan")
                   if sp.step == step and sp.args["changed"]]
        if replans and not replans[-1].args["repartition"]:
            kept.append(step)
            runtime.prepare_swap(fb[3].schedule,
                                 layout=fb_layout)
        if runtime.swap_ready() and not runtime.hot_swaps \
                and runtime.phase_in_cycle(step + 1) == 0:
            # the next step installs the swap: record every allocation
            # from here to the end of the new layout's first step
            torch.cuda.synchronize()
            window["base"] = torch.cuda.memory_allocated()
            torch.cuda.memory._record_memory_history(
                enabled="all", context="alloc", stacks="python",
                max_entries=200_000)

    trace_path = (ROOT / "chiprun_out"
                  / f"{key.replace('_path', '')}_trace.json")
    trace_path.parent.mkdir(exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    res = train(cfg, steps=steps, on_step=on_step, adapt=True,
                adapt_config=AdaptConfig(
                    eta=1e-3, warmup_steps=2, check_every=2,
                    cooldown_steps=100, min_loss_samples=10**9,
                    wire_precision=precision["wire_precision"]),
                adapt_drop_step=ADAPT_DROP_STEP,
                adapt_drop_scale=ADAPT_DROP_SCALE, adapt_repartition=True,
                trace=str(trace_path), log=lambda s: print("  " + s), **kw)
    launches = kernel_launches(counters)
    peak = torch.cuda.max_memory_allocated()

    rt, losses = res["runtime"], res["losses"]
    lay_a, sched_a = res["layout"], res["schedule"]
    lay_b, sched_b = rt.layout, rt.schedule
    st = rt.stats()
    installs = [e for e in rt.swap_log if "event" not in e]
    replan = next((e for e in res["controller"].events if e.changed), None)
    check(replan is not None and len(installs) == 1
          and st["hot_swaps"] == 1 and st["layout_swaps"] == 1
          and lay_b != lay_a,
          f"{key}: {st['replans']} replans, {st['hot_swaps']} hot swaps "
          f"({st['layout_swaps']} layout-changing); swap log {rt.swap_log}")
    swap = installs[0]["step"]
    check(swap % sched_a.period == 0 and steps - swap >= sched_b.period,
          f"{key}: the swap at step {swap} is not on a boundary of the "
          f"period-{sched_a.period} schedule, or fewer than a period "
          f"({sched_b.period}) of steps follow it in {steps}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    # the collectives each step issued, against its schedule's
    after = rt.collectives_per_phase()
    wants = [planned["before"][2][i % sched_a.period] if i < swap
             else after[(i - swap) % sched_b.period] for i in range(steps)]
    for i, (got, want) in enumerate(zip(res["collectives"], wants)):
        check(got == want, f"{key} step {i}: issued {got}, schedule says "
                           f"{want}")
    # each kernel's launches, from the layers, updates and layouts
    attn = sum(sp.kind in ("attn", "local_attn") for sp in cfg.layer_specs())
    at = [(sched_a.phases[i % sched_a.period], lay_a) if i < swap
          else (sched_b.phases[(i - swap) % sched_b.period], lay_b)
          for i in range(steps)]
    updated = sum(lay.n_buckets for ph, lay in at if ph.do_update)
    bf16 = kw.get("compute_dtype") == "bf16" \
        or precision["master_dtype"] == "bf16sr"
    if rt.fsdp:
        synced = sum(c["reduce_scatter"] for c in res["collectives"])
        gathered = sum(c["param_gather"] for c in res["collectives"]) // 2
    else:
        synced = sum(c["primary"] + c["secondary"]
                     for c in res["collectives"])
        gathered = 0
    int8 = precision["wire_precision"] == "int8"
    sr = precision["master_dtype"] == "bf16sr"
    want = {"flash_fwd": 0 if bf16 else 2 * attn * steps,
            "flash_fwd_sm90": 2 * attn * steps if bf16 else 0,
            "flash_fwd_sm90_mla": 0, "bucket_update": updated,
            "quantize_int8": synced + gathered if int8 else 0,
            "dequantize_int8": synced + gathered if int8 else 0,
            "stochastic_round_bf16": lay_a.n_buckets + updated if sr else 0,
            "rglru_fwd": 0, "rglru_bwd": 0, "rwkv6_fwd": 0, "rwkv6_bwd": 0}
    check(launches == want, f"{key} launches {launches}, expected {want}")
    # the wire bytes each step's syncs carried, against the plan in force
    spans = rt.tracer.spans("collective-group")
    wire = {}
    for name, lo, hi, (per, split) in (
            ("before", 0, swap, planned["before"][:2]),
            ("after", swap, steps, (rt.wire_bytes_per_phase,
                                    rt.wire_bytes_split_per_phase))):
        part = Tracer()
        for sp in spans:
            if lo <= sp.step < hi:
                part.add(sp.kind, sp.name, sp.t0, sp.t1, step=sp.step,
                         phase=sp.phase, **sp.args)
        rep = wire_bytes_report(part, per, split)
        check(rep.ok and all(m is not None for m in rep.measured_per_phase),
              f"{key} wire bytes {name} the swap: measured "
              f"{rep.measured_per_phase} / {rep.measured_split}, planned "
              f"{rep.planned_per_phase} / {rep.planned_split}")
        wire[name] = dict(planned_per_phase=list(rep.planned_per_phase),
                          precisions=list(rep.precisions))
    # the peak: the repack at the boundary (no activations live) holds at
    # most one component more than the resident state; a step of layout B
    # holds what the stored run's steps hold, but its update's per-bucket
    # f32 temporaries scale with B's largest bucket (span): the grad-clip
    # norm's scaled gradient and its square, and on the sharded engine
    # the reduce-scatter's span
    component = 4 * max(sum(lay_a.buf_sizes), sum(lay_b.buf_sizes))
    temps = 4 * max(lay_b.shard_sizes if rt.fsdp else lay_b.buf_sizes) \
        * (2 * bool(rt.opt_spec.grad_clip) + rt.fsdp)
    stored_peak = report[against]["peak_bytes"]
    bound = stored_peak + max(component, temps)
    check(peak <= bound,
          f"{key}: peak {peak} beyond {against}'s {stored_peak} + the "
          f"larger of one state component {component} and layout B's "
          f"update temporaries {temps}")
    repack = next(sp for sp in rt.tracer.spans("repack"))
    step_s = res["step_s"]
    before_s = statistics.median(step_s[1:swap])
    after_s = statistics.median(step_s[swap + 1:])
    stored = stored_run(res["state"], losses)
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # the reference: layout A to the swap step, repack_state, layout B;
    # the repack's own peak above the resident state, measured here
    ref = rt.spawn(schedule=sched_a, layout=lay_a)
    state = ref.init_state(0, dtype=rt.compute_dtype or torch.float32)
    ref_losses = []
    for i in range(steps):
        if i == swap:
            ref = ref.spawn(schedule=sched_b, layout=lay_b)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state = ref.repack_state(state,
                                     build_layout_transition(lay_a, lay_b),
                                     src_schedule=sched_a)
            torch.cuda.synchronize()
            repack_extra = torch.cuda.max_memory_allocated() - resident
            check(repack_extra <= component,
                  f"{key}: the repack took {repack_extra} bytes above the "
                  f"resident {resident}, more than one component "
                  f"{component}")
        state, m = ref.step(i - swap if i >= swap else i, state,
                            make_batch(cfg, 0, i, BATCH, SEQ, device="cuda"))
        ref_losses.append(float(m["loss"]))
    held = held_to(key, ("the explicit repack", stored, True), state,
                   ref_losses)
    del ref, state, stored
    torch.cuda.empty_cache()

    report[key] = dict(
        steps=steps, replan_step=replan.step,
        controller_repartitioned=replan.partition_changed,
        fallback_at=kept[0] if kept else None,
        fallback_partition_elems=(fb_scale * PARTITION_ELEMS if kept
                                  else None),
        swap_step=swap, period_before=sched_a.period,
        period_after=sched_b.period, buckets_before=lay_a.n_buckets,
        buckets_after=lay_b.n_buckets,
        moved_elems=repack.args["moved_elems"], repack_s=installs[0][
            "repack_s"], precision_after=installs[0]["precision"],
        median_step_s_before=before_s, median_step_s_after=after_s,
        step_s=step_s, losses=losses, peak_bytes=peak,
        stored_peak_bytes=stored_peak, component_bytes=component,
        update_temporaries_bytes=temps, peak_bound_bytes=bound,
        repack_resident_bytes=resident, repack_extra_bytes=repack_extra,
        launches=launches, wire_bytes=wire, trace=str(trace_path),
        swap_window_peak_bytes=window.get("top"),
        swap_window_live=window.get("live"),
        run_peak_at_window_end=window.get("run_peak"),
        against=held, stats={k: v for k, v in st.items() if k != "phases"})
    print(f"{key} ({against}'s configuration, {steps} steps): replanned at "
          f"step {replan.step}"
          + ("" if replan.partition_changed else
             f" keeping its partition, so the planner's partition at "
             f"{report[key]['fallback_partition_elems']:,} elements was "
             f"staged at step {kept[0]}")
          + f"; swapped at step {swap}: {lay_a.n_buckets} -> "
          f"{lay_b.n_buckets} buckets, period {sched_a.period} -> "
          f"{sched_b.period}, wires {installs[0]['precision']}, "
          f"{repack.args['moved_elems']:,} elements moved in "
          f"{installs[0]['repack_s']:.3f} s; median step {before_s:.3f} s "
          f"before, {after_s:.3f} s after; peak {peak / 2**30:.2f} GiB "
          f"against {against}'s {stored_peak / 2**30:.2f} GiB + the larger "
          f"of one component {component / 2**30:.2f} GiB and the update "
          f"temporaries {temps / 2**30:.2f} GiB; the explicit repack "
          f"{repack_extra / 2**30:.2f} GiB above the resident "
          f"{resident / 2**30:.2f} GiB [{report['card']}]; "
          f"launches {launches}; wire bytes as planned on both sides; "
          f"every loss and param bitwise the explicit repack; trace -> "
          f"{trace_path.relative_to(ROOT)}")
    if "top" in window:
        print(f"  {key}: over the install and the first step of the new "
              f"layout the allocated bytes peak at "
              f"{window['top'] / 2**30:.2f} GiB (the run's peak by then "
              f"{window['run_peak'] / 2**30:.2f} GiB); live there, made in "
              f"that window:")
        for n, frames in window["live"]:
            print(f"    {n / 2**30:7.3f} GiB  "
                  f"{' < '.join(frames) or '(made outside repro_torch)'}")
    else:
        print(f"  {key}: the swap was not armed a step before its "
              f"boundary, so no allocation window was recorded")
    return launches



# ---------------------------------------------------------------------------
# The elastic control plane: engine fallback and the emergency halt
# ---------------------------------------------------------------------------
ELASTIC_PERIODS_AFTER = 2      # periods on the replicated engine afterwards
# the halt at smoke size: shard 0, the only one, drops at HALT_DROP_STEP
# (after the monitor's 3 warm-up steps); the monitor declares it dead
# after about 8 step walls of silence, and the run halts a step later.
# The steps left after the drop leave room for a step EMA a slow step
# inflated up to 4-fold
HALT_STEPS, HALT_DROP_STEP = 40, 4


def elastic_fallback_path(torch, cfg, report, key, holds, stored_peak_of,
                          **kw):
    """The degradation ladder's fallback rung on the card (JAX's
    ``test_engine_fallback_migration_matches_reference`` at full width):
    ``kw`` (``train``'s options) on the sharded engine at one shard with
    the gather skip on, through ``train`` to the first cycle boundary
    after one period and a step; ``migrate_state`` onto
    ``spawn(fsdp=False)``, the replicated engine; then
    ELASTIC_PERIODS_AFTER periods there.  The launch counters are zeroed
    before ``train`` and read after the last replicated step.

    Checks: the first period held to each of ``holds`` (name, stored run,
    bitwise); each step's collectives as its engine's schedule says; each
    kernel's launches as the layers, updates and syncs say; the wire
    policy and master unchanged by the move (one layout, one bucket
    count); the peak within ``stored_peak_of``'s plus one state component;
    and every loss and param after the move bitwise a replicated
    ``DeftRuntime`` rebuilt from the pre-move ``state_to_tree`` snapshot
    by ``tree_to_state`` and run over the same steps."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.elastic import migrate_state
    from repro_torch.launch.train import build_schedule, train
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train.runtime import DeftRuntime

    gc.collect()
    torch.cuda.empty_cache()
    kw = dict(scheduler="deft", batch=BATCH, seq=SEQ, seed=0, device="cuda",
              lr=LR, loss_chunk=LOSS_CHUNK, partition_elems=PARTITION_ELEMS,
              fsdp=True, **kw)
    wire = kw.get("wire_precision", "f32")
    master = kw.get("master_dtype", "f32")
    schedule = build_schedule(
        init_params(cfg, device="meta"), cfg, dp=1, seq_len=SEQ,
        per_device_batch=BATCH, partition_elems=PARTITION_ELEMS,
        coverage_rate=kw["coverage_rate"], wire_precision=wire,
        master_dtype=master)[3].schedule
    period = schedule.period
    k = -(-(period + 1) // period) * period
    losses, held = [], {}

    def on_step(step, runtime, state, metrics):
        losses.append(float(metrics["loss"]))
        if step == period - 1:
            check(runtime.fsdp and runtime.gather_skip,
                  f"{key} is not the sharded engine with the gather skip")
            for name, store, bitwise in holds:
                held[name] = held_to(key, (name, store, bitwise), state,
                                     losses)

    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    res = train(cfg, steps=k, on_step=on_step,
                log=lambda s: print("  " + s), **kw)
    rt_a, state, layout = res["runtime"], res["state"], res["layout"]
    check(res["schedule"] == schedule, f"{key}: train planned another "
                                       f"schedule")
    step_s = list(res["step_s"])
    coll = list(res["collectives"])
    wants = [rt_a.collectives_per_phase()[i % period] for i in range(k)]
    policy = lambda rt: (rt.layout.precision.describe()
                         if rt.layout.precision is not None else "f32") \
        + f" master {rt.master_dtype}"
    before = policy(rt_a)
    del res
    rss0 = host_rss()
    snap = rt_a.state_to_tree(state)             # on the host
    snap_bytes = host_rss() - rss0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt_b = rt_a.spawn(fsdp=False)
    t1 = time.perf_counter()
    state = migrate_state(rt_a, rt_b, state)
    torch.cuda.synchronize()
    repack_s = time.perf_counter() - t1
    rt_b._load_kernels(rt_b.layout)
    rt_b.reset_cycle(k)
    migrate_s = time.perf_counter() - t0
    after = policy(rt_b)
    check(not rt_b.fsdp and rt_b.layout == layout and after == before
          and "pgather" not in state,
          f"{key}: the fallback changed the layout or its policy "
          f"({before} -> {after}) or kept the gather cache")
    del rt_a
    steps_b = ELASTIC_PERIODS_AFTER * period
    wants += [rt_b.collectives_per_phase()[i % period]
              for i in range(steps_b)]
    after_losses = []
    for i in range(k, k + steps_b):
        batch = make_batch(cfg, 0, i, BATCH, SEQ, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = rt_b.step(i, state, batch)
        after_losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        coll.append(rt_b.last_collectives)
    launches = kernel_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses + after_losses),
          f"{key}: non-finite loss {losses + after_losses}")
    for i, (got, want) in enumerate(zip(coll, wants)):
        check(got == want, f"{key} step {i}: issued {got}, schedule says "
                           f"{want}")
    steps = k + steps_b
    attn = sum(sp.kind in ("attn", "local_attn") for sp in cfg.layer_specs())
    updated = layout.n_buckets * sum(schedule.phases[i % period].do_update
                                     for i in range(steps))
    bf16 = kw.get("compute_dtype") == "bf16" or master == "bf16sr"
    synced = sum(c["reduce_scatter"] for c in coll[:k]) \
        + sum(c["primary"] + c["secondary"] for c in coll[k:])
    gathered = sum(c["param_gather"] for c in coll[:k]) // 2
    int8, sr = wire == "int8", master == "bf16sr"
    want = {"flash_fwd": 0 if bf16 else 2 * attn * steps,
            "flash_fwd_sm90": 2 * attn * steps if bf16 else 0,
            "flash_fwd_sm90_mla": 0, "bucket_update": updated,
            "quantize_int8": synced + gathered if int8 else 0,
            "dequantize_int8": synced + gathered if int8 else 0,
            "stochastic_round_bf16": layout.n_buckets + updated if sr else 0,
            "rglru_fwd": 0, "rglru_bwd": 0, "rwkv6_fwd": 0, "rwkv6_bwd": 0}
    check(launches == want, f"{key} launches {launches}, expected {want}")
    component = 4 * sum(layout.buf_sizes)
    stored_peak = report[stored_peak_of]["peak_bytes"]
    check(peak <= stored_peak + component,
          f"{key}: peak {peak} beyond {stored_peak_of}'s {stored_peak} + "
          f"one component {component}")
    build = dict(loss_chunk=rt_b.loss_chunk, compute_dtype=rt_b.compute_dtype,
                 master_dtype=rt_b.master_dtype)
    stored = stored_run(state, after_losses)
    del state, rt_b
    gc.collect()
    torch.cuda.empty_cache()

    # the reference: a replicated runtime rebuilt from the snapshot
    ref = DeftRuntime(cfg, adamw(LR), schedule, layout, device="cuda",
                      **build)
    state = ref.tree_to_state(snap)
    del snap
    ref.reset_cycle(k)
    ref_losses = []
    for i in range(k, k + steps_b):
        state, m = ref.step(i, state, make_batch(cfg, 0, i, BATCH, SEQ,
                                                 device="cuda"))
        ref_losses.append(float(m["loss"]))
    vs_ref = held_to(key, ("its rebuilt reference", stored, True), state,
                     ref_losses)
    del ref, state, stored
    gc.collect()
    torch.cuda.empty_cache()
    before_s = statistics.median(step_s[1:k])
    after_s = statistics.median(step_s[k + 1:])
    report[key] = dict(
        migrated_at=k, period=period, steps=steps, policy=before,
        repack_s=repack_s, migrate_s=migrate_s, snapshot_host_bytes=snap_bytes,
        peak_bytes=peak, stored_peak_bytes=stored_peak,
        component_bytes=component, median_step_s_before=before_s,
        median_step_s_after=after_s, step_s=step_s,
        losses=losses + after_losses, launches=launches,
        against={**held, "rebuilt reference": vs_ref})
    print(f"{key} ({cfg.name}, {cfg.n_layers} layers, {steps} steps): "
          f"sharded engine to step {k}, then migrate_state onto the "
          f"replicated engine (spawn(fsdp=False)): repack_s "
          f"{repack_s * 1e3:.1f} ms, migrate_s {migrate_s * 1e3:.1f} ms; "
          f"policy {before} before, {after} after; median step "
          f"{before_s:.3f} s before, {after_s:.3f} s after; peak "
          f"{peak / 2**30:.2f} GiB against {stored_peak_of}'s "
          f"{stored_peak / 2**30:.2f} GiB + one component "
          f"{component / 2**30:.2f} GiB [{report['card']}]; launches "
          f"{launches}; every loss and param after the move bitwise its "
          f"rebuilt reference")
    for name, store, bitwise in holds:
        print_against(report, (name, store, bitwise), held[name])
    return launches


def elastic_halt_phase(torch, report):
    """The ladder's bottom rung through the launcher at smoke size
    (``reduce_for_smoke`` of the main path's arch, sharded, the gather skip
    on): ``train(elastic=True, elastic_drop_step=HALT_DROP_STEP,
    ckpt=...)`` at one rank drops shard 0, the only one; the monitor
    declares it dead, no survivor is left, and the run halts with the
    emergency checkpoint.  ``train(resume=True)`` then finishes the
    HALT_STEPS steps, and every loss and the final params must be bitwise
    an uninterrupted run's.  The counters count the halted and the
    resumed runs (the uninterrupted one runs first).  Also times one more
    emergency save of the halted state and one restore of it."""
    from repro_torch.checkpoint import valid_steps
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.train import restore_runtime_state, train
    from repro_torch.models.model import init_params

    cfg = reduce_for_smoke(get_config(ARCH))
    quiet = dict(device="cuda", batch=2, seq=64, fsdp=True, elastic=True,
                 log=lambda s: None)
    whole = train(cfg, steps=HALT_STEPS, **quiet)
    whole_losses = whole["losses"]
    whole_params = [b.to("cpu", copy=True) for b in whole["state"]["pbuf"]]
    schedule, layout = whole["schedule"], whole["layout"]
    del whole
    counters = zero_counters()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        logs = []
        first = train(cfg, steps=HALT_STEPS, ckpt=d,
                      elastic_drop_step=HALT_DROP_STEP,
                      **dict(quiet, log=logs.append))
        coord = first["elastic"]
        halt = coord.log[-1] if coord.log else {}
        check(first["halted"] and halt.get("action") == "checkpoint-halt"
              and halt.get("trigger") == "dead"
              and valid_steps(d) == [halt["step"]]
              and len(first["losses"]) == halt["step"],
              f"the smoke run did not halt on its dropped shard: halted "
              f"{first['halted']}, log {coord.log}, saved {valid_steps(d)}")
        at = halt["step"]
        # one more save of the halted state, and one restore of it, timed
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d2:
            coord.checkpoint_dir = d2
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coord.emergency_checkpoint(at, first["state"])
            save_s = time.perf_counter() - t0
        rt = first["runtime"]
        fresh = rt.spawn()
        t0 = time.perf_counter()
        got, start = restore_runtime_state(
            fresh, d, init_params(cfg, device="meta"), log=lambda s: None)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(start == at, f"restored step {start}, halted at {at}")
        del got, fresh, rt, first["state"], first["runtime"]
        rest = train(cfg, steps=HALT_STEPS - at, ckpt=d, resume=True,
                     **quiet)
        check(rest["start_step"] == at
              and first["losses"] + rest["losses"] == whole_losses
              and all(torch.equal(a.cpu(), b) for a, b in
                      zip(rest["state"]["pbuf"], whole_params)),
              f"resumed at {rest['start_step']}: the halted and resumed "
              f"losses {first['losses'] + rest['losses']} vs the "
              f"uninterrupted {whole_losses}, or its params differ")
        del rest
    launches = kernel_launches(counters)
    want = expected_launches(cfg, schedule, layout, HALT_STEPS)
    check(launches == want, f"elastic_halt_phase launches {launches}, "
                            f"expected {want}")
    event = next(line for line in logs if "dead" in line)
    report["elastic_halt"] = dict(
        steps=HALT_STEPS, drop_step=HALT_DROP_STEP,
        detected_step=halt["detected_step"], halted_at=at, save_s=save_s,
        restore_s=restore_s, launches=launches, event=event)
    print(f"elastic halt (smoke {ARCH}, sharded, {HALT_STEPS} steps): shard "
          f"0 dropped at step {HALT_DROP_STEP}, declared dead at step "
          f"{halt['detected_step']} ({event.strip()}), halted at step {at} "
          f"with the emergency checkpoint; one more save of that state "
          f"{save_s:.3f} s, its restore {restore_s:.3f} s "
          f"[{report['card']}]; resumed at {at}: every loss and the final "
          f"params bitwise the uninterrupted run's; launches {launches}")
    return launches

# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def served_error(got, ref) -> float:
    """Decode equivalence: max |diff| / max |ref| over every served
    position's logits."""
    return ((got - ref).abs().max() / (ref.abs().max() + 1e-6)).item()


def serve_path(torch, report):
    """recurrentgemma-9b at full width and depth served through
    ``launch/serve.py::serve``: 4 prompts of 1024 tokens, 64 greedy tokens
    each.  Every served position's logits (the prefill's last, then each
    decode step's) against the training forward over the prompt plus the
    generated tokens on the plain versions, no kernel (the head applied to
    those positions); the RG-LRU scan kernel launched once a layer at the
    prefill and at each decode step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import forward, head_logits, init_params

    cfg = get_config(SERVE_ARCH)
    kinds = [sp.kind for sp in cfg.layer_specs()]
    check(cfg.n_layers == SERVE_LAYERS and kinds.count("rglru") == SERVE_RGLRU
          and kinds.count("local_attn") == SERVE_LAYERS - SERVE_RGLRU,
          f"{SERVE_ARCH}: {cfg.n_layers} layers, "
          f"{kinds.count('rglru')} RG-LRU")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = leaf_params(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT),
                            generator=gen, device="cuda")
    # a first, short call loads the kernels these shapes pick (its prefill
    # is printed as the cold one); the counted call is warm
    cold = serve(cfg, params, prompts, 2)
    counters = zero_counters()
    out = serve(cfg, params, prompts, SERVE_GEN)
    launches = kernel_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want["rglru_fwd"] = SERVE_RGLRU * SERVE_GEN
    check(launches == want, f"serve_path launches {launches}, expected {want}")
    check(out.tokens.shape == (SERVE_REQUESTS, SERVE_GEN)
          and bool(torch.isfinite(out.logits).all()),
          f"serve_path: tokens {tuple(out.tokens.shape)}, finite logits "
          f"{bool(torch.isfinite(out.logits).all())}")
    # the reference: the training forward over prompt + generated tokens,
    # on the plain scan and attention
    seq = torch.cat([prompts, out.tokens[:, :-1]], dim=1)
    with torch.inference_mode():
        x, _ = forward(params, cfg, seq, remat=False, head=False,
                       attn_impl="plain", scan_impl="plain")
        ref = head_logits(params, cfg, x[:, SERVE_PROMPT - 1:])
    err = served_error(out.logits, ref)
    check(err <= SERVE_BOUND, f"serve_path: served logits vs the plain "
                              f"forward: max |diff| / max |ref| {err:.3g}")
    profiled = serve_profile(torch, cfg, params, prompts, report)
    decode_tokens = SERVE_REQUESTS * (SERVE_GEN - 1)
    rep = report["serve_path"] = dict(
        arch=SERVE_ARCH, layers=cfg.n_layers, params=n_params,
        requests=SERVE_REQUESTS, prompt=SERVE_PROMPT, gen=SERVE_GEN,
        init_s=init_s, cold_prefill_ms=cold.prefill_s * 1e3,
        prefill_ms=out.prefill_s * 1e3,
        decode_ms_per_token=out.decode_s / (SERVE_GEN - 1) * 1e3,
        decode_tokens_per_s=decode_tokens / out.decode_s,
        prefill_tokens_per_s=SERVE_REQUESTS * SERVE_PROMPT / out.prefill_s,
        peak_bytes=peak, max_rel_err=err, launches=launches,
        first_tokens=out.tokens[0, :16].tolist(), card=report["card"],
        **profiled)
    print(f"serve_path: {SERVE_ARCH} at full width and depth ({cfg.n_layers} "
          f"layers, {n_params:,} params as leaves, formula "
          f"{cfg.total_params():,}, f32), {SERVE_REQUESTS} x "
          f"{SERVE_PROMPT}-token prompts, {SERVE_GEN} greedy tokens: prefill "
          f"{rep['prefill_ms']:.1f} ms (the first call's "
          f"{rep['cold_prefill_ms']:.1f} ms), decode "
          f"{rep['decode_ms_per_token']:.2f} ms/token "
          f"({rep['decode_tokens_per_s']:.0f} tok/s), peak "
          f"{peak / 2**30:.2f} GiB [{report['card']}]; every served "
          f"position vs the plain forward: max |diff| / max |ref| {err:.3g} "
          f"(bound {SERVE_BOUND}); launches {launches}")
    del params, out, cold, x, ref, seq
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_profile(torch, cfg, params, prompts, report):
    """Where the served path's time goes: a profile of the prefill and of
    8 decode steps, device ms by kernel kind and the decode's idle share
    (its wall under the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import decode_step, init_cache, prefill

    def kinds(prof):
        """Device ms by kernel kind: cuBLAS products, the scan, the rest."""
        out = {"products": 0.0, "rglru": 0.0, "other": 0.0}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            t = (e.cuda_time_total if t is None else t) / 1e3
            if t <= 0 or e.key.startswith(("aten::", "cuda", "Memcpy",
                                           "Memset")):
                continue
            name = e.key.lower()
            kind = ("rglru" if "rglru" in name else
                    "products" if any(w in name for w in (
                        "gemm", "gemv", "cutlass", "xmma", "dot_kernel"))
                    else "other")
            out[kind] += t
        return out

    b, p_len = prompts.shape
    cache = init_cache(cfg, b, p_len + SERVE_GEN, device="cuda",
                       prefill_chunk=p_len)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logits = prefill(params, cfg, prompts, cache)
        torch.cuda.synchronize()
    prefill_kinds = kinds(prof)
    token = torch.argmax(logits, dim=-1)
    n_steps = 8
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            token = torch.argmax(decode_step(params, cfg, token, cache,
                                             p_len + i), dim=-1)
        torch.cuda.synchronize()
        decode_wall_ms = (time.perf_counter() - t0) / n_steps * 1e3
    decode_kinds = {k: v / n_steps for k, v in kinds(prof).items()}
    decode_idle = 1.0 - sum(decode_kinds.values()) / decode_wall_ms
    del cache, logits
    print(f"serve_path profile [{report['card']}]: prefill device ms "
          f"{ {k: round(v, 3) for k, v in prefill_kinds.items()} }, a decode "
          f"step {({k: round(v, 3) for k, v in decode_kinds.items()})} in "
          f"{decode_wall_ms:.2f} ms of wall (idle {decode_idle:.1%}, under "
          f"the profiler)")
    return dict(prefill_device_ms=prefill_kinds,
                decode_step_device_ms=decode_kinds,
                decode_step_wall_ms_profiled=decode_wall_ms,
                decode_idle_share=decode_idle)


def serve_smoke_path(torch, report):
    """The seven families of the JAX package's decode-equivalence test at
    smoke size on the card: prefill 16 tokens, decode 8 one by one, every
    position's logits against the training forward and against the same
    served run, both on the plain versions (no kernel); then gemma2's ring
    cache decoding past its window.  Each family's kernels (flash for the
    encoder and the cross-attention, the scan, the WKV) launch as its
    layers say: once a layer and call, the encoder's layers once."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models.model import (
        decode_step,
        encode,
        forward,
        init_cache,
        init_params,
        prefill,
    )
    from repro_torch.tree import tree_flatten_with_path

    b, s, n_pre, cap = (SERVE_SMOKE[k] for k in ("batch", "seq", "prefill",
                                                 "capacity_factor"))

    plain = dict(attn_impl="plain", scan_impl="plain")

    def served(cfg, params, tokens, memory, n_prefill, cap, **impl):
        cache = init_cache(cfg, tokens.shape[0], tokens.shape[1],
                           device="cuda", prefill_chunk=n_prefill)
        got = [prefill(params, cfg, tokens[:, :n_prefill], cache,
                       memory=memory, capacity_factor=cap, **impl)]
        for i in range(n_prefill, tokens.shape[1]):
            got.append(decode_step(params, cfg, tokens[:, i], cache, i,
                                   capacity_factor=cap, **impl))
        return torch.stack(got, dim=1)

    def reference(cfg, params, tokens, memory, n_prefill, cap):
        with torch.inference_mode():
            if cfg.is_encoder_decoder:
                memory = encode(params, cfg, memory, attn_impl="plain")
            logits, _ = forward(params, cfg, tokens, memory=memory,
                                capacity_factor=cap, remat=False, **plain)
        return logits[:, n_prefill - 1:]

    total = None
    rows = {}
    for i, (arch, n_layers) in enumerate(SERVE_FAMILIES):
        cfg = reduce_for_smoke(get_config(arch), n_layers)
        params = init_params(cfg, seed=i, device="cuda")
        for path, leaf in tree_flatten_with_path(params):
            if path[-1] == "gate":
                leaf.fill_(SERVE_GATE)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(100 + i)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device="cuda")
        memory = None
        if cfg.modality != "text":
            memory = torch.randn((b, max(cfg.n_modal_tokens, 1), cfg.d_model),
                                 generator=gen, device="cuda")
        counters = zero_counters()
        got = served(cfg, params, tokens, memory, n_pre, cap)
        launches = kernel_launches(counters)
        kinds = [sp.kind for sp in cfg.layer_specs()]
        calls = 1 + s - n_pre
        want = {name: 0 for name in launches}
        want["rglru_fwd"] = kinds.count("rglru") * calls
        want["rwkv6_fwd"] = kinds.count("rwkv") * calls
        want["flash_fwd"] = (kinds.count("cross_attn") * calls
                             + cfg.n_encoder_layers)
        check(launches == want, f"serve_smoke_path {arch}: launches "
                                f"{launches}, expected {want}")
        err = served_error(got, reference(cfg, params, tokens, memory, n_pre,
                                          cap))
        err_plain = served_error(got, served(cfg, params, tokens, memory,
                                             n_pre, cap, **plain))
        check(err <= SERVE_BOUND and err_plain <= SERVE_BOUND,
              f"serve_smoke_path {arch}: served logits vs the plain forward "
              f"{err:.3g}, vs the plain served run {err_plain:.3g}")
        rows[cfg.name if n_layers == 2 else f"{cfg.name}-{n_layers}"] = dict(
            max_rel_err=err, max_rel_err_plain_served=err_plain,
            launches=launches)
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
        print(f"serve_smoke_path {cfg.name} ({n_layers} layers): prefill "
              f"{n_pre} + {s - n_pre} "
              f"decode steps, max |diff| / max |ref| {err:.3g} against the "
              f"plain forward, {err_plain:.3g} against the plain served run; "
              f"launches "
              f"{ {k: n for k, n in launches.items() if n} }")

    # gemma2's local layers past the smoke window: a ring of 64 slots
    cfg = reduce_for_smoke(get_config("gemma2-2b"))
    params = init_params(cfg, seed=99, device="cuda")
    seq = 2 * cfg.sliding_window + 7
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                           device="cuda")
    got = served(cfg, params, tokens, None, 1, 1.25)
    err = served_error(got, reference(cfg, params, tokens, None, 1, 1.25))
    check(err <= SERVE_BOUND, f"serve_smoke_path ring decode: {err:.3g}")
    rows["gemma2-2b ring"] = dict(max_rel_err=err, positions=seq)
    report["serve_smoke_path"] = rows
    print(f"serve_smoke_path gemma2-2b-smoke ring (window "
          f"{cfg.sliding_window}): 1 prompt token + {seq - 1} decode steps, "
          f"max |diff| / max |ref| {err:.3g}")
    for name in ("rglru_fwd", "rwkv6_fwd", "flash_fwd"):
        check(total[name] > 0, f"serve_smoke_path never launched {name}")
    return total


def tp_config(cut):
    """A ``tp_path`` cut's config: the config at full width with the cut's
    depth, or its smoke config (``reduce_for_smoke``)."""
    from repro_torch.configs import get_config, reduce_for_smoke

    arch, depth, _, _, kind = cut
    if kind == "smoke":
        return reduce_for_smoke(get_config(arch), depth.get("n_layers", 2))
    return dataclasses.replace(get_config(arch), **depth)


def tp_train_kw(cut) -> dict:
    """``train``'s arguments for a ``tp_path`` cut (model 1 or 2): the
    paths' at full width, ``moe_smoke_path``'s for a smoke config."""
    seq, kind = cut[3], cut[4]
    kw = dict(scheduler="deft", seq=seq, coverage_rate=COVERAGE_RATE,
              partition_elems=PARTITION_ELEMS, seed=0, device="cuda", lr=LR)
    if kind == "smoke":
        return dict(kw, batch=MOE_BATCH)
    return dict(kw, batch=BATCH, loss_chunk=LOSS_CHUNK)


def tp_params_vs(ref, params) -> dict:
    """The params gathered over 'model' (``params``, the global tree) held
    to ``ref``'s model-1 buckets on the host, one bucket of its layout at
    a time on the card: the max |diff|, the elements beyond PARAM_TOL and,
    per bucket, the share beyond 10 x PARAM_TOL (rwkv6's limit)."""
    out = dict(max_param_diff=0.0, n_params_over_tol=0, bucket_share=[])
    for buf, want in zip(tree_buckets(ref["layout"], params), ref["params"]):
        d = (buf - want.cuda()).abs()
        out["max_param_diff"] = max(out["max_param_diff"], d.max().item())
        out["n_params_over_tol"] += int((d > PARAM_TOL).sum().item())
        out["bucket_share"].append(
            int((d > 10 * PARAM_TOL).sum().item()) / d.numel())
        del d, buf
    if ref["rwkv"]:
        out["ok"] = (out["max_param_diff"] <= RWKV_PARAM_MAX_DIFF
                     and max(out["bucket_share"]) <= RWKV_BUCKET_SHARE)
    else:
        out["ok"] = (out["max_param_diff"] <= PARAM_MAX_DIFF
                     and out["n_params_over_tol"] <= PARAM_MAX_OVER)
    return out


# where a model rank's part of each MoE gradient sits in the whole tensor:
# the dim split over 'model' (the experts' over 'experts', the shared
# experts' over 'ff')
TP_MOE_SPLIT = {"experts/gate": 0, "experts/up": 0, "experts/down": 0,
                "shared/gate": 1, "shared/up": 1, "shared/down": 0}


def tp_moe_width(rank: int, ref) -> dict:
    """``tp_path``'s MoE FFN cut on model rank ``rank``: ``moe_width_phase``'s
    params, input and cotangent (the same draw), this rank's 80 experts and
    half the shared experts' ff columns (``shard_params``), the forward
    and backward through ``apply_moe(tp=)`` twice (bitwise equal; the
    second timed with CUDA events, its 'model' collectives with the device
    synchronised around each).  Rank 1 then sends rank 0 its out and input
    gradient (which must be rank 0's bit for bit) and its slices of the
    expert and shared gradients, in slices of TP_MOE_CHUNK experts, as
    host tensors over gloo; rank 0 holds out, aux and every gradient to
    ``ref`` (``moe_width_phase``'s model-1 result on the host): each
    tensor's max |diff| over its max |ref|.  Returns the rank's time,
    peak and collectives, and on rank 0 those errors."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.moe import apply_moe
    from repro_torch.sharding.tp import ModelParallel, model_specs, shard_params
    from repro_torch.tree import tree_map

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_debug_mesh(data=1, model=TP_MODEL)
    tp = ModelParallel(mesh)
    cfg, full, x, g = moe_width_inputs(torch)
    me = cfg.moe
    check(tp.split("experts", me.n_experts)
          and tp.split("ff", me.d_expert * me.n_shared_experts),
          "tp_path moe_width: the experts or the shared ff do not split")
    p = tree_map(lambda w: w.clone(), shard_params(
        full, model_specs(full, mesh), mesh))
    del full
    torch.cuda.empty_cache()
    leaves = moe_width_leaves(p, x)

    def run():
        y, aux = apply_moe(p, x, cfg=cfg, tp=tp)
        grads = torch.autograd.grad(torch.sum(y * g) + aux, leaves)
        return [y.detach(), aux.detach(), *grads]

    first = run()
    torch.cuda.synchronize()
    tp.reset()
    tp.timed = True
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    second = run()
    end.record()
    torch.cuda.synchronize()
    tp.timed = False
    ms = start.elapsed_time(end)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          f"tp_path moe_width rank {rank}: two runs on the card differ")
    del second
    got = dict(rank=rank, ms=ms, model_s=tp.seconds,
               model_calls=dict(tp.calls),
               peak_bytes=torch.cuda.max_memory_allocated(),
               local_params=sum(w.numel() for w in leaves[1:]))
    y, aux, *grads = first
    mine = dict(zip(MOE_WIDTH_NAMES, grads), out=y)
    if rank != 0:
        for name in ("out", "x"):
            dist.send(mine[name].cpu(), dst=0)
        for name, dim in TP_MOE_SPLIT.items():
            t = mine[name]
            n = t.shape[dim]
            step = TP_MOE_CHUNK if dim == 0 and "experts" in name else n
            for c in range(0, n, step):
                dist.send(t.narrow(dim, c, min(step, n - c)).contiguous()
                          .cpu(), dst=0)
        return got
    for name in ("out", "x"):
        other = torch.empty(mine[name].shape, dtype=mine[name].dtype)
        dist.recv(other, src=1)
        check(torch.equal(other.cuda(), mine[name]),
              f"tp_path moe_width: the ranks' {name} differ")
    errs = {}
    for name in ("out", "x", "router"):
        want = ref[name].cuda()
        errs[name] = ((mine[name] - want).abs().max()
                      / want.abs().max()).item()
        del want
    errs["aux"] = abs(aux.item() - ref["aux"].item()) / abs(ref["aux"].item())
    for name, dim in TP_MOE_SPLIT.items():
        t = mine[name]
        n = t.shape[dim]
        step = TP_MOE_CHUNK if dim == 0 and "experts" in name else n
        dmax = smax = 0.0
        for r in range(TP_MODEL):
            for c in range(0, n, step):
                w = min(step, n - c)
                if r == 0:
                    part = t.narrow(dim, c, w)
                else:
                    shape = list(t.shape)
                    shape[dim] = w
                    part = torch.empty(shape, dtype=t.dtype)
                    dist.recv(part, src=r)
                    part = part.cuda()
                want = ref[name].narrow(dim, r * n + c, w).cuda()
                dmax = max(dmax, (part - want).abs().max().item())
                smax = max(smax, want.abs().max().item())
                del part, want
        errs[name] = dmax / smax
    got["errs"] = errs
    del first, y, grads, mine, leaves, p, x, g
    gc.collect()
    torch.cuda.empty_cache()
    return got


def tp_train(rank: int, port: int, cuts, steps, refs=None) -> list:
    """One model rank of ``tp_path``: every cut in turn over one gloo group
    of the two ranks (NCCL refuses two ranks on one device; gloo
    all-reduces the card's tensors itself): a config through
    ``train(data=1, model=TP_MODEL)``, ``steps[i]`` steps with every launch
    counter set to 0 just before, or the MoE FFN (``tp_moe_width``).  The
    steps after the first time the 'model' collectives (the device
    synchronised around each).  Returns per cut the rank's losses, step
    times, peak over the steps, launches, the data collectives and the
    schedule's census of them (``sharded_collectives`` on the sharded
    engine, ``phase_collectives`` on the replicated one); on rank 0 also
    the params gathered over 'model' after the last step held to
    ``refs[i]`` (``tp_params_vs``)."""
    import datetime

    import torch
    import torch.distributed as dist
    from repro_torch.launch.train import train
    from repro_torch.train.runtime import phase_collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=TP_MODEL,
        rank=rank, timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    say = (lambda s: print(f"  rank 0: {s}")) if rank == 0 else \
        (lambda s: None)
    out = []
    for i, cut in enumerate(cuts):
        t0 = time.perf_counter()
        if cut[4] == "moe_width":
            got = tp_moe_width(rank, refs[i] if rank == 0 else None)
            got["wall_s"] = time.perf_counter() - t0
            out.append(got)
            continue
        cfg = tp_config(cut)
        n = steps[i]
        got = {}

        def on_step(step, runtime, state, metrics):
            if step == 0:                      # the first step warms up
                runtime.tp.reset()
                runtime.tp.timed = True
            if step != n - 1:
                return
            got.update(model_calls=dict(runtime.tp.calls),
                       model_s=runtime.tp.seconds,
                       local_elems=sum(b.numel() for b in state["pbuf"]),
                       peak_bytes=torch.cuda.max_memory_allocated())
            runtime.tp.timed = False
            params = runtime.params_tree(state)      # a collective
            if rank == 0:
                got["vs"] = tp_params_vs(refs[i], params)
            del params

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counters = zero_counters()
        res = train(cfg, steps=n, data=1, model=TP_MODEL, on_step=on_step,
                    log=say, **tp_train_kw(cut))
        launches = kernel_launches(counters)
        sched, rt = res["schedule"], res["runtime"]
        got.update(
            rank=rank, losses=res["losses"], step_s=res["step_s"],
            collectives=res["collectives"],
            want_collectives=(
                sharded_collectives(sched, res["layout"], n, False)
                if rt.fsdp else [phase_collectives(
                    sched.phases[t % sched.period]) for t in range(n)]),
            launches=launches,
            want_launches=expected_launches(cfg, sched, res["layout"], n),
            stats={k: v for k, v in rt.stats().items()
                   if k in ("dp", "model", "sharded_state")},
            wall_s=time.perf_counter() - t0)
        del res, rt
        out.append(got)
    return out


def tp_child(port: int, cuts, steps, queue) -> None:
    """``tp_path``'s rank 1, in a spawned process: its reports on
    ``queue``."""
    import torch.distributed as dist

    out = tp_train(1, port, cuts, steps)
    queue.put(out)
    dist.destroy_process_group()


def tp_path(torch, schedule, layout, report, against, mla, moe_ref):
    """The 'model' axis at data 1 x model 2: two processes on the one
    card, this one rank 0 and a spawned one rank 1, each holding its
    shards of every leaf the port's ``spec_tree`` splits over 'model',
    the cuts in turn (``tp_train``) with every launch counter zeroed just
    before each.  First the main path's gemma2-2b cut for one period of its
    schedule (8 heads over 4 kv heads: 4 over 2 a rank; d_ff 9216: 4608;
    the 256000-row tied table: 128000), held to ``against`` (the main
    path's stored run); then the recurrent and encoder-decoder families at
    full width, each one schedule period at most TP_MAX_STEPS steps:
    recurrentgemma-9b's pattern period (lru 2048 and 8 of the 16 gate
    blocks a rank, 8 query heads over the one kv head gathered: the f32
    flash at 8:1), 4 layers of rwkv6-1.6b (16 of 32 WKV heads, d_ff 3584,
    the vocab and the untied head split), 2 + 2 layers of
    seamless-m4t-large-v2 (8 heads of 64 in the encoder, the decoder and
    the cross-attention, d_ff 4096; 256,206 vocab rows split into
    128,103); then the FSDP archs on their sharded engine: deepseek-v2-236b's
    dense layer 0 (64 of the 128 MLA heads at 192 / 128, ``wdq`` and
    ``wdkv`` whole, d_ff 6144, 51,200 of the 102,400 vocab rows) held to
    ``mla`` (= (layout, stored run) of ``mla_path``), one of its MoE FFNs
    at published width (80 of the 160 experts and 1536 of the shared
    experts' 3072 ff columns a rank) held to ``moe_ref`` within
    MOE_WIDTH_TOL, and the three FSDP archs' smoke configs.  The family
    and smoke cuts are each held to a model-1 run of the cut made first in
    this process (the same schedule, batches and seed).  The main path's
    NCCL group is replaced by the gloo group of the two ranks.  Held per
    trained cut: the ranks' losses equal, each within 1e-4 relative of the
    reference's (the row-parallel sums run in another order, so not
    bitwise), the params gathered after the steps within PARAM_MAX_DIFF /
    PARAM_MAX_OVER of its buckets (rwkv6: RWKV_PARAM_MAX_DIFF and
    RWKV_BUCKET_SHARE), each rank's launches as its layers and updates say
    with the scan, the WKV, the flash and the bucket update above zero
    where the cut has them, the data collectives the schedule's census,
    the engine the arch's default, and the two ranks' peaks together below
    the card's 80 GB.  Prints each rank's peak, the median step, tokens/s
    and the share of the steps in the 'model' collectives, and each cut's
    wall seconds.  Returns the launches of the main path's cut, of the
    families' and of the FSDP archs', each summed over the ranks, by path
    name."""
    import multiprocessing
    import socket

    import torch.distributed as dist
    from repro_torch.launch.train import build_schedule, train
    from repro_torch.models.model import init_params
    from repro_torch.sharding import needs_fsdp

    name, want, _ = against
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mla_layout, mla_run = mla
    cuts = ((TP_MAIN_CUT,) + TP_FAMILY_CUTS + (TP_MLA_CUT, TP_MOE_WIDTH_CUT)
            + TP_SMOKE_CUTS)
    refs = [dict(layout=layout, params=want["params"], losses=want["losses"],
                 rwkv=False, name=name)]
    schedules, steps = [schedule], [schedule.period]
    for cut in cuts[1:]:
        if cut[4] == "moe_width":
            refs.append(moe_ref)
            schedules.append(None)
            steps.append(0)
            continue
        cfg = tp_config(cut)
        sched = build_schedule(
            init_params(cfg, device="meta"), cfg, dp=1, seq_len=cut[3],
            per_device_batch=tp_train_kw(cut)["batch"],
            partition_elems=PARTITION_ELEMS,
            coverage_rate=COVERAGE_RATE)[3].schedule
        n = min(sched.period, TP_MAX_STEPS)
        steps.append(n)
        schedules.append(sched)
        if cut is TP_MLA_CUT:
            check(n == sched.period == len(mla_run["losses"]),
                  f"tp_path: mla_path's stored period "
                  f"({len(mla_run['losses'])} steps) is not this schedule's "
                  f"({sched.period}, at most {TP_MAX_STEPS})")
            refs.append(dict(layout=mla_layout, params=mla_run["params"],
                             losses=mla_run["losses"], rwkv=False,
                             name="mla_path"))
            continue
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = train(cfg, steps=n, log=lambda s: None, **tp_train_kw(cut))
        check(res["schedule"].phases == sched.phases,
              f"tp_path {cfg.name}: another schedule than planned")
        refs.append(dict(layout=res["layout"], losses=res["losses"],
                         params=[b.cpu() for b in res["state"]["pbuf"]],
                         rwkv=cut[0] == RWKV_ARCH, name="model 1",
                         median_step_s=statistics.median(res["step_s"][1:]),
                         peak_bytes=torch.cuda.max_memory_allocated()))
        del res
    gc.collect()
    torch.cuda.empty_cache()
    model1_s = time.perf_counter() - t0
    if dist.is_initialized():
        dist.destroy_process_group()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    child = ctx.Process(target=tp_child, args=(port, cuts, steps, queue))
    child.start()
    try:
        ranks = [tp_train(0, port, cuts, steps, refs)]
        ranks.append(queue.get(timeout=TP_CHILD_TIMEOUT_S))
    finally:
        child.join(timeout=TP_CHILD_TIMEOUT_S)
        if child.is_alive():
            child.kill()
            child.join()
        dist.destroy_process_group()
    wall = time.perf_counter() - t0
    check(child.exitcode == 0, f"tp_path rank 1 exited {child.exitcode}")
    keys = [f"f32 model {TP_MODEL}", f"f32 model {TP_MODEL} families",
            f"f32 model {TP_MODEL} fsdp archs"]
    totals = {k: {} for k in keys}
    rows = {}
    for i, (cut, ref, n, sched) in enumerate(zip(cuts, refs, steps,
                                                  schedules)):
        arch, _, of_layers, seq, kind = cut
        runs = [r[i] for r in ranks]
        if kind == "moe_width":
            errs = runs[0]["errs"]
            worst = max(errs, key=errs.get)
            check(errs[worst] <= MOE_WIDTH_TOL,
                  f"tp_path moe_width at model {TP_MODEL} against "
                  f"moe_width_phase's model-1 result: {worst} off by "
                  f"{errs[worst]:.3g} of its scale (limit {MOE_WIDTH_TOL})")
            peaks = sum(r["peak_bytes"] for r in runs)
            check(peaks < CARD_BYTES, f"tp_path moe_width: the ranks' peaks "
                                      f"add up to {peaks} bytes")
            rows["moe_width"] = dict(
                seq=seq, rel_err=errs, peaks_sum_bytes=peaks,
                ranks=[{k: v for k, v in r.items() if k != "errs"}
                       for r in runs])
            print(f"tp_path moe_width ({arch} MoE FFN at published width, "
                  f"[1, {seq}, 5120], data 1 x model {TP_MODEL}: 80 experts "
                  f"and half the shared ff a rank): forward + backward "
                  + " / ".join(f"{r['ms']:.3f}" for r in runs)
                  + f" ms by rank [{report['card']}]; against the model-1 "
                  f"result (max |diff| / max |ref|): "
                  f"{', '.join(f'{k} {v:.2g}' for k, v in errs.items())}")
            for r in runs:
                print(f"  rank {r['rank']}: peak "
                      f"{r['peak_bytes'] / 2**30:.2f} GiB, "
                      f"{r['local_params']:,} params, 'model' collectives "
                      f"{r['model_calls']} {r['model_s']:.3f} s, wall "
                      f"{r['wall_s']:.1f} s")
            continue
        cfg = tp_config(cut)
        key = f"tp_path {cfg.name}"
        losses = runs[0]["losses"]
        check(all(r["losses"] == losses for r in runs),
              f"{key}: the ranks' losses differ: "
              f"{[r['losses'] for r in runs]}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
        check(len(losses) == len(ref["losses"]) == n and rel <= 1e-4,
              f"{key} losses {losses} vs {ref['name']}'s {ref['losses']}: "
              f"rel {rel:.3g}")
        vs = runs[0]["vs"]
        check(vs["ok"], f"{key} params vs {ref['name']}: max |diff| "
                        f"{vs['max_param_diff']:.3g}, "
                        f"{vs['n_params_over_tol']} beyond {PARAM_TOL}, "
                        f"bucket shares beyond {10 * PARAM_TOL} "
                        f"{vs['bucket_share']}")
        need = {"bucket_update"} | {
            ARCH: {"flash_fwd"}, RG_ARCH: {"rglru_fwd", "rglru_bwd",
                                           "flash_fwd"},
            RWKV_ARCH: {"rwkv6_fwd", "rwkv6_bwd"}, ED_ARCH: {"flash_fwd"},
        }.get(arch, {"flash_fwd"})
        total = totals[keys[0 if i == 0 else 1 if cut in TP_FAMILY_CUTS
                            else 2]]
        for r in runs:
            check(r["launches"] == r["want_launches"],
                  f"{key} rank {r['rank']} launches {r['launches']}, "
                  f"expected {r['want_launches']}")
            check(all(r["launches"][k] > 0 for k in need),
                  f"{key} rank {r['rank']} launched none of some of {need}")
            check(r["collectives"] == r["want_collectives"],
                  f"{key} rank {r['rank']}: issued {r['collectives']}, the "
                  f"schedule says {r['want_collectives']}")
            check(r["stats"] == {"dp": 1, "model": TP_MODEL,
                                 "sharded_state": needs_fsdp(cfg.name)},
                  f"{key} rank {r['rank']} ran {r['stats']}")
            r["median_step_s"] = statistics.median(r["step_s"][1:])
            r["model_share"] = r["model_s"] / sum(r["step_s"][1:])
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        peaks = sum(r["peak_bytes"] for r in runs)
        check(peaks < CARD_BYTES, f"{key}: the ranks' peaks add up to "
                                  f"{peaks} bytes")
        med = max(r["median_step_s"] for r in runs)
        batch = tp_train_kw(cut)["batch"]
        engine = "sharded" if needs_fsdp(cfg.name) else "replicated"
        rows[cfg.name] = dict(
            config=dict(arch=arch, n_layers=cfg.n_layers,
                        n_encoder_layers=cfg.n_encoder_layers,
                        of_layers=of_layers, params=leaf_params(cfg),
                        batch=batch, seq=seq, kind=kind),
            against=ref["name"], steps=n, period=sched.period, losses=losses,
            ref_losses=ref["losses"], loss_rel_diff=rel, median_step_s=med,
            tokens_per_s=batch * seq / med, peaks_sum_bytes=peaks,
            ranks=[{k: v for k, v in r.items() if k != "vs"} for r in runs],
            **vs)
        if "median_step_s" in ref:
            rows[cfg.name].update(model1_median_step_s=ref["median_step_s"],
                                  model1_peak_bytes=ref["peak_bytes"])
        print(f"{key} ({cfg.n_layers}"
              + (f" + {cfg.n_encoder_layers}" if cfg.n_encoder_layers else "")
              + f" of {of_layers} layers, batch {batch}, seq {seq}, data 1 x "
              f"model {TP_MODEL}, {engine} engine, gloo, two processes on "
              f"one card): {n} steps, "
              f"median step {med:.3f} s"
              + (f" (model 1: {ref['median_step_s']:.3f} s)"
                 if "median_step_s" in ref else "")
              + f", {batch * seq / med:.0f} tok/s [{report['card']}]; vs "
              f"{ref['name']}: loss rel {rel:.3g}, params max diff "
              f"{vs['max_param_diff']:.3g} ({vs['n_params_over_tol']} over "
              f"{PARAM_TOL}); peaks {peaks / 2**30:.2f} GiB together"
              + (f" (model 1: {ref['peak_bytes'] / 2**30:.2f})"
                 if "peak_bytes" in ref else ""))
        for r in runs:
            print(f"  rank {r['rank']}: peak {r['peak_bytes'] / 2**30:.2f} "
                  f"GiB, {r['local_elems']:,} params, median step "
                  f"{r['median_step_s']:.3f} s, launches "
                  f"{ {k: v for k, v in r['launches'].items() if v} }, "
                  f"'model' collectives {r['model_calls']} "
                  f"{r['model_s']:.3f} s = {100 * r['model_share']:.1f}% of "
                  f"steps 1-{n - 1}, wall {r['wall_s']:.1f} s")
    report["tp_path"] = dict(cuts=rows, wall_s=wall, model1_s=model1_s)
    print(f"tp_path: {wall:.1f} s ({model1_s:.1f} s of it the model-1 "
          f"runs)")
    return totals


def run() -> int:
    # torch.compile (the flex_attention yardstick) caches inside the
    # checkout and compiles in this process, starting no worker pool
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.launch.train import build_schedule
        from repro_torch.models.model import init_params
        from repro_torch.train.bucketing import build_bucket_layout
    except ImportError as e:
        print(f"chip_smoke: the port is not in this checkout ({e})",
              file=sys.stderr)
        return 2
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    per_lib = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {sorted(per_lib)} in {build_s:.1f} s (parallel nvcc)")
    for name in build.SOURCES:
        for line in build.ptxas_report(build.build_log(name)):
            print(f"  {name}: {line}")
    report["build_s"] = build_s

    cfg = dataclasses.replace(get_config(ARCH), n_layers=N_LAYERS)
    print(f"config: {ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads}H/{cfg.n_kv_heads}KV, head_dim {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), depth cut to "
          f"{N_LAYERS} of 26 layers: {leaf_params(cfg):,} params as leaves "
          f"(formula {cfg.total_params():,})")
    meta = init_params(cfg, device="meta")
    bucket_of, nb, _, plan = build_schedule(
        meta, cfg, dp=1, seq_len=SEQ, per_device_batch=BATCH,
        partition_elems=PARTITION_ELEMS, coverage_rate=COVERAGE_RATE)
    schedule = plan.schedule
    layout = build_bucket_layout(meta, bucket_of, nb)
    check(any(ph.update_k > 1 or ph.rotate for ph in schedule.phases),
          "degenerate schedule (no merged update, no rotation)")

    rg_cfg = dataclasses.replace(get_config(RG_ARCH), n_layers=RG_LAYERS)
    check(rg_cfg.sliding_window == RG_WINDOW
          and rg_cfg.resolved_lru_width == RG_WIDTH,
          f"{RG_ARCH}: window {rg_cfg.sliding_window}, lru width "
          f"{rg_cfg.resolved_lru_width}")
    print(f"config: {RG_ARCH} at full width (d_model {rg_cfg.d_model}, "
          f"lru_width {RG_WIDTH}, {rg_cfg.n_heads}H/{rg_cfg.n_kv_heads}KV, "
          f"head_dim {rg_cfg.head_dim}, d_ff {rg_cfg.d_ff}, vocab "
          f"{rg_cfg.vocab_size}, window {RG_WINDOW}), depth cut to "
          f"{RG_LAYERS} of {RG_OF_LAYERS} layers: "
          f"{leaf_params(rg_cfg):,} params as leaves (formula "
          f"{rg_cfg.total_params():,})")
    rg_meta = init_params(rg_cfg, device="meta")
    rg_schedule = build_schedule(
        rg_meta, rg_cfg, dp=1, seq_len=SEQ, per_device_batch=BATCH,
        partition_elems=PARTITION_ELEMS,
        coverage_rate=COVERAGE_RATE)[3].schedule
    del rg_meta
    check(RG_STEPS >= rg_schedule.period,
          f"{RG_ARCH}: {RG_STEPS} steps do not cover a period "
          f"({rg_schedule.period})")

    rw_cfg = get_config(RWKV_ARCH)
    check(rw_cfg.n_layers == RWKV_LAYERS
          and rw_cfg.d_model // rw_cfg.n_heads == RWKV_HEAD_SIZE
          and rw_cfg.n_heads == RWKV_HEADS,
          f"{RWKV_ARCH}: {rw_cfg.n_layers} layers, {rw_cfg.n_heads} heads "
          f"of {rw_cfg.d_model // rw_cfg.n_heads}")
    print(f"config: {RWKV_ARCH} at full width and full depth (d_model "
          f"{rw_cfg.d_model}, {rw_cfg.n_heads} time-mix heads of "
          f"{RWKV_HEAD_SIZE}, d_ff {rw_cfg.d_ff}, vocab {rw_cfg.vocab_size}, "
          f"{RWKV_LAYERS} of {RWKV_LAYERS} layers): {leaf_params(rw_cfg):,} "
          f"params as leaves (formula {rw_cfg.total_params():,})")
    rw_schedule = build_schedule(
        init_params(rw_cfg, device="meta"), rw_cfg, dp=1, seq_len=SEQ,
        per_device_batch=BATCH, partition_elems=PARTITION_ELEMS,
        coverage_rate=COVERAGE_RATE)[3].schedule
    check(any(ph.update_k > 1 or ph.rotate for ph in rw_schedule.phases)
          and RWKV_STEPS >= 2 * rw_schedule.period,
          f"{RWKV_ARCH}: degenerate schedule or {RWKV_STEPS} steps short of "
          f"two periods ({rw_schedule.period})")

    ed_cfg = get_config(ED_ARCH)
    check(ed_cfg.is_encoder_decoder and ed_cfg.n_layers == ED_LAYERS
          and ed_cfg.n_encoder_layers == ED_ENC_LAYERS
          and ed_cfg.n_modal_tokens == ED_FRAMES
          and all((ed_cfg.n_heads, ed_cfg.n_kv_heads, ed_cfg.resolved_head_dim)
                  == (sh[3], sh[4], sh[5]) for sh in FLASH_ED_SHAPES.values()),
          f"{ED_ARCH}: {ed_cfg.n_encoder_layers} + {ed_cfg.n_layers} layers, "
          f"{ed_cfg.n_modal_tokens} frames, {ed_cfg.n_heads} heads of "
          f"{ed_cfg.resolved_head_dim}")
    print(f"config: {ED_ARCH} at full width and full depth (d_model "
          f"{ed_cfg.d_model}, {ed_cfg.n_heads} heads of "
          f"{ed_cfg.resolved_head_dim}, d_ff {ed_cfg.d_ff}, vocab "
          f"{ed_cfg.vocab_size}, {ED_ENC_LAYERS} encoder + {ED_LAYERS} "
          f"decoder layers, {ED_FRAMES} stub frames, {ed_cfg.norm}, "
          f"{ed_cfg.ffn_activation}, tied embeddings): "
          f"{leaf_params(ed_cfg):,} params as leaves (formula "
          f"{ed_cfg.total_params():,}, which counts one attention per "
          f"decoder layer)")
    ed_schedule = build_schedule(
        init_params(ed_cfg, device="meta"), ed_cfg, dp=1, seq_len=ED_SEQ,
        per_device_batch=BATCH, partition_elems=PARTITION_ELEMS,
        coverage_rate=COVERAGE_RATE)[3].schedule
    check(any(ph.update_k > 1 or ph.rotate for ph in ed_schedule.phases),
          f"{ED_ARCH}: degenerate schedule")

    mla_cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    m = mla_cfg.mla
    check((mla_cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim,
           m.v_head_dim) == FLASH_MLA_SHAPES["mla"][2:]
          and [s.ffn for s in mla_cfg.layer_specs()] == ["moe"]
          and mla_cfg.moe.first_k_dense == 1,
          f"{MLA_ARCH}: {mla_cfg.n_heads} heads, d_qk / d_v "
          f"{m.qk_nope_head_dim + m.qk_rope_head_dim} / {m.v_head_dim}")
    print(f"config: {MLA_ARCH} at full width cut to its dense layer 0 (MLA: "
          f"d_model {mla_cfg.d_model}, {mla_cfg.n_heads} heads, q_lora "
          f"{m.q_lora_rank}, kv_lora {m.kv_lora_rank}, d_qk / d_v "
          f"{m.qk_nope_head_dim + m.qk_rope_head_dim} / {m.v_head_dim}; "
          f"SwiGLU d_ff {mla_cfg.d_ff}; vocab {mla_cfg.vocab_size}, untied), "
          f"{MLA_LAYERS} of {MLA_OF_LAYERS} layers: "
          f"{leaf_params(mla_cfg):,} params as leaves (formula "
          f"{mla_cfg.total_params():,})")
    mla_meta = init_params(mla_cfg, device="meta")
    mla_bucket_of, mla_nb, _, mla_plan = build_schedule(
        mla_meta, mla_cfg, dp=1, seq_len=MLA_SEQ, per_device_batch=BATCH,
        partition_elems=PARTITION_ELEMS, coverage_rate=COVERAGE_RATE)
    mla_schedule = mla_plan.schedule
    mla_layout = build_bucket_layout(mla_meta, mla_bucket_of, mla_nb)
    del mla_meta
    check(any(ph.update_k > 1 or ph.rotate for ph in mla_schedule.phases)
          and MLA_STEPS >= 2 * mla_schedule.period,
          f"{MLA_ARCH}: degenerate schedule or {MLA_STEPS} steps short of two "
          f"periods ({mla_schedule.period})")

    walls = report["walls"] = {}

    def timed(key, fn, *args, **kw):
        """``fn(*args, **kw)``, its wall seconds printed and kept in
        ``report["walls"]`` and in its own entry (``wall_s``), so that a
        later path can be budgeted from them."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        walls[key] = time.perf_counter() - t
        if isinstance(report.get(key), dict):
            report[key]["wall_s"] = walls[key]
        print(f"{key}: {walls[key]:.1f} s wall")
        return out

    entries = [timed("flash", flash_phase, torch, report),
               timed("bucket_update", bucket_phase, torch, layout, report)]
    timed("sharded_update", sharded_update_phase, torch, meta, bucket_of, nb,
          report)
    entries += timed("quantize", quantize_phase, torch, layout, report)
    entries += timed("flash_bf16", flash_bf16_phase, torch, report)
    entries += timed("rglru", rglru_phase, torch, report)
    entries += timed("rwkv6", rwkv6_phase, torch, report)
    timed("rwkv_grads", rwkv_grad_phase, torch, rw_cfg, report)
    replicated, sharded, streamed, sharded_prec, mla_store = {}, {}, {}, {}, {}
    steps = 2 * schedule.period + 2
    period = schedule.period

    launches = {
        "f32": timed("main_path", main_path, torch, cfg, schedule, report,
                     "main_path", ARCH, 26, steps, store=replicated),
        "f32 sharded": timed(
            "sharded_path", main_path, torch, cfg, schedule, report,
            "sharded_path", ARCH, 26, steps, fsdp=True, store=sharded,
            against=("main_path", replicated, False)),
        # bitwise the sharded run: one period and the next cycle's first
        # step, where the streamed order is recorded
        "f32 sharded streamed": timed(
            "decoupled_path", main_path, torch, cfg, schedule, report,
            "decoupled_path", ARCH, 26, period + 1, fsdp=True,
            decoupled=True, store=streamed,
            against=("sharded_path", sharded, True)),
        # bitwise their unrouted runs (and the 4-rank gloo tests hold the
        # chains bitwise on the CPU): one period, and the streamed one the
        # next cycle's first step too
        "f32 chain": timed(
            "chain_path", main_path, torch, cfg, schedule, report,
            "chain_path", ARCH, 26, period, chain=True,
            against=("main_path", replicated, True)),
        "f32 sharded streamed chain": timed(
            "chain_path_sharded", main_path, torch, cfg, schedule, report,
            "chain_path_sharded", ARCH, 26, period + 1, fsdp=True,
            decoupled=True, chain=True,
            against=("decoupled_path", streamed, True)),
        f"{WIRE}+{MASTER}": timed(
            "precision_path", precision_path, torch, cfg, report,
            "precision_path", COVERAGE_RATE, delayed=False),
        f"{WIRE}+{MASTER} delayed": timed(
            "precision_path_delayed", precision_path, torch, cfg, report,
            "precision_path_delayed", DELAYED_COVERAGE_RATE, delayed=True),
        f"{WIRE}+{MASTER} sharded": timed(
            "sharded_precision_path", precision_path, torch, cfg, report,
            "sharded_precision_path", DELAYED_COVERAGE_RATE, delayed=True,
            fsdp=True, store=sharded_prec),
        f"{WIRE}+{MASTER} sharded streamed": timed(
            "decoupled_precision_path", precision_path, torch, cfg, report,
            "decoupled_precision_path", DELAYED_COVERAGE_RATE, delayed=True,
            fsdp=True, decoupled=True,
            against=("sharded_precision_path", sharded_prec, True)),
        f"{RG_ARCH} f32": timed(
            "recurrent_path", main_path, torch, rg_cfg, rg_schedule, report,
            "recurrent_path", RG_ARCH, RG_OF_LAYERS, RG_STEPS),
        f"{RWKV_ARCH} f32": timed(
            "rwkv_path", main_path, torch, rw_cfg, rw_schedule, report,
            "rwkv_path", RWKV_ARCH, RWKV_LAYERS, RWKV_STEPS,
            bucket_share=RWKV_BUCKET_SHARE),
        f"{ED_ARCH} f32": timed(
            "encdec_path", main_path, torch, ed_cfg, ed_schedule, report,
            "encdec_path", ED_ARCH, ED_LAYERS, 2 * ed_schedule.period + 2,
            seq=ED_SEQ),
        # the arch's default engine; its schedule updates at every position
        # but the last, so no position reuses a gather within the cycle;
        # its first period is what tp_path's model-2 cut is held to
        f"{MLA_ARCH} f32 sharded": timed(
            "mla_path", main_path, torch, mla_cfg, mla_schedule, report,
            "mla_path", MLA_ARCH, MLA_OF_LAYERS, MLA_STEPS, fsdp=True,
            seq=MLA_SEQ, need_reuse=False, store=mla_store),
        # the same two configs on the delayed precision path (int8 wires,
        # bf16sr master, bf16 compute), each on its default engine
        f"{ED_ARCH} {WIRE}+{MASTER}": timed(
            "encdec_precision_path", precision_path, torch, ed_cfg, report,
            "encdec_precision_path", DELAYED_COVERAGE_RATE, delayed=True,
            seq=ED_SEQ, compute_dtype="bf16", f32_key="encdec_path"),
        f"{MLA_ARCH} {WIRE}+{MASTER} sharded": timed(
            "mla_precision_path", precision_path, torch, mla_cfg, report,
            "mla_precision_path", DELAYED_COVERAGE_RATE, delayed=True,
            fsdp=True, seq=MLA_SEQ, need_reuse=False, f32_key="mla_path"),
    }
    for engine, n in timed(
            "baselines_path", baselines_path, torch, cfg, schedule,
            bucket_of, layout, report,
            ("main_path", replicated, False)).items():
        launches[f"f32 {engine.replace('_', '-')}"] = n
    for key in ("mla_path", "mla_precision_path"):
        check(report[key]["peak_bytes"] < 80e9,
              f"{key} peak {report[key]['peak_bytes']} bytes")
    launches["moe smoke"] = timed("moe_smoke_path", moe_smoke_path, torch,
                                  report)
    timed("checkpoint_path", checkpoint_path, torch, cfg, report,
          "checkpoint_path", ("main_path", replicated, True),
          coverage_rate=COVERAGE_RATE)
    timed("checkpoint_precision_path", checkpoint_path, torch, cfg, report,
          "checkpoint_precision_path",
          ("sharded_precision_path", sharded_prec, True),
          coverage_rate=DELAYED_COVERAGE_RATE, wire_precision=WIRE,
          master_dtype=MASTER, fsdp=True, compute_dtype="bf16")
    timed("checkpoint_files", checkpoint_files_phase, torch, report)
    launches["f32 adapt"] = timed(
        "adapt_path", adapt_path, torch, cfg, report, "adapt_path",
        "main_path", coverage_rate=COVERAGE_RATE)
    launches[f"{WIRE}+{MASTER} sharded adapt"] = timed(
        "adapt_precision_path", adapt_path, torch, cfg, report,
        "adapt_precision_path", "sharded_precision_path",
        coverage_rate=DELAYED_COVERAGE_RATE, wire_precision=WIRE,
        master_dtype=MASTER, fsdp=True, compute_dtype="bf16")
    launches["f32 sharded elastic fallback"] = timed(
        "elastic_fallback_path", elastic_fallback_path, torch, cfg, report,
        "elastic_fallback_path",
        (("main_path", replicated, False), ("sharded_path", sharded, True)),
        "sharded_path", coverage_rate=COVERAGE_RATE)
    launches[f"{WIRE}+{MASTER} sharded elastic fallback"] = timed(
        "elastic_fallback_precision_path", elastic_fallback_path, torch, cfg,
        report, "elastic_fallback_precision_path",
        (("sharded_precision_path", sharded_prec, True),),
        "sharded_precision_path", coverage_rate=DELAYED_COVERAGE_RATE,
        wire_precision=WIRE, master_dtype=MASTER, compute_dtype="bf16")
    launches["smoke elastic halt"] = timed("elastic_halt", elastic_halt_phase,
                                           torch, report)
    launches["serve"] = timed("serve_path", serve_path, torch, report)
    launches["serve smoke"] = timed("serve_smoke_path", serve_smoke_path,
                                    torch, report)
    # its model-1 result, on the host, is what tp_path's model-2 cut of the
    # same FFN is held to
    moe_ref = timed("moe_width", moe_width_phase, torch, report)
    launches.update(timed(
        "tp_path", tp_path, torch, schedule, layout, report,
        ("main_path", replicated, False), (mla_layout, mla_store), moe_ref))
    del moe_ref
    del replicated, sharded, streamed, sharded_prec, mla_store
    for e in entries:
        by_path = {path: n[e["name"]] for path, n in launches.items()}
        e["launches"] = next((n for n in by_path.values() if n), 0)
        e["launches_by_path"] = by_path
    report["kernels"] = entries
    report["wall_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
