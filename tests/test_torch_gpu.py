"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  This
file imports neither JAX nor the JAX package, so it runs on a machine
with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: flash attention 1e-4 absolute and relative on out, lse and
the autograd gradients (f32 inputs: split-TF32 products, about 2^-22
relative, summed in another order than the plain version's matmuls), its
f32 split pass bitwise (rounding and data movement only); on bf16 inputs lse keeps 1e-4, out (bf16)
rtol 2**-7 (one bf16 rounding step) and the gradients rtol 1.6e-2 with
atol max|g| / 128 (the plain backward reads the kernel's rounded output);
the bf16 kernel at MLA's 192 / 128 and at 48 / 32 zero-padded to 64 / 32
under the same bf16 limits, and a bf16 q over f32 K/V launching the f32
kernel (jnp's promotion); the bucket update (on whole buffers, and on the four spans of a sharded
layout reassembled against the full-buffer apply), the three quantize
kernels and the two RG-LRU scan kernels bitwise (each rounds every operation separately, as the plain
version's elementwise kernels do, and the hash is integer arithmetic); the
RWKV-6 WKV forward and backward max |diff| / max |plain| <= 1e-4 on o and
every gradient (f32 on both sides, another summation order inside the small
products), S_final, the chunk-start states and ds0 bitwise.  The f32
flash at MLA's d_qk != d_v (192 / 128, and 48 / 32 zero-padded to the
instantiated 64 / 32) under the same 1e-4, its split pass bitwise; the MoE
FFN's forward and backward twice on the card, bitwise equal (no float sum
in its routing depends on the order of atomics).  At one rank
the chain collectives are the identity and issue no P2P op, and the
decoupled sharded engine's streamed param gathers (f32 and int8 wires,
also routed along the one-rank chain) train bitwise as the burst ones.  A
sharded bf16sr state (int8 wires, bf16 compute, the gather cache) goes
through real checkpoint files and back onto the card bitwise, and a run
resumed from them mid-cycle is bitwise the uninterrupted one.  The
served path: the f32 flash at one query (a decode step's cross-attention)
under the same 1e-4; each family's prefill + decode through the kernels
within max |diff| / max |ref| 2e-4 of the training forward (the bound of
the JAX package's decode-equivalence test) and of the same served run on
the plain versions, its kernels launched once a layer and call;
``serve`` launching the scan once a layer at the prefill and at each
decode step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.bucket_update import (
    apply_bucket_updates,
    bucket_update_cuda,
    bucket_update_ref,
    build_segments,
    pack_scalars,
)
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_fwd_cuda,
    flash_fwd_plain,
)
from repro_torch.kernels.flash_attention.ops import (
    _tma_aligned,
    flash_split_plain,
    kernel_dims,
    split_buffer,
)
from repro_torch.kernels.quantize import (
    dequantize_int8_cuda,
    dequantize_int8_plain,
    quantize_int8_cuda,
    quantize_int8_plain,
    stochastic_round_bf16_cuda,
    stochastic_round_bf16_plain,
)
from repro_torch.kernels.rglru import (
    rglru_bwd_cuda,
    rglru_fwd_cuda,
    rglru_scan,
    rglru_scan_bwd_plain,
    rglru_scan_plain,
)
from repro_torch.kernels.rwkv6 import (
    rwkv6_bwd_cuda,
    rwkv6_bwd_plain,
    rwkv6_fwd_cuda,
    rwkv6_mix,
)
from repro_torch.kernels.rwkv6.ops import _chunked_forward
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.deft import plan_ag_stream
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data.pipeline import make_batch
from repro_torch.checkpoint import restore
from repro_torch.launch.train import (
    build_schedule,
    init_distributed,
    restore_runtime_state,
    train,
)
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import serve
from repro_torch.models.model import (
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
    prefill,
)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.optim.optimizers import adamw, sgd_momentum
from repro_torch.sharding.tp import (
    ModelParallel,
    copy_in,
    gather,
    reduce_out,
    vocab_embed,
    vocab_parallel_nll,
)
from repro_torch.train.bucketing import (
    build_bucket_layout,
    build_layout_transition,
)
from repro_torch.train.chains import (
    chain_all_gather,
    chain_all_reduce,
    chain_reduce_scatter,
)
from repro_torch.train.runtime import DeftRuntime
from repro_torch.tree import (
    tree_flatten_with_path,
    tree_leaves,
    tree_unflatten,
)

TOL = 1e-4
BF16_OUT_RTOL = 2 ** -7
BF16_GRAD_RTOL = 1.6e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc there)")


def _qkv(seed, b, s, h, kvh, d, sk=None):
    g = torch.Generator().manual_seed(seed)
    mk = lambda n, s: torch.randn((b, s, n, d), generator=g).cuda()
    return mk(h, s), mk(kvh, sk or s), mk(kvh, sk or s)


@pytest.mark.gpu
@pytest.mark.parametrize("d,h,kvh,s,causal,window,cap", [
    (32, 4, 2, 128, True, 0, 0.0),
    (64, 4, 4, 100, False, 0, 0.0),
    (128, 8, 2, 200, True, 0, 0.0),
    (256, 8, 4, 333, True, 100, 50.0),
    (256, 2, 1, 64, False, 0, 0.0),
    (256, 16, 1, 300, True, 64, 0.0),       # recurrentgemma: MQA 16:1
    (64, 16, 16, (300, 77), False, 0, 0.0),  # cross-attention: Sq != Sk
    (128, 36, 4, 333, True, 100, 0.0),      # starcoder2: 36 heads over 4
])
def test_flash_kernel_matches_plain(d, h, kvh, s, causal, window, cap):
    """``s`` is the length of q and k/v, or a pair (Sq, Sk)."""
    _need_card()
    sq, sk = s if isinstance(s, tuple) else (s, s)
    q, k, v = _qkv(5, 2, sq, h, kvh, d, sk)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = flash_fwd_cuda(q, k, v, **kw)
    ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)

    w = torch.randn_like(q)
    grads = []
    for impl in ("cuda", "plain"):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        torch.sum(flash_attention(*xs, impl=impl, **kw) * w).backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("elem", [False, True], ids=["uniform", "per-element"])
@pytest.mark.parametrize("spec", [adamw(1e-2, weight_decay=0.01),
                                  sgd_momentum(3e-2, momentum=0.85,
                                               weight_decay=0.02)],
                         ids=["adamw", "sgd"])
def test_bucket_kernel_bitwise(spec, elem):
    _need_card()
    adam = spec.name == "adamw"
    padded, n_valid = 4096 + 640, 4096 + 533
    rng = np.random.default_rng(7)
    mk = lambda: torch.from_numpy(
        rng.standard_normal(padded).astype(np.float32)).cuda()
    p, m, v, g = mk(), mk(), mk().abs(), mk()
    sc = torch.rand(padded, device="cuda") * 0.5 + 0.5
    wd = torch.rand(padded, device="cuda") * 0.1
    scal = pack_scalars(spec, torch.tensor(3, dtype=torch.int32, device="cuda"),
                        grad_scale=0.5, clip=torch.tensor(0.9, device="cuda"))
    kw = dict(n_valid=n_valid,
              uniform=None if elem else (1.0, spec.weight_decay),
              elem_hparams=(sc, wd) if elem else None)
    want = bucket_update_ref(spec, p, m, v if adam else None, g, scal, **kw)
    bucket_update_cuda(spec, p, m, v if adam else None, g, scal,
                       zero_grads=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(p, want[0]) and torch.equal(m, want[1])
    assert (not adam) or torch.equal(v, want[2])
    assert not g.any()


SPAN_SHARDS = 4


def _span_case(opt, elem, master):
    """A 4-shard layout of two buckets whose padded tails lie in their
    last spans (NaN/inf there in the gradient), its spec and start
    buffers."""
    shapes = {"w": (37, 90), "b": (13,), "h": (2000,), "u": (5, 7, 30)}
    lay = build_bucket_layout(
        {k: torch.empty(v, device="meta") for k, v in shapes.items()},
        (0, 1, 1, 0), 2, shard_count=SPAN_SHARDS)
    kw = dict(grad_clip=0.0)
    if elem:
        kw.update(decay_mask="matrix", ndim1_lr_scale=0.5)
    spec = (adamw(1e-2, weight_decay=0.01, **kw) if opt == "adamw" else
            sgd_momentum(3e-2, momentum=0.85, weight_decay=0.02, **kw))
    rng = np.random.default_rng(11)
    bufs = {}
    for name in ("p", "m", "v", "g"):
        bufs[name] = []
        for n, valid in zip(lay.buf_sizes, lay.sizes):
            x = rng.standard_normal(n).astype(np.float32)
            x = np.abs(x) if name == "v" else x
            x[valid:] = (np.resize(np.array([np.nan, np.inf, -np.inf],
                                            np.float32), n - valid)
                         if name == "g" else 0.0)
            bufs[name].append(torch.from_numpy(x).cuda())
    if master == "bf16sr":
        bufs["p"] = [x.to(torch.bfloat16) for x in bufs["p"]]
    return lay, spec, bufs


def _span_update(lay, spec, bufs, master, impl=None):
    """One update of every span in turn (fresh step counters), on copies
    of ``bufs``; returns the reassembled p, m, v."""
    spans = lay.shard_sizes
    c = {k: [x.clone() for x in v] for k, v in bufs.items()}
    for s in range(SPAN_SHARDS):
        cut = lambda xs: [x[s * spans[b]:(s + 1) * spans[b]]
                          for b, x in enumerate(xs)]
        opt = {"step": torch.tensor(2, dtype=torch.int32, device="cuda"),
               "m": cut(c["m"])}
        if spec.name == "adamw":
            opt["v"] = cut(c["v"])
        apply_bucket_updates(spec, build_segments(lay, spec), cut(c["p"]),
                             cut(c["g"]), opt, grad_scale=0.5, impl=impl,
                             shard_id=s, master_dtype=master,
                             quantize_impl="plain" if impl == "plain" else None)
    torch.cuda.synchronize()
    return c["p"], c["m"], c["v"]


@pytest.mark.gpu
@pytest.mark.parametrize("elem", [False, True], ids=["uniform", "per-element"])
@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_bucket_kernel_on_spans_bitwise(opt, elem):
    """Each of the four spans through the kernel reassembles bitwise to one
    kernel apply over the whole buffers; the hostile gradient tail does
    not leak."""
    _need_card()
    lay, spec, bufs = _span_case(opt, elem, "f32")
    launches = bucket_update_cuda.launches
    got = _span_update(lay, spec, bufs, "f32")
    assert bucket_update_cuda.launches - launches == 2 * SPAN_SHARDS
    full = {k: [x.clone() for x in v] for k, v in bufs.items()}
    opt_f = {"step": torch.tensor(2, dtype=torch.int32, device="cuda"),
             "m": full["m"], "v": full["v"]}
    apply_bucket_updates(spec, build_segments(lay, spec), full["p"],
                         full["g"], opt_f, grad_scale=0.5)
    torch.cuda.synchronize()
    for k, xs in zip("pmv", got):
        if k == "v" and spec.name != "adamw":
            continue
        for x, want in zip(xs, full[k]):
            assert torch.isfinite(x).all() and torch.equal(x, want), k


@pytest.mark.gpu
@pytest.mark.parametrize("elem", [False, True], ids=["uniform", "per-element"])
@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_bucket_kernel_on_bf16sr_spans_bitwise(opt, elem):
    """bf16sr spans: the kernels (update and stochastic rounding over the
    span's own indices) bitwise equal to the plain versions."""
    _need_card()
    lay, spec, bufs = _span_case(opt, elem, "bf16sr")
    sr = stochastic_round_bf16_cuda.launches
    got = _span_update(lay, spec, bufs, "bf16sr")
    assert stochastic_round_bf16_cuda.launches - sr == 2 * SPAN_SHARDS
    want = _span_update(lay, spec, bufs, "bf16sr", impl="plain")
    for b in range(lay.n_buckets):
        assert torch.equal(got[0][b].view(torch.int16),
                           want[0][b].view(torch.int16))
        assert torch.equal(got[1][b], want[1][b])
        assert torch.equal(got[2][b], want[2][b])


# the f32 kernel's split pass writes K and V as TF32 hi + lo, in its stages'
# layout, bit for bit what the plain version computes
@pytest.mark.gpu
@pytest.mark.parametrize("d,kvh,s", [(32, 2, 128), (64, 4, 100), (128, 2, 200),
                                     (256, 4, 333), (256, 1, 64), (256, 1, 1)])
def test_flash_split_pass_bitwise(d, kvh, s):
    _need_card()
    q, k, v = _qkv(7, 2, s, 2 * kvh, kvh, d)
    split = split_buffer(2, kvh, s, d, "cuda")
    flash_fwd_cuda(q, k, v, causal=True, split=split)
    want = flash_split_plain(k, v)
    torch.cuda.synchronize()
    assert torch.equal(split.view(torch.int32), want.view(torch.int32))


# MLA: d_v != d_qk; 48 / 32 runs zero-padded at the instantiated 64 / 32
@pytest.mark.gpu
@pytest.mark.parametrize("d,dv,h,kvh,s,causal", [
    (192, 128, 8, 8, 333, True),
    (192, 128, 4, 4, 64, True),
    (192, 128, 4, 2, (300, 77), False),
    (48, 32, 4, 4, 200, True),
    (48, 32, 4, 4, 1, True),
    (64, 32, 4, 1, 130, False),
])
def test_flash_kernel_mla_dims_match_plain(d, dv, h, kvh, s, causal):
    _need_card()
    sq, sk = s if isinstance(s, tuple) else (s, s)
    q, k, _ = _qkv(8, 2, sq, h, kvh, d, sk)
    v = _qkv(9, 2, sk, kvh, kvh, dv)[0]
    dq_k, dv_k = kernel_dims(d, dv)
    split = split_buffer(2, kvh, sk, dq_k, "cuda", dv_k)
    out, lse = flash_fwd_cuda(q, k, v, causal=causal, split=split)
    ref, ref_lse = flash_fwd_plain(q, k, v, causal=causal)
    pad = lambda x, n: torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    want = flash_split_plain(pad(k, dq_k), pad(v, dv_k))
    torch.cuda.synchronize()
    assert out.shape == (2, sq, h, dv)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)
    assert torch.equal(split.view(torch.int32), want.view(torch.int32))
    w = torch.randn_like(ref)
    grads = []
    for impl in ("cuda", "plain"):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        torch.sum(flash_attention(*xs, causal=causal, impl=impl) * w).backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_twice_on_the_card_is_bitwise(arch):
    """Output, aux and every gradient of ``apply_moe`` (at a capacity factor
    that drops tokens) are the same bits in two runs."""
    _need_card()
    cfg = reduce_for_smoke(get_config(arch))
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = init_moe(gen, cfg, device="cuda")
    x = torch.randn((2, 64, cfg.d_model), device="cuda", generator=gen)
    w = torch.randn(x.shape, device="cuda", generator=gen)
    runs = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_(True)] + [
            t.clone().requires_grad_(True) for t in tree_leaves(p)]
        y, aux = apply_moe(tree_unflatten(p, leaves[1:]), leaves[0],
                           cfg=cfg, capacity_factor=0.75)
        (torch.sum(y * w) + aux).backward()
        runs.append([y.detach(), aux.detach()] + [t.grad for t in leaves])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_needs_a_key(dtype):
    _need_card()
    q, k, v = (x.to(dtype) for x in _qkv(9, 1, 16, 2, 1, 64))
    with pytest.raises(ValueError, match="at least one key"):
        flash_fwd_cuda(q, k[:, :0], v[:, :0])


# bf16 goes to the tensor-core kernel (flash_fwd_sm90.cu): key blocks of 64
# at D = 256, 128 below; 128 query rows per CTA
@pytest.mark.gpu
@pytest.mark.parametrize("d,h,kvh,s,causal,window,cap", [
    (128, 8, 2, 200, True, 0, 0.0),
    (256, 8, 4, 333, True, 100, 50.0),
    (32, 4, 2, 128, True, 0, 0.0),          # 64-byte swizzle
    (32, 4, 1, 300, True, 90, 30.0),        # window < key block, softcap
    (64, 4, 4, 100, False, 0, 0.0),         # bidirectional, S < key block
    (64, 8, 2, 257, True, 77, 50.0),        # window < key block, ragged
    (128, 8, 8, 40, True, 0, 50.0),         # S < key block, softcap
    (128, 4, 2, 390, False, 0, 0.0),        # bidirectional, S % 128 != 0
    (256, 16, 1, 300, True, 64, 0.0),       # MQA 16:1, window = key block
    (256, 4, 2, 200, False, 0, 50.0),       # bidirectional, softcap
    (256, 8, 4, 150, True, 37, 0.0),        # window < key block, no softcap
    (256, 2, 1, 20, True, 0, 0.0),          # S < key block
])
def test_flash_kernel_bf16_matches_plain(d, h, kvh, s, causal, window, cap):
    _need_card()
    q, k, v = (x.bfloat16() for x in _qkv(6, 2, s, h, kvh, d))
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = flash_fwd_cuda(q, k, v, **kw)
    ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_OUT_RTOL,
                               atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)
    w = torch.randn(q.shape, device="cuda")
    grads = []
    for impl in ("cuda", "plain"):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        torch.sum(flash_attention(*xs, impl=impl, **kw).float() * w).backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(
            a.float(), b.float(), rtol=BF16_GRAD_RTOL,
            atol=b.float().abs().max().item() / 128)
    with pytest.raises(TypeError):
        flash_fwd_cuda(q, k.float(), v)


@pytest.mark.gpu
def test_flash_kernel_bf16_copies_strides_tma_cannot_take():
    _need_card()
    d = 128
    q, k, v = (x.bfloat16() for x in _qkv(8, 2, 96, 4, 2, d + 4))
    # head stride 132 elements: not a multiple of 16 bytes, so copied
    qs, ks, vs = (x[..., :d] for x in (q, k, v))
    assert not _tma_aligned(qs)
    got = flash_fwd_cuda(qs, ks, vs, causal=True)
    want = flash_fwd_cuda(*(x.contiguous() for x in (qs, ks, vs)), causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # a head dim without a tile of its own runs at one that holds it (48
    # at 64, read at 48 once copied); one wider than every tile is refused
    got = flash_fwd_cuda(*(x[..., :48] for x in (q, k, v)))
    want = flash_fwd_plain(*(x[..., :48] for x in (q, k, v)))
    torch.cuda.synchronize()
    assert got[0].shape == want[0].shape
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               rtol=BF16_OUT_RTOL, atol=1e-5)
    with pytest.raises(ValueError):
        flash_fwd_cuda(*(torch.cat([x, x, x], -1) for x in (q, k, v)))


# MLA's d_qk != d_v on bf16: the (192, 128) instantiation, and 48 / 32
# read at 48 by the instantiated 64 / 32; from 40 kv heads on, more than
# the 132 CTAs in flight can share four ways, the grid runs query blocks
# first (two stages of 128 keys at (192, 128))
@pytest.mark.gpu
@pytest.mark.parametrize("d,dv,h,kvh,s,causal,window,cap", [
    (192, 128, 4, 4, 200, True, 0, 0.0),
    (192, 128, 4, 2, (300, 77), False, 0, 0.0),
    (192, 128, 8, 8, 40, True, 0, 0.0),             # S < key block
    (48, 32, 4, 4, 200, True, 0, 0.0),
    (48, 32, 4, 4, 1, True, 0, 0.0),
    (64, 32, 4, 1, 130, False, 0, 0.0),
    (192, 128, 40, 40, 333, True, 0, 0.0),          # query first, ragged
    (192, 128, 48, 48, 100, False, 0, 0.0),         # S < key block
    (192, 128, 40, 40, 256, True, 0, 0.0),          # blocks = stages
    (192, 128, 40, 40, (200, 130), False, 0, 0.0),  # Sq != Sk, ragged
    (192, 128, 40, 40, 520, True, 77, 0.0),         # window < key block
    (192, 128, 40, 40, 300, True, 0, 50.0),         # softcap
    (128, 128, 40, 40, 300, True, 100, 50.0),       # square, query first
    (48, 32, 40, 40, 300, True, 0, 0.0),            # read at 48, query first
])
def test_flash_kernel_bf16_mla_dims_match_plain(d, dv, h, kvh, s, causal,
                                                window, cap):
    _need_card()
    sq, sk = s if isinstance(s, tuple) else (s, s)
    q, k, _ = (x.bfloat16() for x in _qkv(10, 2, sq, h, kvh, d, sk))
    v = _qkv(11, 2, sk, kvh, kvh, dv)[0].bfloat16()
    before = dict(flash_fwd_cuda.launches_bf16_dims)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = flash_fwd_cuda(q, k, v, **kw)
    ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    at = kernel_dims(d, dv)
    assert flash_fwd_cuda.launches_bf16_dims[at] == before.get(at, 0) + 1
    assert out.shape == (2, sq, h, dv) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_OUT_RTOL,
                               atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)
    w = torch.randn(ref.shape, device="cuda")
    grads = []
    for impl in ("cuda", "plain"):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        torch.sum(flash_attention(*xs, impl=impl, **kw).float()
                  * w).backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(
            a.float(), b.float(), rtol=BF16_GRAD_RTOL,
            atol=b.float().abs().max().item() / 128)


@pytest.mark.gpu
def test_flash_mixed_dtypes_launch_the_f32_kernel():
    """A bf16 q over f32 K/V (a bf16 decoder's cross-attention to the f32
    memory) runs the f32 kernel on the promoted q: out in q's dtype, each
    gradient in its input's, and no bf16 launch."""
    _need_card()
    q, k, v = _qkv(12, 2, 96, 4, 4, 64, 40)
    q = q.bfloat16()
    n, n_bf16 = flash_fwd_cuda.launches, flash_fwd_cuda.launches_bf16
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*xs, causal=False)
    assert flash_fwd_cuda.launches == n + 1
    assert flash_fwd_cuda.launches_bf16 == n_bf16
    ref, _ = flash_fwd_plain(q.float(), k, v, causal=False)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, rtol=BF16_OUT_RTOL,
                               atol=1e-5)
    torch.sum(out.float() * torch.randn(out.shape, device="cuda")).backward()
    assert [x.grad.dtype for x in xs] == [torch.bfloat16, torch.float32,
                                          torch.float32]


def _hostile(n, n_valid, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    if n >= 256 and n_valid >= 256:
        x[128:256] = 0.0                       # an all-zero row
    x[n_valid:] = np.resize(np.array([np.nan, np.inf, -np.inf, 1e30],
                                     np.float32), n - n_valid)
    return torch.from_numpy(x).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("padded,n_valid", [(128, 128), (1280, 1000),
                                            (4096, 4096), (4096, 1)])
def test_quantize_kernels_bitwise(padded, n_valid):
    _need_card()
    x = _hostile(padded, n_valid, padded + n_valid)
    q, s = quantize_int8_cuda(x, n_valid)
    q2, s2 = quantize_int8_plain(x, n_valid)
    y = dequantize_int8_cuda(q, s, n_valid)
    y2 = dequantize_int8_plain(q, s, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(q, q2) and torch.equal(s, s2) and torch.equal(y, y2)
    for seed in (0, 12345, 2**32 - 1):
        a = stochastic_round_bf16_cuda(x, seed, n_valid)
        b = stochastic_round_bf16_plain(x, seed, n_valid)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-h0", "h0"])
@pytest.mark.parametrize("bsz,s,w", [(2, 64, 128), (1, 128, 256),
                                     (3, 33, 100), (1, 1, 4096)])
def test_rglru_kernels_bitwise(bsz, s, w, with_h0):
    _need_card()
    rng = np.random.default_rng(bsz * 1000 + s + w)
    mk = lambda *shape, lo=None: torch.from_numpy(
        (rng.uniform(lo, 0.95, shape) if lo is not None
         else rng.standard_normal(shape)).astype(np.float32)).cuda()
    b, a, dh = mk(bsz, s, w), mk(bsz, s, w, lo=0.1), mk(bsz, s, w)
    h0 = mk(bsz, w) if with_h0 else None
    h, hfin = rglru_fwd_cuda(b, a, h0)
    ref, ref_fin = rglru_scan_plain(b, a, h0)
    torch.cuda.synchronize()
    assert torch.equal(h, ref) and torch.equal(hfin, ref_fin)
    for dh_final in (None, mk(bsz, w)):
        got = rglru_bwd_cuda(a, h, h0, dh, dh_final)
        want = rglru_scan_bwd_plain(a, ref, h0, dh, dh_final)
        torch.cuda.synchronize()
        assert (got[2] is None) == (want[2] is None) == (not with_h0)
        for x, y in zip(got, want):
            assert x is None or torch.equal(x, y)
    # the autograd Function launches both kernels and matches the plain one
    grads = []
    for impl in ("cuda", "plain"):
        xs = [x.clone().requires_grad_(True) for x in (b, a)]
        rglru_fwd_cuda.launches = rglru_bwd_cuda.launches = 0
        out, _ = rglru_scan(*xs, h0, impl=impl)
        torch.sum(out * dh).backward()
        assert rglru_fwd_cuda.launches == rglru_bwd_cuda.launches == \
            (impl == "cuda")
        grads.append([x.grad for x in xs])
    for x, y in zip(*grads):
        assert torch.equal(x, y)


def _rel(x, y):
    return ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("with_s0,with_dsf", [(False, False), (True, False),
                                              (False, True), (True, True)])
@pytest.mark.parametrize("b,s,h,d", [(2, 64, 2, 32), (1, 96, 4, 64),
                                     (3, 40, 2, 64), (1, 32, 1, 64),
                                     (1, 1000, 3, 64), (1, 5, 2, 64),
                                     (1, 1, 2, 64), (3, 70, 5, 32),
                                     # 1, 7, 8, 9 and 33 chunks: at and
                                     # around the scans' 8-chunk look-ahead
                                     (1, 32, 2, 64), (1, 224, 2, 64),
                                     (1, 256, 2, 32), (1, 280, 2, 64),
                                     (2, 1056, 2, 64)])
def test_rwkv6_kernels_match_plain(b, s, h, d, with_s0, with_dsf):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(b * 1000 + s + h + d)
    mk = lambda *shape: torch.randn(shape, device="cuda", generator=g)
    r, k, v, do = (mk(b, s, h, d) for _ in range(4))
    w = torch.sigmoid(mk(b, s, h, d)) * 0.9 + 0.05
    u = mk(h, d)
    s0 = mk(b, h, d, d) if with_s0 else None
    dsf = mk(b, h, d, d) if with_dsf else None
    o, sf, states = rwkv6_fwd_cuda(r, k, v, w, u, s0, save_states=True)
    ro, rsf, rstates = _chunked_forward(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert _rel(o, ro) <= TOL
    # the state update sums ke^T v over t in order, as the plain product does
    assert torch.equal(sf, rsf) and torch.equal(states, rstates)
    o2, sf2, none = rwkv6_fwd_cuda(r, k, v, w, u, s0)   # states as scratch
    assert none is None and torch.equal(o2, o) and torch.equal(sf2, sf)
    got = rwkv6_bwd_cuda(r, k, v, w, u, states, do, dsf, need_ds0=with_s0)
    want = rwkv6_bwd_plain(r, k, v, w, u, s0, do, dsf, states=rstates)
    torch.cuda.synchronize()
    assert (got[5] is None) == (want[5] is None) == (not with_s0)
    for x, y in zip(got, want):
        assert x is None or _rel(x, y) <= TOL
    # ds0: dS summed over the chunks as the plain loop sums it, from the
    # same rd^T do products
    assert not with_s0 or torch.equal(got[5], want[5])
    # the autograd Function launches both kernels and matches the plain one
    grads = []
    for impl in ("cuda", "plain"):
        xs = [x.clone().requires_grad_(True) for x in (r, k, v, w, u)]
        rwkv6_fwd_cuda.launches = rwkv6_bwd_cuda.launches = 0
        out, _ = rwkv6_mix(*xs, s0, impl=impl)
        torch.sum(out * do).backward()
        assert rwkv6_fwd_cuda.launches == rwkv6_bwd_cuda.launches == \
            (impl == "cuda")
        grads.append([x.grad for x in xs])
    for x, y in zip(*grads):
        assert _rel(x, y) <= TOL
    with pytest.raises(ValueError):          # head sizes 32 and 64 only
        rwkv6_fwd_cuda(*(x[..., :16].contiguous() for x in (r, k, v, w, u)))


@pytest.mark.gpu
def test_chains_at_one_rank_are_the_identity():
    _need_card()
    init_distributed(torch.device("cuda"))
    x = torch.randn(1021, device="cuda")
    seen = []
    assert chain_all_reduce(x, (0,), record=seen.append) is x
    assert chain_reduce_scatter(x, (0,), record=seen.append) is x
    out = torch.empty_like(x)
    assert chain_all_gather(x, (0,), out=out, record=seen.append) is out
    assert torch.equal(out, x) and seen == []


@pytest.mark.gpu
@pytest.mark.parametrize("wires", ["f32", "int8"])
def test_streamed_gathers_bitwise_burst(wires):
    """Smoke qwen3-4b on the one-shard sharded engine over a period + 1:
    burst, streamed, and streamed with every synced bucket secondary and
    every gather on the one-rank chain, bitwise in losses and params."""
    _need_card()
    init_distributed(torch.device("cuda"))
    cfg = reduce_for_smoke(get_config("qwen3-4b"))
    meta = init_params(cfg, device="meta")
    bucket_of, nb, times, plan = build_schedule(
        meta, cfg, dp=1, seq_len=32, per_device_batch=2,
        partition_elems=250_000, coverage_rate=1.8)
    layout = build_bucket_layout(meta, bucket_of, nb)
    if wires == "int8":
        layout = layout.with_precision(PrecisionPolicy(("int8",) * nb))
    sched = plan.schedule
    routed = dataclasses.replace(sched, phases=tuple(
        dataclasses.replace(ph, secondary=(True,) * nb)
        for ph in sched.phases))
    ag = plan_ag_stream(routed, times)
    ag = dataclasses.replace(ag, items=tuple(
        dataclasses.replace(i, link=1) for i in ag.items))
    runs = []
    for kw in ({}, {"decoupled": True},
               {"decoupled": True, "secondary_chain": (0,), "ag_plan": ag}):
        rt = DeftRuntime(cfg, adamw(1e-3), routed if kw.get("ag_plan")
                         else sched, layout, device="cuda", fsdp=True, **kw)
        state = rt.init_state(seed=0)
        losses = []
        for i in range(sched.period + 1):
            state, m = rt.step(i, state, make_batch(cfg, 0, i, 2, 32,
                                                    device="cuda"))
            losses.append(float(m["loss"]))
            assert not rt.last_p2p
        runs.append((losses, [p.clone() for p in state["pbuf"]]))
    for losses, pbuf in runs[1:]:
        assert losses == runs[0][0]
        for a, b in zip(pbuf, runs[0][1]):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(tmp_path):
    """Smoke qwen3-4b on the sharded engine with int8 wires, a bf16sr
    master and bf16 compute (period 5, the gather reused at position 3):
    saved at step 3 and restored from the files, every tensor on the card
    and bitwise the saved state; resumed, bitwise the uninterrupted run."""
    _need_card()
    init_distributed(torch.device("cuda"))
    cfg = reduce_for_smoke(get_config("qwen3-4b"))
    kw = dict(batch=2, seq=32, device="cuda", partition_elems=250_000,
              coverage_rate=7.2, fsdp=True, wire_precision="int8",
              master_dtype="bf16sr", compute_dtype="bf16",
              log=lambda s: None)
    whole = train(cfg, steps=5, **kw)
    d = str(tmp_path)
    first = train(cfg, steps=3, ckpt=d, **kw)
    rt, saved = first["runtime"], first["state"]
    assert rt.phase_in_cycle(3) == 3 and rt.gather_skip
    tree = restore(d, 3, rt.checkpoint_struct())
    assert all(t.device.type == "cuda" for t in tree_leaves(tree))
    logs = []
    state, step = restore_runtime_state(rt, d, init_params(cfg, device="meta"),
                                        log=logs.append)
    assert step == 3 and logs == ["resumed checkpoint step 3"]
    assert set(state) == set(saved)
    for k in ("pbuf", "cur", "fut", "gbuf", "pgather"):
        for a, b in zip(state[k], saved[k]):
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a, b), k
    for k in ("m", "v", "step"):
        for a, b in zip(tree_leaves(state["opt"][k]),
                        tree_leaves(saved["opt"][k])):
            assert a.device.type == "cuda" and torch.equal(a, b), k
    assert state["pbuf"][0].dtype == torch.bfloat16
    rest = train(cfg, steps=2, ckpt=d, resume=True, **kw)
    assert rest["start_step"] == 3
    assert first["losses"] + rest["losses"] == whole["losses"]
    for a, b in zip(rest["state"]["pbuf"], whole["state"]["pbuf"]):
        assert torch.equal(a, b)


def _replay_swap(cfg, rt, sched_a, lay_a, swap_step, n_steps, batch, seq,
                 seed=0):
    """The explicit reference of a hot-swapped run of ``rt``: a sibling of
    schedule ``sched_a`` and layout ``lay_a`` to the swap step, then
    ``repack_state`` onto a sibling built for ``rt``'s installed schedule
    and layout, handing the accumulators over from ``sched_a`` as the
    staged swap does.  Returns (losses, param buffers)."""
    ref = rt.spawn(schedule=sched_a, layout=lay_a)
    state = ref.init_state(seed, dtype=rt.compute_dtype or torch.float32)
    losses = []
    for i in range(n_steps):
        if i == swap_step:
            ref = ref.spawn(schedule=rt.schedule, layout=rt.layout)
            state = ref.repack_state(
                state, build_layout_transition(lay_a, rt.layout),
                src_schedule=sched_a)
        state, m = ref.step(i - swap_step if i >= swap_step else i, state,
                            make_batch(cfg, seed, i, batch, seq,
                                       device="cuda"))
        losses.append(float(m["loss"]))
    return losses, state["pbuf"]


@pytest.mark.gpu
def test_background_swap_loads_its_kernels(monkeypatch):
    """An f32 run (no quantize kernel) stages a layout with a new partition
    and int8 wires on a background thread while it keeps stepping: the
    build loads the quantize library, the swap lands at a boundary, the
    int8 kernels run after it, and the run is bitwise its explicit
    reference."""
    from repro_torch.kernels import build

    _need_card()
    init_distributed(torch.device("cuda"))
    cfg = reduce_for_smoke(get_config("qwen3-4b"))
    meta = init_params(cfg, device="meta")
    plans = [build_schedule(meta, cfg, dp=1, seq_len=32, per_device_batch=2,
                            partition_elems=pe, coverage_rate=1.8)
             for pe in (250_000, 120_000)]
    (bo_a, nb_a, _, plan_a), (bo_b, nb_b, _, plan_b) = plans
    lay_a = build_bucket_layout(meta, bo_a, nb_a)
    lay_b = build_bucket_layout(meta, bo_b, nb_b).with_precision(
        PrecisionPolicy(("int8",) * nb_b))
    monkeypatch.setattr(build, "_LOADED", {
        k: v for k, v in build._LOADED.items() if k != "quantize"})
    rt = DeftRuntime(cfg, adamw(1e-3), plan_a.schedule, lay_a,
                     device="cuda")
    state = rt.init_state(seed=0)
    losses, i = [], 0

    def step():
        nonlocal state, i
        state, m = rt.step(i, state, make_batch(cfg, 0, i, 2, 32,
                                                device="cuda"))
        losses.append(float(m["loss"]))
        i += 1

    for _ in range(plan_a.schedule.period + 1):
        step()
    before = quantize_int8_cuda.launches
    rt.prepare_swap(plan_b.schedule, layout=lay_b,
                    background=True)
    while not rt.swap_ready():             # the build runs meanwhile
        assert i < 200 and not rt.swap_failures, rt.last_swap_error
        step()
    while rt.hot_swaps == 0:               # installed at the next boundary
        step()
    for _ in range(plan_b.schedule.period):
        step()
    assert rt.hot_swaps == 1 and rt.layout == lay_b
    assert "quantize" in build._LOADED
    assert quantize_int8_cuda.launches > before
    swap_step = rt.swap_log[-1]["step"]
    ref_losses, ref_pbuf = _replay_swap(cfg, rt, plan_a.schedule, lay_a,
                                        swap_step, i, 2, 32)
    assert losses == ref_losses
    for a, b in zip(state["pbuf"], ref_pbuf):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_adapt_loop_on_the_card():
    """The launcher's adaptive loop at smoke size: a 3x synthetic bandwidth
    drop at step 4 replans onto another partition, the runtime re-packs at
    a boundary and trains on, bitwise a run that switched layouts by
    hand."""
    _need_card()
    init_distributed(torch.device("cuda"))
    cfg = reduce_for_smoke(get_config("qwen3-4b"))
    res = train(cfg, steps=16, batch=2, seq=32, device="cuda", adapt=True,
                adapt_drop_step=4, adapt_repartition=True,
                log=lambda s: None)
    rt = res["runtime"]
    st = rt.stats()
    assert st["replans"] == 1 and st["hot_swaps"] == 1
    assert st["layout_swaps"] == 1 and rt.layout != res["layout"]
    swap_step = rt.swap_log[-1]["step"]
    assert swap_step % res["schedule"].period == 0
    ref_losses, ref_pbuf = _replay_swap(cfg, rt, res["schedule"],
                                        res["layout"], swap_step, 16, 2, 32)
    assert res["losses"] == ref_losses
    for a, b in zip(res["state"]["pbuf"], ref_pbuf):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sk,h,kvh,d", [
    (4, 1024, 16, 16, 64),      # seamless-m4t-large-v2's 1024 frames
    (2, 1601, 64, 8, 128),      # llama-3.2-vision-90b's 1601 patches
    (3, 17, 4, 1, 32),          # a smoke config's 16 + 1
])
def test_flash_kernel_at_one_query_matches_plain(b, sk, h, kvh, d):
    """A decode step's cross-attention: one query over the memory's keys,
    no mask."""
    _need_card()
    g = torch.Generator().manual_seed(11)
    q = torch.randn((b, 1, h, d), generator=g).cuda()
    k, v = (torch.randn((b, sk, kvh, d), generator=g).cuda() for _ in "kv")
    out, lse = flash_fwd_cuda(q, k, v, causal=False)
    ref, ref_lse = flash_fwd_plain(q, k, v, causal=False)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)


SERVE_CASES = [("qwen3-4b", 2), ("gemma2-2b", 2), ("deepseek-v2-236b", 2),
               ("rwkv6-1.6b", 2), ("recurrentgemma-9b", 2),
               ("seamless-m4t-large-v2", 2), ("llama-3.2-vision-90b", 5)]
SERVE_BOUND = 2e-4


def _served(cfg, params, tokens, memory, n_prefill, **impl):
    cache = init_cache(cfg, tokens.shape[0], tokens.shape[1], device="cuda",
                       prefill_chunk=n_prefill)
    got = [prefill(params, cfg, tokens[:, :n_prefill], cache, memory=memory,
                   capacity_factor=16.0, **impl)]
    for i in range(n_prefill, tokens.shape[1]):
        got.append(decode_step(params, cfg, tokens[:, i], cache, i,
                               capacity_factor=16.0, **impl))
    return torch.stack(got, dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,n_layers", SERVE_CASES)
def test_served_logits_match_the_forward_on_the_card(arch, n_layers):
    """B 2, prefill 16, 8 decode steps through the kernels: against the
    training forward and against the served run on the plain versions;
    the scan, the WKV and the flash launched once a layer and call (the
    encoder's layers once)."""
    _need_card()
    cfg = reduce_for_smoke(get_config(arch), n_layers)
    params = init_params(cfg, seed=3, device="cuda")
    for leaf_path, leaf in tree_flatten_with_path(params):
        if leaf_path[-1] == "gate":
            leaf.fill_(0.5)
    g = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=g,
                           device="cuda")
    memory = None
    if cfg.modality != "text":
        memory = torch.randn((2, max(cfg.n_modal_tokens, 1), cfg.d_model),
                             generator=g, device="cuda")
    counters = (flash_fwd_cuda, rglru_fwd_cuda, rwkv6_fwd_cuda)
    for c in counters:
        c.launches = 0
    got = _served(cfg, params, tokens, memory, 16)
    launches = [c.launches for c in counters]
    kinds = [sp.kind for sp in cfg.layer_specs()]
    assert launches == [kinds.count("cross_attn") * 9 + cfg.n_encoder_layers,
                        kinds.count("rglru") * 9, kinds.count("rwkv") * 9]
    plain = _served(cfg, params, tokens, memory, 16, attn_impl="plain",
                    scan_impl="plain")
    with torch.inference_mode():
        mem = encode(params, cfg, memory) if cfg.is_encoder_decoder else memory
        ref = forward(params, cfg, tokens, memory=mem, capacity_factor=16.0,
                      remat=False)[0][:, 15:]
    assert _rel(got, ref) < SERVE_BOUND
    assert _rel(got, plain) < SERVE_BOUND


@pytest.mark.gpu
def test_serve_launches_the_scan_each_step():
    """``serve`` on recurrentgemma-9b-smoke: one prefill and ``gen - 1``
    decode steps, each running the RG-LRU scan kernel once a layer."""
    _need_card()
    cfg = reduce_for_smoke(get_config("recurrentgemma-9b"))
    params = init_params(cfg, seed=5, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (3, 20), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(6))
    rglru_fwd_cuda.launches = 0
    out = serve(cfg, params, prompts, 6)
    n_rglru = [sp.kind for sp in cfg.layer_specs()].count("rglru")
    assert rglru_fwd_cuda.launches == n_rglru * 6
    assert out.tokens.shape == (3, 6) and out.tokens.is_cuda
    assert bool(torch.isfinite(out.logits).all())


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["per_leaf", "tree"])
def test_baseline_engines_on_the_card_match_their_cpu_runs(engine):
    """Smoke qwen3-4b over two periods on the per-leaf steps and on the
    tree-state engine, on the card and on the CPU from the same params and
    batches: the losses within 1e-4 relative, every param within 1e-4 (the
    card's flash is split-TF32, the CPU's plain); the card launching the
    f32 flash twice an attention layer and step and the bucket update
    never.  The CPU run syncs over a gloo group (NCCL takes card tensors
    only)."""
    from repro_torch.train.steps import init_train_state, make_deft_step_fns

    _need_card()
    init_distributed(torch.device("cuda"))
    groups = {"cpu": torch.distributed.new_group(backend="gloo"),
              "cuda": None}
    cfg = reduce_for_smoke(get_config("qwen3-4b"))
    meta = init_params(cfg, device="meta")
    bucket_of, nb, _, plan = build_schedule(
        meta, cfg, dp=1, seq_len=32, per_device_batch=2,
        partition_elems=250_000, coverage_rate=1.8)
    sched = plan.schedule
    layout = build_bucket_layout(meta, bucket_of, nb)
    params = init_params(cfg, seed=0, device="cpu")
    n = 2 * sched.period
    runs = {}
    for dev in ("cpu", "cuda"):
        if engine == "per_leaf":
            fns = make_deft_step_fns(cfg, adamw(1e-3), sched, bucket_of,
                                     group=groups[dev])
            state = init_train_state(cfg, adamw(1e-3), deft=True,
                                     params=params, device=dev)
        else:
            rt = DeftRuntime(cfg, adamw(1e-3), sched, layout, device=dev,
                             group=groups[dev], flat_state=False)
            state = rt.state_from_params(params)
        flash_fwd_cuda.launches = bucket_update_cuda.launches = 0
        losses = []
        for i in range(n):
            batch = make_batch(cfg, 0, i, 2, 32, device=dev)
            if engine == "per_leaf":
                state, m = fns[i % sched.period](state, batch)
            else:
                state, m = rt.step(i, state, batch)
            losses.append(float(m["loss"]))
        runs[dev] = (losses, [p.cpu() for p in tree_leaves(state["params"])],
                     flash_fwd_cuda.launches, bucket_update_cuda.launches)
    n_attn = sum(s.kind in ("attn", "local_attn") for s in cfg.layer_specs())
    assert runs["cuda"][2:] == (2 * n_attn * n, 0)
    assert runs["cpu"][2:] == (0, 0)
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=TOL)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)


@pytest.mark.gpu
def test_tp_functions_on_the_card_at_model_one():
    """At model 1 ``copy_in`` / ``reduce_out`` / ``gather`` hand back their
    input and its gradient, ``vocab_embed`` is the table's lookup, and
    ``vocab_parallel_nll`` is ``logsumexp - gold`` within 1e-6 with its
    gradient: no collective is issued."""
    _need_card()
    init_distributed(torch.device("cuda"))
    tp = ModelParallel(make_debug_mesh(
        data=torch.distributed.get_world_size(), model=1))
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 8), generator=g).cuda().requires_grad_()
    w = torch.randn((3, 5, 8), generator=g).cuda()
    for fn in (lambda t: copy_in(t, tp), lambda t: reduce_out(t, tp),
               lambda t: gather(t, tp, dim=-1)):
        x.grad = None
        y = fn(x)
        (y * w).sum().backward()
        assert torch.equal(y, x) and torch.equal(x.grad, w)
    table = torch.randn((64, 8), generator=g).cuda()
    tokens = torch.randint(0, 64, (2, 7), generator=g).cuda()
    assert torch.equal(vocab_embed(table, tokens, tp), table[tokens])
    logits = torch.randn((2, 7, 64), generator=g).cuda()
    a = logits.clone().requires_grad_()
    b = logits.clone().requires_grad_()
    got = vocab_parallel_nll(a, tokens, tp)
    want = torch.logsumexp(b, -1) - torch.gather(b, -1, tokens[..., None])[..., 0]
    cot = torch.randn((2, 7), generator=g).cuda()
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6)
    assert tp.calls == {}


@pytest.mark.gpu
def test_model_one_mesh_steps_are_bitwise_on_the_card():
    """gemma2-2b-smoke over two periods of the flat engine on the card,
    through a model-1 mesh and without one: every loss and param bitwise,
    the f32 flash and the bucket update launched alike."""
    _need_card()
    init_distributed(torch.device("cuda"))
    cfg = reduce_for_smoke(get_config("gemma2-2b"))
    meta = init_params(cfg, device="meta")
    bucket_of, nb, _, plan = build_schedule(
        meta, cfg, dp=1, seq_len=80, per_device_batch=2,
        partition_elems=120_000, coverage_rate=1.8)
    sched = plan.schedule
    layout = build_bucket_layout(meta, bucket_of, nb)
    runs = []
    for mesh in (None, make_debug_mesh(
            data=torch.distributed.get_world_size(), model=1)):
        rt = DeftRuntime(cfg, adamw(1e-3), sched, layout, device="cuda",
                         mesh=mesh, loss_chunk=16)
        state = rt.init_state(0)
        flash_fwd_cuda.launches = bucket_update_cuda.launches = 0
        losses = []
        for i in range(2 * sched.period):
            state, m = rt.step(i, state, make_batch(cfg, 0, i, 2, 80,
                                                    device="cuda"))
            losses.append(float(m["loss"]))
        runs.append((losses, [b.cpu() for b in state["pbuf"]],
                     flash_fwd_cuda.launches, bucket_update_cuda.launches))
    assert runs[0][0] == runs[1][0]
    assert runs[0][2:] == runs[1][2:] and min(runs[0][2:]) > 0
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
