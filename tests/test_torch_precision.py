"""The port's wire-precision kernels and the bf16 paths around them,
against the JAX package, on the same numpy inputs.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX package's ``ref`` twins and its Pallas
kernels in interpret mode.  The CUDA kernels themselves are held against
the plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py.

Tolerances:
* int8 quantize / dequantize, bf16 stochastic rounding, ``wire_seed``
  and ``apply_bucket_updates(master_dtype="bf16sr")``: bitwise (the same
  rounded operations and the same uint32 hash, in the same order).  The
  one exception is a NaN's payload after stochastic rounding: JAX's
  convert gives a canonical NaN, the port keeps the bits the mask leaves;
  both are NaN at the same places.
* flash attention on bf16 q/k/v against ``flash.py`` on bf16: outputs and
  gradients are bf16 values computed in f32 by both and rounded once, so
  they differ by at most a rounding step of bf16: rtol 2**-7 (one bf16
  ulp) with atol 1e-3 for values near zero on the forward, and rtol
  1.6e-2 (two ulps; the backward also reads the rounded forward output)
  with atol one bf16 ulp at the gradient's largest magnitude
  (max|g| / 128) on the gradients, where sums of many terms cancel.
  Readings (CPU): forward max |diff| 1.95e-3 at values up to 3.9;
  gradients max |diff| 7.8e-3 = 0.0028 of max|g| (softcap and window),
  so the atol keeps a 2.8x margin.  lse is f32 from identical inputs:
  2e-5, the f32 tolerance of tests/test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
from repro.configs import get_config, reduce_for_smoke
from repro.kernels.bucket_update import apply_bucket_updates as jax_apply
from repro.kernels.bucket_update import build_segments as jax_segments
from repro.kernels.bucket_update import init_flat_opt_state as jax_opt_state
from repro.kernels.flash_attention.flash import flash_global, flash_local
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.quantize import ops as jq
from repro.models.model import init_params as jax_init_params
from repro.optim.optimizers import adamw as jax_adamw
from repro.train.bucketing import assign_buckets as jax_assign
from repro.train.bucketing import build_bucket_layout as jax_layout
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.kernels.bucket_update import (
    apply_bucket_updates,
    build_segments,
    init_flat_opt_state,
)
from repro_torch.kernels.flash_attention import flash_attention, flash_fwd_plain
from repro_torch.kernels.quantize import (
    cast_compute,
    dequantize_int8,
    dequantize_int8_cuda,
    int8_scales,
    quantize_dequantize_int8,
    quantize_int8,
    quantize_int8_cuda,
    stochastic_round_bf16,
    stochastic_round_bf16_cuda,
    wire_seed,
)
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import build_bucket_layout

JAX_IMPLS = ("ref", "interpret")
_GOLDEN = 0x9E3779B9


def _hostile(n, n_valid, seed, scale=3.0):
    """f32[n] with NaN/inf garbage past ``n_valid`` and one all-zero row."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    if n >= 256 and n_valid >= 256:
        x[128:256] = 0.0
    tail = np.array([np.nan, np.inf, -np.inf, 1e30], np.float32)
    x[n_valid:] = np.resize(tail, n - n_valid)
    return x


def _bf16_bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _assert_bf16_equal(got, want):
    """Bitwise, except that any NaN equals any NaN (see the docstring)."""
    g, w = _bf16_bits(got), _bf16_bits(want)
    g_nan = (g & 0x7FFF) > 0x7F80
    w_nan = (w & 0x7FFF) > 0x7F80
    assert np.array_equal(g_nan, w_nan)
    assert np.array_equal(g[~g_nan], w[~w_nan])


# (padded, n_valid): one row, ragged, whole, one valid element, all tail
SIZES = [(128, 128), (1280, 1000), (4096, 4096), (4096, 1), (1280, 0)]


@pytest.mark.parametrize(
    "padded,n_valid,supplied",
    [(p, n, False) for p, n in SIZES] + [(p, n, True) for p, n in SIZES],
    ids=[f"{p}-{n}" for p, n in SIZES]
    + [f"{p}-{n}-supplied_scale" for p, n in SIZES])
def test_int8_quantize_dequantize_bitwise_vs_jax(padded, n_valid, supplied):
    """Bitwise JAX's ref and Pallas interpret.  ``supplied``: the scales
    given to ``quantize_int8`` (``scale=``, as ranks that agreed them pass
    them): JAX's own scales give JAX's grid bitwise, and scales of larger
    row maxima the rows rounded on those (numpy's ``rint`` of the
    quotient, clipped, the tail zero)."""
    x = _hostile(padded, n_valid, seed=padded + n_valid)
    tq, ts = quantize_int8(torch.from_numpy(x), n_valid)
    if supplied:
        own = ts.clone()
        tq, ts = quantize_int8(torch.from_numpy(x), n_valid, scale=own)
        assert ts is own
        rows = padded // 128
        big = int8_scales(torch.from_numpy(
            np.abs(_hostile(padded, padded, seed=7, scale=9.0))
            .reshape(rows, 128).max(axis=1)))
        gq, gs = quantize_int8(torch.from_numpy(x), n_valid, scale=big)
        xs = np.where(np.arange(padded) < n_valid, x, 0.0).reshape(rows, 128)
        with np.errstate(invalid="ignore"):
            want = np.clip(np.rint(xs / big.numpy()[:, None]), -127, 127)
        want = np.nan_to_num(want, nan=0.0).astype(np.int8).reshape(-1)
        assert gs is big and np.array_equal(gq.numpy(), want)
        with pytest.raises(ValueError):
            quantize_int8(torch.from_numpy(x), n_valid, scale=big[1:])
    td = dequantize_int8(tq, ts, n_valid)
    assert tq.dtype == torch.int8 and ts.shape == (padded // 128,)
    for impl in JAX_IMPLS:
        q, s = jq.quantize_int8(jnp.asarray(x), n_valid, impl=impl)
        assert np.array_equal(tq.numpy(), np.asarray(q)), impl
        assert np.array_equal(ts.numpy(), np.asarray(s)), impl
        d = jq.dequantize_int8(q, s, n_valid, impl=impl)
        assert np.array_equal(td.numpy(), np.asarray(d)), impl
    assert not td[n_valid:].any()
    # the wire edge writes the round trip back into the same buffer
    tx = torch.from_numpy(x.copy())
    ptr = tx.data_ptr()
    out = quantize_dequantize_int8(tx, n_valid, out=tx)
    assert out.data_ptr() == ptr and torch.equal(tx, td)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**32 - 1])
@pytest.mark.parametrize("padded,n_valid", SIZES[:4])
def test_stochastic_round_bitwise_vs_jax(padded, n_valid, seed):
    x = _hostile(padded, n_valid, seed=seed % 97)
    got = stochastic_round_bf16(torch.from_numpy(x), seed, n_valid)
    assert got.dtype == torch.bfloat16
    for impl in JAX_IMPLS:
        want = jq.stochastic_round_bf16(jnp.asarray(x), jnp.uint32(seed),
                                        n_valid, impl=impl)
        assert np.array_equal(_bf16_bits(got), _bf16_bits(want)), impl
    assert not _bf16_bits(got)[n_valid:].any()
    # out= writes the resident buffer in place
    buf = torch.empty(padded, dtype=torch.bfloat16)
    stochastic_round_bf16(torch.from_numpy(x), seed, n_valid, out=buf)
    assert torch.equal(buf.view(torch.int16), got.view(torch.int16))


def test_stochastic_round_hash_wraps_at_2_32():
    """``idx + seed * GOLDEN`` wraps past 2**32 inside the buffer: a seed
    whose spread lands 500 below the wrap."""
    inv = pow(_GOLDEN, -1, 2**32)
    for target in (2**32 - 500, 2**32 - 1):
        seed = (target * inv) % 2**32
        assert (seed * _GOLDEN) % 2**32 == target
        x = _hostile(1280, 1280, seed=3)
        got = stochastic_round_bf16(torch.from_numpy(x), seed)
        want = jq.stochastic_round_bf16(jnp.asarray(x), jnp.uint32(seed),
                                        impl="ref")
        assert np.array_equal(_bf16_bits(got), _bf16_bits(want))
        # the same seed as a device-style int64 tensor
        got_t = stochastic_round_bf16(torch.from_numpy(x),
                                      torch.tensor(seed, dtype=torch.int64))
        assert torch.equal(got_t.view(torch.int16), got.view(torch.int16))


def test_non_finite_valid_elements_match_jax():
    """NaN / inf inside the valid span: the int8 grid maps a NaN quotient
    to 0 (a NaN row's scale is 1, an inf row's is inf), bitwise as JAX;
    stochastic rounding agrees up to the NaN payload."""
    x = _hostile(512, 512, seed=9)
    x[[3, 200, 300]] = [np.nan, np.inf, -np.inf]
    tq, ts = quantize_int8(torch.from_numpy(x))
    q, s = jq.quantize_int8(jnp.asarray(x), impl="ref")
    assert np.array_equal(tq.numpy(), np.asarray(q))
    assert np.array_equal(ts.numpy(), np.asarray(s))
    got = stochastic_round_bf16(torch.from_numpy(x), 77)
    for impl in JAX_IMPLS:
        _assert_bf16_equal(got, jq.stochastic_round_bf16(
            jnp.asarray(x), jnp.uint32(77), impl=impl))


@pytest.mark.parametrize("step", [0, 1, 7, 2**31 - 1, 2**32 - 1])
def test_wire_seed_bitwise_vs_jax(step):
    for b in (0, 3, 1000):
        want = int(jq.wire_seed(step, b))
        assert int(wire_seed(step, b)) == want
        if step < 2**31:   # the on-device int32 step counter
            t = torch.tensor(step, dtype=torch.int32)
            assert int(wire_seed(t, b)) == int(jq.wire_seed(jnp.int32(step), b))


def test_dispatch_never_launches_on_cpu_tensors():
    x = torch.from_numpy(_hostile(256, 200, seed=1))
    before = (quantize_int8_cuda.launches, dequantize_int8_cuda.launches,
              stochastic_round_bf16_cuda.launches)
    q, s = quantize_int8(x, 200)
    dequantize_int8(q, s, 200)
    stochastic_round_bf16(x, 5, 200)
    assert (quantize_int8_cuda.launches, dequantize_int8_cuda.launches,
            stochastic_round_bf16_cuda.launches) == before
    for call in (lambda: quantize_int8(x, impl="cuda"),
                 lambda: quantize_int8_cuda(x),
                 lambda: dequantize_int8_cuda(q, s),
                 lambda: stochastic_round_bf16_cuda(x, 5)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError):
        quantize_int8(torch.zeros(100))          # not a 128-lane multiple
    y = torch.ones(4)
    assert cast_compute(y, None) is y and cast_compute(y, torch.float32) is y
    assert cast_compute(y, torch.bfloat16).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# apply_bucket_updates with a bf16sr master
# ---------------------------------------------------------------------------
def test_apply_bucket_updates_bf16sr_bitwise_vs_jax():
    cfg = reduce_for_smoke(get_config("qwen3-4b"))
    tcfg = t_reduce(t_get_config("qwen3-4b"))
    jparams = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), cfg))
    bucket_of, nb = jax_assign(jparams, cfg, 400_000)
    jl = jax_layout(jparams, bucket_of, nb)
    tl = build_bucket_layout(init_params(tcfg, device="meta"), bucket_of, nb)
    assert tl.buf_sizes == jl.buf_sizes and nb > 1
    rng = np.random.default_rng(4)

    def bufs(scale, zero_tail=True):
        out = []
        for n, size in zip(jl.buf_sizes, jl.sizes):
            a = (rng.standard_normal(n) * scale).astype(np.float32)
            if zero_tail:
                a[size:] = 0.0
            out.append(a)
        return out

    p32, g = bufs(0.05), bufs(1e-2)
    jspec, spec = jax_adamw(1e-3, weight_decay=0.01), adamw(1e-3, weight_decay=0.01)
    jpbuf = [jnp.asarray(p).astype(jnp.bfloat16) for p in p32]
    tpbuf = [torch.from_numpy(p).to(torch.bfloat16) for p in p32]
    for a, b in zip(tpbuf, jpbuf):
        assert np.array_equal(_bf16_bits(a), _bf16_bits(b))
    jopt = jax_opt_state(jspec, jl.buf_sizes)
    topt = init_flat_opt_state(spec, tl.buf_sizes, device="cpu")
    jseg, tseg = jax_segments(jl, jspec), build_segments(tl, spec)
    for step in range(2):           # two updates: the seed moves with the step
        grads = [gg * (step + 1) for gg in g]
        jpbuf, jopt, _ = jax_apply(
            jspec, jseg, jpbuf, [jnp.asarray(x) for x in grads], jopt,
            grad_scale=0.5, zero_grads=False, impl="ref",
            master_dtype="bf16sr")
        tg = [torch.from_numpy(x.copy()) for x in grads]
        ids = [p.data_ptr() for p in tpbuf]
        tpbuf, topt, _ = apply_bucket_updates(
            spec, tseg, tpbuf, tg, topt, grad_scale=0.5,
            master_dtype="bf16sr")
        assert [p.data_ptr() for p in tpbuf] == ids       # in place
        assert all(p.dtype == torch.bfloat16 for p in tpbuf)
        for b in range(nb):
            assert np.array_equal(_bf16_bits(tpbuf[b]), _bf16_bits(jpbuf[b])), b
            assert np.array_equal(topt["m"][b].numpy(), np.asarray(jopt["m"][b]))
            assert np.array_equal(topt["v"][b].numpy(), np.asarray(jopt["v"][b]))
    assert int(topt["step"]) == int(jopt["step"]) == 2


# ---------------------------------------------------------------------------
# flash attention on bf16 inputs
# ---------------------------------------------------------------------------
def _qkv_bf16(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    mk = lambda n: rng.standard_normal((b, s, n, d)).astype(np.float32)
    # round once to bf16 so both packages start from the same values
    return [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
            for a in (mk(h), mk(kvh), mk(kvh))]


def _t_bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("d,window,cap", [(32, 0, 0.0), (32, 40, 50.0),
                                          (256, 0, 50.0)])
def test_flash_bf16_forward_and_grads_match_jax_flash(d, window, cap):
    q, k, v = _qkv_bf16(11, 2, 96, 4, 2, d)
    w = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    if window:
        fn = lambda q_, k_, v_: flash_local(q_, k_, v_, window, cap, 0, 32)
    else:
        fn = lambda q_, k_, v_: flash_global(q_, k_, v_, True, cap, 0, 32)
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    out_j = fn(*jin)
    _, grads_j = jax.value_and_grad(
        lambda *a: jnp.sum(fn(*a).astype(jnp.float32) * w),
        argnums=(0, 1, 2))(*jin)
    tin = [_t_bf16(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*tin, causal=True, window=window, softcap=cap)
    assert out.dtype == torch.bfloat16 and out_j.dtype == jnp.bfloat16
    torch.sum(out.float() * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               rtol=2**-7, atol=1e-3)
    for got, want in zip((x.grad for x in tin), grads_j):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1.6e-2,
                                   atol=np.abs(want).max() / 128)


def test_flash_bf16_plain_forward_matches_pallas():
    q, k, v = _qkv_bf16(13, 2, 128, 4, 2, 256)
    want = flash_attention_pallas(
        *(jnp.asarray(a).astype(jnp.bfloat16).transpose(0, 2, 1, 3)
          for a in (q, k, v)),
        causal=True, window=48, softcap=50.0, block_q=32, block_kv=32,
        interpret=True).transpose(0, 2, 1, 3)
    got, lse = flash_fwd_plain(*(_t_bf16(a) for a in (q, k, v)), causal=True,
                               window=48, softcap=50.0, block_q=48)
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2**-7, atol=1e-3)
    # lse from the same bf16 values in f32 equals the f32 path's
    _, lse32 = flash_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, window=48, softcap=50.0)
    np.testing.assert_allclose(lse.numpy(), lse32.numpy(), rtol=2e-5, atol=2e-5)
