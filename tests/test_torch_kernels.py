"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the Pallas kernel (interpret mode) and the JAX
blockwise/reference twins, on the same numpy inputs.  The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_gpu.py (skipped without a card) and by chip_smoke.py.

Tolerances:
* flash attention, f32: 2e-5 absolute/relative on outputs, lse and
  gradients — the plain version sums in another order than XLA
  (blockwise over the visible span vs the Pallas/flash chunk scans).
* bucket update and its scalars row: bitwise against the JAX package's
  ``bucket_update_ref`` / ``pack_scalars`` (same rounded operations in
  the same order).  Against the Pallas kernel in interpret mode: 1e-6,
  the bound the JAX package itself sets between Pallas and its ref (XLA
  contracts some multiply-adds there; tests/test_bucket_update.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
from repro.kernels.bucket_update import bucket_update_pallas, bucket_update_ref
from repro.kernels.bucket_update import pack_scalars as jax_pack_scalars
from repro.kernels.flash_attention.flash import (
    _global_fwd_impl,
    flash_global,
    flash_local,
)
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.optim.optimizers import adamw as jax_adamw
from repro.optim.optimizers import sgd_momentum as jax_sgd
from repro_torch.kernels.bucket_update import (
    bucket_update,
    bucket_update_cuda,
    pack_scalars,
)
from repro_torch.kernels.bucket_update import bucket_update_ref as t_ref
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_fwd_cuda,
    flash_fwd_plain,
)
from repro_torch.optim.optimizers import adamw, sgd_momentum

FTOL = 2e-5
KTOL = 1e-6


def _qkv(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    mk = lambda n: rng.standard_normal((b, s, n, d)).astype(np.float32)
    return mk(h), mk(kvh), mk(kvh)


# (D, H, KV, S, causal, window, softcap): GQA everywhere; gemma2's head
# dim 256 and softcap 50; a window shorter than S so blocks are skipped
FLASH_CASES = [
    (32, 4, 2, 128, True, 0, 0.0),
    (32, 4, 2, 128, True, 48, 50.0),
    (256, 4, 2, 128, True, 48, 50.0),
    (256, 2, 1, 64, False, 0, 0.0),
]


@pytest.mark.parametrize("d,h,kvh,s,causal,window,cap", FLASH_CASES)
def test_flash_plain_forward_matches_pallas(d, h, kvh, s, causal, window, cap):
    q, k, v = _qkv(0, 2, s, h, kvh, d)
    want = flash_attention_pallas(
        jnp.asarray(q).transpose(0, 2, 1, 3), jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3), causal=causal, window=window,
        softcap=cap, block_q=32, block_kv=32, interpret=True,
    ).transpose(0, 2, 1, 3)
    got, _ = flash_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal, window=window,
                             softcap=cap, block_q=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FTOL, atol=FTOL)


@pytest.mark.parametrize("d,window,cap", [(32, 0, 0.0), (32, 0, 50.0),
                                          (32, 40, 50.0), (256, 40, 50.0)])
def test_flash_forward_and_grads_match_jax_flash(d, window, cap):
    """Forward, lse and (dq, dk, dv) against jax.value_and_grad of the
    JAX package's blockwise twins (flash_global / flash_local)."""
    q, k, v = _qkv(1, 2, 96, 4, 2, d)
    w = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    if window:
        fn = lambda q_, k_, v_: flash_local(q_, k_, v_, window, cap, 0, 32)
    else:
        fn = lambda q_, k_, v_: flash_global(q_, k_, v_, True, cap, 0, 32)
    out_j, grads_j = jax.value_and_grad(
        lambda *a: jnp.sum(fn(*a) * w), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True, window=window, softcap=cap)
    loss = torch.sum(out * torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(out_j), rtol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FTOL, atol=FTOL)
    if not window:
        _, lse_j = _global_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), True, cap, 0, 32)
        _, lse = flash_fwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                 causal=True, softcap=cap)
        np.testing.assert_allclose(lse.numpy(),
                                   np.asarray(lse_j).reshape(lse.shape),
                                   rtol=FTOL, atol=FTOL)


def test_flash_dispatch_never_launches_on_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 16, 2, 1, 32))
    before = flash_fwd_cuda.launches
    flash_attention(q, k, v)
    assert flash_fwd_cuda.launches == before
    with pytest.raises(ValueError):
        flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError):
        flash_fwd_cuda(q, k, v)


# ---------------------------------------------------------------------------
# bucket update — the case grid of tests/test_bucket_update.py
# ---------------------------------------------------------------------------
SPECS = [
    (adamw(1e-2, weight_decay=0.01), jax_adamw(1e-2, weight_decay=0.01)),
    (sgd_momentum(3e-2, momentum=0.85, weight_decay=0.02),
     jax_sgd(3e-2, momentum=0.85, weight_decay=0.02)),
]


def _bucket_inputs(padded, n_valid, seed=7):
    rng = np.random.default_rng(seed)

    def mk(i):
        x = rng.standard_normal(padded).astype(np.float32)
        x[n_valid:] = 0.0
        return x
    p, m, v, g = mk(0), mk(1), np.abs(mk(2)), mk(3)
    sc = rng.uniform(0.5, 1.0, padded).astype(np.float32)
    wd = rng.uniform(0.0, 0.1, padded).astype(np.float32)
    sc[n_valid:] = 0.0
    wd[n_valid:] = 0.0
    return p, m, v, g, sc, wd


@pytest.mark.parametrize("elem", [False, True], ids=["uniform", "per-element"])
@pytest.mark.parametrize("padded,n_valid", [(640, 533), (128, 128), (256, 1)])
@pytest.mark.parametrize("specs", SPECS, ids=["adamw", "sgd"])
def test_bucket_update_plain_matches_jax(specs, padded, n_valid, elem):
    spec, jspec = specs
    adam = spec.name == "adamw"
    p, m, v, g, sc, wd = _bucket_inputs(padded, n_valid)
    scal = jax_pack_scalars(jspec, jnp.int32(3), grad_scale=0.5,
                            clip=jnp.float32(0.9))
    kw = dict(n_valid=n_valid, zero_grads=True)
    if elem:
        kw.update(uniform=None, elem_hparams=(jnp.asarray(sc), jnp.asarray(wd)))
    else:
        kw.update(uniform=(1.0, spec.weight_decay))
    args = (jnp.asarray(p), jnp.asarray(m), jnp.asarray(v) if adam else None,
            jnp.asarray(g), scal)
    want_ref = bucket_update_ref(jspec, *args, **kw)
    want_pal = bucket_update_pallas(jspec, *args, interpret=True, **kw)

    t = {n: torch.from_numpy(x.copy()) for n, x in
         dict(p=p, m=m, v=v, g=g, sc=sc, wd=wd).items()}
    tscal = torch.from_numpy(np.asarray(scal))
    tkw = dict(n_valid=n_valid)
    if elem:
        tkw.update(uniform=None, elem_hparams=(t["sc"], t["wd"]))
    else:
        tkw.update(uniform=(1.0, spec.weight_decay))
    got = t_ref(spec, t["p"], t["m"], t["v"] if adam else None, t["g"], tscal,
                zero_grads=True, **tkw)
    for name, a, r, pl in zip("pmv", got, want_ref, want_pal):
        if a is None:
            continue
        a = a.numpy()
        assert np.array_equal(a, np.asarray(r)), name
        np.testing.assert_allclose(a, np.asarray(pl), rtol=KTOL, atol=KTOL,
                                   err_msg=name)
    assert not got[3].any()

    # the in-place dispatcher writes the plain result back on the CPU
    before = bucket_update_cuda.launches
    bucket_update(spec, t["p"], t["m"], t["v"] if adam else None, t["g"],
                  tscal, zero_grads=True, **tkw)
    assert bucket_update_cuda.launches == before
    assert torch.equal(t["p"], got[0]) and torch.equal(t["m"], got[1])
    assert not t["g"].any()


@pytest.mark.parametrize("specs", SPECS, ids=["adamw", "sgd"])
@pytest.mark.parametrize("step", [1, 2, 7, 1000])
def test_pack_scalars_matches_jax(specs, step):
    spec, jspec = specs
    got = pack_scalars(spec, torch.tensor(step, dtype=torch.int32),
                       grad_scale=1.0 / 3, clip=torch.tensor(0.7))
    want = np.asarray(jax_pack_scalars(jspec, jnp.int32(step),
                                       grad_scale=1.0 / 3,
                                       clip=jnp.float32(0.7)))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_library_loads_build_once_across_threads(tmp_path, monkeypatch):
    """Two threads asking for libraries at once (a background swap build
    and the training loop): one build runs, both get the one library."""
    import threading
    import time

    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    builds = []

    def fake_compile(jobs):
        builds.append(sorted(jobs))
        time.sleep(0.2)             # both threads are waiting by now
        for out, _ in jobs.values():
            out.write_bytes(b"")
        return {k: ("", 0.0) for k in jobs}

    monkeypatch.setattr(build, "_compile", fake_compile)
    start = threading.Barrier(2)
    got = {}

    def load(name):
        start.wait(timeout=10)
        got[name] = build.library(name)

    threads = [threading.Thread(target=load, args=(n,))
               for n in ("quantize", "bucket_update")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert builds == [sorted(build.SOURCES)]
    assert got == {n: ("lib", str(build._target(n)[0]))
                   for n in ("quantize", "bucket_update")}
    assert build.library("quantize") is got["quantize"]
