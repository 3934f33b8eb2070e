"""Port parity of the RWKV-6 WKV: ``repro_torch.kernels.rwkv6`` against the
JAX package's ``repro.kernels.rwkv6`` on the CPU.

Inputs come from a numpy seed, with the decay by the JAX package's own law
(``sigmoid(N) * 0.9 + 0.05``, as ``tests/test_kernels.py`` draws it), at
the JAX kernel test's shapes plus a ragged length (40, against T = 32) and
one of five chunks.  Tolerances, the JAX package's own 1e-4:

* forward: the token loop and the chunked pair within rtol = atol = 1e-4 of
  ``ref.py``, of the JAX dispatcher's chunked path and of the Pallas kernel
  in interpret mode (chunks of 16 and 32; it takes whole chunks only).  Not
  bitwise: the chunked form factors the decays through ``e^{lw_exc}`` and
  ``e^{-lw_inc}`` and sums in another order than the token loop, and XLA
  and ATen order their reductions differently.
* gradients of the port's Function (through the plain chunked backward)
  for r, k, v, w, u and s0, with and without a cotangent on S_final,
  against ``jax.vjp`` of ``_chunked_jnp`` and of ``ref.py``: max |diff| /
  max |JAX| <= 1e-4 per gradient (a gradient's elements span orders of
  magnitude, so the bound is on the largest).
* the plain backward against torch autograd through the plain forward, and
  ``torch.autograd.gradcheck`` in float64.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6 import rwkv6_mix as jax_rwkv6_mix
from repro.kernels.rwkv6 import rwkv6_pallas, rwkv6_reference
from repro.kernels.rwkv6.ops import _chunked_jnp
from repro_torch.kernels import build
from repro_torch.kernels.rwkv6 import (
    rwkv6_bwd_cuda,
    rwkv6_bwd_plain,
    rwkv6_chunked_plain,
    rwkv6_fwd_cuda,
    rwkv6_mix,
    rwkv6_reference_plain,
)
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ops import _RWKV6

TOL = 1e-4
SHAPES = [(2, 32, 2, 16), (1, 64, 4, 32), (2, 40, 2, 64), (1, 160, 2, 64)]
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _inputs(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    w = 1.0 / (1.0 + np.exp(-n(b, s, h, d))) * 0.9 + 0.05
    return dict(r=n(b, s, h, d), k=n(b, s, h, d), v=n(b, s, h, d),
                w=w.astype(np.float32), u=n(h, d), s0=n(b, h, d, d),
                do=n(b, s, h, d), dsf=n(b, h, d, d))


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _close_rel(got, want, name):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
    assert err <= TOL, f"{name}: max |diff| / max |want| = {err:.3g}"


def _flat(t, b, s, h, d):
    return jnp.asarray(t).transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_jax(shape, with_s0):
    b, s, h, d = shape
    x = _inputs(*shape)
    s0 = x["s0"] if with_s0 else None
    args = [x[n] for n in "rkvwu"]
    wants = [rwkv6_reference(*args, s0),
             jax_rwkv6_mix(*args, s0, impl="chunked")]
    s0f = (jnp.zeros((b * h, d, d)) if s0 is None
           else jnp.asarray(s0).reshape(b * h, d, d))
    uf = jnp.broadcast_to(jnp.asarray(x["u"])[None], (b, h, d)).reshape(b * h, d)
    for chunk in (16, 32):
        if s % chunk:
            continue                  # the Pallas kernel takes whole chunks
        o, sf = rwkv6_pallas(*(_flat(x[n], *shape) for n in "rkvw"), uf, s0f,
                             chunk=chunk, interpret=True)
        wants.append((np.asarray(o).reshape(b, h, s, d).transpose(0, 2, 1, 3),
                      np.asarray(sf).reshape(b, h, d, d)))
    for fn in (rwkv6_reference_plain, rwkv6_chunked_plain):
        o, sf = fn(*(_t(a) for a in args), _t(s0))
        assert o.shape == (b, s, h, d) and sf.shape == (b, h, d, d)
        for want_o, want_sf in wants:
            np.testing.assert_allclose(o.numpy(), np.asarray(want_o),
                                       rtol=TOL, atol=TOL)
            np.testing.assert_allclose(sf.numpy(), np.asarray(want_sf),
                                       rtol=TOL, atol=TOL)
    # the dispatcher's chunked pair is rwkv6_chunked_plain
    o, sf = rwkv6_mix(*(_t(a) for a in args), _t(s0), impl="chunked")
    np.testing.assert_allclose(o.numpy(), np.asarray(wants[1][0]), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("with_s0,with_dsf", [
    (False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("shape", SHAPES)
def test_grads_match_jax_vjp(shape, with_s0, with_dsf):
    """dr, dk, dv, dw, du (and ds0) of the port's Function against jax.vjp
    of _chunked_jnp and of ref.py, with and without a cotangent on the
    final state."""
    x = _inputs(*shape, seed=1)
    names = list("rkvwu") + (["s0"] if with_s0 else [])
    leaves = [_t(x[n]).requires_grad_(True) for n in names]
    s0t = leaves[5] if with_s0 else None
    o, sf = _RWKV6.apply(*leaves[:5], s0t, "chunked")
    obj = torch.sum(o * _t(x["do"]))
    if with_dsf:
        obj = obj + torch.sum(sf * _t(x["dsf"]))
    obj.backward()
    dsf = x["dsf"] if with_dsf else np.zeros_like(x["s0"])
    for fn in (lambda *a: _chunked_jnp(*a[:5], a[5] if with_s0 else None),
               lambda *a: rwkv6_reference(*a[:5], a[5] if with_s0 else None)):
        _, vjp = jax.vjp(fn, *(x[n] for n in names))
        want = vjp((jnp.asarray(x["do"]), jnp.asarray(dsf)))
        assert len(want) == len(leaves)
        for leaf, w, name in zip(leaves, want, NAMES):
            _close_rel(leaf.grad.numpy(), w, name)


@pytest.mark.parametrize("shape", [(2, 40, 2, 64), (1, 96, 3, 32)])
def test_bwd_plain_matches_torch_autograd(shape):
    """The explicit chunked reverse pass equals autograd through the plain
    chunked forward."""
    x = _inputs(*shape, seed=2)
    leaves = [_t(x[n]).requires_grad_(True) for n in ("r", "k", "v", "w",
                                                      "u", "s0")]
    o, sf = rwkv6_chunked_plain(*leaves)
    (torch.sum(o * _t(x["do"])) + torch.sum(sf * _t(x["dsf"]))).backward()
    got = rwkv6_bwd_plain(*(_t(x[n]) for n in ("r", "k", "v", "w", "u",
                                               "s0", "do", "dsf")))
    for g, leaf, name in zip(got, leaves, NAMES):
        _close_rel(g.numpy(), leaf.grad.numpy(), name)


@pytest.mark.parametrize("with_s0", [False, True])
def test_gradcheck_float64(with_s0):
    """The plain Function in float64 over two chunks, the second ragged."""
    rng = np.random.default_rng(3)
    b, s, h, d = 1, 35, 1, 2
    n = lambda *shape: torch.from_numpy(rng.standard_normal(shape))
    w = torch.sigmoid(n(b, s, h, d)) * 0.9 + 0.05
    args = [n(b, s, h, d), n(b, s, h, d), n(b, s, h, d), w, n(h, d)]
    if with_s0:
        args.append(n(b, h, d, d))
    args = [a.requires_grad_(True) for a in args]
    fn = lambda *a: _RWKV6.apply(*a[:5], a[5] if with_s0 else None, "chunked")
    assert torch.autograd.gradcheck(fn, args)
    # only o used: the Function takes a None cotangent for S_final
    assert torch.autograd.gradcheck(lambda *a: fn(*a)[0], args)


def test_dispatch_never_launches_on_cpu_tensors():
    x = _inputs(1, 130, 2, 16)
    rwkv6_fwd_cuda.launches = rwkv6_bwd_cuda.launches = 0
    args = [_t(x[n]) for n in "rkvwu"]
    r = args[0].clone().requires_grad_(True)
    for s in (40, 130):                # the token loop, then the chunked pair
        o, _ = rwkv6_mix(r[:, :s], *(a[:, :s] for a in args[1:4]), args[4])
        o.sum().backward()
    assert rwkv6_fwd_cuda.launches == rwkv6_bwd_cuda.launches == 0
    ref = rwkv6_mix(*args, impl="ref")[0]
    np.testing.assert_allclose(rwkv6_mix(*args)[0].numpy(), ref.numpy(),
                               rtol=TOL, atol=TOL)
    # bf16 inputs are computed in f32, as the JAX package does
    ob, sb = rwkv6_mix(*(a.bfloat16() for a in args), impl="plain")
    assert ob.dtype == sb.dtype == torch.float32
    with pytest.raises(ValueError):
        rwkv6_mix(*args, impl="cuda")
    with pytest.raises(ValueError):
        rwkv6_fwd_cuda(*args)
    with pytest.raises(ValueError):
        rwkv6_mix(*args, impl="pallas")


@pytest.mark.parametrize("entry,argtypes", [
    ("rwkv6_fwd_f32", ops.FWD_ARGTYPES), ("rwkv6_bwd_f32", ops.BWD_ARGTYPES)])
def test_wrapper_argtypes_match_c_signature(entry, argtypes):
    """The ctypes binding passes as many arguments, of the same kinds, as
    the kernel source's ``extern "C"`` entry point takes (a pointer is
    ``c_void_p``, ``long long`` is ``c_longlong``): a scratch argument
    added to one side only fails here, not on the card."""
    src, _ = build.SOURCES["rwkv6"]
    text = (build._PKG / src).read_text()
    params = build.c_params(text, entry)
    assert [t for t, _ in params] == list(argtypes), [n for _, n in params]


_stages_spec = importlib.util.spec_from_file_location(
    "rwkv6_stages",
    Path(__file__).resolve().parents[1] / "scripts/rwkv6_stages.py")
rwkv6_stages = importlib.util.module_from_spec(_stages_spec)
_stages_spec.loader.exec_module(rwkv6_stages)


@pytest.mark.parametrize("stage", ["decays", "A", "grads"])
def test_bwd_stage_cuts_apply_to_the_shipped_source(stage):
    """Each stage of the gradient pass that ``scripts/rwkv6_stages.py
    --bwd`` cuts is marked in the shipped ``rwkv6.cu`` and closed by a
    barrier: the cut removes lines of ``rwkv6_bwd_chunk_kernel`` only and
    keeps every barrier."""
    _, kernel, stages, _ = rwkv6_stages.DIRECTIONS["bwd"]
    shipped = rwkv6_stages.SHIPPED.read_text()
    cut = rwkv6_stages.cut_stages(shipped, kernel, stages, [stage])
    start = shipped.index(f"{kernel}(")
    end = shipped.index("\n}\n", start)
    assert cut != shipped
    assert cut[:start] == shipped[:start]
    assert cut.endswith(shipped[end:])
    assert cut.count("__syncthreads();") == shipped.count("__syncthreads();")
