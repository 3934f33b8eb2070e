"""Port parity of the RG-LRU scan: ``repro_torch.kernels.rglru`` against the
JAX package's ``repro.kernels.rglru`` on the CPU.

Inputs come from a numpy seed, with the decay ``a`` in (0.1, 0.95), at the
shapes of the JAX package's own kernel test plus one whose width is not a
multiple of 32.  Tolerances:

* forward: rtol = atol = 1e-5 against ``ref.py``'s ``lax.scan``, the
  associative path and Pallas interpret.  Not bitwise: the plain scan
  rounds the multiply and the add of each step separately (as the CUDA
  kernel does, bitwise, on the card), while XLA on the CPU contracts
  ``a_t * h + b_t`` into one fused multiply-add, one rounding; the
  associative path associates the products differently again.
* gradients of the port's Function (through the plain reverse scan)
  against ``jax.vjp`` of ``ref.py`` and of the associative path: rtol =
  atol = 1e-5 (the Pallas kernel has no VJP).
* ``torch.autograd.gradcheck`` in float64 on the plain Function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
from repro.kernels.rglru import rglru_scan as jax_rglru_scan
from repro.kernels.rglru import rglru_scan_pallas, rglru_scan_reference
from repro_torch.kernels.rglru import (
    rglru_bwd_cuda,
    rglru_fwd_cuda,
    rglru_scan,
    rglru_scan_plain,
)
from repro_torch.kernels.rglru.ops import _RGLRUScan

TOL = 1e-5
SHAPES = [(2, 64, 128), (1, 128, 256), (3, 33, 128), (2, 40, 100)]


def _inputs(b, s, w, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        b=rng.standard_normal((b, s, w)).astype(np.float32),
        a=rng.uniform(0.1, 0.95, (b, s, w)).astype(np.float32),
        h0=rng.standard_normal((b, w)).astype(np.float32),
        dh=rng.standard_normal((b, s, w)).astype(np.float32),
        dh_final=rng.standard_normal((b, w)).astype(np.float32),
    )


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_jax(shape, with_h0):
    x = _inputs(*shape)
    h0 = x["h0"] if with_h0 else None
    h, hfin = rglru_scan_plain(_t(x["b"]), _t(x["a"]), _t(h0))
    assert h.dtype == hfin.dtype == torch.float32
    jh0 = None if h0 is None else jnp.asarray(h0)
    for want in (rglru_scan_reference(x["b"], x["a"], jh0),
                 jax_rglru_scan(x["b"], x["a"], jh0, impl="associative"),
                 rglru_scan_pallas(x["b"], x["a"], jh0, interpret=True)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want[0]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(hfin.numpy(), np.asarray(want[1]),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("with_h0,with_dh_final", [
    (False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("shape", SHAPES)
def test_grads_match_jax_vjp(shape, with_h0, with_dh_final):
    """db, da (and dh0) of the port's Function against jax.vjp of ref.py's
    lax.scan and of the associative scan, with and without a cotangent on
    the final state."""
    x = _inputs(*shape, seed=1)
    h0 = x["h0"] if with_h0 else None
    dh_final = x["dh_final"] if with_dh_final else np.zeros_like(x["h0"])
    bt, at = _t(x["b"]).requires_grad_(True), _t(x["a"]).requires_grad_(True)
    h0t = _t(h0).requires_grad_(True) if with_h0 else None
    h, hfin = rglru_scan(bt, at, h0t)
    obj = torch.sum(h * _t(x["dh"]))
    if with_dh_final:
        obj = obj + torch.sum(hfin * _t(dh_final))
    obj.backward()
    got = [bt.grad, at.grad] + ([h0t.grad] if with_h0 else [])

    args = (x["b"], x["a"]) + ((h0,) if with_h0 else ())
    for fn in (rglru_scan_reference,
               lambda *a: jax_rglru_scan(*a, impl="associative")):
        _, vjp = jax.vjp(fn, *args)
        want = vjp((jnp.asarray(x["dh"]), jnp.asarray(dh_final)))
        assert len(want) == len(got)
        for g, w, name in zip(got, want, ("db", "da", "dh0")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL, err_msg=name)


@pytest.mark.parametrize("with_h0", [False, True])
def test_gradcheck_float64(with_h0):
    rng = np.random.default_rng(3)
    b = torch.from_numpy(rng.standard_normal((2, 7, 5))).requires_grad_(True)
    a = torch.from_numpy(rng.uniform(0.1, 0.95, (2, 7, 5))).requires_grad_(True)
    h0 = (torch.from_numpy(rng.standard_normal((2, 5))).requires_grad_(True)
          if with_h0 else None)
    args = (b, a) + ((h0,) if with_h0 else ())
    fn = lambda b, a, h0=None: _RGLRUScan.apply(b, a, h0, "plain")
    assert torch.autograd.gradcheck(fn, args)
    # only h used: the Function takes a None cotangent for h_final
    assert torch.autograd.gradcheck(lambda *xs: fn(*xs)[0], args)


def test_dispatch_never_launches_on_cpu_tensors():
    x = _inputs(1, 9, 4)
    rglru_fwd_cuda.launches = rglru_bwd_cuda.launches = 0
    b = _t(x["b"]).requires_grad_(True)
    h, _ = rglru_scan(b, _t(x["a"]))
    h.sum().backward()
    assert rglru_fwd_cuda.launches == rglru_bwd_cuda.launches == 0
    # bf16 inputs are cast to f32, as the JAX dispatcher does
    hb, fb = rglru_scan(_t(x["b"]).bfloat16(), _t(x["a"]).bfloat16())
    assert hb.dtype == fb.dtype == torch.float32
    with pytest.raises(ValueError):
        rglru_scan(_t(x["b"]), _t(x["a"]), impl="cuda")
    with pytest.raises(ValueError):
        rglru_fwd_cuda(_t(x["b"]), _t(x["a"]))
    with pytest.raises(ValueError):
        rglru_scan(_t(x["b"]), _t(x["a"]), impl="associative")
