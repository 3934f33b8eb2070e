"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  This
file imports neither JAX nor the JAX package, so it runs on a machine
with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: flash attention 1e-4 absolute and relative on out, lse and
the autograd gradients (f32 with another summation order than cuBLAS's
matmuls in the plain version); the bucket update bitwise (its kernel
rounds every operation separately, as the plain version's elementwise
kernels do).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bucket_update import (
    bucket_update_cuda,
    bucket_update_ref,
    pack_scalars,
)
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_fwd_cuda,
    flash_fwd_plain,
)
from repro_torch.optim.optimizers import adamw, sgd_momentum

TOL = 1e-4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc there)")


def _qkv(seed, b, s, h, kvh, d):
    g = torch.Generator().manual_seed(seed)
    mk = lambda n: torch.randn((b, s, n, d), generator=g).cuda()
    return mk(h), mk(kvh), mk(kvh)


@pytest.mark.gpu
@pytest.mark.parametrize("d,h,kvh,s,causal,window,cap", [
    (32, 4, 2, 128, True, 0, 0.0),
    (64, 4, 4, 100, False, 0, 0.0),
    (128, 8, 2, 200, True, 0, 0.0),
    (256, 8, 4, 333, True, 100, 50.0),
    (256, 2, 1, 64, False, 0, 0.0),
])
def test_flash_kernel_matches_plain(d, h, kvh, s, causal, window, cap):
    _need_card()
    q, k, v = _qkv(5, 2, s, h, kvh, d)
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
