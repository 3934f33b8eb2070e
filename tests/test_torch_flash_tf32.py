"""The arithmetic of the f32 split-TF32 tensor-core flash forward
(``kernels/flash_attention/csrc/flash_fwd.cu``), emulated on the CPU.

The kernel runs only on the card; this file holds its rounding against
``flash_fwd_plain`` under the check the card applies to the kernel (out and
lse within 1e-4, absolute and relative), and against the JAX package's
``flash.py`` on the same f32 inputs.  The emulation:

* q scaled by sm_scale = f32(1/sqrt(D)); q, k, v split into
  hi = tf32_rna(x) and lo = tf32_rna(x - hi) (``ops.tf32_round``);
* per block of 64 keys S = Qh.Kh + (Qh.Kl + Ql.Kh), each product in f32;
  softcap c * tanh(s * f32(1/c)); masked scores -inf;
* online softmax, the running max starting at -1e30; P = exp(S - m)
  split into hi + lo; O = O * alpha + Ph.Vh + Ph.Vl + Pl.Vh;
* out = O / max(l, 1e-30), lse = m + log(max(l, 1e-30)).

The same at MLA's d_qk != d_v: 192 / 128, and the smoke config's 48 / 32
as the kernel runs it, zero-padded to 64 / 32 with the scale of the
unpadded 48, then sliced.  One case shows that a single TF32 product (no
lo terms) fails the same check, which is why the kernel splits.  The split pass's plain version
(``flash_split_plain``, held bitwise against the kernel on the card) is
checked here against the layout the kernel reads, written out index by
index.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash import flash_global, flash_local
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_fwd_plain
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import (
    SPLIT_BK,
    SPLIT_KEY_ORDER,
    flash_split_plain,
    split_shape,
    tf32_round,
)

# the card's check and its cases come from chip_smoke.py (which imports only
# the standard library at module level), so the two cannot drift apart
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
FLASH_TOL = chip_smoke.FLASH_TOL
CASES = chip_smoke.FLASH_CASES
NEG = -1e30


def _split(x, split):
    hi = tf32_round(x)
    return (hi, tf32_round(x - hi)) if split else (hi,)


def _products(a, b, eq, split):
    """a.b as the kernel forms it: hi.hi + (hi.lo + lo.hi), or hi.hi."""
    if not split:
        return torch.einsum(eq, a[0], b[0])
    return torch.einsum(eq, a[0], b[0]) + (torch.einsum(eq, a[0], b[1])
                                           + torch.einsum(eq, a[1], b[0]))


def emulate(q, k, v, *, causal, window, softcap, split=True, scale_d=None):
    """The kernel's rounding, vectorised over every query row; q is scaled
    by 1/sqrt(``scale_d``) (default: q's head dim)."""
    b, sq, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kvh
    scale = torch.tensor(1.0 / np.sqrt(scale_d or d), dtype=torch.float32)
    qs = _split(q.float().reshape(b, sq, kvh, g, d) * scale, split)
    inv_cap = torch.tensor(1.0 / softcap if softcap else 0.0,
                           dtype=torch.float32)
    m = torch.full((b, kvh, g, sq), NEG)
    l = torch.zeros((b, kvh, g, sq))
    acc = torch.zeros((b, kvh, g, sq, dv))
    qp = torch.arange(sq)[:, None]
    for k0 in range(0, sk, SPLIT_BK):
        k1 = min(k0 + SPLIT_BK, sk)
        ks = _split(k[:, k0:k1].float(), split)
        vs = _split(v[:, k0:k1].float(), split)
        s = _products(qs, ks, "bqhgd,bkhd->bhgqk", split)
        if softcap:
            s = softcap * torch.tanh(s * inv_cap)
        kp = torch.arange(k0, k1)[None, :]
        ok = torch.ones((sq, k1 - k0), dtype=torch.bool)
        if causal:
            ok &= kp <= qp
        if window:
            ok &= kp > qp - window
        s = torch.where(ok, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _products(
            _split(p, split), vs, "bhgqk,bkhd->bhgqd", split)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)
    return out, (m + torch.log(l)).reshape(b, h, sq)


def _qkv(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    mk = lambda n: torch.from_numpy(
        rng.standard_normal((b, s, n, d)).astype(np.float32))
    return mk(h), mk(kvh), mk(kvh)


def _agrees(out, lse, ref, ref_lse):
    return (torch.allclose(out, ref, rtol=FLASH_TOL, atol=FLASH_TOL)
            and torch.allclose(lse, ref_lse, rtol=FLASH_TOL, atol=FLASH_TOL))


@pytest.mark.parametrize("b,s,h,kvh,d,causal,window,cap", CASES)
def test_split_tf32_emulation_passes_the_card_check(b, s, h, kvh, d, causal,
                                                    window, cap):
    q, k, v = _qkv(s + d, b, s, h, kvh, d)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = emulate(q, k, v, **kw)
    ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
    assert _agrees(out, lse, ref, ref_lse)


@pytest.mark.parametrize("window,cap", [(0, 50.0), (48, 0.0)])
def test_split_tf32_emulation_matches_jax_flash(window, cap):
    q, k, v = _qkv(12, 1, 160, 4, 2, 256)
    out, _ = emulate(q, k, v, causal=True, window=window, softcap=cap)
    qj, kj, vj = (jnp.asarray(x.numpy()) for x in (q, k, v))
    if window:
        want = flash_local(qj, kj, vj, window, cap, 0, 32)
    else:
        want = flash_global(qj, kj, vj, True, cap, 0, 32)
    torch.testing.assert_close(out, torch.from_numpy(np.array(want)),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


# MLA: (d_qk, d_v, heads, kv heads, seq, causal)
@pytest.mark.parametrize("d,dv,h,kvh,s,causal", [
    (192, 128, 4, 4, 200, True),
    (48, 32, 4, 4, 150, True),
    (48, 32, 4, 2, 90, False),
])
def test_split_tf32_emulation_at_mla_dims(d, dv, h, kvh, s, causal):
    """The kernel at d_v != d_qk, at the dims it runs (``kernel_dims``: 48 /
    32 zero-padded to 64 / 32, scaled by the unpadded 48), against the
    plain version and JAX's ``flash_global`` under the card's check."""
    rng = np.random.default_rng(d + dv + s)
    mk = lambda n, w: torch.from_numpy(
        rng.standard_normal((1, s, n, w)).astype(np.float32))
    q, k, v = mk(h, d), mk(kvh, d), mk(kvh, dv)
    dq, dvk = ops.kernel_dims(d, dv)
    pad = lambda x, n: torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    out, lse = emulate(pad(q, dq), pad(k, dq), pad(v, dvk), causal=causal,
                       window=0, softcap=0.0, scale_d=d)
    out = out[..., :dv]
    ref, ref_lse = flash_fwd_plain(q, k, v, causal=causal)
    assert _agrees(out, lse, ref, ref_lse)
    want = flash_global(*(jnp.asarray(x.numpy()) for x in (q, k, v)), causal,
                        0.0, 0, 32)
    torch.testing.assert_close(out, torch.from_numpy(np.array(want)),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


def test_single_tf32_fails_the_card_check():
    b, s, h, kvh, d, causal, window, cap = CASES[1]
    q, k, v = _qkv(s + d, b, s, h, kvh, d)
    kw = dict(causal=causal, window=window, softcap=cap)
    ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
    out, lse = emulate(q, k, v, split=False, **kw)
    assert not _agrees(out, lse, ref, ref_lse)


def test_tf32_round_is_cvt_rna():
    """Ten mantissa bits, to nearest, ties away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp,
                      1 + ulp / 2 - 2 ** -23, 3.0, 0.0, -2.5e-30])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1 + 2 * ulp, 1.0, 3.0, 0.0,
                         tf32_round(torch.tensor([-2.5e-30])).item()])
    assert torch.equal(tf32_round(x), want)


@pytest.mark.parametrize("d,dv,sk", [
    pytest.param(32, 32, 100, id="32-100"),
    pytest.param(64, 64, 64, id="64-64"),
    pytest.param(128, 128, 1, id="128-1"),
    pytest.param(256, 256, 130, id="256-130"),
    pytest.param(192, 128, 70, id="192-128-70"),
    pytest.param(64, 32, 100, id="64-32-100"),
])
def test_split_pass_plain_version(d, dv, sk):
    """hi and lo have 13 zero low bits, hi + lo is within 2^-22 of x, and
    the kernel's stage layout, read back index by index, gives K and V:
    K's d // dc stages, then V's dv // dc, dc = min(d, dv, 64)."""
    b, kvh = 2, 3
    _, k, _ = _qkv(d + sk, b, sk, kvh, kvh, d)
    v = _qkv(dv + sk + 1, b, sk, kvh, kvh, dv)[1]
    split = flash_split_plain(k, v)
    assert tuple(split.shape) == split_shape(b, kvh, sk, d, dv)
    bits = split.view(torch.int32)
    assert not (bits & 0x1FFF).any()

    dc = min(d, dv, 64)
    nkb = split.shape[1]
    stages = split                 # [B * KVH, key blocks, stages, (hi, lo), ...]

    def swizzled(row, e):                          # a 32-column chunk's swizzle
        return row * 32 + ((e // 4) ^ (row % 8)) * 4 + e % 4

    for x, first in ((k, 0), (v, d // dc)):
        w = x.shape[-1]
        key = np.arange(nkb * SPLIT_BK)[:, None]   # [keys, 1]
        col = np.arange(w)[None, :]                # [1, width]
        blk, kp = key // SPLIT_BK, key % SPLIT_BK
        stage, c = first + col // dc, col % dc
        if first == 0:
            # K: stage = d-columns [stage dc, ..), chunk c // 32, row = key
            pos = (c // 32) * SPLIT_BK * 32 + swizzled(kp, c % 32)
        else:
            # V: stage = d-rows, row = c; key kp at position 8 (kp // 8) + slot
            slot = np.argsort(SPLIT_KEY_ORDER)[kp % 8]
            lp = 8 * (kp // 8) + slot
            pos = (lp // 32) * dc * 32 + swizzled(c, lp % 32)
        grid = lambda a: torch.from_numpy(
            np.broadcast_to(a, (nkb * SPLIT_BK, w)).copy())
        idx, blk_i, st_i = grid(pos), grid(blk), grid(stage)
        hi = stages[:, blk_i, st_i, 0, idx]        # [B * KVH, keys, width]
        lo = stages[:, blk_i, st_i, 1, idx]
        xs = x.permute(0, 2, 1, 3).reshape(b * kvh, sk, w)
        assert not hi[:, sk:].any() and not lo[:, sk:].any()
        hi, lo = hi[:, :sk], lo[:, :sk]
        assert torch.equal(hi, tf32_round(xs))
        assert torch.equal(lo, tf32_round(xs - hi))
        assert ((hi + lo - xs).abs() <= 2.0 ** -22 * xs.abs()).all()


@pytest.mark.parametrize("entry,argtypes", [
    ("flash_fwd", ops.F32_ARGTYPES),
    ("flash_fwd_sm90", ops.BF16_ARGTYPES),
])
def test_wrapper_argtypes_match_c_signature(entry, argtypes):
    """The ctypes binding passes as many arguments, of the same kinds, as
    the kernel source's ``extern "C"`` entry point takes: a scratch
    argument added to one side only fails here, not on the card."""
    src, _ = build.SOURCES[entry]
    lib, fn = ops._ENTRY[torch.float32 if entry == "flash_fwd"
                         else torch.bfloat16]
    assert lib == entry
    params = build.c_params((build._PKG / src).read_text(), fn)
    assert [t for t, _ in params] == list(argtypes), [n for _, n in params]


_LOG = """ptxas info    : (C7519) warpgroup.arrive is injected in around line 25 by compiler to allow use of registers in GMMA in function '_ZN45_GLOBAL__N__2eede63c_12_flash_fwd_cu_1ad8dec021flash_fwd_tf32_kernelILi256EEEvPKfS2_Pf'
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__2eede63c_12_flash_fwd_cu_1ad8dec021flash_fwd_tf32_kernelILi256EEEvPKfS2_Pf' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__2eede63c_12_flash_fwd_cu_1ad8dec021flash_fwd_tf32_kernelILi256EEEvPKfS2_Pf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 2 barriers
ptxas info    : Compiling entry function '_Z20bucket_update_kernelPfS_' for 'sm_90a'
ptxas info    : Used 40 registers, used 1 barriers
"""


def test_ptxas_report_names_each_kernel():
    """Register, spill and advisory lines come out under the kernel's own
    name and head dim, an advisory under the function it names."""
    assert build.ptxas_report(_LOG) == [
        "flash_fwd_tf32_kernel<256>: ptxas info    : (C7519) warpgroup.arrive"
        " is injected in around line 25 by compiler to allow use of "
        "registers in GMMA",
        "flash_fwd_tf32_kernel<256>: 0 bytes stack frame, 0 bytes spill "
        "stores, 0 bytes spill loads",
        "flash_fwd_tf32_kernel<256>: Used 254 registers, used 2 barriers",
        "bucket_update_kernel: Used 40 registers, used 1 barriers",
    ]
    assert build.ptxas_report(_LOG, "bucket") == [
        "bucket_update_kernel: Used 40 registers, used 1 barriers"]


_rev_spec = importlib.util.spec_from_file_location(
    "flash_f32_revisions",
    Path(__file__).resolve().parents[1] / "scripts/flash_f32_revisions.py")
revisions = importlib.util.module_from_spec(_rev_spec)
_rev_spec.loader.exec_module(revisions)


@pytest.mark.parametrize("name", sorted(revisions.CUTS))
def test_revision_cuts_apply_to_the_shipped_source(name):
    """Every text edit of ``scripts/flash_f32_revisions.py --cuts`` finds
    its place in the shipped ``flash_fwd.cu`` as often as it expects."""
    shipped = revisions.SHIPPED.read_text()
    assert revisions.cut(shipped, name) != shipped
