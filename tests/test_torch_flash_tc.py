"""The arithmetic of the bf16 tensor-core flash forward
(``kernels/flash_attention/csrc/flash_fwd_sm90.cu``), emulated on the CPU.

The kernel runs only on the card; this file holds its rounding against
``flash_fwd_plain`` under the checks the card applies to the kernel (out
within rtol 2**-7, atol 1e-5; lse within 1e-4), and against the JAX
package's ``flash.py`` on the same bf16 inputs.  The emulation:

* S = Q.K^T from the bf16 values, accumulated in f32 (bf16 x bf16 products
  are exact), scaled by 1/sqrt(D) after the product; softcap c*tanh(s/c);
* online softmax over blocks of BK keys (64 at D = 256, else 128), the
  running max starting at -1e30, masked scores -inf;
* P split into hi = bf16(p) and lo = bf16(p - hi), O += hi.V + lo.V in f32;
* out = O / max(l, 1e-30) rounded to bf16, lse = m + log(max(l, 1e-30)).

One case shows that a single bf16 P (the textbook tensor-core design)
fails the same check, which is why the kernel splits P.  The same
emulation holds at ``chip_smoke.py``'s MLA cases (d_qk 192 over d_v 128,
40 or 48 heads each with its own K and V), and the text cuts of
``scripts/flash_sm90_layouts.py`` are held to the shipped source, as is
the wrapper's choice to read a bf16 q and k at their own head dim.
"""
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
from repro.kernels.flash_attention.flash import flash_global, flash_local
from repro_torch.kernels.flash_attention import flash_fwd_plain
from repro_torch.kernels.flash_attention.ops import bf16_reads_unpadded

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import FLASH_BF16_CASES  # noqa: E402

BF16_OUT_RTOL = 2 ** -7
LSE_TOL = 1e-4
NEG = -1e30


def emulate(q, k, v, *, causal, window, softcap, split=True):
    """The kernel's rounding, vectorised over every query row."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    bk = 64 if d == 256 else 128
    g = h // kvh
    qf = q.float().reshape(b, sq, kvh, g, d)
    kf, vf = k.float(), v.float()
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    m = torch.full((b, kvh, g, sq), NEG)
    l = torch.zeros((b, kvh, g, sq))
    dv = v.shape[-1]
    acc = torch.zeros((b, kvh, g, sq, dv))
    qp = torch.arange(sq)[:, None]
    for k0 in range(0, sk, bk):
        k1 = min(k0 + bk, sk)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, k0:k1]) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
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
        hi = p.bfloat16().float()
        parts = (hi, (p - hi).bfloat16().float()) if split else (hi,)
        acc = acc * alpha[..., None]
        for part in parts:
            acc = acc + torch.einsum("bhgqk,bkhd->bhgqd", part, vf[:, k0:k1])
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)
    return out.bfloat16(), (m + torch.log(l)).reshape(b, h, sq)


def _qkv(seed, b, s, h, kvh, d, dv=None):
    rng = np.random.default_rng(seed)
    mk = lambda n, w: torch.from_numpy(
        rng.standard_normal((b, s, n, w)).astype(np.float32)).bfloat16()
    return mk(h, d), mk(kvh, d), mk(kvh, dv or d)


def _misses(out, lse, ref, ref_lse):
    """Elements outside the card's bf16 checks (out, lse)."""
    o, r = out.float(), ref.float()
    bad_o = ((o - r).abs() > 1e-5 + BF16_OUT_RTOL * r.abs()).sum().item()
    bad_l = ((lse - ref_lse).abs() > LSE_TOL + LSE_TOL * ref_lse.abs()).sum()
    return bad_o, bad_l.item()


# chip_smoke.py's bf16 flash cases and its MQA 16:1 case, at small S
CASES = [
    (2, 333, 8, 4, 256, True, 100, 50.0),    # ragged S, window, softcap
    (1, 520, 8, 4, 256, True, 0, 50.0),      # gemma2 global layer
    (2, 200, 8, 2, 128, True, 0, 0.0),       # qwen3 head dim, GQA 4:1
    (2, 130, 4, 4, 128, False, 0, 0.0),      # bidirectional, ragged
    (1, 300, 16, 1, 256, True, 64, 0.0),     # recurrentgemma MQA 16:1
]


@pytest.mark.parametrize("b,s,h,kvh,d,causal,window,cap", CASES)
def test_split_p_emulation_passes_the_card_checks(b, s, h, kvh, d, causal,
                                                  window, cap):
    q, k, v = _qkv(s + d, b, s, h, kvh, d)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = emulate(q, k, v, **kw)
    ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
    assert _misses(out, lse, ref, ref_lse) == (0, 0)


@pytest.mark.parametrize("window,cap", [(0, 50.0), (48, 0.0)])
def test_split_p_emulation_matches_jax_flash(window, cap):
    q, k, v = _qkv(11, 1, 160, 4, 2, 256)
    out, _ = emulate(q, k, v, causal=True, window=window, softcap=cap)
    qj, kj, vj = (jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
                  for x in (q, k, v))
    if window:
        want = flash_local(qj, kj, vj, window, cap, 0, 32)
    else:
        want = flash_global(qj, kj, vj, True, cap, 0, 32)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    torch.testing.assert_close(out.float(), want, rtol=BF16_OUT_RTOL,
                               atol=1e-5)


def test_single_bf16_p_fails_the_card_check():
    b, s, h, kvh, d, causal, window, cap = CASES[1]
    q, k, v = _qkv(s + d, b, s, h, kvh, d)
    kw = dict(causal=causal, window=window, softcap=cap)
    ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
    out, lse = emulate(q, k, v, split=False, **kw)
    bad_out, _ = _misses(out, lse, ref, ref_lse)
    assert bad_out > 0


@pytest.mark.parametrize(
    "b,s,h,kvh,d,causal,window,cap,dv",
    [c for c in FLASH_BF16_CASES if len(c) > 8])
def test_split_p_emulation_at_mla_dims(b, s, h, kvh, d, causal, window, cap,
                                       dv):
    q, k, v = _qkv(s + d + h, b, s, h, kvh, d, dv)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = emulate(q, k, v, **kw)
    ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
    assert out.shape == ref.shape == (b, s, h, dv)
    assert _misses(out, lse, ref, ref_lse) == (0, 0)


def test_bf16_reads_q_and_k_at_their_own_head_dim():
    """48 bf16 columns are 96 bytes, whole 16-byte rows: TMA reads them
    as they are; 36 (72 bytes) and f32 tensors are zero-padded."""
    q, k, _ = _qkv(5, 2, 16, 4, 4, 48)
    assert bf16_reads_unpadded(q, k)
    wide = torch.cat([q, q[..., :4]], -1)[..., :48]       # head stride 52
    assert not bf16_reads_unpadded(wide, k)
    assert bf16_reads_unpadded(wide.contiguous(), k)
    assert not bf16_reads_unpadded(q[..., :36], k[..., :36].contiguous())
    assert not bf16_reads_unpadded(q.float(), k.float())


_rev_spec = importlib.util.spec_from_file_location(
    "flash_sm90_layouts", ROOT / "scripts/flash_sm90_layouts.py")
revisions = importlib.util.module_from_spec(_rev_spec)
_rev_spec.loader.exec_module(revisions)


@pytest.mark.parametrize("name", sorted(revisions.CUTS))
def test_sm90_revision_cuts_apply_to_the_shipped_source(name):
    """Every text edit of ``scripts/flash_sm90_layouts.py --cut`` finds its
    place in the shipped ``flash_fwd_sm90.cu`` as often as it expects."""
    shipped = revisions.SHIPPED.read_text()
    assert revisions.cut(shipped, name) != shipped


def test_kv_hbm_bytes_at_mla():
    """MLA's [1, 4096, 128] causal at (192, 128): 5.54 GB of K/V when every
    query block of 128 reads its visible keys, 0.34 GB once a head."""
    unshared, shared = revisions.kv_hbm_bytes(1, 4096, 128, 128, 192, 128, 0)
    assert unshared == 528 * 128 * 128 * 640
    assert shared == 128 * 4096 * 640
