"""Port parity of DeepSeek-V2's Multi-head Latent Attention (train path)
and of the attention it runs at d_v != d_qk, against the JAX package.

* ``flash_fwd_plain`` / ``flash_bwd_plain`` at d_qk / d_v 48 / 32 (the
  smoke config's) and 192 / 128 (the published one), causal: out and
  (q, k, v) gradients against JAX's ``flash_global`` (its
  forward and custom backward) and ``attention_reference``, within 1e-5
  (f32 on the CPU, other summation orders).
* ``apply_mla`` on deepseek-v2-236b-smoke's dims against JAX's: output
  and the gradients of x and of every param leaf, rtol 1e-4 / atol 1e-5;
  with a latent cache, the absorbed path (a 40-token prefill at position
  0, then one token at 40): out and the cache, within the same limits.
* ``DeftRuntime`` on deepseek-v2-236b-smoke (the dense layer 0 at d_ff
  512, then an MLA + MoE layer) over two periods of a delayed-update
  schedule against JAX's ``DeftRuntime`` on the same numpy params and
  batches: losses within rtol 1e-4, every param within 1e-4
  (tests/test_torch_runtime.py's limit).
* ``loss_fn`` and every gradient leaf of deepseek-v2-236b-smoke against
  ``jax.value_and_grad`` of JAX's (rtol 1e-4, atol 1e-5).
* The launcher at smoke size on the CPU: ``--arch deepseek-v2-236b
  --smoke`` trains on the sharded engine (``needs_fsdp``) and logs the aux
  loss, also on the precision path (a bf16sr master, and bf16 compute
  with int8 wires): finite losses, a bf16 master where it is bf16sr, and
  seamless-m4t-large-v2-smoke the same.
* ``kernel_dims``: the instantiated (d_qk, d_v) pair a call runs at.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.kernels.flash_attention import attention_reference
from repro.kernels.flash_attention.flash import flash_global
from repro.launch.train import build_schedule as jax_build_schedule
from repro.models import attention as jattn
from repro.optim.optimizers import adamw as jax_adamw
from repro.train import runtime as jrt
from repro.train.bucketing import build_bucket_layout as jax_layout
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_bwd_plain,
    flash_fwd_plain,
)
from repro_torch.kernels.flash_attention.ops import kernel_dims
from repro_torch.launch.train import build_schedule, init_distributed, train
from repro_torch.models import attention as tattn
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import build_bucket_layout
from repro_torch.train.runtime import DeftRuntime
from repro_torch.tree import tree_flatten_with_path, tree_leaves

from _torch_tiny import loss_and_grads_match_jax, smoke_params

RTOL, ATOL = 1e-4, 1e-5
FLASH_ATOL = 1e-5
PARAM_ATOL = 1e-4
ARCH = "deepseek-v2-236b"
B, S, PART, LR = 2, 32, 300_000, 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


# (d_qk, d_v, heads, kv heads, seq, causal)
@pytest.mark.parametrize("d,dv,h,kvh,s,causal", [
    pytest.param(48, 32, 4, 4, 96, True, id="smoke-48-32"),
    pytest.param(192, 128, 2, 2, 80, True, id="published-192-128"),
])
def test_flash_plain_at_dv_ne_dqk_matches_jax(d, dv, h, kvh, s, causal):
    rng = np.random.default_rng(d + s)
    mk = lambda n, w: rng.standard_normal((1, s, n, w)).astype(np.float32)
    q, k, v, dout = mk(h, d), mk(kvh, d), mk(kvh, dv), mk(h, dv)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_fwd_plain(tq, tk, tv, causal=causal, block_q=32)
    dq, dk, dv_ = flash_bwd_plain(tq, tk, tv, out, lse, torch.from_numpy(dout),
                                  causal=causal, block_q=32)
    assert out.shape == (1, s, h, dv) and dv_.shape == v.shape

    @jax.jit
    def jax_run(a, b_, c, g):
        outs = []
        for fn in (lambda *x: flash_global(*x, causal, 0.0, 0, 32),
                   lambda *x: attention_reference(*x, causal=causal)):
            o, vjp = jax.vjp(fn, a, b_, c)
            outs.append((o, vjp(g)))
        return outs

    for jout, jgrads in jax_run(*(jnp.asarray(x) for x in (q, k, v, dout))):
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                                   atol=FLASH_ATOL)
        for got, want in zip((dq, dk, dv_), jgrads):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=FLASH_ATOL)


def test_kernel_dims():
    assert kernel_dims(192, 128) == (192, 128)
    assert kernel_dims(48, 32) == (64, 32)
    assert kernel_dims(128, 128) == (128, 128)
    assert kernel_dims(100, 100) == (128, 128)
    with pytest.raises(ValueError, match="no flash instantiation"):
        kernel_dims(320, 128)


def test_apply_mla_matches_jax():
    cfg = reduce_for_smoke(get_config(ARCH))
    tcfg = t_reduce(t_get_config(ARCH))
    m = tcfg.mla
    assert (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) == (48, 32)
    jp = jax.jit(lambda k: jattn.init_mla(k, cfg))(jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def jax_run(p, xx, ww):
        out, vjp = jax.vjp(lambda p_, x_: jattn.apply_mla(p_, x_, cfg=cfg)[0],
                           p, xx)
        return out, vjp(ww)

    jy, (jgp, jgx) = jax_run(jp, jnp.asarray(x), jnp.asarray(w))
    params = params_from_numpy(_np(jp), device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tattn.apply_mla(params, tx, cfg=tcfg)
    torch.sum(y * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL)
    got = tree_flatten_with_path(params)
    want = jax.tree.leaves(jgp)
    assert len(got) == len(want) == 8
    for (path, p), g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=ATOL, err_msg="/".join(path))
    jc = jattn.make_mla_cache(cfg, 2, 48)
    tc = tattn.make_mla_cache(tcfg, 2, 48, device="cpu")
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    with torch.inference_mode():
        for xx, pos in ((x, 0), (x1, 40)):
            jy, jc = jattn.apply_mla(jp, jnp.asarray(xx), cfg=cfg, pos=pos,
                                     cache=jc)
            y = tattn.apply_mla(params, torch.from_numpy(xx), cfg=tcfg,
                                pos=pos, cache=tc)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                                       atol=ATOL)
            for name in ("ckv", "krope"):
                np.testing.assert_allclose(tc[name].numpy(),
                                           np.asarray(jc[name]), rtol=RTOL,
                                           atol=ATOL)


@pytest.fixture(scope="module")
def jax_params():
    """deepseek-v2-236b-smoke's params (``_torch_tiny.smoke_params``) as a
    JAX tree."""
    return jax.tree.map(jnp.asarray, smoke_params(ARCH))


def test_loss_and_grads_match_jax(jax_params):
    """deepseek-v2-236b-smoke (dense layer 0, then MLA + MoE): loss and
    every gradient leaf (``_torch_tiny.loss_and_grads_match_jax``)."""
    loss_and_grads_match_jax(ARCH, 64, 0, jax_params)


def test_mla_runtime_matches_jax_over_two_periods(group, single_mesh,
                                                  jax_params, monkeypatch):
    cfg = reduce_for_smoke(get_config(ARCH))
    tcfg = t_reduce(t_get_config(ARCH))
    jparams = jax_params
    jb, jnb, _, jplan = jax_build_schedule(
        jparams, cfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=1.8)
    meta = init_params(tcfg, device="meta")
    tb, tnb, _, tplan = build_schedule(
        meta, tcfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=1.8)
    assert (tb, tnb) == (jb, jnb)
    sched = tplan.schedule
    assert max(sched.batch_size_sequence) > 1        # merged updates
    n_steps = 2 * sched.period
    batches = [make_batch(tcfg, 0, i, B, S, device="cpu")
               for i in range(n_steps)]

    # init_state starts from the fixture's params, not a draw of its own
    monkeypatch.setattr(jrt, "init_params", lambda *a, **kw: jax_params)
    with single_mesh:
        jr = jrt.DeftRuntime(cfg, jax_adamw(LR), jplan.schedule,
                             jax_layout(jparams, jb, jnb), single_mesh)
        jstate = jr.init_state(jax.random.PRNGKey(0))
        jlosses = []
        for i, bt in enumerate(batches):
            jstate, m = jr.step(i, jstate, {
                k: jnp.asarray(v.numpy().astype(np.int32))
                for k, v in bt.items()})
            jlosses.append(float(m["loss"]))
        jfinal = [np.asarray(b) for b in jstate["pbuf"]]

    rt = DeftRuntime(tcfg, adamw(LR), sched, build_bucket_layout(meta, tb, tnb),
                     device="cpu")
    state = rt.state_from_params(params_from_numpy(smoke_params(ARCH),
                                                   device="cpu"))
    losses = []
    for i, bt in enumerate(batches):
        state, m = rt.step(i, state, bt)
        losses.append(float(m["loss"]))
        assert float(m["aux"]) > 0
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    # every param, bucket by bucket of the one layout both engines use
    assert len(state["pbuf"]) == len(jfinal) == tnb
    for a, b in zip(state["pbuf"], jfinal):
        np.testing.assert_allclose(a.numpy(), b, atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_launcher_smoke_and_bf16_refusal(group, arch):
    """The launcher trains the MLA config on the f32 path and on the
    precision path, which it refused before the bf16 flash took d_v !=
    d_qk; an encoder-decoder's precision path likewise (the test keeps its
    name from the refusal it replaced)."""
    cfg = t_reduce(t_get_config(arch))
    lines = []
    if arch == ARCH:
        res = train(cfg, steps=3, batch=2, seq=32, device="cpu",
                    partition_elems=PART, log=lines.append)
        assert all(np.isfinite(res["losses"]))
        assert res["runtime"].stats()["sharded_state"]       # needs_fsdp
        assert any("aux=" in ln for ln in lines)
    for prec in (dict(master_dtype="bf16sr"),
                 dict(compute_dtype="bf16", wire_precision="int8")):
        res = train(cfg, steps=2, batch=2, seq=32, device="cpu",
                    partition_elems=PART, log=lines.append, **prec)
        assert all(np.isfinite(res["losses"]))
        st = res["runtime"].stats()
        assert st["sharded_state"] == (arch == ARCH)
        master = torch.bfloat16 if "master_dtype" in prec else torch.float32
        assert all(p.dtype == master for p in res["state"]["pbuf"])
        if "compute_dtype" in prec:
            assert st["compute_dtype"] == "bfloat16"
            assert set(res["layout"].precision.wire) == {"int8"}


def test_mla_flash_autograd_takes_dv():
    """``flash_attention`` on CPU tensors at d_v != d_qk: out [.., DV] and
    gradients of the inputs' shapes."""
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn((1, 20, 2, 48), generator=g, requires_grad=True)
            for _ in range(2))
    v = torch.randn((1, 20, 2, 32), generator=g, requires_grad=True)
    out = flash_attention(q, k, v, causal=True)
    out.sum().backward()
    assert out.shape == (1, 20, 2, 32)
    assert (q.grad.shape, k.grad.shape, v.grad.shape) == \
        (q.shape, k.shape, v.shape)
