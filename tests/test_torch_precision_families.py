"""Port parity of DeFT's precision path on the encoder-decoder, VLM and MLA
configs, against the JAX package on the CPU.

* The port's ``DeftRuntime`` against JAX's over one schedule period, on
  the same numpy params (the port's seed-0 draw, ``_torch_tiny``'s
  pattern, carried into JAX as arrays) and the same numpy batches (tokens
  and the f32 stub memory), under a bf16sr resident master and under bf16
  compute over an f32 master: seamless-m4t-large-v2-smoke,
  llama-3.2-vision-90b-smoke at 5 layers with its gate opened to 0.5 (a
  closed gate multiplies the cross path by 0), and deepseek-v2-236b-smoke
  (MLA at 48 / 32, a MoE layer).  A partition of 1,000,000 elements gives
  each a delayed schedule of one merged update a period (periods 2, 3 and
  2), and one JAX compile of each of its few phases, which the file's
  time rests on.  Losses and every param, bucket by bucket on the flat
  buffers, within ``tests/test_torch_precision_runtime.py``'s ``TOL``
  for seamless and deepseek-v2 (readings: losses 3.8e-5 / 1.4e-5 and
  1.1e-4 / 9.4e-5, max |diff| 7.8e-3 / 2.0e-3 and 2.9e-3 / 2.0e-3, 0.23%
  / 0.23% and 0.35% / 0.37% of params beyond one bf16 ulp, bf16sr /
  bf16).
* The VLM over two periods: its first period's one update reads the
  empty generation of a fresh start.  Its limits are wider than ``TOL``:
  losses 2.5e-3, max |diff| 1e-2, 3% of params beyond one bf16 ulp
  (readings 1.3e-3 / 1.7e-3, 3.9e-3 / 1.5e-3, 1.6% / 1.1%).  JAX's
  compiled step keeps bf16 intermediates in f32 inside its fusions, and
  XLA's bf16 sigmoid is not correctly rounded (PyTorch's is), so the
  reference's own compiled forward sits 3.6e-4 from its op-by-op forward
  on this model, where the port's sits 2.4e-5 from it (held below to
  FORWARD_RTOL), and Adam's sign-like steps
  turn gradient noise at that scale into moved elements.
* The dtypes at jnp's promotion points, in one forward of each package
  on bf16 params: JAX never casts the f32 memory, so the encoder's output
  and the cross-attention K/V are f32 while each cross-attention's output
  and the decoder's residual stream are bf16; MLA's aux loss is f32.  A
  port that cast the memory to bf16 would move the loss by no more than
  the noise (7.5e-5 on seamless, against JAX's op-by-op forward), so
  these dtypes are the check of the promotion rule.
* ``flash_attention`` on a bf16 q over f32 K/V (the cross-attention of a
  bf16 decoder) against JAX's ``attention_reference`` and its gradients
  (``jax.vjp``): out bf16 within one bf16 rounding step, dq bf16 and dk /
  dv f32 within 1e-5 + 1e-2 relative (the bf16 dq is one rounding of the
  same f32 value; the f32 parts differ by summation order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core.precision import PrecisionPolicy as JaxPolicy
from repro.kernels.flash_attention import attention_reference
from repro.launch.train import build_schedule as jax_build_schedule
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.optim.optimizers import adamw as jax_adamw
from repro.train import runtime as jrt
from repro.train.bucketing import build_bucket_layout as jax_layout
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.train import build_schedule, init_distributed
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as tmodel
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import build_bucket_layout
from repro_torch.train.runtime import DeftRuntime

from test_torch_precision_runtime import TOL

B, S, PART, LR = 2, 32, 1_000_000, 1e-3
# (loss rtol, param atol, largest share of params beyond 1e-4 + |p| / 128)
# and periods run; see the module docstring for the VLM's
LIMITS = {"seamless": (TOL, 1), "deepseek-v2": (TOL, 1),
          "vlm-5layers": ({"bf16sr": (2.5e-3, 1e-2, 0.03),
                           "bf16": (2.5e-3, 1e-2, 0.03)}, 2)}
# the VLM's loss against JAX's op-by-op forward (reading 2.4e-5)
FORWARD_RTOL = 1e-4
# (arch, smoke layers, gate): the VLM at one whole pattern period, its
# gate opened so the gated cross block counts
FAMILIES = {
    "seamless": ("seamless-m4t-large-v2", 2, None),
    "vlm-5layers": ("llama-3.2-vision-90b", 5, 0.5),
    "deepseek-v2": ("deepseek-v2-236b", 2, None),
}
F32, BF16 = "float32", "bfloat16"


def _cfgs(family):
    arch, n_layers, _ = FAMILIES[family]
    return (reduce_for_smoke(get_config(arch), n_layers),
            t_reduce(t_get_config(arch), n_layers))


@functools.lru_cache(maxsize=None)
def _params(family):
    """The family's smoke params, the port's seed-0 draw as a numpy tree of
    the JAX package's structure (the VLM's gates opened); shared, so never
    written to."""
    _, n_layers, gate = FAMILIES[family]
    params = params_to_numpy(init_params(_cfgs(family)[1], seed=0,
                                         device="cpu"))
    if gate is not None:
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: np.full_like(x, gate)
            if getattr(p[-1], "key", None) == "gate" else x, params)
    return params


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


def _batches(tcfg, n):
    """(port batches, JAX batches) of the port's numpy stream, the f32
    memory included."""
    port = [make_batch(tcfg, 0, i, B, S, device="cpu") for i in range(n)]
    as_jax = lambda bt: {k: jnp.asarray(v.numpy().astype(np.int32)
                                        if k != "memory" else v.numpy())
                         for k, v in bt.items()}
    return port, [as_jax(bt) for bt in port]


def _case(case):
    """(master, JAX compute dtype, port compute dtype) of a case."""
    if case == "bf16sr":
        return "bf16sr", None, None
    return "f32", jnp.bfloat16, torch.bfloat16


@pytest.mark.parametrize("case", ["bf16sr", "bf16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_precision_runtime_matches_jax(group, single_mesh, family, case,
                                       monkeypatch):
    cfg, tcfg = _cfgs(family)
    params = _params(family)
    jparams = jax.tree.map(jnp.asarray, params)
    jb, jnb, _, jplan = jax_build_schedule(
        jparams, cfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=1.8)
    meta = init_params(tcfg, device="meta")
    tb, tnb, _, tplan = build_schedule(
        meta, tcfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=1.8)
    assert (tb, tnb) == (jb, jnb)
    sched = tplan.schedule
    limits, periods = LIMITS[family]
    port_batches, jax_batches = _batches(tcfg, periods * sched.period)
    master, jcompute, tcompute = _case(case)
    wire = ("f32",) * jnb

    # JAX's init_state starts from these params, not a draw of its own
    monkeypatch.setattr(jrt, "init_params", lambda *a, **kw: jparams)
    layout = jax_layout(jparams, jb, jnb).with_precision(
        JaxPolicy(wire=wire, master=master))
    rcfg = jrt.RuntimeConfig(
        compute_dtype=jcompute,
        master_dtype=master if master != "f32" else None)
    with single_mesh:
        jr = jrt.DeftRuntime(cfg, jax_adamw(LR), jplan.schedule, layout,
                             single_mesh, config=rcfg)
        jstate = jr.init_state(jax.random.PRNGKey(0))
        jlosses = []
        for i, bt in enumerate(jax_batches):
            jstate, m = jr.step(i, jstate, bt)
            jlosses.append(float(m["loss"]))
        jfinal = [np.asarray(b, np.float32) for b in jstate["pbuf"]]

    rt = DeftRuntime(
        tcfg, adamw(LR), sched,
        build_bucket_layout(meta, tb, tnb).with_precision(
            PrecisionPolicy(wire=wire, master=master)),
        device="cpu", compute_dtype=tcompute)
    state = rt.state_from_params(params_from_numpy(params, device="cpu"))
    losses = []
    for i, bt in enumerate(port_batches):
        state, m = rt.step(i, state, bt)
        losses.append(float(m["loss"]))
    want = torch.bfloat16 if master == "bf16sr" else torch.float32
    assert all(p.dtype == want for p in state["pbuf"])

    rtol, atol, share = limits[case]
    assert len(state["pbuf"]) == len(jfinal) == tnb
    n = over = 0
    worst = 0.0
    for a, b in zip(state["pbuf"], jfinal):
        d = np.abs(a.float().numpy() - b)
        worst = max(worst, float(d.max()))
        over += int((d > 1e-4 + np.abs(b) / 128).sum())
        n += d.size
    assert worst <= atol and over <= share * n, (family, case, worst, over, n)
    np.testing.assert_allclose(losses, jlosses, rtol=rtol)


def _recorders(seen, encode, cross_kv, cross, block):
    """Wrappers of a package's encode, cross_kv, apply_cross_attention and
    apply_block recording the dtypes they return into ``seen``; a block
    called without ``causal`` is a decoder block (the encoder passes
    causal=False)."""

    def rec_encode(*a, **kw):
        out = encode(*a, **kw)
        seen["encoder"].add(out.dtype)
        return out

    def rec_cross_kv(*a, **kw):
        k, v = cross_kv(*a, **kw)
        seen["cross_kv"].update((k.dtype, v.dtype))
        return k, v

    def rec_cross(*a, **kw):
        out = cross(*a, **kw)
        seen["cross_out"].add(out.dtype)
        return out

    def rec_block(*a, **kw):
        out = block(*a, **kw)
        if "causal" not in kw:
            seen["residual"].add(out[0].dtype)
        return out

    return rec_encode, rec_cross_kv, rec_cross, rec_block


def _dtypes(mods, names, loss_fn, monkeypatch):
    """({point: sorted dtype names}, the loss) of one forward ``loss_fn()``
    with the recorders patched over ``names`` of ``mods``."""
    seen = {"encoder": set(), "cross_kv": set(), "cross_out": set(),
            "residual": set()}
    fns = [getattr(m, n) for m, n in zip(mods, names)]
    with monkeypatch.context() as mp:
        for m, n, f in zip(mods, names, _recorders(seen, *fns)):
            mp.setattr(m, n, f)
        loss, parts = loss_fn()
    seen["aux"] = {parts["aux"].dtype}
    return {k: sorted(str(d).replace("torch.", "") for d in v)
            for k, v in seen.items()}, loss


NAMES = ("encode", "cross_kv", "apply_cross_attention", "apply_block")


# the dtypes each family's promotion points take on bf16 params
WANT_DTYPES = {
    "seamless": dict(encoder=[F32], cross_kv=[F32], cross_out=[BF16],
                     residual=[BF16], aux=[F32]),
    "vlm-5layers": dict(encoder=[], cross_kv=[F32], cross_out=[BF16],
                        residual=[BF16], aux=[F32]),
    "deepseek-v2": dict(encoder=[], cross_kv=[], cross_out=[],
                        residual=[BF16], aux=[F32]),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_promotion_dtypes_match_jax(family, monkeypatch):
    """One forward of each package's loss_fn on the bf16-cast params and
    the f32 memory (JAX's traced by ``jax.jit``): the dtypes at the
    encoder's output, the cross K/V, each cross-attention's output, the
    decoder's residual and the aux loss, equal and as jnp's promotion
    gives them."""
    cfg, tcfg = _cfgs(family)
    params = _params(family)
    port_bt, jax_bt = _batches(tcfg, 1)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    want, _ = _dtypes((jmodel, jattn, jattn, jmodel), NAMES,
                      lambda: jax.jit(lambda p, b: jmodel.loss_fn(
                          p, cfg, b, remat=False))(jparams, jax_bt[0]),
                      monkeypatch)
    tparams = params_from_numpy(params, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        got, _ = _dtypes((tmodel, tblocks, tblocks, tmodel), NAMES,
                         lambda: tmodel.loss_fn(tparams, tcfg, port_bt[0],
                                                remat=False), monkeypatch)
    assert want == WANT_DTYPES[family], want
    assert got == want


def test_vlm_forward_follows_jnp_op_by_op():
    """The 5-layer VLM's loss on bf16 params within FORWARD_RTOL of JAX's
    forward run op by op (``jax.disable_jit``), which JAX's compiled
    forward misses by 3.6e-4: the ground of the VLM's runtime limits."""
    cfg, tcfg = _cfgs("vlm-5layers")
    params = _params("vlm-5layers")
    port_bt, jax_bt = _batches(tcfg, 1)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    with jax.disable_jit():
        jloss, _ = jmodel.loss_fn(jparams, cfg, jax_bt[0], remat=False)
    tparams = params_from_numpy(params, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        loss, _ = tmodel.loss_fn(tparams, tcfg, port_bt[0], remat=False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=FORWARD_RTOL)


def test_flash_bf16_q_over_f32_kv_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 16, 2, 32)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
    jq = jnp.asarray(q, jnp.bfloat16)
    jout, vjp = jax.vjp(lambda a, b, c: attention_reference(a, b, c,
                                                            causal=False),
                        jq, jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(w, jnp.bfloat16))
    assert jout.dtype == jnp.bfloat16
    assert [g.dtype for g in jgrads] == [jnp.bfloat16, jnp.float32,
                                         jnp.float32]

    xs = [torch.from_numpy(q).bfloat16().requires_grad_(True),
          torch.from_numpy(k).requires_grad_(True),
          torch.from_numpy(v).requires_grad_(True)]
    out = flash_attention(*xs, causal=False)
    out.backward(torch.from_numpy(w).bfloat16())
    assert out.dtype == torch.bfloat16
    assert [x.grad.dtype for x in xs] == [torch.bfloat16, torch.float32,
                                          torch.float32]
    want = np.asarray(jout, np.float32)
    np.testing.assert_allclose(out.detach().float().numpy(), want,
                               rtol=2 ** -7, atol=1e-5)
    for x, g in zip(xs, jgrads):
        np.testing.assert_allclose(x.grad.float().numpy(),
                                   np.asarray(g, np.float32), rtol=1e-2,
                                   atol=1e-5)
