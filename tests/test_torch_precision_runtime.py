"""Port parity of DeFT's precision path on the replicated flat engine.

The port's ``DeftRuntime`` against the JAX package's on one CPU device:
smoke qwen3-4b, the same schedule, params and batches, two schedule
periods, in three precision cases:

* (a) a mixed wire policy — int8, bf16 and f32 wires on different
  buckets — with an f32 master and f32 compute;
* (b) a bf16sr resident master (f32 wires, forward in bf16 on the bf16
  params);
* (c) ``compute_dtype=bf16`` over an f32 master.

Tolerances: losses rtol; params max |diff| (atol); and the largest share
of params that differ by more than 1e-4 + |want| / 128 (one bf16 ulp at
the value, so a bf16 master's last-bit disagreement does not count).
Each is set from the readings of this file on the CPU:
* (a) losses 1e-4, atol 1e-3, share 1e-4.  Read: losses 1.5e-7, max
  |diff| 1.03e-4, 1 element of 1,181,056 beyond 1e-4 (the f32
  reduction-order noise of tests/test_torch_runtime.py can move one int8
  rounding by a step of its row's grid).
* (b) bf16sr and (c) bf16 compute: the forward runs in bf16, where XLA and
  PyTorch round at other places, and an AdamW step divides by the
  gradient's own magnitude, so a near-zero gradient element moves by up
  to lr either way: losses 2.5e-4, atol 1e-2, share 1%.  Read: losses
  8.5e-5 / 1.5e-4 (6.6e-5 / 1.5e-4 on two threads), max |diff|
  3.30e-3 / 3.24e-3, 6,059 / 5,296 elements (0.51% / 0.45%) beyond the
  count's threshold.

  Control: the port computing in f32 while JAX runs bf16 reads losses
  1.3e-4 / 3.6e-4, max |diff| 3.30e-3 / 3.83e-3, 0.58% / 0.68% beyond
  the threshold.  So the loss limit separates (c) from a port that
  ignores ``compute_dtype`` but nothing in these values can separate
  (b) (Adam's near sign-like step keeps small gradient differences
  under one bf16 ulp).  Every case therefore also asserts the dtype of
  the port's autograd leaves and of the gradients autograd hands them.

A seeded bf16sr run also reproduces bitwise on a second run, and its
initial master equals the JAX package's ``init_state`` master bitwise
(the same flatten, the same stochastic-rounding hash with seed b + 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
from repro.configs import get_config, reduce_for_smoke
from repro.core.precision import PrecisionPolicy as JaxPolicy
from repro.data.pipeline import make_batch
from repro.launch.train import build_schedule as jax_build_schedule
from repro.models.model import init_params as jax_init_params
from repro.optim.optimizers import adamw as jax_adamw
from repro.train import runtime as jrt
from repro.train.bucketing import build_bucket_layout as jax_layout
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_numpy
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch.train import build_schedule, init_distributed
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import build_bucket_layout
from repro_torch.train.runtime import DeftRuntime, phase_collectives
from repro_torch.tree import tree_leaves

ARCH, B, S, PART, LR = "qwen3-4b", 2, 32, 250_000, 1e-3
# case -> (loss rtol, param atol, largest share of params beyond
# 1e-4 + |want| / 128)
TOL = {"mixed": (1e-4, 1e-3, 1e-4), "bf16sr": (2.5e-4, 1e-2, 0.01),
       "bf16": (2.5e-4, 1e-2, 0.01)}


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


@pytest.fixture(scope="module")
def setup():
    cfg = reduce_for_smoke(get_config(ARCH))
    tcfg = t_reduce(t_get_config(ARCH))
    jparams = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), cfg))
    jb, jnb, _, jplan = jax_build_schedule(
        jparams, cfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=1.8)
    tb, tnb, _, tplan = build_schedule(
        init_params(tcfg, device="meta"), tcfg, dp=1, seq_len=S,
        per_device_batch=B, partition_elems=PART, coverage_rate=1.8)
    assert (tb, tnb) == (jb, jnb) and jnb >= 3
    sched = tplan.schedule
    assert max(sched.batch_size_sequence) > 1
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, jax_init_params(key, cfg))
    batches = [make_batch(cfg, 0, i, B, S) for i in range(2 * sched.period)]
    return dict(cfg=cfg, tcfg=tcfg, jparams=jparams, jb=jb, jnb=jnb,
                jsched=jplan.schedule, tsched=sched, key=key, params=params,
                batches=batches)


def _policy(case, n):
    if case == "mixed":
        return ("int8", "bf16", "f32") * (n // 3) + ("int8", "bf16")[: n % 3], "f32"
    return ("f32",) * n, "bf16sr" if case == "bf16sr" else "f32"


def _run_jax(su, case, single_mesh):
    wire, master = _policy(case, su["jnb"])
    layout = jax_layout(su["jparams"], su["jb"], su["jnb"]).with_precision(
        JaxPolicy(wire=wire, master=master))
    rcfg = jrt.RuntimeConfig(
        compute_dtype=jnp.bfloat16 if case == "bf16" else None,
        master_dtype=master if master != "f32" else None)
    with single_mesh:
        jr = jrt.DeftRuntime(su["cfg"], jax_adamw(LR), su["jsched"], layout,
                             single_mesh, config=rcfg)
        state = jr.init_state(su["key"])
        pbuf0 = [np.asarray(p) for p in state["pbuf"]]
        losses = []
        for i, bt in enumerate(su["batches"]):
            state, m = jr.step(i, state, bt)
            losses.append(float(m["loss"]))
        final = [np.asarray(x, np.float32)
                 for x in jax.tree.leaves(jr.params_tree(state))]
    return pbuf0, losses, final


def _run_port(su, case):
    wire, master = _policy(case, su["jnb"])
    layout = build_bucket_layout(
        init_params(su["tcfg"], device="meta"), su["jb"], su["jnb"]
    ).with_precision(PrecisionPolicy(wire=wire, master=master))
    rt = DeftRuntime(su["tcfg"], adamw(LR), su["tsched"], layout,
                     device="cpu",
                     compute_dtype=torch.bfloat16 if case == "bf16" else None)
    state = rt.state_from_params(params_from_numpy(su["params"], device="cpu"))
    pbuf0 = [p.clone() for p in state["pbuf"]]
    losses = []
    for i, bt in enumerate(su["batches"]):
        batch = {k: torch.from_numpy(np.array(v)).long() for k, v in bt.items()}
        state, m = rt.step(i, state, batch)
        assert rt.last_collectives == phase_collectives(
            su["tsched"].phases[i % rt.period])
        losses.append(float(m["loss"]))
    final = [p.float().numpy() for p in tree_leaves(rt.params_tree(state))]
    return rt, state, pbuf0, losses, final


def _watch_leaves(monkeypatch):
    """Record the dtypes of the port's autograd leaves (the params the
    forward reads) and of the gradients autograd hands them."""
    from repro_torch.train import runtime as trt

    seen = {"leaf": set(), "grad": set()}
    inner = trt.loss_fn

    def loss_fn(params, *a, **kw):
        for t in tree_leaves(params):
            seen["leaf"].add(t.dtype)
            t.register_hook(lambda g: seen["grad"].add(g.dtype))
        return inner(params, *a, **kw)

    monkeypatch.setattr(trt, "loss_fn", loss_fn)
    return seen


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("case", ["mixed", "bf16sr", "bf16"])
def test_precision_runtime_matches_jax(group, single_mesh, setup, case,
                                      monkeypatch):
    jpbuf0, jlosses, jfinal = _run_jax(setup, case, single_mesh)
    seen = _watch_leaves(monkeypatch)
    rt, state, pbuf0, losses, final = _run_port(setup, case)
    compute = torch.float32 if case == "mixed" else torch.bfloat16
    assert seen == {"leaf": {compute}, "grad": {compute}}, seen
    st = rt.stats()
    wire, master = _policy(case, setup["jnb"])
    assert st["master_dtype"] == master
    assert st["wire_precision"] == PrecisionPolicy(wire, master).describe()
    assert st["compute_dtype"] == ("bfloat16" if case == "bf16" else "float32")
    want_dtype = torch.bfloat16 if case == "bf16sr" else torch.float32
    assert all(p.dtype == want_dtype for p in state["pbuf"])
    # the same starting master, bitwise (bf16sr: the seeded rounding)
    for a, b in zip(pbuf0, jpbuf0):
        assert np.array_equal(_bits(a), b.view(np.int16) if
                              a.dtype == torch.bfloat16 else b)
    rtol, atol, share = TOL[case]
    np.testing.assert_allclose(losses, jlosses, rtol=rtol)
    n = over = 0
    worst = 0.0
    for a, b in zip(final, jfinal):
        d = np.abs(a - b)
        worst = max(worst, float(d.max()))
        over += int((d > 1e-4 + np.abs(b) / 128).sum())
        n += d.size
    assert worst <= atol and over <= share * n, (case, worst, over, n)
    assert int(state["opt"]["step"]) == 2 * setup["tsched"].updates_per_period

    if case == "bf16sr":       # a seeded bf16sr run reproduces bitwise
        _, state2, _, losses2, _ = _run_port(setup, case)
        assert losses2 == losses
        for a, b in zip(state["pbuf"], state2["pbuf"]):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_precision_layout_checks(group, setup):
    meta = init_params(setup["tcfg"], device="meta")
    layout = build_bucket_layout(meta, setup["jb"], setup["jnb"])
    n = setup["jnb"]
    sr = layout.with_precision(PrecisionPolicy(("f32",) * n, "bf16sr"))
    with pytest.raises(ValueError, match="disagreement"):
        DeftRuntime(setup["tcfg"], adamw(LR), setup["tsched"], sr,
                    device="cpu", master_dtype="f32")
    rt = DeftRuntime(setup["tcfg"], adamw(LR), setup["tsched"], layout,
                     device="cpu", master_dtype="bf16sr")
    assert rt.master_dtype == "bf16sr" and rt.stats()["wire_precision"] == "f32"
    with pytest.raises(ValueError, match="compute_dtype"):
        rt.init_state(0, dtype=torch.bfloat16)
    assert layout.wire(0) == "f32" and layout.master_dtype == "f32"
    assert sr.master_dtype == "bf16sr" and sr.with_precision(None) == layout
    with pytest.raises(ValueError):
        layout.with_precision(PrecisionPolicy(("f32",) * (n + 1)))
