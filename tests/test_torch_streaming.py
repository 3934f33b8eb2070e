"""Port parity of AG streaming, the decoupled sharded flat engine
(DESIGN.md §12), against the JAX package and against the port's burst
engine, on one rank (2 and 4 gloo ranks: tests/test_torch_chains.py).

* The lazy parameter view reads every leaf bitwise equal to
  ``unflatten_buckets``, gathers a bucket at the first access of a leaf
  it holds and no sooner, memoizes leaves, and densifies through
  ``repro_torch.tree``.
* ``ParamStream`` issues each gather ahead in the recorded first-touch
  order (nothing ahead on a first dispatch), waits at first touch, reads
  a reused bucket from the cache, runs a chained gather only after every
  gather in flight has landed, and gathers an untouched bucket after the
  forward.
* The 1-shard ``DeftRuntime(fsdp=True, decoupled=True)`` against the JAX
  package's ``DeftRuntime(config=RuntimeConfig(fsdp=True,
  decoupled=True))`` over two periods of smoke qwen3-4b, f32 and on mixed
  int8 / bf16 / f32 wires, within the limits
  tests/test_torch_sharded.py holds the burst engine to.
* Decoupled against burst over a period + 1, bitwise (every loss and
  every ``pbuf``): f32, bf16 compute and mixed wires, the gather skip on
  and off.
* A gather census at the forward's first compute (its first leaf read,
  the embedding lookup): the burst engine has issued every bucket's
  gather, the decoupled one the embedding's bucket and the one gather it
  issues ahead (2; the JAX package's jaxpr census counts 1, as a trace
  issues nothing ahead).
* ``decoupled`` without ``fsdp`` raises, in the runtime and the launcher.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core.precision import PrecisionPolicy as JaxPrecisionPolicy
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
from repro_torch.launch.train import build_schedule, init_distributed, train
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train import runtime as trt
from repro_torch.train.bucketing import build_bucket_layout, unflatten_buckets
from repro_torch.train.runtime import DeftRuntime, phase_collectives_sharded
from repro_torch.train.streaming import (
    AHEAD,
    LazyDict,
    ParamStream,
    lazy_param_tree,
)
from repro_torch.tree import tree_dense, tree_leaves

ARCH, B, S, PART, LR = "qwen3-4b", 2, 32, 250_000, 1e-3
ATOL = 1e-4                      # tests/test_torch_sharded.py's
MIXED_TOL = (1e-4, 1e-3, 1e-4)   # and its mixed-wire limits


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


def _mixed_wires(nb):
    return tuple(("int8", "bf16", "f32")[b % 3] for b in range(nb))


@pytest.fixture(scope="module")
def setup():
    tcfg = t_reduce(t_get_config(ARCH))
    meta = init_params(tcfg, device="meta")
    bucket_of, nb, _, plan = build_schedule(
        meta, tcfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=1.8)
    return tcfg, meta, bucket_of, nb, plan.schedule


def _batches(n):
    cfg = reduce_for_smoke(get_config(ARCH))
    return [{k: torch.from_numpy(np.array(v)).long()
             for k, v in make_batch(cfg, 0, i, B, S).items()}
            for i in range(n)]


# ---------------------------------------------------------------------------
# the lazy view
# ---------------------------------------------------------------------------
def test_lazy_view_reads_every_leaf_bitwise(setup):
    tcfg, meta, bucket_of, nb, _ = setup
    layout = build_bucket_layout(meta, bucket_of, nb)
    gen = torch.Generator().manual_seed(3)
    bufs = [torch.randn(n, generator=gen) for n in layout.buf_sizes]
    calls = []

    def get_full(b):
        calls.append(b)
        return bufs[b]

    lazy = lazy_param_tree(meta, layout, get_full)
    assert isinstance(lazy, LazyDict) and calls == []
    embed = layout.bucket_of_leaf[0]      # "embed" sorts first
    table = lazy["embed"]["table"]
    assert calls == [embed]               # one bucket, at its first leaf
    assert lazy["embed"]["table"] is table          # memoized
    want = unflatten_buckets(layout, bufs)
    got = tree_leaves(lazy)
    assert len(got) == len(want) == layout.n_leaves
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    assert sorted(calls) == list(range(nb))         # each bucket once
    dense = tree_dense(lazy)
    assert isinstance(dense, dict) and isinstance(dense["stack"], tuple)
    assert all(a is b for a, b in zip(tree_leaves(dense), got))


def test_lazy_leaves_wire_grads_into_the_buffer(setup):
    tcfg, meta, bucket_of, nb, _ = setup
    layout = build_bucket_layout(meta, bucket_of, nb)
    bufs = [torch.ones(n) for n in layout.buf_sizes]
    grads = [torch.zeros(n) for n in layout.buf_sizes]
    lazy = lazy_param_tree(meta, layout, lambda b: bufs[b], grads)
    table = lazy["embed"]["table"]
    (2.0 * table).sum().backward()
    b = layout.bucket_of_leaf[0]
    n = table.numel()
    assert table.requires_grad and table.grad.data_ptr() == grads[b].data_ptr()
    assert torch.equal(grads[b][:n], torch.full((n,), 2.0))


def _fake_stream(n, cached=(), chained=(), order=None):
    """A ``ParamStream`` over ``n`` buckets whose gathers log their issue
    ("i", b) and their landing ("w", b)."""
    log = []

    def start(b):
        log.append(("i", b))

        def finish():
            log.append(("w", b))
            return torch.full((2,), float(b))
        return finish

    stream = ParamStream(
        start, [torch.zeros(2) if b in cached else None for b in range(n)],
        chained=[b in chained for b in range(n)], order=order)
    return stream, log


def test_param_stream_issues_ahead_and_completes():
    # first dispatch: no recorded order, nothing issued ahead
    stream, log = _fake_stream(3)
    stream.get_full(0)
    assert log == [("i", 0), ("w", 0)] and stream.issued_at_first_touch == 1
    # recorded order 0, 2, 1: each first touch issues the next bucket
    # before waiting for its own; a second touch issues nothing
    stream, log = _fake_stream(4, order=(0, 2, 1, 3))
    assert stream.get_full(0)[0] == 0
    assert log == [("i", 0), ("i", 2), ("w", 0)]
    assert stream.issued_at_first_touch == 1 + AHEAD
    stream.get_full(2)
    stream.get_full(0)
    assert log[3:] == [("i", 1), ("w", 2)]
    # bucket 3 is never touched: it is gathered after the forward, and
    # the gather issued ahead lands
    full = stream.complete()
    assert log[5:] == [("w", 1), ("i", 3), ("w", 3)]
    assert [int(f[0]) for f in full] == [0, 1, 2, 3]
    assert stream.touched == [0, 2] and stream.issued == [0, 2, 1, 3]
    # a reused bucket reads the cache and issues nothing; a chained one
    # lands every gather in flight first, then runs at its touch
    stream, log = _fake_stream(4, cached=(1,), chained=(2,),
                               order=(0, 1, 3, 2))
    stream.get_full(0)                       # issues 3 ahead (1 is cached)
    assert log == [("i", 0), ("i", 3), ("w", 0)]
    assert stream.get_full(1)[0] == 0 and len(log) == 3
    stream.get_full(2)
    assert log[3:] == [("w", 3), ("i", 2), ("w", 2)]


# ---------------------------------------------------------------------------
# the 1-shard decoupled engine against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wires", ["f32", "mixed"])
def test_decoupled_runtime_matches_jax(group, single_mesh, setup, wires):
    cfg = reduce_for_smoke(get_config(ARCH))
    tcfg, meta, tb, tnb, sched = setup
    jparams = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), cfg))
    jb, jnb, _, jplan = jax_build_schedule(
        jparams, cfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=1.8)
    assert (tb, tnb) == (jb, jnb)
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, jax_init_params(key, cfg))
    n_steps = 2 * sched.period
    jlay = jax_layout(jparams, jb, jnb, shard_count=1)
    layout = build_bucket_layout(meta, jb, jnb, shard_count=1)
    if wires == "mixed":
        jlay = jlay.with_precision(JaxPrecisionPolicy(_mixed_wires(jnb)))
        layout = layout.with_precision(PrecisionPolicy(_mixed_wires(jnb)))
    with single_mesh:
        jr = jrt.DeftRuntime(
            cfg, jax_adamw(LR), jplan.schedule, jlay, single_mesh,
            config=jrt.RuntimeConfig(fsdp=True, decoupled=True))
        jstate = jr.init_state(key)
        jlosses = []
        for i in range(n_steps):
            jstate, m = jr.step(i, jstate, make_batch(cfg, 0, i, B, S))
            jlosses.append(float(m["loss"]))
        jfinal = [np.asarray(x) for x in jax.tree.leaves(jr.params_tree(jstate))]
        assert jr.stats()["decoupled"] is True

    rt = DeftRuntime(tcfg, adamw(LR), sched, layout, device="cpu", fsdp=True,
                     decoupled=True)
    assert rt.stats()["decoupled"] is True and rt.stats()["gather_skip"]
    state = rt.state_from_params(params_from_numpy(params, device="cpu"))
    losses = []
    for i, bt in enumerate(_batches(n_steps)):
        state, m = rt.step(i, state, bt)
        t = i % sched.period
        reuse = (t > 0 and not sched.phases[t - 1].do_update,) * jnb
        assert rt.last_collectives == phase_collectives_sharded(
            sched.phases[t], layout, reuse, True)
        losses.append(float(m["loss"]))
    final = [p.numpy() for p in tree_leaves(rt.params_tree(state))]
    if wires == "f32":
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        for a, b in zip(final, jfinal):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        return
    rtol, atol, share = MIXED_TOL
    np.testing.assert_allclose(losses, jlosses, rtol=rtol)
    n = over = 0
    worst = 0.0
    for a, b in zip(final, jfinal):
        d = np.abs(a - b)
        worst = max(worst, float(d.max()))
        over += int((d > 1e-4 + np.abs(b) / 128).sum())
        n += d.size
    assert worst <= atol and over <= share * n, (worst, over, n)


# ---------------------------------------------------------------------------
# decoupled against burst, and the gather census
# ---------------------------------------------------------------------------
def _run(setup, case, decoupled, gather_skip=None, census=None):
    """``period + 1`` steps of one engine; returns the losses and the final
    ``pbuf``.  ``census`` collects, per step, the param gathers issued
    when the forward first reads a leaf."""
    tcfg, meta, bucket_of, nb, sched = setup
    layout = build_bucket_layout(meta, bucket_of, nb)
    if case == "mixed":
        layout = layout.with_precision(PrecisionPolicy(_mixed_wires(nb)))
    rt = DeftRuntime(tcfg, adamw(LR), sched, layout, device="cpu", fsdp=True,
                     decoupled=decoupled, gather_skip=gather_skip,
                     compute_dtype=torch.bfloat16 if case == "bf16" else None)
    state = rt.init_state(seed=0, dtype=rt.compute_dtype or torch.float32)
    losses = []
    for i, bt in enumerate(_batches(sched.period + 1)):
        state, m = rt.step(i, state, bt)
        losses.append(float(m["loss"]))
        if census is not None:
            census.append((rt.last_stream or {}).get("issued_at_first_touch"))
    return losses, [p.clone() for p in state["pbuf"]], rt


@pytest.mark.parametrize("case,skip", [("f32", None), ("f32", False),
                                       ("bf16", None), ("mixed", None)])
def test_decoupled_is_bitwise_burst(group, setup, case, skip):
    lb, pb, _ = _run(setup, case, False, skip)
    ld, pd, rt = _run(setup, case, True, skip)
    assert lb == ld
    for a, b in zip(pb, pd):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert rt.stats()["gather_skip"] == (skip is None)


def test_gather_census_at_the_first_compute(group, setup, monkeypatch):
    """The param gathers issued when the forward reads its first leaf
    (the embedding table, before any block), at cycle position 0 of the
    second cycle: every bucket's on the burst engine, the embedding's
    bucket and ``AHEAD`` more on the decoupled one."""
    nb = setup[3]
    seen = []
    loss_fn = trt.loss_fn

    def spy(params, *a, **kw):
        params["embed"]["table"]
        seen.append(rt_box[0].dp.counts["param_gather"])
        return loss_fn(params, *a, **kw)

    monkeypatch.setattr(trt, "loss_fn", spy)
    rt_box = []
    for decoupled in (False, True):
        tcfg, meta, bucket_of, _, sched = setup
        layout = build_bucket_layout(meta, bucket_of, nb)
        rt = DeftRuntime(tcfg, adamw(LR), sched, layout, device="cpu",
                         fsdp=True, decoupled=decoupled)
        rt_box[:] = [rt]
        state = rt.init_state(seed=0)
        seen.clear()
        for i, bt in enumerate(_batches(sched.period + 1)):
            state, _ = rt.step(i, state, bt)
        first_cycle, again = seen[0], seen[sched.period]
        if not decoupled:
            assert first_cycle == again == nb
            continue
        # the first dispatch records the order and issues nothing ahead
        assert first_cycle == 1
        assert again == 1 + AHEAD
        assert rt.last_stream["issued_at_first_touch"] == again
        assert rt.last_stream["touched"][0] == layout.bucket_of_leaf[0]
        assert sorted(rt.last_stream["touched"]) == list(range(nb))
        assert rt.last_collectives["param_gather"] == nb


def test_decoupled_needs_fsdp(group, setup):
    tcfg, meta, bucket_of, nb, sched = setup
    layout = build_bucket_layout(meta, bucket_of, nb)
    with pytest.raises(ValueError, match="decoupled AG streaming"):
        DeftRuntime(tcfg, adamw(LR), sched, layout, device="cpu",
                    decoupled=True)
    with pytest.raises(ValueError, match="decoupled AG streaming"):
        train(tcfg, steps=1, batch=B, seq=S, device="cpu", fsdp=False,
              decoupled=True, log=lambda s: None)
