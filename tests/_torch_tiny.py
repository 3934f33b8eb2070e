"""Shared by the control-surface tests (``test_torch_swap*.py``,
``test_torch_adapt.py``, ``test_torch_obs.py``): the tiny qwen3 of
``tests/test_repack.py`` and ``tests/test_adapt.py`` in both packages,
the same JAX params and numpy batches, and the runs the tests compare;
and by ``test_torch_mla.py`` / ``test_torch_moe.py``: a smoke model's
params drawn once a process by the port's init (``smoke_params``: numpy
in the JAX package's tree, which a JAX draw of takes seconds), and its
loss and every gradient leaf against JAX's (``loss_and_grads_match_jax``).
The JAX package is imported inside the functions that use it, so that
the spawned gloo ranks of ``test_torch_swap_ranks.py``, which import
this module, start without JAX."""
import contextlib
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.bucket import BucketTimes
from repro_torch.core.deft import feedback_solve
from repro_torch.core.preserver import WalkParams
from repro_torch.core.profiler import HardwareModel
from repro_torch.data.pipeline import make_batch as t_make_batch
from repro_torch.models.model import init_params, loss_fn
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import (
    assign_buckets,
    build_bucket_layout,
    build_layout_transition,
    leaf_bucket_times,
)
from repro_torch.train.runtime import DeftRuntime
from repro_torch.tree import tree_flatten_with_path, tree_leaves

WALK = WalkParams(s0=4.0, eta=0.01, mu=1.0, sigma=40.0, batch=256)
B, S, LR, ATOL = 4, 32, 1e-3, 1e-4
TINY = dict(name="qwen3-tiny", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
CTRL = dict(warmup_steps=2, check_every=2, cooldown_steps=100,
            min_loss_samples=10**9)            # timing trigger only


def port_cfg():
    return dataclasses.replace(t_get_config("qwen3-4b"), **TINY)


def make_tiny():
    """Both packages' tiny qwen3 and JAX's params at key 0, in both."""
    import jax
    from repro.configs import get_config
    from repro.models.model import init_params as jax_init_params

    cfg = dataclasses.replace(get_config("qwen3-4b"), **TINY)
    key = jax.random.PRNGKey(0)
    jparams = jax_init_params(key, cfg)
    return SimpleNamespace(
        cfg=cfg, tcfg=port_cfg(), key=key, jparams=jparams,
        params=params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu"),
        meta=init_params(port_cfg(), device="meta"), batches={})


def jb(t, step):
    """JAX's batch of ``step`` as numpy (made once: JAX's ``make_batch``
    traces on every call)."""
    from repro.data.pipeline import make_batch

    if step not in t.batches:
        t.batches[step] = {k: np.asarray(v) for k, v in
                           make_batch(t.cfg, 0, step, B, S).items()}
    return t.batches[step]


def tb(t, step):
    """The same batch as torch tensors."""
    return {k: torch.from_numpy(v).long() for k, v in jb(t, step).items()}


def plan(t, pe, cr=1.8):
    """(bucket_of, nb, times, schedule, scheduler cfg) of partition ``pe``
    from the port's planner, checked equal to JAX's."""
    from repro.core.bucket import BucketTimes as JBucketTimes
    from repro.core.deft import feedback_solve as jax_feedback_solve
    from repro.core.profiler import HardwareModel as JHardwareModel
    from repro.train import assign_buckets as jax_assign
    from repro.train import leaf_bucket_times as jax_leaf_times

    jbo, jnb = jax_assign(t.jparams, t.cfg, partition_elems=pe)
    jt = jax_leaf_times(t.jparams, t.cfg, jbo, jnb,
                        JHardwareModel(dp_degree=2), S, B)
    scale = cr * (jt.fwd_total + jt.bwd_total) / jt.comm_total
    jt = JBucketTimes(jt.fwd, jt.bwd, tuple(c * scale for c in jt.comm))
    jsched = jax_feedback_solve(jt, WALK)[0]
    bo, nb = assign_buckets(t.meta, t.tcfg, partition_elems=pe)
    times = leaf_bucket_times(t.meta, t.tcfg, bo, nb,
                              HardwareModel(dp_degree=2), S, B)
    scale = cr * (times.fwd_total + times.bwd_total) / times.comm_total
    times = BucketTimes(times.fwd, times.bwd,
                        tuple(c * scale for c in times.comm))
    sched, _, scfg, _ = feedback_solve(times, WALK)
    assert (bo, nb) == (jbo, jnb)
    assert phases(sched) == phases(jsched)
    return bo, nb, times, sched, scfg


def phases(schedule):
    return [dataclasses.astuple(p) for p in schedule.phases]


def layouts(t, bo, nb, shards=1):
    from repro.train import build_bucket_layout as jax_layout

    return (jax_layout(t.jparams, bo, nb, shard_count=shards),
            build_bucket_layout(t.meta, bo, nb, shard_count=shards))


def port_run(t, rt, n_steps, hook=None):
    """Step ``rt`` from the JAX params over the numpy batches; ``hook(i,
    state)`` runs after step ``i``.  Returns (state, losses)."""
    state = rt.state_from_params(t.params)
    losses = []
    for i in range(n_steps):
        state, m = rt.step(i, state, tb(t, i))
        losses.append(float(m["loss"]))
        if hook is not None:
            hook(i, state)
    return state, losses


def jax_run(t, rt, n_steps, single_mesh, hook=None):
    import jax

    state = rt.init_state(t.key)
    with jax.set_mesh(single_mesh):
        for i in range(n_steps):
            state, m = rt.step(i, state, jb(t, i))
            if hook is not None:
                hook(i, state, m)
    return jax.tree.map(np.asarray, rt.params_tree(state))


def reference(t, sched_a, lay_a, sched_b, lay_b, swap_step, n_steps,
               fsdp=False):
    """The explicit reference: layout A to the swap step, the hand-over to
    B (through ``repack_state`` when the layout changes), then a fresh
    runtime built for B."""
    rt_a = DeftRuntime(t.tcfg, adamw(LR), sched_a, lay_a, device="cpu",
                       fsdp=fsdp)
    rt_b = DeftRuntime(t.tcfg, adamw(LR), sched_b, lay_b, device="cpu",
                       fsdp=fsdp)
    state = rt_a.state_from_params(t.params)
    losses = []
    for i in range(n_steps):
        if i == swap_step and lay_a != lay_b:
            state = rt_b.repack_state(state,
                                      build_layout_transition(lay_a, lay_b),
                                      src_schedule=sched_a)
        elif i == swap_step:
            rt_b.hand_over(state, sched_a)
        rt, at = (rt_a, i) if i < swap_step else (rt_b, i - swap_step)
        state, m = rt.step(at, state, tb(t, i))
        losses.append(float(m["loss"]))
    return rt_b, state, losses


@contextlib.contextmanager
def jax_divisors():
    """The JAX package's hand-over inside: every update divides by its
    phase's ``update_k``, also where the generation a swap handed over
    holds another number of steps (ROADMAP §3); the port's runs in it are
    the ones JAX's swapped runs are held to."""
    from repro_torch.train import runtime as trt

    saved = trt.handover_divisors
    trt.handover_divisors = lambda src, dst: []
    try:
        yield
    finally:
        trt.handover_divisors = saved


def bitwise(run, ref):
    (rt, state, losses), (rt_r, state_r, losses_r) = run, ref
    assert losses == losses_r
    for a, b in zip(tree_leaves(rt.params_tree(state)),
                    tree_leaves(rt_r.params_tree(state_r))):
        assert torch.equal(a, b), "the hot swap diverged from its reference"


def near_jax(rt, state, jfinal):
    import jax

    for a, b in zip(tree_leaves(rt.params_tree(state)),
                    jax.tree.leaves(jfinal)):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0)


# the timing args of control-plane spans; every other arg is compared
TIMED = ("repack_s", "compile_s", "elapsed_s")


def span_rows(tracer, kinds=None):
    """(kind, name, step, phase, args) of every span in record order,
    ``kinds`` only when given; a timing arg becomes whether it is set."""
    return [(sp.kind, sp.name, sp.step, sp.phase,
             {k: (v is not None) if k in TIMED else v
              for k, v in sp.args.items()})
            for sp in tracer.spans(kinds)]


@functools.lru_cache(maxsize=None)
def smoke_params(arch: str):
    """``arch``'s smoke config's params from the port's ``init_params``
    (seed 0) as a numpy tree of the JAX package's structure; shared, so
    never written to."""
    return params_to_numpy(init_params(t_reduce(t_get_config(arch)), seed=0,
                                       device="cpu"))


def loss_and_grads_match_jax(arch, seq, loss_chunk, jparams,
                             rtol=1e-4, atol=1e-5):
    """``loss_fn`` and every gradient leaf of ``arch``'s smoke config at
    JAX's params ``jparams`` against ``jax.value_and_grad`` of JAX's
    ``loss_fn`` (no remat: the same gradients), on a batch of 2 x ``seq``
    from the port's stream; the aux part nonzero and equal, the param
    tree's shapes the port's own."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduce_for_smoke
    from repro.models.model import loss_fn as jax_loss_fn

    cfg = reduce_for_smoke(get_config(arch))
    tcfg = t_reduce(t_get_config(arch))
    data = {k: v.numpy() for k, v in
            t_make_batch(tcfg, 0, 0, 2, seq, device="cpu").items()}
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, cfg, {k: jnp.asarray(v.astype(np.int32))
                                       for k, v in data.items()},
                              loss_chunk=loss_chunk, remat=False),
        has_aux=True))(jparams)

    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(params)] == \
        [tuple(x.shape) for x in tree_leaves(init_params(tcfg, device="meta"))]
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).long() for k, v in data.items()}
    loss, parts = loss_fn(params, tcfg, batch, loss_chunk=loss_chunk)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol, atol=atol)
    assert float(parts["aux"]) > 0
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                               rtol=rtol, atol=atol)
    got = tree_flatten_with_path(params)
    want = jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for (path, p), g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=rtol,
                                   atol=atol, err_msg="/".join(path))
