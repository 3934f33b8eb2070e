"""Port parity of the sharded flat engine (DESIGN.md §8-§9) against the JAX
package, and its arithmetic at 2 and 4 ranks.

* The shard-aware ``BucketLayout`` (``shard_count`` 1, 2 and 4) equals the
  JAX package's, field by field, with bitwise flattened buffers: on smoke
  gemma2-2b and on a toy tree whose first bucket is all tail on the last
  shard and whose third bucket is empty.
* ``element_hparams_shard`` equals the JAX package's; the device cache's
  span views equal it.
* The sharded ``apply_bucket_updates`` on each of 4 shards equals the JAX
  package's (``impl="ref"``, ``shard_id=jnp.int32(s)``, the cross-shard
  norm sum emulated): AdamW and SGD, uniform and per-element
  hyperparameters.  Bitwise with clipping off and with a bf16sr master
  (the same rounded operations; the stochastic rounding hashes span-local
  indices in both); atol/rtol 1e-6 with clipping on, JAX's own bound
  between a sharded and a full apply (the squared norm sums in another
  order).  A hostile NaN/inf tail is masked; clipping without a norm sum
  raises.
* A 1-shard ``DeftRuntime(fsdp=True)`` against the JAX package's
  ``DeftRuntime(fsdp=True)`` on one CPU device over two periods (smoke
  qwen3-4b, whose period-3 schedule reuses a gather): f32 at
  tests/test_torch_runtime.py's atol 1e-4, bf16 compute at
  tests/test_torch_precision_runtime.py's limits, and on mixed int8 /
  bf16 / f32 wires at that file's mixed limits (so the int8 param gather
  and sync run on both sides); the gather skip resolved on in both.
* The wire collectives (``_wire_reduce_scatter``, ``_wire_gather``) at 2
  and 4 gloo ranks against the JAX package's int8 projection.
* Spawned gloo runs at 2 and 4 ranks, each rank taking its slice of a
  global batch of 4: params within 1e-4 of the port's one-rank replicated
  run over the whole batch; each rank's ``pbuf``/``m``/``v`` exactly
  ``shard_sizes[b]`` long; gather skip on and off bitwise equal; the
  collectives of every step equal ``phase_collectives_sharded``.  At 2
  ranks also a mixed int8 / bf16 / f32 wire run (both ranks bitwise equal,
  within the wires' rounding of one rank: tests/test_torch_runtime.py's
  limits, and at most 5% of the params beyond one bf16 ulp of it) and a hand-made gradient-accumulation schedule whose update
  consumes the fresh generation (``update_source="new"``).
"""
import dataclasses
import multiprocessing as mp
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
from repro.configs import get_config, reduce_for_smoke
from repro.core.precision import PrecisionPolicy as JaxPrecisionPolicy
from repro.data.pipeline import make_batch
from repro.kernels.bucket_update import apply_bucket_updates as jax_apply
from repro.kernels.bucket_update import build_segments as jax_segments
from repro.kernels.bucket_update import init_flat_opt_state as jax_opt_state
from repro.kernels.quantize import quantize_dequantize_int8 as jax_qdq
from repro.launch.train import build_schedule as jax_build_schedule
from repro.models.model import init_params as jax_init_params
from repro.optim.optimizers import adamw as jax_adamw
from repro.optim.optimizers import sgd_momentum as jax_sgd
from repro.sharding.specs import FSDP_ARCHS as JAX_FSDP_ARCHS
from repro.train import runtime as jrt
from repro.train.bucketing import build_bucket_layout as jax_layout
from repro.train.bucketing import flatten_buckets as jax_flatten
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_numpy
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data.pipeline import make_batch as t_make_batch
from repro_torch.kernels.bucket_update import (
    apply_bucket_updates,
    build_segments,
    init_flat_opt_state,
)
from repro_torch.launch.train import build_schedule, init_distributed
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw, sgd_momentum
from repro_torch.sharding import FSDP_ARCHS, needs_fsdp
from repro_torch.train.bucketing import build_bucket_layout, flatten_buckets
from repro_torch.train.runtime import (
    DataParallel,
    DeftRuntime,
    _wire_gather,
    _wire_reduce_scatter,
    phase_collectives_sharded,
)
from repro_torch.tree import tree_leaves

N_SHARDS = 4
ATOL = 1e-4
# the toy tree's leaves in tree_flatten order are b (13), h (200), u (105),
# w (333): bucket 0 holds b and w (346 elements; at 4 shards of 128 its last
# span is all tail), bucket 1 h and u, bucket 2 nothing
TOY_BUCKETS, TOY_NB = (0, 1, 1, 0), 3


def _toy(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"w": mk(37, 9), "b": mk(13), "h": mk(200), "u": mk(5, 7, 3)}


def _reuse(schedule, t, skip=True):
    """The gather-skip mask of cycle position ``t``: the previous phase did
    not update (position 0 always gathers)."""
    if not skip:
        return None
    hit = t > 0 and not schedule.phases[t - 1].do_update
    return (hit,) * len(schedule.phases[t].route_new)


def _torch_tree(tree):
    return params_from_numpy(tree, device="cpu")


def _layouts(tree_np, bucket_of, nb, shards):
    jl = jax_layout(tree_np, bucket_of, nb, shard_count=shards)
    tl = build_bucket_layout(_torch_tree(tree_np), bucket_of, nb,
                             shard_count=shards)
    return jl, tl


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


@pytest.fixture(scope="module")
def gemma_smoke():
    cfg = reduce_for_smoke(get_config("gemma2-2b"))
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(1), cfg))
    jb, jnb, _, _ = jax_build_schedule(
        params, cfg, dp=1, seq_len=32, per_device_batch=2,
        partition_elems=120_000, coverage_rate=1.8)
    return params, jb, jnb


# ---------------------------------------------------------------------------
# layout and per-shard hyperparameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("tree", ["toy", "gemma2-2b"])
def test_sharded_layout_matches_jax(tree, shards, gemma_smoke):
    if tree == "toy":
        # the empty bucket only on sharded layouts: unsharded, it has no
        # element at all, which JAX's flatten_buckets cannot concatenate
        params, bucket_of = _toy(), TOY_BUCKETS
        nb = TOY_NB if shards > 1 else TOY_NB - 1
    else:
        params, bucket_of, nb = gemma_smoke
    jl, tl = _layouts(params, bucket_of, nb, shards)
    for f in ("bucket_of_leaf", "n_buckets", "leaves", "offsets", "sizes",
              "shapes", "padded_sizes", "shards", "buf_sizes",
              "shard_sizes"):
        assert getattr(tl, f) == getattr(jl, f), f
    assert all(n % (128 * shards) == 0 for n in tl.buf_sizes)
    if tree == "toy" and shards == 4:
        span = tl.shard_sizes[0]
        assert tl.sizes[0] <= 3 * span                  # last span all tail
        assert tl.sizes[2] == 0 and tl.buf_sizes[2] == 4 * 128
    tbufs = flatten_buckets(tl, tree_leaves(params_from_numpy(params,
                                                               device="cpu")))
    for a, b in zip(tbufs, jax_flatten(jl, jax.tree.leaves(params))):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_sharded_layout_checks():
    with pytest.raises(ValueError, match="shard_count"):
        build_bucket_layout(_torch_tree(_toy()), TOY_BUCKETS, TOY_NB,
                            shard_count=0)
    lay = build_bucket_layout(_torch_tree(_toy()), TOY_BUCKETS, TOY_NB,
                              shard_count=2)
    # a span of 64 elements would not tile the 128-lane kernels (int8's
    # blockwise grid included): the layout refuses it
    with pytest.raises(ValueError, match="lanes"):
        dataclasses.replace(lay, shards=4)
    assert FSDP_ARCHS == JAX_FSDP_ARCHS
    assert needs_fsdp("llama4-maverick-400b-a17b-smoke")
    assert not needs_fsdp("gemma2-2b")


def test_element_hparams_shard_matches_jax():
    params = _toy()
    jl, tl = _layouts(params, TOY_BUCKETS, TOY_NB, N_SHARDS)
    kw = dict(weight_decay=0.1, decay_mask="matrix", ndim1_lr_scale=0.5)
    jseg = jax_segments(jl, jax_adamw(1e-2, **kw))
    tseg = build_segments(tl, adamw(1e-2, **kw))
    for b in range(TOY_NB - 1):
        assert tseg.uniform(b) is None and jseg.uniform(b) is None
        for s in range(N_SHARDS):
            got = tseg.element_hparams_shard(b, s, N_SHARDS)
            want = jseg.element_hparams_shard(b, s, N_SHARDS)
            dev = tseg.device_hparams(b, "cpu", shard=s)
            for g, w, d in zip(got, want, dev):
                assert g.dtype == w.dtype and np.array_equal(g, w)
                assert np.array_equal(d.numpy(), w)
    with pytest.raises(ValueError, match="does not split"):
        tseg.element_hparams_shard(0, 0, N_SHARDS + 1)


# ---------------------------------------------------------------------------
# the sharded update against the JAX package's
# ---------------------------------------------------------------------------
def _spec(pkg, opt, hp, clip):
    """(optimizer, hyperparameters, clip) -> the package's OptimizerSpec."""
    kw = dict(grad_clip=clip)
    if hp == "per-element":
        kw.update(decay_mask="matrix", ndim1_lr_scale=0.5)
    if opt == "adamw":
        return (jax_adamw if pkg == "jax" else adamw)(
            1e-2, weight_decay=0.01, **kw)
    return (jax_sgd if pkg == "jax" else sgd_momentum)(
        3e-2, momentum=0.85, weight_decay=0.02, **kw)


def _span(layout, bufs, s):
    n = layout.shard_sizes
    return [x[s * n[b]:(s + 1) * n[b]] for b, x in enumerate(bufs)]


def _run_shards(pkg, opt, hp, clip, master, hostile=False):
    """Every shard's (p, m, v) spans after one update of one package, on
    the toy tree's 4-shard layout (gradients large enough to clip)."""
    params, grads = _toy(0), _toy(1, scale=3.0)
    lay = (jax_layout if pkg == "jax" else build_bucket_layout)(
        params if pkg == "jax" else _torch_tree(params), TOY_BUCKETS, TOY_NB,
        shard_count=N_SHARDS)
    spec = _spec(pkg, opt, hp, clip)
    adam = opt == "adamw"
    pfull = [np.asarray(x) for x in jax_flatten(lay, jax.tree.leaves(params))]
    gfull = [np.asarray(x).copy() for x in jax_flatten(lay,
                                                       jax.tree.leaves(grads))]
    if hostile:                              # the padded tail of every bucket
        for b, g in enumerate(gfull):
            g[lay.sizes[b]:] = np.resize(
                np.array([np.nan, np.inf, -np.inf, 1e30], np.float32),
                g.size - lay.sizes[b])
    if master == "bf16sr":        # a bf16 master: params on the bf16 grid
        pfull = [np.asarray(jnp.asarray(p).astype(jnp.bfloat16)) for p in pfull]
    if pkg == "jax":
        seg = jax_segments(lay, spec)
        opt0 = jax_opt_state(spec, lay.buf_sizes)
        to = lambda xs: [jnp.asarray(x) for x in xs]
        sq = lambda gs: jnp.sum(jnp.stack(
            [jnp.sum(jnp.square(g * 0.25)) for g in gs]))
        stack = lambda xs: jnp.sum(jnp.stack(xs))
    else:
        seg = build_segments(lay, spec)
        opt0 = init_flat_opt_state(spec, lay.shard_sizes, "cpu")
        to = lambda xs: [torch.from_numpy(np.array(x)) if x.dtype != jnp.bfloat16
                         else torch.from_numpy(x.view(np.int16).copy()).view(
                             torch.bfloat16) for x in xs]
        sq = lambda gs: torch.sum(torch.stack(
            [torch.sum(torch.square(g * 0.25)) for g in gs]))
        stack = lambda xs: torch.sum(torch.stack(xs))
    # the norm sum over the shards, emulated from every shard's masked
    # contribution (the all-reduce the engine issues)
    masked = [g.copy() for g in gfull]
    for b, g in enumerate(masked):
        g[lay.sizes[b]:] = 0.0
    total = stack([sq(to(_span(lay, masked, s))) for s in range(N_SHARDS)])
    out = []
    for s in range(N_SHARDS):
        if pkg == "jax":
            o = {"step": opt0["step"], "m": to(_span(lay, opt0["m"], s))}
            if adam:
                o["v"] = to(_span(lay, opt0["v"], s))
            p, o, _ = jax_apply(
                spec, seg, to(_span(lay, pfull, s)), to(_span(lay, gfull, s)),
                o, grad_scale=0.25, impl="ref", shard_id=jnp.int32(s),
                norm_psum=(lambda t: total) if clip else None,
                master_dtype=master if master != "f32" else None)
            conv = lambda x: (np.asarray(x).view(np.int16)
                              if x.dtype == jnp.bfloat16 else np.asarray(x))
        else:
            o = {"step": opt0["step"].clone(),
                 "m": [x.clone() for x in opt0["m"]]}
            if adam:
                o["v"] = [x.clone() for x in opt0["v"]]
            p, o, _ = apply_bucket_updates(
                spec, seg, to(_span(lay, pfull, s)), to(_span(lay, gfull, s)),
                o, grad_scale=0.25, shard_id=s,
                norm_psum=(lambda t: total) if clip else None,
                master_dtype=master)
            conv = lambda x: (x.view(torch.int16).numpy()
                              if x.dtype == torch.bfloat16 else x.numpy())
            assert int(o["step"]) == 1
        out.append([[conv(x) for x in p], [conv(x) for x in o["m"]],
                    [conv(x) for x in o["v"]] if adam else []])
    return out


UPDATE_CASES = [(opt, hp, clip, "f32")
                for opt in ("adamw", "sgd")
                for hp in ("uniform", "per-element")
                for clip in (0.0, 1.0)] + [
    (opt, hp, 0.0, "bf16sr") for opt in ("adamw", "sgd")
    for hp in ("uniform", "per-element")]


@pytest.mark.parametrize("opt,hp,clip,master", UPDATE_CASES,
                         ids=["-".join(map(str, c)) for c in UPDATE_CASES])
def test_sharded_update_matches_jax(opt, hp, clip, master):
    got = _run_shards("torch", opt, hp, clip, master)
    want = _run_shards("jax", opt, hp, clip, master)
    for s in range(N_SHARDS):
        for what, g_list, w_list in zip("pmv", got[s], want[s]):
            for b, (g, w) in enumerate(zip(g_list, w_list)):
                msg = f"shard {s} {what} bucket {b}"
                if clip:
                    np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6,
                                               err_msg=msg)
                else:
                    assert np.array_equal(g, w), msg


def test_sharded_update_masks_hostile_tail():
    """NaN/inf in the padded tail of every bucket's gradient (the whole
    last span of bucket 0): the spans come out bitwise as with a clean
    tail, clipping on, and as JAX's."""
    got = _run_shards("torch", "adamw", "uniform", 1.0, "f32", hostile=True)
    clean = _run_shards("torch", "adamw", "uniform", 1.0, "f32")
    want = _run_shards("jax", "adamw", "uniform", 1.0, "f32", hostile=True)
    for s in range(N_SHARDS):
        for g_list, c_list, w_list in zip(got[s], clean[s], want[s]):
            for g, c, w in zip(g_list, c_list, w_list):
                assert np.isfinite(g).all() and np.array_equal(g, c)
                np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)


def test_sharded_update_with_clip_needs_norm_sum():
    lay = build_bucket_layout(_torch_tree(_toy()), TOY_BUCKETS, TOY_NB,
                              shard_count=N_SHARDS)
    spec = adamw(1e-2)                                   # clip on
    opt = init_flat_opt_state(spec, lay.shard_sizes, "cpu")
    spans = [torch.zeros(n) for n in lay.shard_sizes]
    with pytest.raises(ValueError, match="norm_psum"):
        apply_bucket_updates(spec, build_segments(lay, spec), spans,
                             [x.clone() for x in spans], opt, shard_id=0)


# ---------------------------------------------------------------------------
# the 1-shard engine against the JAX package's
# ---------------------------------------------------------------------------
RT_ARCH, RT_B, RT_S, RT_PART, LR = "qwen3-4b", 2, 32, 250_000, 1e-3
# tests/test_torch_precision_runtime.py's bf16 limits: loss rtol, param
# atol, largest share of params beyond 1e-4 + |want| / 128
BF16_TOL = (2.5e-4, 1e-2, 0.01)
# and its mixed-wire limits: f32 reduction-order noise can move one int8
# rounding by a step of its row's grid
MIXED_TOL = (1e-4, 1e-3, 1e-4)


def _mixed_wires(nb):
    return tuple(("int8", "bf16", "f32")[b % 3] for b in range(nb))


@pytest.mark.parametrize("compute", ["f32", "bf16", "mixed"])
def test_sharded_runtime_matches_jax(group, single_mesh, compute):
    """``mixed``: f32 compute over int8 / bf16 / f32 wires in turn, so the
    int8 param gather (quantize, gather values and scales, dequantize)
    and the int8 reduce-scatter run on both sides."""
    cfg = reduce_for_smoke(get_config(RT_ARCH))
    tcfg = t_reduce(t_get_config(RT_ARCH))
    jparams = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), cfg))
    jb, jnb, _, jplan = jax_build_schedule(
        jparams, cfg, dp=1, seq_len=RT_S, per_device_batch=RT_B,
        partition_elems=RT_PART, coverage_rate=1.8)
    tb, tnb, _, tplan = build_schedule(
        init_params(tcfg, device="meta"), tcfg, dp=1, seq_len=RT_S,
        per_device_batch=RT_B, partition_elems=RT_PART, coverage_rate=1.8)
    assert (tb, tnb) == (jb, jnb)
    sched = tplan.schedule
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, jax_init_params(key, cfg))
    batches = [make_batch(cfg, 0, i, RT_B, RT_S) for i in range(2 * sched.period)]
    bf16 = compute == "bf16"
    jlay = jax_layout(jparams, jb, jnb, shard_count=1)
    layout = build_bucket_layout(init_params(tcfg, device="meta"), jb, jnb,
                                 shard_count=1)
    if compute == "mixed":
        jlay = jlay.with_precision(JaxPrecisionPolicy(_mixed_wires(jnb)))
        layout = layout.with_precision(PrecisionPolicy(_mixed_wires(jnb)))
    with single_mesh:
        jr = jrt.DeftRuntime(
            cfg, jax_adamw(LR), jplan.schedule, jlay, single_mesh,
            config=jrt.RuntimeConfig(
                fsdp=True, compute_dtype=jnp.bfloat16 if bf16 else None))
        jstate = jr.init_state(key)
        jlosses = []
        for i, bt in enumerate(batches):
            jstate, m = jr.step(i, jstate, bt)
            jlosses.append(float(m["loss"]))
        jfinal = [np.asarray(x) for x in jax.tree.leaves(jr.params_tree(jstate))]
        jstats = jr.stats()

    rt = DeftRuntime(tcfg, adamw(LR), sched, layout, device="cpu", fsdp=True,
                     compute_dtype=torch.bfloat16 if bf16 else None)
    st = rt.stats()
    assert st["sharded_state"] and jstats["sharded_state"]
    assert st["shards"] == jstats["shards"] == 1
    assert st["gather_skip"] == jstats["gather_skip"] is True
    state = rt.state_from_params(params_from_numpy(params, device="cpu"))
    assert "pgather" in state
    losses = []
    for i, bt in enumerate(batches):
        batch = {k: torch.from_numpy(np.array(v)).long() for k, v in bt.items()}
        state, m = rt.step(i, state, batch)
        t = i % sched.period
        assert rt.last_collectives == phase_collectives_sharded(
            sched.phases[t], layout, _reuse(sched, t), True)
        losses.append(float(m["loss"]))
    # the gather skip reused a gather at some position, and the cache holds
    # the forward's dtype
    assert any(any(_reuse(sched, t)) for t in range(sched.period))
    assert all(g.dtype == (torch.bfloat16 if bf16 else torch.float32)
               for g in state["pgather"])
    final = [p.float().numpy() for p in tree_leaves(rt.params_tree(state))]
    if compute == "f32":
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        for a, b in zip(final, jfinal):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        return
    rtol, atol, share = BF16_TOL if bf16 else MIXED_TOL
    np.testing.assert_allclose(losses, jlosses, rtol=rtol)
    n = over = 0
    worst = 0.0
    for a, b in zip(final, jfinal):
        d = np.abs(a - b)
        worst = max(worst, float(d.max()))
        over += int((d > 1e-4 + np.abs(b) / 128).sum())
        n += d.size
    assert worst <= atol and over <= share * n, (worst, over, n)


def test_sharded_runtime_checks(group):
    tcfg = t_reduce(t_get_config(RT_ARCH))
    meta = init_params(tcfg, device="meta")
    bo, nb, _, plan = build_schedule(meta, tcfg, dp=1, seq_len=RT_S,
                                     per_device_batch=RT_B,
                                     partition_elems=RT_PART,
                                     coverage_rate=1.8)
    two = build_bucket_layout(meta, bo, nb, shard_count=2)
    with pytest.raises(ValueError, match="shard_count=2"):
        DeftRuntime(tcfg, adamw(LR), plan.schedule, two, device="cpu",
                    fsdp=True)
    one = build_bucket_layout(meta, bo, nb)
    with pytest.raises(ValueError, match="gather_skip"):
        DeftRuntime(tcfg, adamw(LR), plan.schedule, one, device="cpu",
                    gather_skip=True)
    rt = DeftRuntime(tcfg, adamw(LR), plan.schedule, one, device="cpu",
                     fsdp=True, gather_skip=False)
    assert not rt.stats()["gather_skip"] and "pgather" not in rt.init_state()


# ---------------------------------------------------------------------------
# 2 and 4 gloo ranks
# ---------------------------------------------------------------------------
G_ARCH, G_S, G_PART, G_BATCH, G_STEPS = "qwen3-4b", 32, 120_000, 4, 6
# the 2-rank mixed-wire run against one rank: the largest share of params
# beyond 1e-4 + |want| / 128 (readings in the test)
MIXED_GLOO_SHARE = 0.05


def _gloo_setup():
    cfg = t_reduce(t_get_config(G_ARCH))
    meta = init_params(cfg, device="meta")
    bucket_of, nb, _, plan = build_schedule(
        meta, cfg, dp=2, seq_len=G_S, per_device_batch=G_BATCH // 2,
        partition_elems=G_PART, coverage_rate=1.8)
    return cfg, meta, bucket_of, nb, plan.schedule


def _accum_schedule(schedule, nb):
    """Gradient accumulation over two steps, the second's update consuming
    the fresh generation (``update_source="new"``)."""
    ph = schedule.phases[0]
    acc = dataclasses.replace(ph, route_new=("future",) * nb,
                              sync_cur=(False,) * nb, rotate=False,
                              do_update=False, update_k=1)
    upd = dataclasses.replace(ph, route_new=("sync",) * nb,
                              sync_cur=(False,) * nb, rotate=True,
                              do_update=True, update_k=2, update_source="new")
    return dataclasses.replace(schedule, phases=(acc, upd), period=2,
                               updates_per_period=1,
                               batch_size_sequence=(2,))


def _run(world, rank, case, fsdp, gather_skip=None):
    """One run of ``G_STEPS`` steps over this rank's slice of the global
    batch; returns the final params then the losses.  ``case`` is "f32",
    "mixed" (int8, bf16 and f32 wires in turn) or "accum"."""
    cfg, meta, bucket_of, nb, schedule = _gloo_setup()
    if case == "accum":
        schedule = _accum_schedule(schedule, nb)
    layout = build_bucket_layout(meta, bucket_of, nb,
                                 shard_count=world if fsdp else 1)
    if case == "mixed":
        layout = layout.with_precision(PrecisionPolicy(
            tuple(("int8", "bf16", "f32")[b % 3] for b in range(nb))))
    rt = DeftRuntime(cfg, adamw(LR), schedule, layout, device="cpu",
                     fsdp=fsdp, gather_skip=gather_skip)
    state = rt.init_state(seed=0)
    if fsdp:
        for key, bufs in (("pbuf", state["pbuf"]), ("m", state["opt"]["m"]),
                          ("v", state["opt"]["v"])):
            assert [x.numel() for x in bufs] == list(layout.shard_sizes), key
        assert [x.numel() for x in state["cur"]] == list(layout.buf_sizes)
    per = G_BATCH // world
    losses = []
    for i in range(G_STEPS):
        full = t_make_batch(cfg, 0, i, G_BATCH, G_S, device="cpu")
        state, m = rt.step(i, state, {k: v[rank * per:(rank + 1) * per]
                                      for k, v in full.items()})
        if fsdp:
            t = i % rt.period
            assert rt.last_collectives == phase_collectives_sharded(
                schedule.phases[t], layout,
                _reuse(schedule, t, rt.gather_skip), True), i
        losses.append(float(m["loss"]))
    if fsdp:
        assert rt.stats()["gather_skip"] == bool(
            gather_skip if gather_skip is not None else True)
    params = [p.numpy().copy() for p in tree_leaves(rt.params_tree(state))]
    return params + [np.array(losses)]


# the wire collectives: a buffer of W_ROWS rows of 128 lanes per rank,
# each row on its own scale so the int8 grid differs row by row
W_ROWS = 6
WIRES = ("int8", "bf16", "f32")


def _wire_input(world, seed):
    rng = np.random.default_rng(seed)
    n = world * W_ROWS * 128
    x = rng.standard_normal(n).astype(np.float32)
    return x * np.repeat(np.exp(rng.uniform(-4, 2, n // 128)),
                         128).astype(np.float32)


def _wire_collectives(world, rank):
    """This rank's outputs of ``_wire_reduce_scatter`` (of rank ``r``'s
    gradient, seed ``100 + r``) and ``_wire_gather`` (of its span of the
    param buffer, seed 7) at every wire, through the engine's counted
    ``DataParallel``."""
    dp = DataParallel(keys=DataParallel.SHARDED)
    full = torch.from_numpy(_wire_input(world, 7))
    span = full.numel() // world
    out = []
    for wire in WIRES:
        g = torch.from_numpy(_wire_input(world, 100 + rank))
        out.append(_wire_reduce_scatter(g, wire, dp.reduce_scatter).numpy())
        gathered = torch.empty_like(full)
        _wire_gather(full[rank * span:(rank + 1) * span].clone(), wire,
                     lambda x, o=None: dp.all_gather(x, o, "param_gather"),
                     gathered)
        out.append(gathered.numpy())
    # the int8 gather is two all-gathers (values and scales)
    assert dp.counts["reduce_scatter"] == 3 and \
        dp.counts["param_gather"] == 4, dp.counts
    return out


def _rank_main(rank, world, port, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        runs = {"wires": _wire_collectives(world, rank),
                "skip": _run(world, rank, "f32", True, True),
                "noskip": _run(world, rank, "f32", True, False)}
        if world == 2:
            runs["mixed"] = _run(world, rank, "mixed", True)
            runs["accum"] = _run(world, rank, "accum", True)
        for name, res in runs.items():
            np.savez(os.path.join(out_dir, f"{name}{rank}.npz"), *res)
    finally:
        dist.destroy_process_group()


def _spawn(world, out_dir):
    """Every rank's runs, as {case: [rank 0's result, rank 1's, ...]}."""
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        assert not p.is_alive() and p.exitcode == 0
    out = {}
    for name in ("wires", "skip", "noskip", "mixed", "accum"):
        for r in range(world):
            path = os.path.join(out_dir, f"{name}{r}.npz")
            if os.path.exists(path):
                f = np.load(path)
                out.setdefault(name, []).append(
                    [f[f"arr_{i}"] for i in range(len(f.files))])
    return out


@pytest.fixture(scope="module")
def one_rank(group):
    """The one-rank replicated runs over the whole batch."""
    return {case: _run(1, 0, case, False)
            for case in ("f32", "mixed", "accum")}


@pytest.fixture(scope="module", params=[2, 4])
def spawned(request, tmp_path_factory):
    """(world, every rank's runs) for 2 and 4 gloo ranks."""
    world = request.param
    return world, _spawn(world, str(tmp_path_factory.mktemp(f"gloo{world}")))


def test_gloo_wire_collectives(spawned):
    """The sharded sync and param gather at each wire precision, at 2 and
    4 ranks, against the JAX package's int8 projection:

    * reduce-scatter: rank r's span of the sum over the ranks of each
      rank's gradient on the wire's grid (int8: blockwise quantized and
      dequantized; bf16: rounded, and summed in bf16, so within one
      rounding of the partial sum per addition);
    * all-gather: the full buffer on the wire's grid, bitwise (an int8
      span is whole 128-lane rows, so its per-row scales are the full
      buffer's).

    The f32 sums run in gloo's order, so they are held to 1e-6."""
    world, runs = spawned
    full = _wire_input(world, 7)
    grads = [_wire_input(world, 100 + r) for r in range(world)]
    span = full.size // world
    on_grid = {
        "int8": lambda x: np.asarray(jax_qdq(jnp.asarray(x))),
        "bf16": lambda x: np.asarray(
            jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)),
        "f32": lambda x: x,
    }
    for r in range(world):
        outs = runs["wires"][r]
        for i, wire in enumerate(WIRES):
            rs, ag = outs[2 * i], outs[2 * i + 1]
            q = [on_grid[wire](g) for g in grads]
            want = np.sum(q, axis=0, dtype=np.float32)[r * span:(r + 1) * span]
            if wire == "bf16":
                # world - 1 roundings, each within 2^-8 of its partial sum
                bound = world * 2.0 ** -8 * np.sum(np.abs(q), axis=0)[
                    r * span:(r + 1) * span]
                assert (np.abs(rs - want) <= bound).all(), (wire, r)
            else:
                np.testing.assert_allclose(rs, want, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{wire} rank {r}")
            assert np.array_equal(ag, on_grid[wire](full)), (wire, r)


def test_gloo_ranks_sharded_equal_one_rank(spawned, one_rank):
    world, runs = spawned
    one = one_rank["f32"]
    for r in range(world):
        skip, noskip = runs["skip"][r], runs["noskip"][r]
        for a, b in zip(skip, noskip):                 # the gather skip
            assert np.array_equal(a, b)
        np.testing.assert_allclose(skip[-1], one[-1], rtol=1e-5)   # losses
        for a, b in zip(skip[:-1], one[:-1]):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    if world == 2:
        # the mixed wires: the ranks agree bitwise, and stay within the
        # wires' rounding of the one-rank run (tests/test_torch_runtime.py)
        r0, r1 = runs["mixed"]
        for a, b in zip(r0, r1):
            assert np.array_equal(a, b)
        np.testing.assert_allclose(r0[-1], one_rank["mixed"][-1], rtol=1e-3)
        n = over = 0
        for a, b in zip(r0[:-1], one_rank["mixed"][:-1]):
            np.testing.assert_allclose(a, b, atol=1e-2, rtol=0)
            over += int((np.abs(a - b) > 1e-4 + np.abs(b) / 128).sum())
            n += a.size
        # AdamW moves a param by at most about lr a step, so the atol alone
        # would pass a run with no update; that run puts 85% of the params
        # beyond one bf16 ulp of the one-rank run, a sound run 1.1%
        assert over <= MIXED_GLOO_SHARE * n, (over, n)
        # an update that consumes the fresh generation
        acc = runs["accum"][0]
        np.testing.assert_allclose(acc[-1], one_rank["accum"][-1], rtol=1e-5)
        for a, b in zip(acc[:-1], one_rank["accum"][:-1]):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
