"""Port parity of the replicated flat DeFT engine against the JAX package.

* ``BucketLayout`` and flatten/unflatten: equal offsets/sizes, bitwise
  buffers.
* ``DeftRuntime``: params after two schedule periods equal the JAX
  ``DeftRuntime`` (one CPU device, same schedule, same params and
  batches; gemma2-2b, recurrentgemma-9b and rwkv6-1.6b smoke) — f32 on
  both sides with different reduction orders.  AdamW
  divides each element's step by that element's own gradient magnitude,
  so where a gradient is near zero the reduction-order noise moves the
  param by a visible fraction of lr = 1e-3: atol 1e-4 (a tenth of one
  step's move), rtol 0.
* The collectives each phase issues equal ``phase_collectives``.
* The DDP baseline step matches the JAX one.
* Two spawned gloo ranks equal one rank over the concatenated batch; with
  a mixed int8 / bf16 / f32 wire policy the two replicas stay bitwise
  identical and stay within the wires' rounding of the one-rank run.
"""
import multiprocessing as mp
import os
import socket

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.data.pipeline import make_batch
from repro.launch.train import build_schedule as jax_build_schedule
from repro.models.model import init_params as jax_init_params
from repro.optim.optimizers import adamw as jax_adamw
from repro.train import runtime as jrt
from repro.train.bucketing import build_bucket_layout as jax_layout
from repro.train.bucketing import flatten_buckets as jax_flatten
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_numpy
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data.pipeline import make_batch as t_make_batch
from repro_torch.launch.train import build_schedule, init_distributed
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import (
    build_bucket_layout,
    flatten_buckets,
    unflatten_buckets,
)
from repro_torch.train.runtime import (
    DeftRuntime,
    init_ddp_state,
    make_ddp_step,
    phase_collectives,
)
from repro_torch.tree import tree_leaves

ARCH, B, S, PART = "gemma2-2b", 2, 80, 120_000
ATOL = 1e-4


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _plan(cfg, tcfg):
    jparams = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), cfg))
    jb, jnb, _, jplan = jax_build_schedule(
        jparams, cfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=1.8)
    tb, tnb, _, tplan = build_schedule(
        init_params(tcfg, device="meta"), tcfg, dp=1, seq_len=S,
        per_device_batch=B, partition_elems=PART, coverage_rate=1.8)
    assert (tb, tnb) == (jb, jnb)
    return jparams, jb, jnb, jplan.schedule, tplan.schedule


def test_layout_and_flatten_match_jax():
    cfg = reduce_for_smoke(get_config(ARCH))
    tcfg = t_reduce(t_get_config(ARCH))
    params = _np(jax_init_params(jax.random.PRNGKey(1), cfg))
    jparams, jb, jnb, _, _ = _plan(cfg, tcfg)
    jl = jax_layout(jparams, jb, jnb)
    tl = build_bucket_layout(init_params(tcfg, device="meta"), jb, jnb)
    for f in ("bucket_of_leaf", "n_buckets", "leaves", "offsets", "sizes",
              "shapes", "padded_sizes"):
        assert getattr(tl, f) == getattr(jl, f), f
    tbufs = flatten_buckets(
        tl, tree_leaves(params_from_numpy(params, device="cpu")))
    jbufs = jax_flatten(jl, jax.tree.leaves(params))
    for a, b in zip(tbufs, jbufs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    back = unflatten_buckets(tl, tbufs)
    for a, b in zip(back, jax.tree.leaves(params)):
        assert np.array_equal(a.numpy(), b)
    # leaves are views: writing one writes its bucket buffer
    back[0].add_(1.0)
    b0 = tl.bucket_of_leaf[0]
    assert not np.array_equal(tbufs[b0].numpy(), np.asarray(jbufs[b0]))


def test_runtime_matches_jax_runtime_over_two_periods(group, single_mesh):
    _runtime_parity(ARCH, single_mesh)


def test_recurrentgemma_runtime_matches_jax_runtime_over_two_periods(
        group, single_mesh):
    """The Griffin hybrid (RG-LRU scan, MQA local attention) on the same
    engine: 13 buckets, period 3, merged batch sizes (2, 1)."""
    _runtime_parity("recurrentgemma-9b", single_mesh)


def test_rwkv6_runtime_matches_jax_runtime_over_two_periods(
        group, single_mesh):
    """RWKV-6 (time-mix through the WKV token loop at S = 80, channel-mix,
    untied head) on the same engine: 10 buckets, period 6, merged batch
    sizes (1, 1, 2, 1, 1), so two periods are 12 steps and 10 updates.

    Over those, AdamW's near-zero-gradient amplification shows: an embedding
    row seen once (token 292, at step 6) has one element whose synced
    gradient is -8.8e-7 in the port and -2.6e-6 in JAX, on a row whose
    largest is 0.215 and whose elements differ by up to 5.3e-6 — reduction
    noise on a value ~1e-5 of its row.  With sqrt(v) near AdamW's eps (1e-8)
    the two steps differ by ~17%, and the element drifts by ~6e-5 an update
    to 2.6e-4 after 4 updates (the one element of 1.4M beyond 1e-4).  So
    this case allows a handful of elements beyond ATOL, none beyond one
    step of lr (1e-3); every other element is held to ATOL."""
    _runtime_parity("rwkv6-1.6b", single_mesh, max_over=5, max_diff=1e-3)


def _runtime_parity(arch, single_mesh, max_over=0, max_diff=ATOL):
    cfg = reduce_for_smoke(get_config(arch))
    tcfg = t_reduce(t_get_config(arch))
    jparams, jb, jnb, jsched, tsched = _plan(cfg, tcfg)
    assert tsched.phases == tuple(
        type(tsched.phases[0])(**p.__dict__) for p in jsched.phases)
    # a delayed-update schedule: merged (k > 1) updates and rotations
    assert max(tsched.batch_size_sequence) > 1
    assert tsched.updates_per_period < tsched.period

    key = jax.random.PRNGKey(0)
    params = _np(jax_init_params(key, cfg))
    opt = jax_adamw(1e-3)
    n_steps = 2 * jsched.period
    batches = [make_batch(cfg, 0, i, B, S) for i in range(n_steps)]
    with single_mesh:
        jr = jrt.DeftRuntime(cfg, opt, jsched, jax_layout(jparams, jb, jnb),
                             single_mesh)
        jstate = jr.init_state(key)
        jlosses = []
        for i, bt in enumerate(batches):
            jstate, m = jr.step(i, jstate, bt)
            jlosses.append(float(m["loss"]))
        jfinal = _np(jr.params_tree(jstate))

    rt = DeftRuntime(tcfg, adamw(1e-3), tsched,
                     build_bucket_layout(init_params(tcfg, device="meta"),
                                         jb, jnb), device="cpu")
    state = rt.state_from_params(params_from_numpy(params, device="cpu"))
    for i, bt in enumerate(batches):
        batch = {k: torch.from_numpy(np.array(v)).long() for k, v in bt.items()}
        state, m = rt.step(i, state, batch)
        phase = tsched.phases[i % tsched.period]
        assert rt.last_collectives == phase_collectives(phase) \
            == jrt.phase_collectives(jsched.phases[i % jsched.period])
        assert m["updated"] == phase.do_update
        np.testing.assert_allclose(float(m["loss"]), jlosses[i], rtol=1e-4)
    assert int(state["opt"]["step"]) == 2 * tsched.updates_per_period
    n_over = 0
    for a, b in zip(tree_leaves(rt.params_tree(state)), jax.tree.leaves(jfinal)):
        np.testing.assert_allclose(a.numpy(), b, atol=max_diff, rtol=0)
        n_over += int(np.sum(np.abs(a.numpy() - b) > ATOL))
    assert n_over <= max_over, f"{n_over} params beyond {ATOL}"
    st = rt.stats()
    assert st["steps_dispatched"] == n_steps
    assert st["unique_phases"] == len(set(tsched.phases))


def test_ddp_step_matches_jax(group, single_mesh):
    cfg = reduce_for_smoke(get_config("qwen3-4b"))
    tcfg = t_reduce(t_get_config("qwen3-4b"))
    opt = jax_adamw(1e-3)
    batches = [make_batch(cfg, 0, i, B, 32) for i in range(2)]
    with single_mesh:
        jstate = jax_init_train_state(jax.random.PRNGKey(0), cfg, opt)
        params = _np(jstate["params"])
        step = jrt.make_ddp_step(cfg, opt, donate=False)
        for bt in batches:
            jstate, jm = step(jstate, bt)
    state = init_ddp_state(tcfg, adamw(1e-3),
                           params=params_from_numpy(params, device="cpu"))
    tstep = make_ddp_step(tcfg, adamw(1e-3))
    for bt in batches:
        state, m = tstep(state, {k: torch.from_numpy(np.array(v)).long()
                                 for k, v in bt.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    for a, b in zip(tree_leaves(state["params"]),
                    jax.tree.leaves(_np(jstate["params"]))):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0)


def _rank_main(rank, world, port, n_steps, out_dir, mixed=False):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        res = _run_port(world, rank, n_steps, mixed)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), *res)
    finally:
        dist.destroy_process_group()


def _run_port(world, rank, n_steps, mixed=False):
    """The port's runtime on the smoke config, planned for two ranks,
    over a global batch of 4 of which this rank takes its slice; returns
    the final params then the losses.  ``mixed`` puts int8, bf16 and f32
    wires on the buckets in turn."""
    cfg = t_reduce(t_get_config(ARCH))
    meta = init_params(cfg, device="meta")
    bucket_of, nb, _, plan = build_schedule(
        meta, cfg, dp=2, seq_len=48, per_device_batch=2,
        partition_elems=PART, coverage_rate=1.8)
    layout = build_bucket_layout(meta, bucket_of, nb)
    if mixed:
        layout = layout.with_precision(PrecisionPolicy(
            tuple(("int8", "bf16", "f32")[b % 3] for b in range(nb))))
    rt = DeftRuntime(cfg, adamw(1e-3), plan.schedule, layout, device="cpu")
    state = rt.init_state(seed=0)
    per = 4 // world
    losses = []
    for i in range(n_steps):
        full = t_make_batch(cfg, 0, i, 4, 48, device="cpu")
        state, m = rt.step(i, state, {k: v[rank * per:(rank + 1) * per]
                                      for k, v in full.items()})
        assert rt.last_collectives == phase_collectives(
            plan.schedule.phases[i % rt.period])
        losses.append(float(m["loss"]))
    params = [p.numpy().copy() for p in tree_leaves(rt.params_tree(state))]
    return params + [np.array(losses)]


def _two_ranks_and_one(tmp_path, n_steps, mixed=False):
    """(rank 0's result, rank 1's, the one-rank run's) of ``_run_port``."""
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_rank_main, args=(r, 2, port, n_steps,
                                                  str(tmp_path), mixed))
             for r in range(2)]
    for p in procs:
        p.start()
    one = _run_port(1, 0, n_steps, mixed)
    for p in procs:
        p.join(timeout=240)
        assert not p.is_alive() and p.exitcode == 0
    ranks = []
    for r in range(2):
        f = np.load(tmp_path / f"rank{r}.npz")
        ranks.append([f[f"arr_{i}"] for i in range(len(f.files))])
        assert len(ranks[-1]) == len(one)
    return ranks[0], ranks[1], one


def test_two_gloo_ranks_equal_one_rank(group, tmp_path):
    """Each rank takes half the global batch; the DeFT syncs (all-reduce
    and reduce-scatter + all-gather) must recover the one-rank run over
    the whole batch, within f32 reduction-order noise."""
    two, _, one = _two_ranks_and_one(tmp_path, 6)
    np.testing.assert_allclose(two[-1], one[-1], rtol=1e-5)   # losses
    for a, b in zip(two[:-1], one[:-1]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_two_gloo_ranks_mixed_wire(group, tmp_path):
    """int8, bf16 and f32 wires on the buckets in turn, on two gloo ranks
    (bf16 all-reduce and reduce-scatter + all-gather included): the two
    replicas end bitwise identical, and the run stays within the wires'
    rounding of the one-rank run, where each rank's half-batch gradient
    was rounded instead of the whole batch's.  AdamW divides each step by
    the element's own gradient magnitude, so where a gradient is near zero
    the wires' rounding moves a param by up to lr either way.  Limits from
    the readings (losses rel 7.4e-5, params max |diff| 2.8e-3 after 6
    steps): losses rtol 1e-3, params atol 1e-2 (ten steps of lr 1e-3)."""
    r0, r1, one = _two_ranks_and_one(tmp_path, 6, mixed=True)
    for a, b in zip(r0, r1):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(r0[-1], one[-1], rtol=1e-3)     # losses
    for a, b in zip(r0[:-1], one[:-1]):
        np.testing.assert_allclose(a, b, atol=1e-2, rtol=0)
