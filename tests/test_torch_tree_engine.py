"""Port parity of the tree-state engine (``DeftRuntime(flat_state=False)``,
JAX's ``_deft_body_fused``) on the tiny qwen3 of ``tests/_torch_tiny.py``:

* against JAX's ``DeftRuntime(flat_state=False)`` over two periods at
  coverage rate 1.8 (period 3, a delayed update of k 3): every loss and
  param within rtol 1e-4 / atol 1e-5, each phase's collectives those of
  ``phase_collectives`` (the flat engine's);
* against the port's flat engine on the same run, and bitwise the port's
  per-leaf steps at one rank (f32, and bf16 resident params, which JAX's
  tree engine takes and its flat engine refuses);
* spawned gloo ranks, one spawn per world size: at 2 and 4 ranks, and at
  pod 2 x data 2, the tree engine and the per-leaf steps against the
  port's flat engine on a schedule with every other synced bucket on the
  secondary link, every rank's replica bitwise rank 0's, each step's
  collectives as the engines' counts say; the tree engine along a
  secondary chain at 4 ranks; at 2 ranks a tree state moved by
  ``migrate_state`` onto rank 0 alone and back, its params and moments
  bitwise;
* every refusal of JAX's ``RuntimeConfig.validate`` for
  ``flat_state=False``, and ``fsdp=True`` with it (ROADMAP item 8);
* a checkpoint written mid-cycle through the checkpoint module and
  resumed on a fresh runtime, bitwise the uninterrupted run; a hot swap
  onto another layout bitwise its explicit ``repack_state``.

One JAX schedule is compiled (the tree engine's two unique phases)."""
import dataclasses
import multiprocessing as mp
import os
import socket

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
import _torch_tiny as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data.pipeline import make_batch
from repro_torch.elastic.coordinator import ElasticCoordinator, migrate_state
from repro_torch.launch.mesh import ring_chain
from repro_torch.launch.train import (
    build_schedule,
    init_distributed,
    pod_groups,
)
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import (
    build_bucket_layout,
    build_layout_transition,
)
from repro_torch.train.runtime import DeftRuntime, Placement, phase_collectives
from repro_torch.train.steps import (
    init_train_state,
    make_deft_step_fns,
    phase_collectives_per_leaf,
)
from repro_torch.tree import tree_leaves

LR = T.LR
PE_A, PE_B = 40_000, 60_000           # periods 3 and 2 at CR 1.8
RTOL, ATOL = 1e-4, 1e-5
BATCH, S = 4, 32                      # the spawned runs' global batch


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


@pytest.fixture(scope="module")
def tiny():
    return T.drawn_tiny(7)


@pytest.fixture(scope="module")
def plan_a(tiny):
    bo, nb, _, sched, _ = T.plan(tiny, PE_A, 1.8)
    assert max(p.update_k for p in sched.phases) > 1
    assert any(p.rotate for p in sched.phases)
    return bo, nb, sched, build_bucket_layout(tiny.meta, bo, nb)


def _rt(tiny, plan, flat_state=False, **kw):
    bo, nb, sched, lay = plan
    return DeftRuntime(tiny.tcfg, adamw(LR), sched, lay, device="cpu",
                       flat_state=flat_state, **kw)


def _leaves(tree):
    return [x.detach().float().numpy().copy() for x in tree_leaves(tree)]


@pytest.fixture
def one_thread():
    """Bitwise comparisons of separate backward passes run on one CPU
    thread: several threads may sum the embedding gradient in another
    order from one run to the next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tiny, rt, n, state=None, start=0, hook=None):
    """Step ``rt`` over steps ``start..n-1`` of the numpy batches (from
    the shared params when no ``state``): (state, losses)."""
    state = rt.state_from_params(tiny.params) if state is None else state
    losses = []
    for i in range(start, n):
        state, m = rt.step(i, state, T.tb(tiny, i))
        losses.append(float(m["loss"]))
        if hook is not None:
            hook(i, state, m)
    return state, losses


def test_tree_engine_matches_jax_and_flat(group, tiny, plan_a, single_mesh):
    """Two periods against JAX's tree engine, and against the port's flat
    engine on the same params and batches."""
    import jax
    import jax.numpy as jnp
    from repro.core.scheduler import DeftSchedule, PhaseSpec
    from repro.optim.optimizers import adamw as jax_adamw
    from repro.optim.optimizers import init_opt_state as jax_init_opt_state
    from repro.train import runtime as jrt

    bo, nb, sched, lay = plan_a
    jsched = DeftSchedule(
        plans=(), phases=tuple(PhaseSpec(**p.__dict__) for p in sched.phases),
        period=sched.period, updates_per_period=sched.updates_per_period,
        batch_size_sequence=sched.batch_size_sequence)
    n = 2 * sched.period
    jr = jrt.DeftRuntime(tiny.cfg, jax_adamw(LR), jsched,
                         T.layouts(tiny, bo, nb)[0], single_mesh,
                         flat_state=False)
    # init_state's form around the shared params (a JAX draw takes seconds)
    params = jax.tree.map(jnp.asarray, tiny.jparams)
    zeros = lambda: tuple(jnp.zeros((1, b)) for b in lay.buf_sizes)
    jstate = {"params": params,
              "opt": jax_init_opt_state(jax_adamw(LR), params),
              "cur": zeros(), "fut": zeros()}
    jlosses = []
    with single_mesh:
        for i in range(n):
            jstate, m = jr.step(i, jstate, T.jb(tiny, i))
            jlosses.append(float(m["loss"]))
    jfinal = jax.tree.leaves(jr.params_tree(jstate))
    assert jr.stats()["update_impl"] == "per-leaf"

    rt = _rt(tiny, plan_a)

    def hook(i, state, m):
        ph = sched.phases[i % sched.period]
        assert rt.last_collectives == phase_collectives(ph)
        assert m["updated"] == ph.do_update

    state, losses = _run(tiny, rt, n, hook=hook)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    for a, b in zip(_leaves(rt.params_tree(state)), jfinal):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    assert set(state) == {"params", "opt", "cur", "fut"}
    assert [c.numel() for c in state["cur"]] == list(lay.buf_sizes)
    assert int(state["opt"]["step"]) == 2 * sched.updates_per_period
    st = rt.stats()
    assert (st["flat_state"], st["update_impl"]) == (False, "per-leaf")
    assert st["steps_dispatched"] == n
    assert st["unique_phases"] == len(set(sched.phases))

    flat = _rt(tiny, plan_a, flat_state=True)
    fstate, flosses = _run(tiny, flat, n)
    assert flat.stats()["update_impl"] == "plain"
    np.testing.assert_allclose(losses, flosses, rtol=RTOL, atol=ATOL)
    for a, b in zip(_leaves(rt.params_tree(state)),
                    _leaves(flat.params_tree(fstate))):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tree_engine_is_bitwise_per_leaf_at_one_rank(group, tiny, plan_a,
                                                     dtype, one_thread):
    """At one rank the tree engine and the per-leaf steps sum the same
    gradients in the same order and apply the same update through other
    views: every loss and param bitwise, the params resident at their
    init dtype."""
    bo, nb, sched, lay = plan_a
    rt = _rt(tiny, plan_a)
    fns = make_deft_step_fns(tiny.tcfg, adamw(LR), sched, bo)
    state = rt.init_state(seed=1, dtype=dtype)
    leaf = init_train_state(tiny.tcfg, adamw(LR), deft=True, seed=1,
                            dtype=dtype, device="cpu")
    for i in range(2 * sched.period):
        state, m = rt.step(i, state, T.tb(tiny, i))
        leaf, ml = fns[i % sched.period](leaf, T.tb(tiny, i))
        assert float(m["loss"]) == float(ml["loss"])
    for a, b in zip(tree_leaves(rt.params_tree(state)),
                    tree_leaves(leaf["params"])):
        assert a.dtype == dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves(state["opt"]), tree_leaves(leaf["opt"])):
        assert torch.equal(a, b)
    # with a layout, init_train_state is the tree engine's fresh state
    fresh = init_train_state(tiny.tcfg, adamw(LR), deft=True, layout=lay,
                             seed=1, dtype=dtype, device="cpu")
    for a, b in zip(tree_leaves(fresh), tree_leaves(rt.init_state(1, dtype))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_tree_engine_refusals(group, tiny, plan_a):
    """JAX's ``RuntimeConfig.validate`` for ``flat_state=False``, the
    sharded tree engine (ROADMAP item 8), the flat-only surfaces."""
    bo, nb, sched, lay = plan_a
    cases = [
        (dict(compute_dtype=torch.bfloat16), "compute_dtype"),
        (dict(compute_dtype=torch.float32), "compute_dtype"),
        (dict(update_impl="plain"), "update_impl"),
        (dict(master_dtype="bf16sr"), "bf16sr"),
        (dict(gather_skip=True), "gather_skip"),
        (dict(decoupled=True), "decoupled AG streaming"),
        (dict(fsdp=True), "ROADMAP item 8"),
        (dict(outer_group=torch.distributed.new_group([0]),
              secondary_chain=(0,)), "multi-pod"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            _rt(tiny, plan_a, **kw)
    wired = lay.with_precision(PrecisionPolicy(("int8",) * nb))
    with pytest.raises(ValueError, match="PrecisionPolicy"):
        _rt(tiny, (bo, nb, sched, wired))
    rt = _rt(tiny, plan_a, secondary_chain=(0,))     # one DP axis: taken
    with pytest.raises(ValueError, match="flat-state"):
        rt.checkpoint_struct()
    with pytest.raises(ValueError, match="flat-state"):
        ElasticCoordinator(rt, None, None, params_abs=tiny.meta)
    sib = rt.spawn()
    assert not sib.flat_state and sib.secondary_chain == (0,)


def test_checkpoint_resumes_bitwise(group, tiny, plan_a, tmp_path,
                                    one_thread):
    """Saved at cycle position 2 (``fut`` holds a generation) through
    ``state_to_tree`` and the checkpoint files, restored on a fresh runtime
    with ``like`` a fresh state's tree: the rest of two periods bitwise."""
    bo, nb, sched, lay = plan_a
    n, at = 2 * sched.period, 2
    ref, ref_losses = _run(tiny, _rt(tiny, plan_a), n)
    rt = _rt(tiny, plan_a)
    state, losses = _run(tiny, rt, at)
    tree = rt.state_to_tree(state)
    assert tree["params"] is not state["params"]
    assert [tuple(c.shape) for c in tree["cur"]] == \
        [(1, b) for b in lay.buf_sizes]
    ckpt.save(str(tmp_path), at, tree)
    with pytest.raises(ValueError, match="flat-state"):
        rt.checkpoint_struct()
    fresh = _rt(tiny, plan_a)
    like = fresh.state_to_tree(fresh.init_state())
    back = fresh.tree_to_state(ckpt.restore(str(tmp_path), at, like,
                                            device="cpu"))
    back, rest = _run(tiny, fresh, n, state=back, start=at)
    assert losses + rest == ref_losses
    for a, b in zip(tree_leaves((fresh.params_tree(back), back["opt"],
                                 back["cur"], back["fut"])),
                    tree_leaves((ref["params"], ref["opt"], ref["cur"],
                                 ref["fut"]))):
        assert torch.equal(a, b)


def test_layout_swap_is_bitwise_repack(group, tiny, plan_a, one_thread):
    """A hot swap onto another partition at the cycle boundary after one
    period, bitwise the run that calls ``repack_state`` itself between two
    runtimes; params and moments pass through the repack untouched."""
    bo, nb, sched_a, lay_a = plan_a
    bo_b, nb_b, _, sched_b, _ = T.plan(tiny, PE_B, 1.8)
    lay_b = build_bucket_layout(tiny.meta, bo_b, nb_b)
    assert nb_b != nb
    swap, n = sched_a.period, sched_a.period + 2 * sched_b.period
    rt = _rt(tiny, plan_a)

    def hook(i, state, m):
        if i == 0:
            rt.prepare_swap(sched_b, layout=lay_b)

    state, losses = _run(tiny, rt, n, hook=hook)
    assert rt.hot_swaps == rt.layout_swaps == 1 and rt.layout == lay_b

    rt_a, rt_b = _rt(tiny, plan_a), _rt(tiny, (bo_b, nb_b, sched_b, lay_b))
    ref, ref_losses = _run(tiny, rt_a, swap)
    params = ref["params"]
    ref = rt_b.repack_state(ref, build_layout_transition(lay_a, lay_b),
                            src_schedule=sched_a)
    assert ref["params"] is params
    assert [c.numel() for c in ref["cur"]] == list(lay_b.buf_sizes)
    for i in range(swap, n):
        ref, m = rt_b.step(i - swap, ref, T.tb(tiny, i))
        ref_losses.append(float(m["loss"]))
    assert losses == ref_losses
    for a, b in zip(tree_leaves((state["params"], state["opt"])),
                    tree_leaves((ref["params"], ref["opt"]))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------
def _spawn_setup(world):
    """The schedule every world size runs (planned for 4 ranks at coverage
    rate 3: period 3, an update of k 3 that does not rotate, a rotation
    without an update), with every other synced bucket moved onto the
    secondary link."""
    cfg = T.port_cfg()
    meta = init_params(cfg, device="meta")
    bo, nb, _, plan = build_schedule(
        meta, cfg, dp=4, seq_len=S, per_device_batch=BATCH // 4,
        partition_elems=PE_A, coverage_rate=3.0)
    sched = plan.schedule
    assert any(p.do_update and not p.rotate and p.update_k > 1
               for p in sched.phases)
    sched = dataclasses.replace(sched, phases=tuple(
        dataclasses.replace(ph, secondary=tuple(
            b % 2 == 0 and ((ph.route_new[b] == "sync" and ph.rotate)
                            or ph.sync_cur[b]) for b in range(nb)))
        for ph in sched.phases))
    return cfg, meta, bo, nb, sched


def _engine_run(world, rank, engine, pod=1, chain=None):
    """Two periods of ``engine`` ("flat", "tree" or "leaf") over this rank's
    slice of the global batch, each step's collectives checked: the final
    params and the losses."""
    cfg, meta, bo, nb, sched = _spawn_setup(world)
    data_group, pod_group = pod_groups(pod)
    lay = build_bucket_layout(meta, bo, nb)
    sizes = [x.numel() for x in tree_leaves(meta)]
    if engine == "leaf":
        fns = make_deft_step_fns(cfg, adamw(LR), sched, bo, group=data_group,
                                 outer_group=pod_group)
        state = init_train_state(cfg, adamw(LR), deft=True, seed=0,
                                 device="cpu")
    else:
        rt = DeftRuntime(cfg, adamw(LR), sched, lay, device="cpu",
                         group=data_group, outer_group=pod_group,
                         secondary_chain=chain,
                         flat_state=engine == "flat")
        state = rt.init_state(seed=0)
    per, losses = BATCH // world, []
    for i in range(2 * sched.period):
        full = make_batch(cfg, 0, i, BATCH, S, device="cpu")
        local = {k: v[rank * per:(rank + 1) * per] for k, v in full.items()}
        if engine == "leaf":
            fn = fns[i % sched.period]
            state, m = fn(state, local)
            assert fn.last_collectives == phase_collectives_per_leaf(
                fn.phase, bo, 2, **(dict(leaf_sizes=sizes, n_data=world // pod)
                                    if pod > 1 else {})), i
        else:
            state, m = rt.step(i, state, local)
            assert rt.last_collectives == rt.collectives_per_phase()[
                i % rt.period], i
        losses.append(float(m["loss"]))
    params = state["params"] if engine == "leaf" else rt.params_tree(state)
    return _leaves(params) + [np.array(losses)]


def _round_trip(world, rank):
    """A tree state after one period over both ranks, moved onto rank 0
    alone and back by ``migrate_state``: every rank's params and moments
    before and after, and the sums of the accumulators' rows."""
    import torch.distributed as dist

    cfg, meta, bo, nb, sched = _spawn_setup(world)
    lay = build_bucket_layout(meta, bo, nb)
    g0 = dist.new_group([0])
    both = DeftRuntime(cfg, adamw(LR), sched, lay, device="cpu",
                       flat_state=False)
    state = both.init_state(seed=0)
    per = BATCH // world
    for i in range(sched.period + 1):          # position 1: fut holds one
        full = make_batch(cfg, 0, i, BATCH, S, device="cpu")
        state, _ = both.step(i, state, {k: v[rank * per:(rank + 1) * per]
                                        for k, v in full.items()})
    before = _leaves((state["params"], state["opt"]))
    acc = [c.clone() for c in state["cur"] + state["fut"]]
    for c in acc:
        dist.all_reduce(c)
    two, one = both.placement(), Placement((0,), g0, lay, False)
    alone = both.spawn(group=g0) if rank == 0 else None
    down = migrate_state(both, alone, state, old=two, new=one)
    assert (down is None) == (rank != 0)
    back_rt = DeftRuntime(cfg, adamw(LR), sched, lay, device="cpu",
                          flat_state=False)
    back = migrate_state(alone, back_rt, down, old=one, new=two)
    after = _leaves((back["params"], back["opt"]))
    sums = [c.clone() for c in back["cur"] + back["fut"]]
    for c in sums:
        dist.all_reduce(c)
    return before + after + [np.array([
        float((a - b).abs().max()) for a, b in zip(acc, sums)])]


def _rank_main(rank, world, port, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        runs = {e: _engine_run(world, rank, e) for e in ("flat", "tree",
                                                         "leaf")}
        if world == 4:
            for e in ("flat", "tree", "leaf"):
                runs[f"pod_{e}"] = _engine_run(world, rank, e, pod=2)
            runs["chain_tree"] = _engine_run(world, rank, "tree",
                                             chain=ring_chain(world, 1))
        else:
            runs["trip"] = _round_trip(world, rank)
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
    for f in sorted(os.listdir(out_dir)):
        name, r = f[:-5], int(f[-5])
        arrs = np.load(os.path.join(out_dir, f))
        out.setdefault(name, {})[r] = [arrs[f"arr_{i}"]
                                       for i in range(len(arrs.files))]
    return {k: [v[r] for r in range(world)] for k, v in out.items()}


_SPAWNED = {}


def _spawned(world, tmp_path_factory):
    if world not in _SPAWNED:
        _SPAWNED[world] = _spawn(
            world, str(tmp_path_factory.mktemp(f"tree{world}")))
    return world, _SPAWNED[world]


@pytest.fixture(scope="module", params=[2, 4])
def spawned(request, tmp_path_factory):
    return _spawned(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawned(2, tmp_path_factory)[1]


def _close(run, ref):
    np.testing.assert_allclose(run[-1], ref[-1], rtol=RTOL, atol=ATOL)
    for a, b in zip(run[:-1], ref[:-1]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_engines_on_gloo_ranks(spawned):
    """The tree engine and the per-leaf steps against the flat engine at
    the same ranks (and at pod 2 x data 2, and the tree engine along a
    chain at 4), every replica bitwise rank 0's."""
    world, runs = spawned
    pairs = [("tree", "flat"), ("leaf", "flat")]
    if world == 4:
        pairs += [("pod_tree", "pod_flat"), ("pod_leaf", "pod_flat"),
                  ("pod_flat", "flat"), ("chain_tree", "tree")]
    for run, ref in pairs:
        for r in range(world):
            _close(runs[run][r], runs[ref][r])
    for name, per_rank in runs.items():
        if name == "trip":
            continue
        for r in range(1, world):
            for a, b in zip(per_rank[r], per_rank[0]):
                assert np.array_equal(a, b), (name, r)


def test_tree_state_migrates_and_returns(two):
    """A tree state moved onto rank 0 alone and back: params and moments
    bitwise on both ranks (rank 1 receives them from rank 0), the
    accumulators' sum over the ranks kept (folded onto rank 0, then its
    row scaled back and rank 1's zero)."""
    for r in range(2):
        res = two["trip"][r]
        half = (len(res) - 1) // 2
        for a, b in zip(res[:half], res[half:2 * half]):
            assert np.array_equal(a, b)
        assert np.all(res[-1] <= 1e-6)
