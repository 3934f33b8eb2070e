"""The port's runtime control surface against the JAX package's
(DESIGN.md §9-§11): ``prepare_swap``, the cycle-boundary install,
``repack_state``, ``spawn`` and the trace, on the tiny qwen3 of
``tests/test_repack.py`` with the same JAX params and numpy batches
(``tests/_torch_tiny.py``).

* A partition hot swap (``prepare_swap(layout=)``) on both engines lands
  at the step JAX's lands, with JAX's ``info``; the run is bitwise the
  port's explicit reference (layout A to the swap step, ``repack_state``,
  a fresh runtime of layout B), and its trace holds JAX's spans (kind,
  name, step, phase, args; times aside).  JAX's same run is within
  ``tests/test_torch_runtime.py``'s atol 1e-4 of the port's run with
  JAX's hand-over (``_torch_tiny.jax_divisors``), not of the port's own:
* After the swap, schedule B's first update (update_k 2) meets the
  one-step generation schedule A (period 1) handed over.  Dividing it by
  2 moves the params; the port divides it by the steps it holds
  (``handover_divisors``), which is bitwise the run that rebuilds B from
  the same state with that generation counted twice, and JAX, which
  divides by 2, is held to the port run that does so too.
* A precision-only layout change re-packs by aliasing: every destination
  bucket is its source tensor.
* ``background=True`` arms only once built; a failing build is logged
  (``swap-compile-failed``), retried, then abandoned with the old
  schedule stepping on; a newer ``prepare_swap`` supersedes an older one.
* ``spawn``: overrides, the inherited ``decoupled`` dying with the sharded
  engine, and illegal combinations raising.

The adaptive loops are in ``tests/test_torch_adapt.py``, the sharded swap
across gloo ranks in ``tests/test_torch_swap_ranks.py``.
"""
import json
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
import _torch_tiny as T
from repro.obs import Tracer as JTracer
from repro.optim.optimizers import adamw as jax_adamw
from repro.train import DeftRuntime as JRuntime
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch.train import (
    init_distributed,
    restore_runtime_state,
    save_checkpoint,
)
from repro_torch.obs import Tracer
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import (
    build_bucket_layout,
    build_layout_transition,
)
from repro_torch.tree import tree_leaves
from repro_torch.train.runtime import DeftRuntime, handover_divisors


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


@pytest.fixture(scope="module")
def tiny():
    return T.make_tiny()


INFO_KEYS = ("new_phases", "reused_phases", "layout_change", "n_buckets",
             "shards", "moved_elems")


@pytest.mark.parametrize("fsdp", [False, True],
                         ids=["replicated", "sharded-rs"])
def test_partition_hot_swap_bitwise(group, tiny, single_mesh, fsdp):
    bo_a, nb_a, _, sched_a, _ = T.plan(tiny, 20_000)
    bo_b, nb_b, _, sched_b, _ = T.plan(tiny, 60_000)
    assert bo_a != bo_b
    jl_a, lay_a = T.layouts(tiny, bo_a, nb_a)
    jl_b, lay_b = T.layouts(tiny, bo_b, nb_b)
    n_steps = 2 * sched_a.period + 2 * sched_b.period
    at = sched_a.period + 1

    jrt = JRuntime(tiny.cfg, jax_adamw(T.LR), sched_a, jl_a, single_mesh,
                   fsdp=fsdp, tracer=JTracer())
    jinfo = {}

    def jhook(i, state, m):
        if i == at - 1:
            jinfo.update(jrt.prepare_swap(sched_b, state, T.jb(tiny, 0),
                                          layout=jl_b))
    jfinal = T.jax_run(tiny, jrt, n_steps, single_mesh, jhook)

    def port_swap():
        rt = DeftRuntime(tiny.tcfg, adamw(T.LR), sched_a, lay_a,
                         device="cpu", fsdp=fsdp, tracer=Tracer())
        info = {}

        def hook(i, state):
            if i == at - 1:
                info.update(rt.prepare_swap(sched_b, layout=lay_b))
        return (rt, info, *T.port_run(tiny, rt, n_steps, hook))

    rt, info, state, losses = port_swap()
    assert {k: info[k] for k in INFO_KEYS} == {k: jinfo[k] for k in INFO_KEYS}
    assert rt.layout_swaps == 1 and rt.layout == lay_b
    swap = rt.swap_log[0]
    assert swap["step"] == jrt.swap_log[0]["step"]
    assert swap["step"] % sched_a.period == 0
    assert swap["repack_s"] is not None and swap["repack_s"] > 0
    assert [k for k in state] == [k for k in rt.state_from_params(
        tiny.params)]
    with T.jax_divisors():
        rt_j, _, state_j, _ = port_swap()
    T.near_jax(rt_j, state_j, jfinal)
    # every step's and every control-plane span, as JAX records them
    assert T.span_rows(rt.tracer) == T.span_rows(jrt.tracer)
    T.bitwise((rt, state, losses),
             T.reference(tiny, sched_a, lay_a, sched_b, lay_b, swap["step"],
                        n_steps, fsdp))


def test_swap_first_update_applies_the_generation_mean(group, tiny,
                                                       single_mesh):
    bo_a, nb_a, _, sched_a, _ = T.plan(tiny, 20_000)
    bo_b, nb_b, _, sched_b, _ = T.plan(tiny, 60_000)
    jl_a, lay_a = T.layouts(tiny, bo_a, nb_a)
    jl_b, lay_b = T.layouts(tiny, bo_b, nb_b)
    # A updates every step from the one-step generation before it; B's
    # first update (its position 1) applies cur with update_k 2, and cur
    # holds the one-step generation A left at the boundary
    assert sched_a.period == 1 and sched_a.phases[0].update_k == 1
    upd = sched_b.phases[1]
    assert sched_b.period == 2 and not sched_b.phases[0].do_update
    assert upd.do_update and upd.update_source == "cur" and upd.update_k == 2
    assert handover_divisors(sched_a, sched_b) == [None, 1]
    swap, n_steps = 2, 2 + 2 * sched_b.period

    def port_swap():
        rt = DeftRuntime(tiny.tcfg, adamw(T.LR), sched_a, lay_a,
                         device="cpu")

        def hook(i, state):
            if i == swap - 1:
                rt.prepare_swap(sched_b, layout=lay_b)
        state, _ = T.port_run(tiny, rt, n_steps, hook)
        assert rt.swap_log[0]["step"] == swap
        return [p.clone() for p in tree_leaves(rt.params_tree(state))]

    got = port_swap()
    with T.jax_divisors():
        halved = port_swap()
    # the run rebuilt on B from the same state, the handed-over generation
    # counted as B's two steps: B's own update then applies its mean
    rt_a = DeftRuntime(tiny.tcfg, adamw(T.LR), sched_a, lay_a, device="cpu")
    rt_b = DeftRuntime(tiny.tcfg, adamw(T.LR), sched_b, lay_b, device="cpu")
    state = rt_a.state_from_params(tiny.params)
    for i in range(n_steps):
        if i == swap:
            state = rt_b.repack_state(state,
                                      build_layout_transition(lay_a, lay_b))
            for c in state["cur"]:
                c.mul_(2.0)
        rt, at = (rt_a, i) if i < swap else (rt_b, i - swap)
        state, _ = rt.step(at, state, T.tb(tiny, i))
    rebuilt = tree_leaves(rt_b.params_tree(state))
    assert all(torch.equal(a, b) for a, b in zip(got, rebuilt))
    moved = max((a - b).abs().max().item() for a, b in zip(got, halved))
    assert moved > 1e-5, moved

    # JAX divides by update_k: its run is the halved one, not the port's
    jrt = JRuntime(tiny.cfg, jax_adamw(T.LR), sched_a, jl_a, single_mesh)

    def jhook(i, state, m):
        if i == swap - 1:
            jrt.prepare_swap(sched_b, state, T.jb(tiny, 0), layout=jl_b)
    jfinal = jax.tree.leaves(T.jax_run(tiny, jrt, n_steps, single_mesh,
                                       jhook))
    near = lambda ours: max(float(np.abs(a.numpy() - b).max())
                            for a, b in zip(ours, jfinal))
    assert near(halved) <= T.ATOL < near(got), (near(halved), near(got))


def test_resume_inside_the_handover_keeps_its_divisors(group, tiny,
                                                       tmp_path):
    """A checkpoint taken inside B's first cycle after the swap, while the
    hand-over still owes B's first update its divisor 1, carries it in the
    sidecar; a runtime built on B and resumed there mid-cycle is bitwise
    the uninterrupted run.  Without the key its first update divides by
    update_k 2 and the run departs."""
    bo_a, nb_a, _, sched_a, _ = T.plan(tiny, 20_000)
    bo_b, nb_b, _, sched_b, _ = T.plan(tiny, 60_000)
    _, lay_a = T.layouts(tiny, bo_a, nb_a)
    _, lay_b = T.layouts(tiny, bo_b, nb_b)
    swap, save_at, n_steps = 2, 3, 2 + 2 * sched_b.period
    ckpt = tmp_path / "ckpt"
    rt = DeftRuntime(tiny.tcfg, adamw(T.LR), sched_a, lay_a, device="cpu")

    def hook(i, state):
        if i == swap - 1:
            rt.prepare_swap(sched_b, layout=lay_b)
        if i + 1 == save_at:
            assert rt.pending_divisors == [1]
            save_checkpoint(str(ckpt), save_at, rt, state)
    state, _ = T.port_run(tiny, rt, n_steps, hook)
    whole = tree_leaves(rt.params_tree(state))
    with open(ckpt / f"layout_{save_at:08d}.json") as f:
        side = json.load(f)
    assert side["handover_divisors"] == [1]
    assert side["next_phase"] == 1

    def resumed(directory):
        rt_b = DeftRuntime(tiny.tcfg, adamw(T.LR), sched_b, lay_b,
                           device="cpu")
        st, start = restore_runtime_state(rt_b, str(directory), tiny.meta,
                                          log=lambda s: None)
        assert start == save_at and rt_b.phase_in_cycle(start) == 1
        for i in range(start, n_steps):
            st, _ = rt_b.step(i, st, T.tb(tiny, i))
        return tree_leaves(rt_b.params_tree(st))

    assert all(torch.equal(a, b) for a, b in zip(resumed(ckpt), whole))
    # the same checkpoint without the key: B's first update halves the
    # handed-over generation
    bare = tmp_path / "bare"
    shutil.copytree(ckpt, bare)
    del side["handover_divisors"]
    with open(bare / f"layout_{save_at:08d}.json", "w") as f:
        json.dump(side, f)
    assert not all(torch.equal(a, b) for a, b in zip(resumed(bare), whole))


def test_precision_only_swap_aliases(group, tiny):
    """A layout change of wire precision alone moves no element: every
    destination bucket of the repack is its source tensor, and the
    installed swap keeps the resident buffers and reprices the wire."""
    bo, nb, _, sched, _ = T.plan(tiny, 20_000)
    lay = build_bucket_layout(tiny.meta, bo, nb)
    lay8 = lay.with_precision(PrecisionPolicy(wire=("int8",) * nb))
    tr = build_layout_transition(lay, lay8)
    assert all(tr.identical) and tr.moved_elems == 0
    rt = DeftRuntime(tiny.tcfg, adamw(T.LR), sched, lay, device="cpu",
                     tracer=Tracer())
    state, _ = T.port_run(tiny, rt, sched.period)
    before = {k: state[k] for k in ("pbuf", "cur", "fut")}
    before.update(m=state["opt"]["m"], v=state["opt"]["v"])
    out = rt.spawn(layout=lay8).repack_state(state, tr)
    after = {k: out[k] for k in ("pbuf", "cur", "fut")}
    after.update(m=out["opt"]["m"], v=out["opt"]["v"])
    for k in before:
        assert all(a is b for a, b in zip(after[k], before[k])), k

    info = rt.prepare_swap(sched, layout=lay8)
    assert info["layout_change"] and info["moved_elems"] == 0
    pbuf = out["pbuf"]
    out, _ = rt.step(sched.period, out, T.tb(tiny, 0))
    assert all(a is b for a, b in zip(out["pbuf"], pbuf))
    assert rt.layout_swaps == 1 and rt.layout == lay8
    spans = rt.tracer.spans("collective-group")
    assert spans[-1].args["precision"] == f"int8x{nb}"
    assert spans[-1].args["wire_bytes"] == rt.wire_bytes_per_phase[0] > 0


def test_background_swap_arms_only_when_built(group, tiny, monkeypatch):
    bo, nb, _, sched, _ = T.plan(tiny, 20_000)
    lay = build_bucket_layout(tiny.meta, bo, nb)
    bo_b, nb_b, _, sched_b, _ = T.plan(tiny, 60_000)
    lay_b = build_bucket_layout(tiny.meta, bo_b, nb_b)
    p = sched.period
    rt = DeftRuntime(tiny.tcfg, adamw(T.LR), sched, lay, device="cpu")
    state = rt.state_from_params(tiny.params)
    step = iter(range(100))

    def run(n):
        nonlocal state
        for _ in range(n):
            i = next(step)
            state, _ = rt.step(i, state, T.tb(tiny, i))

    # a build held back: boundaries pass on the old schedule until it arms
    stage, release = rt._stage, threading.Event()

    def held(*a):
        assert release.wait(timeout=30)
        return stage(*a)
    monkeypatch.setattr(rt, "_stage", held)
    rt.prepare_swap(sched_b, layout=lay_b, background=True)
    run(2 * p + 1)
    assert not rt.swap_ready() and rt.hot_swaps == 0 and rt.layout == lay
    release.set()
    assert rt.wait_swap_ready(timeout=30)
    run(p)
    assert rt.hot_swaps == 1 and rt.layout == lay_b
    assert rt.swap_log[-1]["step"] == 3 * p

    # a build that keeps failing: logged, retried, abandoned; the
    # installed schedule keeps stepping
    def broken(*a):
        raise RuntimeError("nvcc failed for quantize")
    monkeypatch.setattr(rt, "_stage", broken)
    info = rt.prepare_swap(sched, layout=lay, background=True,
                           retries=2, retry_backoff_s=0.0)
    assert not rt.wait_swap_ready(timeout=30)
    assert info["abandoned"] and info["compile_attempts"] == 3
    log = rt.swap_log
    assert [e["event"] for e in log[-4:]] == ["swap-compile-failed"] * 3 \
        + ["swap-abandoned"]
    assert [e["retrying"] for e in log[-4:-1]] == [True, True, False]
    assert rt.swap_failures == 3
    assert rt.last_swap_error == "RuntimeError: nvcc failed for quantize"
    run(2 * sched_b.period)
    assert rt.hot_swaps == 1 and rt.layout == lay_b

    # a newer prepare_swap supersedes an older one still building
    release.clear()
    monkeypatch.setattr(rt, "_stage", held)
    rt.prepare_swap(sched, layout=lay, background=True)
    older = rt._swap_thread
    monkeypatch.setattr(rt, "_stage", stage)
    rt.prepare_swap(sched_b)          # same layout, built now
    release.set()
    older.join(timeout=30)
    assert not older.is_alive()
    assert rt._pending.layout is None and rt._pending.schedule == sched_b
    run(sched_b.period)
    assert rt.hot_swaps == 2 and rt.layout == lay_b and rt.replans == 4


def test_spawn(group, tiny):
    bo, nb, _, sched, _ = T.plan(tiny, 20_000)
    bo_b, nb_b, _, sched_b, _ = T.plan(tiny, 60_000)
    lay = build_bucket_layout(tiny.meta, bo, nb)
    lay_b = build_bucket_layout(tiny.meta, bo_b, nb_b)
    tracer = Tracer()
    rt = DeftRuntime(tiny.tcfg, adamw(T.LR), sched, lay, device="cpu",
                     fsdp=True, decoupled=True, loss_chunk=16, tracer=tracer)
    sib = rt.spawn(schedule=sched_b, layout=lay_b)
    assert (sib.schedule, sib.layout) == (sched_b, lay_b)
    assert sib.fsdp and sib.decoupled and sib.loss_chunk == 16
    assert sib.tracer is tracer and sib.trace_steps
    # the inherited decoupled flag dies with the sharded engine
    rep = rt.spawn(fsdp=False)
    assert not rep.fsdp and not rep.decoupled and not rep.gather_skip
    assert rt.spawn(gather_skip=False).gather_skip is False
    assert rt.spawn(tracer=Tracer()).tracer is not tracer
    untraced = DeftRuntime(tiny.tcfg, adamw(T.LR), sched, lay, device="cpu")
    assert not untraced.spawn().trace_steps
    assert untraced.spawn().tracer is not untraced.tracer
    # illegal combinations raise in the sibling's constructor
    with pytest.raises(ValueError, match="decoupled AG streaming"):
        rt.spawn(fsdp=False, decoupled=True)
    with pytest.raises(ValueError, match="gather_skip"):
        rt.spawn(fsdp=False, gather_skip=True)
    with pytest.raises(ValueError, match="shard_count=2"):
        rt.spawn(layout=build_bucket_layout(tiny.meta, bo, nb,
                                            shard_count=2))
    with pytest.raises(ValueError, match="disagreement"):
        rt.spawn(layout=lay.with_precision(PrecisionPolicy(
            wire=("f32",) * nb, master="bf16sr")))
    # and so does a swap or a repack across shard counts
    with pytest.raises(ValueError, match="shard_count"):
        rt.prepare_swap(sched, layout=build_bucket_layout(
            tiny.meta, bo, nb, shard_count=2))
    with pytest.raises(ValueError, match="shard count"):
        rt.repack_state({}, build_layout_transition(
            build_bucket_layout(tiny.meta, bo, nb, shard_count=2), lay))
