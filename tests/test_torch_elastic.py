"""The port's elastic control plane (``repro_torch.elastic``) against the
JAX package's (DESIGN.md §10), in one process.

* ``fold_accum_rows`` bitwise JAX's on the same numpy rows at (4, 2),
  (4, 3), (2, 4), (3, 4) and (4, 1) (XLA's ``segment_sum`` sums each
  segment from zero in ascending row order, as the port does), keeping
  the global mean (JAX's own check, 1e-6).
* The copied controller's degradation ladder at widths 4, 3, 2, 1 and 0:
  every ``ElasticPlan.describe()`` (solve time aside) and schedule digest
  equal JAX's.
* The coordinator's bookkeeping on JAX's ``_StubRuntime`` event sequences
  (cascading faults, a capacity return merging with an armed plan,
  straggler recovery) through both packages' coordinators: ``log``,
  ``members``, ``spares``, ``_returning``, ``_out_reason``,
  ``_pending_members``, the armed plans and every trace instant equal;
  the refusals (a pod layout; a survivor count that does not split the
  global batch, when its plan runs).
* The monitor's clock once every shard is silent: JAX's stands still (its
  launcher never declares the last shards dead), the port's launcher
  advances it by the step's wall.
* Engine fallback at one rank (JAX's
  ``test_engine_fallback_migration_matches_reference``): the sharded
  engine's state ``migrate_state``-d onto ``spawn(fsdp=False)`` is bitwise
  a replicated runtime rebuilt from its ``state_to_tree`` snapshot over
  the next steps, and within JAX's atol 1e-5 of JAX's same run.
* The launcher's halt at one rank: the only shard dropped, or a
  SIGUSR1, writes the emergency checkpoint and stops the run, and the
  resume finishes it bitwise the uninterrupted run.
* The copied ``truncate_checkpoint`` on the port's files: the torn step
  is skipped and the one before restores.
* Halt at one rank (JAX's ``test_coordinator_halt_emergency_checkpoint_
  and_resume``): a preemption of the only shard writes the emergency
  checkpoint and raises ``ElasticHalt``; JAX's coordinator halting on the
  same state writes the same files byte for byte, each package restores
  the other's bitwise, and the port's resume is bitwise the
  uninterrupted run.
"""
import dataclasses
import json
import os
import re
import signal
import zipfile
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
import _torch_tiny as T
from repro.checkpoint import checkpoint as jckpt
from repro.core.preserver import WalkParams as JWalk
from repro.core.profiler import HardwareModel as JHardwareModel
from repro.elastic import ElasticController as JController
from repro.elastic import ElasticCoordinator as JCoordinator
from repro.elastic import ElasticHalt as JHalt
from repro.elastic import HealthConfig as JHealthConfig
from repro.elastic import HealthMonitor as JMonitor
from repro.elastic import fold_accum_rows as jax_fold
from repro.elastic import migrate_state as jax_migrate
from repro.launch.train import restore_runtime_state as jax_restore
from repro.optim.optimizers import adamw as jax_adamw
from repro.train import DeftRuntime as JRuntime
from repro.train import assign_buckets as jax_assign
from repro.train import build_leaf_time_model as jax_leaf_model
from repro_torch.checkpoint import (
    latest_step,
    restore,
    save,
    schedule_digest,
    valid_steps,
)
from repro_torch.checkpoint.checkpoint import load_arrays
from repro_torch.core.profiler import HardwareModel
from repro_torch.elastic import (
    ElasticController,
    ElasticCoordinator,
    ElasticHalt,
    HealthConfig,
    HealthMonitor,
    fold_accum_rows,
    migrate_state,
    truncate_checkpoint,
)
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.launch.train import (
    init_distributed,
    restore_runtime_state,
    train,
)
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import assign_buckets, build_leaf_time_model
from repro_torch.train.runtime import DeftRuntime
from repro_torch.tree import tree_leaves

JWALK = JWalk(s0=4.0, eta=0.01, mu=1.0, sigma=40.0, batch=256)


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


@pytest.fixture(scope="module")
def tiny():
    return T.make_tiny()


# ---------------------------------------------------------------------------
# fold_accum_rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_old,n_new", [(4, 2), (4, 3), (2, 4), (3, 4),
                                         (4, 1)])
def test_fold_accum_rows_matches_jax(n_old, n_new):
    rows = np.random.RandomState(n_old * 10 + n_new).randn(
        n_old, 33).astype(np.float32)
    want = np.asarray(jax_fold(jnp.asarray(rows), n_new))
    got = fold_accum_rows(torch.from_numpy(rows), n_new)
    assert got.shape == (n_new, 33)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(got.numpy().sum(0) / n_new,
                               rows.sum(0) / n_old, rtol=0, atol=1e-6)
    x = torch.from_numpy(rows)
    assert fold_accum_rows(x, n_old) is x        # width unchanged: no-op


# ---------------------------------------------------------------------------
# The controller's ladder
# ---------------------------------------------------------------------------
def _controllers(t, pe=20_000):
    """(JAX's, the port's) controller of ``tests/test_elastic.py``'s
    ``_controller`` on the tiny qwen3."""
    jbo, jnb = jax_assign(t.jparams, t.cfg, partition_elems=pe)
    bo, nb = assign_buckets(t.meta, t.tcfg, partition_elems=pe)
    assert (bo, nb) == (jbo, jnb)

    def jmodel(width):
        return jax_leaf_model(t.jparams, t.cfg, JHardwareModel(dp_degree=width),
                              T.S, max(T.B // width, 1)
                              ).with_coverage_rate(bo, nb, 1.8)

    def tmodel(width):
        return build_leaf_time_model(t.meta, t.tcfg,
                                     HardwareModel(dp_degree=width), T.S,
                                     max(T.B // width, 1)
                                     ).with_coverage_rate(bo, nb, 1.8)

    return (JController(jmodel, bo, nb, walk=JWALK),
            ElasticController(tmodel, bo, nb, walk=T.WALK))


def _describe(plan):
    return None if plan is None else re.sub(r"\(\d+ ms\)", "",
                                            plan.describe())


def test_controller_ladder_matches_jax(tiny):
    jctrl, ctrl = _controllers(tiny)
    ladder = [(10, 4, "scale-up"), (11, 3, "straggler"), (12, 2, "dead"),
              (13, 1, "dead"), (14, 0, "preemption")]
    for step, width, trigger in ladder:
        jp, p = jctrl.propose(step, width, trigger), \
            ctrl.propose(step, width, trigger)
        assert _describe(p) == _describe(jp)
        assert (p.action, p.sharded, p.n_shards, p.bucket_of, p.n_buckets) \
            == (jp.action, jp.sharded, jp.n_shards, jp.bucket_of,
                jp.n_buckets)
        if width:
            assert schedule_digest(p.schedule) == \
                jckpt.schedule_digest(jp.schedule)
        if width == 2:
            jctrl.adopt(jp)
            ctrl.adopt(p)
    assert [x.action for x in ctrl.plans] == [
        "scale-up", "scale-down", "scale-down", "fallback-replicated",
        "checkpoint-halt"]


# ---------------------------------------------------------------------------
# The coordinator's bookkeeping (planning only: no boundary is ever hit)
# ---------------------------------------------------------------------------
class _JStubMesh:
    axis_names = ("data", "model")

    def __init__(self, n):
        self.devices = np.empty((n, 1), dtype=object)


class _JStub:
    """JAX's ``_StubRuntime``: phase_in_cycle never hits a boundary."""

    flat_state = True

    def __init__(self, n):
        self.mesh = _JStubMesh(n)

    def phase_in_cycle(self, i):
        return 1


class _Stub:
    """The port's stand-in: ``n`` ranks of one 'data' group, this process
    at position 0, never on a cycle boundary."""

    secondary_chain = None
    layout = None
    fsdp = True
    period = 1

    def __init__(self, n, outer=None, position=1):
        self.dp = SimpleNamespace(size=n, rank=0, group=None, outer=outer)
        self.position = position

    def phase_in_cycle(self, i):
        return self.position


def _coordinators(t, hc=None, n=4, global_batch=0):
    jctrl, ctrl = _controllers(t)
    jhc = None if hc is None else JHealthConfig(**dataclasses.asdict(hc))
    return (JCoordinator(_JStub(n), jctrl, JMonitor(n, jhc),
                         params_abs=t.jparams),
            ElasticCoordinator(_Stub(n), ctrl, HealthMonitor(n, hc),
                               params_abs=t.meta, global_batch=global_batch))


def _view(c):
    """What the two coordinators must agree on (times aside)."""
    return dict(
        members=list(c.members), spares=list(c.spares),
        returning=list(c._returning), out_reason=dict(c._out_reason),
        pending_members=list(c._pending_members),
        pending=_describe(c._pending), halt=_describe(c._halt),
        log=list(c.log),
        events=[dataclasses.astuple(e) for e in c.fault_events],
        trace=[(sp.kind, sp.name, sp.step, sp.args)
               for sp in c.tracer.spans()])


def _cascade(c):
    c.notice_preemption(5, [3])
    yield
    c.notice_preemption(6, [2])
    yield
    c.notice_preemption(7, [3])      # already planned out: nothing changes
    yield


def _capacity(c):
    c.notice_preemption(5, [3])
    c.notice_preemption(6, [2])
    yield
    c.notice_capacity(7, [3])        # 3's removal cancels, 2's stays armed
    yield
    c.notice_capacity(8, [2])        # full cancellation: disarm
    yield


def _straggler(c):
    for step in range(40):
        c.observe(step, [1.0, 1.0, 4.0 if step < 12 else 1.0, 1.0])
        yield
    c.notice_capacity(40, [2])       # already restored: a no-op
    yield


STRAGGLER_HC = HealthConfig(warmup_steps=1, straggler_ratio=1.5,
                            straggler_patience=2, recovered_ratio=1.3,
                            recovered_patience=2)


@pytest.mark.parametrize("case,hc", [(_cascade, None), (_capacity, None),
                                     (_straggler, STRAGGLER_HC)],
                         ids=["cascade", "capacity", "straggler"])
def test_coordinator_bookkeeping_matches_jax(tiny, case, hc):
    jc, c = _coordinators(tiny, hc)
    n = 0
    for _ in zip(case(jc), case(c)):
        assert _view(c) == _view(jc), f"after event {n}"
        n += 1
    if case is _cascade:
        assert c._pending_members == [0, 1] and sorted(c.spares) == [2, 3]
    elif case is _capacity:
        assert c._pending is None and c.members == [0, 1, 2, 3]
        assert [sp.name for sp in c.tracer.spans()][-1] == "disarm"
    else:
        names = [sp.name for sp in c.tracer.spans()]
        assert "detect-straggler" in names and "detect-recovered" in names
        assert "arm-scale-down" in names and names[-1] == "disarm"
        assert c.spares == [] and c._out_reason == {}


def test_coordinator_refusals(tiny):
    _, ctrl = _controllers(tiny)
    with pytest.raises(ValueError, match="pod"):
        ElasticCoordinator(_Stub(4, outer=object()), ctrl, HealthMonitor(4),
                           params_abs=tiny.meta)
    # a survivor count that does not split the global batch is refused
    # when its plan runs, before anything moves, by the halt path (the
    # emergency checkpoint, then ElasticHalt); an armed plan that a later
    # event re-arms is not (JAX's cascade passes through 3 of 4)
    _, c = _coordinators(tiny, global_batch=4)
    c.notice_preemption(5, [3])
    assert c._pending.n_shards == 3
    c.runtime.position = 0                          # a cycle boundary
    c.checkpoint_dir = "ckpt"
    saved = []
    c.emergency_checkpoint = lambda i, state: saved.append(i) or "ckpt/6"
    with pytest.raises(ElasticHalt, match=r"3 surviving shards do not split "
                                          r"the global batch 4 \(checkpoint: "
                                          r"ckpt/6\)"):
        c.maybe_migrate(6, None)
    assert saved == [6] and c.members == [0, 1, 2, 3]
    assert c._pending is None and c._halt is None
    assert c.log[-1]["action"] == "checkpoint-halt"
    assert c.log[-1]["checkpoint"] == "ckpt/6"
    assert c.tracer.spans()[-1].name == "checkpoint-halt"


def test_silent_world_needs_the_launchers_clock():
    """JAX's launcher feeds the monitor no clock, and the monitor's own
    advances by the slowest LIVE wall: once every shard is silent it
    stands still, so JAX's launcher never declares its last shards dead
    (ROADMAP §3).  The port's launcher passes a clock that advances by the
    step's wall when no shard is live; on the same walls it declares the
    shard dead and, the copied monitor being JAX's, both monitors agree
    while any shard lives."""
    walls = [[0.0625] if s < 6 else [None] for s in range(40)]
    jmon, mon = JMonitor(1), HealthMonitor(1)
    clock, dead = 0.0, []
    for step, w in enumerate(walls):
        assert jmon.observe(step, w) == [] or step < 6
        live = [x for x in w if x is not None]
        clock += max(live, default=0.0625)
        dead += [e for e in mon.observe(step, w, now=clock)
                 if e.kind == "dead"]
        if step < 6:
            assert mon.stats() == jmon.stats()
    assert jmon.alive_shards() == [0] and jmon.events == []
    # silent from step 6: 9 walls of 1/16 s exceed the timeout, 8 x 1/16
    assert [(e.step, e.shard) for e in dead] == [(14, 0)]


# ---------------------------------------------------------------------------
# Engine fallback at one rank
# ---------------------------------------------------------------------------
def test_engine_fallback_migration(group, tiny, single_mesh):
    """Sharded -> replicated at a cycle boundary (period 2 at coverage
    rate 3.5, as JAX's test): the port bitwise its rebuilt reference, and
    within JAX's atol 1e-5 of JAX's same migration."""
    t = tiny
    bo, nb, _, sched, _ = T.plan(t, 20_000, cr=3.5)
    jlay, lay = T.layouts(t, bo, nb)
    k = 2 * sched.period
    rt_a = DeftRuntime(t.tcfg, adamw(T.LR), sched, lay, device="cpu",
                       fsdp=True)
    state = rt_a.state_from_params(t.params)
    for i in range(k):
        state, _ = rt_a.step(i, state, T.tb(t, i))
    snap = rt_a.state_to_tree(state)         # host copies
    rt_b = rt_a.spawn(fsdp=False)
    assert not rt_b.fsdp and rt_b.layout == rt_a.layout
    state_b = migrate_state(rt_a, rt_b, state)
    assert "pgather" not in state_b
    rt_b.reset_cycle(k)
    rt_r = DeftRuntime(t.tcfg, adamw(T.LR), sched, lay, device="cpu")
    state_r = rt_r.tree_to_state(snap)
    rt_r.reset_cycle(k)
    losses, losses_r = [], []
    for i in range(k, 2 * k):
        state_b, m = rt_b.step(i, state_b, T.tb(t, i))
        losses.append(float(m["loss"]))
        state_r, m = rt_r.step(i, state_r, T.tb(t, i))
        losses_r.append(float(m["loss"]))
    assert losses == losses_r
    params = [p.numpy() for p in tree_leaves(rt_b.params_tree(state_b))]
    for a, b in zip(params, tree_leaves(rt_r.params_tree(state_r))):
        assert np.array_equal(a, b.numpy())

    # JAX's test, on the same params and batches
    with jax.set_mesh(single_mesh):
        ja = JRuntime(t.cfg, jax_adamw(T.LR), sched, jlay, single_mesh,
                      fsdp=True)
        js = ja.init_state(t.key)
        for i in range(k):
            js, _ = ja.step(i, js, T.jb(t, i))
        jb_ = ja.spawn(fsdp=False)
        js = jax_migrate(ja, jb_, js)
        jb_.reset_cycle(k)
        jlosses = []
        for i in range(k, 2 * k):
            js, m = jb_.step(i, js, T.jb(t, i))
            jlosses.append(float(m["loss"]))
        jparams = jax.tree.leaves(jb_.params_tree(js))
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Halt, emergency checkpoint and resume at one rank
# ---------------------------------------------------------------------------
def test_truncate_checkpoint_on_port_files(tmp_path):
    """The copied ``KillMidCheckpoint`` damage on the port's own files:
    the truncated newest step no longer counts, the one before resumes
    (JAX's ``test_truncated_newest_checkpoint_resume_picks_previous``)."""
    d = str(tmp_path)
    tree = lambda seed: {"w": torch.from_numpy(
        np.random.RandomState(seed).randn(5, 3).astype(np.float32))}
    save(d, 5, tree(5))
    save(d, 9, tree(9))
    assert latest_step(d) == 9
    path = truncate_checkpoint(d, 9)
    assert path == str(tmp_path / "ckpt_00000009.npz")
    assert valid_steps(d) == [5] and latest_step(d) == 5
    got = restore(d, 5, tree(0), device="cpu")
    assert torch.equal(got["w"], tree(5)["w"])


@pytest.mark.parametrize("cause", ["drop", "signal"])
def test_launcher_halts_and_resumes(group, tmp_path, cause):
    """``train(elastic=True)`` at one rank, smoke qwen3 on the sharded
    engine: dropping shard 0, the only one, halts the run with the
    emergency checkpoint once the monitor declares it dead (its clock
    advancing by the measured walls); a SIGUSR1 goes through the same
    ``emergency_checkpoint``.  The resume from it finishes the run
    bitwise the uninterrupted one."""
    cfg = t_reduce(t_get_config("qwen3-4b"))
    # the monitor's step EMA starts after its 3 warm-up steps; a drop at
    # step 10 gives it 7 walls, and 40 steps leave about 20 to detect in
    d, n, drop = str(tmp_path), 40, 10
    kw = dict(device="cpu", batch=2, seq=32, fsdp=True, elastic=True,
              log=lambda s: None)
    whole = train(cfg, steps=n, **kw)

    def preempt(step, *_):
        if cause == "signal" and step == 5:
            os.kill(os.getpid(), signal.SIGUSR1)

    logs = []
    cut = train(cfg, steps=n, ckpt=d, on_step=preempt,
                elastic_drop_step=drop if cause == "drop" else 0,
                **dict(kw, log=logs.append))
    at = len(cut["losses"])
    assert cut["halted"] and valid_steps(d) == [at]
    if cause == "drop":
        halt = cut["elastic"].log[-1]
        assert halt["action"] == "checkpoint-halt"
        assert halt["trigger"] == "dead"
        assert drop < halt["detected_step"] < at
        assert halt["step"] == at and halt["checkpoint"].endswith(
            f"ckpt_{at:08d}.npz")
        assert f"elastic: elastic halt at step {at} (checkpoint: " \
            f"{halt['checkpoint']})" in logs
    else:
        assert at == 6 and cut["elastic"].log == []
        assert f"preemption signal {int(signal.SIGUSR1)}: checkpointing " \
            f"and exiting cleanly" in logs
    rest = train(cfg, steps=n - at, ckpt=d, resume=True, **kw)
    assert rest["start_step"] == at
    assert cut["losses"] + rest["losses"] == whole["losses"]
    for a, b in zip(rest["state"]["pbuf"], whole["state"]["pbuf"]):
        assert torch.equal(a, b)


def _jax_tree(jr, arrays):
    """JAX arrays for ``jr.checkpoint_struct()`` from an npz's arrays."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(
        jr.checkpoint_struct())
    leaves = []
    for path, _ in paths:
        a = arrays["/".join(jckpt._path_str(p) for p in path)]
        if a.dtype == np.dtype("V2"):
            a = a.view(np.int16).view(ml_dtypes.bfloat16)
        leaves.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _sidecars(d, step):
    with open(d / f"ckpt_{step:08d}.json") as f:
        meta = json.load(f)
    meta.pop("treedef")
    with open(d / f"layout_{step:08d}.json") as f:
        return meta, json.load(f)


def test_halt_emergency_checkpoint_and_resume(group, tiny, single_mesh,
                                              tmp_path):
    t = tiny
    bo, nb, _, sched, _ = T.plan(t, 20_000)
    jlay, lay = T.layouts(t, bo, nb)
    jctrl, ctrl = _controllers(t)
    n_steps, halt = 7, 3
    whole_rt = DeftRuntime(t.tcfg, adamw(T.LR), sched, lay, device="cpu")
    wstate, whole = T.port_run(t, whole_rt, n_steps)
    whole_params = tree_leaves(whole_rt.params_tree(wstate))

    d = tmp_path / "port"
    rt = DeftRuntime(t.tcfg, adamw(T.LR), sched, lay, device="cpu")
    coord = ElasticCoordinator(rt, ctrl, HealthMonitor(1), params_abs=t.meta,
                               checkpoint_dir=str(d))
    state = rt.state_from_params(t.params)
    losses = []
    for i in range(halt):
        state, m = coord.step(i, state, T.tb(t, i))
        losses.append(float(m["loss"]))
    events = coord.notice_preemption(halt, [0])
    assert [e.kind for e in events] == ["preemption"]
    with pytest.raises(ElasticHalt) as err:
        coord.step(halt, state, T.tb(t, halt))
    assert err.value.step == halt and err.value.checkpoint_path == str(
        d / f"ckpt_{halt:08d}.npz")
    assert coord.log[-1]["action"] == "checkpoint-halt"
    assert [sp.name for sp in coord.tracer.spans("elastic")] == [
        "detect-preemption", "arm-checkpoint-halt", "checkpoint-halt"]
    assert latest_step(str(d)) == halt
    arrays = load_arrays(str(d), halt)

    # JAX's coordinator halting on the same state writes the same files
    jd = tmp_path / "jax"
    with jax.set_mesh(single_mesh):
        jr = JRuntime(t.cfg, jax_adamw(T.LR), sched, jlay, single_mesh)
        jstate = jr.tree_to_state(_jax_tree(jr, arrays))
        jcoord = JCoordinator(jr, jctrl, JMonitor(1), params_abs=t.jparams,
                              checkpoint_dir=str(jd))
        jcoord.notice_preemption(halt, [0])
        with pytest.raises(JHalt) as jerr:
            jcoord.step(halt, jstate, T.jb(t, halt))
        assert jerr.value.step == halt
        assert [{k: v for k, v in e.items() if k != "checkpoint"}
                for e in jcoord.log] == \
            [{k: v for k, v in e.items() if k != "checkpoint"}
             for e in coord.log]
        # each package restores the other's files
        jgot, jstart = jax_restore(jr, str(d), t.jparams)
        back = {k: np.asarray(v) for k, v in
                jckpt._flatten(jr.state_to_tree(jgot)).items()}
    assert _members(str(jd / f"ckpt_{halt:08d}.npz")) == \
        _members(err.value.checkpoint_path)
    assert _sidecars(jd, halt) == _sidecars(d, halt)
    assert jstart == halt and sorted(back) == sorted(arrays)
    for k in back:
        assert np.array_equal(back[k], arrays[k]), k

    # the port resumes from JAX's files bitwise what it halted with, and
    # its resume from its own goes on bitwise the uninterrupted run
    rt2 = DeftRuntime(t.tcfg, adamw(T.LR), sched, lay, device="cpu")
    got, start = restore_runtime_state(rt2, str(jd), t.meta,
                                       log=lambda s: None)
    assert start == halt
    for a, b in zip(tree_leaves(rt2.state_to_tree(got)),
                    tree_leaves(rt.state_to_tree(state))):
        assert torch.equal(a, b)
    rt3 = DeftRuntime(t.tcfg, adamw(T.LR), sched, lay, device="cpu")
    got, start = restore_runtime_state(rt3, str(d), t.meta,
                                       log=lambda s: None)
    for i in range(start, n_steps):
        got, m = rt3.step(i, got, T.tb(t, i))
        losses.append(float(m["loss"]))
    assert losses == whole
    for a, b in zip(tree_leaves(rt3.params_tree(got)), whole_params):
        assert torch.equal(a, b)
