"""The elastic coordinator over 4 spawned gloo ranks, on the scenarios of
``tests/test_elastic.py``'s chaos scripts (``_DROP_SCRIPT``,
``_CASCADE_SCRIPT``, ``_STRAGGLER_SCRIPT``), against the JAX package.

Each rank is one origin shard of the tiny qwen3's sharded flat engine
(``tests/_torch_tiny.py``; 4 shards, the monitor's settings of JAX's
chaos ``setup``), observes the scenario's walls and runs
``ElasticCoordinator.maybe_migrate`` and its runtime's step:

* drop: shards 2 and 3 drop at step 4 -> a 4 -> 2 scale-down on a cycle
  boundary; its post-migration trajectory bitwise a from-scratch 2-rank
  run from the migrated snapshot; capacity returns -> 2 -> 4; then the
  A -> B -> A round trip through ``migrate_state``: params and moments
  bitwise, ``cur``/``fut`` sums within 2e-5 (JAX's limits);
* cascade: two preemptions in one cycle window fold into ONE 4 -> 2;
* straggler: a 4x straggler gives 4 -> 3 (global batch 12);
* halt: shards 0 and 1 preempted (4 -> 2, rank 0 parked), then 2 and 3:
  the emergency checkpoint, written by rank 2 and bitwise the members'
  state, and ``ElasticHalt`` with its path on every rank;
* unsplit: the straggler's 4 -> 3 at global batch 8, which 3 does not
  split: at the boundary the plan halts instead (the emergency
  checkpoint, bitwise the state the plan found, and ``ElasticHalt``
  naming both numbers on every rank).

JAX's own outcomes are asserted (action, trigger, shard counts,
``preserver_ok``, members, spares, the boundary), parked ranks hold no
runtime and no state and skip their steps, and every migration's state is
held to JAX's ``migrate_state`` run on 4 forced host devices on the same
snapshot (params, ``m``, ``v`` and the step bitwise; ``cur``/``fut`` as
folded, bitwise), under the same plan (its schedule digest equal).  The
post-migration steps of the drop and straggler scenarios are held to
JAX's run from the port's migrated snapshot on the survivor mesh within
1e-5 (losses, relative; params, absolute), the test placing each of the
port's batches on that mesh.  JAX's side is a subprocess started with
the module's first test: it imports and builds while the gloo ranks run,
then waits for their snapshots.
"""
import json
import multiprocessing as mp
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
import _torch_tiny as T
from repro_torch.checkpoint import restore, save, schedule_digest
from repro_torch.checkpoint.checkpoint import load_arrays
from repro_torch.core.deft import feedback_solve
from repro_torch.core.profiler import HardwareModel
from repro_torch.data.pipeline import make_batch
from repro_torch.elastic import (
    DeviceDrop,
    ElasticController,
    ElasticCoordinator,
    ElasticHalt,
    FaultScenario,
    HealthConfig,
    HealthMonitor,
    StragglerSlowdown,
    migrate_state,
)
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import (
    assign_buckets,
    build_bucket_layout,
    build_leaf_time_model,
)
from repro_torch.train.runtime import DeftRuntime, Placement

PE, CR, LR = 20_000, 1.8, 1e-3
TIMED = ("repack_s", "compile_s", "migrate_s")
# scenario -> global batch (divisible by every survivor count it plans)
BATCH = {"drop": 8, "cascade": 8, "straggler": 12, "halt": 8,
         "unsplit": 8}


def _setup(B):
    """The chaos scripts' ``setup``: the 4-shard runtime, controller and
    coordinator of this rank (its monitor at JAX's chaos settings)."""
    tcfg = T.port_cfg()
    meta = init_params(tcfg, device="meta")
    bo, nb = assign_buckets(meta, tcfg, partition_elems=PE)

    def model_for(width):
        return build_leaf_time_model(
            meta, tcfg, HardwareModel(dp_degree=width), T.S,
            max(B // width, 1)).with_coverage_rate(bo, nb, CR)

    sched, _, scfg, _ = feedback_solve(model_for(4).bucket_times(bo, nb),
                                       T.WALK)
    rt = DeftRuntime(tcfg, adamw(LR), sched,
                     build_bucket_layout(meta, bo, nb, shard_count=4),
                     device="cpu", fsdp=True)
    ctrl = ElasticController(model_for, bo, nb, walk=T.WALK,
                             scheduler_cfg=scfg)
    mon = HealthMonitor(4, HealthConfig(warmup_steps=1, timeout_factor=3.0,
                                        straggler_ratio=1.5,
                                        straggler_patience=2))
    coord = ElasticCoordinator(rt, ctrl, mon, params_abs=meta,
                               global_batch=B)
    return tcfg, rt, coord, sched


def _snapshot(rt, state, directory, step):
    """``state_to_tree`` of the members, written by their writer as
    checkpoint ``step`` in ``directory``; every rank of the world waits."""
    import torch.distributed as dist

    tree = rt.state_to_tree(state) if rt is not None else None
    if tree is not None:
        save(directory, step, tree)
    dist.barrier()


class _Run:
    """One scenario on this rank: drives the coordinator and records what
    the test checks."""

    def __init__(self, name, out_dir):
        self.name, self.dir = name, os.path.join(out_dir, name)
        self.B = BATCH[name]
        self.tcfg, self.rt0, self.coord, self.sched = _setup(self.B)
        self.state = self.rt0.init_state(seed=0)
        self.losses, self.parked = {}, []
        self.parked_clean = True
        self.migrations = []        # (step, members before, members after)
        self.boundaries = []        # each on a boundary of the cycle left
        self.digests = []           # each executed plan's schedule digest

    def batch(self, step):
        c = self.coord
        pos = c.members.index(c.position)
        per = self.B // len(c.members)
        full = make_batch(self.tcfg, 0, step, self.B, T.S, device="cpu")
        return {k: v[pos * per:(pos + 1) * per] for k, v in full.items()}

    def run(self, steps, walls=None):
        c = self.coord
        for step in steps:
            if c._pending is not None and c.phase_in_cycle(step) == 0:
                before = list(c.members)
                _snapshot(c.runtime, self.state,
                          os.path.join(self.dir, f"pre{step}"), step)
            n_log = len(c.log)
            boundary = c.phase_in_cycle(step) == 0
            self.state = c.maybe_migrate(step, self.state)
            if len(c.log) > n_log:
                self.migrations.append((step, before, list(c.members)))
                self.boundaries.append(boundary)
                # the plan just executed is the last one proposed
                self.digests.append(schedule_digest(
                    c.controller.plans[-1].schedule))
                _snapshot(c.runtime, self.state,
                          os.path.join(self.dir, f"post{step}"), step)
            if c.runtime is None:
                self.parked.append(step)
                self.parked_clean &= self.state is None
                assert c.parked
            else:
                self.state, m = c.runtime.step(step, self.state,
                                               self.batch(step))
                self.losses[step] = float(m["loss"])
            c.observe(step, walls(step) if walls else [1.0] * 4)

    def record(self, **extra):
        c = self.coord
        return dict(
            log=[{k: v for k, v in e.items() if k not in TIMED}
                 for e in c.log],
            members=c.members, spares=c.spares, losses=self.losses,
            parked=self.parked, parked_clean=self.parked_clean,
            migrations=self.migrations,
            accum_devices=(c.runtime.accum_devices if c.runtime else None),
            boundaries=self.boundaries, digests=self.digests, **extra)


def _reference(run, step, upto):
    """A from-scratch run of the survivors' plan from the post-migration
    snapshot at ``step`` (JAX's ``ELASTIC_REF_MATCH``): its losses, and
    its final state written beside the coordinator's run's."""
    c = run.coord
    rt = c.runtime
    losses = {}
    if rt is not None:
        ref = DeftRuntime(rt.cfg, adamw(LR), rt.schedule, rt.layout,
                          device="cpu", fsdp=rt.fsdp, group=rt.dp.group)
        st = ref.tree_to_state(restore(
            os.path.join(run.dir, f"post{step}"), step,
            ref.checkpoint_struct(), device="cpu"))
        ref.reset_cycle(step)
        for i in range(step, upto):
            st, m = ref.step(i, st, run.batch(i))
            losses[i] = float(m["loss"])
    else:
        ref = st = None
    _snapshot(ref, st, os.path.join(run.dir, "ref"), upto)
    _snapshot(rt, run.state, os.path.join(run.dir, "run"), upto)
    return losses


def _drop(out_dir):
    run = _Run("drop", out_dir)
    drop, period = 4, run.sched.period
    scen = FaultScenario(4, (DeviceDrop(drop, (2, 3)),))
    n1 = drop + 4 * period
    run.run(range(n1), lambda s: list(scen.observe(s, 1.0).walls))
    m_step = run.migrations[0][0]
    ref = _reference(run, m_step, n1)
    after_down = dict(members=list(run.coord.members),
                      spares=list(run.coord.spares))
    # capacity returns: the symmetric 2 -> 4 scale-up
    run.coord.notice_capacity(n1, [2, 3])
    n2 = n1 + 3 * run.coord._period
    run.run(range(n1, n2))
    # the A -> B -> A round trip through migrate_state
    c = run.coord
    rt4 = c.runtime
    plan = [p for p in c.controller.plans if p.action == "scale-down"][-1]
    lay2 = build_bucket_layout(c.params_abs, plan.bucket_of, plan.n_buckets,
                               shard_count=2)
    four = rt4.placement()
    two = Placement((0, 1), c._group([0, 1]), lay2, True)
    _snapshot(rt4, run.state, os.path.join(run.dir, "orig"), n2)
    rt2 = rt4.spawn(group=two.group, schedule=plan.schedule,
                    layout=lay2) if c.position in (0, 1) else None
    down = migrate_state(rt4, rt2, run.state, old=four, new=two)
    rt4b = DeftRuntime(rt4.cfg, adamw(LR), rt4.schedule, rt4.layout,
                       device="cpu", fsdp=True, group=four.group)
    back = migrate_state(rt2, rt4b, down, old=two, new=four)
    _snapshot(rt4b, back, os.path.join(run.dir, "back"), n2)
    return run.record(ref_losses=ref, n1=n1, n2=n2, after_down=after_down,
                      parked_then=run.parked)


def _cascade(out_dir):
    run = _Run("cascade", out_dir)
    run.run(range(2))
    c = run.coord
    c.notice_preemption(2, [3])
    first = c._pending.n_shards
    c.notice_preemption(2, [2])
    armed = (c._pending.n_shards, list(c._pending_members), list(c.spares))
    run.run(range(2, 2 + 3 * run.sched.period))
    return run.record(first=first, armed=armed)


def _straggler(out_dir):
    run = _Run("straggler", out_dir)
    onset = 3
    scen = FaultScenario(4, (StragglerSlowdown(onset, 1, 4.0),))
    n = onset + 4 * run.sched.period
    run.run(range(n), lambda s: list(scen.observe(s, 1.0).walls))
    ref = _reference(run, run.migrations[0][0], n)
    return run.record(ref_losses=ref, n=n)


def _halt(out_dir):
    """Shards 0 and 1 preempted (4 -> 2, rank 0 parked), then 2 and 3:
    no survivor, so the emergency checkpoint, written by rank 2, the
    lowest member, and ``ElasticHalt`` on every rank."""
    run = _Run("halt", out_dir)
    c = run.coord
    c.checkpoint_dir = os.path.join(run.dir, "emergency")
    run.run(range(2))
    c.notice_preemption(2, [0, 1])
    at = 2 + 2 * run.sched.period
    run.run(range(2, at))
    c.notice_preemption(at, [2, 3])
    _snapshot(c.runtime, run.state, os.path.join(run.dir, "before"), at)
    try:
        c.maybe_migrate(at, run.state)
        halted = None
    except ElasticHalt as e:
        halted = [e.step, e.checkpoint_path]
    return run.record(halted=halted, at=at)


def _unsplit(out_dir):
    """The straggler scenario at global batch 8: the 4 -> 3 plan arms,
    and at its boundary 3 ranks do not split 8, so it halts."""
    run = _Run("unsplit", out_dir)
    run.coord.checkpoint_dir = os.path.join(run.dir, "emergency")
    scen = FaultScenario(4, (StragglerSlowdown(3, 1, 4.0),))
    try:
        run.run(range(3 + 4 * run.sched.period),
                lambda s: list(scen.observe(s, 1.0).walls))
        halted = None
    except ElasticHalt as e:
        halted = [e.step, e.checkpoint_path, str(e)]
    return run.record(halted=halted)


SCENARIOS = {"drop": _drop, "cascade": _cascade, "straggler": _straggler,
             "halt": _halt, "unsplit": _unsplit}


def _rank_main(rank, world, port, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        for name, fn in SCENARIOS.items():
            rec = fn(out_dir)
            with open(os.path.join(out_dir, f"{name}{rank}.json"), "w") as f:
                json.dump(rec, f)
        dist.barrier()
        if rank == 0:
            open(os.path.join(out_dir, "DONE"), "w").close()
    finally:
        dist.destroy_process_group()


_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, sys.argv[1])
import dataclasses, json, time
import jax, jax.numpy as jnp
import numpy as np
import repro
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config
from repro.core.deft import feedback_solve
from repro.core.preserver import WalkParams
from repro.core.profiler import HardwareModel
from repro.elastic import ElasticController, migrate_state
from repro.launch.mesh import make_debug_mesh, make_elastic_mesh
from repro.models.model import init_params
from repro.optim.optimizers import adamw
from repro.train import (DeftRuntime, assign_buckets, build_bucket_layout,
                         build_leaf_time_model)
from repro_torch.configs import get_config as t_get_config
from repro_torch.data.pipeline import make_batch as t_make_batch

TINY, S, PE, CR, LR = %r, %d, %d, %r, %r
out = sys.argv[2]
cfg = dataclasses.replace(get_config("qwen3-4b"), **TINY)
tcfg = dataclasses.replace(t_get_config("qwen3-4b"), **TINY)
params = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
bo, nb = assign_buckets(params, cfg, partition_elems=PE)
walk = WalkParams(s0=4.0, eta=0.01, mu=1.0, sigma=40.0, batch=256)
mesh4 = make_debug_mesh(data=4, model=1)
rows = mesh4.devices

def controller(B):
    def model_for(width):
        return build_leaf_time_model(params, cfg, HardwareModel(dp_degree=width),
                                     S, max(B // width, 1)).with_coverage_rate(bo, nb, CR)
    sched, _, scfg, _ = feedback_solve(model_for(4).bucket_times(bo, nb), walk)
    return ElasticController(model_for, bo, nb, walk=walk, scheduler_cfg=scfg), sched

def load(rt, mesh, d, step):
    arrays = dict(np.load(os.path.join(d, f"ckpt_{step:08d}.npz")))
    paths, treedef = jax.tree_util.tree_flatten_with_path(rt.checkpoint_struct())
    leaves = [jnp.asarray(arrays["/".join(jckpt._path_str(p) for p in path)])
              for path, _ in paths]
    with jax.set_mesh(mesh):
        return rt.tree_to_state(jax.tree_util.tree_unflatten(treedef, leaves))

while not os.path.exists(os.path.join(out, "DONE")):
    time.sleep(0.2)
result = {}
for name, B in (("drop", 8), ("cascade", 8), ("straggler", 12)):
    rec = json.load(open(os.path.join(out, f"{name}0.json")))
    ctrl, sched = controller(B)
    lay = build_bucket_layout(params, bo, nb, shard_count=4)
    mesh = mesh4
    rt = DeftRuntime(cfg, adamw(LR), sched, lay, mesh, fsdp=True)
    for k, (step, before, after) in enumerate(rec["migrations"]):
        mig = rec["log"][k]
        plan = ctrl.propose(mig["detected_step"], len(after), mig["trigger"])
        new_mesh = make_elastic_mesh([tuple(rows[o, :]) for o in after])
        new_lay = build_bucket_layout(params, plan.bucket_of, plan.n_buckets,
                                      shard_count=plan.n_shards if plan.sharded else 1)
        new_rt = rt.spawn(mesh=new_mesh, schedule=plan.schedule,
                          layout=new_lay, fsdp=plan.sharded)
        d = os.path.join(out, name)
        state = load(rt, mesh, os.path.join(d, f"pre{step}"), step)
        state = migrate_state(rt, new_rt, state)
        with jax.set_mesh(new_mesh):
            tree = new_rt.state_to_tree(state)
            np.savez(os.path.join(d, f"jax_post{step}.npz"),
                     **{k2: np.asarray(v) for k2, v in jckpt._flatten(tree).items()})
        result[f"{name}/{step}/digest"] = jckpt.schedule_digest(plan.schedule)
        result[f"{name}/{step}/action"] = plan.action
        upto = rec.get("n1", rec.get("n"))
        if k == 0 and name in ("drop", "straggler"):
            # the post-migration steps from the port's migrated snapshot,
            # each of the port's batches placed on the survivor mesh
            new_rt.reset_cycle(step)
            st = load(new_rt, new_mesh, os.path.join(d, f"post{step}"), step)
            losses = []
            with jax.set_mesh(new_mesh):
                for i in range(step, upto):
                    b = {k2: jax.device_put(np.asarray(v), NamedSharding(new_mesh, P("data")))
                         for k2, v in t_make_batch(tcfg, 0, i, B, S, device="cpu").items()}
                    st, m = new_rt.step(i, st, b)
                    losses.append(float(m["loss"]))
                flat = jckpt._flatten(new_rt.state_to_tree(st))
                np.savez(os.path.join(d, "jax_run.npz"), losses=np.array(losses),
                         **{k2: np.asarray(v) for k2, v in flat.items()
                            if k2.startswith("params/")})
        ctrl.adopt(plan)
        rt, mesh = new_rt, new_mesh
json.dump(result, open(os.path.join(out, "jax.json"), "w"))
""" % (T.TINY, T.S, PE, CR, LR)


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("elastic_ranks")


@pytest.fixture(scope="module", autouse=True)
def jax_side(out_dir):
    """JAX's migrations and runs on 4 forced host devices, started with
    the module's first test; it waits for the gloo ranks' snapshots."""
    (out_dir / "jax_run.py").write_text(_JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.Popen(
        [sys.executable, str(out_dir / "jax_run.py"), src, str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(out_dir):
    """Every rank's record of every scenario: {scenario: [rank 0's, ...]}."""
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_rank_main, args=(r, 4, port, str(out_dir)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        assert not p.is_alive() and p.exitcode == 0
    return {name: [json.load(open(out_dir / f"{name}{r}.json"))
                   for r in range(4)] for name in SCENARIOS}


@pytest.fixture(scope="module")
def jax_out(out_dir, ranks, jax_side):
    _, err = jax_side.communicate(timeout=600)
    assert jax_side.returncode == 0, err[-4000:]
    return json.load(open(out_dir / "jax.json"))


def _arrays(d, step):
    return load_arrays(str(d), step)


def _same_everywhere(recs):
    """Every rank's coordinator made the same decisions."""
    for r in recs[1:]:
        for k in ("log", "members", "spares", "migrations", "boundaries"):
            assert r[k] == recs[0][k], k


def _losses(rec):
    return {int(k): v for k, v in rec["losses"].items()}


def test_drop_scale_down_up_and_round_trip(ranks, out_dir):
    recs = ranks["drop"]
    _same_everywhere(recs)
    r0 = recs[0]
    down, up = r0["log"]
    assert down["action"] == "scale-down" and down["trigger"] == "dead"
    assert (down["old_shards"], down["new_shards"]) == (4, 2)
    assert down["preserver_ok"]
    assert r0["after_down"] == {"members": [0, 1], "spares": [2, 3]}
    m_step = down["step"]
    assert 4 < down["detected_step"] <= m_step
    assert up["action"] == "scale-up"
    assert (up["old_shards"], up["new_shards"]) == (2, 4)
    assert r0["members"] == [0, 1, 2, 3] and r0["spares"] == []
    assert [m[0] for m in r0["migrations"]] == [down["step"], up["step"]]
    assert r0["boundaries"] == [True, True]
    # parked ranks hold nothing and skip exactly the steps between
    for r in (2, 3):
        assert recs[r]["parked"] == list(range(m_step, up["step"]))
        assert recs[r]["parked_clean"]
        assert all(s not in _losses(recs[r]) for s in recs[r]["parked"])
    for r in (0, 1):
        assert recs[r]["parked"] == []
    # the trajectory after the scale-down, bitwise a from-scratch 2-rank
    # run from the migrated snapshot
    ref = {int(k): v for k, v in r0["ref_losses"].items()}
    run = _losses(r0)
    assert ref and all(run[s] == ref[s] for s in ref)
    n1 = r0["n1"]
    a, b = _arrays(out_dir / "drop" / "run", n1), \
        _arrays(out_dir / "drop" / "ref", n1)
    for k in a:
        if not k.startswith("pgather"):
            assert np.array_equal(a[k], b[k]), k
    # the round trip: params and moments bitwise, accumulator sums 2e-5
    n2 = r0["n2"]
    a, b = _arrays(out_dir / "drop" / "orig", n2), \
        _arrays(out_dir / "drop" / "back", n2)
    assert sorted(a) == sorted(b)
    for k in a:
        if k.startswith(("cur", "fut")):
            np.testing.assert_allclose(b[k].sum(0), a[k].sum(0), rtol=0,
                                       atol=2e-5, err_msg=k)
        elif not k.startswith("pgather"):
            assert np.array_equal(a[k], b[k]), k


def test_cascade_one_scale_down(ranks):
    recs = ranks["cascade"]
    _same_everywhere(recs)
    r0 = recs[0]
    assert r0["first"] == 3
    assert r0["armed"] == [2, [0, 1], [3, 2]]
    downs = [e for e in r0["log"] if e["action"] == "scale-down"]
    assert len(downs) == 1 and downs[0]["trigger"] == "preemption"
    assert (downs[0]["old_shards"], downs[0]["new_shards"]) == (4, 2)
    assert r0["members"] == [0, 1] and sorted(r0["spares"]) == [2, 3]
    for r in (2, 3):
        assert recs[r]["parked_clean"] and recs[r]["parked"]
        assert recs[r]["accum_devices"] is None
    assert recs[1]["accum_devices"] == 2


def test_straggler_scale_down_4_to_3(ranks, out_dir):
    recs = ranks["straggler"]
    _same_everywhere(recs)
    r0 = recs[0]
    mig = r0["log"][0]
    assert mig["action"] == "scale-down" and mig["trigger"] == "straggler"
    assert (mig["old_shards"], mig["new_shards"]) == (4, 3)
    assert r0["members"] == [0, 2, 3] and r0["spares"] == [1]
    assert recs[0]["accum_devices"] == 3 and recs[1]["accum_devices"] is None
    assert recs[1]["parked_clean"]
    ref = {int(k): v for k, v in r0["ref_losses"].items()}
    run = _losses(r0)
    assert ref and all(run[s] == ref[s] for s in ref)
    n = r0["n"]
    a, b = _arrays(out_dir / "straggler" / "run", n), \
        _arrays(out_dir / "straggler" / "ref", n)
    for k in a:
        if not k.startswith("pgather"):
            assert np.array_equal(a[k], b[k]), k


def test_halt_after_rank_0_left(ranks, out_dir):
    """The emergency checkpoint of a group without rank 0: its lowest
    member writes it, every rank gets its path, and it holds the
    members' state bitwise."""
    recs = ranks["halt"]
    _same_everywhere(recs)
    r0 = recs[0]
    at = r0["at"]
    assert [e["action"] for e in r0["log"]] == ["scale-down",
                                                "checkpoint-halt"]
    assert r0["members"] == [2, 3] and sorted(r0["spares"]) == [0, 1, 2, 3]
    path = str(out_dir / "halt" / "emergency" / f"ckpt_{at:08d}.npz")
    assert all(r["halted"] == [at, path] for r in recs)
    assert r0["log"][-1]["checkpoint"] == path
    a = _arrays(out_dir / "halt" / "emergency", at)
    b = _arrays(out_dir / "halt" / "before", at)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert a["cur/[0]"].shape[0] == 2          # the two members' rows


def test_unsplit_batch_halts_with_checkpoint(ranks, out_dir):
    """A planned survivor count that does not split the global batch
    halts at the plan's boundary through the emergency checkpoint, which
    holds the state the plan found bitwise, instead of migrating."""
    recs = ranks["unsplit"]
    _same_everywhere(recs)
    r0 = recs[0]
    why = "3 surviving shards do not split the global batch 8"
    at, path, msg = r0["halted"]
    assert all(r["halted"] == r0["halted"] for r in recs)
    assert r0["migrations"] == [] and r0["members"] == [0, 1, 2, 3]
    assert [(e["action"], e["trigger"], e["reason"]) for e in r0["log"]] \
        == [("checkpoint-halt", "straggler", why)]
    assert why in msg and path in msg
    assert path == str(out_dir / "unsplit" / "emergency"
                       / f"ckpt_{at:08d}.npz")
    a = _arrays(out_dir / "unsplit" / "emergency", at)
    b = _arrays(out_dir / "unsplit" / f"pre{at}", at)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["drop", "cascade", "straggler"])
def test_migrated_state_matches_jax(ranks, jax_out, out_dir, name):
    """Each migration's state against JAX's ``migrate_state`` of the same
    snapshot under the same plan: every array bitwise (the fold's sums
    included) apart from the gather cache, which both leave cold."""
    r0 = ranks[name][0]
    assert r0["migrations"]
    for (step, _, _), digest in zip(r0["migrations"], r0["digests"]):
        port_plan = next(e for e in r0["log"] if e["step"] == step)
        assert jax_out[f"{name}/{step}/action"] == port_plan["action"]
        assert jax_out[f"{name}/{step}/digest"] == digest
        got = _arrays(out_dir / name / f"post{step}", step)
        want = dict(np.load(out_dir / name / f"jax_post{step}.npz"))
        assert sorted(k for k in got if not k.startswith("pgather")) == \
            sorted(k for k in want if not k.startswith("pgather"))
        for k in got:
            if k.startswith("pgather"):
                continue
            assert got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), (name, step, k)


@pytest.mark.parametrize("name", ["drop", "straggler"])
def test_trajectory_after_migration_near_jax(ranks, jax_out, out_dir, name):
    r0 = ranks[name][0]
    step = r0["migrations"][0][0]
    upto = r0.get("n1", r0.get("n"))
    want = dict(np.load(out_dir / name / "jax_run.npz"))
    run = _losses(r0)
    np.testing.assert_allclose([run[i] for i in range(step, upto)],
                               want.pop("losses"), rtol=1e-5)
    got = _arrays(out_dir / name / "run", upto)
    assert sorted(want) == sorted(k for k in got if k.startswith("params/"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
