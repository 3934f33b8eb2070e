"""The precision path, AG streaming and ring chains over the 'model' axis
against the JAX package and the port's model-1 runs.

One spawn of 4 gloo ranks runs qwen3-tiny (global batch 4 x 32, buckets
of about 25,000 elements: 4 buckets, two schedule periods of 2 with a
merged update and a rotation) on both flat engines over the meshes (data
2, model 2) and (data 1, model 4) in three precision cases, as
``tests/test_torch_precision_runtime.py`` runs them on one device:

* ``mixed``: f32, bf16 and int8 wires, int8 on the two buckets that hold
  128-lane rows a whole leaf (a norm's 64 scales) shares with a split
  one, asserted from the runtime's ``_shared_rows`` (also within each
  data rank's span, which the int8 param gather quantizes): a row's own
  absmax differs between the model ranks there, so they agree it over
  'model' first;
* ``bf16sr``: a bf16sr resident master, each element hashed at its place
  in JAX's global bucket;
* ``bf16``: ``compute_dtype=bf16`` over an f32 master.

Each case is held three ways: to JAX's one-device ``DeftRuntime`` with
the same policy (the sharded engine's where it computes another function:
an int8 param gather, a bf16sr master read at f32) and to the port's
model-1 run at the same data size (one rank, or a second spawn of 2 ranks
at data 2) at ``test_torch_precision_runtime.py``'s (b)/(c) limits
(losses rtol 2.5e-4, params atol 1e-2, at most 1% beyond 1e-4 + |p| /
128), with the dtypes of the autograd leaves and their gradients
asserted; and across the model ranks, every whole leaf bitwise equal
after every step (the check fails on the int8 wire without the agreed
scales).  At data 2 each rank puts its own half batch's gradient on the
int8 grid and one device does not, so there the mixed case may lie as far
from JAX's one device as its model-1 run does, and 0.1% further.

At (2, 2) the same spawn also runs: ``decoupled=True`` bitwise its burst
run, in f32 and on the mixed wires, its gathers streamed as the model-1
run's; ring chains over each model rank's 'data' line (every sync and
gather on the secondary link) on the replicated and the streamed sharded
engine, and (pod 2, data 1, model 2) with the chain (0,), each step's
collectives and P2P pairs the model-1 runs' (the 2-rank spawn, at data 2
and pod 2) and losses and params within ``tests/test_torch_tp.py``'s f32
limits of the unchained model-2 run; the mixed wires' planned bytes equal
to the bytes the engine sent (``obs.wire_bytes_report``); and the
launcher's ``train(model=2)`` on int8 wires, a bf16sr master, bf16
compute and streamed gathers against its model-1 run at data 2, on
qwen3-tiny widened so that every shard spans whole 128-lane rows.

Params and batches are the port's (seed 0), handed to JAX as numpy.  The
spawned ranks import no JAX.
"""
import concurrent.futures
import dataclasses
import functools
import hashlib
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_threads  # noqa: F401  (one CPU thread a test process)
import _torch_tiny as T
from repro_torch.core.deft import plan_ag_stream
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import build_schedule, init_distributed, train
from repro_torch.models.model import init_params
from repro_torch.obs import Tracer, wire_bytes_report
from repro_torch.optim.optimizers import adamw
from repro_torch.sharding.tp import model_specs, shard_params
from repro_torch.train import runtime as trt
from repro_torch.train.bucketing import build_bucket_layout
from repro_torch.train.runtime import DeftRuntime
from repro_torch.tree import tree_leaves
from test_torch_tp import (
    ATOL,
    LR,
    MAX_OVER_SHARE,
    RTOL,
    _init,
    _join,
    _n_over,
    _spawn,
)

CASES = ("mixed", "bf16sr", "bf16")
MESHES = ((2, 2), (1, 4))
# qwen3-tiny over a global batch of 4 x 32 in buckets of about 25,000
# elements: 4 buckets, a schedule of period 2 with a merged update (k 2)
# and a rotation; at model > 1 buckets 2 and 3 hold rows a norm's 64
# scales share with a split leaf, at model 2 in both data ranks' spans
B, S, PART = 4, 32, 25_000
# test_torch_precision_runtime.py's (b)/(c) limits: loss rtol, param
# atol, largest share of params beyond 1e-4 + |want| / 128
LOSS_RTOL, PARAM_ATOL, OVER_SHARE = 2.5e-4, 1e-2, 0.01
CHAIN = (1, 0)          # a chain over each model rank's two 'data' ranks
LAUNCH = dict(wire_precision="int8", master_dtype="bf16sr",
              compute_dtype="bf16", fsdp=True, decoupled=True)
# the launcher's config: qwen3-tiny widened so that every leaf and every
# shard at model 2 spans whole 128-lane rows, as gemma2-2b's do at full
# width: a model rank's int8 rows are then rows of the global bucket (at
# qwen3-tiny's widths a split leaf's rows group other elements, ROADMAP
# section 3)
LAUNCH_TINY = dict(d_model=128, n_heads=2, n_kv_heads=2, head_dim=128,
                   d_ff=512)


@functools.lru_cache(maxsize=None)
def _plan():
    """The case's params (seed 0), schedule, buckets and numpy batches of
    two periods, the same in every process."""
    cfg = T.port_cfg()
    meta = init_params(cfg, device="meta")
    bo, nb, times, plan = build_schedule(
        meta, cfg, dp=2, seq_len=S, per_device_batch=B // 2,
        partition_elems=PART, coverage_rate=1.8)
    sched = plan.schedule
    batches = [{k: v.numpy() for k, v in
                make_batch(cfg, 0, i, B, S, device="cpu").items()}
               for i in range(2 * sched.period)]
    return dict(cfg=cfg, meta=meta, bo=bo, nb=nb, sched=sched, times=times,
                batches=batches, params=init_params(cfg, seed=0,
                                                    device="cpu"))


def _policy(case, n):
    if case == "mixed":     # int8 on the buckets with shared rows
        return PrecisionPolicy(("f32", "bf16") + ("int8",) * (n - 2), "f32")
    if case == "bf16sr":
        return PrecisionPolicy(("f32",) * n, "bf16sr")
    return None


@functools.lru_cache(maxsize=None)
def _routed():
    """qwen3-tiny's schedule with every synced bucket on the secondary link
    and every param gather on link 1 (``chip_smoke.route_all_secondary``,
    as the JAX package's chain test forces them), and that AG plan."""
    c = _plan()
    times, nb = c["times"], c["nb"]
    sched = dataclasses.replace(c["sched"], phases=tuple(
        dataclasses.replace(ph, secondary=tuple(
            (ph.route_new[b] == "sync" and ph.rotate) or ph.sync_cur[b]
            for b in range(nb))) for ph in c["sched"].phases))
    ag = plan_ag_stream(sched, times)
    return sched, dataclasses.replace(ag, items=tuple(
        dataclasses.replace(i, link=1) for i in ag.items))


def _batches(c, mesh):
    """Each step's batch rows of this rank's ('pod', 'data') position."""
    per = c["batches"][0]["tokens"].shape[0] // (
        1 if mesh is None else mesh.dp_size)
    at = 0 if mesh is None else mesh.dp_index * per
    return [{k: torch.from_numpy(v[at:at + per]).long()
             for k, v in bt.items()} for bt in c["batches"]]


def _digest(rt, state) -> str:
    """Hash of every element of this rank's param buffers (or spans) that
    lies in a leaf kept whole over 'model'."""
    h = hashlib.sha256()
    for b, buf in enumerate(state["pbuf"]):
        lo = rt.dp.rank * buf.numel() if rt.fsdp else 0
        for a, e, split in rt._model_norm.runs[b]:
            a, e = max(a, lo), min(e, lo + buf.numel())
            if not split and a < e:
                h.update(buf[a - lo:e - lo].view(torch.uint8).numpy()
                         .tobytes())
    return h.hexdigest()


def run_case(case, *, mesh=None, fsdp=False, decoupled=False, chain=None,
             tracer=None):
    """This rank's run of qwen3-tiny over two periods: losses, the final
    params (gathered over 'model', as f32 numpy), the dtypes of the
    autograd leaves and their gradients, the collectives and P2P pairs of
    every step, the streamed census, and at model > 1 whether every whole
    leaf was bitwise equal across the model ranks after every step."""
    c = _plan()
    sched, ag = _routed() if chain is not None else (c["sched"], None)
    meta = c["meta"] if mesh is None or mesh.size("model") == 1 else \
        shard_params(c["meta"], model_specs(c["meta"], mesh), mesh)
    n_data = 1 if mesh is None else mesh.size("data")
    lay = build_bucket_layout(meta, c["bo"], c["nb"],
                              shard_count=n_data if fsdp else 1)
    policy = _policy(case, c["nb"])
    if policy is not None:
        lay = lay.with_precision(policy)
    rt = DeftRuntime(c["cfg"], adamw(LR), sched, lay, device="cpu",
                     mesh=mesh, fsdp=fsdp, decoupled=decoupled,
                     secondary_chain=chain, ag_plan=ag, tracer=tracer,
                     compute_dtype=torch.bfloat16 if case == "bf16" else None)
    seen = {"leaf": set(), "grad": set()}
    inner = trt.loss_fn

    def watched(params, *a, **kw):
        for t in tree_leaves(params):
            seen["leaf"].add(str(t.dtype))
            t.register_hook(lambda g: seen["grad"].add(str(g.dtype)))
        return inner(params, *a, **kw)

    trt.loss_fn = watched
    # the dtypes the 'model' collectives sum and take the max of, and the
    # gradient buffers' that the clip norm reads
    out = dict(model_sums=set(), model_maxes=set(), norm_dtypes=set())
    if rt.tp is not None:
        reduce = rt.tp.all_reduce
        norm = rt._model_norm

        def all_reduce(x, op=dist.ReduceOp.SUM, kind="all_reduce"):
            out["model_maxes" if op == dist.ReduceOp.MAX
                else "model_sums"].add(str(x.dtype))
            return reduce(x, op, kind)

        def clip_norm(gbuf, **kw):
            out["norm_dtypes"].update(str(g.dtype) for g in gbuf)
            return norm(gbuf, **kw)

        clip_norm.runs = norm.runs
        rt.tp.all_reduce, rt._model_norm = all_reduce, clip_norm
    try:
        state = rt.state_from_params(c["params"])
        out.update(losses=[], collectives=[], p2p=[], whole_equal=[],
                   streams=[])
        for i, bt in enumerate(_batches(c, mesh)):
            state, m = rt.step(i, state, bt)
            out["losses"].append(float(m["loss"]))
            out["collectives"].append(dict(rt.last_collectives))
            out["p2p"].append(list(rt.last_p2p))
            if decoupled:
                out["streams"].append(dict(rt.last_stream))
            if rt.tp is not None:
                got = [None] * rt.tp.size
                dist.all_gather_object(got, _digest(rt, state),
                                       group=rt.tp.group)
                out["whole_equal"].append(len(set(got)) == 1)
    finally:
        trt.loss_fn = inner
    out["params"] = [x.float().numpy()
                     for x in tree_leaves(rt.params_tree(state))]
    out["leaf_dtypes"] = seen
    out["pbuf_dtype"] = str(state["pbuf"][0].dtype)
    out["stats"] = {k: v for k, v in rt.stats().items()
                    if k in ("master_dtype", "wire_precision",
                             "compute_dtype", "model", "decoupled")}
    # the int8 buckets' rows whose scales the model ranks agree: of the
    # whole buffer, and of this rank's span (what the param gather sends)
    out["int8_shared_rows"] = [
        sum(0 if r is None or lay.wire(b) != "int8" else int(r.numel())
            for b, r in enumerate(rt._shared_rows[span]))
        for span in (False, True)]
    out["census"] = rt.collectives_per_phase()
    if tracer is not None:
        rep = wire_bytes_report(tracer, rt.wire_bytes_per_phase,
                                rt.wire_bytes_split_per_phase)
        out["wire"] = dict(ok=rep.ok, measured=rep.measured_per_phase,
                           planned=rep.planned_per_phase,
                           split=(rep.measured_split == rep.planned_split),
                           per_cycle=rep.planned_per_cycle,
                           stats=rt.stats()["planned_wire_bytes_per_cycle"])
    return out


def _launch(**kw):
    cfg = dataclasses.replace(T.port_cfg(), **LAUNCH_TINY)
    res = train(cfg, scheduler="deft", steps=6, batch=B, seq=S,
                partition_elems=PART, device="cpu", log=lambda s: None,
                **LAUNCH, **kw)
    rt = res["runtime"]
    return dict(losses=res["losses"],
                shared_rows=sum(0 if r is None else r.numel()
                                for r in rt._shared_rows[False]),
                params=[x.float().numpy() for x in
                        tree_leaves(rt.params_tree(res["state"]))])


def _save(out_dir, name, rank, obj):
    np.save(os.path.join(out_dir, f"{name}_rank{rank}.npy"), obj,
            allow_pickle=True)


def _main4(rank, world, port, out_dir):
    _init(rank, world, port)
    runs = {}
    for data, model in MESHES:
        mesh = make_debug_mesh(data=data, model=model)
        for case in CASES:
            for fsdp in (False, True):
                runs[(data, model, case, fsdp)] = run_case(
                    case, mesh=mesh, fsdp=fsdp, tracer=Tracer() if (
                        data, case, fsdp) == (2, "mixed", False) else None)
    mesh = make_debug_mesh(data=2, model=2)
    runs["f32"] = run_case("f32", mesh=mesh)
    runs["f32 sharded"] = run_case("f32", mesh=mesh, fsdp=True)
    runs["f32 streamed"] = run_case("f32", mesh=mesh, fsdp=True,
                                    decoupled=True)
    runs["mixed streamed"] = run_case("mixed", mesh=mesh, fsdp=True,
                                      decoupled=True)
    runs["f32 chain"] = run_case("f32", mesh=mesh, chain=CHAIN)
    runs["f32 streamed chain"] = run_case("f32", mesh=mesh, fsdp=True,
                                          decoupled=True, chain=CHAIN)
    runs["f32 pod chain"] = run_case(
        "f32", mesh=make_debug_mesh(pod=2, data=1, model=2), fsdp=True,
        decoupled=True, chain=(0,))
    runs["launcher"] = _launch(model=2)
    _save(out_dir, "model", rank, runs)


def _main2(rank, world, port, out_dir):
    """The model-1 runs at data 2 (two ranks): the precision cases, the
    chained and pod cases and the launcher's."""
    _init(rank, world, port)
    mesh = make_debug_mesh(data=2, model=1)
    runs = {(case, fsdp): run_case(case, mesh=mesh, fsdp=fsdp)
            for case in CASES for fsdp in (False, True)}
    runs["f32 chain"] = run_case("f32", mesh=mesh, chain=CHAIN)
    runs["f32 streamed chain"] = run_case("f32", mesh=mesh, fsdp=True,
                                          decoupled=True, chain=CHAIN)
    runs["f32 pod chain"] = run_case(
        "f32", mesh=make_debug_mesh(pod=2, data=1, model=1), fsdp=True,
        decoupled=True, chain=(0,))
    runs["launcher"] = _launch(model=1)
    _save(out_dir, "one", rank, runs)


def _jax_reference(case, fsdp, n_dev):
    """JAX's ``DeftRuntime`` (``fsdp``: its sharded engine) on qwen3-tiny
    under ``case``'s policy on ``n_dev`` devices ('data'), from the port's
    params and batches: losses and final params."""
    import jax
    import jax.numpy as jnp
    import repro  # noqa: F401
    from repro.configs import get_config
    from repro.core.precision import PrecisionPolicy as JaxPolicy
    from repro.core.scheduler import DeftSchedule, PhaseSpec
    from repro.optim.optimizers import adamw as jax_adamw
    from repro.train import runtime as jrt
    from repro.train.bucketing import build_bucket_layout as jax_layout
    from repro_torch.convert import params_to_numpy

    assert jax.device_count() == n_dev
    c = _plan()
    cfg = dataclasses.replace(get_config("qwen3-4b"), **T.TINY)
    sched = c["sched"]
    jsched = DeftSchedule(
        plans=(), phases=tuple(PhaseSpec(**p.__dict__) for p in sched.phases),
        period=sched.period, updates_per_period=sched.updates_per_period,
        batch_size_sequence=sched.batch_size_sequence)
    params = params_to_numpy(c["params"])
    lay = jax_layout(params, c["bo"], c["nb"],
                     shard_count=n_dev if fsdp else 1)
    policy = _policy(case, c["nb"])
    if policy is not None:
        lay = lay.with_precision(JaxPolicy(wire=policy.wire,
                                           master=policy.master))
    mesh = jax.make_mesh((n_dev, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    tree = jax.tree.map(jnp.asarray, params)
    jrt.init_params = lambda *a, **k: tree   # init_state takes these
    rcfg = jrt.RuntimeConfig(
        fsdp=fsdp, compute_dtype=jnp.bfloat16 if case == "bf16" else None,
        master_dtype="bf16sr" if case == "bf16sr" else None)
    with mesh:
        jr = jrt.DeftRuntime(cfg, jax_adamw(LR), jsched, lay, mesh,
                             config=rcfg)
        state = jr.init_state(jax.random.PRNGKey(0))
        losses = []
        for i, bt in enumerate(c["batches"]):
            state, m = jr.step(i, state, {k: jnp.asarray(v.astype(np.int32))
                                          for k, v in bt.items()})
            losses.append(float(m["loss"]))
        final = [np.asarray(x, np.float32)
                 for x in jax.tree.leaves(jr.params_tree(state))]
    return dict(losses=losses, params=final)


def _jax_jobs(jobs):
    """JAX's references of ``jobs`` ((case, fsdp, devices)) in turn, in one
    process."""
    return [_jax_reference(*job) for job in jobs]


# JAX's one-device references, in two spawned processes: the sharded
# engine's where it computes another function than the replicated one (an
# int8 param gather; a bf16sr master read at f32)
JAX_JOBS = ([("mixed", False, 1), ("bf16sr", False, 1), ("bf16", False, 1)],
            [("mixed", True, 1), ("bf16sr", True, 1)])


def _jax_ref(refs, case, fsdp):
    return refs.get((case, fsdp, 1), refs.get((case, False, 1)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank and 2-rank spawns, JAX's references in two spawned
    processes, and meanwhile in this process the port's model-1 runs at
    one rank."""
    out_dir = str(tmp_path_factory.mktemp("tp_precision"))
    procs = _spawn(_main4, 4, out_dir) + _spawn(_main2, 2, out_dir)
    ctx = mp.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(JAX_JOBS),
                                                mp_context=ctx) as pool:
        futs = [pool.submit(_jax_jobs, jobs) for jobs in JAX_JOBS]
        init_distributed(torch.device("cpu"))
        one = {(case, fsdp): run_case(case, fsdp=fsdp)
               for case in CASES for fsdp in (False, True)}
        one["f32 streamed"] = run_case("f32", fsdp=True, decoupled=True)
        jax_refs = {job: out for jobs, f in zip(JAX_JOBS, futs)
                    for job, out in zip(jobs, f.result())}
    _join(procs)
    load = lambda name, r: np.load(os.path.join(
        out_dir, f"{name}_rank{r}.npy"), allow_pickle=True).item()
    return dict(model=[load("model", r) for r in range(4)],
                two=[load("one", r) for r in range(2)], jax=jax_refs, one=one)


def _over(got, want) -> float:
    """The share of ``got``'s params beyond one bf16 ulp (1e-4 + |want| /
    128) of ``want``'s."""
    over = sum(int((np.abs(a - b) > 1e-4 + np.abs(b) / 128).sum())
               for a, b in zip(got["params"], want["params"]))
    return over / sum(b.size for b in want["params"])


def _held(got, want, what, share=OVER_SHARE):
    """``got``'s losses and params within the (b)/(c) limits of
    ``want``'s: losses rtol 2.5e-4, params atol 1e-2, at most ``share`` of
    them beyond one bf16 ulp."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL,
                               err_msg=what)
    worst = max(float(np.abs(a - b).max())
                for a, b in zip(got["params"], want["params"]))
    over = _over(got, want)
    assert worst <= PARAM_ATOL and over <= share, (what, worst, over, share)


def _within_f32(got, want, what):
    """``tests/test_torch_tp.py``'s f32 limits."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL, err_msg=what)
    size = sum(p.size for p in want["params"])
    over = sum(_n_over(a, b) for a, b in zip(got["params"], want["params"]))
    assert over <= MAX_OVER_SHARE * size, (what, over, size)


def _bitwise(got, want, what):
    assert got["losses"] == want["losses"], what
    for a, b in zip(got["params"], want["params"]):
        assert np.array_equal(a, b), what


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "sharded"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=["data2-model2", "data1-model4"])
def test_precision_at_model_above_one(runs, mesh, case, fsdp):
    """Against JAX's one device and the port's model 1 at the (b)/(c)
    limits; every whole leaf bitwise across the model ranks after every
    step, on a layout with rows a whole leaf shares with a split one; the
    leaves' and their gradients' dtypes and the master's as the case
    says; the data collectives the schedule's census."""
    key = (*mesh, case, fsdp)
    ranks = [r[key] for r in runs["model"]]
    # the sharded engine reads params at the compute dtype (f32 under a
    # bf16sr master), the replicated one a bf16sr master in bf16
    compute = "torch.bfloat16" if case == "bf16" or (
        case == "bf16sr" and not fsdp) else "torch.float32"
    c = _plan()
    policy = _policy(case, c["nb"])
    for r, got in enumerate(ranks):
        assert all(got["whole_equal"]) and \
            len(got["whole_equal"]) == 2 * c["sched"].period, (r, key)
        if case == "mixed":   # the ranks agree some int8 rows' scales
            assert got["int8_shared_rows"][0] > 0, (r, key)
            assert not fsdp or got["int8_shared_rows"][1] > 0, (r, key)
        assert got["leaf_dtypes"] == {"leaf": {compute}, "grad": {compute}}
        # the row-parallel partial sums and copy_in's gradients in the
        # compute dtype, as XLA's all-reduce of a bf16 product; the vocab
        # cross entropy's max and sums, the clip norm's and the int8
        # scales' in f32; the clip norm over f32 gradient buffers
        assert got["model_sums"] == {compute, "torch.float32"}, key
        assert got["model_maxes"] == {"torch.float32"}, key
        assert got["norm_dtypes"] == {"torch.float32"}, key
        assert got["pbuf_dtype"] == ("torch.bfloat16" if case == "bf16sr"
                                     else "torch.float32")
        assert got["stats"]["model"] == mesh[1]
        assert got["stats"]["master_dtype"] == (
            "bf16sr" if case == "bf16sr" else "f32")
        assert got["stats"]["compute_dtype"] == (
            "bfloat16" if case == "bf16" else "float32")
        if policy is not None:
            assert got["stats"]["wire_precision"] == policy.describe()
        for i, coll in enumerate(got["collectives"]):
            assert coll == got["census"][i % c["sched"].period], (r, i)
        assert got["losses"] == ranks[0]["losses"]
        for a, b in zip(got["params"], ranks[0]["params"]):
            assert np.array_equal(a, b), (r, key)
    one = runs["two"][0] if mesh[0] == 2 else runs["one"]
    _held(ranks[0], one[(case, fsdp)], f"{key} vs model 1")
    # at data 2 each rank puts its own half batch's gradient on the int8
    # grid, which one device does not: there the model-2 run may lie as far
    # from JAX's one device as its model-1 run at data 2 does, and 0.1%
    # further (JAX's own int8 run on 2 host devices aborts in XLA)
    jax = _jax_ref(runs["jax"], case, fsdp)
    share = OVER_SHARE
    if case == "mixed" and mesh[0] > 1:
        share = max(share, _over(one[(case, fsdp)], jax) + OVER_SHARE / 10)
    _held(ranks[0], jax, f"{key} vs JAX", share)


def test_streamed_is_bitwise_the_burst_run(runs):
    """At (2, 2), ``decoupled=True`` is bitwise the burst run in f32 and on
    the mixed wires, and its gathers stream as the model-1 run's do: the
    same first-touch order and gathers issued before the forward's first
    compute."""
    want = runs["one"]["f32 streamed"]["streams"]
    for r in runs["model"]:
        _bitwise(r["f32 streamed"], r["f32 sharded"], "f32")
        _bitwise(r["mixed streamed"], r[(2, 2, "mixed", True)], "mixed")
        for key in ("f32 streamed", "mixed streamed"):
            assert r[key]["streams"] == want, key
            assert all(r[key]["whole_equal"]), key
    assert want[-1]["issued_at_first_touch"] < len(want[-1]["touched"])


@pytest.mark.parametrize("key", ["f32 chain", "f32 streamed chain",
                                 "f32 pod chain"])
def test_chains_over_each_data_line(runs, key):
    """Every step's collectives and P2P pairs equal the model-1 run's of
    the same chain (2 ranks: data 2, or pod 2 x data 1), and the run is
    within the f32 limits of the unchained model-2 run."""
    against = {"f32 chain": "f32", "f32 streamed chain": "f32 sharded",
               "f32 pod chain": "f32 sharded"}[key]
    for r, got in enumerate(runs["model"]):
        # model rank r % 2 of data (or pod) rank r // 2
        ref = runs["two"][r // 2][key]
        assert got[key]["collectives"] == ref["collectives"], (r, key)
        assert got[key]["p2p"] == ref["p2p"], (r, key)
        assert all(got[key]["whole_equal"]), (r, key)
        _within_f32(got[key], got[against], key)
    rounds = sum(c.get("chain_rounds", 0)
                 for c in runs["model"][0][key]["collectives"])
    assert (rounds > 0) == (key != "f32 pod chain")


def test_planned_wire_bytes_equal_the_measured_at_model_two(runs):
    """The mixed wires at (2, 2): each phase's planned bytes, per model
    rank over its shard buckets, are the bytes its engine sent."""
    for r in runs["model"]:
        w = r[(2, 2, "mixed", False)]["wire"]
        assert w["ok"] and w["split"] and w["measured"] == w["planned"]
        assert w["stats"] == w["per_cycle"] > 0


def test_launcher_precision_and_streaming_at_model_two(runs):
    """``train(model=2)`` (data 2) on int8 wires, a bf16sr master, bf16
    compute and streamed gathers against the launcher's model-1 run at
    data 2, at the (b)/(c) limits; every rank's params alike."""
    want = runs["two"][0]["launcher"]
    for r in runs["model"]:
        assert r["launcher"]["shared_rows"] == 0
        _held(r["launcher"], want, "launcher")
        for a, b in zip(r["launcher"]["params"],
                        runs["model"][0]["launcher"]["params"]):
            assert np.array_equal(a, b)
