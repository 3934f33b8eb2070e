"""The FSDP archs over the 'model' mesh axis, and every family's gradients
there, against the JAX package.

One spawn of 4 gloo ranks runs both parts below; JAX's references run
beside it, each in a spawned process of its own.

* Gradients.  For each case of ``GRAD_CASES``, one ``loss_fn`` backward
  at (data, model) = (1, 4) or (2, 2) (each data row computes the whole
  batch), every rank's gradients gathered to the global tree
  (``gather_params``) and held leaf by leaf against ``jax.grad`` of JAX's
  ``loss_fn`` on one device, rtol 1e-4 / atol 1e-6 (rwkv6 at PERF.md's
  rwkv limits): qwen3-tiny (``q_norm`` / ``k_norm``), recurrentgemma-9b
  with ``n_heads=2`` (the gate blocks), rwkv6-1.6b (ddlerp, LoRA, ``w0``,
  the group norm), seamless-m4t-large-v2 (the memory's gradient),
  deepseek-v2-236b (MLA's latents, the router) and llama4 (the router,
  ``q_norm``) and deepseek-v2 with 3 experts and a shared ff of 129 over
  4 ranks (neither splits: one rank runs no expert, the shared experts run
  whole), each with the router's aux coefficient raised to
  ``AUX_COEF`` on both sides so that an aux term summed over 'model' once
  too often would lie far beyond the limit (AdamW's ``m / sqrt(v)`` all
  but cancels such a scale error, so the engine runs cannot see it), and
  the VLM at 5 layers (its gated cross block, the gate opened to 0.5).
  Beside each, ``SpanNorm`` of the same gradients in the flat layout
  (this rank's spans of a 2-shard layout at data 2, whole buffers at data
  1) against JAX's ``global_norm`` within 1e-6 relative.
* Engines.  deepseek-v2-236b-smoke at (2, 2), llama4-smoke at (1, 4) (one
  expert a rank) and the 5-layer VLM at (2, 2) on the sharded flat
  ``DeftRuntime(fsdp=True)`` (their default) over two schedule periods,
  then one DDP step from the same params, against JAX's one-device
  ``DeftRuntime(fsdp=True)`` and ``ddp_train_step`` (deepseek-v2 at data
  2, whose data ranks each route their own tokens at their own capacity,
  so that its loss is not the whole batch's: against JAX's engine on 2
  forced host devices, manual over 'data' as the port's, and JAX's DDP
  step of 2 micro-batches, each one data rank's rows): losses within rtol
  1e-4 / atol 1e-5, the engine's params within 1e-4 with at most one
  element in 1e5 beyond rtol 1e-4 / atol 1e-5 (the DDP step's within
  ``DDP_MAX_DIFF`` / ``DDP_MAX_OVER_SHARE``), every rank's gathered params
  bitwise rank
  0's (the whole leaves stay bitwise equal across the model ranks), each
  step's data-line collectives the sharded census
  (``phase_collectives_sharded`` counts the 'data' line only), and each
  update's one extra 'model' all-reduce (the clip norm's split part).

Params and batches are the port's (seed 0), handed to JAX as numpy.  The
spawned ranks import no JAX.
"""
import concurrent.futures
import dataclasses
import functools
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
import _torch_tiny as T
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import build_schedule
from repro_torch.models.model import init_params, loss_fn
from repro_torch.optim.optimizers import adamw
from repro_torch.sharding.tp import (
    ModelParallel,
    SpanNorm,
    gather_params,
    model_specs,
    shard_params,
    split_leaves,
)
from repro_torch.train.bucketing import build_bucket_layout, flatten_buckets
from repro_torch.train.runtime import (
    DataParallel,
    DeftRuntime,
    init_ddp_state,
    make_ddp_step,
)
from repro_torch.tree import (
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
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
from test_torch_tp_families import (
    RWKV_MAX_OVER_SHARE,
    RWKV_PARAM_MAX_DIFF,
)

WORLD = 4
B, S = 4, 32
GRAD_ATOL = 1e-6
NORM_RTOL = 1e-6
AUX_COEF = 1.0
VLM_GATE = 0.5
VLM = {"n_layers": 5}
# (id, arch (None: qwen3-tiny), config overrides on both sides, data, model)
GRAD_CASES = (
    ("qwen3-tiny", None, {}, 1, 4),
    ("recurrentgemma-2heads", "recurrentgemma-9b", {"n_heads": 2}, 1, 4),
    ("rwkv6", "rwkv6-1.6b", {}, 2, 2),
    ("seamless", "seamless-m4t-large-v2", {}, 2, 2),
    ("deepseek-v2", "deepseek-v2-236b", {"aux": AUX_COEF}, 2, 2),
    ("llama4", "llama4-maverick-400b-a17b", {"aux": AUX_COEF}, 1, 4),
    # 3 experts over 4 ranks (one rank runs none) and a shared ff of 129
    # columns: neither splits, so the expert leaves go in whole through
    # copy_in and the shared experts run whole on every rank
    ("deepseek-v2-uneven", "deepseek-v2-236b",
     {"aux": AUX_COEF, "moe": (("n_experts", 3), ("d_expert", 129))}, 1, 4),
    ("vlm-5layers", "llama-3.2-vision-90b", VLM, 2, 2),
)
# (id, arch, overrides, data, model, partition elements: each a schedule of
# period 3 with a merged update and a rotation)
ENGINE_CASES = (
    ("deepseek-v2-data2-model2", "deepseek-v2-236b", {}, 2, 2, 200_000),
    ("llama4-data1-model4", "llama4-maverick-400b-a17b", {}, 1, 4, 200_000),
    ("vlm-5layers-data2-model2", "llama-3.2-vision-90b", VLM, 2, 2, 400_000),
)
# One AdamW step from fresh moments moves an element by lr * g / (|g| +
# eps): where |g| sits at the f32 noise floor (about 1e-8 here: experts
# that see few tokens, the VLM's cross block over the 0.02-scale memory),
# a last-bit difference of g moves the param by a visible part of lr.  The
# port's unsplit DDP step (no model axis, the same data split) against
# JAX's on these configs reads 16 (llama4), 23 (deepseek-v2) and about 30
# (the VLM) elements beyond rtol 1e-4 / atol 1e-5, 1.1e-5 to 1.7e-5 of
# the params, and a largest difference of 1.1e-4 (llama4, the VLM), above
# the engines' 1e-4.  So the DDP step here is held to a quarter of one
# step of lr and two elements in 1e5; a fault of the split (a gradient
# summed twice, a wrong slice) moves whole leaves by about lr, and the
# gradients themselves are held at atol 1e-6 above.
DDP_MAX_DIFF = 2.5e-4
DDP_MAX_OVER_SHARE = 2e-5
# rwkv6's gradients amplify f32 rounding (PERF.md section 2): each leaf
# within 1e-2 of JAX's, at most 1% of its elements beyond rtol / atol 1e-4
RWKV_GRAD_TOL = 1e-4


def _with(cfg, kw):
    """``cfg`` with the case's overrides; ``moe`` holds (field, value)
    pairs of the MoE config, ``aux`` its router's aux coefficient."""
    kw = dict(kw)
    moe = dict(kw.pop("moe", ()))
    if "aux" in kw:
        moe["router_aux_coef"] = kw.pop("aux")
    if moe:
        kw["moe"] = dataclasses.replace(cfg.moe, **moe)
    return dataclasses.replace(cfg, **kw)


def _port_cfg(arch, kw):
    if arch is None:
        return T.port_cfg()
    return _with(t_reduce(t_get_config(arch)), kw)


def _jax_cfg(arch, kw):
    from repro.configs import get_config, reduce_for_smoke

    if arch is None:
        return dataclasses.replace(get_config("qwen3-4b"), **T.TINY)
    return _with(reduce_for_smoke(get_config(arch)), kw)


@functools.lru_cache(maxsize=None)
def _params(arch, kw):
    """The port's params (seed 0) as a numpy tree of JAX's structure, the
    VLM's gate opened to VLM_GATE (at 0 its cross block passes nothing
    back)."""
    tree = params_to_numpy(init_params(_port_cfg(arch, dict(kw)), seed=0,
                                       device="cpu"))
    return tree_unflatten(tree, [
        np.full_like(x, VLM_GATE) if "/".join(p).endswith("mixer/gate")
        else x for p, x in tree_flatten_with_path(tree)])


def _batch(tcfg, i=0):
    return {k: v.numpy() for k, v in
            make_batch(tcfg, 0, i, B, S, device="cpu").items()}


def _torch_batch(bt, rows=slice(None)):
    return {k: torch.from_numpy(v[rows]) if k == "memory"
            else torch.from_numpy(v[rows]).long() for k, v in bt.items()}


def _key(kw):
    return tuple(sorted(kw.items()))


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------
def _port_grads(j):
    """This rank's gradient case ``j``: the loss, the aux, the gathered
    gradient leaves and the span clip norm."""
    _, arch, kw, data, model = GRAD_CASES[j]
    tcfg = _port_cfg(arch, kw)
    mesh = make_debug_mesh(data=data, model=model)
    tp = ModelParallel(mesh)
    meta = init_params(tcfg, device="meta")
    specs = model_specs(meta, mesh)
    params = tree_map(lambda x: x.clone().requires_grad_(True), shard_params(
        params_from_numpy(_params(arch, _key(kw)), device="cpu"), specs,
        mesh))
    loss, parts = loss_fn(params, tcfg, _torch_batch(_batch(tcfg)), tp=tp)
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in tree_leaves(params)]
    full = gather_params(tree_unflatten(params, grads), specs, tp)
    # the flat layout of this rank's shards: three buckets of contiguous
    # leaves, 1/data of each a rank
    n = len(grads)
    local = shard_params(meta, specs, mesh)
    lay = build_bucket_layout(local, tuple(i * 3 // n for i in range(n)), 3,
                              shard_count=data)
    bufs = flatten_buckets(lay, [g.detach() for g in grads])
    norm = SpanNorm(lay, split_leaves(specs), tp)
    if data > 1:
        r = mesh.index("data")
        spans = [b[r * s:(r + 1) * s] for b, s in zip(bufs, lay.shard_sizes)]
        dp = DataParallel(mesh.group("data"), DataParallel.SHARDED)
        gn = norm(spans, shard_id=r, psum=dp.norm)
    else:
        gn = norm(bufs)
    return dict(loss=float(loss), aux=float(parts["aux"]), norm=float(gn),
                model_calls=dict(tp.calls),
                grads=[g.numpy() for g in tree_leaves(full)])


@functools.lru_cache(maxsize=None)
def _engine_plan(j):
    _, arch, kw, data, _, pe = ENGINE_CASES[j]
    tcfg = _port_cfg(arch, kw)
    meta = init_params(tcfg, device="meta")
    bo, nb, _, plan = build_schedule(meta, tcfg, dp=data, seq_len=S,
                                     per_device_batch=B // data,
                                     partition_elems=pe, coverage_rate=1.8)
    sched = plan.schedule
    batches = [_batch(tcfg, i) for i in range(2 * sched.period)]
    return dict(cfg=tcfg, meta=meta, bo=bo, nb=nb, sched=sched,
                batches=batches, params=_params(arch, _key(kw)))


def _port_engine(j):
    """This rank's engine case ``j``: the losses of two periods on the
    sharded flat engine, its collectives against its census, the 'model'
    all-reduces of each step, the gathered params; then one DDP step."""
    c = _engine_plan(j)
    _, _, _, data, model, _ = ENGINE_CASES[j]
    mesh = make_debug_mesh(data=data, model=model)
    specs = model_specs(c["meta"], mesh)
    lay = build_bucket_layout(shard_params(c["meta"], specs, mesh), c["bo"],
                              c["nb"], shard_count=data)
    rt = DeftRuntime(c["cfg"], adamw(LR), c["sched"], lay, device="cpu",
                     mesh=mesh, fsdp=True)
    state = rt.state_from_params(params_from_numpy(c["params"],
                                                   device="cpu"))
    per = B // mesh.dp_size
    rows = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
    census = rt.collectives_per_phase()
    losses, colls, calls, updates = [], [], [], []
    for i, bt in enumerate(c["batches"]):
        rt.tp.reset()
        state, m = rt.step(i, state, _torch_batch(bt, rows))
        losses.append(float(m["loss"]))
        colls.append(rt.last_collectives == census[i % c["sched"].period])
        calls.append(rt.tp.calls.get("all_reduce", 0))
        updates.append(c["sched"].phases[i % c["sched"].period].do_update)
    params = [x.numpy() for x in tree_leaves(rt.params_tree(state))]
    ddp = make_ddp_step(c["cfg"], adamw(LR), mesh=mesh)
    dstate = init_ddp_state(c["cfg"], adamw(LR), params=params_from_numpy(
        c["params"], device="cpu", mesh=mesh))
    dstate, dm = ddp(dstate, _torch_batch(c["batches"][0], rows))
    dparams = [x.numpy() for x in tree_leaves(gather_params(
        dstate["params"], specs, ModelParallel(mesh)))]
    return dict(losses=np.array(losses), collectives=np.array(colls),
                model_all_reduces=np.array(calls), updates=np.array(updates),
                sharded=np.array(rt.stats()["sharded_state"]),
                ddp_loss=np.array(float(dm["loss"])),
                **{f"p{i}": p for i, p in enumerate(params)},
                **{f"d{i}": p for i, p in enumerate(dparams)})


def _rank_main(rank, world, port, out_dir):
    _init(rank, world, port)
    for j in range(len(GRAD_CASES)):
        out = _port_grads(j)
        if rank == 0:
            np.save(os.path.join(out_dir, f"grad{j}.npy"), out,
                    allow_pickle=True)
    for j in range(len(ENGINE_CASES)):
        np.savez(os.path.join(out_dir, f"engine{j}_rank{rank}.npz"),
                 **_port_engine(j))


# ---------------------------------------------------------------------------
# JAX's references, each in a process of its own
# ---------------------------------------------------------------------------
def _jax_grads(j):
    """``jax.value_and_grad`` of JAX's ``loss_fn`` (no remat) on one
    device, and JAX's ``global_norm`` of the gradients."""
    import jax
    import jax.numpy as jnp
    import repro  # noqa: F401
    from repro.models.model import loss_fn as jax_loss_fn
    from repro.optim.optimizers import _global_norm

    _, arch, kw, _, _ = GRAD_CASES[j]
    cfg = _jax_cfg(arch, kw)
    bt = {k: jnp.asarray(v) if k == "memory" else jnp.asarray(
        v.astype(np.int32)) for k, v in _batch(_port_cfg(arch, kw)).items()}
    params = jax.tree.map(jnp.asarray, _params(arch, _key(kw)))
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, cfg, bt, remat=False), has_aux=True))(params)
    return dict(loss=float(loss), aux=float(parts["aux"]),
                norm=float(_global_norm(grads)),
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)])


def _per_shard_routing(j):
    """Whether case ``j`` routes MoE tokens per data shard: a data-parallel
    rank dispatches its own tokens at its own capacity, so at data > 1 a
    MoE config's loss is not the whole batch's."""
    _, _, _, data, _, _ = ENGINE_CASES[j]
    return data > 1 and _engine_plan(j)["cfg"].moe is not None


def _jax_engine(j):
    """JAX's sharded flat ``DeftRuntime`` (fsdp) over two periods and one
    ``ddp_train_step``, from the same params and batches: on one device
    (one shard), or, where MoE routes per data shard, on ``data`` forced
    host devices (``data`` shards; JAX's engine is manual over 'data', so
    each shard routes its own tokens) beside a DDP step of ``data``
    micro-batches (each one a data rank's rows: JAX's DDP step routes the
    whole batch)."""
    import jax
    import jax.numpy as jnp
    import repro  # noqa: F401
    from repro.core.scheduler import DeftSchedule, PhaseSpec
    from repro.optim.optimizers import adamw as jax_adamw
    from repro.optim.optimizers import init_opt_state as jax_init_opt_state
    from repro.train import runtime as jrt
    from repro.train.bucketing import build_bucket_layout as jax_layout

    c = _engine_plan(j)
    _, arch, kw, _, _, _ = ENGINE_CASES[j]
    cfg = _jax_cfg(arch, kw)
    sched = c["sched"]
    jsched = DeftSchedule(
        plans=(), phases=tuple(PhaseSpec(**p.__dict__) for p in sched.phases),
        period=sched.period, updates_per_period=sched.updates_per_period,
        batch_size_sequence=sched.batch_size_sequence)
    tree = jax.tree.map(jnp.asarray, c["params"])
    n = ENGINE_CASES[j][3] if _per_shard_routing(j) else 1
    assert jax.device_count() == n
    mesh = jax.make_mesh((n, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    opt = jax_adamw(LR)
    # init_state starts from these params, not a draw of its own
    jrt.init_params = lambda *a, **k: tree
    jb = lambda bt: {k: jnp.asarray(v) if k == "memory"
                     else jnp.asarray(v.astype(np.int32))
                     for k, v in bt.items()}
    losses = []
    with mesh:
        jr = jrt.DeftRuntime(cfg, opt, jsched,
                             jax_layout(c["params"], c["bo"], c["nb"],
                                        shard_count=n), mesh,
                             config=jrt.RuntimeConfig(fsdp=True))
        state = jr.init_state(jax.random.PRNGKey(0))
        for i, bt in enumerate(c["batches"]):
            state, m = jr.step(i, state, jb(bt))
            losses.append(float(m["loss"]))
        final = [np.asarray(x) for x in jax.tree.leaves(jr.params_tree(state))]
        sharded = bool(jr.stats()["sharded_state"])
        step = jrt.make_ddp_step(cfg, opt, donate=False,
                                 microbatch=n if n > 1 else 0)
        dstate, dm = step({"params": tree,
                           "opt": jax_init_opt_state(opt, tree)},
                          jb(c["batches"][0]))
    return dict(losses=np.array(losses), params=final, sharded=sharded,
                ddp_loss=float(dm["loss"]),
                ddp_params=[np.asarray(x)
                            for x in jax.tree.leaves(dstate["params"])])


def _jax_jobs(jobs):
    """The references of ``jobs`` ((kind, case) pairs) in turn, in one
    process: its compiler warms up once."""
    return [(_jax_grads if kind == "grad" else _jax_engine)(j)
            for kind, j in jobs]


def _force_devices(n):
    """A pool worker's initializer: ``n`` host devices for JAX, set before
    it is imported."""
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (spawned first) and JAX's references, computed
    while the ranks run, each in a spawned process."""
    out_dir = str(tmp_path_factory.mktemp("tp_fsdp"))
    procs = _spawn(_rank_main, WORLD, out_dir)
    ctx = mp.get_context("spawn")
    many = [j for j in range(len(ENGINE_CASES)) if _per_shard_routing(j)]
    # one process an engine reference, the gradients' in two (the heaviest
    # compiles first in each)
    batches = [[("engine", j)] for j in range(len(ENGINE_CASES))
               if j not in many]
    order = sorted(range(len(GRAD_CASES)),
                   key=lambda j: GRAD_CASES[j][1] not in (
                       "deepseek-v2-236b", "llama-3.2-vision-90b"))
    batches += [[("grad", j) for j in order[k::2]] for k in range(2)]
    pools = [concurrent.futures.ProcessPoolExecutor(
        1, mp_context=ctx, initializer=_force_devices,
        initargs=(ENGINE_CASES[j][3],)) for j in many]
    with concurrent.futures.ProcessPoolExecutor(len(batches),
                                                mp_context=ctx) as pool:
        futs = [(jobs, q.submit(_jax_jobs, jobs)) for jobs, q in zip(
            [[("engine", j)] for j in many], pools)]
        futs += [(jobs, pool.submit(_jax_jobs, jobs)) for jobs in batches]
        refs = {job: out for jobs, f in futs
                for job, out in zip(jobs, f.result())}
    for q in pools:
        q.shutdown()
    _join(procs)
    grads = [np.load(os.path.join(out_dir, f"grad{j}.npy"),
                     allow_pickle=True).item()
             for j in range(len(GRAD_CASES))]
    engines = [[dict(np.load(os.path.join(out_dir,
                                          f"engine{j}_rank{r}.npz")))
                for r in range(WORLD)] for j in range(len(ENGINE_CASES))]
    return grads, engines, refs


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
def _split(arch, kw, data, model, *path):
    meta = init_params(_port_cfg(arch, kw), device="meta")
    leaf = model_specs(meta, {"data": data, "model": model})
    for key in path:
        leaf = leaf[key]
    return [a for a in leaf if a is not None]


def test_cases_split_as_described():
    """The splits the cases are chosen for, read off ``spec_tree``: MLA's
    up-projections and ``wo`` over 'heads', its down-projections whole; the
    experts over 'experts', the router whole, the shared experts over
    'ff'; the VLM's cross block over its heads, its gate whole."""
    ds = ("deepseek-v2-236b", {})
    assert _split(*ds, 2, 2, "stack", 0, "mixer", "wuq") == ["model"]
    assert _split(*ds, 2, 2, "stack", 0, "mixer", "wo") == ["model"]
    assert _split(*ds, 2, 2, "stack", 0, "mixer", "wdq") == []
    assert _split(*ds, 2, 2, "stack", 0, "mixer", "wdkv") == []
    assert _split(*ds, 2, 2, "stack", 0, "ffn", "experts", "gate") \
        == ["model"]
    assert _split(*ds, 2, 2, "stack", 0, "ffn", "router") == []
    assert _split(*ds, 2, 2, "stack", 0, "ffn", "shared", "down") \
        == ["model"]
    l4 = ("llama4-maverick-400b-a17b", {})
    assert _split(*l4, 1, 4, "stack", 1, "ffn", "experts", "down") \
        == ["model"]
    assert _split(*l4, 1, 4, "stack", 1, "mixer", "q_norm") == []
    uneven = ("deepseek-v2-236b", GRAD_CASES[6][2])
    assert _split(*uneven, 1, 4, "stack", 0, "ffn", "experts", "up") == []
    assert _split(*uneven, 1, 4, "stack", 0, "ffn", "shared", "up") == []
    vlm = ("llama-3.2-vision-90b", VLM)
    assert _split(*vlm, 2, 2, "stack", 4, "mixer", "wq") == ["model"]
    assert _split(*vlm, 2, 2, "stack", 4, "mixer", "gate") == []


@pytest.mark.parametrize("j", range(len(GRAD_CASES)),
                         ids=[c[0] for c in GRAD_CASES])
def test_gradients_match_jax_grad(runs, j):
    grads, _, refs = runs
    got, want = grads[j], refs[("grad", j)]
    _, arch, kw, _, model = GRAD_CASES[j]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=RTOL,
                               atol=ATOL)
    if "aux" in kw:
        assert got["aux"] > 0.1                  # the raised aux counts
    assert got["model_calls"]["all_reduce"] > 0
    assert len(got["grads"]) == len(want["grads"])
    for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        assert g.shape == w.shape, i
        if arch == "rwkv6-1.6b":
            np.testing.assert_allclose(g, w, rtol=0, atol=RWKV_PARAM_MAX_DIFF,
                                       err_msg=str(i))
            over = np.sum(np.abs(g - w) > RWKV_GRAD_TOL * (1 + np.abs(w)))
            assert over <= RWKV_MAX_OVER_SHARE * w.size, (i, over)
            continue
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=GRAD_ATOL,
                                   err_msg=str(i))


@pytest.mark.parametrize("j", range(len(GRAD_CASES)),
                         ids=[c[0] for c in GRAD_CASES])
def test_span_norm_is_jax_global_norm(runs, j):
    grads, _, refs = runs
    got, want = grads[j]["norm"], refs[("grad", j)]["norm"]
    assert want > 0
    assert abs(got - want) <= NORM_RTOL * want, (got, want)


@pytest.mark.parametrize("j", range(len(ENGINE_CASES)),
                         ids=[c[0] for c in ENGINE_CASES])
def test_sharded_engine_matches_jax_on_one_device(runs, j):
    _, engines, refs = runs
    ref = refs[("engine", j)]
    sched = _engine_plan(j)["sched"]
    assert max(p.update_k for p in sched.phases) > 1
    assert any(p.rotate for p in sched.phases)
    assert ref["sharded"]
    n = len(ref["params"])
    for r, run in enumerate(engines[j]):
        assert run["sharded"], r
        assert run["collectives"].all(), r
        # the clip norm's split part: one 'model' all-reduce an update
        calls, upd = run["model_all_reduces"], run["updates"]
        base = calls[~upd]
        assert len(set(base)) == 1 and set(calls[upd]) == {base[0] + 1}, \
            (r, calls, upd)
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(run["ddp_loss"], ref["ddp_loss"],
                                   rtol=RTOL, atol=ATOL)
        for i in range(n):
            assert np.array_equal(run[f"p{i}"], engines[j][0][f"p{i}"]), (r, i)
            assert np.array_equal(run[f"d{i}"], engines[j][0][f"d{i}"]), (r, i)
    size = sum(p.size for p in ref["params"])
    over = sum(_n_over(engines[j][0][f"p{i}"], w)
               for i, w in enumerate(ref["params"]))
    assert over <= MAX_OVER_SHARE * size, (over, size)
    over = 0
    for i, w in enumerate(ref["ddp_params"]):
        got = engines[j][0][f"d{i}"]
        np.testing.assert_allclose(got, w, rtol=0, atol=DDP_MAX_DIFF)
        over += int(np.sum(np.abs(got - w) > ATOL + RTOL * np.abs(w)))
    assert over <= DDP_MAX_OVER_SHARE * size, (over, size)
