"""The model mesh axis of the port against the JAX package.

* (a) Specs: ``sharding.specs.spec_tree`` / ``param_rules`` / ``batch_axes``
  and the rule tables equal JAX's, leaf for leaf, for all ten configs on
  ``jax.sharding.AbstractMesh`` (16, 16), (2, 2) and (1, 4), with the
  'tp' and 'dp' layouts ('dp' refused for the FSDP archs in both), and
  ``spec_for``'s divisibility rule equal JAX's.
* (b) The TP Functions (``sharding/tp.py``) at 2 spawned gloo ranks, model
  2: ``copy_in``, ``reduce_out``, ``gather`` and ``vocab_embed`` forward
  and gradients equal to the unsplit op (float64, exact); the
  vocab-parallel cross entropy behind gemma2's final softcap through
  ``chunked_ce`` within 1e-6 of the unsplit ``chunked_ce`` and of JAX's,
  its gradients within 1e-6, and a float64 gradcheck of it; the
  refusals at model 2 naming ROADMAP item 8.2, and the three FSDP archs
  (MLA, MoE, the VLM's gated cross block) constructed at model 2 on both
  flat engines and on DDP.
* (c) One spawn of 4 gloo ranks runs the replicated flat ``DeftRuntime``
  over a mesh for two periods, then one DDP step from the same params, at
  qwen3-tiny (data 2, model 2), qwen3-tiny (data 1, model 4), where the
  kv projection splits inside a head, and gemma2-2b-smoke (data 2, model
  2, the chunked LM head): losses and gathered params within rtol 1e-4 /
  atol 1e-5 of JAX's ``DeftRuntime`` and ``ddp_train_step`` on its one
  CPU device fed the same numpy batches (the engine's params: at most one
  element in 1e5 beyond, each within 1e-4, as the port's one-rank engine
  needs on gemma2; ``MAX_OVER_SHARE``) (JAX's partitioner computes the
  same function on every mesh; only the order of the row-parallel sums
  moves), every rank's gathered params bitwise rank 0's (so the leaves
  kept whole are bitwise equal across model ranks), each phase's
  collectives ``phase_collectives``.
* (d) A model-1 mesh through the new path is bitwise the engine built
  without one, at one rank and at 4 gloo ranks (data 4).
* The attention at model 4 where the heads split unevenly (inside a head,
  or not at all) against the unsplit one, output and gradients.
* The launcher's ``train(model=2)`` (DeFT and DDP) at 2 gloo ranks within
  rtol 1e-4 / atol 1e-5 of its model-1 run at one rank.

Params and batches are the port's (seed 0), handed to JAX as numpy.  The
spawned ranks import no JAX (this module imports it inside functions).
"""
import dataclasses
import functools
import multiprocessing as mp
import os
import socket

import numpy as np
import pytest
import torch

import _torch_tiny as T
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import build_schedule, init_distributed, train
from repro_torch.models.model import chunked_ce, init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.sharding import (
    axis_names,
    rules_deft_manual_dp,
    rules_deft_rs_manual_pod,
    rules_pjit,
    spec_for,
)
from repro_torch.sharding.specs import batch_axes, param_rules, spec_tree
from repro_torch.sharding.tp import (
    ModelParallel,
    copy_in,
    gather,
    gather_params,
    model_specs,
    reduce_out,
    shard_params,
    vocab_embed,
    vocab_parallel_nll,
)
from repro_torch.train.bucketing import build_bucket_layout
from repro_torch.train.runtime import (
    DeftRuntime,
    init_ddp_state,
    make_ddp_step,
    phase_collectives,
)
from repro_torch.tree import tree_leaves

LR = 1e-3
RTOL, ATOL = 1e-4, 1e-5
CE_TOL = 1e-6
# AdamW divides each element's step by its own gradient's magnitude, so
# where a gradient is near zero the reduction-order noise moves the param
# by a visible fraction of lr (a first AdamW step moves every element by
# about 0.45 lr whatever its gradient's size): the port's one-rank engine
# already has 2 of gemma2-2b-smoke's params beyond rtol / atol of JAX after
# the two periods (1.6e-5 and 1.4e-5).  So at most one element in 1e5 may
# lie beyond, none beyond a tenth of one step of lr.
STEP_TOL = 1e-4
MAX_OVER_SHARE = 1e-5
# the FSDP archs, whose blocks (MLA, MoE, the VLM's gated cross block) the
# 'model' axis refused until ROADMAP item 8.1 was done, with their smoke
# overrides: the VLM's smoke depth of 3 holds no gated cross block, its 5
# layers (one pattern period) hold one
FSDP_FAMILIES = {"deepseek-v2-236b": {}, "llama4-maverick-400b-a17b": {},
                 "llama-3.2-vision-90b": {"n_layers": 5}}
# (name, data, model, loss chunk)
MESHES = (("qwen3-tiny", 2, 2, 0), ("qwen3-tiny", 1, 4, 0),
          ("gemma2-2b-smoke", 2, 2, 16))


def _case(name):
    """(port cfg, global batch, seq, partition) of a case's config."""
    if name == "qwen3-tiny":
        return T.port_cfg(), 4, 32, 40_000
    return t_reduce(t_get_config("gemma2-2b")), 4, 80, 120_000


def _plan(name):
    """The case's params (seed 0), schedule, buckets and numpy batches of
    two periods, the same in every process (planner and draws are
    deterministic)."""
    tcfg, b, s, pe = _case(name)
    meta = init_params(tcfg, device="meta")
    bo, nb, _, plan = build_schedule(meta, tcfg, dp=2, seq_len=s,
                                     per_device_batch=b // 2,
                                     partition_elems=pe, coverage_rate=1.8)
    sched = plan.schedule
    batches = [{k: v.numpy() for k, v in
                make_batch(tcfg, 0, i, b, s, device="cpu").items()}
               for i in range(2 * sched.period)]
    return dict(cfg=tcfg, meta=meta, bo=bo, nb=nb, sched=sched,
                batches=batches, params=init_params(tcfg, seed=0,
                                                    device="cpu"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(target, world, out_dir):
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs):
    for p in procs:
        p.join(timeout=300)
        assert not p.is_alive() and p.exitcode == 0, p.exitcode


def _init(rank, world, port):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)


# ---------------------------------------------------------------------------
# (a) specs
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models.model import init_params as jax_init_params

    cfg = get_config(arch)
    return jax.eval_shape(
        lambda k: jax_init_params(k, cfg, dtype=jnp.bfloat16),
        jax.ShapeDtypeStruct((2,), jnp.uint32))


def _jax_specs(arch, shape, layout):
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.sharding.specs import param_rules as jax_param_rules
    from repro.sharding.specs import spec_tree as jax_spec_tree

    params = _jax_shapes(arch)
    mesh = jax.sharding.AbstractMesh(
        shape, ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    specs = jax_spec_tree(params, jax_param_rules(arch, False, layout), mesh)
    return mesh, [_names(x) for x in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))]


def _names(spec):
    """A spec as the tuple of mesh-axis names of each dim (jax 0.9's
    ``PartitionSpec`` writes a one-axis tuple as the axis)."""
    return tuple(axis_names(a) for a in spec)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_tree_equals_jax(arch):
    import repro  # noqa: F401  (the jax compat shims)

    meta = init_params(t_get_config(arch), device="meta")
    for shape in ((16, 16), (2, 2), (1, 4)):
        for layout in ("tp", "dp"):
            if layout == "dp" and _needs_fsdp(arch):
                with pytest.raises(AssertionError):
                    _jax_specs(arch, shape, layout)
                with pytest.raises(ValueError):
                    param_rules(arch, False, layout)
                continue
            mesh, want = _jax_specs(arch, shape, layout)
            got = spec_tree(meta, param_rules(arch, False, layout), mesh)
            got = [_names(s) for s in tree_leaves(got)]
            assert got == want, (arch, shape, layout)
            # the same mesh as a plain {axis: size} mapping
            assert [_names(s) for s in tree_leaves(spec_tree(
                meta, param_rules(arch, False, layout),
                dict(zip(("data", "model"), shape))))] == want


def _needs_fsdp(arch):
    from repro.sharding.specs import needs_fsdp as jax_needs_fsdp
    from repro_torch.sharding import needs_fsdp

    assert needs_fsdp(arch) == jax_needs_fsdp(arch)
    return needs_fsdp(arch)


def test_rule_tables_and_spec_for_equal_jax():
    import jax
    import repro  # noqa: F401
    from repro import sharding as js
    from repro.sharding import specs as jspecs

    for mp_ in (False, True):
        for fsdp in (False, True):
            for layout in ("tp", "dp"):
                assert rules_pjit(mp_, fsdp, layout) == \
                    js.rules_pjit(mp_, fsdp, layout)
        for layout in ("tp", "dp"):
            assert batch_axes(mp_, layout) == jspecs.batch_axes(mp_, layout)
    assert rules_deft_manual_dp() == js.rules_deft_manual_dp()
    assert rules_deft_rs_manual_pod() == js.rules_deft_rs_manual_pod()
    mesh = jax.sharding.AbstractMesh(
        (16, 16), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = rules_pjit(False, False)
    with jax.sharding.use_abstract_mesh(mesh):
        with js.logical_rules(rules):
            for names, shape in (
                    (("batch", None, "heads", None), (32, 8, 36, 128)),
                    (("batch", None, "heads", None), (32, 8, 32, 128)),
                    (("batch", "seq", "embed"), (48, 7, 2304)),
                    ((None, "vocab"), (3, 256000)),
                    ((None, "vocab"), (3, 256206))):
                want = _names(js.spec_for(names, shape))
                assert _names(spec_for(names, rules, mesh.shape, shape)) \
                    == want, (names, shape)


# ---------------------------------------------------------------------------
# (b) the TP Functions at 2 ranks
# ---------------------------------------------------------------------------
class _Split(torch.autograd.Function):
    """This rank's slice of a tensor every rank holds whole, its gradient
    all-gathered back (so a check over the whole tensor sees every
    rank's contribution)."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        n = x.shape[dim] // tp.size
        return x.narrow(dim, tp.rank * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_gather(g.contiguous(), ctx.dim), None, None


def _functions_main(rank, world, port, out_dir):
    _init(rank, world, port)
    mesh = make_debug_mesh(data=1, model=world)
    tp = ModelParallel(mesh)
    out = {}
    g64 = lambda seed, *shape: torch.randn(
        shape, generator=torch.Generator().manual_seed(seed),
        dtype=torch.float64)
    # copy_in: identity forward, the gradient summed over the ranks
    x = g64(0, 3, 4).requires_grad_()
    y = copy_in(x, tp)
    (y * g64(10 + rank, 3, 4)).sum().backward()
    out["copy_in_fwd"] = float((y - x).detach().abs().max())
    out["copy_in_grad"] = float((x.grad - sum(
        g64(10 + r, 3, 4) for r in range(world))).abs().max())
    # reduce_out: the sum forward, identity backward
    x = g64(20 + rank, 3, 4).requires_grad_()
    y = reduce_out(x, tp)
    w = g64(1, 3, 4)
    (y * w).sum().backward()
    out["reduce_out_fwd"] = float((y - sum(g64(20 + r, 3, 4)
                                           for r in range(world))).abs().max())
    out["reduce_out_grad"] = float((x.grad - w).abs().max())
    # gather along the last dim: the concatenation, its gradient the sum
    # of every rank's cotangent on this rank's columns
    x = g64(30 + rank, 3, 4).requires_grad_()
    y = gather(x, tp, dim=-1)
    (y * g64(40 + rank, 3, 4 * world)).sum().backward()
    want = torch.cat([g64(30 + r, 3, 4) for r in range(world)], dim=-1)
    cot = sum(g64(40 + r, 3, 4 * world) for r in range(world))
    out["gather_fwd"] = float((y - want).abs().max())
    out["gather_grad"] = float((x.grad - cot[:, 4 * rank:4 * rank + 4])
                               .abs().max())
    # vocab_embed against the whole table's lookup
    table = g64(2, 10, 4)
    tokens = torch.tensor([[0, 9, 4, 5, 5], [3, 7, 1, 0, 8]])
    shard = table[5 * rank:5 * rank + 5].clone().requires_grad_()
    y = vocab_embed(shard, tokens, tp)
    w = g64(3, 2, 5, 4)
    (y * w).sum().backward()
    full = table.clone().requires_grad_()
    (full[tokens] * w).sum().backward()
    out["embed_fwd"] = float((y - table[tokens]).abs().max())
    out["embed_grad"] = float((shard.grad - full.grad[5 * rank:5 * rank + 5])
                              .abs().max())
    # the vocab-parallel CE behind gemma2's final softcap, through
    # chunked_ce, against the unsplit chunked_ce (f32)
    cfg = t_reduce(t_get_config("gemma2-2b"))
    g32 = torch.Generator().manual_seed(4)
    xs = torch.randn((2, 24, cfg.d_model), generator=g32)
    tab = torch.randn((cfg.vocab_size, cfg.d_model), generator=g32) * 0.05
    tgt = torch.randint(0, cfg.vocab_size, (2, 24), generator=g32)
    n = cfg.vocab_size // world
    xa = xs.clone().requires_grad_()
    ta = tab[rank * n:(rank + 1) * n].clone().requires_grad_()
    loss = chunked_ce({"embed": {"table": ta}}, cfg, xa, tgt, None, 8, tp=tp)
    loss.backward()
    xb = xs.clone().requires_grad_()
    tb = tab.clone().requires_grad_()
    ref = chunked_ce({"embed": {"table": tb}}, cfg, xb, tgt, None, 8)
    ref.backward()
    out["ce_loss"] = float(loss)
    out["ce_vs_port"] = abs(float(loss) - float(ref))
    out["ce_grad_x"] = float((xa.grad - xb.grad).abs().max())
    out["ce_grad_table"] = float(
        (ta.grad - tb.grad[rank * n:(rank + 1) * n]).abs().max())
    np.savez(os.path.join(out_dir, "ce_inputs.npz"), x=xs.numpy(),
             table=tab.numpy(), targets=tgt.numpy())
    # float64 gradcheck of the vocab-parallel nll behind a softcap (in
    # float64: ``models.common.softcap`` computes in f32)
    logits = g64(5, 2, 3, 6).requires_grad_()
    labels = torch.tensor([[0, 5, 3], [2, 2, 4]])
    fn = lambda lg: vocab_parallel_nll(
        30.0 * torch.tanh(_Split.apply(lg, tp, 2) / 30.0), labels, tp)
    out["gradcheck"] = bool(torch.autograd.gradcheck(fn, (logits,)))
    # the refusals at model 2
    out["refusals"] = _refusals(mesh)
    out["launcher"] = _launcher_losses(model=world)
    np.save(os.path.join(out_dir, f"fns{rank}.npy"), out, allow_pickle=True)


def _launcher_losses(**mesh):
    """``train``'s losses of three DeFT steps and two DDP steps of
    qwen3-tiny on the CPU (global batch 2 x 32) under ``mesh`` (the
    launcher's ``data`` / ``model``)."""
    out = {}
    for scheduler, steps in (("deft", 3), ("ddp", 2)):
        res = train(T.port_cfg(), scheduler=scheduler, steps=steps, batch=2,
                    seq=32, partition_elems=40_000, device="cpu",
                    log=lambda msg: None, **mesh)
        out[scheduler] = res["losses"]
    return out


def _refusals(mesh):
    """The message of each refused construction or call at model 2."""
    got = {}
    cfg = t_reduce(t_get_config("gemma2-2b"))
    meta = init_params(cfg, device="meta")
    bo, nb, _, plan = build_schedule(meta, cfg, dp=1, seq_len=32,
                                     per_device_batch=2,
                                     partition_elems=120_000,
                                     coverage_rate=1.8)
    lay = build_bucket_layout(shard_params(meta, model_specs(meta, mesh),
                                           mesh), bo, nb)
    shard_lay = build_bucket_layout(shard_params(
        meta, model_specs(meta, mesh), mesh), bo, nb,
        shard_count=mesh.size("data"))

    def refused(key, fn):
        try:
            fn()
        except NotImplementedError as e:
            got[key] = str(e)
        else:
            got[key] = None

    mk = lambda c=cfg, layout=lay, **kw: DeftRuntime(
        c, adamw(LR), plan.schedule, layout, device="cpu", mesh=mesh, **kw)
    refused("tree", lambda: mk(flat_state=False))
    refused("bf16", lambda: mk(compute_dtype=torch.bfloat16))
    refused("bf16sr", lambda: mk(master_dtype="bf16sr"))
    refused("wires", lambda: DeftRuntime(
        cfg, adamw(LR), plan.schedule,
        lay.with_precision(PrecisionPolicy.uniform(nb, "bf16")),
        device="cpu", mesh=mesh))
    refused("chain", lambda: mk(secondary_chain=(0,)))
    refused("decoupled", lambda: mk(fsdp=True, decoupled=True,
                                    layout=shard_lay))
    for arch, kw in FSDP_FAMILIES.items():
        fcfg = dataclasses.replace(t_reduce(t_get_config(arch)), **kw)
        fmeta = init_params(fcfg, device="meta")
        fbo, fnb, _, fplan = build_schedule(
            fmeta, fcfg, dp=1, seq_len=32, per_device_batch=2,
            partition_elems=120_000, coverage_rate=1.8)
        flay = build_bucket_layout(shard_params(
            fmeta, model_specs(fmeta, mesh), mesh), fbo, fnb,
            shard_count=mesh.size("data"))
        for fsdp in (True, False):
            refused(f"{arch} fsdp={fsdp}", lambda: DeftRuntime(
                fcfg, adamw(LR), fplan.schedule, flay, device="cpu",
                mesh=mesh, fsdp=fsdp))
        refused(f"{arch} ddp", lambda: make_ddp_step(fcfg, adamw(LR),
                                                      mesh=mesh))
    rt = mk()
    state = rt.init_state(0)
    refused("state_to_tree", lambda: rt.state_to_tree(state))
    refused("prepare_swap", lambda: rt.prepare_swap(plan.schedule))
    refused("spawn", lambda: rt.spawn())
    return got


@pytest.fixture(scope="module")
def functions(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("tp_functions"))
    _join(_spawn(_functions_main, 2, out_dir))
    runs = [np.load(os.path.join(out_dir, f"fns{r}.npy"),
                    allow_pickle=True).item() for r in range(2)]
    return runs, dict(np.load(os.path.join(out_dir, "ce_inputs.npz")))


def test_tp_functions_equal_the_unsplit_ops(functions):
    runs, _ = functions
    for r, out in enumerate(runs):
        for key in ("copy_in", "reduce_out", "gather", "embed"):
            assert out[f"{key}_fwd"] == 0.0, (r, key)
            assert out[f"{key}_grad"] <= 1e-15, (r, key, out[f"{key}_grad"])


def test_vocab_parallel_ce_matches_chunked_ce(functions):
    import jax.numpy as jnp
    from repro.configs import get_config, reduce_for_smoke
    from repro.models.model import chunked_ce as jax_chunked_ce

    runs, inp = functions
    cfg = reduce_for_smoke(get_config("gemma2-2b"))
    want = float(jax_chunked_ce({"embed": {"table": jnp.asarray(
        inp["table"])}}, cfg, jnp.asarray(inp["x"]),
        jnp.asarray(inp["targets"]), None, 8))
    for out in runs:
        assert out["ce_loss"] == runs[0]["ce_loss"]
        assert abs(out["ce_loss"] - want) <= CE_TOL, (out["ce_loss"], want)
        assert out["ce_vs_port"] <= CE_TOL
        assert out["ce_grad_x"] <= CE_TOL and out["ce_grad_table"] <= CE_TOL
        assert out["gradcheck"]


def test_model_axis_refusals(functions):
    """The engines and paths of ROADMAP item 8.2 refuse model 2, each
    naming the item: the tree-state engine, a bf16 compute dtype, a bf16sr
    master, non-f32 wires, a chain, AG streaming, a checkpoint save, a
    swap and a spawn.  The three FSDP archs, refused here until MLA's
    heads, MoE's experts and the VLM's gated cross block ran over 'model'
    (item 8.1), construct at model 2 on both flat engines and on DDP; they
    are held to JAX in ``tests/test_torch_tp_fsdp.py``, as
    recurrentgemma-9b, rwkv6-1.6b and seamless-m4t-large-v2 are in
    ``tests/test_torch_tp_families.py``."""
    runs, _ = functions
    got = runs[0]["refusals"]
    for key in ("tree", "bf16", "bf16sr", "wires", "chain", "decoupled",
                "state_to_tree", "prepare_swap", "spawn"):
        assert got[key] is not None and "ROADMAP item 8.2" in got[key], key
    for arch in FSDP_FAMILIES:
        for engine in ("fsdp=True", "fsdp=False", "ddp"):
            assert got[f"{arch} {engine}"] is None, (arch, engine)


# ---------------------------------------------------------------------------
# (c) the engine and DDP at 4 ranks against JAX on one device
# ---------------------------------------------------------------------------
def _port_case(name, data, model, chunk):
    """This rank's run of one mesh case: the losses of two periods, the
    gathered params after them, then one DDP step's loss and params."""
    c = _plan(name)
    mesh = make_debug_mesh(data=data, model=model)
    specs = model_specs(c["meta"], mesh)
    lay = build_bucket_layout(shard_params(c["meta"], specs, mesh), c["bo"],
                              c["nb"])
    rt = DeftRuntime(c["cfg"], adamw(LR), c["sched"], lay, device="cpu",
                     mesh=mesh, loss_chunk=chunk)
    state = rt.state_from_params(c["params"])
    per = c["batches"][0]["tokens"].shape[0] // mesh.dp_size
    rows = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
    local = lambda bt: {k: torch.from_numpy(v[rows]).long()
                        for k, v in bt.items()}
    losses, colls = [], []
    for i, bt in enumerate(c["batches"]):
        state, m = rt.step(i, state, local(bt))
        losses.append(float(m["loss"]))
        colls.append(rt.last_collectives
                     == phase_collectives(c["sched"].phases[i % c["sched"]
                                                           .period]))
    params = [x.numpy() for x in tree_leaves(rt.params_tree(state))]
    ddp = make_ddp_step(c["cfg"], adamw(LR), mesh=mesh, loss_chunk=chunk)
    dstate = init_ddp_state(c["cfg"], adamw(LR), params=params_from_numpy(
        params_to_numpy(c["params"]), device="cpu", mesh=mesh))
    dstate, dm = ddp(dstate, local(c["batches"][0]))
    dparams = [x.numpy() for x in tree_leaves(gather_params(
        dstate["params"], specs, ModelParallel(mesh)))]
    return dict(losses=np.array(losses), collectives=np.array(colls),
                ddp_loss=np.array(float(dm["loss"])),
                **{f"p{i}": p for i, p in enumerate(params)},
                **{f"d{i}": p for i, p in enumerate(dparams)})


def _engine_main(rank, world, port, out_dir):
    _init(rank, world, port)
    for j, case in enumerate(MESHES):
        np.savez(os.path.join(out_dir, f"case{j}_rank{rank}.npz"),
                 **_port_case(*case))
    np.save(os.path.join(out_dir, f"extra_rank{rank}.npy"),
            {"model1": _model_one_bitwise(world),
             "odd_heads": _odd_heads(make_debug_mesh(data=1, model=world))},
            allow_pickle=True)


def _odd_heads(mesh):
    """``apply_self_attention`` at model ``mesh.size('model')`` against the
    unsplit attention where the heads do not split evenly: 6 heads over 2
    kv heads of 16 (q split inside a head, kv gathered) and 5 heads over 1
    of 6 (neither splits: each rank takes whole heads of the replicated
    weights, one rank two).  The largest |diff| of the output and of every
    gradient (the split leaves' gathered), per case."""
    from repro_torch.models.attention import apply_self_attention

    tp = ModelParallel(mesh)
    out = {}
    for h, kv, hd in ((6, 2, 16), (5, 1, 6)):
        cfg = dataclasses.replace(T.port_cfg(), n_heads=h, n_kv_heads=kv,
                                  head_dim=hd, d_model=32)
        g = torch.Generator().manual_seed(h)
        rnd = lambda *shape: torch.randn(shape, generator=g) * 0.2
        tree = {"mixer": {"wq": rnd(32, h * hd), "wk": rnd(32, kv * hd),
                          "wv": rnd(32, kv * hd), "wo": rnd(h * hd, 32),
                          "q_norm": rnd(hd), "k_norm": rnd(hd)}}
        x, cot = rnd(2, 12, 32), rnd(2, 12, 32)
        specs = model_specs(tree, mesh)
        runs = []
        for local in (None, shard_params(tree, specs, mesh)):
            p = {k: v.clone().requires_grad_()
                 for k, v in (local or tree)["mixer"].items()}
            xi = x.clone().requires_grad_()
            y = apply_self_attention(p, xi, cfg=cfg, window=0,
                                     tp=None if local is None else tp)
            (y * cot).sum().backward()
            grads = {"mixer": {k: v.grad for k, v in p.items()}}
            if local is not None:
                grads = gather_params(grads, specs, tp)
            runs.append([y.detach(), xi.grad] + tree_leaves(grads))
        out[f"{h}x{kv}x{hd}"] = max(float((a - b).abs().max())
                                    for a, b in zip(*runs))
    return out


def _model_one_bitwise(world) -> bool:
    """Whether qwen3-tiny over two periods on a (data ``world``, model 1)
    mesh is bitwise the engine over the world's group without a mesh."""
    c = _plan("qwen3-tiny")
    lay = build_bucket_layout(c["meta"], c["bo"], c["nb"])
    per = c["batches"][0]["tokens"].shape[0] // world
    rank = torch.distributed.get_rank()
    runs = []
    for mesh in (None, make_debug_mesh(data=world, model=1)):
        rt = DeftRuntime(c["cfg"], adamw(LR), c["sched"], lay, device="cpu",
                         mesh=mesh)
        state = rt.state_from_params(c["params"])
        losses = []
        for i, bt in enumerate(c["batches"]):
            state, m = rt.step(i, state, {
                k: torch.from_numpy(v[rank * per:(rank + 1) * per]).long()
                for k, v in bt.items()})
            losses.append(float(m["loss"]))
        runs.append((losses, [b.clone() for b in state["pbuf"]]))
    return runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def _jax_reference(name, chunk, single_mesh):
    """JAX's flat ``DeftRuntime`` over two periods and one
    ``ddp_train_step`` on its one CPU device, from the same params and
    batches."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduce_for_smoke
    from repro.core.scheduler import DeftSchedule, PhaseSpec
    from repro.kernels.bucket_update import init_flat_opt_state
    from repro.optim.optimizers import adamw as jax_adamw
    from repro.optim.optimizers import init_opt_state as jax_init_opt_state
    from repro.train import runtime as jrt
    from repro.train.bucketing import build_bucket_layout as jax_layout
    from repro.train.bucketing import flatten_buckets as jax_flatten

    c = _plan(name)
    cfg = (dataclasses.replace(get_config("qwen3-4b"), **T.TINY)
           if name == "qwen3-tiny" else reduce_for_smoke(get_config(
               "gemma2-2b")))
    sched = c["sched"]
    jsched = DeftSchedule(
        plans=(), phases=tuple(PhaseSpec(**p.__dict__) for p in sched.phases),
        period=sched.period, updates_per_period=sched.updates_per_period,
        batch_size_sequence=sched.batch_size_sequence)
    params = params_to_numpy(c["params"])
    lay = jax_layout(params, c["bo"], c["nb"])
    opt = jax_adamw(LR)
    jr = jrt.DeftRuntime(cfg, opt, jsched, lay, single_mesh,
                         loss_chunk=chunk)
    state = {"pbuf": tuple(jax_flatten(lay, jax.tree.leaves(params))),
             "opt": init_flat_opt_state(opt, lay.buf_sizes),
             **jrt.init_fused_accumulators(lay, 1)}
    losses = []
    with single_mesh:
        for i, bt in enumerate(c["batches"]):
            state, m = jr.step(i, state, bt)
            losses.append(float(m["loss"]))
        final = [np.asarray(x) for x in jax.tree.leaves(jr.params_tree(state))]
        tree = jax.tree.map(jnp.asarray, params)
        step = jrt.make_ddp_step(cfg, opt, donate=False, loss_chunk=chunk)
        dstate, dm = step({"params": tree,
                           "opt": jax_init_opt_state(opt, tree)},
                          c["batches"][0])
    return dict(losses=np.array(losses), params=final,
                ddp_loss=float(dm["loss"]),
                ddp_params=[np.asarray(x)
                            for x in jax.tree.leaves(dstate["params"])])


@pytest.fixture(scope="module")
def engines(tmp_path_factory, single_mesh):
    """Every rank's runs of the three mesh cases (spawned first), and
    JAX's references, computed while the ranks run."""
    out_dir = str(tmp_path_factory.mktemp("tp_engines"))
    procs = _spawn(_engine_main, 4, out_dir)
    refs = {}
    for name, _, _, chunk in MESHES:
        if name not in refs:
            refs[name] = _jax_reference(name, chunk, single_mesh)
    _join(procs)
    runs = [[dict(np.load(os.path.join(out_dir, f"case{j}_rank{r}.npz")))
             for r in range(4)] for j in range(len(MESHES))]
    extra = [np.load(os.path.join(out_dir, f"extra_rank{r}.npy"),
                     allow_pickle=True).item() for r in range(4)]
    return runs, refs, extra


def _n_over(got, want) -> int:
    """Elements of ``got`` beyond rtol 1e-4 / atol 1e-5 of ``want``; every
    element is held within atol 1e-4 meanwhile."""
    np.testing.assert_allclose(got, want, rtol=0, atol=STEP_TOL)
    return int(np.sum(np.abs(got - want) > ATOL + RTOL * np.abs(want)))


@pytest.mark.parametrize("j", range(len(MESHES)),
                         ids=[f"{n}-data{d}-model{m}" for n, d, m, _ in MESHES])
def test_mesh_runs_match_jax_on_one_device(engines, j):
    runs, refs, _ = engines
    name = MESHES[j][0]
    ref = refs[name]
    c = _plan(name)
    assert max(p.update_k for p in c["sched"].phases) > 1
    assert any(p.rotate for p in c["sched"].phases)
    n = len(ref["params"])
    for r, run in enumerate(runs[j]):
        assert run["collectives"].all(), r
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(run["ddp_loss"], ref["ddp_loss"],
                                   rtol=RTOL, atol=ATOL)
        for i in range(n):
            assert np.array_equal(run[f"p{i}"], runs[j][0][f"p{i}"]), (r, i)
            assert np.array_equal(run[f"d{i}"], runs[j][0][f"d{i}"]), (r, i)
    size = sum(p.size for p in ref["params"])
    for key, want in (("p", ref["params"]), ("d", ref["ddp_params"])):
        over = sum(_n_over(runs[j][0][f"{key}{i}"], want[i])
                   for i in range(n))
        assert over <= MAX_OVER_SHARE * size, (key, over, size)


# ---------------------------------------------------------------------------
# (d) model 1
# ---------------------------------------------------------------------------
@pytest.fixture
def one_thread():
    """Two backward passes compared bitwise run on one CPU thread: several
    may sum the embedding gradient in another order from run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_model_one_mesh_is_bitwise_the_engine_on_four_ranks(engines):
    assert all(e["model1"] for e in engines[2])


def test_attention_with_heads_that_do_not_split_evenly(engines):
    for e in engines[2]:
        for case, err in e["odd_heads"].items():
            assert err <= 1e-5, (case, err)


def test_launcher_at_model_two_matches_model_one(functions):
    """``train(model=2)`` (DeFT and DDP) at 2 gloo ranks against the
    launcher at one rank, model 1, on the same global batches."""
    runs, _ = functions
    init_distributed(torch.device("cpu"))
    want = _launcher_losses()
    for out in runs:
        for scheduler, losses in want.items():
            np.testing.assert_allclose(out["launcher"][scheduler], losses,
                                       rtol=RTOL, atol=ATOL)


def test_model_one_mesh_is_bitwise_the_engine(one_thread):
    init_distributed(torch.device("cpu"))
    c = _plan("qwen3-tiny")
    lay = build_bucket_layout(c["meta"], c["bo"], c["nb"])
    runs = []
    for mesh in (None, make_debug_mesh(data=1, model=1)):
        rt = DeftRuntime(c["cfg"], adamw(LR), c["sched"], lay, device="cpu",
                         mesh=mesh)
        assert rt.tp is None and rt.stats()["model"] == 1
        state = rt.state_from_params(c["params"])
        losses = []
        for i, bt in enumerate(c["batches"]):
            state, m = rt.step(i, state, {k: torch.from_numpy(v).long()
                                          for k, v in bt.items()})
            losses.append(float(m["loss"]))
        runs.append((losses, [b.clone() for b in state["pbuf"]]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
