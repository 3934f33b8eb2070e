"""Layout transitions and restores across layouts and ranks, against the
JAX package.

* ``build_layout_transition`` equals JAX's copies, ``identical`` flags
  and ``moved_elems`` (and its ``reverse``) between layouts of two
  partitions, shard counts 1, 2 and 4, and precision policies;
  ``repack_buffers`` equals JAX's bitwise on 1-D and ``(rows, n)``
  buffers, an identical bucket being the source tensor itself; so does
  ``repack_placed`` on one rank (whole buffers), its new buckets made
  uninitialised as NaN, so that an element it leaves unwritten shows.
* A checkpoint written under partition A restores into a runtime of
  partition B (``restore_runtime_state``): ``cur``/``fut`` equal
  unflatten-under-A then reflatten-under-B, params equal the
  reflattened tree, and the restored state trains (as
  ``tests/test_repack.py`` checks for JAX).
* Two spawned gloo ranks save a sharded state (2 shards, mid-cycle) and
  restore it on the replicated engine at 2 ranks through the shard-count
  transition: every rank's buffers are bitwise the reference built from
  the file, and a step after it agrees on both ranks.  The same
  checkpoint on one rank is refused, as JAX refuses it (its accumulators
  hold two ranks' rows; folding them is the elastic coordinator's):
  ``restore_runtime_state`` returns ``(None, 0)`` after the "unusable"
  message in both packages.
* A known hazard, pinned so that its fix shows: the same two ranks also
  save mid-cycle (position 3 of 4, live accumulators); restored
  replicated, the cycle restarts on the partial generation with a
  warning, and the two replicas disagree from the first update.  The
  JAX package, restoring the same files on two forced host devices,
  prints no warning and its replicated params disagree across the
  devices alike, each device within 1e-5 of the port's rank.
"""
import multiprocessing as mp
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
from repro.configs import get_config, reduce_for_smoke
from repro.core.precision import PrecisionPolicy as JaxPolicy
from repro.launch.train import build_schedule as jax_build_schedule
from repro.launch.train import restore_runtime_state as jax_restore_state
from repro.models.model import init_params as jax_init_params
from repro.optim.optimizers import adamw as jax_adamw
from repro.train import runtime as jrt
from repro.train.bucketing import build_bucket_layout as jax_layout
from repro.train.bucketing import build_layout_transition as jax_transition
from repro.train.bucketing import repack_buffers as jax_repack
from repro_torch.checkpoint.checkpoint import load_arrays
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.train import (
    build_schedule,
    init_distributed,
    restore_runtime_state,
    save_checkpoint,
    train,
)
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import (
    assign_buckets,
    build_bucket_layout,
    build_layout_transition,
    flatten_buckets,
    repack_buffers,
    unflatten_buckets,
)
from repro_torch.train.runtime import DeftRuntime, Placement, repack_placed

ARCH, B, S, LR = "qwen3-4b", 2, 32, 1e-3
PARTS = (120_000, 250_000)


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


@pytest.fixture(scope="module")
def trees():
    cfg = reduce_for_smoke(get_config(ARCH))
    tcfg = t_reduce(t_get_config(ARCH))
    jparams = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), cfg))
    meta = init_params(tcfg, device="meta")
    parts = [assign_buckets(meta, tcfg, p) for p in PARTS]
    return dict(cfg=cfg, tcfg=tcfg, jparams=jparams, meta=meta, parts=parts)


def _layouts(tr, part, shards, wire=None):
    """(JAX layout, port layout) of partition ``part`` at ``shards``, with
    a uniform ``wire`` policy when given."""
    bo, nb = tr["parts"][part]
    jl = jax_layout(tr["jparams"], bo, nb, shard_count=shards)
    tl = build_bucket_layout(tr["meta"], bo, nb, shard_count=shards)
    if wire is not None:
        jl = jl.with_precision(JaxPolicy(wire=(wire,) * nb, master="bf16sr"))
        tl = tl.with_precision(PrecisionPolicy(wire=(wire,) * nb,
                                               master="bf16sr"))
    return jl, tl


# (src partition, src shards, src wire), (dst partition, dst shards, dst wire)
PAIRS = [
    ((0, 1, None), (1, 1, None)),       # two partitions
    ((1, 1, None), (0, 1, None)),
    ((0, 1, None), (0, 2, None)),       # shard counts
    ((0, 2, None), (0, 4, None)),
    ((1, 4, None), (1, 1, None)),
    ((0, 4, None), (1, 2, None)),       # both at once
    ((0, 1, None), (0, 1, "int8")),     # precision only: identical buckets
    ((1, 2, "bf16"), (0, 4, "int8")),
]


def _spans(tr_):
    return [[(c.src_bucket, c.src_off, c.dst_off, c.length) for c in spans]
            for spans in tr_.copies]


@pytest.mark.parametrize("src,dst", PAIRS)
def test_layout_transition_matches_jax(trees, src, dst):
    jsrc, tsrc = _layouts(trees, *src)
    jdst, tdst = _layouts(trees, *dst)
    jt, tt = jax_transition(jsrc, jdst), build_layout_transition(tsrc, tdst)
    assert _spans(tt) == _spans(jt)
    assert tt.identical == jt.identical
    assert tt.moved_elems == jt.moved_elems
    assert _spans(tt.reverse()) == _spans(jt.reverse())
    if src[:2] == dst[:2]:
        assert all(tt.identical) and tt.moved_elems == 0
    # random buffers with zero tails, 1-D and stacked by rows
    rng = np.random.default_rng(sum(src[:2]) + 10 * sum(dst[:2]))
    for lead in ((), (3,)):
        bufs = []
        for b, n in enumerate(tsrc.buf_sizes):
            x = rng.standard_normal(lead + (n,)).astype(np.float32)
            x[..., tsrc.sizes[b]:] = 0
            bufs.append(x)
        src_t = [torch.from_numpy(x) for x in bufs]
        got = repack_buffers(tt, src_t)
        want = jax_repack(jt, [jnp.asarray(x) for x in bufs])
        assert len(got) == len(want) == tdst.n_buckets
        for b, (g, w) in enumerate(zip(got, want)):
            assert tuple(g.shape) == lead + (tdst.buf_sizes[b],)
            assert np.array_equal(g.numpy(), np.asarray(w)), b
            if tt.identical[b]:
                assert g is src_t[tt.copies[b][0].src_bucket]
    # a bf16 buffer stays bf16 (the zero tail takes the source dtype)
    low = [torch.zeros(n, dtype=torch.bfloat16) for n in tsrc.buf_sizes]
    assert all(x.dtype == torch.bfloat16 for x in repack_buffers(tt, low))


@pytest.mark.parametrize("src,dst", PAIRS)
def test_repack_placed_matches_jax(group, trees, src, dst, monkeypatch):
    """The repack every layout change runs, on one rank's whole buffers:
    each element written once, the padded tail zero, identical buckets
    passed through."""
    jsrc, tsrc = _layouts(trees, *src)
    jdst, tdst = _layouts(trees, *dst)
    jt, tt = jax_transition(jsrc, jdst), build_layout_transition(tsrc, tdst)
    rng = np.random.default_rng(7 + sum(src[:2]) + 10 * sum(dst[:2]))
    bufs = []
    for b, n in enumerate(tsrc.buf_sizes):
        x = rng.standard_normal(n).astype(np.float32)
        x[tsrc.sizes[b]:] = 0
        bufs.append(x)
    src_t = [torch.from_numpy(x) for x in bufs]
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: empty(*a, **k).fill_(
        float("nan")))
    got = repack_placed(tt, src_t, Placement((0,), None, tsrc, False),
                        Placement((0,), None, tdst, False),
                        dtype=torch.float32, device="cpu")
    want = jax_repack(jt, [jnp.asarray(x) for x in bufs])
    assert len(got) == len(want) == tdst.n_buckets
    for b, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.numpy(), np.asarray(w)), b
        if tt.identical[b]:
            assert g is src_t[tt.copies[b][0].src_bucket]


def test_layout_transition_needs_one_tree(trees):
    _, tl = _layouts(trees, 0, 1)
    toy = {"w": torch.empty(3, 5, device="meta")}
    other = build_bucket_layout(toy, (0,), 1)
    with pytest.raises(ValueError, match="same parameter tree"):
        build_layout_transition(tl, other)


def _reflatten_rows(lay_a, lay_b, rows_a):
    """Each row's buffers unflattened under A and flattened under B (no
    LayoutTransition involved), stacked back by rows."""
    n_rows = rows_a[0].shape[0]
    per_row = [flatten_buckets(lay_b, unflatten_buckets(
        lay_a, [x[r] for x in rows_a])) for r in range(n_rows)]
    return [torch.stack([per_row[r][b] for r in range(n_rows)])
            for b in range(lay_b.n_buckets)]


def test_checkpoint_restores_across_layouts(group, trees, tmp_path):
    """Saved under partition A after four steps, restored into a runtime
    of partition B."""
    tcfg, d = trees["tcfg"], str(tmp_path)
    kw = dict(batch=B, seq=S, device="cpu", log=lambda s: None)
    first = train(tcfg, steps=4, partition_elems=PARTS[0], ckpt=d, **kw)
    lay_a = first["layout"]
    arrays = load_arrays(d, 4)
    logs = []
    rt_b = train(tcfg, steps=0, partition_elems=PARTS[1], **kw)["runtime"]
    lay_b = rt_b.layout
    assert lay_b != lay_a
    state, step = restore_runtime_state(rt_b, d, trees["meta"],
                                        log=logs.append)
    # another partition plans another schedule: its digest differs too,
    # and step 4 is mid-cycle under A, so the live accumulators warn
    next_phase = first["runtime"].phase_in_cycle(4)
    assert step == 4 and len(logs) == 3 and logs[0].startswith(
        "resume: WARNING schedule digest mismatch at step 4")
    assert next_phase != 0 and logs[1].startswith(
        f"resume: WARNING checkpoint step 4 was saved at cycle position "
        f"{next_phase} with live accumulators")
    assert logs[2] == ("resumed checkpoint step 4 (re-packed from a "
                       "different layout) (cycle restarted)")
    assert rt_b.phase_in_cycle(4) == 0
    live = False
    for name in ("cur", "fut"):
        rows = [torch.from_numpy(arrays[f"{name}/[{b}]"])
                for b in range(lay_a.n_buckets)]
        live = live or any(x.any() for x in rows)
        for got, want in zip(state[name], _reflatten_rows(lay_a, lay_b,
                                                          rows)):
            assert torch.equal(got, want[0])
    assert live
    want_pbuf = flatten_buckets(lay_b, unflatten_buckets(
        lay_a, list(first["state"]["pbuf"])))
    for got, want in zip(state["pbuf"], want_pbuf):
        assert torch.equal(got, want)
    # and the restored state trains under B
    state, m = rt_b.step(4, state, make_batch(tcfg, 0, 4, B, S,
                                              device="cpu"))
    assert bool(torch.isfinite(m["loss"]))


# ---------------------------------------------------------------------------
# 2 gloo ranks: saved sharded at 2 shards, restored replicated at 2 ranks
# ---------------------------------------------------------------------------
G_STEPS, G_PART, G_BATCH = 4, 250_000, 4
G_MID = 3           # a mid-cycle save: position 3 of the period of 4


def _rank_main(rank, world, port, ckpt_dir, mid_dir, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        tcfg = t_reduce(t_get_config(ARCH))
        kw = dict(batch=G_BATCH, seq=S, device="cpu", partition_elems=G_PART,
                  log=lambda s: None)

        def save_mid(step, runtime, state, m):
            if step + 1 == G_MID:
                assert runtime.phase_in_cycle(G_MID) == G_MID
                assert any(c.any() for c in state["cur"])
                tree = runtime.state_to_tree(state)
                # the tree is built on the writing rank's host alone
                assert (tree is None) == (rank != 0)
                save_checkpoint(mid_dir, G_MID, runtime, state)

        res = train(tcfg, steps=G_STEPS, ckpt=ckpt_dir, fsdp=True,
                    on_step=save_mid, **kw)
        assert res["layout"].shards == world
        assert res["runtime"].phase_in_cycle(G_STEPS) == 0
        rt = train(tcfg, steps=0, fsdp=False, **kw)["runtime"]
        assert rt.layout.shards == 1 and rt.accum_devices == world
        logs = []
        state, step = restore_runtime_state(
            rt, ckpt_dir, init_params(tcfg, device="meta"), log=logs.append)
        assert step == G_STEPS
        out = {"msg": np.array(logs[0])}
        for k in ("pbuf", "cur", "fut", "gbuf"):
            for b, x in enumerate(state[k]):
                out[f"{k}{b}"] = x.numpy().copy()
        for k in ("m", "v"):
            for b, x in enumerate(state["opt"][k]):
                out[f"{k}{b}"] = x.numpy().copy()
        out["step"] = state["opt"]["step"].numpy()
        # one replicated step from the restored state, on this rank's slice
        full = make_batch(tcfg, 0, G_STEPS, G_BATCH, S, device="cpu")
        per = G_BATCH // world
        state, m = rt.step(G_STEPS, state, {k: v[rank * per:(rank + 1) * per]
                                            for k, v in full.items()})
        out["loss"] = np.array([float(m["loss"])])
        for b, x in enumerate(state["pbuf"]):
            out[f"after{b}"] = x.numpy()
        # the mid-cycle checkpoint, restored replicated: one step after it
        logs = []
        state, step = restore_runtime_state(
            rt, mid_dir, init_params(tcfg, device="meta"), log=logs.append)
        assert step == G_MID
        out["mid_msg"] = np.array(logs)
        full = make_batch(tcfg, 0, G_MID, G_BATCH, S, device="cpu")
        state, m = rt.step(G_MID, state, {k: v[rank * per:(rank + 1) * per]
                                          for k, v in full.items()})
        assert bool(m["updated"])
        for b, x in enumerate(state["pbuf"]):
            out[f"mid_after{b}"] = x.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt2"))
    mid = str(tmp_path_factory.mktemp("mid2"))
    out = str(tmp_path_factory.mktemp("out2"))
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_rank_main, args=(r, 2, port, ckpt, mid, out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        assert not p.is_alive() and p.exitcode == 0
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(2)]
    return ckpt, mid, ranks


def test_gloo_sharded_save_restores_replicated(trees, two_ranks):
    ckpt, _, ranks = two_ranks
    meta = trees["meta"]
    bo, nb = assign_buckets(meta, trees["tcfg"], G_PART)
    lay_a = build_bucket_layout(meta, bo, nb, shard_count=2)
    lay_b = build_bucket_layout(meta, bo, nb)
    arrays = load_arrays(ckpt, G_STEPS)
    tree_leaves_of = lambda name: [torch.from_numpy(arrays[k]) for k in
                                   sorted((k for k in arrays
                                           if k.startswith(name + "/")),
                                          key=_leaf_order(meta, name))]
    want = {k: flatten_buckets(lay_b, tree_leaves_of(n)) for k, n in
            (("pbuf", "params"), ("m", "opt/m"), ("v", "opt/v"))}
    for name in ("cur", "fut"):
        rows = [torch.from_numpy(arrays[f"{name}/[{b}]"]) for b in range(nb)]
        assert rows[0].shape[0] == 2            # both ranks' rows
        want[name] = _reflatten_rows(lay_a, lay_b, rows)
    assert any(x.any() for x in want["cur"] + want["fut"])
    for r, got in enumerate(ranks):
        assert str(got["msg"]) == ("resumed checkpoint step 4 (re-packed "
                                   "from a different layout) (cycle "
                                   "restarted)")
        assert int(got["step"]) == int(arrays["opt/step"])
        for b in range(nb):
            for k in ("pbuf", "m", "v"):
                assert np.array_equal(got[f"{k}{b}"], want[k][b].numpy()), \
                    (r, k, b)
            for k in ("cur", "fut"):
                assert np.array_equal(got[f"{k}{b}"], want[k][b][r].numpy()), \
                    (r, k, b)
            assert not got[f"gbuf{b}"].any()
    # the replicated step after the restore: both replicas agree
    assert np.array_equal(ranks[0]["loss"], ranks[1]["loss"])
    assert np.isfinite(ranks[0]["loss"]).all()
    for b in range(nb):
        assert np.array_equal(ranks[0][f"after{b}"], ranks[1][f"after{b}"])


def _leaf_order(meta, name):
    """Sort key of ``name/...`` checkpoint keys in tree_flatten order."""
    from repro_torch.checkpoint.checkpoint import _items

    order = [name + "/" + k for k, _ in _items(meta)]
    return order.index


def test_two_rank_checkpoint_refused_on_one_rank(group, trees, two_ranks,
                                                 capsys):
    ckpt, _, _ = two_ranks
    meta, tcfg = trees["meta"], trees["tcfg"]
    bo, nb = assign_buckets(meta, tcfg, G_PART)
    _, _, _, plan = build_schedule(meta, tcfg, dp=1, seq_len=S,
                                   per_device_batch=B,
                                   partition_elems=G_PART, coverage_rate=1.8)
    logs = []
    for fsdp in (True, False):
        rt = DeftRuntime(tcfg, adamw(LR), plan.schedule,
                         build_bucket_layout(meta, bo, nb), device="cpu",
                         fsdp=fsdp)
        assert restore_runtime_state(rt, ckpt, meta, log=logs.append) \
            == (None, 0)
    assert len(logs) == 2 and all(
        s.startswith(f"resume: checkpoint step {G_STEPS} unusable "
                     f"(ValueError: cur/[0]: shape (2, ") for s in logs)
    # JAX refuses the port's 2-rank checkpoint on its one device alike
    cfg = trees["cfg"]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    _, _, _, jplan = jax_build_schedule(
        trees["jparams"], cfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=G_PART, coverage_rate=1.8)
    jr = jrt.DeftRuntime(cfg, jax_adamw(LR), jplan.schedule,
                         jax_layout(trees["jparams"], bo, nb), mesh,
                         config=jrt.RuntimeConfig(fsdp=True))
    capsys.readouterr()
    with jax.set_mesh(mesh):
        assert jax_restore_state(jr, ckpt, trees["jparams"]) == (None, 0)
    assert capsys.readouterr().out.strip() == logs[0]


_JAX_MID_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import sys
sys.path.insert(0, sys.argv[1])
import jax
import numpy as np
import repro
from repro.configs import get_config, reduce_for_smoke
from repro.data.pipeline import make_batch
from repro.launch.train import build_schedule, restore_runtime_state
from repro.models.model import init_params
from repro.optim.optimizers import adamw
from repro.train import runtime as jrt
from repro.train.bucketing import build_bucket_layout

ARCH, PART, BATCH, S, LR, STEP = %r, %d, %d, %d, %r, %d
cfg = reduce_for_smoke(get_config(ARCH))
params = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
bo, nb, _, plan = build_schedule(params, cfg, dp=2, seq_len=S,
                                 per_device_batch=BATCH // 2,
                                 partition_elems=PART, coverage_rate=1.8)
out = {}
with jax.set_mesh(mesh):
    jr = jrt.DeftRuntime(cfg, adamw(LR), plan.schedule,
                         build_bucket_layout(params, bo, nb), mesh,
                         config=jrt.RuntimeConfig(fsdp=False))
    state, step = restore_runtime_state(jr, sys.argv[2], params)
    assert step == STEP
    state, m = jr.step(STEP, state, make_batch(cfg, 0, STEP, BATCH, S))
    assert bool(m["updated"])
    for b, x in enumerate(state["pbuf"]):
        for d, shard in enumerate(sorted(x.addressable_shards,
                                         key=lambda a: a.device.id)):
            out[f"dev{d}_{b}"] = np.asarray(shard.data)
np.savez(sys.argv[3], **out)
""" % (ARCH, G_PART, G_BATCH, S, LR, G_MID)


def test_mid_cycle_cross_layout_restore_replicas_disagree(trees, two_ranks,
                                                         tmp_path):
    """The known hazard of a restarted cycle on mid-generation
    accumulators, in both packages: when this test fails, the hazard is
    fixed (or moved) and ROADMAP.md's entry goes with it."""
    _, mid, ranks = two_ranks
    nb = assign_buckets(trees["meta"], trees["tcfg"], G_PART)[1]
    resumed = ("resumed checkpoint step 3 (re-packed from a different "
               "layout) (cycle restarted)")
    for got in ranks:
        assert list(got["mid_msg"]) == [
            "resume: WARNING checkpoint step 3 was saved at cycle position "
            "3 with live accumulators; the restarted cycle does not sync "
            "them as the saved one would, and across ranks the replicas "
            "disagree from the first update", resumed]
    port = [[r[f"mid_after{b}"] for b in range(nb)] for r in ranks]
    assert not all(np.array_equal(a, b) for a, b in zip(*port))
    # JAX on the same files: no warning, the same split replicas
    (tmp_path / "run.py").write_text(_JAX_MID_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    res = subprocess.run(
        [sys.executable, str(tmp_path / "run.py"), src, mid,
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        timeout=120, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines() == [resumed]
    f = np.load(tmp_path / "out.npz")
    jax_dev = [[f[f"dev{d}_{b}"] for b in range(nb)] for d in range(2)]
    assert not all(np.array_equal(a, b) for a, b in zip(*jax_dev))
    for d in range(2):
        for a, b in zip(jax_dev[d], port[d]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
