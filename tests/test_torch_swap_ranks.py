"""The sharded engine's partition hot swap at 2 and 4 spawned gloo ranks,
where ``repack_state`` moves param and moment spans across ranks (one
source bucket all-gathered over 'data' at a time) and the live ``cur``
accumulators are handed over to the new schedule: each rank bitwise its
explicit reference, and within ``tests/test_torch_sharded.py``'s gloo
tolerance (params 1e-4, losses rtol 1e-5) of the one-rank replicated run.
The spawned ranks run no JAX.  The JAX package, which carries ``cur``
over as it stands, runs the same swap on 2 forced host devices in a
subprocess and leaves the one-rank run of it by more than that tolerance.
"""
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
from repro_torch.core.bucket import BucketTimes
from repro_torch.core.deft import feedback_solve
from repro_torch.core.profiler import HardwareModel
from repro_torch.data.pipeline import make_batch as t_make_batch
from repro_torch.launch.train import init_distributed
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import (
    assign_buckets,
    build_bucket_layout,
    build_layout_transition,
    leaf_bucket_times,
)
from repro_torch.train.runtime import (
    DeftRuntime,
    _cur_at_boundary,
    _cur_reading,
)
from repro_torch.tree import tree_leaves


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


_JAX_SWAP_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import sys
sys.path.insert(0, sys.argv[1])
import dataclasses
import jax
import numpy as np
import repro
from repro.configs import get_config
from repro.core.bucket import BucketTimes
from repro.core.deft import feedback_solve
from repro.core.preserver import WalkParams
from repro.core.profiler import HardwareModel
from repro.data.pipeline import make_batch
from repro.models.model import init_params
from repro.optim.optimizers import adamw
from repro.train import (DeftRuntime, assign_buckets, build_bucket_layout,
                         leaf_bucket_times)

TINY, B, S, LR = %r, %d, %d, %r
cfg = dataclasses.replace(get_config("qwen3-4b"), **TINY)
key = jax.random.PRNGKey(0)
params = init_params(key, cfg)
plans = []
for pe in (20_000, 60_000):
    bo, nb = assign_buckets(params, cfg, partition_elems=pe)
    t = leaf_bucket_times(params, cfg, bo, nb, HardwareModel(dp_degree=2),
                          S, B)
    scale = 1.8 * (t.fwd_total + t.bwd_total) / t.comm_total
    t = BucketTimes(t.fwd, t.bwd, tuple(c * scale for c in t.comm))
    walk = WalkParams(s0=4.0, eta=0.01, mu=1.0, sigma=40.0, batch=256)
    plans.append((feedback_solve(t, walk)[0],
                  build_bucket_layout(params, bo, nb)))
(sa, la), (sb, lb) = plans
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
with jax.set_mesh(mesh):
    rt = DeftRuntime(cfg, adamw(LR), sa, la, mesh)
    state = rt.init_state(key)
    losses = []
    for i in range(2 * sa.period + 2 * sb.period):
        batch = make_batch(cfg, 0, i, B, S)
        state, m = rt.step(i, state, batch)
        losses.append(float(m["loss"]))
        if i == sa.period:
            rt.prepare_swap(sb, state, batch, layout=lb)
    assert rt.layout_swaps == 1
    np.savez(sys.argv[2], rt.swap_log[0]["step"], np.array(losses),
             *[np.asarray(x) for x in jax.tree.leaves(rt.params_tree(state))])
""" % (T.TINY, T.B, T.S, T.LR)


@pytest.fixture(scope="module", autouse=True)
def jax_swap(tmp_path_factory):
    """JAX's partition swap on 2 forced host devices from JAX's params at
    key 0, started in a subprocess with the module's first test so that it
    runs while the gloo ranks do."""
    d = tmp_path_factory.mktemp("jax_swap")
    (d / "run.py").write_text(_JAX_SWAP_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.Popen(
        [sys.executable, str(d / "run.py"), src, str(d / "out.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc, d / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _ranks_case(world, fsdp):
    """The schedules and layouts of the two partitions (A: 20,000, B:
    60,000 elements) from the port's planner alone (the spawned ranks run
    no JAX): (cfg, schedule A, layout A, schedule B, layout B)."""
    tcfg = T.port_cfg()
    meta = init_params(tcfg, device="meta")
    out = []
    for pe in (20_000, 60_000):
        bo, nb = assign_buckets(meta, tcfg, partition_elems=pe)
        times = leaf_bucket_times(meta, tcfg, bo, nb,
                                  HardwareModel(dp_degree=2), T.S, T.B)
        scale = 1.8 * (times.fwd_total + times.bwd_total) / times.comm_total
        times = BucketTimes(times.fwd, times.bwd,
                            tuple(c * scale for c in times.comm))
        sched = feedback_solve(times, T.WALK)[0]
        out.append((sched, build_bucket_layout(
            meta, bo, nb, shard_count=world if fsdp else 1)))
    (sa, la), (sb, lb) = out
    return tcfg, sa, la, sb, lb


def _ranks_run(world, rank, fsdp, explicit):
    """This rank's losses and final params of a swap from A to B at the
    first boundary after one period, and back to A two periods of B
    later, over its slice of the global batch: through ``prepare_swap``
    (staged a step before each boundary), or ``explicit``ly through
    ``repack_state`` onto a sibling runtime, handing the accumulators over
    from the schedule left."""
    tcfg, sa, la, sb, lb = _ranks_case(world, fsdp)
    per = T.B // world
    s1 = -(-(sa.period + 1) // sa.period) * sa.period
    s2 = s1 + 2 * sb.period
    legs = {s1: (sa, la, sb, lb), s2: (sb, lb, sa, la)}
    rt = DeftRuntime(tcfg, adamw(T.LR), sa, la, device="cpu", fsdp=fsdp)
    state = rt.init_state(seed=0)
    base, losses = 0, []
    for i in range(s2 + 2 * sa.period):
        if explicit and i in legs:
            src, src_lay, dst, dst_lay = legs[i]
            rt = rt.spawn(schedule=dst, layout=dst_lay)
            state = rt.repack_state(
                state, build_layout_transition(src_lay, dst_lay),
                src_schedule=src)
            base = i
        full = t_make_batch(tcfg, 0, i, T.B, T.S, device="cpu")
        state, m = rt.step(i - base, state,
                           {k: v[rank * per:(rank + 1) * per]
                            for k, v in full.items()})
        losses.append(float(m["loss"]))
        if not explicit and i + 1 in legs:
            rt.prepare_swap(legs[i + 1][2], layout=legs[i + 1][3])
    if not explicit:
        assert [e["step"] for e in rt.swap_log] == [s1, s2]
    assert rt.layout == la
    if fsdp:
        assert [x.numel() for x in state["opt"]["m"]] == list(la.shard_sizes)
    params = [p.numpy().copy() for p in tree_leaves(rt.params_tree(state))]
    return params + [np.array(losses), np.array([s1, s2])]


def _rank_main(rank, world, port, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        for explicit in (False, True):
            np.savez(os.path.join(out_dir, f"{explicit}{rank}.npz"),
                     *_ranks_run(world, rank, True, explicit))
    finally:
        dist.destroy_process_group()


def _spawn(world, out_dir):
    """Every rank's runs, as {explicit: [rank 0's, rank 1's, ...]}."""
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
    for explicit in (False, True):
        for r in range(world):
            f = np.load(os.path.join(out_dir, f"{explicit}{r}.npz"))
            out.setdefault(explicit, []).append(
                [f[f"arr_{i}"] for i in range(len(f.files))])
    return out


@pytest.fixture(scope="module")
def one_rank(group):
    """The one-rank replicated run of the swap (``_ranks_run``)."""
    return _ranks_run(1, 0, False, False)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_repack_across_ranks(group, one_rank, tmp_path, world):
    """Every rank's swap run is bitwise its explicit reference, and within
    the gloo tolerance of the one-rank replicated run of the same swaps.
    Schedule A leaves bucket 0's share of ``cur`` rank-local and the rest
    summed over the ranks at its boundary, and B's first cycle sums every
    bucket of it: without the hand-over (``_hand_over_cur``) the summed
    elements would count N times.  B leaves all of ``cur`` rank-local and
    A's first cycle applies buckets 1-4 of it as summed: without the
    hand-over's sum they would hold one rank's gradients."""
    _, sa, _, sb, _ = _ranks_case(world, True)
    assert "summed" in _cur_at_boundary(sa) and "local" in _cur_reading(sb)
    assert "local" in _cur_at_boundary(sb) and "summed" in _cur_reading(sa)
    runs = _spawn(world, str(tmp_path))
    one = one_rank
    for r in range(world):
        swap, ref = runs[False][r], runs[True][r]
        for a, b in zip(swap, ref):
            assert np.array_equal(a, b), f"rank {r}"
        assert np.array_equal(swap[-1], one[-1])
        np.testing.assert_allclose(swap[-2], one[-2], rtol=1e-5)
        for a, b in zip(swap[:-2], one[:-2]):
            np.testing.assert_allclose(a, b, atol=T.ATOL, rtol=0)


def test_jax_swap_counts_summed_cur_twice(group, jax_swap):
    """The second witness of the hazard the hand-over removes: the JAX
    package carries ``cur`` over as it stands, so on 2 devices its swap
    sums the elements schedule A had already summed a second time.  From
    JAX's params and batches its losses agree with the port's one-rank run
    of the same swap up to B's first update, and its params then leave
    that run by more than twice the 1e-4 within which the port's one-rank
    run holds JAX's one-device run (``tests/test_torch_swap.py``), so by
    more than 1e-4 JAX's own one-device run; the port's swap keeps 1e-4 at
    2 and 4 ranks (``test_sharded_repack_across_ranks``).  When this
    fails, the JAX package has changed, and ROADMAP.md §3 with it."""
    tiny = T.make_tiny()
    bo_a, nb_a, _, sa, _ = T.plan(tiny, 20_000)
    bo_b, nb_b, _, sb, _ = T.plan(tiny, 60_000)
    lb = T.layouts(tiny, bo_b, nb_b)[1]
    rt = DeftRuntime(tiny.tcfg, adamw(T.LR), sa,
                     T.layouts(tiny, bo_a, nb_a)[1], device="cpu")
    state, losses = T.port_run(
        tiny, rt, 2 * sa.period + 2 * sb.period,
        lambda i, st: i == sa.period and rt.prepare_swap(sb, layout=lb))
    proc, out = jax_swap
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    f = np.load(out)
    swap, jlosses = int(f["arr_0"]), f["arr_1"]
    assert swap == rt.swap_log[0]["step"]
    np.testing.assert_allclose(jlosses[:swap + 2], losses[:swap + 2],
                               rtol=1e-5)
    diff = max(np.abs(a.numpy() - f[f"arr_{j + 2}"]).max() for j, a in
               enumerate(tree_leaves(rt.params_tree(state))))
    assert diff > 2 * T.ATOL, diff
