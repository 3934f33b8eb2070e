"""Port parity of the per-link ring chains and the pod axis (DESIGN.md §14)
against the JAX package, and of both flat engines routed through them at
2 and 4 gloo ranks.

* ``launch.mesh.ring_chain`` / ``link_chains`` and ``chains.chain_perm``
  equal the JAX package's.
* The three chain collectives at 2 and 4 gloo ranks, on a buffer of 4096
  and one of 1021 (which does not divide, so the all-reduce pads): bitwise
  equal to the numpy sums in ascending rank order, and at 4 ranks to the
  JAX package's ``chain_*`` on the same inputs (4 forced host devices in a
  subprocess); each round's P2P pairs are the chain's.
* The decoupled sharded engine against the burst one on mixed int8 /
  bf16 / f32 wires, bitwise at 2 and 4 ranks.
* At 4 ranks with chain (0, 2, 1, 3), every synced bucket secondary and
  every param gather on link 1, the replicated and the decoupled sharded
  engine with an int8 bucket 0: within ``ATOL`` (params) and rtol 1e-5
  (losses) of the same runs unrouted, and within the mixed-wire limits of
  tests/test_torch_sharded.py of the same engine at one rank (each rank
  projects its own gradient onto the int8 grid, so the runs differ from
  one rank's by more than the f32 reduction order: 4.6e-3 at most in
  params, 1.6e-4 in loss); on f32 wires within ``ATOL`` and rtol 1e-5 of
  the one-rank replicated run.  Their P2P census holds only
  ``chain_perm(CHAIN, s)`` permutations, none of the natural ring's; the
  unrouted runs record none.
* A 2 x 2 pod x data layout of both engines on f32 wires (the sharded one
  with a chain over its 'data' pair) within ``ATOL`` and rtol 1e-5 of the
  one-rank run.
* Every run's collectives equal the by-construction counts, with the pod
  all-reduces and chain rounds.
* The validation errors: a chain that is no permutation, one that does
  not match the 'data' group, a chain on the replicated engine of a pod
  layout, and a chain collective handed a chain of another group.
"""
import dataclasses
import multiprocessing as mp
import os
import pathlib
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch.mesh import link_chains as jax_link_chains
from repro.launch.mesh import ring_chain as jax_ring_chain
from repro.train.chains import chain_perm as jax_chain_perm
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.deft import plan_ag_stream
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.mesh import link_chains, ring_chain
from repro_torch.launch.train import (
    build_schedule,
    init_distributed,
    pod_groups,
)
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import build_bucket_layout
from repro_torch.train.chains import (
    chain_all_gather,
    chain_all_reduce,
    chain_perm,
    chain_reduce_scatter,
)
from repro_torch.train.runtime import DeftRuntime
from repro_torch.tree import tree_leaves

CHAIN = (0, 2, 1, 3)
ARCH, S, PART, BATCH, STEPS, LR = "qwen3-4b", 32, 120_000, 4, 6, 1e-3
ATOL = 1e-4                      # tests/test_torch_sharded.py's
LOSS_RTOL = 1e-5
# tests/test_torch_sharded.py's 2-rank mixed-wire limits: loss rtol, param
# atol, largest share of params beyond 1e-4 + |want| / 128
INT8_LOSS_RTOL, INT8_ATOL, INT8_SHARE = 1e-3, 1e-2, 0.05
N_ELEMS, N_ODD = 4096, 1021


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", range(1, 18))
def test_ring_chain_matches_jax(n):
    for link in range(4):
        assert ring_chain(n, link) == jax_ring_chain(n, link)
    assert link_chains(n, 4) == jax_link_chains(n, 4)


def test_chain_perm_matches_jax():
    for chain in (CHAIN, (0,), (1, 0), ring_chain(8, 1), ring_chain(7, 2)):
        for jump in range(len(chain) + 1):
            assert chain_perm(chain, jump) == jax_chain_perm(chain, jump)


# ---------------------------------------------------------------------------
# validation (one rank)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


def _setup():
    """The schedule every run shares (planned for 4 ranks), with every
    synced bucket forced onto the secondary link as the JAX package's
    4-device test forces it, and an AG plan with every streamed gather on
    link 1."""
    cfg = reduce_for_smoke(get_config(ARCH))
    meta = init_params(cfg, device="meta")
    bucket_of, nb, times, plan = build_schedule(
        meta, cfg, dp=4, seq_len=S, per_device_batch=BATCH // 4,
        partition_elems=PART, coverage_rate=1.8)
    sched = plan.schedule
    phases = tuple(dataclasses.replace(ph, secondary=tuple(
        (ph.route_new[b] == "sync" and ph.rotate) or ph.sync_cur[b]
        for b in range(nb))) for ph in sched.phases)
    sched = dataclasses.replace(sched, phases=phases)
    ag = plan_ag_stream(sched, times)
    ag = dataclasses.replace(ag, items=tuple(
        dataclasses.replace(i, link=1) for i in ag.items))
    return cfg, meta, bucket_of, nb, sched, ag


def test_chain_validation(group):
    cfg, meta, bucket_of, nb, sched, ag = _setup()
    one = build_bucket_layout(meta, bucket_of, nb)
    with pytest.raises(ValueError, match="permutation"):
        DeftRuntime(cfg, adamw(LR), sched, one, device="cpu",
                    secondary_chain=(1,))
    with pytest.raises(ValueError, match="permutation"):
        DeftRuntime(cfg, adamw(LR), sched, one, device="cpu",
                    secondary_chain=(0, 0))
    with pytest.raises(ValueError, match="data' axis"):
        DeftRuntime(cfg, adamw(LR), sched, one, device="cpu",
                    secondary_chain=(1, 0))
    with pytest.raises(ValueError, match="multi-pod"):
        DeftRuntime(cfg, adamw(LR), sched, one, device="cpu",
                    outer_group=torch.distributed.new_group([0]),
                    secondary_chain=(0,))
    with pytest.raises(ValueError, match="permutation of the 1 ranks"):
        chain_all_reduce(torch.ones(8), (0, 1))
    with pytest.raises(ValueError, match="does not divide"):
        pod_groups(3)
    # at one rank a chain is the identity and issues no P2P op
    x = torch.arange(8.0)
    seen = []
    assert chain_all_reduce(x, (0,), record=seen.append) is x
    assert chain_reduce_scatter(x, (0,), record=seen.append) is x
    assert chain_all_gather(x, (0,), record=seen.append) is x
    assert seen == []
    rt = DeftRuntime(cfg, adamw(LR), sched, one, device="cpu",
                     secondary_chain=(0,), ag_plan=ag)
    state = rt.init_state()
    chained = 0
    for i in range(sched.period):
        state, _ = rt.step(i, state, make_batch(cfg, 0, i, BATCH, S,
                                                device="cpu"))
        assert rt.last_collectives["chain_rounds"] == 0 and not rt.last_p2p
        assert rt.last_collectives == rt.collectives_per_phase()[i]
        chained += rt.last_collectives["chained"]
    assert chained == sum(c["secondary"] for c in rt.collectives_per_phase())
    assert chained > 0


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------
def _inputs(world):
    rng = np.random.default_rng(11)
    return rng.standard_normal((world, N_ELEMS)).astype(np.float32)


def _collectives(world, rank, chain):
    """This rank's chain reduce-scatter (of row ``rank``), all-gather (of
    that result) and all-reduce (of the row's first 1021 elements), and
    the recorded permutations."""
    x = torch.from_numpy(_inputs(world)[rank].copy())
    perms = []
    rs = chain_reduce_scatter(x, chain, record=perms.append)
    ag = chain_all_gather(rs, chain, record=perms.append)
    ar = chain_all_reduce(x[:N_ODD].clone(), chain, record=perms.append)
    return [rs.numpy(), ag.numpy(), ar.numpy(),
            np.array(sorted(set(perms)), dtype=np.int64).reshape(-1, 2)]


def _run(world, rank, *, fsdp, decoupled=False, chain=None, pod=1,
         wires="int8-0"):
    """``STEPS`` steps over this rank's slice of the global batch; returns
    the final params, the losses and the P2P permutations recorded.
    ``wires``: "int8-0" (int8 on bucket 0, f32 elsewhere), "mixed" (int8,
    bf16 and f32 in turn) or "f32"."""
    cfg, meta, bucket_of, nb, sched, ag = _setup()
    data_group, pod_group = pod_groups(pod)
    n_data = world // pod
    layout = build_bucket_layout(meta, bucket_of, nb,
                                 shard_count=n_data if fsdp else 1)
    if wires != "f32":
        layout = layout.with_precision(PrecisionPolicy(
            ("int8",) + ("f32",) * (nb - 1) if wires == "int8-0"
            else tuple(("int8", "bf16", "f32")[b % 3] for b in range(nb))))
    rt = DeftRuntime(cfg, adamw(LR), sched, layout, device="cpu", fsdp=fsdp,
                     decoupled=decoupled, group=data_group,
                     outer_group=pod_group, secondary_chain=chain,
                     ag_plan=ag)
    state = rt.init_state(seed=0)
    per = BATCH // world
    losses, perms = [], set()
    for i in range(STEPS):
        full = make_batch(cfg, 0, i, BATCH, S, device="cpu")
        state, m = rt.step(i, state, {k: v[rank * per:(rank + 1) * per]
                                      for k, v in full.items()})
        assert rt.last_collectives == rt.collectives_per_phase()[
            i % rt.period], i
        losses.append(float(m["loss"]))
        perms.update(rt.last_p2p)
    params = [p.numpy().copy() for p in tree_leaves(rt.params_tree(state))]
    return params + [np.array(losses),
                     np.array(sorted(perms), dtype=np.int64).reshape(
                         -1, world // pod, 2)]


def _rank_main(rank, world, port, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        runs = {"coll": _collectives(world, rank, ring_chain(world, 1)),
                "burst": _run(world, rank, fsdp=True, wires="mixed"),
                "dec": _run(world, rank, fsdp=True, decoupled=True,
                            wires="mixed")}
        if world == 4:
            runs.update(
                rep=_run(world, rank, fsdp=False),
                rep_chain=_run(world, rank, fsdp=False, chain=CHAIN),
                shd=_run(world, rank, fsdp=True, decoupled=True),
                shd_chain=_run(world, rank, fsdp=True, decoupled=True,
                               chain=CHAIN),
                rep_chain_f32=_run(world, rank, fsdp=False, chain=CHAIN,
                                   wires="f32"),
                shd_chain_f32=_run(world, rank, fsdp=True, decoupled=True,
                                   chain=CHAIN, wires="f32"),
                pod_rep=_run(world, rank, fsdp=False, pod=2, wires="f32"),
                pod_shd=_run(world, rank, fsdp=True, decoupled=True,
                             chain=(0, 1), pod=2, wires="f32"))
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
    for name in sorted({re.sub(r"\d\.npz$", "", f)
                        for f in os.listdir(out_dir)}):
        for r in range(world):
            f = np.load(os.path.join(out_dir, f"{name}{r}.npz"))
            out.setdefault(name, []).append(
                [f[f"arr_{i}"] for i in range(len(f.files))])
    return out


_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, sys.argv[1])
import jax
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.train.chains import (chain_all_gather, chain_all_reduce,
                                chain_reduce_scatter)

CHAIN = (0, 2, 1, 3)
mesh = jax.make_mesh((4, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)

def body(x):
    v = x[0]
    rs = chain_reduce_scatter(v, "data", CHAIN)
    ag = chain_all_gather(rs, "data", CHAIN)
    ar = chain_all_reduce(v[:%d], "data", CHAIN)
    return rs[None], ag[None], ar[None]

x = np.load(sys.argv[2])["x"]
with jax.set_mesh(mesh):
    rs, ag, ar = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=P("data"), out_specs=(P("data"),) * 3,
        axis_names={"data"}, check_vma=False))(x)
np.savez(sys.argv[3], rs=np.asarray(rs), ag=np.asarray(ag), ar=np.asarray(ar))
""" % N_ODD


@pytest.fixture(scope="module")
def jax_chains(tmp_path_factory):
    """The JAX package's chain collectives on the 4-rank inputs, as
    [rank] rows of (reduce-scatter, all-gather, all-reduce)."""
    d = tmp_path_factory.mktemp("jaxchains")
    np.savez(d / "in.npz", x=_inputs(4))
    (d / "run.py").write_text(_JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run(
        [sys.executable, str(d / "run.py"), src, str(d / "in.npz"),
         str(d / "out.npz")], capture_output=True, text=True, timeout=60,
        env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    f = np.load(d / "out.npz")
    return f["rs"], f["ag"], f["ar"]


_SPAWNED = {}


def _spawned(world, tmp_path_factory):
    """One spawn per world size, shared by every test that reads it."""
    if world not in _SPAWNED:
        _SPAWNED[world] = _spawn(
            world, str(tmp_path_factory.mktemp(f"gloo{world}")))
    return world, _SPAWNED[world]


@pytest.fixture(scope="module", params=[2, 4])
def spawned(request, tmp_path_factory):
    return _spawned(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawned(4, tmp_path_factory)[1]


@pytest.fixture(scope="module")
def one_rank(group):
    """The one-rank runs over the whole batch: replicated in f32 and with
    the int8 bucket 0, and the decoupled one-shard engine with it."""
    return {"f32": _run(1, 0, fsdp=False, wires="f32"),
            "rep": _run(1, 0, fsdp=False),
            "shd": _run(1, 0, fsdp=True, decoupled=True)}


def test_chain_collectives_bitwise(spawned, jax_chains):
    world, runs = spawned
    x = _inputs(world)
    acc = x[0].copy()
    for r in range(1, world):               # ascending rank order, f32
        acc = acc + x[r]
    chunk = N_ELEMS // world
    chain = ring_chain(world, 1)
    allowed = {chain_perm(chain, s) for s in range(1, world)}
    for r in range(world):
        rs, ag, ar, perms = runs["coll"][r]
        assert np.array_equal(rs, acc[r * chunk:(r + 1) * chunk])
        assert np.array_equal(ag, acc)
        assert np.array_equal(ar, acc[:N_ODD])
        assert {tuple(map(tuple, p)) for p in perms.reshape(-1, world, 2)} \
            == allowed
        if world == 4:
            jrs, jag, jar = jax_chains
            assert np.array_equal(rs, jrs[r])
            assert np.array_equal(ag, jag[r])
            assert np.array_equal(ar, jar[r])


def test_decoupled_is_bitwise_burst_on_gloo_ranks(spawned):
    world, runs = spawned
    for r in range(world):
        for a, b in zip(runs["burst"][r], runs["dec"][r]):
            assert np.array_equal(a, b)


def _close(run, ref):
    np.testing.assert_allclose(run[-2], ref[-2], rtol=LOSS_RTOL)
    for a, b in zip(run[:-2], ref[:-2]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def _close_int8(run, ref):
    """tests/test_torch_sharded.py's mixed-wire limits against one rank:
    each rank projects its own gradient onto the int8 grid, one rank the
    whole batch's."""
    np.testing.assert_allclose(run[-2], ref[-2], rtol=INT8_LOSS_RTOL)
    n = over = 0
    for a, b in zip(run[:-2], ref[:-2]):
        np.testing.assert_allclose(a, b, atol=INT8_ATOL, rtol=0)
        over += int((np.abs(a - b) > 1e-4 + np.abs(b) / 128).sum())
        n += a.size
    assert over <= INT8_SHARE * n, (over, n)


def _perms(run):
    return {tuple(map(tuple, p)) for p in run[-1]}


def test_chain_routed_engines(four, one_rank):
    natural = {chain_perm(tuple(range(4)), s) for s in (1, 2, 3)}
    allowed = {chain_perm(CHAIN, s) for s in (1, 2, 3)}
    for r in range(4):
        for plain, routed in (("rep", "rep_chain"), ("shd", "shd_chain")):
            _close(four[routed][r], four[plain][r])
            _close_int8(four[routed][r], one_rank[plain])
            _close(four[routed + "_f32"][r], one_rank["f32"])
            for run in (routed, routed + "_f32"):
                got = _perms(four[run][r])
                assert got and got <= allowed and not got & natural, got
            assert not _perms(four[plain][r])


def test_pod_by_data_engines(four, one_rank):
    for r in range(4):
        _close(four["pod_rep"][r], one_rank["f32"])
        _close(four["pod_shd"][r], one_rank["f32"])
        assert not _perms(four["pod_rep"][r])
        assert _perms(four["pod_shd"][r]) == {chain_perm((0, 1), 1)}
