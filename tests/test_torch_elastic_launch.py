"""The launcher's elastic surface (``--elastic*``) at 4 gloo ranks on the
CPU, held to the port's in-process coordinator run of the same scenario.

JAX's launcher cannot be the reference here: on 4 forced host devices
(``--data 4 --model 1``) it fails at its first step on this jax, elastic
or not, handing its step a batch replicated over the mesh where the step
was compiled for one split over 'data' (ROADMAP §3).  So:

* the launcher (``python -m repro_torch.launch.train``, one process per
  rank, the process group from the environment) runs the smoke qwen3 on
  the sharded flat engine at coverage rate 3.5 (period 4 at 4 and at 2
  ranks), shards 2 and 3 dropping at step 4 and returning at step 20;
* the in-process run drives an ``ElasticCoordinator`` over 4 spawned
  gloo ranks, built as the launcher builds it, through the same
  ``FaultScenario`` at a constant wall.

The launcher measures its walls, so the step at which it detects the
drop may move by one with the load; the cycle boundary it migrates at
does not (period 4).  Held: every rank exits 0; the ``elastic:`` lines of
the lowest member rank (the only rank that logs them) give the in-process
run's migrations (action, shard counts, trigger, periods), members,
spares and fault-event count; each migration lands on the first cycle
boundary after its detection (the scale-up after the return; a plan arms after the step it was detected at); the ranks other
than the lowest member log nothing and the run's closing checkpoint is
written.  The refusals (``--elastic`` with ``--adapt`` or under
``--scheduler ddp``) are checked on the command line and in ``train``.
"""
import json
import multiprocessing as mp
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.preserver import WalkParams
from repro_torch.core.profiler import HardwareModel
from repro_torch.data.pipeline import make_batch
from repro_torch.elastic import (
    CapacityReturn,
    DeviceDrop,
    ElasticController,
    ElasticCoordinator,
    FaultScenario,
    HealthMonitor,
)
from repro_torch.launch.train import build_schedule, init_distributed, train
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import (
    build_bucket_layout,
    build_leaf_time_model,
)
from repro_torch.train.runtime import DeftRuntime

ROOT = Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ, CR, PE = 28, 4, 32, 3.5, 200_000
DROP, RETURN, SHARDS = 4, 20, (2, 3)
ARGS = ["--arch", "qwen3-4b", "--smoke", "--steps", str(STEPS), "--batch",
        str(BATCH), "--seq", str(SEQ), "--device", "cpu", "--fsdp",
        "--coverage-rate", str(CR), "--elastic", "--elastic-drop-step",
        str(DROP), "--elastic-drop-shards", ",".join(map(str, SHARDS)),
        "--elastic-return-step", str(RETURN)]
# JAX's launcher has no --device and no --fsdp (qwen3 is replicated there)
JAX_ARGS = ["--arch", "qwen3-4b", "--smoke", "--steps", "2", "--batch",
            str(BATCH), "--seq", str(SEQ), "--coverage-rate", str(CR),
            "--data", "4", "--model", "1", *ARGS[ARGS.index("--elastic"):]]
MIGRATION = re.compile(
    r"^\s*elastic  step\s+(\d+)  (\S+) (\d+)->(\d+) shards \(trigger (\S+), "
    r"detected at step (\d+)\)  period (\d+)->(\d+)")
SUMMARY = re.compile(r"^elastic: members=(.*) spares=(.*) (\d+) migrations, "
                     r"(\d+) fault events$")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def launcher(tmp_path_factory):
    """The 4 launcher processes, started with the module's first test so
    that they run while the in-process ranks do."""
    d = tmp_path_factory.mktemp("elastic_launch")
    port = _free_port()
    procs = []
    for r in range(4):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK=str(r),
                   LOCAL_RANK=str(r), WORLD_SIZE="4",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *ARGS,
             "--ckpt", str(d / "ckpt")], cwd=d, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    # JAX's launcher on the same scenario, 4 forced host devices
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *JAX_ARGS],
        cwd=d, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    yield procs, d, jax_proc
    for p in procs + [jax_proc]:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _in_process(rank, port, out):
    """The launcher's coordinator, built as ``train`` builds it, through
    the same scenario at a constant wall of 1 s per step."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    try:
        cfg = reduce_for_smoke(get_config("qwen3-4b"))
        meta = init_params(cfg, device="meta")
        bo, nb, _, plan = build_schedule(
            meta, cfg, dp=4, seq_len=SEQ, per_device_batch=BATCH // 4,
            partition_elems=PE, coverage_rate=CR)
        rt = DeftRuntime(cfg, adamw(1e-3), plan.schedule,
                         build_bucket_layout(meta, bo, nb, shard_count=4),
                         device="cpu", fsdp=True)

        def model_for(width):
            return build_leaf_time_model(
                meta, cfg, HardwareModel(dp_degree=width), SEQ,
                max(BATCH // width, 1)).with_coverage_rate(bo, nb, CR)

        walk = WalkParams(s0=4.0, eta=0.01, mu=1.0, sigma=40.0, batch=256)
        c = ElasticCoordinator(
            rt, ElasticController(model_for, bo, nb, walk=walk,
                                  scheduler_cfg=plan.scheduler_cfg),
            HealthMonitor(4), params_abs=meta, global_batch=BATCH)
        scen = FaultScenario(4, (DeviceDrop(DROP, SHARDS),
                                 CapacityReturn(RETURN, SHARDS)))
        state, clock = rt.init_state(0), 0.0
        for step in range(STEPS):
            state = c.maybe_migrate(step, state)
            if c.runtime is not None:
                pos, per = c.members.index(c.position), BATCH // len(c.members)
                full = make_batch(cfg, 0, step, BATCH, SEQ, device="cpu")
                state, _ = c.runtime.step(
                    step, state, {k: v[pos * per:(pos + 1) * per]
                                  for k, v in full.items()})
            obs = scen.observe(step, 1.0)
            if obs.returned:
                c.notice_capacity(step, obs.returned)
            live = [obs.walls[o] for o in c.members
                    if obs.walls[o] is not None]
            clock += max(live, default=1.0)
            c.observe(step, obs.walls, now=clock)
        if rank == 0:
            st = c.stats()
            with open(out, "w") as f:
                json.dump(dict(
                    members=list(st["members"]), spares=list(st["spares"]),
                    n_events=len(st["fault_events"]),
                    migrations=[(e["action"], e["old_shards"],
                                 e["new_shards"], e["trigger"],
                                 e["old_period"], e["new_period"])
                                for e in st["migrations"]]), f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def in_process(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic_inproc") / "rank0.json"
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_in_process, args=(r, port, str(out)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        assert not p.is_alive() and p.exitcode == 0
    return json.loads(out.read_text())


def test_jax_launcher_fails_its_first_step_on_4_devices(launcher):
    """Why the in-process run is the reference: JAX's launcher hands its
    first step a batch replicated over the mesh, where the step was
    compiled for one split over 'data' (ROADMAP §3).  When this fails,
    JAX's launcher has changed, and ROADMAP §3 with it."""
    jax_proc = launcher[2]
    log = jax_proc.communicate(timeout=300)[0]
    assert jax_proc.returncode != 0
    assert "Computation was compiled for input shardings that disagree " \
           "with the shardings of arguments passed to it" in log, log[-3000:]
    assert "Required sharding: NamedSharding(mesh=Mesh('data': 4" in log
    assert re.search(r"step\s+0 loss=", log) is None


def test_launcher_elastic_matches_in_process(launcher, in_process):
    procs, d, _ = launcher
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}: {log[-3000:]}"
    lines = logs[0].splitlines()
    assert "elastic: injected faults: DeviceDrop@4; CapacityReturn@20" \
        in lines
    migs = [MIGRATION.match(x) for x in lines]
    migs = [tuple(int(g) if g.isdigit() else g for g in m.groups())
            for m in migs if m]
    # (step, action, old, new, trigger, detected, old period, new period)
    assert [(a, o, n, t, p0, p1) for _, a, o, n, t, _, p0, p1 in migs] == \
        [tuple(m) for m in in_process["migrations"]]
    (down, _, _, _, _, det, p_old, _), (up, _, _, _, _, det_up, p_mid, _) \
        = migs
    # a plan arms after its step and runs at the next cycle boundary
    assert DROP < det < down <= det + p_old and down % p_old == 0
    assert det_up == RETURN < up <= RETURN + p_mid
    assert (up - down) % p_mid == 0
    summary = [SUMMARY.match(x) for x in lines]
    summary = [m.groups() for m in summary if m]
    assert summary == [(str(tuple(in_process["members"])),
                        str(tuple(in_process["spares"])),
                        str(len(in_process["migrations"])),
                        str(in_process["n_events"]))]
    # the lowest member logs the run; the others, parked or not, do not
    for log in logs[1:]:
        assert not re.search(r"^(step |elastic)", log, re.M), log[-2000:]
    steps = [int(m.group(1)) for m in
             re.finditer(r"^step\s+(\d+) loss=", logs[0], re.M)]
    assert steps and steps[-1] == STEPS - 1
    assert (d / "ckpt" / f"ckpt_{STEPS:08d}.json").exists()


@pytest.mark.parametrize("extra", [["--adapt"], ["--scheduler", "ddp"]])
def test_launcher_refuses(extra, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-4b", "--smoke", "--device", "cpu", "--elastic", *extra],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "--elastic" in out.stderr, out.stderr


@pytest.mark.parametrize("kw", [dict(adapt=True), dict(scheduler="ddp")])
def test_train_refuses(kw):
    init_distributed(torch.device("cpu"))
    with pytest.raises(ValueError, match="elastic"):
        train(reduce_for_smoke(get_config("qwen3-4b")), elastic=True,
              device="cpu", steps=1, batch=2, seq=32, **kw)
