"""The port's observability (``repro_torch.obs``, the runtime's trace)
against the JAX package's (DESIGN.md §11, §13-§14).

* The sharded engine on a mixed int8 / bf16 wire layout with the gather
  skip on records JAX's step spans (``phase``, ``collective-group`` with
  the bytes on each link, ``update-apply``, ``gather-skip``) in JAX's
  order with JAX's names and args (times aside), on the tiny qwen3 with
  the same JAX params and numpy batches (``tests/_torch_tiny.py``);
  ``tests/test_torch_swap.py`` holds the same on both engines across a
  partition swap.  ``wire_bytes_report`` over the port's trace is ``ok``
  against its plan, and ``attribute_trace`` measures every phase.
* ``wire_bytes_per_phase`` / ``wire_bytes_split_per_phase`` equal JAX's
  on f32, mixed-wire and all-secondary (chain-routed) layouts and
  schedules in which no bucket syncs two generations in one phase.  Where
  one does, the port counts both generations, as its engine (and JAX's)
  puts both on the wire, and JAX's plan counts one (ROADMAP section 3;
  ``tests/test_torch_tp_families.py`` holds the port's plan to the
  measured bytes there).
* Without a tracer the runtime records the control plane only.
* The launcher: ``--adapt --adapt-drop-step 4 --adapt-repartition --trace
  OUT.json`` prints the replan JAX's launcher prints under the same
  synthetic walls and a hot swap, and writes a Chrome trace with phase,
  swap-install and repack spans.  The two launchers draw other batches,
  and JAX's may still be compiling its swap when it ends, so only the
  lines the walls decide are compared.  JAX's launcher runs through
  ``_JAX_LAUNCHER``, which joins that compile before the interpreter
  exits: left running, it aborts or crashes the exit (SIGABRT or
  SIGSEGV, more often under load; ROADMAP §3).
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
import _torch_tiny as T
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.obs import Tracer as JTracer
from repro.optim.optimizers import adamw as jax_adamw
from repro.train import DeftRuntime as JRuntime
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch.train import init_distributed
from repro_torch.obs import Tracer, attribute_trace, wire_bytes_report
from repro_torch.optim.optimizers import adamw
from repro_torch.train.runtime import DeftRuntime

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


@pytest.fixture(scope="module")
def tiny():
    return T.make_tiny()


def _mixed(nb):
    return tuple(("int8", "bf16", "f32")[b % 3] for b in range(nb))


def test_sharded_precision_trace_matches_jax(group, tiny, single_mesh):
    bo, nb, times, sched, scfg = T.plan(tiny, 60_000)
    jl, lay = T.layouts(tiny, bo, nb)
    jl = jl.with_precision(JPolicy(wire=_mixed(nb)))
    lay = lay.with_precision(PrecisionPolicy(wire=_mixed(nb)))
    n_steps = 2 * sched.period + 1
    jrt = JRuntime(tiny.cfg, jax_adamw(T.LR), sched, jl, single_mesh,
                   fsdp=True, tracer=JTracer())
    T.jax_run(tiny, jrt, n_steps, single_mesh)
    rt = DeftRuntime(tiny.tcfg, adamw(T.LR), sched, lay, device="cpu",
                     fsdp=True, tracer=Tracer())
    assert rt.trace_steps and rt.gather_skip
    T.port_run(tiny, rt, n_steps)
    rows = T.span_rows(rt.tracer)
    assert rows == T.span_rows(jrt.tracer)
    kinds = {r[0] for r in rows}
    assert kinds == {"phase", "collective-group", "update-apply",
                     "gather-skip"}
    firsts = [r for r in rows if r[0] == "phase" and r[4]["first"]]
    assert [r[2] for r in firsts] == list(range(sched.period))

    rep = wire_bytes_report(rt.tracer, rt.wire_bytes_per_phase,
                            rt.wire_bytes_split_per_phase)
    assert rep.ok and rep.planned_per_cycle > 0
    assert all(m is not None for m in rep.measured_per_phase)
    assert set(rep.precisions) == {lay.precision.describe()}
    att = attribute_trace(rt.tracer, times, scfg, sched)
    assert att.period == sched.period
    assert all(m is not None and m > 0 for m in att.measured_phase_s)
    st = rt.stats()
    assert st["trace"]["recorded"] == rt.tracer.n_recorded
    assert st["planned_wire_bytes_per_cycle"] == rep.planned_per_cycle


def _all_secondary(schedule):
    """Every synced bucket on the secondary link (the chain-routed
    schedules of ``tests/test_torch_chains.py``)."""
    nb = len(schedule.phases[0].route_new)
    return dataclasses.replace(schedule, phases=tuple(
        dataclasses.replace(ph, secondary=tuple(
            (ph.route_new[b] == "sync" and ph.rotate) or ph.sync_cur[b]
            for b in range(nb))) for ph in schedule.phases))


@pytest.mark.parametrize("case", ["f32", "mixed", "chained"])
@pytest.mark.parametrize("pe", [20_000, 60_000])
def test_planned_wire_bytes_match_jax(group, tiny, single_mesh, case, pe):
    bo, nb, _, sched, _ = T.plan(tiny, pe)
    jl, lay = T.layouts(tiny, bo, nb)
    kw = {}
    if case == "mixed":
        jl = jl.with_precision(JPolicy(wire=_mixed(nb), master="bf16sr"))
        lay = lay.with_precision(PrecisionPolicy(wire=_mixed(nb),
                                                 master="bf16sr"))
    if case == "chained":
        sched = _all_secondary(sched)
        kw = dict(secondary_chain=(0,))
    # the domain where the two plans agree: no bucket syncs twice a phase
    assert not any(ph.rotate and ph.route_new[b] == "sync" and ph.sync_cur[b]
                   for ph in sched.phases for b in range(nb))
    jrt = JRuntime(tiny.cfg, jax_adamw(T.LR), sched, jl, single_mesh)
    rt = DeftRuntime(tiny.tcfg, adamw(T.LR), sched, lay, device="cpu", **kw)
    assert rt.wire_bytes_per_phase == tuple(jrt.wire_bytes_per_phase)
    assert rt.wire_bytes_split_per_phase == tuple(
        tuple(x) for x in jrt.wire_bytes_split_per_phase)
    if case == "chained":
        assert all(p == 0 for p, _ in rt.wire_bytes_split_per_phase)


def test_untraced_runtime_records_control_plane_only(group, tiny):
    bo, nb, _, sched, _ = T.plan(tiny, 20_000)
    lay = T.layouts(tiny, bo, nb)[1]
    rt = DeftRuntime(tiny.tcfg, adamw(T.LR), sched, lay, device="cpu")
    assert not rt.trace_steps and rt.swap_log == []
    state, _ = T.port_run(tiny, rt, 2)
    assert rt.tracer.spans("phase") == []
    rt.prepare_swap(sched)
    T.port_run(tiny, rt, 1)
    assert [sp.kind for sp in rt.tracer.spans()] == ["swap-compile",
                                                     "swap-install"]
    assert rt.swap_log[0]["step"] == 0 and rt.swap_log[0]["repack_s"] is None


ADAPT_ARGS = ["--arch", "qwen3-4b", "--smoke", "--steps", "16", "--batch",
              "2", "--seq", "32", "--adapt", "--adapt-drop-step", "4",
              "--adapt-repartition"]


# JAX's launcher, then a join of its background swap compile (the runtime
# names the thread), so that the interpreter never exits with it running
_JAX_LAUNCHER = """
import runpy, sys, threading
sys.argv[0] = "repro.launch.train"
runpy.run_module("repro.launch.train", run_name="__main__", alter_sys=True)
for t in threading.enumerate():
    if t.name == "deft-swap-compile":
        t.join()
"""


@pytest.fixture(scope="module", autouse=True)
def launchers(tmp_path_factory):
    """Both packages' launchers under ``ADAPT_ARGS``, each writing its
    trace, started with the module's first test so that they run while
    the in-process tests do: ({package: process}, {package: trace})."""
    d = tmp_path_factory.mktemp("launchers")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               PYTHONUNBUFFERED="1")
    out = {pkg: d / f"{pkg}.json" for pkg in ("repro", "repro_torch")}
    entry = {"repro": ["-c", _JAX_LAUNCHER],
             "repro_torch": ["-m", "repro_torch.launch.train"]}
    procs = {pkg: subprocess.Popen(
        [sys.executable, *entry[pkg], *ADAPT_ARGS, "--trace", str(out[pkg])]
        + (["--device", "cpu"] if pkg == "repro_torch" else []),
        cwd=d, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pkg in out}
    yield procs, out
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def test_launcher_adapt_and_trace(launchers):
    procs, out = launchers
    logs = {pkg: p.communicate(timeout=300)[0] for pkg, p in procs.items()}
    for pkg, p in procs.items():
        assert p.returncode == 0, logs[pkg][-3000:]
    assert f"trace -> {out['repro']}" in logs["repro"]

    def replans(log):
        # the replan lines the synthetic walls decide, solve time aside
        return [re.sub(r"\(\d+ ms\)", "", line).strip()
                for line in log.splitlines() if line.startswith("adapt    ")]
    port = replans(logs["repro_torch"])
    assert port and port == replans(logs["repro"])
    assert "REPARTITION" in port[0]
    swaps = [line for line in logs["repro_torch"].splitlines()
             if line.strip().startswith("swap ")]
    assert len(swaps) == 1 and "installed" in swaps[0]
    assert re.search(r"adapt: 1 replans, 1 hot-swaps \(1 layout-changing\)",
                     logs["repro_torch"])
    assert f"trace -> {out['repro_torch']}" in logs["repro_torch"]

    trace = json.loads(out["repro_torch"].read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"phase0", "swap-install", "swap-repack"} <= names
    kinds = {e.get("cat") for e in trace["traceEvents"]}
    assert {"step", "phase", "collective-group", "swap-install",
            "repack", "replan"} <= kinds
