"""The adaptive control plane driving the port's runtime, against the
JAX package's (DESIGN.md §7, §9): ``tests/test_adapt.py::
test_adaptive_loop_hot_swap_bit_matches_reference`` and ``tests/
test_repack.py::test_adaptive_repartition_end_to_end`` on both packages,
the same tiny qwen3, JAX params and numpy batches (``tests/_torch_tiny.py``).

A 3x synthetic bandwidth drop at step 4 drives the copied controller
(timing trigger only): it replans at JAX's step onto JAX's schedule (and,
with a repartitioner, JAX's partition and bucket count), the runtime
swaps at JAX's step with JAX's ``info``, the params end bitwise the
port's explicit reference and, run with JAX's hand-over
(``_torch_tiny.jax_divisors``: every update divided by its phase's
update_k, ROADMAP §3), within atol 1e-4 of JAX's run, and re-staging the
schedule is a pure phase-table hit (``new_phases == 0``).
"""
import jax
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
import _torch_tiny as T
from repro.adapt import AdaptConfig as JAdaptConfig
from repro.adapt import AdaptiveController as JController
from repro.adapt import BandwidthDrop as JDrop
from repro.adapt import RepartitionConfig as JRepartitionConfig
from repro.adapt import Repartitioner as JRepartitioner
from repro.adapt import SyntheticTelemetrySource as JSource
from repro.core.bucket import BucketTimes as JBucketTimes
from repro.core.deft import feedback_solve as jax_feedback_solve
from repro.core.profiler import HardwareModel as JHardwareModel
from repro.optim.optimizers import adamw as jax_adamw
from repro.train import DeftRuntime as JRuntime
from repro.train import build_bucket_layout as jax_layout
from repro.train import build_leaf_time_model as jax_leaf_model
from repro_torch.adapt import (
    AdaptConfig,
    AdaptiveController,
    BandwidthDrop,
    RepartitionConfig,
    Repartitioner,
    SyntheticTelemetrySource,
)
from repro_torch.core.profiler import HardwareModel
from repro_torch.launch.train import init_distributed
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import (
    build_bucket_layout,
    build_leaf_time_model,
)
from repro_torch.train.runtime import DeftRuntime

INFO_KEYS = ("new_phases", "reused_phases", "layout_change", "n_buckets",
             "shards", "moved_elems")


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


@pytest.fixture(scope="module")
def tiny():
    return T.make_tiny()


def _adaptive_loop(t, runtime, ctrl, src, n_steps, batch_of, stage,
                   run_base_of=None):
    """The controller loop of ``tests/test_adapt.py``: one synthetic wall
    per step, and each adopted replan staged by ``stage(event, state,
    batch)``.  Returns (state, losses, the adopted events)."""
    events, losses = [], []
    run_base = None
    state = (runtime.state_from_params(t.params)
             if isinstance(runtime, DeftRuntime)
             else runtime.init_state(t.key))
    for step in range(n_steps):
        batch = batch_of(step)
        state, m = runtime.step(step, state, batch)
        losses.append(float(m["loss"]))
        wall = src.wall_time(step, ctrl.schedule, ctrl.scheduler_cfg,
                             runtime.last_phase, solve_times=ctrl.times,
                             run_base=run_base)
        ev = ctrl.observe(step, runtime.last_phase, wall)
        if ev is not None and ev.changed:
            events.append(ev)
            if ev.partition_changed and run_base_of is not None:
                run_base = run_base_of(ev)
            stage(ev, state, batch)
    return state, losses, events


@pytest.mark.parametrize("repartition", [False, True],
                         ids=["same-layout", "repartition"])
def test_adaptive_loop_hot_swap_matches_jax(group, tiny, single_mesh,
                                            repartition):
    """``tests/test_adapt.py::test_adaptive_loop_hot_swap_bit_matches_
    reference`` and, with a repartitioner, ``tests/test_repack.py::
    test_adaptive_repartition_end_to_end``."""
    pe = 20_000
    bo, nb, times, schedule, scfg = T.plan(tiny, pe)
    jl, lay = T.layouts(tiny, bo, nb)
    n_steps = 6 * schedule.period + 8
    jrp = rp = None
    if repartition:
        jm = jax_leaf_model(tiny.jparams, tiny.cfg,
                            JHardwareModel(dp_degree=2), T.S, T.B)
        jm = jm.with_coverage_rate(bo, nb, 1.8)
        jrp = JRepartitioner(jm, JRepartitionConfig(base_partition_elems=pe))
        model = build_leaf_time_model(tiny.meta, tiny.tcfg,
                                      HardwareModel(dp_degree=2), T.S, T.B)
        model = model.with_coverage_rate(bo, nb, 1.8)
        assert model.bucket_times(bo, nb) == times
        rp = Repartitioner(model, RepartitionConfig(base_partition_elems=pe))
    jtimes = JBucketTimes(times.fwd, times.bwd, times.comm)
    jsched, _, jscfg, _ = jax_feedback_solve(jtimes, T.WALK)
    jctrl = JController(jtimes, jsched, jscfg, walk=T.WALK,
                        cfg=JAdaptConfig(**T.CTRL), repartitioner=jrp,
                        bucket_of=bo if repartition else None)
    make_ctrl = lambda: AdaptiveController(
        times, schedule, scfg, walk=T.WALK, cfg=AdaptConfig(**T.CTRL),
        repartitioner=rp, bucket_of=bo if repartition else None)

    def new_layout(ev, pkg_layout, params):
        if not ev.partition_changed:
            return None
        return pkg_layout(params, ev.partition.bucket_of,
                          ev.partition.n_buckets)

    jrt = JRuntime(tiny.cfg, jax_adamw(T.LR), jsched, jl, single_mesh)
    jinfo = []
    with jax.set_mesh(single_mesh):
        jstate, _, jevents = _adaptive_loop(
            tiny, jrt, jctrl, JSource(jtimes, JDrop(step=4, comm_scale=3.0)),
            n_steps, lambda i: T.jb(tiny, i),
            lambda ev, st, bt: jinfo.append(jrt.prepare_swap(
                ev.schedule, st, bt,
                layout=new_layout(ev, jax_layout, tiny.jparams))),
            jrp and (lambda ev: jrp.base_times_for(ev.partition)))
        jfinal = jax.tree.map(np.asarray, jrt.params_tree(jstate))

    def port_loop():
        rt = DeftRuntime(tiny.tcfg, adamw(T.LR), schedule, lay, device="cpu")
        infos = []
        out = _adaptive_loop(
            tiny, rt, make_ctrl(),
            SyntheticTelemetrySource(times,
                                     BandwidthDrop(step=4, comm_scale=3.0)),
            n_steps, lambda i: T.tb(tiny, i),
            lambda ev, st, bt: infos.append(rt.prepare_swap(
                ev.schedule,
                layout=new_layout(ev, build_bucket_layout, tiny.meta))),
            rp and (lambda ev: rp.base_times_for(ev.partition)))
        return (rt, infos, *out)

    rt, infos, state, losses, events = port_loop()

    # one replan, at JAX's step, onto JAX's schedule and partition
    assert len(events) == len(jevents) == 1
    ev, jev = events[0], jevents[0]
    assert ev.step == jev.step
    assert T.phases(ev.schedule) == T.phases(jev.schedule) \
        != T.phases(schedule)
    assert ev.partition_changed == jev.partition_changed == repartition
    assert ev.new_n_buckets == jev.new_n_buckets
    assert {k: infos[0][k] for k in INFO_KEYS if k in infos[0]} == \
        {k: jinfo[0][k] for k in INFO_KEYS if k in jinfo[0]}
    st = rt.stats()
    assert st["replans"] == 1 and st["hot_swaps"] == 1
    assert st["layout_swaps"] == int(repartition)
    swap = rt.swap_log[0]
    assert swap["step"] == jrt.swap_log[0]["step"]
    assert swap["step"] % schedule.period == 0
    assert swap["n_buckets"] == (ev.new_n_buckets if repartition else nb)
    assert rt.period == ev.schedule.period
    assert st["steps_dispatched"] == n_steps and st["steps_per_s"] > 0
    with T.jax_divisors():
        rt_j, _, state_j, _, _ = port_loop()
    T.near_jax(rt_j, state_j, jfinal)

    lay_b = new_layout(ev, build_bucket_layout, tiny.meta) or lay
    T.bitwise((rt, state, losses),
             T.reference(tiny, schedule, lay, ev.schedule, lay_b,
                        swap["step"], n_steps))
    # staging the same schedule again is a pure phase-table hit
    re_info = rt.prepare_swap(ev.schedule)
    assert re_info["new_phases"] == 0
    assert infos[0]["new_phases"] + infos[0]["reused_phases"] == \
        ev.schedule.period
