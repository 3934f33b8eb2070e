"""Training driver of the port: DDP baseline or the DeFT pipeline
(profile -> knapsack solver -> Preserver -> replicated flat engine).

Port of ``repro/launch/train.py`` for the flat engines' flags: the
precision ones (``--wire-precision``, ``--master-dtype``,
``--compute-dtype``, DESIGN.md §13), ``--fsdp``, the sharded flat
engine (params and moments 1/N per rank, DESIGN.md §8; by default the
archs ``repro_torch.sharding.needs_fsdp`` names), ``--decoupled``, its
param all-gathers streamed into the forward (DESIGN.md §12), and
``--pod``, a ``pod x data`` layout of the ranks whose syncs are
hierarchical, ``--data --model`` (or ``--production-mesh``), a mesh with
a 'model' axis over which every config runs tensor-parallel
(``sharding/tp.py``; both flat engines in f32, an FSDP arch on its
sharded default, and the DDP baseline), and checkpoints
in the JAX package's format (``--ckpt``, ``--ckpt-every``, ``--resume``;
a SIGTERM or SIGUSR1 checkpoints and exits cleanly, DESIGN.md §10), the
online control plane (``--adapt``,
``--adapt-drop-step``, ``--adapt-drop-scale``, ``--adapt-repartition``:
telemetry, drift detection, a Preserver-gated replan and a hot swap at a
cycle boundary, DESIGN.md §7 and §9), the elastic control plane
(``--elastic``, ``--elastic-drop-step``, ``--elastic-drop-shards``,
``--elastic-return-step``, ``--elastic-straggler-step``,
``--elastic-straggler-shard``, ``--elastic-straggler-factor``: health
monitoring, a scale-down or scale-up of the ranks at a cycle boundary and
an emergency checkpoint when none survive, DESIGN.md §10) and ``--trace
OUT.json``, a Chrome trace of every step's spans.  Runs on the card unless ``--device
cpu``.  Under ``torchrun`` the process group comes from its environment;
run alone it is a one-rank group (NCCL on the card, gloo on the CPU), so
every gradient sum still goes through a real collective.  ``--arch``
takes every config of ``repro_torch.configs``; an audio or vision
config's batches carry the stub frontend's memory, split over the ranks
with the tokens; a MoE config's log lines carry the aux loss.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --smoke --scheduler deft --steps 8 --batch 4 --seq 64 \
        --wire-precision int8 --master-dtype bf16sr
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --smoke --steps 6 --batch 2 --seq 32 --device cpu --fsdp
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen3-4b --smoke --steps 6 --batch 2 --seq 32 --device cpu \
        --fsdp --decoupled
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --smoke --steps 4 --batch 2 --seq 32 --device cpu --ckpt CKPT_DIR \
        --ckpt-every 2 [--resume]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --smoke --steps 16 --batch 2 --seq 32 --device cpu --adapt \
        --adapt-drop-step 4 --adapt-repartition --trace OUT.json
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch seamless-m4t-large-v2 --smoke --steps 6 --batch 2 --seq 32 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v2-236b --smoke --steps 6 --batch 2 --seq 32 \
        --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-4b --smoke --steps 28 --batch 4 --seq 32 --device cpu \
        --fsdp --coverage-rate 3.5 --elastic --elastic-drop-step 4 \
        --elastic-drop-shards 2,3 --elastic-return-step 20
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch gemma2-2b --smoke --steps 6 --batch 4 --seq 64 --device cpu \
        --data 2 --model 2
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import socket
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.adapt import (
    AdaptConfig,
    AdaptiveController,
    BandwidthDrop,
    RepartitionConfig,
    Repartitioner,
    SyntheticTelemetrySource,
)
from repro_torch.checkpoint import (
    latest_step,
    load_layout_descriptor,
    restore,
    save,
    save_layout_descriptor,
    saved_keys,
    schedule_digest,
    valid_steps,
)
from repro_torch.configs import ARCH_NAMES, get_config, reduce_for_smoke
from repro_torch.core.bucket import BucketTimes
from repro_torch.core.deft import Planner, PlanRequest
from repro_torch.core.preserver import WalkParams
from repro_torch.core.profiler import HardwareModel
from repro_torch.data.pipeline import make_batch
from repro_torch.elastic import (
    CapacityReturn,
    DeviceDrop,
    ElasticController,
    ElasticCoordinator,
    ElasticHalt,
    FaultScenario,
    HealthMonitor,
    StragglerSlowdown,
)
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models.model import init_params
from repro_torch.obs import Tracer, format_event
from repro_torch.optim.optimizers import adamw
from repro_torch.sharding import needs_fsdp
from repro_torch.sharding.tp import PATHS_ITEM, model_specs, shard_params
from repro_torch.train.bucketing import (
    assign_buckets,
    build_bucket_layout,
    build_leaf_time_model,
    coverage_rescale,
    leaf_bucket_times,
)
from repro_torch.train.runtime import DeftRuntime, init_ddp_state, make_ddp_step
from repro_torch.tree import tree_map


def init_distributed(device: torch.device) -> None:
    """Process group from torchrun's environment, else a one-rank group
    on a free localhost port.  No-op when one exists."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)


def pod_groups(pod: int):
    """(data group, pod group) of this rank in a ``pod x data`` layout of
    the world, rank ``p * data + d`` at pod ``p``, data position ``d`` (the
    JAX mesh's device order): the groups of ``make_debug_mesh(data, 1,
    pod)``.  ``pod == 1`` is (None, None): one DP axis over the world."""
    world = dist.get_world_size()
    if pod < 1 or world % pod:
        raise ValueError(f"--pod {pod} does not divide the {world} ranks")
    if pod == 1:
        return None, None
    mesh = make_debug_mesh(data=world // pod, model=1, pod=pod)
    return mesh.group("data"), mesh.group("pod")


def train_mesh(*, pod: int = 1, data: Optional[int] = None, model: int = 1,
               production_mesh: bool = False):
    """The launcher's mesh over the world: ``make_production_mesh()``, or
    ``(pod, data, model)`` with 'data' taking the ranks the other two
    leave (``data`` None).  The default puts every rank on the data axes
    at model 1; JAX's launcher defaults to ``data = n_dev // 2`` and a
    model axis of the rest (ROADMAP §3)."""
    world = dist.get_world_size()
    if production_mesh:
        if pod > 1 or data is not None or model != 1:
            raise ValueError("--production-mesh sets the mesh: drop --pod, "
                             "--data and --model")
        return make_production_mesh()
    if pod < 1 or model < 1 or world % (pod * model):
        raise ValueError(f"--pod {pod} x --model {model} does not divide the "
                         f"{world} ranks")
    if data is None:
        data = world // (pod * model)
    return make_debug_mesh(data=data, model=model, pod=pod if pod > 1 else 0)


def build_schedule(params, cfg, *, dp: int, seq_len: int,
                   per_device_batch: int, partition_elems: int,
                   coverage_rate: float = 0.0, heterogeneous: bool = True,
                   mu: float = 1.65, eps: float = 0.01, max_retries: int = 10,
                   wire_precision: str = "f32", master_dtype: str = "f32"):
    """Leaf-bucket profile -> Solver -> Preserver; ``coverage_rate > 0``
    rescales the analytic comm times to that coverage rate.
    ``wire_precision`` engages the per-bucket precision ladder ("auto") or
    forces a uniform wire dtype; the returned plan carries the adopted
    policy (``plan.precision``)."""
    bucket_of, nb = assign_buckets(params, cfg, partition_elems)
    hw = HardwareModel(dp_degree=dp)
    times = leaf_bucket_times(params, cfg, bucket_of, nb, hw, seq_len,
                              per_device_batch)
    if coverage_rate > 0:
        scale = coverage_rescale(times, coverage_rate)
        times = BucketTimes(times.fwd, times.bwd,
                            tuple(c * scale for c in times.comm))
    walk = WalkParams(s0=4.0, eta=0.01, mu=1.0, sigma=40.0, batch=256)
    res = Planner().plan(PlanRequest(
        times=times, walk=walk, heterogeneous=heterogeneous, mu=mu, eps=eps,
        max_retries=max_retries, wire_precision=wire_precision,
        master_dtype=master_dtype,
    ))
    return bucket_of, nb, times, res


def restore_runtime_state(runtime, ckpt_dir: str, params_abs,
                          log: Callable = print):
    """Restore the newest usable checkpoint into ``runtime``'s resident
    state: ``(state, start_step)``, or ``(None, 0)`` when nothing on disk
    restores (DESIGN.md §10).

    * Only committed steps are tried (``valid_steps``); a step that still
      fails to restore (torn arrays, a stale sidecar, another number of
      ranks' accumulator rows) falls back to the previous one.
    * A checkpoint written under another layout re-packs through the
      LayoutTransition (``tree_to_state``).
    * It continues mid-cycle only under the identical schedule (digest)
      and layout, and, on a gather-skip runtime, only if the gather cache
      was saved; otherwise the cycle restarts at the checkpoint step, and
      a digest mismatch drops the gather cache with a warning.
    * A checkpoint saved inside the first cycle after a hot swap carries
      the update divisors the hand-over still owed
      (``handover_divisors``); a mid-cycle resume installs them, a
      restarted cycle does not.
    * A restarted cycle on a checkpoint saved mid-cycle with live
      accumulators restores as JAX's does, with a warning the JAX package
      does not print: the partial generation is not synced as the saved
      cycle would sync it, and replicas disagree from the first update.

    The arrays are staged on the host and moved to the device bucket by
    bucket, so the device holds the state once."""
    layout = runtime.layout
    run_digest = schedule_digest(runtime.schedule)
    for last in reversed(valid_steps(ckpt_dir)):
        try:
            src_layout, next_phase, src_digest, divisors = \
                load_layout_descriptor(ckpt_dir, last, params_abs)
            if src_layout is None:
                src_layout = layout
            digest_ok = (not src_digest) or src_digest == run_digest
            # read the gather cache only if the checkpoint has one and the
            # layout and schedule both match
            has_pg = any(k.startswith("pgather")
                         for k in saved_keys(ckpt_dir, last))
            ts = restore(
                ckpt_dir, last,
                runtime.checkpoint_struct(
                    src_layout,
                    with_pgather=(has_pg and src_layout == layout
                                  and digest_ok)),
                device="cpu")
            state = runtime.tree_to_state(ts, src_layout=src_layout)
        except Exception as e:      # torn arrays, stale sidecar, ...
            log(f"resume: checkpoint step {last} unusable "
                f"({type(e).__name__}: {e}); trying the previous one")
            continue
        # mid-cycle only under the byte-identical schedule, and only if
        # the gather cache the resumed position may read was saved
        same_cycle = (src_layout == layout and src_digest == run_digest
                      and (not runtime.gather_skip or has_pg))
        runtime.reset_cycle(last - next_phase if same_cycle else last)
        runtime.pending_divisors = divisors if same_cycle else []
        if src_digest and not digest_ok:
            log(f"resume: WARNING schedule digest mismatch at step {last} "
                f"(saved {src_digest}, running {run_digest}) — gather cache "
                f"dropped, cycle restarted at the checkpoint step")
        if not same_cycle and next_phase and any(
                bool(x.any()) for x in ts["cur"] + ts["fut"]):
            # the JAX package restores this silently; its replicas
            # disagree alike (tests/test_torch_repack.py)
            log(f"resume: WARNING checkpoint step {last} was saved at cycle "
                f"position {next_phase} with live accumulators; the "
                f"restarted cycle does not sync them as the saved one "
                f"would, and across ranks the replicas disagree from the "
                f"first update")
        log(f"resumed checkpoint step {last}"
            + (" (re-packed from a different layout)"
               if src_layout != layout else "")
            + ("" if same_cycle else " (cycle restarted)"))
        return state, last
    return None, 0


def save_checkpoint(ckpt_dir: str, step: int, runtime, state
                    ) -> Optional[str]:
    """Checkpoint ``state`` as step ``step`` (with the layout descriptor
    of a DeFT ``runtime``; ``None`` for the DDP baseline, whose state is
    already a tree).  Every rank of the runtime takes part in
    ``state_to_tree``, which builds the tree on its writer's host alone
    (rank 0, or the lowest member after an elastic migration); the writer
    writes and every rank of the world waits at a barrier until the
    sidecar is committed (a parked rank of an elastic run, with neither
    runtime nor state, only waits).  Returns the npz path on the
    writer."""
    if runtime is not None:
        tree = runtime.state_to_tree(state)
    else:
        tree = state if dist.get_rank() == 0 else None
    path = None
    if tree is not None:
        path = save(ckpt_dir, step, tree)
        if runtime is not None:
            save_layout_descriptor(
                ckpt_dir, step, runtime.layout,
                next_phase=runtime.phase_in_cycle(step),
                digest=schedule_digest(runtime.schedule),
                divisors=runtime.pending_divisors)
    del tree
    dist.barrier()
    return path


PREEMPTION_SIGNALS = (signal.SIGTERM, signal.SIGUSR1)


def _preempted(flag: Dict[str, Any], device: torch.device) -> bool:
    """Whether any rank took a preemption signal (every rank calls this
    at the top of each step, so all of them stop at the same step)."""
    if dist.get_world_size() == 1:
        return flag["sig"] is not None
    seen = torch.tensor([int(flag["sig"] is not None)], device=device)
    dist.all_reduce(seen, op=dist.ReduceOp.MAX)
    return bool(seen.item())


COMPUTE_DTYPES = {"f32": None, "bf16": torch.bfloat16}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, *, scheduler: str = "deft", steps: int = 40, batch: int = 8,
          seq: int = 64, coverage_rate: float = 1.8,
          partition_elems: int = 200_000, seed: int = 0, device="cuda",
          lr: float = 1e-3, loss_chunk: int = 0,
          attn_impl: Optional[str] = None, scan_impl: Optional[str] = None,
          update_impl: Optional[str] = None,
          quantize_impl: Optional[str] = None, wire_precision: str = "f32",
          master_dtype: str = "f32", compute_dtype: str = "f32",
          fsdp: Optional[bool] = None, decoupled: bool = False,
          pod: int = 1, data: Optional[int] = None, model: int = 1,
          production_mesh: bool = False,
          secondary_chain: Optional[Sequence[int]] = None,
          reroute: Optional[Callable] = None,
          ckpt: str = "", ckpt_every: int = 0, resume: bool = False,
          adapt: bool = False, adapt_config: Optional[AdaptConfig] = None,
          adapt_drop_step: int = 0, adapt_drop_scale: float = 3.0,
          adapt_repartition: bool = False, trace: str = "",
          elastic: bool = False, elastic_drop_step: int = 0,
          elastic_drop_shards: Sequence[int] = (),
          elastic_return_step: int = 0, elastic_straggler_step: int = 0,
          elastic_straggler_shard: int = 0,
          elastic_straggler_factor: float = 3.0,
          on_step: Optional[Callable] = None,
          log: Callable = print) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` steps on a global ``batch`` split over
    the ranks of the process group (initialised here if missing).

    ``on_step(step, runtime, state, metrics)`` runs after every step;
    ``attn_impl``/``scan_impl``/``update_impl``/``quantize_impl`` =
    "plain" force the kernels' plain versions (a comparison knob).
    ``wire_precision`` ("auto", "f32", "bf16", "int8"), ``master_dtype``
    ("f32", "bf16sr") and ``compute_dtype`` ("f32", "bf16") are the DeFT
    engine's precision (the DDP baseline takes none), on every config: an
    audio or vision config's f32 stub memory is never cast, so its encoder
    and cross-attention K/V run in f32 beside bf16 params, as JAX's
    promotion runs them.  ``fsdp`` runs the
    sharded flat engine over a layout of one shard per rank (None: the
    arch's default, ``needs_fsdp``, under DeFT; the DDP baseline is
    replicated); its gather skip is on where the
    schedule can reuse a gather, and ``decoupled`` streams its param
    gathers into the forward.  ``pod`` lays the ranks out as ``pod x
    data`` (``pod_groups``): the sharded layout splits over 'data' and the
    syncs are hierarchical.  ``model`` adds a 'model' axis (``data`` None:
    the ranks the other axes leave; ``production_mesh``: JAX's production
    mesh mapped onto the nodes, ``train_mesh``): the global batch splits
    over pod x data, each model rank runs the model tensor-parallel on
    its shards of the params (every config: MoE over its experts, MLA
    and the VLM's gated cross block over their heads too), on either flat
    engine in f32 (an FSDP arch on its sharded default, split over 'data'
    within each model rank) or the DDP baseline (the tree-state engine,
    the precision path, AG streaming, chains, checkpoints, adapt and
    elastic refuse it, ROADMAP item 8.2).
    ``secondary_chain`` routes the secondary link's collectives along
    that ring chain of the 'data' ranks; ``reroute(schedule, times)``
    returns the (schedule, AG plan) the runtime runs instead of the
    planner's schedule and no AG plan.

    ``ckpt`` is a checkpoint directory: the state is saved there every
    ``ckpt_every`` steps (0: only at the end) and at the end, and a
    SIGTERM or SIGUSR1 saves it at the top of the next step and stops the
    run (the previous handlers are back when ``train`` returns).
    ``resume`` first restores the newest usable checkpoint there
    (``restore_runtime_state``) and runs ``steps`` steps from its step,
    on the batches of those steps.

    ``adapt`` attaches the adaptive controller (JAX's launcher wiring):
    each step's wall feeds it, and a replan it adopts is staged with
    ``prepare_swap(background=True)`` under the layout its view assumes,
    a wire-precision change riding on it; ``adapt_config`` replaces the
    launcher's ``AdaptConfig``.  ``adapt_drop_step > 0`` feeds it the
    synthetic walls of a ``adapt_drop_scale``-fold bandwidth drop at that
    step instead of the measured ones (the device synchronised, then the
    host clock around the step, the largest over the ranks), and
    ``adapt_repartition`` lets a replan change the bucket partition
    itself.  Over several ranks the swap builds in the foreground, so
    that every rank installs it at the same boundary.  ``trace`` is a path
    for the Chrome trace of every span (written by rank 0).

    ``elastic`` attaches the elastic control plane (JAX's launcher wiring,
    DESIGN.md §10): an ``ElasticCoordinator`` over the world, one origin
    shard per rank, whose health monitor sees every step's wall (the
    device synchronised, the host clock around the step, the largest over
    the ranks; a parked rank's counts 0) under the injected faults: a
    ``DeviceDrop`` of ``elastic_drop_shards`` (default: the last rank) at
    ``elastic_drop_step``, their ``CapacityReturn`` at
    ``elastic_return_step``, a ``StragglerSlowdown`` of
    ``elastic_straggler_shard`` by ``elastic_straggler_factor`` from
    ``elastic_straggler_step`` (0: none).  The monitor's clock advances by
    the slowest live shard's wall, as JAX's does, and by the step's wall
    when no shard is live (JAX's clock then stands still, so it never
    declares the last shards dead; ROADMAP §3).  A migration re-forms the
    group at a cycle boundary, the global batch staying whole (new
    position ``j`` takes its ``j``-th slice); a parked rank skips its
    steps.  A halt writes the emergency checkpoint (with ``ckpt``) and
    ends the run cleanly, as a SIGTERM or SIGUSR1 does; the lowest member
    rank logs.

    Returns the losses, per-step wall times (each step synchronised), the
    schedule, the runtime, the final state, the first step run, the
    adaptive controller (None without ``adapt``) and the elastic
    coordinator (None without ``elastic``); a parked rank ends with the
    runtime and state None and records no loss for its skipped steps."""
    device = torch.device(device)
    init_distributed(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = train_mesh(pod=pod, data=data, model=model,
                      production_mesh=production_mesh)
    n_dp = mesh.dp_size
    if batch % n_dp:
        raise ValueError(f"global batch {batch} does not split over {n_dp} "
                         f"data-parallel ranks")
    per = batch // n_dp
    if mesh.size("model") > 1 and (ckpt or adapt or elastic):
        raise NotImplementedError(
            f"checkpoints, adapt and elastic at model {mesh.size('model')} "
            f"are not ported ({PATHS_ITEM})")
    opt = adamw(lr)
    out: Dict[str, Any] = {"losses": [], "step_s": [], "collectives": []}
    tracer = Tracer() if trace else None
    runtime = None
    start_step = 0
    if fsdp is None:             # the DDP baseline is replicated only
        fsdp = scheduler == "deft" and needs_fsdp(cfg.name)
    # the log carries the aux loss where a MoE layer makes one
    has_moe = cfg.moe is not None and any(
        s.ffn == "moe" for s in cfg.layer_specs()[cfg.moe.first_k_dense:])
    if elastic and adapt:
        raise ValueError("elastic and adapt are mutually exclusive: the "
                         "elastic controller owns replanning while it owns "
                         "the ranks (DESIGN.md §10)")
    if elastic and scheduler != "deft":
        raise ValueError("elastic needs --scheduler deft (the migration path "
                         "repacks the flat DeFT state)")
    if scheduler == "ddp":
        if fsdp:
            raise ValueError("the port's DDP baseline is replicated: fsdp "
                             "needs --scheduler deft")
        if decoupled or secondary_chain is not None:
            raise ValueError("the DDP baseline has no param gather to "
                             "stream and no secondary link: decoupled and "
                             "secondary_chain need --scheduler deft")
        if adapt:
            raise ValueError("the adaptive control plane replans DeFT "
                             "schedules: adapt needs --scheduler deft")
        params = init_params(cfg, seed=seed, device=device)
        if mesh.size("model") > 1:
            params = tree_map(torch.clone, shard_params(
                params, model_specs(params, mesh), mesh))
        state = init_ddp_state(cfg, opt, params=params)
        del params
        step_fn = make_ddp_step(cfg, opt, loss_chunk=loss_chunk,
                                attn_impl=attn_impl, scan_impl=scan_impl,
                                mesh=mesh)
        if resume and ckpt:
            last = latest_step(ckpt)
            if last is not None:
                state = restore(ckpt, last, state, device=device)
                start_step = last
                log(f"resumed checkpoint step {last}")
    elif scheduler == "deft":
        params_abs = init_params(cfg, device="meta")
        bucket_of, nb, times, plan = build_schedule(
            params_abs, cfg, dp=n_dp, seq_len=seq, per_device_batch=per,
            partition_elems=partition_elems, coverage_rate=coverage_rate,
            wire_precision=wire_precision, master_dtype=master_dtype)
        schedule, ag_plan = plan.schedule, None
        if reroute is not None:
            schedule, ag_plan = reroute(schedule, times)
        log(f"deft: {nb} buckets, CR={times.coverage_rate:.2f}, "
            f"period={schedule.period}, "
            f"updates/period={schedule.updates_per_period}, "
            f"batch-size seq={schedule.batch_size_sequence}, "
            f"preserver ratio={plan.verdict.ratio:.4f}")
        if plan.precision is not None:
            log(f"precision: wire={plan.precision.describe()} "
                f"master={plan.precision.master}")
        # the planner's buckets over the global tree, laid out over this
        # rank's shards of it (the same schedule on every model rank)
        local_abs = params_abs if mesh.size("model") == 1 else shard_params(
            params_abs, model_specs(params_abs, mesh), mesh)
        layout = build_bucket_layout(
            local_abs, bucket_of, nb,
            shard_count=mesh.size("data") if fsdp else 1)
        if plan.precision is not None:
            layout = layout.with_precision(plan.precision)
        cdt = COMPUTE_DTYPES[compute_dtype]
        runtime = DeftRuntime(
            cfg, opt, schedule, layout, device=device, loss_chunk=loss_chunk,
            attn_impl=attn_impl, scan_impl=scan_impl, update_impl=update_impl,
            quantize_impl=quantize_impl, compute_dtype=cdt,
            master_dtype=master_dtype, fsdp=fsdp, decoupled=decoupled,
            mesh=mesh,
            secondary_chain=secondary_chain, ag_plan=ag_plan, tracer=tracer)
        state = None
        if resume and ckpt:
            state, start_step = restore_runtime_state(runtime, ckpt,
                                                      params_abs, log=log)
        if state is None:
            state = runtime.init_state(seed, dtype=cdt or torch.float32)
        out.update(schedule=schedule, layout=layout, times=times)
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}")

    # the online adaptive control plane
    controller = telemetry = None
    run_base = None          # scale-1 run times after a repartition
    if adapt:
        repartitioner = None
        if adapt_repartition:
            model = build_leaf_time_model(params_abs, cfg,
                                          HardwareModel(dp_degree=n_dp),
                                          seq, per)
            if coverage_rate > 0:
                model = model.with_coverage_rate(bucket_of, nb, coverage_rate)
            repartitioner = Repartitioner(model, RepartitionConfig(
                base_partition_elems=partition_elems))
        controller = AdaptiveController(
            times, schedule, plan.scheduler_cfg,
            cfg=adapt_config or AdaptConfig(
                eta=1e-3, warmup_steps=4, check_every=4,
                cooldown_steps=2 * schedule.period,
                wire_precision=wire_precision),
            repartitioner=repartitioner,
            bucket_of=bucket_of if repartitioner else None,
            tracer=runtime.tracer, precision=plan.precision)
        if adapt_drop_step > 0:
            telemetry = SyntheticTelemetrySource(
                times, BandwidthDrop(step=adapt_drop_step,
                                     comm_scale=adapt_drop_scale))
            log(f"adapt: synthetic bandwidth drop x{adapt_drop_scale} at "
                f"step {adapt_drop_step}")

    def adapt_step(step: int, loss: float, wall: float):
        """Feed one step to the controller and stage the replan it
        adopts (JAX's launcher loop)."""
        nonlocal run_base
        if telemetry is not None:
            # the priced view: synthetic walls reflect the installed wire
            # precision, or every replan after a downgrade reads as drift
            wall = telemetry.wall_time(
                step, controller.schedule, controller.scheduler_cfg,
                runtime.last_phase, solve_times=controller.wire_times(),
                run_base=run_base)
            cold = None
        else:
            if world > 1:                       # every rank replans alike
                w = torch.tensor([wall], dtype=torch.float64, device=device)
                dist.all_reduce(w, op=dist.ReduceOp.MAX)
                wall = float(w.item())
            cold = runtime.last_dispatch_first
        event = controller.observe(step, runtime.last_phase, wall,
                                   loss=loss, cold=cold)
        if event is None:
            return
        log(format_event(event))
        if not event.changed:
            return
        policy = controller.precision
        if policy is not None and policy.master != runtime.master_dtype:
            # the controller prices wires only: its policies come back
            # with an f32 master, and the resident master is the runtime's
            policy = dataclasses.replace(policy, master=runtime.master_dtype)
        new_layout = None
        if controller.repartitioner is not None:
            # always the layout the controller's installed view assumes: a
            # schedule solved for partition B never runs under layout A
            new_layout = build_bucket_layout(
                params_abs, controller.bucket_of, controller.times.n,
                shard_count=mesh.size("data") if fsdp else 1,
            ).with_precision(policy)
        elif event.precision_changed:
            new_layout = runtime.layout.with_precision(policy)
        if event.partition_changed:
            run_base = controller.repartitioner.base_times_for(
                event.partition)
        runtime.prepare_swap(event.schedule,
                             background=world == 1, layout=new_layout)

    # the fault-tolerant elastic control plane
    coord = scenario = None

    def say(msg: str) -> None:
        """An elastic run's log comes from its lowest member rank."""
        if coord is None or coord.position == min(coord.members):
            log(msg)

    if elastic:
        def model_for(width: int):
            m = build_leaf_time_model(params_abs, cfg,
                                      HardwareModel(dp_degree=width), seq,
                                      max(batch // width, 1))
            if coverage_rate > 0:
                m = m.with_coverage_rate(bucket_of, nb, coverage_rate)
            return m

        walk = WalkParams(s0=4.0, eta=0.01, mu=1.0, sigma=40.0, batch=256)
        coord = ElasticCoordinator(
            runtime,
            ElasticController(model_for, bucket_of, nb, walk=walk,
                              scheduler_cfg=plan.scheduler_cfg),
            HealthMonitor(world), params_abs=params_abs,
            checkpoint_dir=ckpt, global_batch=batch)
        faults = []
        if elastic_drop_step > 0:
            shards = tuple(int(x) for x in elastic_drop_shards) or (world - 1,)
            faults.append(DeviceDrop(elastic_drop_step, shards))
            if elastic_return_step > 0:
                faults.append(CapacityReturn(elastic_return_step, shards))
        if elastic_straggler_step > 0:
            faults.append(StragglerSlowdown(elastic_straggler_step,
                                            elastic_straggler_shard,
                                            elastic_straggler_factor))
        if faults:
            scenario = FaultScenario(n_shards=world, events=tuple(faults))
            say("elastic: injected faults: " + "; ".join(
                f"{type(e).__name__}@{e.step}" for e in faults))

    clock = 0.0                         # the health monitor's clock

    def elastic_observe(step: int, wall: float) -> None:
        """Feed one step's wall, agreed over the world, to the monitor
        through the injected faults (JAX's launcher loop)."""
        nonlocal clock
        if world > 1:
            w = torch.tensor([wall], dtype=torch.float64, device=device)
            dist.all_reduce(w, op=dist.ReduceOp.MAX)
            wall = float(w.item())
        if scenario is not None:
            obs = scenario.observe(step, wall)
            if obs.notices:
                for ev in coord.notice_preemption(step, obs.notices):
                    say(format_event(ev))
            if obs.returned:
                coord.notice_capacity(step, obs.returned)
                say(f"elastic: capacity returned: shards {obs.returned}")
            walls = obs.walls
        else:
            walls = (wall,) * coord.n_origin
        live = [walls[o] for o in coord.members if walls[o] is not None]
        clock += max(live, default=wall)
        for ev in coord.observe(step, walls, now=clock):
            say(format_event(ev))

    # a preemption signal (what cluster managers send before reclaiming
    # the host) checkpoints and stops the run cleanly
    preempted: Dict[str, Any] = {"sig": None}
    previous = {}
    if (ckpt or elastic) \
            and threading.current_thread() is threading.main_thread():
        def on_preempt(signum, frame):
            preempted["sig"] = signum

        for sig in PREEMPTION_SIGNALS:
            previous[sig] = signal.signal(sig, on_preempt)
    last_step = start_step + steps - 1
    halted = False
    try:
        for step in range(start_step, start_step + steps):
            if (ckpt or elastic) and _preempted(preempted, device):
                say(f"preemption signal {preempted['sig']}: checkpointing "
                    f"and exiting cleanly")
                if ckpt:
                    path = (coord.emergency_checkpoint(step, state)
                            if coord is not None else
                            save_checkpoint(ckpt, step, runtime, state))
                    say(f"checkpoint -> {path}")
                halted = True
                last_step = step - 1
                break
            pos, n_pos = mesh.dp_index, n_dp
            if coord is not None:
                try:
                    state = coord.maybe_migrate(step, state)
                except ElasticHalt as e:
                    # the degradation ladder bottomed out; the emergency
                    # checkpoint (with ckpt) is on disk — stop cleanly
                    say(f"elastic: {e}")
                    halted = True
                    last_step = step - 1
                    break
                runtime = coord.runtime         # migrations swap it
                pos = None if coord.parked else \
                    coord.members.index(coord.position)
                n_pos = len(coord.members)
            m = None
            if pos is not None:
                # batches are keyed by the global step: a resumed run goes
                # on with the stream where it left off; the global batch
                # splits over the current members
                per_now = batch // n_pos
                full = make_batch(cfg, seed, step, batch, seq, device=device)
                local = {k: v[pos * per_now:(pos + 1) * per_now]
                         for k, v in full.items()}
            _sync(device)
            t0 = time.perf_counter()
            if pos is not None and runtime is None:
                state, m = step_fn(state, local)
            elif pos is not None:
                state, m = runtime.step(step, state, local)
                out["collectives"].append(runtime.last_collectives)
            if m is not None:
                loss = float(m["loss"])      # waits for the step
                _sync(device)
                out["step_s"].append(time.perf_counter() - t0)
                out["losses"].append(loss)
                if tracer is not None:
                    tracer.add("step", f"step{step}", t0, tracer.now(),
                               step=step)
            if coord is not None:
                elastic_observe(step, out["step_s"][-1] if m is not None
                                else 0.0)
            if controller is not None:
                adapt_step(step, loss, out["step_s"][-1])
            if on_step is not None and m is not None:
                on_step(step, runtime, state, m)
            if ckpt and ckpt_every > 0 \
                    and (step + 1 - start_step) % ckpt_every == 0:
                save_checkpoint(ckpt, step + 1, runtime, state)
            if m is not None and ((step - start_step) % max(steps // 10, 1)
                                  == 0 or step == last_step):
                aux = (f"aux={float(m['aux']):.5f} " if has_moe else "")
                say(f"step {step:4d} loss={loss:.4f} {aux}"
                    f"updated={bool(m['updated'])} "
                    f"({out['step_s'][-1]:.3f}s)")
        if ckpt and not halted:
            path = save_checkpoint(ckpt, last_step + 1, runtime, state)
            if path is not None:
                log(f"checkpoint -> {path}")
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    if controller is not None:
        st = runtime.stats()
        log(f"adapt: {st['replans']} replans, {st['hot_swaps']} hot-swaps "
            f"({st['layout_swaps']} layout-changing), {st['cached_phases']} "
            f"cached phases, {st['steps_per_s']:.2f} steps/s (dispatch)")
        for sw in st["swap_log"]:
            log("  " + format_event(sw))
        for ev in controller.events:
            log("  " + format_event(ev))
    if coord is not None:
        st = coord.stats()
        say(f"elastic: members={st['members']} spares={st['spares']} "
            f"{len(st['migrations'])} migrations, "
            f"{len(st['fault_events'])} fault events")
        for mig in st["migrations"]:
            say("  " + format_event(mig))
    if tracer is not None and rank == 0:
        tracer.export_chrome_trace(trace)
        ts = tracer.stats()
        dropped = (f", {ts['dropped']} dropped (ring full)"
                   if ts["dropped"] else "")
        log(f"trace -> {trace} ({ts['retained']} spans{dropped})")
    out.update(runtime=runtime, state=state, start_step=start_step,
               halted=halted, controller=controller, elastic=coord)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--scheduler", choices=["ddp", "deft"], default="deft")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--coverage-rate", type=float, default=1.8,
                    help="synthetic CR for the DeFT schedule (0 = analytic)")
    ap.add_argument("--partition-elems", type=int, default=200_000)
    ap.add_argument("--loss-chunk", type=int, default=0,
                    help="sequence chunk of the LM-head loss (0 = whole "
                         "sequence); long sequences at a large vocab need it")
    ap.add_argument("--compute-dtype", choices=["f32", "bf16"], default="f32",
                    help="forward/backward precision of the flat engine (the "
                         "master copy stays as --master-dtype says)")
    ap.add_argument("--wire-precision", choices=["auto", "f32", "bf16", "int8"],
                    default="f32",
                    help="gradient wire precision (DESIGN.md §13): 'auto' "
                         "lets the planner pick a per-bucket policy under the "
                         "precision-aware Preserver; a dtype forces that "
                         "uniform wire")
    ap.add_argument("--master-dtype", choices=["f32", "bf16sr"], default="f32",
                    help="resident master-param dtype: 'bf16sr' keeps params "
                         "at bf16 with seeded stochastic-rounded updates "
                         "(moments stay f32)")
    ap.add_argument("--fsdp", action="store_true", default=None,
                    help="drive the SHARDED flat engine: params and optimizer "
                         "moments resident 1/N over the ranks (default: the "
                         "arch's policy)")
    ap.add_argument("--decoupled", action="store_true",
                    help="stream per-bucket param all-gathers into the "
                         "forward instead of the phase-start burst "
                         "(DESIGN.md §12; needs --fsdp)")
    ap.add_argument("--pod", type=int, default=1,
                    help="outer 'pod' axis of a pod x data layout of the "
                         "ranks: syncs reduce-scatter over 'data', "
                         "all-reduce over 'pod', all-gather over 'data'")
    ap.add_argument("--production-mesh", action="store_true",
                    help="JAX's production mesh mapped onto the nodes: "
                         "(ranks / g, g), g the GPUs of a node")
    ap.add_argument("--data", type=int, default=0,
                    help="mesh 'data' axis (0: the ranks --pod and --model "
                         "leave)")
    ap.add_argument("--model", type=int, default=1,
                    help="mesh 'model' axis: the model runs "
                         "tensor-parallel over it (either flat engine in "
                         "f32, or --scheduler ddp)")
    ap.add_argument("--ckpt", default="", help="checkpoint dir (optional)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="auto-checkpoint cadence in steps (0 = only at "
                         "the end)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint from --ckpt "
                         "before training (a checkpoint written under a "
                         "different bucket layout is re-packed through "
                         "the LayoutTransition)")
    ap.add_argument("--adapt", action="store_true",
                    help="online control plane: telemetry -> drift "
                         "detection -> replan -> phase hot-swap")
    ap.add_argument("--adapt-drop-step", type=int, default=0,
                    help="with --adapt: inject a synthetic bandwidth drop "
                         "at this step (0 = use real measured wall times)")
    ap.add_argument("--adapt-drop-scale", type=float, default=3.0,
                    help="comm slowdown factor of the injected drop")
    ap.add_argument("--adapt-repartition", action="store_true",
                    help="with --adapt: replans may change the bucket "
                         "partition itself — the runtime re-packs the "
                         "flat state at a cycle boundary, no restart")
    ap.add_argument("--elastic", action="store_true",
                    help="fault-tolerant control plane: per-shard health "
                         "monitoring -> Preserver-gated scale-down/up of the "
                         "ranks via a cycle-boundary repack, zero restart")
    ap.add_argument("--elastic-drop-step", type=int, default=0,
                    help="with --elastic: inject a device-drop fault at "
                         "this step (0 = none)")
    ap.add_argument("--elastic-drop-shards", default="",
                    help="comma-separated origin shard ids (ranks) the "
                         "injected drop kills (default: the last rank)")
    ap.add_argument("--elastic-return-step", type=int, default=0,
                    help="with --elastic: the dropped shards come back at "
                         "this step (scale-up trigger; 0 = never)")
    ap.add_argument("--elastic-straggler-step", type=int, default=0,
                    help="with --elastic: one shard starts running slow "
                         "at this step (0 = none)")
    ap.add_argument("--elastic-straggler-shard", type=int, default=0)
    ap.add_argument("--elastic-straggler-factor", type=float, default=3.0)
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="record step/phase/collective/control-plane "
                         "spans and export a Chrome-trace (Perfetto-"
                         "loadable) JSON to this path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.elastic and args.adapt:
        ap.error("--elastic and --adapt are mutually exclusive: the "
                 "elastic controller owns replanning while it owns the "
                 "ranks (DESIGN.md §10)")
    if args.elastic and args.scheduler != "deft":
        ap.error("--elastic needs --scheduler deft (the migration path "
                 "repacks the flat DeFT state)")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    print(f"arch={cfg.name} params={cfg.total_params():,} device={args.device}")
    t0 = time.time()
    res = train(cfg, scheduler=args.scheduler, steps=args.steps,
                batch=args.batch, seq=args.seq,
                coverage_rate=args.coverage_rate,
                partition_elems=args.partition_elems, seed=args.seed,
                device=args.device, loss_chunk=args.loss_chunk,
                wire_precision=args.wire_precision,
                master_dtype=args.master_dtype,
                compute_dtype=args.compute_dtype, fsdp=args.fsdp,
                decoupled=args.decoupled, pod=args.pod,
                data=args.data or None, model=args.model,
                production_mesh=args.production_mesh, ckpt=args.ckpt,
                ckpt_every=args.ckpt_every, resume=args.resume,
                adapt=args.adapt, adapt_drop_step=args.adapt_drop_step,
                adapt_drop_scale=args.adapt_drop_scale,
                adapt_repartition=args.adapt_repartition, trace=args.trace,
                elastic=args.elastic,
                elastic_drop_step=args.elastic_drop_step,
                elastic_drop_shards=tuple(
                    int(x) for x in args.elastic_drop_shards.split(",") if x),
                elastic_return_step=args.elastic_return_step,
                elastic_straggler_step=args.elastic_straggler_step,
                elastic_straggler_shard=args.elastic_straggler_shard,
                elastic_straggler_factor=args.elastic_straggler_factor)
    dt = time.time() - t0
    n = len(res["losses"])
    print(f"{n} steps in {dt:.1f}s "
          f"({n * args.batch * args.seq / dt:.0f} tok/s)")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
