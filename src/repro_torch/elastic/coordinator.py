"""Elastic execution: drive a DeftRuntime across changes of its ranks
(DESIGN.md §10).

Port of ``repro/elastic/coordinator.py``.  The :class:`ElasticCoordinator`
wraps a :class:`~repro_torch.train.runtime.DeftRuntime` and owns the
fault-to-recovery pipeline:

    observe (per-shard walls) -> HealthMonitor -> FaultEvent
        -> ElasticController.propose (Preserver-gated plan)
        -> armed until the next cycle boundary
        -> migrate: a process group of the survivors -> fold the
           accumulator rows -> move the param and moment spans ->
           ``reset_cycle`` -> the new runtime dispatches — ZERO restart.

Shard identity: observations are indexed by **origin shard id**, the
position of a rank in the 'data' group the coordinator was constructed
with, which must be the world (one rank per shard).  After a 4->2
scale-down the surviving origin shards keep their ids, so a
:class:`~repro_torch.elastic.faults.FaultScenario` scripted against the
original world replays unchanged across migrations; the coordinator
translates to current positions internally.

Accumulator folding: ``cur``/``fut`` rows carry per-rank gradient sums
whose consumer divides by ``n_dp * k`` after a sum over the ranks.  A
change of ranks preserves the GLOBAL batch (the per-rank batch resizes),
so rows fold by position as

    scale-down (n -> n'):  row'_j = (n'/n) * sum_{i : i mod n' == j} row_i
    scale-up   (n -> n'):  row'_j = (n'/n) * row_j   (j < n, else 0)

which keeps ``sum(rows') / n'`` identical to ``sum(rows) / n``.  Each rank
holds its own row, so the rows move point to point: old position ``i``'s
to new position ``i mod n'``, summed in ascending ``i`` and scaled there
(:func:`fold_accum_rows` is the same function on a stacked tensor).

How ranks stand in for JAX's mesh: JAX runs one process over a mesh, and
its in-process harness keeps the "dead" devices answering reads.  The
port runs one process per rank, and every rank stays a process of the
world.  A rank planned out of the group is **parked**: it holds no runtime
and no state and skips ``step``, but it keeps its place in every call
made over the world (the launcher's per-step wall agreement, each
``dist.new_group``, each migration, where a departing rank still hands
over its spans and rows).  A capacity return brings a parked rank back:
it receives the state from the members (the replicated parts by point to
point from the first member) and spawns a runtime over the new group.

What a real deployment adds: this harness migrates live buffers — the
departing ranks still answer.  On real hardware a dead rank's spans are
gone; production pairs this control flow with the emergency-checkpoint
path (or redundant sharding) to re-source lost spans, and re-forms the
process group without the dead ranks.  The control-plane logic —
detection, pricing, gating, cycle-boundary repack — is exactly what this
module tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import (
    save as save_ckpt,
    save_layout_descriptor,
    schedule_digest,
)
from repro_torch.elastic.controller import ElasticController, ElasticPlan
from repro_torch.elastic.health import FaultEvent, HealthMonitor
from repro_torch.launch.mesh import elastic_group
from repro_torch.obs.trace import Tracer
from repro_torch.train.bucketing import (
    build_bucket_layout,
    build_layout_transition,
)
from repro_torch.train.runtime import Placement


class ElasticHalt(RuntimeError):
    """Raised by :meth:`ElasticCoordinator.step` when the degradation
    ladder bottoms out (no survivors / preempted out): the emergency
    checkpoint is on disk and the driver should exit cleanly; a later
    ``--resume`` continues from it."""

    def __init__(self, step: int, checkpoint_path: str, reason: str = ""):
        self.step = step
        self.checkpoint_path = checkpoint_path
        self.reason = reason
        super().__init__(
            f"elastic halt at step {step}"
            + (f": {reason}" if reason else "")
            + (f" (checkpoint: {checkpoint_path})"
               if checkpoint_path else " (no checkpoint dir configured)")
        )


def fold_accum_rows(rows: torch.Tensor, n_new: int) -> torch.Tensor:
    """Fold a ``(n_old, size)`` accumulator stack to ``n_new`` rows,
    preserving ``sum(rows)/n`` (the global-mean gradient the delayed
    update consumes) under a constant global batch: a scale-down sums the
    rows of each new position in ascending old position from zero, a
    scale-up appends zero rows, then both scale by ``n_new / n_old``."""
    n_old = int(rows.shape[0])
    if n_new == n_old:
        return rows
    scale = n_new / n_old
    if n_new < n_old:
        out = torch.zeros((n_new,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                          device=rows.device)
        for i in range(n_old):
            out[i % n_new] += rows[i]
    else:
        pad = torch.zeros((n_new - n_old,) + tuple(rows.shape[1:]),
                          dtype=rows.dtype, device=rows.device)
        out = torch.cat([rows, pad], dim=0)
    return out * scale


def _fold_placed(rows: Optional[Sequence[torch.Tensor]], src: Placement,
                 dst: Placement, device) -> Optional[List[torch.Tensor]]:
    """:func:`fold_accum_rows` over the ranks: this rank's folded row of
    each ``src.layout`` bucket (None outside ``dst``) from its own row
    (None outside ``src``).  Old position ``i``'s row goes point to point
    to new position ``i mod n'`` (``i`` on a scale-up or at an unchanged
    count, where only the ranks at the positions may differ)."""
    me = dist.get_rank()
    n, n2 = len(src.ranks), len(dst.ranks)
    down = n2 < n

    def sources(j):
        return ([i for i in range(n) if i % n2 == j] if down
                else [j] if j < n else [])

    j = dst.ranks.index(me) if me in dst.ranks else None
    out = [] if j is not None else None
    for sb, size in enumerate(src.layout.buf_sizes):
        ops, got = [], {}
        if me in src.ranks:
            i = src.ranks.index(me)
            to = dst.ranks[i % n2 if down else i]
            if to != me:
                ops.append(dist.P2POp(dist.isend, rows[sb], to))
        if j is not None:
            for i in sources(j):
                if src.ranks[i] != me:
                    got[i] = torch.empty((size,), dtype=torch.float32,
                                         device=device)
                    ops.append(dist.P2POp(dist.irecv, got[i], src.ranks[i]))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        if j is None:
            continue
        row = lambda i: got[i] if i in got else rows[sb]
        if n2 == n:
            out.append(row(j))
        elif down:
            acc = torch.zeros((size,), dtype=torch.float32, device=device)
            for i in sources(j):
                acc += row(i)
            out.append(acc * (n2 / n))
        else:
            out.append(row(j) * (n2 / n) if j < n else
                       torch.zeros((size,), dtype=torch.float32,
                                   device=device))
    return out


def migrate_state(old_rt, new_rt, state, *, old: Optional[Placement] = None,
                  new: Optional[Placement] = None) -> Any:
    """Move a flat train state from ``old_rt``'s ranks and layout onto
    ``new_rt``'s: fold the accumulator rows, move the param and moment
    spans across the shard counts, hand a returning rank the state, and
    finish it under the new layout.  Consumes ``state``.

    Collective over the ranks of both sides.  A rank outside the old side
    passes ``old_rt=None`` and ``state=None``, a rank outside the new side
    ``new_rt=None`` (and gets None back); both sides' :class:`Placement`
    must then be given (``old``, ``new``), since that rank lacks the
    runtime they come from.  A rank on neither side moves nothing.

    * ``cur``/``fut``: the rows fold by position (:func:`_fold_placed`;
      nothing when the ranks are unchanged), then re-flatten along the
      element axis under the new layout.
    * params and moments: each source bucket is gathered over the old
      ranks one bucket at a time and each new rank cuts out its span or
      whole bucket (:func:`~repro_torch.train.runtime.repack_placed`), so
      a rank holds at most one component and one whole bucket more than
      its state; a rank new to the state receives the buckets, and the
      optimizer step, from the first old rank.
    * the gather cache is dropped and ``gbuf`` rebuilt (the cycle starts
      at position 0, which always gathers), as ``repack_state`` finishes
      a state (``DeftRuntime._repack``, which does the moves too).

    JAX's ``migrate_state`` folds, ``device_put``s onto the new mesh and
    runs ``repack_state``; here the element-axis repack and the move
    between ranks are one pass, since a layout of one shard count cannot
    be re-split over another."""
    rt = new_rt or old_rt
    if rt is None:
        return None
    old = old or old_rt.placement()
    new = new or new_rt.placement()
    me = dist.get_rank()
    state = state if state is not None else {"opt": {}}
    tr = build_layout_transition(old.layout, new.layout)
    if old.ranks != new.ranks:
        for key in ("cur", "fut"):
            state[key] = _fold_placed(state.pop(key, None), old, new,
                                      rt.device)
    takers = [r for r in new.ranks if r not in old.ranks]
    if me == old.ranks[0] and takers:
        for w in [dist.isend(state["opt"]["step"], dst=r) for r in takers]:
            w.wait()
    elif me in takers:
        state["opt"]["step"] = torch.zeros((), dtype=torch.int32,
                                           device=rt.device)
        dist.recv(state["opt"]["step"], src=old.ranks[0])
    return rt._repack(state, tr, old, new)


class ElasticCoordinator:
    """Fault-tolerant wrapper around a flat-state :class:`DeftRuntime`.

    Every rank of the world builds one over its runtime and drives it
    alike.  The driver loop calls :meth:`step` in place of
    ``runtime.step`` and :meth:`observe` with per-origin-shard walls each
    step (the same on every rank); everything else — detection, planning,
    cycle-boundary migration, the degradation ladder — happens inside.
    ``self.runtime`` is always the currently dispatching runtime, None on
    a parked rank.  ``global_batch`` (0: unchecked) must split over the
    survivor count of every plan that executes; a plan that does not
    halts as the bottom of the ladder does.  ``compile_s`` in the log
    times the new runtime's kernel loads (the port compiles no phases).
    """

    def __init__(
        self,
        runtime,
        controller: ElasticController,
        monitor: HealthMonitor,
        *,
        params_abs,
        checkpoint_dir: str = "",
        tracer: Optional[Tracer] = None,
        global_batch: int = 0,
    ):
        if runtime.dp.outer is not None:
            raise ValueError(
                "elastic execution supports one 'data' group; fold the pod "
                "axis into data before wrapping"
            )
        if getattr(runtime, "secondary_chain", None) is not None:
            raise ValueError(
                "elastic execution re-forms the 'data' group, and a "
                "secondary_chain is a permutation of its positions: wrap a "
                "runtime without one"
            )
        self.runtime = runtime
        self.controller = controller
        self.monitor = monitor
        self.params_abs = params_abs
        self.checkpoint_dir = checkpoint_dir
        self.global_batch = global_batch
        # origin shard id = position in the 'data' group; this rank's own
        self.n_origin = runtime.dp.size
        self.position = runtime.dp.rank
        # what a parked rank still needs: a runtime to spawn from when it
        # returns, the layout and engine in force, the cycle clock
        self._proto = runtime
        self.layout = runtime.layout
        self.sharded = runtime.fsdp
        self._period = runtime.period
        self._cycle_base = 0
        # membership -> its process group, built once (every rank builds
        # the same ones in the same order); the origin's is the runtime's
        self._groups: Dict[Tuple[int, ...], Any] = {
            tuple(range(self.n_origin)): runtime.dp.group}
        # origin ids currently IN the group, in order, and the spare pool
        # capacity returns draw from.  An armed (not yet executed) plan's
        # membership is always `(members | returning) - spares`: faulted
        # members sit in BOTH `members` and `spares` until the plan
        # executes; capacity returnees sit in `returning` until they land
        # in `members`.  Every mutation re-arms the plan from that one
        # invariant, so cascading faults, straggler recoveries and
        # capacity returns compose instead of clobbering each other.
        self.members: List[int] = list(range(self.n_origin))
        self.spares: List[int] = []
        self._returning: List[int] = []
        # origin id -> the fault kind that planned it out (cleared when
        # the shard is restored or drawn back from the spare pool)
        self._out_reason: Dict[int, str] = {}
        self._pending: Optional[ElasticPlan] = None
        self._pending_members: List[int] = []
        self._halt: Optional[ElasticPlan] = None
        self.log: List[Dict[str, Any]] = []
        self.fault_events: List[FaultEvent] = []
        # detection -> arm -> migrate lifecycle mirrors into one trace
        # (DESIGN.md §11): default to the runtime's tracer so elastic
        # events land next to the step/phase spans they interrupt.
        # Compare against None, never truthiness — an empty Tracer has
        # __len__ == 0 and would be silently replaced by a private one
        if tracer is None:
            tracer = getattr(runtime, "tracer", None)
        self.tracer = tracer if tracer is not None else Tracer(capacity=1024)
        if self.monitor.tracer is None:
            self.monitor.tracer = self.tracer
        if monitor.n_shards != len(self.members):
            monitor.reset(len(self.members))

    @property
    def parked(self) -> bool:
        """This rank is planned out of the group: no runtime, no step."""
        return self.position not in self.members

    # ---- observations ---------------------------------------------------
    def observe(
        self,
        step: int,
        walls: Sequence[Optional[float]],
        collectives: Optional[Sequence[Optional[float]]] = None,
        now: Optional[float] = None,
    ) -> List[FaultEvent]:
        """Feed one step's per-ORIGIN-shard observations (length
        ``n_origin``; entries for shards not currently in the group are
        ignored).  Returns the fault events raised, after any replanning
        they triggered."""
        if len(walls) != self.n_origin:
            raise ValueError(
                f"expected {self.n_origin} origin-shard observations, "
                f"got {len(walls)}"
            )
        cur_walls = [walls[o] for o in self.members]
        cur_colls = (
            [collectives[o] for o in self.members]
            if collectives is not None else None
        )
        events = self.monitor.observe(step, cur_walls, cur_colls, now=now)
        self._handle(step, events)
        return events

    def notice_preemption(
        self, step: int, shards: Sequence[int]
    ) -> List[FaultEvent]:
        """Explicit preemption notice for origin ``shards`` — no timeout
        wait; the scale-down (or halt) is planned immediately."""
        events = []
        for o in shards:
            if o not in self.members:
                continue
            ev = self.monitor.notice_preemption(
                step, self.members.index(o)
            )
            if ev is not None:
                events.append(ev)
        self._handle(step, events)
        return events

    def notice_capacity(self, step: int, shards: Sequence[int]) -> None:
        """Origin ``shards`` became available again.  A shard whose
        removal is still armed (in ``spares`` AND ``members``) is simply
        restored — its removal cancels; a shard already migrated out
        joins ``returning`` and the symmetric scale-up arms.  Either way
        the plan is re-armed from the membership invariant, MERGING with
        (never clobbering) any armed fault plan."""
        fresh = [o for o in shards if o in self.spares]
        if not fresh:
            return
        trigger = "scale-up"
        for o in fresh:
            self.spares.remove(o)
            self._out_reason.pop(o, None)
            if o not in self.members:
                self._returning.append(o)
        if not any(o in self._returning for o in fresh):
            # pure cancellation of armed removals: if removals for OTHER
            # shards remain armed, keep their fault trigger on the plan
            trigger = self._remaining_trigger() or trigger
        self._rearm(step, trigger)

    # ---- fault handling -------------------------------------------------
    def _handle(self, step: int, events: List[FaultEvent]) -> None:
        self.fault_events.extend(events)
        lost: List[Tuple[int, str]] = []
        restored = False
        for ev in events:
            if ev.kind in ("dead", "preemption", "straggler"):
                o = self.members[ev.shard]
                # a shard already planned out (armed earlier this cycle
                # window) must not be re-lost: it is in `spares`, and
                # counting it again would double-book the removal
                if o not in self.spares and all(o != p for p, _ in lost):
                    lost.append((o, ev.kind))
            # 'bandwidth' is informational here: uniform drift is the
            # adaptive replanner's job
            elif ev.kind == "recovered":
                o = self.members[ev.shard]
                # a straggler that recovers before its armed removal
                # executes is restored: out of the spare pool, removal
                # cancelled (dead/preempted shards never emit 'recovered')
                if o in self.spares and self._out_reason.get(o) == "straggler":
                    self.spares.remove(o)
                    self._out_reason.pop(o, None)
                    restored = True
        if not lost and not restored:
            return
        # shards planned out of the group move to the spare pool the
        # moment the plan arms — capacity returns can bring them back
        for o, kind in lost:
            self.spares.append(o)
            self._out_reason[o] = kind
        trigger = lost[-1][1] if lost else (self._remaining_trigger()
                                            or "scale-up")
        self._rearm(step, trigger)

    def _remaining_trigger(self) -> Optional[str]:
        """Fault kind of the latest still-armed removal, if any."""
        out = [o for o in self.members if o in self.spares]
        return self._out_reason.get(out[-1]) if out else None

    def _rearm(self, step: int, trigger: str) -> None:
        """Recompute the armed plan from the membership invariant
        ``(members | returning) - spares``; a target identical to the
        current membership disarms (nothing left to migrate)."""
        target = sorted(
            (set(self.members) | set(self._returning)) - set(self.spares)
        )
        if target == sorted(self.members):
            if self._pending is not None:
                self.tracer.instant(
                    "elastic", "disarm", step=step, trigger=trigger,
                )
            self._pending = None
            self._pending_members = []
            return
        plan = self.controller.propose(step, len(target), trigger)
        if plan.action == "checkpoint-halt":
            self._halt = plan
            self._pending = None
            self._pending_members = []
            self.tracer.instant(
                "elastic", "arm-checkpoint-halt", step=step,
                trigger=trigger, detected_step=plan.step,
            )
            return
        self._pending = plan
        self._pending_members = target
        self.tracer.instant(
            "elastic", f"arm-{plan.action}", step=step, trigger=trigger,
            detected_step=plan.step, new_shards=plan.n_shards,
            new_period=plan.schedule.period if plan.schedule else None,
        )

    # ---- migration ------------------------------------------------------
    def phase_in_cycle(self, i: int) -> int:
        """The cycle position of step ``i`` (a parked rank keeps the
        members' cycle clock)."""
        if self.runtime is not None:
            return self.runtime.phase_in_cycle(i)
        return (i - self._cycle_base) % self._period

    def maybe_migrate(self, i: int, state):
        """Execute an armed plan if ``i`` is a cycle boundary (or halt
        immediately).  Returns the (possibly migrated) state, None on a
        parked rank; afterwards ``self.runtime`` dispatches it."""
        if self._halt is not None:
            self._do_halt(i, state)
        if self._pending is None:
            return state
        if self.phase_in_cycle(i) != 0:
            return state
        plan, self._pending = self._pending, None
        # checked here, before anything moves, and not when the plan arms:
        # an armed plan a later event re-arms never runs (two preemptions
        # in one window pass through a 3-of-4 plan on their way to 2)
        if self.global_batch and self.global_batch % plan.n_shards:
            self._halt, self._pending_members = plan, []
            self._do_halt(i, state, reason=(
                f"{plan.n_shards} surviving shards do not split the global "
                f"batch {self.global_batch}"))
        return self._execute(i, state, plan)

    def step(self, i: int, state, batch):
        """Drop-in for ``DeftRuntime.step`` with elastic handling: a
        parked rank runs no step and gets ``(None, None)``."""
        state = self.maybe_migrate(i, state)
        if self.runtime is None:
            return state, None
        return self.runtime.step(i, state, batch)

    def _do_halt(self, i: int, state, reason: str = "") -> None:
        """Write the emergency checkpoint (with ``checkpoint_dir``) and
        raise :class:`ElasticHalt`; ``reason`` (a plan that cannot run)
        goes into the log entry, the instant and the message."""
        plan, self._halt = self._halt, None
        path = ""
        if self.checkpoint_dir:
            path = self.emergency_checkpoint(i, state)
        why = {"reason": reason} if reason else {}
        self.log.append({
            "step": i, "action": "checkpoint-halt",
            "detected_step": plan.step, "trigger": plan.trigger,
            "checkpoint": path, **why,
        })
        self.tracer.instant(
            "elastic", "checkpoint-halt", step=i, trigger=plan.trigger,
            detected_step=plan.step, checkpoint=path, **why,
        )
        raise ElasticHalt(i, path, reason)

    def emergency_checkpoint(self, step: int, state) -> str:
        """Checkpoint NOW (tree form + layout/schedule sidecar), atomic
        — the clean-resume half of the unsurvivable-fault path.  Every
        rank of the world calls it: the members gather the tree to the
        lowest member, which writes and then hands every rank the npz
        path it wrote, so none goes on before the sidecar is committed.
        Returns that path."""
        rt = self.runtime
        tree = rt.state_to_tree(state) if rt is not None else None
        path = None
        if tree is not None:
            path = save_ckpt(self.checkpoint_dir, step, tree)
            save_layout_descriptor(
                self.checkpoint_dir, step, rt.layout,
                next_phase=rt.phase_in_cycle(step),
                digest=schedule_digest(rt.schedule),
                divisors=rt.pending_divisors,
            )
        del tree
        if dist.get_world_size() > 1:
            box = [path]
            dist.broadcast_object_list(box, src=self._ranks(self.members)[0])
            path = box[0]
        return path

    def _group(self, members: Sequence[int]):
        """The process group of ``members`` (origin ids), built the first
        time that membership comes up — on every rank, in the same order,
        as ``dist.new_group`` requires."""
        key = tuple(members)
        if key not in self._groups:
            if self.n_origin != dist.get_world_size():
                raise ValueError(
                    f"elastic migration needs one rank per origin shard: "
                    f"{self.n_origin} shards, {dist.get_world_size()} ranks "
                    f"in the world")
            self._groups[key] = elastic_group(self._ranks(key))
        return self._groups[key]

    def _ranks(self, members: Sequence[int]) -> Tuple[int, ...]:
        g = self._groups[tuple(range(self.n_origin))]
        return tuple(o if g is None else dist.get_global_rank(g, o)
                     for o in members)

    def _execute(self, i: int, state, plan: ElasticPlan):
        t_mig = time.perf_counter()
        tr0 = self.tracer.now()
        old_rt = self.runtime
        members = sorted(self._pending_members)
        assert len(members) == plan.n_shards, (members, plan)
        assert len(set(members)) == len(members), members
        # a plan must never re-seat a shard still in the spare pool — a
        # cascading fault or capacity return that mutated the pool after
        # this plan armed would have re-armed it (see _rearm)
        assert set(members).isdisjoint(self.spares), (members, self.spares)
        old_group = self._group(self.members)
        new_group = self._group(members)
        new_layout = build_bucket_layout(
            self.params_abs, plan.bucket_of, plan.n_buckets,
            shard_count=plan.n_shards if plan.sharded else 1,
        )
        old_pol = getattr(self.layout, "precision", None)
        if old_pol is not None:
            # §13: the wire/master policy migrates with the state.  A
            # changed bucket count invalidates per-bucket wire choices,
            # so those reset to f32 (uniform policies survive); the
            # resident master dtype always carries — the migration must
            # not change the memory envelope mid-flight.
            from repro_torch.core.precision import PrecisionPolicy

            if plan.n_buckets == self.layout.n_buckets:
                new_layout = new_layout.with_precision(old_pol)
            else:
                wires = set(old_pol.wire)
                uni = wires.pop() if len(wires) == 1 else "f32"
                new_layout = new_layout.with_precision(
                    PrecisionPolicy.uniform(plan.n_buckets, uni,
                                            old_pol.master)
                )
        new_rt = None
        if self.position in members:
            new_rt = (old_rt or self._proto).spawn(
                group=new_group, schedule=plan.schedule, layout=new_layout,
                fsdp=plan.sharded,
            )
        old = Placement(self._ranks(self.members), old_group, self.layout,
                        self.sharded)
        new = Placement(self._ranks(members), new_group, new_layout,
                        plan.sharded)
        rt = new_rt or old_rt
        sync = (lambda: torch.cuda.synchronize(rt.device)) \
            if rt is not None and rt.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        state = migrate_state(old_rt, new_rt, state, old=old, new=new)
        sync()
        repack_s = time.perf_counter() - t0
        # the port compiles no phases: the new runtime's first step needs
        # only its layout's kernel libraries loaded
        t0 = time.perf_counter()
        if new_rt is not None:
            new_rt._load_kernels(new_layout)
        compile_s = time.perf_counter() - t0
        if new_rt is not None:
            new_rt.reset_cycle(i)
        old_period = old_rt.period if old_rt is not None else self._period
        self._period, self._cycle_base = plan.schedule.period, i
        self.log.append({
            "step": i, "action": plan.action, "trigger": plan.trigger,
            "detected_step": plan.step,
            "old_shards": len(self.members), "new_shards": plan.n_shards,
            "old_period": old_period, "new_period": self._period,
            "sharded": plan.sharded,
            "preserver_ok": bool(plan.verdict and plan.verdict.ok),
            "preserver_ratio": plan.verdict.ratio if plan.verdict else None,
            "n_buckets": (self.layout.n_buckets, new_layout.n_buckets),
            "repack_s": repack_s, "compile_s": compile_s,
            "migrate_s": time.perf_counter() - t_mig,
            "members": tuple(members),
        })
        self.tracer.add(
            "elastic", f"migrate-{plan.action}", tr0, self.tracer.now(),
            step=i, trigger=plan.trigger, detected_step=plan.step,
            old_shards=len(self.members), new_shards=plan.n_shards,
            old_period=old_period, new_period=self._period,
            repack_s=repack_s, compile_s=compile_s,
        )
        self.members = members
        self._returning = [o for o in self._returning if o not in members]
        self._pending_members = []
        self.runtime = new_rt
        self.layout, self.sharded = new_layout, plan.sharded
        self.monitor.reset(len(members))
        self.controller.adopt(plan)
        return state

    # ---- reporting ------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "n_origin": self.n_origin,
            "members": tuple(self.members),
            "spares": tuple(self.spares),
            "returning": tuple(self._returning),
            "migrations": list(self.log),
            "fault_events": [
                dataclasses.asdict(e) for e in self.fault_events
            ],
            "pending": self._pending is not None,
        }
