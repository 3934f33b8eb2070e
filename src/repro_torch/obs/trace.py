"""Ring-buffer span recorder with an injectable clock (DESIGN.md §11).

Every layer of the runtime emits *spans* — ``(kind, name, t0, t1)`` plus
a small attribute dict — into one :class:`Tracer`.  Two properties make
it fit this codebase:

* **injectable monotonic clock**, same pattern as ``elastic/health.py``:
  the tracer never *requires* wall time.  Tests drive a
  :class:`ManualClock` and the resulting trace (and its Chrome-JSON
  export) is bit-for-bit reproducible; production uses
  ``time.perf_counter``.
* **bounded ring**: spans live in a ``deque(maxlen=capacity)``.  The
  recorder is allocation-light and can stay attached for the whole run;
  when the ring wraps, the oldest spans fall off and ``dropped`` counts
  them.  Control-plane events (swaps, replans, faults) are rare, so a
  ring sized for a few thousand step spans retains the full
  control-plane history of any realistic window.

Span kinds are a closed vocabulary (:data:`SPAN_KINDS`) so the
attribution pass and the Chrome export can assign stable tracks.
Export follows the Chrome trace-event format — complete (``"ph": "X"``)
duration events plus instant (``"ph": "i"``) events, timestamps in
microseconds — which Perfetto loads directly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from collections import deque
from typing import Callable, Deque, Dict, Iterable, List, Optional, Sequence, Tuple

#: Closed span-kind vocabulary.  ``step``/``phase`` are the per-step
#: timing backbone; ``collective-group`` mirrors the fused collectives a
#: dispatched phase contains; the rest are control-plane events.
SPAN_KINDS: Tuple[str, ...] = (
    "step",              # one full train-loop step (driver-measured)
    "phase",             # one DeftRuntime.step dispatch (runtime-measured)
    "collective-group",  # the collectives fused into a dispatched phase
    "update-apply",      # optimizer-update positions in the cycle
    "gather-skip",       # phases dispatched with the gather-reuse mask
    "swap-install",      # pending schedule installed at a cycle boundary
    "swap-compile",      # prepare_swap compile work (maybe background)
    "repack",            # cross-layout state movement
    "replan",            # adaptive controller replan solve
    "elastic",           # health detection / arm / migrate lifecycle
    # simulator-derived kinds (attribution closure + explorer export)
    "compute",           # simulated compute op (F/B)
    "collective",        # simulated collective transmission
)

#: Default Chrome-export track per kind (pid 0, one tid per track).
_TRACKS: Tuple[str, ...] = (
    "steps", "phases", "collectives", "control", "elastic",
    "sim-compute", "sim-link0", "sim-link1",
)
_KIND_TRACK: Dict[str, str] = {
    "step": "steps",
    "phase": "phases",
    "collective-group": "collectives",
    "update-apply": "phases",
    "gather-skip": "phases",
    "swap-install": "control",
    "swap-compile": "control",
    "repack": "control",
    "replan": "control",
    "elastic": "elastic",
    "compute": "sim-compute",
    "collective": "sim-link0",
}


@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded interval (``t1 == t0`` for instant events)."""

    kind: str
    name: str
    t0: float
    t1: float
    step: Optional[int] = None
    phase: Optional[int] = None
    track: Optional[str] = None
    attrs: Tuple[Tuple[str, object], ...] = ()

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    @property
    def args(self) -> Dict[str, object]:
        """Attribute dict view (attrs are stored as sorted tuples so
        spans stay hashable and exports stay deterministic)."""
        return dict(self.attrs)


class ManualClock:
    """Deterministic injectable clock: ``advance()`` is the only way
    time passes.  Mirrors the HealthMonitor's replayable-clock model."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def _freeze_attrs(attrs: Dict[str, object]) -> Tuple[Tuple[str, object], ...]:
    return tuple(sorted(attrs.items()))


class Tracer:
    """Bounded span recorder.

    ``clock`` is any zero-arg callable returning monotonic seconds;
    default is ``time.perf_counter``.  All record paths also accept
    explicit ``t0``/``t1`` so callers that already timed something
    (e.g. the runtime's dispatch stopwatch) don't sample twice.
    """

    def __init__(
        self,
        capacity: int = 65536,
        clock: Optional[Callable[[], float]] = None,
    ):
        if capacity <= 0:
            raise ValueError("tracer capacity must be positive")
        self.capacity = capacity
        self.clock = clock if clock is not None else time.perf_counter
        self._spans: Deque[Span] = deque(maxlen=capacity)
        self.dropped = 0
        self.n_recorded = 0

    # ---- recording ------------------------------------------------------
    def now(self) -> float:
        return self.clock()

    def add(
        self,
        kind: str,
        name: str,
        t0: float,
        t1: float,
        *,
        step: Optional[int] = None,
        phase: Optional[int] = None,
        track: Optional[str] = None,
        **attrs: object,
    ) -> Span:
        """Record a completed interval with explicit bounds."""
        if kind not in SPAN_KINDS:
            raise ValueError(f"unknown span kind {kind!r}")
        span = Span(
            kind, name, float(t0), float(t1),
            step=step, phase=phase, track=track,
            attrs=_freeze_attrs(attrs),
        )
        if len(self._spans) == self.capacity:
            self.dropped += 1
        self._spans.append(span)
        self.n_recorded += 1
        return span

    def instant(
        self,
        kind: str,
        name: str,
        *,
        t: Optional[float] = None,
        step: Optional[int] = None,
        phase: Optional[int] = None,
        track: Optional[str] = None,
        **attrs: object,
    ) -> Span:
        """Record a zero-duration event (``"ph": "i"`` in the export)."""
        at = self.now() if t is None else float(t)
        return self.add(
            kind, name, at, at, step=step, phase=phase, track=track, **attrs
        )

    @contextlib.contextmanager
    def span(
        self,
        kind: str,
        name: str,
        *,
        step: Optional[int] = None,
        phase: Optional[int] = None,
        track: Optional[str] = None,
        **attrs: object,
    ):
        """Context manager that measures the enclosed block with the
        tracer's clock.  The span is recorded even if the block raises."""
        t0 = self.now()
        try:
            yield
        finally:
            self.add(
                kind, name, t0, self.now(),
                step=step, phase=phase, track=track, **attrs,
            )

    # ---- queries --------------------------------------------------------
    def spans(
        self, kind: Optional[object] = None
    ) -> List[Span]:
        """Spans in record order; ``kind`` filters by one kind (str) or
        several (any iterable of str)."""
        if kind is None:
            return list(self._spans)
        kinds = {kind} if isinstance(kind, str) else set(kind)
        return [s for s in self._spans if s.kind in kinds]

    def __len__(self) -> int:
        return len(self._spans)

    def clear(self) -> None:
        self._spans.clear()
        self.dropped = 0

    def stats(self) -> dict:
        by_kind: Dict[str, int] = {}
        for s in self._spans:
            by_kind[s.kind] = by_kind.get(s.kind, 0) + 1
        return {
            "capacity": self.capacity,
            "recorded": self.n_recorded,
            "retained": len(self._spans),
            "dropped": self.dropped,
            "by_kind": by_kind,
        }

    # ---- Chrome / Perfetto export ---------------------------------------
    def chrome_trace(self, extra: Optional[dict] = None) -> dict:
        """Chrome trace-event JSON object (``{"traceEvents": [...]}``).

        Seconds become microseconds; each logical track gets its own
        ``tid`` under ``pid`` 0 with a ``thread_name`` metadata event, so
        Perfetto renders steps / phases / collectives / control-plane /
        elastic lanes separately.  Deterministic for a deterministic
        clock: track ids follow the canonical :data:`_TRACKS` order (then
        first-use order for custom tracks) and attrs are pre-sorted.
        """
        tids: Dict[str, int] = {}

        def tid_of(track: str) -> int:
            if track not in tids:
                tids[track] = len(tids)
            return tids[track]

        used = {s.track or _KIND_TRACK.get(s.kind, "control")
                for s in self._spans}
        for t in _TRACKS:
            if t in used:
                tid_of(t)

        events: List[dict] = []
        for s in self._spans:
            track = s.track or _KIND_TRACK.get(s.kind, "control")
            ev: Dict[str, object] = {
                "name": s.name,
                "cat": s.kind,
                "pid": 0,
                "tid": tid_of(track),
                "ts": s.t0 * 1e6,
            }
            if s.t1 > s.t0:
                ev["ph"] = "X"
                ev["dur"] = (s.t1 - s.t0) * 1e6
            else:
                ev["ph"] = "i"
                ev["s"] = "t"  # instant scoped to its thread/track
            args: Dict[str, object] = dict(s.attrs)
            if s.step is not None:
                args["step"] = s.step
            if s.phase is not None:
                args["phase"] = s.phase
            if args:
                ev["args"] = args
            events.append(ev)
        meta = [
            {
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                "args": {"name": track},
            }
            for track, tid in sorted(tids.items(), key=lambda kv: kv[1])
        ]
        out = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": self.dropped},
        }
        if extra:
            out["otherData"].update(extra)
        return out

    def export_chrome_trace(
        self, path: str, extra: Optional[dict] = None
    ) -> str:
        """Serialize :meth:`chrome_trace` to ``path``.  ``sort_keys``
        plus pre-sorted attrs make the bytes reproducible under an
        injected clock (the trace-replay bit-match test relies on it)."""
        payload = json.dumps(
            self.chrome_trace(extra), sort_keys=True, separators=(",", ":")
        )
        with open(path, "w") as f:
            f.write(payload)
        return payload
