"""One formatter for every control-plane event surface (DESIGN.md §11).

Before this module each surface printed its own shape: the runtime's
``swap_log`` dicts, ``ReplanEvent.describe()``, ``FaultEvent.describe()``
and the elastic coordinator's migration dicts.  :func:`format_event`
accepts any of them (plus raw :class:`~repro_torch.obs.trace.Span`\\ s) and
emits one aligned line ``<surface>  step NNNNN  <detail>``, so the
launch driver and ``schedule_explorer`` print replan, elastic, swap and
repack events uniformly.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.trace import Span


def _step(ev: dict) -> str:
    s = ev.get("step")
    return f"step {s:5d}" if isinstance(s, int) else "step     -"


def _fmt_swap(ev: dict) -> str:
    kind = ev.get("event")
    if kind == "swap-compile-failed":
        retry = "retrying" if ev.get("retrying") else "giving up"
        return (f"swap     {_step(ev)}  compile-failed attempt "
                f"{ev.get('attempt', '?')} ({retry}): {ev.get('error')}")
    if kind == "swap-abandoned":
        sup = " superseded" if ev.get("superseded") else ""
        return (f"swap     {_step(ev)}  ABANDONED after "
                f"{ev.get('attempts', '?')} attempts "
                f"({ev.get('elapsed_s', 0.0):.2f}s){sup}: {ev.get('error')}")
    # swap install entry (no 'event' key)
    out = (f"swap     {_step(ev)}  installed period={ev.get('period')} "
           f"updates/period={ev.get('updates_per_period')} "
           f"buckets={ev.get('n_buckets')} shards={ev.get('shards')}")
    if ev.get("repack_s") is not None:
        out += f"  repack {ev['repack_s'] * 1e3:.0f} ms"
    return out


def _fmt_elastic(ev: dict) -> str:
    action = ev.get("action", "?")
    if action == "checkpoint-halt":
        return (f"elastic  {_step(ev)}  checkpoint-halt "
                f"(trigger {ev.get('trigger')}, detected at step "
                f"{ev.get('detected_step')}) -> {ev.get('checkpoint')}")
    out = (f"elastic  {_step(ev)}  {action} "
           f"{ev.get('old_shards')}->{ev.get('new_shards')} shards "
           f"(trigger {ev.get('trigger')}, detected at step "
           f"{ev.get('detected_step')})  period "
           f"{ev.get('old_period')}->{ev.get('new_period')}")
    if ev.get("migrate_s") is not None:
        out += f"  migrate {ev['migrate_s'] * 1e3:.0f} ms"
    if ev.get("repack_s") is not None:
        out += f"  repack {ev['repack_s'] * 1e3:.0f} ms"
    return out


def _fmt_span(sp: Span) -> str:
    step = f"step {sp.step:5d}" if sp.step is not None else "step     -"
    dur = f"  {sp.duration * 1e3:.2f} ms" if sp.t1 > sp.t0 else ""
    args = sp.args
    extras = " ".join(
        f"{k}={v}" for k, v in sorted(args.items()) if k not in ("detail",)
    )
    return (f"{sp.kind:<8s} {step}  {sp.name}{dur}"
            + (f"  [{extras}]" if extras else ""))


def format_event(ev: object) -> str:
    """Format any control-plane event object into one aligned line."""
    # late imports keep obs importable without the adapt/elastic stacks
    try:
        from repro_torch.adapt.controller import ReplanEvent
    except Exception:                                 # pragma: no cover
        ReplanEvent = ()                              # type: ignore
    try:
        from repro_torch.elastic.health import FaultEvent
    except Exception:                                 # pragma: no cover
        FaultEvent = ()                               # type: ignore

    if ReplanEvent and isinstance(ev, ReplanEvent):
        return f"adapt    {ev.describe()}"
    if FaultEvent and isinstance(ev, FaultEvent):
        return f"elastic  {ev.describe()}"
    if isinstance(ev, Span):
        return _fmt_span(ev)
    if isinstance(ev, dict):
        if "action" in ev:
            return _fmt_elastic(ev)
        return _fmt_swap(ev)
    return f"event    {ev!r}"
