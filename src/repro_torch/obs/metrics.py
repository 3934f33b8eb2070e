"""Counters/gauges registry with JSONL export (DESIGN.md §11).

Deliberately tiny: a :class:`Metrics` instance is a pair of flat dicts.
Counters only go up (``inc``); gauges hold the latest value (``set``).
Snapshots are appended to a JSONL file one schema-versioned line at a
time, so long runs stream their metric history without ever holding it
in memory, and the final :meth:`summary` is the schema-pinned payload
benchmarks and the launch driver print/persist.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

#: Bump when the summary/JSONL line layout changes shape.
METRICS_SCHEMA_VERSION = 1

#: Keys every summary / JSONL line carries, in this shape.
SUMMARY_KEYS = ("schema", "counters", "gauges")


class Metrics:
    """Flat counters + gauges with schema-pinned export."""

    def __init__(self) -> None:
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}

    # ---- recording ------------------------------------------------------
    def inc(self, name: str, by: float = 1) -> float:
        v = self._counters.get(name, 0) + by
        self._counters[name] = v
        return v

    def set(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    # ---- queries --------------------------------------------------------
    def counter(self, name: str) -> float:
        return self._counters.get(name, 0)

    def gauge(self, name: str) -> Optional[float]:
        return self._gauges.get(name)

    def summary(self) -> dict:
        """Schema-pinned snapshot: exactly :data:`SUMMARY_KEYS`."""
        return {
            "schema": METRICS_SCHEMA_VERSION,
            "counters": dict(sorted(self._counters.items())),
            "gauges": dict(sorted(self._gauges.items())),
        }

    # ---- export ---------------------------------------------------------
    def export_jsonl(self, path: str, extra: Optional[dict] = None) -> str:
        """Append one summary line to ``path``; returns the line."""
        payload = self.summary()
        if extra:
            payload = {**payload, "extra": extra}
        line = json.dumps(payload, sort_keys=True, separators=(",", ":"))
        with open(path, "a") as f:
            f.write(line + "\n")
        return line


def validate_summary(payload: dict) -> None:
    """Raise ``ValueError`` unless ``payload`` is a valid summary."""
    missing = [k for k in SUMMARY_KEYS if k not in payload]
    if missing:
        raise ValueError(f"metrics summary missing keys: {missing}")
    if payload["schema"] != METRICS_SCHEMA_VERSION:
        raise ValueError(
            f"metrics schema {payload['schema']} != {METRICS_SCHEMA_VERSION}"
        )
    for k in ("counters", "gauges"):
        if not isinstance(payload[k], dict):
            raise ValueError(f"metrics summary {k!r} must be a mapping")
