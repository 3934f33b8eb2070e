"""Unified observability layer (DESIGN.md §11).

Three pieces, consumed by every other subsystem:

* :mod:`repro_torch.obs.trace` — ring-buffer span recorder with an injectable
  monotonic clock and Chrome-trace (Perfetto-loadable) export;
* :mod:`repro_torch.obs.metrics` — counters/gauges registry with JSONL export
  and a schema-pinned summary;
* :mod:`repro_torch.obs.attribution` — turns raw spans back into the paper's
  own metrics (measured coverage rate, per-bucket bubble time, knapsack
  capacity utilization, predicted-vs-actual divergence per bucket);
* :mod:`repro_torch.obs.events` — the one formatter every event surface
  (swap log, replan events, elastic faults/migrations) prints through.
"""
from repro_torch.obs.trace import ManualClock, Span, SPAN_KINDS, Tracer
from repro_torch.obs.metrics import Metrics, METRICS_SCHEMA_VERSION, validate_summary
from repro_torch.obs.attribution import (
    Attribution,
    WireBytesReport,
    attribute,
    attribute_trace,
    bucket_divergence,
    latest_phase_durations,
    measured_phase_durations_from_trace,
    phase_divergence,
    sim_metrics_from_spans,
    spans_from_sim,
    timeline_bubbles,
    link_wire_bytes_from_trace,
    wire_bytes_from_trace,
    wire_bytes_report,
)
from repro_torch.obs.events import format_event

__all__ = [
    "Attribution",
    "ManualClock",
    "Metrics",
    "METRICS_SCHEMA_VERSION",
    "Span",
    "SPAN_KINDS",
    "Tracer",
    "WireBytesReport",
    "attribute",
    "attribute_trace",
    "bucket_divergence",
    "format_event",
    "latest_phase_durations",
    "measured_phase_durations_from_trace",
    "phase_divergence",
    "sim_metrics_from_spans",
    "spans_from_sim",
    "timeline_bubbles",
    "validate_summary",
    "link_wire_bytes_from_trace",
    "wire_bytes_from_trace",
    "wire_bytes_report",
]
