"""Runtime observability: metrics registry, event sink, span tracing,
HTTP endpoint, run reports.

See docs/OBSERVABILITY.md for the metric catalog, the event schema, the
span-tracing semantics, and the zero-dispatch rule this subsystem is built
around.  ``python -m lightgbm_tpu_torch.obs`` dumps the live registry (or a
saved snapshot file) as Prometheus text exposition; subcommands ``trace``
(Chrome-trace export), ``serve`` (standalone HTTP endpoint over a
snapshot), and ``tail`` (follow an events JSONL) cover the operational
loops.  Everything in this package is stdlib-only — it never imports jax.
"""

from .metrics import (  # noqa: F401
    FLEET_SCHEMA, REGISTRY, RESERVOIR_CAP, SCHEMA, SECTION_PREFIX, Counter,
    Gauge, Histogram, Registry, clear_prefix, counter, enabled, event,
    events, gauge, histogram, histogram_items, labeled, load_fleet_metrics,
    load_snapshot, merge_event_files, merge_snapshot_files,
    register_collector, render_lightgbm, render_prometheus,
    render_prometheus_fleet, reset, set_enabled, set_events_file, snapshot,
    start_periodic_snapshots, stop_periodic_snapshots,
    validate_fleet_metrics, validate_snapshot, write_snapshot,
)
from .server import (  # noqa: F401
    MetricsServer, get_server, health, maybe_start, start_server,
    stop_server,
)
from .trace import (  # noqa: F401
    SCHEMA_TRACE, TRACE_RING_CAP, Span, load_trace, record_span,
    reset_trace, set_annotation_factory, span, spans, to_chrome_trace,
    validate_trace, write_trace,
)

__all__ = [
    "FLEET_SCHEMA", "REGISTRY", "RESERVOIR_CAP", "SCHEMA", "SCHEMA_TRACE",
    "SECTION_PREFIX", "TRACE_RING_CAP", "Counter", "Gauge", "Histogram",
    "MetricsServer", "Registry", "Span", "clear_prefix", "counter",
    "enabled", "event", "events", "gauge", "get_server", "health",
    "histogram", "histogram_items", "labeled", "load_fleet_metrics",
    "load_snapshot", "load_trace", "maybe_start", "merge_event_files",
    "merge_snapshot_files", "record_span", "register_collector",
    "render_lightgbm", "render_prometheus", "render_prometheus_fleet",
    "reset", "reset_trace", "set_annotation_factory", "set_enabled",
    "set_events_file", "snapshot", "span", "spans",
    "start_periodic_snapshots", "start_server", "stop_periodic_snapshots",
    "stop_server", "to_chrome_trace", "validate_fleet_metrics",
    "validate_snapshot", "validate_trace", "write_snapshot", "write_trace",
]
