"""tpudist_torch.obs — distributed observability (counterpart of
:mod:`tpudist.obs`): metrics, spans, aggregation, exporters, the health
plane, the flight recorder and per-request tracing.

* :mod:`tpudist_torch.obs.registry` — counters / gauges / log-bucket
  histograms with lazy device accumulation (recording never syncs; one
  stacked ``.cpu()`` per snapshot).
* :mod:`tpudist_torch.obs.spans` — ``with obs.span("serve/segment"):``
  Chrome-trace timelines, each span also a ``torch.profiler``
  ``record_function`` region, optional ``torch.cuda.synchronize()``
  fencing.
* :mod:`tpudist_torch.obs.aggregate` — workers publish snapshots through
  the coord KV store; a reader merges them into a cluster view.
* :mod:`tpudist_torch.obs.export` — bench-schema JSONL, Prometheus text,
  and a stdlib-only HTTP ``/metrics`` + ``/healthz`` endpoint.
* :mod:`tpudist_torch.obs.health` — straggler/staleness classification
  over the published snapshots, with hysteresis.
* :mod:`tpudist_torch.obs.recorder` — bounded flight-recorder ring and
  crash post-mortem bundles (``with obs.recorder.guard("serve_loop")``).
* :mod:`tpudist_torch.obs.events` — per-request distributed tracing:
  trace contexts riding the serve fleet's wire format, the request-event
  ring, fleet-wide timeline merge and SLO burn-rate accounting
  (:class:`SLOTracker`).

* :mod:`tpudist_torch.obs.xla` — kernel-build, CUDA memory and
  cost/MFU telemetry (tpudist's module and metric names; it reads CUDA).
* :mod:`tpudist_torch.obs.tsdb` — bounded in-memory time-series store
  scraped from the registry/merged snapshots on a cadence, with
  rate/delta/quantile_over_time queries (:class:`TSDB`,
  :class:`FleetScraper`).
* :mod:`tpudist_torch.obs.alerts` — declarative alert rules (query +
  predicate + hold) with a pending->firing->resolved lifecycle.
* :mod:`tpudist_torch.obs.console` — ``python -m
  tpudist_torch.obs.console``: terminal dashboard of the fleet;
  ``--once`` renders a single frame.
* :mod:`tpudist_torch.obs.timeline` — ``python -m
  tpudist_torch.obs.timeline``: per-request timelines from an event log.

Module-level conveniences bind to one process-global registry, tracer,
event ring, SLO tracker and flight recorder, so library code can just
``from tpudist_torch import obs; obs.counter(...)``.  Env knobs:
``TPUDIST_OBS_FENCE`` fences spans with ``torch.cuda.synchronize()``;
``TPUDIST_POSTMORTEM_DIR`` picks where crash bundles land.
"""

from __future__ import annotations

from tpudist_torch.obs.aggregate import (
    MetricsPublisher,
    collect,
    collect_and_merge,
    merge_snapshots,
)
from tpudist_torch.obs.alerts import (
    AlertManager,
    AlertRule,
    autoscale_rules,
    default_rules,
    load_rules,
    rules_hash,
)
from tpudist_torch.obs.events import (
    EventPublisher,
    RequestEventLog,
    SLOTracker,
    TraceContext,
    collect_events,
    group_timelines,
    is_complete,
    merge_events,
    slo_class,
    timeline_for_rid,
)
from tpudist_torch.obs.export import (
    MetricsServer,
    jsonl_line,
    snapshot_to_jsonl,
    to_prometheus,
)
from tpudist_torch.obs.health import HealthMonitor, HealthWatcher
from tpudist_torch.obs.recorder import POSTMORTEM_SCHEMA, FlightRecorder
from tpudist_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    hist_quantile,
    split_labels,
    summarize,
    validate_metric_name,
    values_to_hist,
)
from tpudist_torch.obs.spans import SpanTracer, atomic_write_json
from tpudist_torch.obs.tsdb import TSDB, FleetScraper
from tpudist_torch.obs.xla import (
    install_compile_telemetry,
    mfu,
    note_compile,
    note_step,
    peak_tflops,
    update_memory_gauges,
)

__all__ = [
    "AlertManager",
    "AlertRule",
    "Counter",
    "EventPublisher",
    "FleetScraper",
    "FlightRecorder",
    "Gauge",
    "HealthMonitor",
    "HealthWatcher",
    "Histogram",
    "MetricRegistry",
    "MetricsPublisher",
    "MetricsServer",
    "POSTMORTEM_SCHEMA",
    "RequestEventLog",
    "SLOTracker",
    "SpanTracer",
    "TSDB",
    "TraceContext",
    "atomic_write_json",
    "autoscale_rules",
    "collect",
    "collect_and_merge",
    "collect_events",
    "counter",
    "default_rules",
    "events",
    "gauge",
    "group_timelines",
    "hist_quantile",
    "histogram",
    "install_compile_telemetry",
    "is_complete",
    "jsonl_line",
    "load_rules",
    "merge_events",
    "merge_snapshots",
    "mfu",
    "note_compile",
    "note_step",
    "peak_tflops",
    "recorder",
    "registry",
    "rules_hash",
    "slo",
    "slo_class",
    "snapshot",
    "snapshot_to_jsonl",
    "span",
    "split_labels",
    "summarize",
    "timeline_for_rid",
    "to_prometheus",
    "tracer",
    "update_memory_gauges",
    "validate_metric_name",
    "values_to_hist",
]

# process-global registry + tracer + event ring + SLO tracker + flight
# recorder: instrumentation all over the stack reports here;
# snapshot()/tracer.dump()/events.snapshot()/recorder.dump() read it out
registry = MetricRegistry()
tracer = SpanTracer()
events = RequestEventLog()
slo = SLOTracker(registry=registry)
recorder = FlightRecorder(registry=registry, tracer=tracer,
                          request_events=events)

counter = registry.counter
gauge = registry.gauge
histogram = registry.histogram
snapshot = registry.snapshot
span = tracer.span
