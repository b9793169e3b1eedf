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

tpudist's ``tsdb``, ``alerts``, ``console``, ``timeline`` and ``xla``
modules are not ported yet (ROADMAP Queue A 10's remainder).

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

__all__ = [
    "Counter",
    "EventPublisher",
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
    "TraceContext",
    "atomic_write_json",
    "collect",
    "collect_and_merge",
    "collect_events",
    "counter",
    "events",
    "gauge",
    "group_timelines",
    "histogram",
    "hist_quantile",
    "is_complete",
    "jsonl_line",
    "merge_events",
    "merge_snapshots",
    "recorder",
    "registry",
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
