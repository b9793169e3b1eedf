"""Exporters: bench-schema JSONL, Prometheus text format, HTTP /metrics
(counterpart of :mod:`tpudist.obs.export`).

Three renderings of the same registry snapshot:

* :func:`jsonl_line` / :func:`snapshot_to_jsonl` — one JSON object per
  line in the exact ``bench.py`` schema (``{"metric", "value", "unit",
  "vs_baseline", ...}``, insertion order preserved) so BENCH_*.json
  parsers keep working when bench emits through the registry.
* :func:`to_prometheus` — Prometheus text exposition format 0.0.4.
  Log-bucket histograms become classic cumulative ``le`` histograms
  whose upper bounds are the bucket upper edges ``growth**(idx+1)``.
* :class:`MetricsServer` — optional stdlib-only HTTP endpoint serving
  ``/metrics`` (Prometheus text) and ``/metrics.json`` (raw snapshot)
  from a daemon thread; no third-party dependency, safe to leave off.
"""

from __future__ import annotations

import json
import re
import threading

from tpudist_torch.obs.registry import split_labels, summarize

__all__ = ["jsonl_line", "snapshot_to_jsonl", "to_prometheus",
           "MetricsServer"]


# -- JSONL (the bench.py wire schema) ---------------------------------------

def jsonl_line(metric: str, value, unit: str, vs_baseline=None,
               **extra) -> str:
    """One bench-schema line.  Key order is load-bearing: existing
    BENCH_*.json tooling reads these positionally-ish and the recap
    printer re-dumps them verbatim."""
    return json.dumps({"metric": metric, "value": value, "unit": unit,
                       "vs_baseline": vs_baseline, **extra})


def snapshot_to_jsonl(snapshot: dict, **extra) -> list[str]:
    """Render a registry (or merged cluster) snapshot as bench-schema
    lines: counters/gauges one line each, histograms one line per summary
    stat (count/mean/p50/p90/p99/...)."""
    lines: list[str] = []
    for name, m in snapshot.get("counters", {}).items():
        lines.append(jsonl_line(name, m["value"], m["unit"], **extra))
    for name, m in snapshot.get("gauges", {}).items():
        lines.append(jsonl_line(name, m["value"], m["unit"], **extra))
    for name, h in snapshot.get("histograms", {}).items():
        summary = summarize(h)
        for stat in ("count", "mean", "min", "max", "p50", "p90", "p99"):
            unit = "" if stat == "count" else h.get("unit", "")
            lines.append(
                jsonl_line(f"{name}/{stat}", summary[stat], unit, **extra))
    return lines


# -- Prometheus text format -------------------------------------------------

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _NAME_BAD.sub("_", name)
    return "_" + out if out[:1].isdigit() else out


# label parsing lives with the registry now (the TSDB and the name
# validator share it); kept as an alias for older imports.
_split_labels = split_labels


def _prom_num(v) -> str:
    if v is None:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    return repr(float(v))


def to_prometheus(snapshot: dict) -> str:
    """Prometheus text exposition of a registry or merged snapshot.
    Metrics registered with a ``help`` string get a ``# HELP`` line
    ahead of their ``# TYPE``.  Histograms are cumulative: ``le`` edges
    are the log-bucket UPPER
    bounds (``growth**(idx+1)``; the zero bucket folds into the smallest
    edge since its values are <= 0 < every positive edge), closing with
    ``+Inf``, ``_sum`` and ``_count``.  Merged cluster snapshots keep
    their per-host attribution: each counter/gauge additionally emits one
    ``{name}{{worker="r"}}`` sample per rank from its ``per_worker``
    map.  Registry names carrying ``~key=value`` suffixes (the per-class
    SLO series, e.g. ``slo/bad~class=priority``) render as one base
    metric with a real label set (``slo_bad{class="priority"}``)."""
    out: list[str] = []
    typed: set[str] = set()

    def help_line(pname: str, m: dict) -> None:
        h = m.get("help")
        if h:
            # the exposition format's escapes: backslash and newline
            h = h.replace("\\", "\\\\").replace("\n", "\\n")
            out.append(f"# HELP {pname} {h}")

    def label_value(v: str) -> str:
        # exposition-format escapes for label values: backslash, the
        # double quote, and newline (anything else passes through —
        # '/' and '=' are legal inside a quoted label value)
        return (v.replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def label_str(labels: dict[str, str]) -> str:
        if not labels:
            return ""
        inner = ",".join(f'{k}="{label_value(v)}"'
                         for k, v in sorted(labels.items()))
        return "{" + inner + "}"

    def scalar_lines(pname: str, labels: dict, m: dict) -> None:
        out.append(f"{pname}{label_str(labels)} {_prom_num(m['value'])}")
        for rank in sorted(m.get("per_worker", {}), key=int):
            out.append(
                f"{pname}{label_str({**labels, 'worker': rank})} "
                f"{_prom_num(m['per_worker'][rank])}")

    def type_line(pname: str, kind: str, m: dict) -> None:
        # one HELP/TYPE per base name even when several labeled series
        # share it (the exposition format forbids duplicates)
        if pname in typed:
            return
        typed.add(pname)
        help_line(pname, m)
        out.append(f"# TYPE {pname} {kind}")

    for name, m in snapshot.get("counters", {}).items():
        base, labels = _split_labels(name)
        pname = _prom_name(base)
        type_line(pname, "counter", m)
        scalar_lines(pname, labels, m)
    for name, m in snapshot.get("gauges", {}).items():
        base, labels = _split_labels(name)
        pname = _prom_name(base)
        type_line(pname, "gauge", m)
        scalar_lines(pname, labels, m)
    for name, h in snapshot.get("histograms", {}).items():
        base, labels = split_labels(name)
        pname = _prom_name(base)
        if pname not in typed:
            typed.add(pname)
            help_line(pname, h)
            out.append(f"# TYPE {pname} histogram")
        growth = h["growth"]
        cum = h.get("zero", 0)
        for idx in sorted(int(i) for i in h["buckets"]):
            cum += h["buckets"][str(idx)]
            le = label_str({**labels, "le": _prom_num(growth ** (idx + 1))})
            out.append(f"{pname}_bucket{le} {cum}")
        out.append(
            f'{pname}_bucket{label_str({**labels, "le": "+Inf"})} '
            f'{h["count"]}')
        out.append(f"{pname}_sum{label_str(labels)} {_prom_num(h['sum'])}")
        out.append(f"{pname}_count{label_str(labels)} {h['count']}")
    return "\n".join(out) + "\n"


# -- HTTP /metrics ----------------------------------------------------------

_KNOWN_PATHS = ("/metrics", "/metrics.json", "/healthz", "/alerts",
                "/tsdb")


class MetricsServer:
    """stdlib-only metrics + liveness endpoint.

    ``MetricsServer(registry).port`` binds an ephemeral port; pass
    ``snapshot_fn`` to serve something other than the local registry
    (e.g. rank 0 serving the merged cluster view from
    :func:`tpudist_torch.obs.aggregate.collect_and_merge`).  Pass ``health_fn``
    (conventionally ``HealthMonitor.verdict``) to activate ``/healthz``
    as a container liveness probe: 200 while the verdict is healthy (or
    not yet known), 503 once it is degraded — the role the reference's
    Docker HEALTHCHECK plays, but cluster-aware.  Unknown paths get a
    real 404 with a JSON body listing the endpoints.  Runs in a daemon
    thread; :meth:`close` shuts it down.

    With ``alerts`` (an :class:`tpudist_torch.obs.alerts.AlertManager`) the
    server additionally exposes ``/alerts`` — active/resolved alerts +
    the loaded rule set and its hash; with ``tsdb`` (a
    :class:`tpudist_torch.obs.tsdb.TSDB`) it exposes ``/tsdb`` — per-series
    points and store stats (``?match=substr`` filters series,
    ``?window_s=60`` bounds the lookback)."""

    def __init__(self, registry=None, snapshot_fn=None, host: str = "",
                 port: int = 0, health_fn=None, alerts=None,
                 tsdb=None) -> None:
        if (registry is None) == (snapshot_fn is None):
            raise ValueError("pass exactly one of registry / snapshot_fn")
        snap = snapshot_fn or registry.snapshot
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlsplit

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - http.server API
                split = urlsplit(self.path)
                path = split.path
                status = 200
                if path == "/metrics":
                    body = to_prometheus(snap()).encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/metrics.json":
                    body = json.dumps(snap()).encode("utf-8")
                    ctype = "application/json"
                elif path == "/healthz":
                    verdict = (health_fn() if health_fn is not None
                               else {"status": "ok"})
                    status = 503 if verdict.get("status") == "degraded" \
                        else 200
                    body = json.dumps(verdict).encode("utf-8")
                    ctype = "application/json"
                elif path == "/alerts" and alerts is not None:
                    body = json.dumps(alerts.to_doc()).encode("utf-8")
                    ctype = "application/json"
                elif path == "/tsdb" and tsdb is not None:
                    q = parse_qs(split.query)
                    window = q.get("window_s", [None])[0]
                    doc = tsdb.to_doc(
                        match=q.get("match", [None])[0],
                        window_s=float(window) if window else None)
                    body = json.dumps(doc).encode("utf-8")
                    ctype = "application/json"
                else:
                    status = 404
                    body = json.dumps(
                        {"error": f"unknown path {path!r}",
                         "paths": list(_KNOWN_PATHS)}).encode("utf-8")
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:  # silence per-request noise
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="obs-metrics-http",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
