"""Bounded in-memory time-series store over registry snapshots
(counterpart of :mod:`tpudist.obs.tsdb`; the same points survive every
downsample fold and budget trim).

Every signal the repo emits is a point-in-time snapshot: a registry
``snapshot()`` doc, or the fleet-merged view out of
``collect``/``merge_snapshots``.  This module adds the missing time
axis: :class:`TSDB` scrapes those snapshots on a cadence into
per-series ring buffers and answers the questions an operator (or an
alert rule) actually asks — "what was decode-pool KV headroom over the
last two minutes", "how fast is that counter moving", "what is the
p99 of queue wait over the last window".

Design constraints, in order:

* **Bounded.**  Retention, resolution and an overall byte budget are
  configuration; the store trims itself on every scrape.  Old points
  are folded into coarse (downsampled) buckets before they are dropped
  so a 10-minute view survives a 2 MiB budget.
* **Snapshot-native.**  ``scrape()`` takes the exact doc shape
  ``MetricRegistry.snapshot()`` / ``merge_snapshots()`` produce:
  counters and gauges become points; histograms are expanded into
  derived ``{name}/p50 p90 p99 mean count`` series via ``summarize``.
  ``~key=value`` label suffixes in metric names become series labels.
* **Dependency-free.**  Pure stdlib, injectable clock, usable on the
  sim's VirtualClock and in a live exporter thread alike.

:class:`FleetScraper` is the cadence loop: local registry +
coordinator-collected fleet view -> TSDB -> (optionally) an
``AlertManager.evaluate`` per tick, with membership-aware collection so
departed replicas fall out of the merged view immediately.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable

from tpudist_torch.obs.registry import split_labels, summarize

__all__ = ["TSDB", "FleetScraper", "Series"]

# honest CPython accounting constants: a raw point is a 2-tuple of
# floats inside a deque (~56B tuple + 2x24B floats + deque slot), a
# coarse bucket is a 5-slot list, and each series carries dict/str
# overhead.  These deliberately round UP so the budget is conservative.
_RAW_POINT_BYTES = 120
_COARSE_POINT_BYTES = 220
_SERIES_BYTES = 900


class Series:
    """One metric stream: a raw ring at scrape resolution plus a
    coarse ring of downsampled buckets for the older window."""

    __slots__ = ("name", "base", "labels", "kind", "unit", "raw", "coarse")

    def __init__(self, name: str, kind: str, unit: str = "") -> None:
        self.name = name
        self.base, self.labels = split_labels(name)
        self.kind = kind            # "counter" | "gauge"
        self.unit = unit
        self.raw: deque = deque()           # (t, value)
        self.coarse: deque = deque()        # [bucket_t, sum, min, max, n]

    def matches(self, labels: dict[str, str] | None) -> bool:
        if not labels:
            return True
        return all(self.labels.get(k) == v for k, v in labels.items())

    def latest(self) -> tuple[float, float] | None:
        if self.raw:
            return self.raw[-1]
        if self.coarse:
            b = self.coarse[-1]
            return (b[0], b[1] / max(b[4], 1))
        return None

    def points(self, t_min: float | None = None) -> list[tuple[float, float]]:
        """Merged (t, value) points, oldest first; coarse buckets
        contribute their average."""
        out: list[tuple[float, float]] = []
        for b in self.coarse:
            if t_min is None or b[0] >= t_min:
                out.append((b[0], b[1] / max(b[4], 1)))
        for t, v in self.raw:
            if t_min is None or t >= t_min:
                out.append((t, v))
        return out

    def weighted_values(self, t_min: float | None = None) \
            -> list[tuple[float, int]]:
        """(value, weight) pairs for quantile queries — coarse buckets
        weigh as many observations as they folded in."""
        out: list[tuple[float, int]] = []
        for b in self.coarse:
            if t_min is None or b[0] >= t_min:
                out.append((b[1] / max(b[4], 1), int(b[4])))
        for t, v in self.raw:
            if t_min is None or t >= t_min:
                out.append((v, 1))
        return out

    def approx_bytes(self) -> int:
        return (_SERIES_BYTES + len(self.raw) * _RAW_POINT_BYTES
                + len(self.coarse) * _COARSE_POINT_BYTES)


def _env_float(environ, key: str, default: float) -> float:
    try:
        return float(environ.get(key, default))
    except (TypeError, ValueError):
        return default


class TSDB:
    """Bounded in-memory time-series database.

    Parameters
    ----------
    retention_s: points older than this are dropped entirely.
    resolution_s: raw ring bucket width — two samples landing in the
        same bucket keep only the latest (last-write-wins), so a
        faster-than-cadence recorder cannot blow the budget.
    downsample_after_s: raw points older than this are folded into
        coarse buckets of ``downsample_resolution_s`` (avg/min/max/n).
    byte_budget: overall cap on the store's approximate footprint;
        enforced after every scrape by trimming oldest points first.
    """

    def __init__(self, *, retention_s: float = 600.0,
                 resolution_s: float = 1.0,
                 downsample_after_s: float = 120.0,
                 downsample_resolution_s: float = 10.0,
                 byte_budget: int = 2 * 1024 * 1024,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if resolution_s <= 0 or downsample_resolution_s <= 0:
            raise ValueError("resolution must be > 0")
        self.retention_s = float(retention_s)
        self.resolution_s = float(resolution_s)
        self.downsample_after_s = float(downsample_after_s)
        self.downsample_resolution_s = float(downsample_resolution_s)
        self.byte_budget = int(byte_budget)
        self._clock = clock
        self._series: dict[str, Series] = {}
        self._lock = threading.Lock()
        self.dropped_points = 0     # budget-trim casualties, observable

    @classmethod
    def from_env(cls, environ=None, **overrides) -> "TSDB":
        """Knobs: ``TPUDIST_TSDB_{RETENTION_S,RESOLUTION_S,
        DOWNSAMPLE_AFTER_S,DOWNSAMPLE_RESOLUTION_S,BYTE_BUDGET}``."""
        env = os.environ if environ is None else environ
        kw: dict[str, Any] = dict(
            retention_s=_env_float(env, "TPUDIST_TSDB_RETENTION_S", 600.0),
            resolution_s=_env_float(env, "TPUDIST_TSDB_RESOLUTION_S", 1.0),
            downsample_after_s=_env_float(
                env, "TPUDIST_TSDB_DOWNSAMPLE_AFTER_S", 120.0),
            downsample_resolution_s=_env_float(
                env, "TPUDIST_TSDB_DOWNSAMPLE_RESOLUTION_S", 10.0),
            byte_budget=int(_env_float(
                env, "TPUDIST_TSDB_BYTE_BUDGET", 2 * 1024 * 1024)),
        )
        kw.update(overrides)
        return cls(**kw)

    # ------------------------------------------------------------- write

    def record(self, name: str, value: float, t: float | None = None,
               kind: str = "gauge", unit: str = "") -> None:
        """Append one sample.  ``None`` is ignored (absent semantics);
        NaN is stored — predicates comparing against NaN are False, so
        a NaN sample reads as "present but undecidable"."""
        if value is None:
            return
        t = self._clock() if t is None else float(t)
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = Series(name, kind, unit)
            bucket = math.floor(t / self.resolution_s) * self.resolution_s
            if s.raw and s.raw[-1][0] >= bucket:
                s.raw[-1] = (s.raw[-1][0], float(value))   # last-write-wins
            else:
                s.raw.append((bucket, float(value)))
            self._roll(s, t)

    def scrape(self, snapshot: dict, t: float | None = None) -> int:
        """Ingest one registry/merged snapshot doc; returns the number
        of points written.  Histograms expand into derived
        ``{base}/p50 p90 p99 mean count`` series (labels preserved)."""
        t = self._clock() if t is None else float(t)
        n = 0
        for name, c in (snapshot.get("counters") or {}).items():
            v = c.get("value")
            if v is not None and math.isfinite(v):
                self.record(name, v, t, kind="counter",
                            unit=c.get("unit", ""))
                n += 1
        for name, g in (snapshot.get("gauges") or {}).items():
            v = g.get("value")
            if v is not None and math.isfinite(v):
                self.record(name, v, t, kind="gauge", unit=g.get("unit", ""))
                n += 1
        for name, h in (snapshot.get("histograms") or {}).items():
            base, labels = split_labels(name)
            tail = "".join(f"~{k}={v}" for k, v in sorted(labels.items()))
            stats = summarize(h)
            for stat in ("p50", "p90", "p99", "mean"):
                v = stats.get(stat)
                if v is not None and math.isfinite(v):
                    self.record(f"{base}/{stat}{tail}", v, t,
                                unit=h.get("unit", ""))
                    n += 1
            self.record(f"{base}/count{tail}", float(stats.get("count", 0)),
                        t, unit="observations")
            n += 1
        self._enforce_budget()
        return n

    def _roll(self, s: Series, now: float) -> None:
        """Fold raw points past the downsample horizon into coarse
        buckets; expire coarse buckets past retention.  Lock held."""
        horizon = now - self.downsample_after_s
        res = self.downsample_resolution_s
        while s.raw and s.raw[0][0] < horizon:
            t, v = s.raw.popleft()
            bucket = math.floor(t / res) * res
            if s.coarse and s.coarse[-1][0] == bucket:
                b = s.coarse[-1]
                b[1] += v
                b[2] = min(b[2], v)
                b[3] = max(b[3], v)
                b[4] += 1
                # stored as running sum; points() divides by n
            else:
                s.coarse.append([bucket, v, v, v, 1])
        cutoff = now - self.retention_s
        while s.coarse and s.coarse[0][0] < cutoff:
            s.coarse.popleft()
            self.dropped_points += 1
        while s.raw and s.raw[0][0] < cutoff:
            s.raw.popleft()
            self.dropped_points += 1

    def _enforce_budget(self) -> None:
        """Trim oldest points (coarse first, then raw) proportionally
        across series until the approximate footprint fits the budget.
        If every survivor is at its 2-point floor and the shells still
        overflow (series cardinality blowup), whole series are evicted
        coldest-first — the budget is a hard cap, not a hope."""
        with self._lock:
            total = sum(s.approx_bytes() for s in self._series.values())
            if total <= self.byte_budget:
                return
            # shave the oldest end of every series by the same ratio
            # until we fit; 2 points minimum so rate()/delta() survive
            while total > self.byte_budget:
                shaved = 0
                for s in self._series.values():
                    n = len(s.raw) + len(s.coarse)
                    drop = max(1, n // 8) if n > 2 else 0
                    for _ in range(drop):
                        if s.coarse:
                            s.coarse.popleft()
                        elif len(s.raw) > 2:
                            s.raw.popleft()
                        else:
                            break
                        shaved += 1
                        self.dropped_points += 1
                if not shaved:
                    # every series is at its 2-point floor and the
                    # shells alone exceed the budget: the cap is hard,
                    # so evict whole series, coldest last-write first
                    for key in [k for k, s in self._series.items()
                                if not s.raw and not s.coarse]:
                        del self._series[key]
                    by_age = sorted(
                        self._series,
                        key=lambda k: (self._series[k].raw[-1][0]
                                       if self._series[k].raw else
                                       self._series[k].coarse[-1][0]
                                       if self._series[k].coarse
                                       else float("-inf")))
                    for key in by_age:
                        s = self._series.pop(key)
                        self.dropped_points += len(s.raw) + len(s.coarse)
                        total -= s.approx_bytes()
                        if total <= self.byte_budget:
                            break
                    break
                total = sum(s.approx_bytes() for s in self._series.values())

    # ------------------------------------------------------------- read

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def select(self, name: str, labels: dict[str, str] | None = None) \
            -> list[Series]:
        """Series whose base name matches ``name`` (a full labelled
        name also matches itself) and whose labels are a superset of
        ``labels``."""
        with self._lock:
            out = []
            for s in self._series.values():
                if (s.base == name or s.name == name) and s.matches(labels):
                    out.append(s)
            return out

    def _pooled(self, name, labels, window_s, at) -> list[tuple[float, float]]:
        at = self._clock() if at is None else at
        t_min = None if window_s is None else at - window_s
        pts: list[tuple[float, float]] = []
        for s in self.select(name, labels):
            pts.extend(s.points(t_min))
        pts.sort(key=lambda p: p[0])
        return pts

    def latest(self, name: str, labels: dict[str, str] | None = None,
               window_s: float | None = None,
               at: float | None = None) -> float | None:
        """Most recent sample across matching series; ``window_s``
        bounds staleness (None = any age)."""
        at = self._clock() if at is None else at
        best: tuple[float, float] | None = None
        for s in self.select(name, labels):
            p = s.latest()
            if p is None:
                continue
            if window_s is not None and p[0] < at - window_s:
                continue
            if best is None or p[0] > best[0]:
                best = p
        return None if best is None else best[1]

    def delta(self, name: str, window_s: float,
              labels: dict[str, str] | None = None,
              at: float | None = None) -> float | None:
        """last - first over the window, summed across matching
        series.  None until a series has two points in the window."""
        at = self._clock() if at is None else at
        total = None
        for s in self.select(name, labels):
            pts = s.points(at - window_s)
            if len(pts) < 2:
                continue
            total = (total or 0.0) + (pts[-1][1] - pts[0][1])
        return total

    def rate(self, name: str, window_s: float,
             labels: dict[str, str] | None = None,
             at: float | None = None) -> float | None:
        """Reset-aware per-second rate over the window, summed across
        matching series (counter semantics: a decrease is a restart,
        counted from zero)."""
        at = self._clock() if at is None else at
        total = None
        for s in self.select(name, labels):
            pts = s.points(at - window_s)
            if len(pts) < 2:
                continue
            inc = 0.0
            for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
                inc += (v1 - v0) if v1 >= v0 else v1
            span = pts[-1][0] - pts[0][0]
            if span > 0:
                total = (total or 0.0) + inc / span
        return total

    def _over_time(self, name, window_s, labels, at, fold):
        pts = self._pooled(name, labels, window_s, at)
        if not pts:
            return None
        return fold([v for _, v in pts])

    def avg_over_time(self, name, window_s, labels=None, at=None):
        return self._over_time(name, window_s, labels, at,
                               lambda vs: sum(vs) / len(vs))

    def max_over_time(self, name, window_s, labels=None, at=None):
        return self._over_time(name, window_s, labels, at, max)

    def min_over_time(self, name, window_s, labels=None, at=None):
        return self._over_time(name, window_s, labels, at, min)

    def quantile_over_time(self, name: str, q: float, window_s: float,
                           labels=None, at=None) -> float | None:
        """Nearest-rank quantile over the window's samples; coarse
        buckets weigh as many observations as they folded in."""
        at = self._clock() if at is None else at
        t_min = at - window_s
        weighted: list[tuple[float, int]] = []
        for s in self.select(name, labels):
            weighted.extend(s.weighted_values(t_min))
        if not weighted:
            return None
        weighted.sort(key=lambda p: p[0])
        total = sum(w for _, w in weighted)
        rank = max(1, math.ceil(q * total))
        seen = 0
        for v, w in weighted:
            seen += w
            if seen >= rank:
                return v
        return weighted[-1][0]

    # ------------------------------------------------------------- meta

    def approx_bytes(self) -> int:
        with self._lock:
            return sum(s.approx_bytes() for s in self._series.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "points": sum(len(s.raw) + len(s.coarse)
                              for s in self._series.values()),
                "approx_bytes": sum(s.approx_bytes()
                                    for s in self._series.values()),
                "byte_budget": self.byte_budget,
                "dropped_points": self.dropped_points,
                "retention_s": self.retention_s,
                "resolution_s": self.resolution_s,
            }

    def to_doc(self, match: str | None = None,
               window_s: float | None = None) -> dict:
        """JSON-friendly dump (the ``/tsdb`` endpoint body and the
        console snapshot's ``tsdb`` key): stats + per-series points."""
        at = self._clock()
        t_min = None if window_s is None else at - window_s
        doc: dict[str, Any] = {"schema": "tpudist.tsdb/1",
                               "stats": self.stats(), "series": {}}
        with self._lock:
            items = sorted(self._series.items())
        for name, s in items:
            if match is not None and match not in name:
                continue
            doc["series"][name] = {
                "kind": s.kind, "unit": s.unit, "labels": s.labels,
                "points": [[round(t, 3), v] for t, v in s.points(t_min)],
            }
        return doc


class FleetScraper:
    """Cadence loop: local registry + coordinator fleet view -> TSDB
    -> alert evaluation, one ``tick()`` at a time.

    Membership-aware: ranks are read from ``{ns}/replica/*``
    registrations and passed to ``collect(members=...)`` so a replica
    that left the fleet drops out of the merged view (and its pinned
    histogram window out of merged quantiles) immediately instead of
    lingering until ``max_age_s``.

    Derived series written per tick:

    * ``fleet/coord_up``             1.0 / 0.0 (collect round-trip ok)
    * ``fleet/replicas_publishing``  publishers seen this tick
    * ``fleet/max_publish_age_s``    staleness of the oldest publisher
    * ``fleet/kv_free_frac``         merged kv free/(free+used)
    * ``fleet/tier_headroom_frac``   1 - tier_bytes/tier_budget_bytes
    """

    def __init__(self, tsdb: TSDB, *, client=None, namespace: str = "fleet",
                 registry=None, alerts=None, interval_s: float = 1.0,
                 max_age_s: float | None = 10.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.tsdb = tsdb
        self.client = client
        self.namespace = namespace
        self.registry = registry
        self.alerts = alerts
        self.interval_s = float(interval_s)
        self.max_age_s = max_age_s
        self._clock = clock
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.ticks = 0

    # membership: ranks currently registered under {ns}/replica/*
    def members(self) -> set[int] | None:
        if self.client is None:
            return None
        prefix = f"{self.namespace}/replica/"
        ranks: set[int] = set()
        found = False
        for key in self.client.keys(prefix):
            found = True
            try:
                raw = self.client.get(key)
                if raw is None:
                    continue
                info = (json.loads(raw.decode())
                        if isinstance(raw, (bytes, bytearray)) else raw)
                ranks.add(int(info.get("rank")))
            except (TypeError, ValueError, AttributeError):
                continue
        return ranks if found else None

    def tick(self, now: float | None = None) -> dict:
        """One scrape.  Never raises on coordinator trouble — that is
        itself a signal (``fleet/coord_up`` -> 0)."""
        from tpudist_torch.obs.aggregate import collect, merge_snapshots

        now = self._clock() if now is None else now
        self.ticks += 1
        out: dict[str, Any] = {"t": now, "coord_up": None, "publishers": 0}
        if self.registry is not None:
            self.tsdb.scrape(self.registry.snapshot(), t=now)
        if self.client is not None:
            try:
                members = self.members()
                snaps = collect(self.client, f"{self.namespace}/metrics",
                                max_age_s=self.max_age_s, members=members)
                merged = merge_snapshots(snaps)
                self.tsdb.scrape(merged, t=now)
                self._derived(merged, snaps, now)
                out["coord_up"] = True
                out["publishers"] = len(snaps)
            except (ConnectionError, OSError, TimeoutError):
                out["coord_up"] = False
            self.tsdb.record("fleet/coord_up",
                             1.0 if out["coord_up"] else 0.0, t=now)
        if self.alerts is not None:
            out["transitions"] = self.alerts.evaluate(now)
        stats = self.tsdb.stats()
        out["series"] = stats["series"]
        out["approx_bytes"] = stats["approx_bytes"]
        return out

    def _derived(self, merged: dict, snaps: dict, now: float) -> None:
        gauges = merged.get("gauges") or {}

        def g(name):
            e = gauges.get(name)
            return None if e is None else e.get("value")

        self.tsdb.record("fleet/replicas_publishing", float(len(snaps)),
                         t=now)
        ages = [s.get("age_s") for s in snaps.values()
                if s.get("age_s") is not None]
        if ages:
            self.tsdb.record("fleet/max_publish_age_s", max(ages), t=now)
        free, used = g("serve/kv_blocks_free"), g("serve/kv_blocks_used")
        if free is not None and used is not None and free + used > 0:
            self.tsdb.record("fleet/kv_free_frac", free / (free + used),
                             t=now)
        tb, budget = g("serve/tier_bytes"), g("serve/tier_budget_bytes")
        if tb is not None and budget:
            self.tsdb.record("fleet/tier_headroom_frac",
                             max(0.0, 1.0 - tb / budget), t=now)

    # live-mode background loop (the sim calls tick() itself)
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tpudist-scraper")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - scraping must not die
                pass
