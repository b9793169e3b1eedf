"""Per-request distributed tracing: trace contexts, the request-event
(counterpart of :mod:`tpudist.obs.events`).
ring, fleet-wide timeline merge, and SLO burn-rate accounting.

The aggregate counters (``router/slo_shed``, ``serve/rejected``,
``autoscale/*``) answer "how many" but never "why was THIS request
slow/shed/duplicated" — the first operational question at serving
scale.  This module is the per-request answer:

* :class:`TraceContext` — trace id + parent span + enqueue timestamp,
  minted by the :class:`~tpudist_torch.runtime.router.Router` at submit.  It
  rides the existing request wire encoding into each replica's inbox,
  so one id follows a request across processes — including across a
  SIGKILL + redispatch (the router keys the context to its own request
  entry, which survives the death sweep).
* :class:`RequestEventLog` — a bounded ring (the
  :class:`~tpudist_torch.obs.spans.SpanTracer` discipline: deque + dropped
  counter + lock, host-only appends) of structured lifecycle events:
  enqueue, shed, dispatch, admit, segment, degrade_clamp, swap_pause,
  timeout, reroute, redispatch, done_commit, done.  Every event
  carries the trace id, a wall-clock stamp, and a per-process sequence
  number ``i`` so repeated publishes of the same ring merge without
  duplicates.
* :class:`EventPublisher` — the
  :class:`~tpudist_torch.obs.aggregate.MetricsPublisher` pattern applied to
  the event ring: each replica publishes its ring snapshot under
  ``{namespace}/{rank}``; :func:`collect_events` +
  :func:`merge_events` give rank 0 the fleet-wide, time-ordered
  decision log, and :func:`group_timelines` folds it into one causal
  timeline per trace id.  ``python -m tpudist_torch.obs.timeline`` renders
  those timelines (and exports Chrome-trace JSON).
* :class:`SLOTracker` — multi-window good/bad request accounting over
  the same completion events.  ``burn rate`` is the Google-SRE
  definition: the fraction of the error budget (1 - ``target``) the
  observed bad-request rate consumes — 1.0 burns the budget exactly at
  the window's pace, >>1 pages someone.  Rates are exported as
  registry gauges (``slo/burn_rate_{window}s``) so they flow through
  the existing publisher / Prometheus / ``/healthz`` paths, and the
  autoscaler reads them as scale-up pressure.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import uuid
from collections import deque
from typing import Any, Iterable

from tpudist_torch.runtime import faults

__all__ = [
    "EVENTS_SCHEMA",
    "EventPublisher",
    "RequestEventLog",
    "SLOTracker",
    "SLO_CLASSES",
    "TraceContext",
    "collect_events",
    "group_timelines",
    "is_complete",
    "merge_events",
    "slo_class",
    "timeline_for_rid",
]

EVENTS_SCHEMA = "tpudist.events/1"
DEFAULT_NAMESPACE = "obs/events"

# the terminal router-side kinds: a timeline ending in one of these is
# resolved (the request got exactly one Completion)
TERMINAL_KINDS = ("done", "shed", "timeout", "failed")

# completion reasons that count as GOOD service for SLO accounting;
# everything else (shed / timeout / failed / rejected / invalid) burns
# error budget
GOOD_REASONS = ("stop", "length")


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One request's distributed identity: the trace id every lifecycle
    event is keyed by, the parent span (for callers nesting requests
    under their own traces), and the router-side enqueue wall time."""

    trace_id: str
    parent: str | None = None
    enqueued_at: float | None = None

    @classmethod
    def mint(cls, key: Any = None,
             parent: str | None = None) -> "TraceContext":
        """A fresh context: the router's request key (readable) plus a
        random suffix (unique across router restarts, whose key
        sequences both start at 00000000)."""
        suffix = uuid.uuid4().hex[:12]
        tid = f"{key}-{suffix}" if key is not None else suffix
        return cls(trace_id=tid, parent=parent, enqueued_at=time.time())

    def to_wire(self) -> dict:
        return {"id": self.trace_id, "parent": self.parent,
                "enq": self.enqueued_at}

    @classmethod
    def from_wire(cls, d: dict | None) -> "TraceContext | None":
        if not d or d.get("id") is None:
            return None
        return cls(trace_id=str(d["id"]), parent=d.get("parent"),
                   enqueued_at=d.get("enq"))


class RequestEventLog:
    """Bounded per-process ring of request lifecycle events.

    ``record`` is a lock-guarded host-only append (never a device
    sync); overflow evicts the OLDEST event and counts into
    :attr:`dropped` — the crash-adjacent tail is the valuable part,
    exactly the flight-recorder discipline.  Each event carries a
    per-process monotone ``i`` so a collector that sees the same ring
    published twice merges it without duplicates."""

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.dropped = 0
        self._seq = 0
        self._events: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, kind: str, *, trace: str | None = None,
               **fields) -> None:
        """Append one event: ``{"t", "i", "kind", "trace", **fields}``.
        Fields must be JSON-ready host values."""
        with self._lock:
            event = {"t": time.time(), "i": self._seq, "kind": kind,
                     "trace": trace, **fields}
            self._seq += 1
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(event)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def tail(self, n: int) -> list[dict]:
        with self._lock:
            return list(self._events)[-n:]

    def snapshot(self) -> dict:
        """The JSON wire document :class:`EventPublisher` publishes."""
        return {"schema": EVENTS_SCHEMA, "dropped": self.dropped,
                "events": self.events()}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._seq = 0


class EventPublisher:
    """Publishes the event-ring snapshot to the coord store under
    ``{namespace}/{rank}`` — on demand or on a background daemon thread
    (its own client clone; CoordClient sockets are not shared across
    threads).  Last-write-wins: each publish replaces the previous ring
    snapshot, and the per-event ``i`` keys dedup at merge time."""

    def __init__(self, client, rank: int, log: RequestEventLog,
                 namespace: str = DEFAULT_NAMESPACE,
                 interval_s: float = 5.0) -> None:
        self._client = client
        self._rank = rank
        self._log = log
        self._namespace = namespace
        self._interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def key(self) -> str:
        return f"{self._namespace}/{self._rank}"

    def publish(self, client=None) -> dict:
        snap = self._log.snapshot()
        snap["rank"] = self._rank
        snap["published_at"] = time.time()
        # same fault gate as the metrics publisher: a starved obs plane
        # starves the event plane too — they ride the same KV store
        if faults.drop_publish():
            return snap
        (client or self._client).set(
            self.key, json.dumps(snap).encode("utf-8"))
        return snap

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            client = self._client.clone()
            try:
                while not self._stop.wait(self._interval_s):
                    try:
                        self.publish(client)
                    except Exception:  # noqa: BLE001 - teardown races
                        pass
            finally:
                client.close()

        self._thread = threading.Thread(
            target=loop, name=f"obs-events-r{self._rank}", daemon=True)
        self._thread.start()

    def stop(self, final_publish: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_publish:
            try:
                self.publish()
            except Exception:  # noqa: BLE001
                pass


def collect_events(client, namespace: str = DEFAULT_NAMESPACE
                   ) -> dict[int, dict]:
    """Fetch every published event-ring snapshot: ``{rank: snapshot}``.
    Keys deleted between list and get (a departing worker) are
    skipped; each snapshot gains ``age_s`` off its publish stamp."""
    out: dict[int, dict] = {}
    prefix = namespace + "/"
    now = time.time()
    for key in client.keys(prefix):
        raw = client.get(key)
        if raw is None:
            continue
        snap = json.loads(raw.decode("utf-8"))
        published = snap.get("published_at")
        snap["age_s"] = (now - published) if published is not None else None
        out[int(key[len(prefix):])] = snap
    return out


def merge_events(collected: dict[int, dict] | None = None,
                 **local: dict) -> dict:
    """Merge per-process event rings into ONE time-ordered fleet log.

    ``collected`` is :func:`collect_events` output (replica rings keyed
    by rank); keyword snapshots add local rings under a named source
    (``merge_events(collected, router=obs.events.snapshot())``).  Each
    merged event gains ``src`` (its origin); duplicates — the same ring
    published more than once — dedup on ``(src, i)``.  The result is
    the ``tpudist.events/1`` document the timeline tool loads."""
    seen: set[tuple] = set()
    events: list[dict] = []
    dropped = 0
    sources: list[str] = []

    def fold(src: str, snap: dict) -> None:
        nonlocal dropped
        sources.append(src)
        dropped += int(snap.get("dropped", 0) or 0)
        for ev in snap.get("events", []):
            dk = (src, ev.get("i"))
            if ev.get("i") is not None and dk in seen:
                continue
            seen.add(dk)
            events.append({**ev, "src": src})

    for rank in sorted(collected or {}):
        fold(f"r{rank}", (collected or {})[rank])
    for name, snap in sorted(local.items()):
        fold(name, snap)
    # wall-clock order; per-source sequence breaks same-millisecond ties
    events.sort(key=lambda e: (e.get("t", 0.0), e.get("src", ""),
                               e.get("i", 0)))
    return {"schema": EVENTS_SCHEMA, "sources": sources,
            "dropped": dropped, "events": events}


def group_timelines(events: Iterable[dict]) -> dict[str, list[dict]]:
    """Per-trace causal timelines: ``{trace_id: [events, time-ordered]}``.
    Trace-less fleet events (swaps, etc.) are grouped under ``None``."""
    out: dict[str, list[dict]] = {}
    for ev in events:
        out.setdefault(ev.get("trace"), []).append(ev)
    for tl in out.values():
        tl.sort(key=lambda e: (e.get("t", 0.0), e.get("src", ""),
                               e.get("i", 0)))
    return out


def timeline_for_rid(timelines: dict[str, list[dict]],
                     rid: Any) -> list[dict] | None:
    """The timeline whose router ``enqueue`` event carries this caller
    rid (the NEWEST enqueue wins when a rid was reused across runs)."""
    best, best_t = None, None
    for tid, tl in timelines.items():
        if tid is None:
            continue
        for ev in tl:
            if ev.get("kind") == "enqueue" and ev.get("rid") == str(rid):
                if best_t is None or ev["t"] > best_t:
                    best, best_t = tl, ev["t"]
                break
    return best


def is_complete(timeline: list[dict] | None) -> bool:
    """Does this timeline tell the whole story — enqueue first, a
    terminal event last, and (for served requests) one fresh dispatch
    per death-redispatch / rejection-reroute, so there is no gap where
    the request was in flight with no recorded owner?"""
    if not timeline:
        return False
    kinds = [e.get("kind") for e in timeline]
    if kinds[0] != "enqueue":
        return False
    term = kinds[-1]
    if term in ("shed", "timeout", "failed"):
        return True    # resolved without (successful) service
    if term != "done":
        return False
    n_dispatch = kinds.count("dispatch")
    n_again = kinds.count("redispatch") + kinds.count("reroute")
    return n_dispatch >= n_again + 1


SLO_CLASSES = ("best_effort", "priority")


def slo_class(priority: int | None) -> str:
    """The SLO accounting class for a request priority: paying traffic
    (``priority > 0``) and best-effort get separate error budgets."""
    return "priority" if priority is not None and priority > 0 \
        else "best_effort"


class SLOTracker:
    """Multi-window good/bad request counts and burn rates, split by
    priority class.

    ``observe(reason, priority=...)`` classifies one completion
    (``stop``/``length`` are good; shed/timeout/failed/rejected/invalid
    burn budget) under its class (:func:`slo_class`), prunes
    observations older than the longest window, and refreshes the
    per-window gauges:

    * ``slo/good`` / ``slo/bad`` — lifetime counters (all classes);
    * ``slo/good~class={cls}`` / ``slo/bad~class={cls}`` — per-class
      lifetime counters (the ``~class=`` suffix renders as a
      ``{class="..."}`` label in the Prometheus exporter);
    * ``slo/burn_rate_{W}s`` — per window W, the bad fraction over the
      last W seconds divided by the error budget ``1 - target``;
    * ``slo/burn_rate_{W}s~class={cls}`` — the same, per class, so
      best-effort sheds under degradation cannot mask (or masquerade
      as) priority-traffic budget burn.

    Registering the gauges on a :class:`~tpudist_torch.obs.registry
    .MetricRegistry` makes the rates ride every existing export path
    (publisher -> merge, Prometheus text, ``/metrics``) for free."""

    def __init__(self, registry=None, *, target: float = 0.99,
                 windows: tuple[float, ...] = (60.0, 300.0),
                 clock=time.time) -> None:
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if not windows or any(w <= 0 for w in windows):
            raise ValueError(f"windows must be positive, got {windows}")
        self.target = float(target)
        self.windows = tuple(sorted(float(w) for w in windows))
        self._budget = 1.0 - self.target
        self._clock = clock
        self._lock = threading.Lock()
        self._obs: deque[tuple[float, bool, str]] = deque()
        self._registry = registry
        self._good = self._bad = None
        self._cls_counters: dict[tuple[str, bool], Any] = {}
        self._gauges: dict[float, Any] = {}
        self._cls_gauges: dict[tuple[float, str], Any] = {}
        if registry is not None:
            self._good = registry.counter(
                "slo/good", unit="reqs",
                help="Requests completed within SLO (stop/length)")
            self._bad = registry.counter(
                "slo/bad", unit="reqs",
                help="Requests that burned error budget "
                     "(shed/timeout/failed/rejected/invalid)")
            for cls in SLO_CLASSES:
                self._cls_counters[(cls, True)] = registry.counter(
                    f"slo/good~class={cls}", unit="reqs",
                    help=f"In-SLO completions of {cls} traffic")
                self._cls_counters[(cls, False)] = registry.counter(
                    f"slo/bad~class={cls}", unit="reqs",
                    help=f"Budget-burning completions of {cls} traffic")
            for w in self.windows:
                self._gauges[w] = registry.gauge(
                    f"slo/burn_rate_{int(w)}s", unit="ratio",
                    help=f"Error-budget burn rate over the last {int(w)}s "
                         f"(bad fraction / {self._budget:.3g} budget)")
                for cls in SLO_CLASSES:
                    self._cls_gauges[(w, cls)] = registry.gauge(
                        f"slo/burn_rate_{int(w)}s~class={cls}",
                        unit="ratio",
                        help=f"{cls} error-budget burn rate over the "
                             f"last {int(w)}s")

    def observe(self, reason: str | None = None, *,
                good: bool | None = None, priority: int = 0) -> None:
        """Record one completed request (by Completion ``reason``, or
        an explicit ``good=`` override) under its priority class and
        refresh the gauges."""
        if good is None:
            good = reason in GOOD_REASONS
        cls = slo_class(priority)
        now = self._clock()
        with self._lock:
            self._obs.append((now, bool(good), cls))
            horizon = now - self.windows[-1]
            while self._obs and self._obs[0][0] < horizon:
                self._obs.popleft()
        if self._good is not None:
            (self._good if good else self._bad).inc()
            self._cls_counters[(cls, bool(good))].inc()
        self._refresh_gauges()

    def _refresh_gauges(self) -> None:
        """Gauges mirror :meth:`burn_rates`, except a window with zero
        traffic reads ABSENT (``Gauge.clear``), not 0.0: a time-series
        consumer averaging/alerting over the gauge must not dilute real
        burn with idle-window zeros.  The method API keeps returning
        0.0 (no evidence is not a breach for control loops)."""
        for w in self.windows:
            g = self._gauges.get(w)
            if g is not None:
                good, bad = self.counts(w)
                if good + bad:
                    g.set((bad / (good + bad)) / self._budget)
                else:
                    g.clear()
        for c in SLO_CLASSES:
            for w in self.windows:
                g = self._cls_gauges.get((w, c))
                if g is None:
                    continue
                good, bad = self.counts(w, cls=c)
                if good + bad:
                    g.set((bad / (good + bad)) / self._budget)
                else:
                    g.clear()

    def counts(self, window_s: float,
               cls: str | None = None) -> tuple[int, int]:
        """(good, bad) over the trailing ``window_s`` seconds — all
        classes, or one class with ``cls=``."""
        cutoff = self._clock() - window_s
        with self._lock:
            good = sum(1 for t, g, c in self._obs
                       if t >= cutoff and g and (cls is None or c == cls))
            bad = sum(1 for t, g, c in self._obs
                      if t >= cutoff and not g
                      and (cls is None or c == cls))
        return good, bad

    def burn_rates(self, cls: str | None = None) -> dict[float, float]:
        """{window_s: burn rate} — 0.0 for a window with no traffic
        (no evidence is not a breach).  ``cls`` narrows to one
        priority class; default is the aggregate."""
        out: dict[float, float] = {}
        for w in self.windows:
            good, bad = self.counts(w, cls=cls)
            total = good + bad
            out[w] = (bad / total) / self._budget if total else 0.0
        return out

    def clear(self) -> None:
        with self._lock:
            self._obs.clear()
        # burn gauges go back to absent too — a fresh run (each sim
        # scenario clears the tracker) must not scrape the previous
        # run's final burn rate as if it were current
        self._refresh_gauges()
