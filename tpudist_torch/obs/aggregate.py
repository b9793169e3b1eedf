"""Cross-host aggregation over the coord KV service
(counterpart of :mod:`tpudist.obs.aggregate`).

Each worker periodically publishes its registry snapshot as JSON under
``{namespace}/{rank}`` through :class:`tpudist_torch.runtime.coord.CoordClient`
(set is last-write-wins, so a slow worker's stale snapshot is simply
replaced by its next publish).  Rank 0 — or any observer with a client —
collects every published snapshot and merges them into one cluster view:

* counters: sum across workers;
* gauges: sum across workers (queue depths and world sizes add; a
  consumer that wants one worker's value reads ``per_worker``);
* histograms: bucket-by-bucket count merge (the whole point of the
  log-bucket design — quantiles of the merged histogram are computed
  from merged counts, never averaged from per-worker quantiles).

Every merged entry carries ``per_worker`` ({rank: value/count}) so the
cluster view keeps per-host attribution for debugging skew.

This is pull-based pub/sub on a plain KV store: no new coord verbs, and
a worker that dies mid-round just stops refreshing its key.
"""

from __future__ import annotations

import json
import threading
import time

from tpudist_torch.runtime import faults

__all__ = ["MetricsPublisher", "collect", "merge_snapshots"]

DEFAULT_NAMESPACE = "obs/metrics"


class MetricsPublisher:
    """Publishes ``registry.snapshot()`` to the coord store, either on
    demand (:meth:`publish`) or on a background daemon thread every
    ``interval_s`` (:meth:`start` / :meth:`stop`).  The background thread
    takes its own client clone — CoordClient sockets are not shared
    across threads."""

    def __init__(self, client, rank: int, registry,
                 namespace: str = DEFAULT_NAMESPACE,
                 interval_s: float = 5.0) -> None:
        self._client = client
        self._rank = rank
        self._registry = registry
        self._namespace = namespace
        self._interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def key(self) -> str:
        return f"{self._namespace}/{self._rank}"

    def publish(self, client=None) -> dict:
        snap = self._registry.snapshot()
        snap["rank"] = self._rank
        # the staleness stamp: collect() ages each snapshot off this, so
        # consumers can drop (or the health plane can flag) leftovers
        # from ranks that died in a previous elastic round
        snap["published_at"] = time.time()
        # fault harness (TPUDIST_FAULT_PUBLISH_DROP): swallow the store
        # write while heartbeats keep flowing — the end-to-end shape of
        # a wedged obs plane, which the health monitor must classify
        # `stale` (not `lost`) and a router must NOT treat as a death
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
                    except Exception:
                        # the store may be tearing down; keep trying
                        # until stop() — observability must never take
                        # the worker down
                        pass
            finally:
                client.close()

        self._thread = threading.Thread(
            target=loop, name=f"obs-publish-r{self._rank}", daemon=True)
        self._thread.start()

    def stop(self, final_publish: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_publish:
            try:
                self.publish()
            except Exception:
                pass


def collect(client, namespace: str = DEFAULT_NAMESPACE,
            max_age_s: float | None = None,
            members: "set[int] | None" = None) -> dict[int, dict]:
    """Fetch every published snapshot: {rank: snapshot}.  Keys listed but
    deleted between list and get (a departing worker) are skipped.

    Each returned snapshot carries ``age_s`` — seconds since its
    ``published_at`` stamp (None for pre-stamp publishers).  With
    ``max_age_s``, snapshots older than that are DROPPED: a rank that
    died in a previous elastic round leaves its last snapshot in the KV
    store forever, and merging it would silently distort the cluster
    view.  The health plane collects WITHOUT a cutoff and classifies the
    stale ranks instead.

    ``members`` is the stronger, membership-based cutoff: when given
    (ranks currently registered in ``{ns}/replica/*``), snapshots from
    any OTHER rank are dropped regardless of age.  A publisher that
    departs mid-histogram-window otherwise leaves its last generation
    pinned in merged quantiles until ``max_age_s`` — up to an entire
    collection window of a dead replica's queue waits steering the
    autoscaler.  ``None`` means "no membership information", not "no
    members": collection stays age-based only."""
    out: dict[int, dict] = {}
    prefix = namespace + "/"
    now = time.time()
    for key in client.keys(prefix):
        if members is not None:
            try:
                if int(key[len(prefix):]) not in members:
                    continue
            except ValueError:
                continue
        raw = client.get(key)
        if raw is None:
            continue
        snap = json.loads(raw.decode("utf-8"))
        published = snap.get("published_at")
        age = (now - published) if published is not None else None
        snap["age_s"] = age
        if max_age_s is not None and age is not None and age > max_age_s:
            continue
        out[int(key[len(prefix):])] = snap
    return out


def _merge_hist(merged: dict, hist: dict, rank: int) -> None:
    if hist["growth"] != merged["growth"]:
        raise ValueError(
            f"cannot merge histograms with growth {hist['growth']} into "
            f"{merged['growth']}: bucket indices are incompatible")
    merged["count"] += hist["count"]
    merged["sum"] += hist["sum"]
    merged["zero"] += hist.get("zero", 0)
    for bound in ("min", "max"):
        vals = [v for v in (merged[bound], hist[bound]) if v is not None]
        merged[bound] = (min(vals) if bound == "min" else max(vals)) \
            if vals else None
    for idx, n in hist["buckets"].items():
        merged["buckets"][idx] = merged["buckets"].get(idx, 0) + n
    merged["per_worker"][str(rank)] = hist["count"]


def merge_snapshots(snapshots: dict[int, dict]) -> dict:
    """Merge per-worker snapshots into the cluster view (sum counters and
    gauges, merge histogram buckets), keeping ``per_worker`` attribution
    on every metric."""
    merged: dict = {"workers": sorted(snapshots),
                    "counters": {}, "gauges": {}, "histograms": {}}
    ages = {str(rank): snapshots[rank].get("age_s")
            for rank in sorted(snapshots)
            if "age_s" in snapshots[rank]}
    if ages:
        merged["ages"] = ages
    for rank in sorted(snapshots):
        snap = snapshots[rank]
        for kind in ("counters", "gauges"):
            for name, m in snap.get(kind, {}).items():
                slot = merged[kind].setdefault(
                    name, {"value": 0.0, "unit": m.get("unit", ""),
                           "per_worker": {}})
                if m["value"] is not None:
                    slot["value"] += m["value"]
                slot["per_worker"][str(rank)] = m["value"]
                if m.get("help") and "help" not in slot:
                    slot["help"] = m["help"]
        for name, h in snap.get("histograms", {}).items():
            slot = merged["histograms"].get(name)
            if slot is None:
                slot = merged["histograms"][name] = {
                    "unit": h.get("unit", ""), "growth": h["growth"],
                    "count": 0, "sum": 0.0, "min": None, "max": None,
                    "zero": 0, "buckets": {}, "per_worker": {}}
            if h.get("help") and "help" not in slot:
                slot["help"] = h["help"]
            _merge_hist(slot, h, rank)
    # canonical bucket order for stable JSON / prometheus output
    for h in merged["histograms"].values():
        h["buckets"] = {str(i): h["buckets"][str(i)]
                        for i in sorted(int(k) for k in h["buckets"])}
    return merged


def collect_and_merge(client, namespace: str = DEFAULT_NAMESPACE,
                      max_age_s: float | None = None) -> dict:
    """Rank 0's one-call cluster view; ``max_age_s`` drops dead ranks'
    leftover snapshots (see :func:`collect`)."""
    merged = merge_snapshots(collect(client, namespace,
                                     max_age_s=max_age_s))
    merged["time"] = time.time()
    return merged
