"""tpudist_torch.obs.tsdb against the JAX package's ``tpudist.obs.tsdb``.

The same seeded sequence of registry snapshots, scraped at the same
injected clock into both stores, must leave the same points behind —
through the downsample fold and the byte-budget trim, which decide which
points survive — so ``to_doc()`` and ``stats()`` are equal key for key
and every query (``latest``, ``delta``, ``rate``, the ``*_over_time``
family) gives the same number: exactly, or within 1e-12 where floats are
summed.  ``FleetScraper.tick`` over a fake coordinator gives the same
``fleet/*`` series."""

import importlib
import json
import time

import numpy as np
import pytest

ttsdb = importlib.import_module("tpudist_torch.obs.tsdb")
treg = importlib.import_module("tpudist_torch.obs.registry")


@pytest.fixture(scope="module")
def ref():
    return {m: importlib.import_module(f"tpudist.obs.{m}")
            for m in ("tsdb", "registry")}


def _snapshots(seed: int, n: int, n_series: int = 6) -> list[dict]:
    """Registry snapshots of a seeded workload: counters that grow (and
    one that restarts), gauges (one labelled per pool), and a labelled
    histogram, recorded through tpudist's registry (the doc shape both
    stores scrape; the port's registry is held to it elsewhere)."""
    reg_mod = importlib.import_module("tpudist.obs.registry")
    rng = np.random.default_rng(seed)
    out = []
    total = 0.0
    for i in range(n):
        reg = reg_mod.MetricRegistry()
        total += float(rng.integers(0, 20))
        reg.counter("serve/requests").inc(total)
        reg.counter("serve/restarts").inc(float(i % 7))    # resets at 7
        for s in range(n_series):
            reg.gauge(f"serve/kv_free~pool=p{s}").set(
                float(rng.random()))
        reg.gauge("serve/queue_depth").set(float(rng.integers(0, 9)))
        h = reg.histogram("serve/queue_wait_s~pool=decode", unit="s")
        for v in rng.exponential(0.2, size=int(rng.integers(0, 12))):
            h.record(float(v))
        out.append(reg.snapshot())
    return out


def _pair(ref, clock, **kw):
    return (ref["tsdb"].TSDB(clock=lambda: clock["t"], **kw),
            ttsdb.TSDB(clock=lambda: clock["t"], **kw))


def _scrape_both(dbs, snaps, clock, dt):
    for snap in snaps:
        clock["t"] += dt
        for db in dbs:
            db.scrape(json.loads(json.dumps(snap)))


def _close(a, b):
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= 1e-12 * max(1.0, abs(a), abs(b))


QUERIES = [("latest", "serve/queue_depth", {}),
           ("latest", "serve/kv_free", {"labels": {"pool": "p2"}}),
           ("delta", "serve/requests", {"window_s": 30.0}),
           ("rate", "serve/requests", {"window_s": 30.0}),
           ("rate", "serve/restarts", {"window_s": 60.0}),
           ("delta", "serve/kv_free", {"window_s": 20.0}),
           ("avg_over_time", "serve/kv_free", {"window_s": 50.0}),
           ("max_over_time", "serve/queue_wait_s/p99", {"window_s": 90.0}),
           ("min_over_time", "serve/queue_depth", {"window_s": 40.0}),
           ("quantile_over_time", "serve/queue_wait_s/p50",
            {"q": 0.9, "window_s": 120.0}),
           ("quantile_over_time", "serve/kv_free", {"q": 0.5,
                                                    "window_s": 200.0})]


def _query(db, fn, name, kw):
    kw = dict(kw)
    if fn == "latest":
        return db.latest(name, labels=kw.get("labels"))
    if fn == "quantile_over_time":
        return db.quantile_over_time(name, kw["q"], kw["window_s"])
    return getattr(db, fn)(name, kw["window_s"])


@pytest.mark.parametrize("case", [
    # (seed, scrapes, seconds apart, store knobs)
    (0, 40, 1.0, {}),
    (1, 90, 2.5, {"downsample_after_s": 30.0,
                  "downsample_resolution_s": 10.0, "retention_s": 150.0}),
    (2, 60, 0.4, {"resolution_s": 1.0}),          # last-write-wins buckets
    (3, 80, 3.0, {"byte_budget": 48 * 1024,       # past the byte budget
                  "downsample_after_s": 20.0}),
    (4, 30, 1.0, {"byte_budget": 8 * 1024}),      # evicts whole series
], ids=["plain", "downsampled", "coarse_resolution", "budget_trim",
        "budget_evict"])
def test_same_snapshots_same_points(ref, case):
    seed, n, dt, kw = case
    clock = {"t": 1000.0}
    dbs = _pair(ref, clock, **kw)
    _scrape_both(dbs, _snapshots(seed, n, n_series=12 if seed >= 3 else 6),
                 clock, dt)
    a, b = dbs
    assert a.stats() == b.stats()
    assert a.to_doc() == b.to_doc()
    assert a.to_doc(match="kv_free", window_s=30.0) \
        == b.to_doc(match="kv_free", window_s=30.0)
    assert a.series_names() == b.series_names()
    assert a.approx_bytes() == b.approx_bytes() <= a.byte_budget
    for fn, name, qkw in QUERIES:
        va, vb = _query(a, fn, name, qkw), _query(b, fn, name, qkw)
        assert _close(va, vb), (fn, name, va, vb)
    if kw.get("byte_budget"):
        assert b.stats()["dropped_points"] > 0


def test_record_nan_none_and_select(ref):
    clock = {"t": 0.0}
    dbs = _pair(ref, clock, resolution_s=0.001)
    for i, v in enumerate([1.0, None, float("nan"), 3.0, 2.0]):
        for db in dbs:
            db.record("x~a=1", v, t=float(i), kind="counter")
            db.record("x~a=2", 2 * i, t=float(i))
    clock["t"] = 4.0
    a, b = dbs
    assert [s.name for s in a.select("x", {"a": "1"})] \
        == [s.name for s in b.select("x", {"a": "1"})] == ["x~a=1"]
    pa, pb = a.select("x", {"a": "1"})[0], b.select("x", {"a": "1"})[0]
    assert str(pa.points()) == str(pb.points())   # NaN kept alike
    assert a.rate("x", 10.0, {"a": "2"}) == b.rate("x", 10.0, {"a": "2"})
    assert a.delta("x", 10.0) == b.delta("x", 10.0) or (
        np.isnan(a.delta("x", 10.0)) and np.isnan(b.delta("x", 10.0)))


def test_from_env(ref):
    env = {"TPUDIST_TSDB_RETENTION_S": "90", "TPUDIST_TSDB_RESOLUTION_S":
           "0.5", "TPUDIST_TSDB_BYTE_BUDGET": "65536",
           "TPUDIST_TSDB_DOWNSAMPLE_AFTER_S": "bogus"}
    a = ref["tsdb"].TSDB.from_env(env)
    b = ttsdb.TSDB.from_env(env)
    assert a.stats() == b.stats()
    assert (a.downsample_after_s, a.downsample_resolution_s) \
        == (b.downsample_after_s, b.downsample_resolution_s)


class FakeCoord:
    """The verbs FleetScraper and ``collect`` reach for; with ``down``
    set every call raises ConnectionError (a coord outage)."""

    def __init__(self):
        self.kv: dict[str, bytes] = {}
        self.down = False

    def _check(self):
        if self.down:
            raise ConnectionError("coord down")

    def keys(self, prefix=""):
        self._check()
        return sorted(k for k in self.kv if k.startswith(prefix))

    def get(self, key):
        self._check()
        return self.kv.get(key)


def _fleet_doc(rng, rank, published_at):
    reg = importlib.import_module("tpudist.obs.registry").MetricRegistry()
    reg.gauge("serve/kv_blocks_free").set(float(rng.integers(0, 50)))
    reg.gauge("serve/kv_blocks_used").set(float(rng.integers(1, 50)))
    reg.gauge("serve/tier_bytes").set(float(rng.integers(0, 1 << 20)))
    reg.gauge("serve/tier_budget_bytes").set(float(1 << 20))
    reg.gauge("serve/degraded").set(float(rng.random() < 0.2))
    h = reg.histogram("serve/queue_wait_s", unit="s")
    for v in rng.exponential(0.3, size=6):
        h.record(float(v))
    snap = reg.snapshot()
    snap["rank"] = rank
    snap["published_at"] = published_at
    return json.dumps(snap).encode()


def test_fleet_scraper_tick_same_series(ref, monkeypatch):
    """Both scrapers over equal fake coordinators: ranks 0 and 1
    registered, rank 9 publishing but not a member, an outage for two
    ticks; the ``fleet/*`` series (and everything merged) equal."""
    now = 5000.0
    monkeypatch.setattr(time, "time", lambda: now)
    clock = {"t": 0.0}
    dbs = _pair(ref, clock)
    coords = [FakeCoord(), FakeCoord()]
    scrapers = [mod.FleetScraper(db, client=fc, namespace="ns",
                                 clock=lambda: clock["t"])
                for mod, db, fc in zip((ref["tsdb"], ttsdb), dbs, coords)]
    rng = np.random.default_rng(7)
    for fc in coords:
        for rid, rank in (("r0", 0), ("r1", 1)):
            fc.kv[f"ns/replica/{rid}"] = json.dumps(
                {"replica_id": rid, "rank": rank}).encode()
    outs = [[], []]
    for tick in range(12):
        clock["t"] = float(tick)
        docs = {rank: _fleet_doc(rng, rank, now - 0.5 * rank)
                for rank in (0, 1, 9)}
        for i, fc in enumerate(coords):
            fc.down = tick in (5, 6)
            for rank, doc in docs.items():
                fc.kv[f"ns/metrics/{rank}"] = doc
            outs[i].append(scrapers[i].tick())
    assert outs[0] == outs[1]
    a, b = dbs
    assert a.to_doc() == b.to_doc()
    names = b.series_names()
    for name in ("fleet/coord_up", "fleet/replicas_publishing",
                 "fleet/max_publish_age_s", "fleet/kv_free_frac",
                 "fleet/tier_headroom_frac"):
        assert name in names
    assert b.min_over_time("fleet/coord_up", 100.0) == 0.0
    assert b.latest("fleet/replicas_publishing") == 2.0   # rank 9 not in
