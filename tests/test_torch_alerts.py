"""tpudist_torch.obs.alerts against the JAX package's ``tpudist.obs.alerts``.

* The shipped rule sets — ``default_rules()`` and ``autoscale_rules(cfg)``
  for the same configs — have equal ``to_dict`` docs and equal
  ``rules_hash`` (the hash a run's records pin, so it must not drift
  between the packages).
* ``load_rules`` rejects the same bad docs with the same error.
* One scripted breach and recovery over both TSDBs gives the same
  pending -> firing -> resolved transitions and the same ``to_doc``.
* ``MetricsServer(alerts=, tsdb=)`` serves ``/alerts`` and ``/tsdb``.
* ``Router(alerts=)`` arms the admission clamp on a firing
  ``FleetDegraded``, dispatching what tpudist's router dispatches."""

import importlib
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpudist_torch.runtime import wire as twire

talerts = importlib.import_module("tpudist_torch.obs.alerts")
ttsdb = importlib.import_module("tpudist_torch.obs.tsdb")


@pytest.fixture(scope="module")
def ref():
    return {"alerts": importlib.import_module("tpudist.obs.alerts"),
            "tsdb": importlib.import_module("tpudist.obs.tsdb"),
            "autoscaler": importlib.import_module(
                "tpudist.runtime.autoscaler")}


CFGS = [{}, {"target_wait_s": 0.005, "low_wait_s": 0.001},
        {"max_burn_rate": 2.0, "min_kv_free_frac": 0.2,
         "min_tier_headroom_frac": 0.15, "target_wait_s": 1.5}]


def test_default_rules_equal_docs_and_hash(ref):
    a, b = ref["alerts"].default_rules(), talerts.default_rules()
    assert [r.to_dict() for r in a] == [r.to_dict() for r in b]
    assert ref["alerts"].rules_hash(a) == talerts.rules_hash(b)
    # order-insensitive, and any edit drifts the hash
    assert talerts.rules_hash(tuple(reversed(b))) == talerts.rules_hash(b)
    edited = [dict(r.to_dict()) for r in b]
    edited[0]["threshold"] = 0.25
    assert (talerts.rules_hash(talerts.load_rules(edited))
            == ref["alerts"].rules_hash(ref["alerts"].load_rules(edited))
            != talerts.rules_hash(b))


@pytest.mark.parametrize("cfg", CFGS, ids=["defaults", "example",
                                           "every_signal"])
def test_autoscale_rules_equal(ref, cfg):
    from tpudist_torch.runtime.autoscaler import AutoscaleConfig

    a = ref["alerts"].autoscale_rules(
        ref["autoscaler"].AutoscaleConfig(**cfg))
    b = talerts.autoscale_rules(AutoscaleConfig(**cfg))
    assert [r.to_dict() for r in a] == [r.to_dict() for r in b]
    assert ref["alerts"].rules_hash(a) == talerts.rules_hash(b)


GOOD = {"name": "R", "metric": "m", "op": ">", "threshold": 1}
BAD = [
    ({**GOOD, "treshold": 1}, "unknown keys"),
    ({k: v for k, v in GOOD.items() if k != "op"}, "missing"),
    ({**GOOD, "fn": "median"}, "unknown fn"),
    ({**GOOD, "op": "between"}, "unknown op"),
    ({**GOOD, "severity": "critical"}, "unknown severity"),
    ({**GOOD, "fn": "rate"}, "needs window_s"),
    ({**GOOD, "fn": "quantile_over_time", "window_s": 5}, "needs q"),
    ({**GOOD, "for_s": -1}, "for_s"),
    ({**GOOD, "name": ""}, "name and metric"),
    ([GOOD, GOOD], "duplicate"),
    ("not json at all [", None),
]


@pytest.mark.parametrize("doc,match", BAD,
                         ids=[f"bad{i}" for i in range(len(BAD))])
def test_load_rules_rejects_the_same_docs(ref, doc, match, tmp_path):
    if isinstance(doc, str):                 # a path to unparsable JSON
        path = tmp_path / "rules.json"
        path.write_text(doc)
        doc = str(path)
    elif isinstance(doc, dict):
        doc = json.dumps({"rules": [doc]})   # the JSON-doc shape
    errs = []
    for mod in (ref["alerts"], talerts):
        with pytest.raises(Exception) as ei:
            mod.load_rules(doc)
        errs.append((type(ei.value), str(ei.value)))
    assert errs[0] == errs[1]
    if match is not None:
        assert match in errs[1][1]


def _lifecycle(mods, rules, script, registry=None):
    tsdb_mod, alerts_mod = mods
    clock = {"t": 0.0}
    db = tsdb_mod.TSDB(clock=lambda: clock["t"], resolution_s=0.25)
    mgr = alerts_mod.AlertManager(db, alerts_mod.load_rules(rules),
                                  clock=lambda: clock["t"],
                                  registry=registry)
    trace = []
    for t, samples in script:
        clock["t"] = t
        for name, v in samples.items():
            db.record(name, v, t=t)
        trace.append((mgr.evaluate(), [a["rule"] for a in mgr.firing()],
                      mgr.is_firing("QueueHot", "KVLow")))
    return trace, mgr.to_doc(), db.to_doc()


def test_breach_and_recovery_same_lifecycle(ref):
    """Queue depth breaches and recovers, KV headroom dips past a hold,
    a counter spikes (delta) and a rate crosses: each rule's pending /
    firing / resolved transitions are the same, tick for tick."""
    rules = [
        {"name": "QueueHot", "metric": "q", "fn": "last", "window_s": 3,
         "op": ">", "threshold": 5, "for_s": 1.0, "severity": "page"},
        {"name": "KVLow", "metric": "kv", "fn": "avg_over_time",
         "window_s": 2, "op": "<", "threshold": 0.2, "for_s": 0.5},
        {"name": "Deaths", "metric": "deaths", "fn": "delta",
         "window_s": 2, "op": ">", "threshold": 0},
        {"name": "Fast", "metric": "deaths", "fn": "rate", "window_s": 3,
         "op": ">=", "threshold": 0.5, "severity": "info"},
        {"name": "P90", "metric": "q", "fn": "quantile_over_time",
         "q": 0.9, "window_s": 4, "op": ">", "threshold": 7,
         "labels": {"team": "serve"}, "help": "tail"},
    ]
    rng = np.random.default_rng(3)
    script, deaths = [], 0.0
    for i in range(40):
        t = 0.25 * i
        q = 9.0 if 8 <= i < 20 else float(rng.integers(0, 4))
        kv = 0.1 if 14 <= i < 30 else 0.5 + float(rng.random()) / 4
        deaths += 1.0 if i in (10, 11, 25) else 0.0
        script.append((t, {"q": q, "kv": kv, "deaths": deaths}))
    reg_ref = importlib.import_module("tpudist.obs.registry")
    reg_port = importlib.import_module("tpudist_torch.obs.registry")
    ra, rb = reg_ref.MetricRegistry(), reg_port.MetricRegistry()
    a = _lifecycle((ref["tsdb"], ref["alerts"]), rules, script, ra)
    b = _lifecycle((ttsdb, talerts), rules, script, rb)
    assert a == b
    trace, doc, _ = b
    events = [e["event"] for transitions, _, _ in trace
              for e in transitions if e["rule"] == "QueueHot"]
    assert events == ["pending", "firing", "resolved"]
    assert doc["fired_ever"] == ["Deaths", "Fast", "KVLow", "P90",
                                  "QueueHot"]
    assert ra.snapshot()["counters"] == rb.snapshot()["counters"]
    assert ra.snapshot()["gauges"] == rb.snapshot()["gauges"]


def test_metrics_server_alerts_and_tsdb():
    from tpudist_torch.obs.export import MetricsServer
    from tpudist_torch.obs.registry import MetricRegistry

    reg = MetricRegistry()
    reg.counter("hits").inc()
    db = ttsdb.TSDB(clock=lambda: 0.0)
    db.record("serve/queue_depth", 2.0, t=0.0)
    db.record("other/series", 1.0, t=0.0)
    mgr = talerts.AlertManager(db, [talerts.AlertRule(
        name="R", metric="serve/queue_depth", op=">", threshold=1.0)],
        clock=lambda: 0.0)
    mgr.evaluate(0.0)
    srv = MetricsServer(reg, alerts=mgr, tsdb=db)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        alerts = json.loads(urllib.request.urlopen(
            f"{base}/alerts", timeout=5).read())
        assert alerts == json.loads(json.dumps(mgr.to_doc()))
        assert alerts["schema"] == "tpudist.alerts/1"
        assert alerts["fired_ever"] == ["R"]
        doc = json.loads(urllib.request.urlopen(
            f"{base}/tsdb?match=queue", timeout=5).read())
        assert doc == json.loads(json.dumps(db.to_doc(match="queue")))
        assert list(doc["series"]) == ["serve/queue_depth"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=5)
        paths = json.loads(ei.value.read())["paths"]
        assert "/alerts" in paths and "/tsdb" in paths
    finally:
        srv.close()


NS = "fleet"


class OneReplica:
    """An in-memory store with one registered replica that answers every
    dispatched request with ``max_new_tokens`` tokens on the next poll;
    it never advertises degraded service.  Router-side writes are
    logged."""

    def __init__(self):
        self.kv = {f"{NS}/replica/r0": json.dumps(
            {"replica_id": "r0", "rank": 0, "pool": "default",
             "role": "both"}).encode()}
        self.counters: dict[str, int] = {}
        self.log: list = []

    def keys(self, prefix=""):
        return sorted(k for k in self.kv if k.startswith(prefix))

    def get(self, key):
        return self.kv.get(key)

    def set(self, key, value):
        value = value if isinstance(value, bytes) else value.encode()
        self.log.append(("set", key))
        self.kv[key] = value

    def delete(self, key):
        self.log.append(("delete", key))
        self.kv.pop(key, None)

    def add(self, key, delta):
        self.counters[key] = self.counters.get(key, 0) + int(delta)
        return self.counters[key]

    def live(self):
        return {f"{NS}:r0"}

    def step(self):
        inbox = f"{NS}/inbox/r0/"
        for key in [k for k in self.kv if k.startswith(inbox)]:
            doc = twire.decode_record(self.kv.pop(key))
            k = key[len(inbox):]
            self.kv[f"{NS}/done/{k}"] = twire.encode_record(
                "completion", {"key": k, "replica": "r0", "reason": "length",
                               "tokens": list(range(doc["max_new_tokens"]))})


def _route(pkg, degraded_alert: bool):
    if pkg == "tpudist":
        router_mod = importlib.import_module("tpudist.runtime.router")
        serving = importlib.import_module("tpudist.models.serving")
        tsdb_mod = importlib.import_module("tpudist.obs.tsdb")
        alerts_mod = importlib.import_module("tpudist.obs.alerts")
    else:
        router_mod = importlib.import_module("tpudist_torch.runtime.router")
        serving = importlib.import_module("tpudist_torch.models.serving")
        tsdb_mod, alerts_mod = ttsdb, talerts
    mgr = None
    if degraded_alert:
        db = tsdb_mod.TSDB(clock=lambda: 0.0)
        db.record("serve/degraded", 1.0, t=0.0)
        mgr = alerts_mod.AlertManager(db, alerts_mod.default_rules(),
                                      clock=lambda: 0.0)
        mgr.evaluate(0.0)
        assert mgr.is_firing("FleetDegraded")
    fc = OneReplica()
    t = [0.0]

    def sleeper(dt):
        t[0] += dt
        fc.step()

    router = router_mod.Router(fc, namespace=NS, poll_s=0.05,
                               degrade_max_new=3, alerts=mgr,
                               clock=lambda: t[0],
                               wall=lambda: 1000.0 + t[0], sleeper=sleeper)
    reqs = [serving.Request(np.arange(4 + i, dtype=np.int32), 6 + i,
                            rid=f"q{i}", priority=i % 2) for i in range(4)]
    comps = router.run(reqs, timeout_s=30.0)
    return ({c.rid: len(c.tokens) for c in comps},
            [op for op in fc.log if "/journal/" not in op[1]])


@pytest.mark.parametrize("degraded_alert", [False, True],
                         ids=["no_alert", "fleet_degraded_firing"])
def test_router_clamps_on_firing_fleet_degraded(degraded_alert):
    got, ops = _route("tpudist_torch", degraded_alert)
    want, ref_ops = _route("tpudist", degraded_alert)
    assert got == want and ops == ref_ops
    for i in range(4):
        budget = 6 + i
        if degraded_alert and i % 2 == 0:    # best-effort: clamped to 3
            budget = 3
        assert got[f"q{i}"] == budget
