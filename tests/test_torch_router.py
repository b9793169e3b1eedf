"""The port's serve fleet against the JAX package's.

* **Router decisions.**  ``tpudist_torch.runtime.router.Router`` and
  ``tpudist.runtime.router.Router`` are each driven over their own
  in-memory store (the ``FakeCoord`` pattern of ``tests/test_router.py``)
  by the same seeded scripted fleet, on one injected clock: replicas that
  answer, shed, report corrupt segments, flip bits in their commits, hand
  off to a decode pool, die and join.  Every write and delete each router
  makes to its store (inbox dispatches, journal records, sweeps, probes)
  must be the same, in the same order, as must the completions and the
  ``router/*`` counters.
* **Serving metrics.**  After the same workload, the ``serve/*`` counters
  of tpudist's ``ServeLoop`` and the port's are equal; timing histograms
  are compared by count.  At ``pipeline_depth=2`` the instrumented loop
  still makes no per-tick host read.

The live CPU fleets are in ``tests/test_torch_router_journal.py``."""

import importlib
import json
import time

import numpy as np
import pytest

from tpudist_torch import obs as tobs
from tpudist_torch.runtime import router as trouter
from tpudist_torch.runtime import wire as twire

NS = "fleet"


class FakeCoord:
    """In-memory store with an op log (router-side ops only: the
    scripted fleet writes through ``kv`` directly)."""

    def __init__(self):
        self.kv: dict[str, bytes] = {}
        self.live_set: set[str] = set()
        self.counters: dict[str, int] = {}
        self.log: list[tuple] = []

    def keys(self, prefix=""):
        return sorted(k for k in self.kv if k.startswith(prefix))

    def get(self, key):
        return self.kv.get(key)

    def set(self, key, value):
        value = value if isinstance(value, bytes) else value.encode()
        self.log.append(("set", key, value))
        self.kv[key] = value

    def delete(self, key):
        self.log.append(("delete", key, key in self.kv))
        self.kv.pop(key, None)

    def add(self, key, delta):
        self.counters[key] = self.counters.get(key, 0) + int(delta)
        self.log.append(("add", key, self.counters[key]))
        return self.counters[key]

    def live(self):
        return set(self.live_set)


def _tokens(prompt, n):
    return [int((sum(prompt) * 7 + 3 * j) % 61) for j in range(n)]


class ScriptedFleet:
    """Seeded replicas acting on a FakeCoord between router polls."""

    def __init__(self, fc: FakeCoord, seed: int, *, roles=None,
                 deaths=(), joins=(), p=None):
        self.fc = fc
        self.rng = np.random.default_rng(seed)
        self.tick = 0
        self.roles = dict(roles or {})
        self.deaths = dict(deaths)     # earliest tick -> rid
        self.joins = dict(joins)       # tick -> rid
        self.p = p or {"length": 0.5, "stop": 0.1, "rejected": 0.12,
                       "corrupt_segment": 0.06, "flip": 0.07,
                       "hold": 0.15}
        self.held: dict[str, tuple] = {}
        self.rejected: dict[str, int] = {}
        for rid in sorted(set(self.roles) - set(self.joins.values())):
            self._register(rid)

    def _register(self, rid):
        rank = int(rid[1:])
        self.fc.kv[f"{NS}/replica/{rid}"] = json.dumps(
            {"replica_id": rid, "rank": rank, "pool": "default",
             "role": self.roles.get(rid, "both"),
             "cache_layout": "paged", "kv_block_size": 16}).encode()
        self.fc.live_set.add(f"{NS}:{rid}")
        self.rejected[rid] = 0

    def live(self):
        return sorted(n.split(":", 1)[1] for n in self.fc.live_set)

    def step(self):
        self.tick += 1
        for at, rid in list(self.deaths.items()):
            # a death lands at its tick or, later, once the replica
            # holds work (so it always takes requests down with it)
            busy = (any(v[0] == rid for v in self.held.values())
                    or any(k.startswith(f"{NS}/inbox/{rid}/")
                           for k in self.fc.kv))
            if self.tick >= at and busy:
                self.fc.live_set.discard(f"{NS}:{rid}")
                del self.deaths[at]
        if self.tick in self.joins:
            self._register(self.joins[self.tick])
        rng = self.rng
        kinds = list(self.p)
        for rid in self.live():
            inbox = f"{NS}/inbox/{rid}/"
            for key in sorted(k for k in self.fc.kv if k.startswith(inbox)):
                raw = self.fc.kv.pop(key)
                doc = twire.decode_record(raw)
                k = key[len(inbox):]
                act = str(rng.choice(kinds, p=[self.p[x] for x in kinds]))
                if k.startswith("probe-"):
                    act = "length"
                elif (self.roles.get(rid) == "prefill"
                      and act in ("length", "stop")):
                    act = "handoff"
                self.held[k] = (rid, doc, self.tick + int(
                    rng.integers(0, 3)), act)
        for k in sorted(self.held):
            rid, doc, ready, act = self.held[k]
            if f"{NS}:{rid}" not in self.fc.live_set:
                del self.held[k]          # died with the work
                continue
            if ready > self.tick:
                continue
            if act == "hold":
                self.held[k] = (rid, doc, self.tick + 2, "length")
                continue
            del self.held[k]
            out = {"key": k, "tokens": [], "reason": act, "replica": rid}
            if act in ("length", "stop", "flip"):
                n = doc["max_new_tokens"] if act != "stop" else max(
                    1, doc["max_new_tokens"] // 2)
                out.update(tokens=_tokens(doc["prompt"], n),
                           reason="length" if act != "stop" else "stop")
            elif act == "handoff":
                ref = f"{NS}/kv/{k}"
                self.fc.kv[ref] = b"payload"
                out["handoff_ref"] = ref
            elif act == "rejected":
                self.rejected[rid] += 1
            frame = twire.encode_record("completion", out)
            if act == "flip":
                frame = frame[:-3] + bytes([frame[-3] ^ 8]) + frame[-2:]
            self.fc.kv[f"{NS}/done/{k}"] = frame
        for rid in self.live():
            rank = int(rid[1:])
            depth = sum(1 for v in self.held.values() if v[0] == rid)
            waits = rng.exponential(0.05 * (1 + rank), size=8)
            if rank == 2 and self.tick > 6:
                waits = waits + 40.0      # a replica whose queue blows SLOs
            snap = {"rank": rank, "published_at": time.time(),
                    "gauges": {
                        "serve/queue_depth": {"value": float(depth)},
                        "serve/kv_blocks_free": {
                            "value": float(rng.integers(10, 200))},
                        "serve/degraded": {
                            "value": float(self.tick % 9 == 0)}},
                    "counters": {"serve/rejected": {
                        "value": float(self.rejected[rid])}},
                    "histograms": {"serve/queue_wait_s":
                                   tobs.values_to_hist(waits.tolist())}}
            self.fc.kv[f"{NS}/metrics/{rank}"] = json.dumps(snap).encode()


def _requests(mod, seed, n, wall0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dl = None
        if rng.random() < 0.3:
            dl = wall0 + float(rng.choice([1.0, 30.0, 300.0]))
        out.append(mod.Request(
            rng.integers(0, 64, int(rng.integers(2, 12))).astype(np.int32),
            int(rng.integers(2, 9)), rid=f"q{i}", deadline_s=dl,
            priority=int(rng.integers(0, 2)),
            prefix_hash=(None if rng.random() < 0.5
                         else int(rng.integers(0, 3)))))
    return out


def _normalize(log):
    """Frames decoded, trace ids renamed by first appearance, trace
    enqueue stamps (wall clock at mint) dropped."""
    names: dict[str, str] = {}
    out = []
    for op, key, val in log:
        if op == "set":
            try:
                doc = twire.decode_record(val)
            except twire.WireError:
                doc = {"raw": val.hex()}
            tr = doc.get("trace") or (doc.get("req") or {}).get("trace")
            if isinstance(tr, dict):
                tr["id"] = names.setdefault(tr["id"], f"T{len(names)}")
                tr["enq"] = None
            val = doc
        out.append((op, key, val))
    return out


def _drive(pkg, seed, *, n_req, fleet_kw, router_kw):
    """One scripted run: (normalized store log, completions, counters
    moved, router event kinds)."""
    if pkg == "tpudist":
        mod = importlib.import_module("tpudist.runtime.router")
        serving = importlib.import_module("tpudist.models.serving")
        obs_mod = importlib.import_module("tpudist.obs")
    else:
        mod, obs_mod = trouter, tobs
        serving = importlib.import_module("tpudist_torch.models.serving")
    fc = FakeCoord()
    fleet = ScriptedFleet(fc, seed, **fleet_kw)
    t = [0.0]

    def sleeper(dt):
        t[0] += dt
        fleet.step()

    before = {k: v["value"] for k, v in
              obs_mod.snapshot()["counters"].items()}
    obs_mod.events.clear()
    kw = dict(router_kw)
    if "golden" in kw:
        prompt, n = kw.pop("golden")
        kw["golden_probe"] = mod.GoldenProbe(tuple(prompt),
                                             tuple(_tokens(prompt, n)))
    if "qcfg" in kw:
        kw["quarantine_config"] = mod.QuarantineConfig(**kw.pop("qcfg"))
    router = mod.Router(fc, namespace=NS, poll_s=0.05,
                        clock=lambda: t[0], wall=lambda: 1000.0 + t[0],
                        sleeper=sleeper, **kw)
    comps = router.run(_requests(serving, seed, n_req, 1000.0),
                       timeout_s=60.0)
    after = obs_mod.snapshot()["counters"]
    moved = {k: v["value"] - before.get(k, 0.0) for k, v in after.items()
             if k.startswith(("router/", "integrity/", "quarantine/",
                              "probe/"))
             and v["value"] - before.get(k, 0.0)}
    kinds = [(e["kind"], e.get("key"), e.get("replica"))
             for e in obs_mod.events.events()]
    return (_normalize(fc.log),
            [(c.rid, c.tokens.tolist(), c.reason) for c in comps],
            moved, kinds, router.quarantine.quarantined()
            if router.quarantine is not None else None)


SCRIPTS = {
    "unified": dict(
        n_req=24,
        fleet_kw=dict(roles={"r0": "both", "r1": "both", "r2": "both",
                             "r3": "both"},
                      deaths={3: "r1"}, joins={6: "r3"}),
        router_kw=dict(reject_backoff_s=0.2, degrade_max_new=4,
                       join_grace_s=5.0, lost_after_s=30.0,
                       stale_after_s=30.0, max_redispatch=3,
                       golden=([1, 2, 3], 3),
                       qcfg=dict(strike_threshold=2, strike_window_s=5.0,
                                 probe_interval_s=0.2, probe_timeout_s=1.0,
                                 reinstate_after=2, retire_after_fails=3))),
    "two_deaths_no_health": dict(
        n_req=16,
        fleet_kw=dict(roles={"r0": "both", "r1": "both", "r2": "both"},
                      deaths={2: "r0", 4: "r2"}),
        router_kw=dict(use_health=False, max_redispatch=1,
                       reject_backoff_s=0.1, quarantine=False)),
    "disaggregated": dict(
        n_req=14,
        fleet_kw=dict(roles={"r0": "prefill", "r1": "decode",
                             "r2": "decode"}, deaths={4: "r1"},
                      p={"length": 0.7, "stop": 0.1, "rejected": 0.1,
                         "corrupt_segment": 0.0, "flip": 0.0,
                         "hold": 0.1}),
        router_kw=dict(lost_after_s=30.0, stale_after_s=30.0,
                       compact_every=7)),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("seed", [0, 1])
def test_same_script_same_decisions(script, seed):
    cfg = SCRIPTS[script]
    want = _drive("tpudist", seed, **cfg)
    got = _drive("port", seed, **cfg)
    for i, (w, g) in enumerate(zip(want[0], got[0])):
        assert g == w, f"store op {i} differs"
    assert len(got[0]) == len(want[0])
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert got[4] == want[4]
    # the scripts exercise what they are meant to
    moved = got[2]
    assert moved.get("router/completions") == cfg["n_req"]
    if script == "disaggregated":
        assert moved.get("router/handoffs", 0) > 0
    else:
        assert moved.get("router/replica_deaths", 0) >= 1
        assert moved.get("router/redispatched", 0) >= 1
        assert moved.get("router/rejected_rerouted", 0) >= 1
    assert any(op == "set" and "/journal/" in key
               for op, key, _ in got[0])


@pytest.mark.parametrize("seed", range(6))
def test_pick_and_rebalance_agree(seed):
    """``_pick``, ``rebalance_hot_cold`` and ``rebalance_victim`` over
    seeded loads."""
    jr = importlib.import_module("tpudist.runtime.router")
    rng = np.random.default_rng(seed)
    rids = [f"r{i}" for i in range(5)]
    loads = {rid: {"queue_depth": float(rng.integers(0, 4)),
                   "queue_wait_mean": float(rng.choice([0.0, 0.1, 0.5])),
                   "queue_wait_q": float(rng.choice([0.0, 0.2, 3.0])),
                   "kv_blocks_free": (None if rng.random() < 0.3
                                      else float(rng.integers(0, 50)))}
             for rid in rids}
    assigned = {rid: int(rng.integers(0, 3)) for rid in rids}
    pmap = {rid: {int(rng.integers(0, 3))} for rid in rids}
    a = jr.Router(None, use_health=False, quarantine=False)
    b = trouter.Router(None, use_health=False, quarantine=False)
    for ph in (None, 0, 1, 2):
        assert b._pick(rids, loads, assigned, ph, pmap) == \
            a._pick(rids, loads, assigned, ph, pmap)
    for gap in (1, 2, 3):
        for cands in (rids, rids[:2], rids[:1]):
            assert trouter.Router.rebalance_hot_cold(
                loads, cands, assigned, min_gap=gap) == \
                jr.Router.rebalance_hot_cold(loads, cands, assigned,
                                             min_gap=gap)
    entries = {f"k{i}": {"assigned": str(rng.choice(rids)),
                         "stage": str(rng.choice(["prefill", "decode",
                                                  "pull"]))}
               for i in range(8)}
    done = {f"k{int(rng.integers(0, 8))}": None}
    for rid in rids:
        assert trouter.Router.rebalance_victim(entries, done, rid) == \
            jr.Router.rebalance_victim(entries, done, rid)


# -- serving metrics --------------------------------------------------------

SERVE_KW = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                embed_dim=64, max_seq_len=96)


@pytest.fixture(scope="module")
def weights():
    """tpudist's tiny LM (build_tiny_lm, seed 0) and its conversion."""
    import jax

    from tpudist.runtime.router import build_tiny_lm as jax_tiny_lm
    from tpudist_torch.models.convert import from_flax_params
    from tpudist_torch.models.transformer import TransformerConfig

    cfg, params = jax_tiny_lm(seed=0)
    sd = from_flax_params(jax.tree.map(np.asarray, params),
                          TransformerConfig(**SERVE_KW))
    return cfg, params, sd


def _workload(mod, shared):
    rng = np.random.default_rng(1)
    out = []
    for i in range(9):
        tail = rng.integers(0, 64, int(rng.integers(3, 20)))
        prompt = np.concatenate([shared, tail]) if i % 2 else tail
        out.append(mod.Request(prompt.astype(np.int32),
                               int(rng.integers(4, 20)), rid=f"w{i}",
                               priority=i % 2))
    return out


def _serve_metrics(obs_mod, before):
    snap = obs_mod.snapshot()
    pick = lambda d: {k: v for k, v in d.items()  # noqa: E731
                      if k.startswith("serve/")}
    counters = {k: v["value"] - before["counters"].get(k, {}).get(
        "value", 0.0) for k, v in pick(snap["counters"]).items()}
    hist = {k: v["count"] - before["histograms"].get(k, {}).get("count", 0)
            for k, v in pick(snap["histograms"]).items()}
    return counters, hist


def _register_alike(a, b) -> None:
    """Give registries ``a`` and ``b`` the same ``serve/*`` counters and
    histograms.  An earlier test on this worker may have registered one in
    one package's process-global registry only (a paged loop's
    ``serve/prefix_hits``, say), which would read here as a key with delta
    0 on that side alone; a metric this workload registers on one side
    only still shows."""
    for src, dst in ((a, b), (b, a)):
        have = dst.metrics()
        for name, m in src.metrics().items():
            if not name.startswith("serve/") or name in have:
                continue
            kind = type(m).__name__
            if kind == "Counter":
                dst.counter(name, unit=m.unit)
            elif kind == "Histogram":
                dst.histogram(name, unit=m.unit, growth=m.growth,
                              window_s=m.window_s)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serve_counters_equal_after_the_same_workload(weights, layout,
                                                      monkeypatch):
    from tpudist import obs as jobs
    from tpudist.models import serving as jserv
    from tpudist_torch.models import serving as tserv
    from tpudist_torch.models.transformer import TransformerConfig

    monkeypatch.setenv("TPUDIST_KV_HOST_TIER_BYTES", "65536")
    cfg, params, sd = weights
    shared = np.arange(1, 33, dtype=np.int32)
    kw = dict(num_slots=2, steps_per_sync=4, prefill_chunk=8,
              stop_tokens=(7,), max_queue=6, degrade_queue=3,
              degrade_max_new=5, pipeline_depth=1)
    if layout == "paged":
        kw.update(cache_layout="paged", kv_block_size=16, kv_num_blocks=8)
    _register_alike(jobs.registry, tobs.registry)
    # serve/queue_wait_s is a sliding-window histogram: on a loaded host
    # a generation recorded by an earlier test can age out between the
    # before and after snapshots and shrink one package's count delta,
    # so both packages' windows are held still while the test reads them
    for reg in (jobs.registry, tobs.registry):
        for m in reg.metrics().values():
            if getattr(m, "window_s", None):
                monkeypatch.setattr(m, "_clock", lambda t=m._clock(): t)
    b0 = jobs.snapshot()
    want = jserv.ServeLoop(cfg, params, **kw).run(_workload(jserv, shared))
    w = _serve_metrics(jobs, b0)
    b1 = tobs.snapshot()
    got = tserv.ServeLoop(TransformerConfig(**SERVE_KW), sd, device="cpu",
                          **kw).run(_workload(tserv, shared))
    g = _serve_metrics(tobs, b1)
    assert [(c.rid, c.tokens.tolist(), c.reason) for c in got] == \
        [(c.rid, c.tokens.tolist(), c.reason) for c in want]
    assert g[0] == w[0]
    assert g[1] == w[1]
    assert g[0]["serve/rejected"] > 0 and g[0]["serve/degrade_clamped"] > 0
    if layout == "paged":
        assert g[0]["serve/prefix_hits"] > 0
        assert g[0]["serve/tier_spills"] > 0
    gauges = tobs.snapshot()["gauges"]
    assert gauges["serve/queue_depth"]["value"] == 0.0
    assert gauges["serve/degraded"]["value"] == 0.0


def test_depth2_metrics_make_no_host_read(weights):
    """At depth 2 the instrumented loop's segments issue no per-tick host
    read, and every value the serving stack recorded is a host number
    (no CUDA tensor waits in the registry for a snapshot sync)."""
    from tpudist_torch.models import serving as tserv
    from tpudist_torch.models.transformer import TransformerConfig

    _, _, sd = weights
    reg = tobs.registry
    reg.snapshot()    # fold whatever earlier tests left pending
    loop = tserv.ServeLoop(TransformerConfig(**SERVE_KW), sd, num_slots=2,
                           steps_per_sync=4, prefill_chunk=8,
                           cache_layout="paged", kv_block_size=16,
                           pipeline_depth=2, device="cpu")
    comps = loop.run(_workload(tserv, np.arange(1, 33, dtype=np.int32)))
    assert len(comps) == 9 and loop.stats.segments > 0
    assert loop.segment_host_reads == 0
    pending = [v for m in reg.metrics().values() for v in m._pending]
    assert pending and all(isinstance(v, (int, float)) for v in pending)


def test_poison_and_kill_seams_fire(weights, monkeypatch):
    """``faults.poison_logits`` freezes lanes as corrupt_segment and
    ``faults.on_segment`` is called once per dispatched segment."""
    from tpudist_torch.models import serving as tserv
    from tpudist_torch.models.transformer import TransformerConfig
    from tpudist_torch.runtime import faults

    _, _, sd = weights
    seen = []
    monkeypatch.setattr(faults, "on_segment", lambda: seen.append(1))
    faults.install(faults.FaultPlan(nan_after_tokens=3))
    try:
        loop = tserv.ServeLoop(TransformerConfig(**SERVE_KW), sd,
                               num_slots=2, steps_per_sync=4,
                               prefill_chunk=8, pipeline_depth=1,
                               device="cpu")
        comps = loop.run([tserv.Request(np.arange(2, 9, dtype=np.int32),
                                        12, rid=i) for i in range(3)])
    finally:
        faults.reset()
    assert {c.reason for c in comps} == {"corrupt_segment"}
    assert loop.stats.corrupt_segments >= 1
    assert len(seen) == loop.stats.segments > 0


def test_traced_request_records_its_lifecycle(weights):
    from tpudist_torch.models import serving as tserv
    from tpudist_torch.models.transformer import TransformerConfig

    _, _, sd = weights
    tobs.events.clear()
    tc = tobs.TraceContext.mint("k0")
    loop = tserv.ServeLoop(TransformerConfig(**SERVE_KW), sd, num_slots=1,
                           steps_per_sync=4, prefill_chunk=8,
                           pipeline_depth=1, device="cpu")
    loop.run([tserv.Request(np.arange(1, 12, dtype=np.int32), 6, rid="a",
                            trace=tc),
              tserv.Request(np.arange(1, 5, dtype=np.int32), 3, rid="b")])
    kinds = [e["kind"] for e in tobs.events.events()
             if e["trace"] == tc.trace_id]
    assert kinds[0] == "admit" and kinds[-1] == "finalize"
    assert "segment" in kinds and "prefill_chunk" in kinds
    assert all(e["trace"] == tc.trace_id for e in tobs.events.events())
    names = {e["name"] for e in tobs.tracer.events()}
    assert {"serve/admit", "serve/segment", "serve/prefill_chunk"} <= names
