"""tpudist_torch.runtime.autoscaler against the JAX package's
``tpudist.runtime.autoscaler``.

* ``TestConfig`` / ``TestPolicy`` / ``TestDrainMachine`` — tpudist's own
  cases (``tests/test_autoscaler.py``), run against the port: the knobs,
  the breach/idle hysteresis, cooldowns and clamps, and the drain state
  machine's steer -> inbox-empty -> stop -> sweep order.
* **The anchor** — one seeded poll script (registrations with roles,
  published snapshots with queue-wait histograms, KV, tier and burn
  gauges, quarantine marks, a coord outage, joiners that warm up or die,
  draining replicas that migrate their work out) drives tpudist's
  ``Autoscaler`` and the port's over equal fake coordinators on one
  injected clock, for the unified fleet and the ``prefill`` and
  ``decode`` pools: identical ``action_seq()``, decision records, store
  writes and ``autoscale/*`` metrics.  This is what pins the port's
  decisions; the live run below only shows the loop works end to end.
* One CPU end-to-end spike (``device="cpu"``): one replica, max two,
  12 requests — token-exact against the port's paged ``ServeLoop``, at
  least one scale-up, one clean drain back to one replica with
  ``pool_drained`` in the drained replica's exit report.  (The example's
  ``--autoscale`` run is in ``tests/test_torch_serve_fleet_example.py``,
  a file of its own so the two CPU fleets run on different workers.)"""

import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tpudist_torch import obs as tobs
from tpudist_torch.runtime.autoscaler import AutoscaleConfig, Autoscaler

NS = "as-test"
REPO = Path(__file__).resolve().parents[1]


class FakeCoord:
    """In-memory CoordClient stand-in: the verbs the autoscaler reaches
    for (keys/get/set/delete/add/live).  Writes are logged; with
    ``down`` set every call raises ConnectionError."""

    def __init__(self):
        self.kv: dict[str, bytes] = {}
        self.live_set: set[str] = set()
        self.counters: dict[str, int] = {}
        self.log: list[tuple] = []
        self.down = False

    def _check(self):
        if self.down:
            raise ConnectionError("coord store unreachable")

    def keys(self, prefix=""):
        self._check()
        return sorted(k for k in list(self.kv) if k.startswith(prefix))

    def get(self, key):
        self._check()
        return self.kv.get(key)

    def set(self, key, value):
        self._check()
        self.log.append(("set", key, value))
        self.kv[key] = value

    def delete(self, key):
        self._check()
        self.log.append(("delete", key))
        self.kv.pop(key, None)

    def add(self, key, delta):
        self.counters[key] = self.counters.get(key, 0) + int(delta)
        return self.counters[key]

    def live(self):
        self._check()
        return set(self.live_set)


class FakeProc:
    """A spawned joiner: alive until .exit()."""

    def __init__(self, replica_index):
        self.replica_index = replica_index
        self._rc = None

    def poll(self):
        return self._rc

    def exit(self, rc=0):
        self._rc = rc


def _register(fc, rid, rank, *, live=True, role=None):
    info = {"replica_id": rid, "rank": rank}
    if role is not None:
        info["role"] = role
    fc.kv[f"{NS}/replica/{rid}"] = json.dumps(info).encode()
    if live:
        fc.live_set.add(f"{NS}:{rid}")


def _publish(fc, rank, *, wait_idx=None, depth=0.0, free=None, used=None,
             tier=None, burn=None, migrated=None):
    """One MetricsPublisher-shaped snapshot.  ``wait_idx`` puts every
    queue-wait observation in the ``2**wait_idx`` bucket, so every
    quantile reads exactly ``2**wait_idx`` seconds."""
    gauges = {"serve/queue_depth": {"value": depth}}
    if free is not None:
        gauges["serve/kv_blocks_free"] = {"value": free}
    if used is not None:
        gauges["serve/kv_blocks_used"] = {"value": used}
    if tier is not None:
        gauges["serve/tier_bytes"] = {"value": tier[0]}
        gauges["serve/tier_budget_bytes"] = {"value": tier[1]}
    if burn is not None:
        gauges["slo/burn_rate_60s"] = {"value": burn}
    counters = {}
    if migrated is not None:
        counters["serve/migrated_out"] = {"value": migrated}
    snap = {"rank": rank, "published_at": time.time(),
            "gauges": gauges, "counters": counters, "histograms": {}}
    if wait_idx is not None:
        v = float(2.0 ** wait_idx)
        snap["histograms"]["serve/queue_wait_s"] = {
            "growth": 2.0, "count": 100, "sum": v * 100, "zero": 0,
            "min": v, "max": v, "buckets": {str(wait_idx): 100}}
    fc.kv[f"{NS}/metrics/{rank}"] = json.dumps(snap).encode()


def _scaler(fc, clock, spawned, mod=None, **cfg_kw):
    kw = dict(min_replicas=1, max_replicas=4, target_wait_s=0.5,
              low_wait_s=0.1, breach_polls=3, idle_polls=3,
              up_cooldown_s=5.0, down_cooldown_s=5.0)
    pool = cfg_kw.pop("pool", None)
    kw.update(cfg_kw)
    cfg_cls, cls = ((AutoscaleConfig, Autoscaler) if mod is None
                    else (mod.AutoscaleConfig, mod.Autoscaler))

    def spawner(n):
        procs = [FakeProc(100 + len(spawned) + i) for i in range(n)]
        spawned.extend(procs)
        return procs

    return cls(fc, namespace=NS, config=cfg_cls(**kw), spawner=spawner,
               pool=pool, clock=lambda: clock["t"])


class TestConfig:
    def test_from_env_and_defaults(self):
        c = AutoscaleConfig.from_env({
            "TPUDIST_AUTOSCALE_MAX_REPLICAS": "8",
            "TPUDIST_AUTOSCALE_TARGET_WAIT_S": "2.0",
            "TPUDIST_AUTOSCALE_BREACH_POLLS": "5",
            "TPUDIST_AUTOSCALE_MIN_KV_FREE_FRAC": "0.25",
            "TPUDIST_AUTOSCALE_POLL_S": " "})
        assert (c.max_replicas, c.target_wait_s, c.breach_polls,
                c.min_kv_free_frac, c.poll_s) == (8, 2.0, 5, 0.25, 0.5)
        assert c.low_wait_s == 0.5      # defaults to target / 4
        assert AutoscaleConfig().low_wait_s == 0.125

    def test_validation(self):
        with pytest.raises(ValueError, match="min_replicas"):
            AutoscaleConfig(min_replicas=3, max_replicas=2)
        with pytest.raises(ValueError, match="low_wait_s"):
            AutoscaleConfig(target_wait_s=1.0, low_wait_s=1.0)
        with pytest.raises(ValueError, match="quantile"):
            AutoscaleConfig(quantile=0.0)
        with pytest.raises(ValueError, match="breach_polls"):
            AutoscaleConfig(breach_polls=0)
        with pytest.raises(ValueError, match="min_kv_free_frac"):
            AutoscaleConfig(min_kv_free_frac=1.0)
        with pytest.raises(ValueError, match="pool"):
            Autoscaler(FakeCoord(), spawner=lambda n: [], pool="both")
        with pytest.raises(ValueError, match="coord_addr"):
            Autoscaler(FakeCoord())
        assert Autoscaler(FakeCoord(), coord_addr="h:1").device == "cuda"


class TestPolicy:
    def test_breach_hysteresis_then_scale_up(self):
        fc, clock, spawned = FakeCoord(), {"t": 0.0}, []
        _register(fc, "r0", 0)
        _publish(fc, 0, wait_idx=6)             # p90 = 64s >> target
        sc = _scaler(fc, clock, spawned, breach_polls=3)
        for want_breach in (1, 2):
            r = sc.poll()
            assert r["action"] is None and r["breach"] == want_breach
            assert spawned == []
        r = sc.poll()
        assert r["action"] == ("up", 1)
        assert len(spawned) == 1 and r["breach"] == 0

    def test_noise_poll_resets_breach(self):
        fc, clock, spawned = FakeCoord(), {"t": 0.0}, []
        _register(fc, "r0", 0)
        sc = _scaler(fc, clock, spawned, breach_polls=2)
        _publish(fc, 0, wait_idx=6)
        assert sc.poll()["breach"] == 1
        _publish(fc, 0, wait_idx=None)          # calm: no observations
        assert sc.poll()["breach"] == 0
        _publish(fc, 0, wait_idx=6)
        r = sc.poll()
        assert r["breach"] == 1 and r["action"] is None and not spawned

    def test_up_cooldown_and_pending_joiner_bound(self):
        fc, clock, spawned = FakeCoord(), {"t": 0.0}, []
        _register(fc, "r0", 0)
        _publish(fc, 0, wait_idx=6)
        sc = _scaler(fc, clock, spawned, breach_polls=1,
                     up_cooldown_s=10.0, max_replicas=2)
        assert sc.poll()["action"] == ("up", 1)
        clock["t"] += 5.0                       # still cooling down
        assert sc.poll()["action"] is None and len(spawned) == 1
        clock["t"] += 6.0                       # cooldown expired, but
        r = sc.poll()                           # 1 live + 1 pending = max
        assert r["action"] is None and r["pending"] == 1
        assert len(spawned) == 1

    def test_scale_up_resumes_after_joiner_dies(self):
        fc, clock, spawned = FakeCoord(), {"t": 0.0}, []
        _register(fc, "r0", 0)
        _publish(fc, 0, wait_idx=6)
        sc = _scaler(fc, clock, spawned, breach_polls=1,
                     up_cooldown_s=1.0, max_replicas=2)
        assert sc.poll()["action"] == ("up", 1)
        spawned[0].exit(rc=1)                   # died mid-warmup
        clock["t"] += 2.0
        assert sc.poll()["action"] == ("up", 1)
        assert len(spawned) == 2

    def test_idle_window_drains_least_loaded(self):
        fc, clock, spawned = FakeCoord(), {"t": 0.0}, []
        _register(fc, "r0", 0)
        _register(fc, "r1", 1)
        _publish(fc, 0, depth=0.0, free=10)
        _publish(fc, 1, depth=0.0, free=40)     # emptiest: the victim
        sc = _scaler(fc, clock, spawned, idle_polls=3)
        for want_idle in (1, 2):
            r = sc.poll()
            assert r["action"] is None and r["idle"] == want_idle
        r = sc.poll()
        assert r["action"] == ("down", "r1")
        assert fc.get(f"{NS}/draining/r1") is not None
        assert f"{NS}:r1" in fc.live_set        # still alive: draining

    def test_min_clamp_and_one_drain_at_a_time(self):
        fc, clock, spawned = FakeCoord(), {"t": 0.0}, []
        _register(fc, "r0", 0)
        sc = _scaler(fc, clock, spawned, idle_polls=1, min_replicas=1)
        for _ in range(4):
            assert sc.poll()["action"] is None  # 1 active == min
        _register(fc, "r1", 1)
        _register(fc, "r2", 2)
        sc2 = _scaler(fc, clock, spawned, idle_polls=1, min_replicas=1,
                      down_cooldown_s=0.0)
        assert sc2.poll()["action"][0] == "down"
        r = sc2.poll()                          # r-x draining: hold
        assert r["action"] is None and len(r["draining"]) == 1

    def test_middle_band_resets_both_counters(self):
        fc, clock, spawned = FakeCoord(), {"t": 0.0}, []
        _register(fc, "r0", 0)
        _register(fc, "r1", 1)
        sc = _scaler(fc, clock, spawned, target_wait_s=100.0,
                     low_wait_s=0.5, breach_polls=1, idle_polls=1,
                     down_cooldown_s=0.0)
        _publish(fc, 0, wait_idx=6)             # 64s: inside the band
        for _ in range(5):
            r = sc.poll()
            assert r["action"] is None
            assert r["breach"] == 0 and r["idle"] == 0


class TestDrainMachine:
    def test_stop_only_after_inbox_empty_then_sweep(self):
        fc, clock, spawned = FakeCoord(), {"t": 0.0}, []
        _register(fc, "r0", 0)
        _register(fc, "r1", 1)
        sc = _scaler(fc, clock, spawned, idle_polls=1,
                     down_cooldown_s=0.0)
        fc.kv[f"{NS}/inbox/r1/00000001"] = b"{}"   # undelivered work
        _publish(fc, 0, free=10)
        _publish(fc, 1, free=40)
        assert sc.poll()["action"] == ("down", "r1")
        sc.poll()
        assert fc.get(f"{NS}/stop/r1") is None     # inbox not empty
        fc.delete(f"{NS}/inbox/r1/00000001")       # replica took it
        sc.poll()
        assert fc.get(f"{NS}/stop/r1") == b"1"     # now stop it
        assert f"{NS}:r1" in fc.live_set
        d0 = tobs.snapshot()["counters"].get(
            "autoscale/drain_completed", {}).get("value", 0)
        fc.live_set.discard(f"{NS}:r1")            # clean exit
        sc.poll()
        for key in (f"{NS}/draining/r1", f"{NS}/stop/r1",
                    f"{NS}/replica/r1", f"{NS}/metrics/1"):
            assert key not in fc.kv                # residue swept
        d1 = tobs.snapshot()["counters"]["autoscale/drain_completed"][
            "value"]
        assert d1 - d0 == 1

    def test_fast_drain_stops_on_migrated_out(self):
        """A draining replica whose work migrated out (its
        ``serve/migrated_out`` grew, its queue is empty) gets its stop
        key although a raced key still sits in its inbox."""
        fc, clock, spawned = FakeCoord(), {"t": 0.0}, []
        _register(fc, "r0", 0)
        _register(fc, "r1", 1)
        sc = _scaler(fc, clock, spawned, idle_polls=1,
                     down_cooldown_s=0.0)
        _publish(fc, 0, free=10, migrated=0.0)
        _publish(fc, 1, free=40, migrated=2.0)
        m0 = tobs.snapshot()["counters"].get(
            "autoscale/drain_migrations", {}).get("value", 0)
        assert sc.poll()["action"] == ("down", "r1")
        fc.kv[f"{NS}/inbox/r1/00000009"] = b"{}"   # raced the drain
        sc.poll()                                   # base = 2
        assert fc.get(f"{NS}/stop/r1") is None
        _publish(fc, 1, free=40, migrated=5.0, depth=1.0)
        sc.poll()                                   # queue not empty
        assert fc.get(f"{NS}/stop/r1") is None
        _publish(fc, 1, free=40, migrated=5.0, depth=0.0)
        sc.poll()
        assert fc.get(f"{NS}/stop/r1") == b"1"
        m1 = tobs.snapshot()["counters"]["autoscale/drain_migrations"][
            "value"]
        assert m1 - m0 == 3


# ---------------------------------------------------------------- anchor


def _poll_script(fc, clock, procs, rng, i, pool_role):
    """The fleet's state before poll ``i`` of the anchor script (the
    same calls on either package's FakeCoord)."""
    clock["t"] = 0.5 * i
    phase = ("breach" if i < 8 else "band" if i < 11
             else "idle" if i < 30 else "breach" if i < 40 else "idle")
    fc.down = i in (12, 13, 31)                 # a coord brownout
    # joiners register (with the pool's role) two polls after their
    # spawn and go live a poll later; the second joiner dies warming up
    for n, p in enumerate(procs):
        rid = f"r{p.replica_index}"
        born = getattr(p, "born", None)
        if born is None:
            p.born = born = i
        if n == 1 and i - born == 1:
            p.exit(rc=1)
            continue
        if p.poll() is None and i - born >= 2:
            _register(fc, rid, p.replica_index, live=i - born >= 3,
                      role=pool_role)
    # a draining replica: a raced inbox key clears two polls after the
    # mark; once stopped its lease lapses two polls later
    for key in [k for k in fc.kv if k.startswith(f"{NS}/draining/")]:
        rid = key.rsplit("/", 1)[1]
        fc.kv.setdefault(f"{NS}/drain_seen/{rid}", str(i).encode())
        since = int(fc.kv[f"{NS}/drain_seen/{rid}"])
        inbox = f"{NS}/inbox/{rid}/00000001"
        if i - since == 1:
            fc.kv[inbox] = b"{}"
        elif i - since >= 3:
            fc.kv.pop(inbox, None)
    for key in [k for k in fc.kv if k.startswith(f"{NS}/stop/")]:
        rid = key.rsplit("/", 1)[1]
        fc.kv.setdefault(f"{NS}/stop_seen/{rid}", str(i).encode())
        if i - int(fc.kv[f"{NS}/stop_seen/{rid}"]) >= 2:
            fc.live_set.discard(f"{NS}:{rid}")
    if i == 20:
        fc.kv[f"{NS}/quarantined/r1"] = b"1"
    if i == 26:
        fc.kv.pop(f"{NS}/quarantined/r1", None)
    for key in list(fc.kv):
        if not key.startswith(f"{NS}/replica/"):
            continue
        rank = json.loads(fc.kv[key])["rank"]
        wait = {"breach": int(rng.integers(1, 5)),
                "band": -2, "idle": None}[phase]
        depth = float(rng.integers(1, 6)) if phase == "breach" else 0.0
        free = float(rng.integers(0, 60))
        used = float(rng.integers(1, 60))
        tier = ((float(rng.integers(0, 100)), 100.0)
                if rng.random() < 0.5 else None)
        burn = float(rng.exponential(1.0)) if rng.random() < 0.3 else None
        _publish(fc, rank, wait_idx=wait, depth=depth, free=free,
                 used=used, tier=tier, burn=burn,
                 migrated=float(i // 2) if rank == 1 else None)


def _anchor_run(mod, obs_mod, pool, monkeypatch):
    fc, clock, spawned = FakeCoord(), {"t": 0.0}, []
    roles = {None: ("both", "both", "both"),
             "prefill": ("prefill", "decode", "prefill"),
             "decode": ("decode", "decode", "prefill")}[pool]
    for n, role in enumerate(roles):
        _register(fc, f"r{n}", n, role=role)
    rng = np.random.default_rng(11)
    burn_rng = np.random.default_rng(12)
    monkeypatch.setattr(
        obs_mod.slo, "burn_rates",
        lambda cls=None: ({60.0: float(burn_rng.exponential(0.5))}
                          if burn_rng.random() < 0.2 else {}))
    tag = "" if pool is None else f"~pool={pool}"
    names = [f"autoscale/{n}{tag}" for n in (
        "scale_ups", "scale_downs", "drain_completed", "drain_migrations",
        "polls", "suppressed_polls")]
    before = obs_mod.snapshot()["counters"]
    sc = _scaler(fc, clock, spawned, mod=mod, pool=pool,
                 breach_polls=2, idle_polls=3, up_cooldown_s=2.0,
                 down_cooldown_s=1.0, max_replicas=4,
                 max_burn_rate=2.0, min_kv_free_frac=0.15,
                 min_tier_headroom_frac=0.1)
    for i in range(48):
        _poll_script(fc, clock, spawned, rng, i, pool or "both")
        sc.poll()
    after = obs_mod.snapshot()
    moved = {n: after["counters"].get(n, {}).get("value", 0)
             - before.get(n, {}).get("value", 0) for n in names}
    gauges = {n: after["gauges"][n]["value"] for n in after["gauges"]
              if n.startswith("autoscale/") and n.endswith(tag)
              and (tag or "~pool=" not in n)}
    return sc, fc, moved, gauges


@pytest.mark.parametrize("pool", [None, "prefill", "decode"],
                         ids=["unified", "prefill", "decode"])
def test_decision_log_parity(pool, monkeypatch):
    """The anchor: the same poll script through both autoscalers."""
    ref_mod = importlib.import_module("tpudist.runtime.autoscaler")
    ref_obs = importlib.import_module("tpudist.obs")
    now = 4000.0
    monkeypatch.setattr(time, "time", lambda: now)
    ra, fa, ma, ga = _anchor_run(ref_mod, ref_obs, pool, monkeypatch)
    rb, fb, mb, gb = _anchor_run(
        importlib.import_module("tpudist_torch.runtime.autoscaler"), tobs,
        pool, monkeypatch)
    assert rb.action_seq() == ra.action_seq()
    assert json.dumps(rb.decision_log, sort_keys=True) \
        == json.dumps(ra.decision_log, sort_keys=True)
    assert fb.log == fa.log
    assert mb == ma and gb == ga
    kinds = [a["kind"] for a in rb.action_seq()]
    assert "up" in kinds and "down" in kinds       # the script bites
    assert mb[f"autoscale/suppressed_polls"
              f"{'' if pool is None else '~pool=' + pool}"] == 3
    assert sum(1 for r in rb.decision_log if r.get("suppressed")) == 3
    assert mb[f"autoscale/drain_completed"
              f"{'' if pool is None else '~pool=' + pool}"] >= 1
    if pool != "prefill":        # r1 (decode) migrates its work out
        assert mb[f"autoscale/drain_migrations"
                  f"{'' if pool is None else '~pool=' + pool}"] >= 1


# ------------------------------------------------------------ live runs


def _requests(n):
    from tpudist_torch.models.serving import Request

    rng = np.random.default_rng(0)
    return [Request(rng.integers(0, 64, size=4 + i).astype(np.int32),
                    20 + 2 * i, rid=f"q{i}") for i in range(n)]


@pytest.fixture(scope="module")
def coord():
    from tpudist_torch.runtime.coord import CoordClient, CoordServer

    try:
        server = CoordServer(0)
    except Exception as e:   # NativeUnavailable or build failure
        pytest.skip(f"native coord store unavailable: {e}")
    yield server, CoordClient("127.0.0.1", server.port)
    server.stop()


def test_spike_scales_up_idle_drains_down_zero_lost(coord):
    """One replica on the CPU, a 12-request spike with a 5 ms wait
    target: the loop buys a second replica (the default spawner, through
    ``scale_fleet(device="cpu")``), every request completes token-exact
    against the port's paged ServeLoop, and the idle tail drains the
    fleet back to one replica whose departed peer exits clean with its
    pool drained.  Replicas keep queue wait over a 4 s window
    (``TPUDIST_SERVE_WAIT_WINDOW_S``) so the tail is short."""
    from tpudist_torch.models.serving import ServeLoop
    from tpudist_torch.runtime.coord import CoordClient
    from tpudist_torch.runtime.router import (Router, build_tiny_lm,
                                              exit_reports,
                                              launch_local_fleet,
                                              stop_fleet, wait_live)

    server, client = coord
    ns = "as-fleet"
    addr = f"127.0.0.1:{server.port}"
    window = {"TPUDIST_SERVE_WAIT_WINDOW_S": "4"}
    args = ["--cache-layout", "paged", "--kv-block-size", "16",
            "--ttl", "1.0"]
    procs = launch_local_fleet(addr, 1, namespace=ns, replica_args=args,
                               env_overrides={0: window}, device="cpu")
    cfg = AutoscaleConfig(
        min_replicas=1, max_replicas=2, target_wait_s=0.005,
        low_wait_s=0.001, quantile=0.9, breach_polls=2, idle_polls=4,
        up_cooldown_s=60.0, down_cooldown_s=0.0, poll_s=0.25,
        max_metric_age_s=10.0)
    scaler = Autoscaler(CoordClient("127.0.0.1", server.port),
                        coord_addr=addr, namespace=ns, config=cfg,
                        replica_args=args, env_extra=window, device="cpu")

    def counter(name):
        return tobs.snapshot()["counters"].get(name, {}).get("value", 0)

    u0, d0 = counter("autoscale/scale_ups"), counter(
        "autoscale/drain_completed")
    try:
        wait_live(client, 1, namespace=ns, timeout_s=120.0, procs=procs)
        scaler.start()
        router = Router(client, namespace=ns, lost_after_s=5.0)
        comps = router.run(_requests(12), timeout_s=180.0)
        assert sorted(c.rid for c in comps) \
            == sorted(f"q{i}" for i in range(12))
        assert all(c.reason == "length" for c in comps)
        lm_cfg, params = build_tiny_lm(seed=0)
        ref = ServeLoop(lm_cfg, params, num_slots=2, steps_per_sync=4,
                        prefill_chunk=8, cache_layout="paged",
                        kv_block_size=16, device="cpu")
        want = {c.rid: c.tokens.tolist() for c in ref.run(_requests(12))}
        for c in comps:
            assert c.tokens.tolist() == want[c.rid], c.rid
        deadline = time.time() + 240.0
        while counter("autoscale/scale_ups") - u0 < 1 \
                and time.time() < deadline:
            time.sleep(0.25)
        assert counter("autoscale/scale_ups") - u0 >= 1, \
            "the spike never triggered a scale-up"
        deadline = time.time() + 300.0
        mark = f"{ns}:"
        while time.time() < deadline:
            live = {n for n in client.live() if n.startswith(mark)}
            if counter("autoscale/drain_completed") - d0 >= 1 \
                    and len(live) == 1:
                break
            time.sleep(0.25)
        assert counter("autoscale/drain_completed") - d0 >= 1, \
            "the idle fleet never drained down"
        assert len({n for n in client.live() if n.startswith(mark)}) == 1
        down = [r["action"][1] for r in scaler.decision_log
                if r["action"] and r["action"][0] == "down"]
        reports = exit_reports(client, namespace=ns)
        assert down and reports[down[0]]["pool_drained"] is True
        assert reports[down[0]].get("clean", True)
    finally:
        scaler.stop()
        codes = stop_fleet(client, procs + scaler.procs, namespace=ns)
    assert len(scaler.procs) == 1 and codes == [0, 0]


def test_slice_imports_with_jax_blocked():
    """With jax, flax, tpudist and ml_dtypes unimportable, the autoscaler
    and the rest of the observability plane import and work: a poll
    decides, the fixture renders, a build is noted."""
    code = "\n".join([
        "import sys",
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'tpudist',",
        "          'ml_dtypes'):",
        "    sys.modules[m] = None",
        "import json",
        "from tpudist_torch import obs",
        "from tpudist_torch.obs import (alerts, console, timeline, tsdb,",
        "                               xla)",
        "from tpudist_torch.runtime import autoscaler",
        "sys.path.insert(0, 'tests')",
        "import test_torch_autoscaler as t",
        "fc, clock, spawned = t.FakeCoord(), {'t': 0.0}, []",
        "t._register(fc, 'r0', 0)",
        "t._publish(fc, 0, wait_idx=6)",
        "sc = t._scaler(fc, clock, spawned, breach_polls=1)",
        "assert sc.poll()['action'] == ('up', 1)",
        "doc = json.load(open('tests/data/console_snapshot.json'))",
        "assert 'REPLICAS' in console.render(doc)",
        "xla.note_compile(1.5, source='nvcc')",
        "assert obs.snapshot()['counters']['xla/compiles']['value'] == 1",
        "print('ok')"])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
