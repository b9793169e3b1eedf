"""The port router's crash recovery against the JAX package's: the
request-lifecycle journal and ``Router.recover()``.

Each package's router runs over its own in-memory store, with the same
seeded scripted replicas on one injected clock, and is crashed at the
same poll by its own fault harness (``router_kill_after_polls`` with
``router_kill_raise``).  The journals left behind must be the same record
for record; a replacement router's ``recover()`` (with the same
already-delivered rids) must then make the same store writes and deletes,
replay the same terminals and return the same completions; the journal
ends empty.  Corrupt journal records are skipped and counted alike.

The live CPU fleets: port replica subprocesses (``--device cpu``)
restore tpudist's weights (converted, saved with the port's
checkpointer) from ``--snapshot-dir``; one is SIGKILLed by
``KILL_AFTER_SEGMENTS``; every request returns exactly once (its journal
compacted to empty), token-identical to tpudist's single in-process
``ServeLoop``.  A second fleet runs ``--role prefill`` plus ``--role
decode`` (paged) and holds the same."""

import importlib
import json
import time

import numpy as np
import pytest

from tpudist_torch import obs as tobs
from tpudist_torch.runtime import faults as tfaults
from tpudist_torch.runtime import router as trouter
from tpudist_torch.runtime import wire as twire

NS = "jr"


@pytest.fixture(autouse=True)
def _clean_plans():
    jf = importlib.import_module("tpudist.runtime.faults")
    jf.reset()
    tfaults.reset()
    yield
    jf.reset()
    tfaults.reset()


class FakeCoord:
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
        return self.counters[key]

    def live(self):
        return set(self.live_set)


class Replicas:
    """r0..r{n-1}: each answers an inbox item 1-5 ticks after taking it
    (tokens a pure function of the prompt), r1 dies at tick ``die_at``."""

    def __init__(self, fc, seed, n=3, die_at=None):
        self.fc, self.rng, self.tick = fc, np.random.default_rng(seed), 0
        self.die_at, self.held = die_at, {}
        for i in range(n):
            rid = f"r{i}"
            fc.kv[f"{NS}/replica/{rid}"] = json.dumps(
                {"replica_id": rid, "rank": i}).encode()
            fc.live_set.add(f"{NS}:{rid}")

    def step(self):
        self.tick += 1
        if self.tick == self.die_at:
            self.fc.live_set.discard(f"{NS}:r1")
        for name in sorted(self.fc.live_set):
            rid = name.split(":", 1)[1]
            inbox = f"{NS}/inbox/{rid}/"
            for key in sorted(k for k in self.fc.kv if k.startswith(inbox)):
                doc = twire.decode_record(self.fc.kv.pop(key))
                self.held[key[len(inbox):]] = (
                    rid, doc, self.tick + int(self.rng.integers(1, 6)))
        for k in sorted(self.held):
            rid, doc, ready = self.held[k]
            if f"{NS}:{rid}" not in self.fc.live_set:
                del self.held[k]
                continue
            if ready <= self.tick:
                del self.held[k]
                toks = [int((sum(doc["prompt"]) + j) % 50)
                        for j in range(doc["max_new_tokens"])]
                self.fc.kv[f"{NS}/done/{k}"] = twire.encode_record(
                    "completion", {"key": k, "tokens": toks,
                                   "reason": "length", "replica": rid})
        for name in sorted(self.fc.live_set):
            rank = int(name.split(":r", 1)[1])
            self.fc.kv[f"{NS}/metrics/{rank}"] = json.dumps(
                {"rank": rank, "published_at": time.time(), "gauges": {},
                 "counters": {}, "histograms": {}}).encode()


def _pkg(name):
    if name == "tpudist":
        return (importlib.import_module("tpudist.runtime.router"),
                importlib.import_module("tpudist.runtime.faults"),
                importlib.import_module("tpudist.models.serving"),
                importlib.import_module("tpudist.obs"))
    return (trouter, tfaults,
            importlib.import_module("tpudist_torch.models.serving"), tobs)


def _norm_set(val):
    doc = twire.decode_record(val)
    tr = doc.get("trace") or (doc.get("req") or {}).get("trace")
    if isinstance(tr, dict):
        tr["id"] = tr["enq"] = None
    return doc


def _norm(log):
    return [(op, key, _norm_set(v) if op == "set" else v)
            for op, key, v in log]


def _crash_and_recover(name, seed, kill_at, corrupt=()):
    mod, faults, serving, obs_mod = _pkg(name)
    fc = FakeCoord()
    fleet = Replicas(fc, seed, die_at=6)
    t = [0.0]

    def sleeper(dt):
        t[0] += dt
        fleet.step()

    def router():
        return mod.Router(fc, namespace=NS, poll_s=0.05, use_health=False,
                          join_grace_s=0.0, compact_every=5,
                          clock=lambda: t[0], wall=lambda: 1000.0 + t[0],
                          sleeper=sleeper)

    rng = np.random.default_rng(seed)
    reqs = [serving.Request(rng.integers(0, 64, int(rng.integers(2, 9)))
                            .astype(np.int32), int(rng.integers(1, 6)),
                            rid=f"q{i}") for i in range(10)]
    delivered = []
    faults.install(faults.FaultPlan(router_kill_after_polls=kill_at,
                                    router_kill_raise=True))
    with pytest.raises(faults.RouterKilled):
        router().run(reqs, timeout_s=60.0,
                     on_complete=lambda k, c: delivered.append(c.rid))
    faults.reset()
    journal = {k: _norm_set(fc.kv[k]) for k in fc.keys(f"{NS}/journal/")}
    for k in corrupt:
        key = f"{NS}/journal/{k}"
        if key in fc.kv:
            raw = fc.kv[key]
            fc.kv[key] = raw[:-1] + bytes([raw[-1] ^ 1])
    before = {k: v["value"] for k, v in
              obs_mod.snapshot()["counters"].items()}
    fc.log.clear()
    comps = router().recover(timeout_s=60.0, delivered=delivered)
    after = obs_mod.snapshot()["counters"]
    moved = {k: v["value"] - before.get(k, 0.0) for k, v in after.items()
             if k.startswith(("router/", "integrity/"))
             and v["value"] - before.get(k, 0.0)}
    return (journal, delivered, _norm(fc.log),
            [(c.rid, c.tokens.tolist(), c.reason) for c in comps], moved,
            fc.keys(f"{NS}/journal/"))


@pytest.mark.parametrize("seed,kill_at", [(0, 2), (1, 4), (2, 6), (3, 9)])
def test_crash_leaves_the_same_journal_and_recovers_alike(seed, kill_at):
    want = _crash_and_recover("tpudist", seed, kill_at)
    got = _crash_and_recover("port", seed, kill_at)
    assert got[0] == want[0]            # the journal the crash left
    assert got[1] == want[1]            # what the dead router delivered
    assert got[2] == want[2]            # recovery's store writes
    assert got[3] == want[3]            # recovery's completions
    assert got[4] == want[4]            # router/* counters moved
    assert got[5] == [] and want[5] == []
    every = sorted(set(got[1]) | {rid for rid, _, _ in got[3]})
    assert every == sorted(f"q{i}" for i in range(10))
    assert got[4]["router/recoveries"] == 1
    for doc in got[0].values():
        assert doc["schema"] == "tpudist.journal/1"


def test_corrupt_journal_records_are_skipped_alike():
    want = _crash_and_recover("tpudist", 4, 9, corrupt=("00000002",
                                                        "00000005"))
    got = _crash_and_recover("port", 4, 9, corrupt=("00000002",
                                                     "00000005"))
    assert got[2:] == want[2:]
    assert got[4].get("integrity/checksum_mismatch", 0) >= 1


def test_empty_journal_recover_is_a_noop():
    fc = FakeCoord()
    r = trouter.Router(fc, namespace=NS, use_health=False)
    assert r.recover(timeout_s=1.0) == []
    assert trouter.JOURNAL_SCHEMA == "tpudist.journal/1"


# -- CPU fleet ---------------------------------------------------------------

SERVE_KW = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                embed_dim=64, max_seq_len=96)
FLEET_NS = "fleet"


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


def _coord_pair():
    from tpudist_torch.runtime.coord import CoordClient, CoordServer

    server = CoordServer(0)
    return server, CoordClient("127.0.0.1", server.port)


def _fleet_requests(mod):
    rng = np.random.default_rng(0)
    return [mod.Request(rng.integers(0, 64, size=4 + 3 * i).astype(np.int32),
                        14 + 2 * i, rid=f"q{i}") for i in range(6)]


@pytest.fixture(scope="module")
def snapshot_dir(weights, tmp_path_factory):
    """tpudist's tiny-LM weights, converted, in a fleet snapshot dir."""
    from tpudist_torch.elastic.checkpoint import Checkpointer

    d = tmp_path_factory.mktemp("fleet_snapshot")
    _, _, sd = weights
    Checkpointer(d, layout="steps").save(0, sd, meta={"version": 0})
    return d


def _reference(weights, **kw):
    from tpudist.models import serving as jserv

    cfg, params, _ = weights
    loop = jserv.ServeLoop(cfg, params, num_slots=2, steps_per_sync=4,
                           prefill_chunk=8, pipeline_depth=1,
                           cache_layout="paged", kv_block_size=16, **kw)
    return {c.rid: c.tokens.tolist() for c in loop.run(
        _fleet_requests(jserv))}


def _run_fleet(snapshot_dir, roles, env_overrides):
    """Replicas r0..rN-1 with ``roles``; returns (completions, exit
    codes, exit reports, router counters moved, KV payload keys and
    journal keys left in the store)."""
    from tpudist_torch.models import serving as tserv

    server, client = _coord_pair()
    # a 2 s lease and a 15 s publish bound keep a loaded host's slow
    # heartbeat or publisher from reading as a second death
    common = ["--cache-layout", "paged", "--kv-block-size", "16",
              "--ttl", "2.0", "--snapshot-dir", str(snapshot_dir)]
    procs = []
    for i, role in enumerate(roles):
        procs += trouter.scale_fleet(
            f"127.0.0.1:{server.port}", 1, start_index=i,
            namespace=FLEET_NS, replica_args=common + ["--role", role],
            env_overrides=env_overrides, device="cpu")
    before = {k: v["value"] for k, v in
              tobs.snapshot()["counters"].items()}
    try:
        trouter.wait_live(client, len(roles), namespace=FLEET_NS,
                          timeout_s=120.0, procs=procs)
        comps = trouter.Router(client, namespace=FLEET_NS,
                               lost_after_s=15.0).run(
            _fleet_requests(tserv), timeout_s=120.0)
    finally:
        codes = trouter.stop_fleet(client, procs, namespace=FLEET_NS)
    after = tobs.snapshot()["counters"]
    moved = {k: v["value"] - before.get(k, 0.0) for k, v in after.items()
             if k.startswith("router/")}
    reports = trouter.exit_reports(client, namespace=FLEET_NS)
    left = (client.keys(f"{FLEET_NS}/kv/"),
            client.keys(f"{FLEET_NS}/journal/"))
    del server
    return comps, codes, reports, moved, left


@pytest.fixture(scope="module")
def unified_fleet(snapshot_dir):
    return _run_fleet(snapshot_dir, ["both", "both"],
                      {1: {"TPUDIST_FAULT_KILL_AFTER_SEGMENTS": "4"}})


@pytest.fixture(scope="module")
def disagg_fleet(snapshot_dir):
    return _run_fleet(snapshot_dir, ["prefill", "decode", "decode"],
                      {2: {"TPUDIST_FAULT_KILL_AFTER_SEGMENTS": "3"}})


def test_fleet_kill_every_request_once_token_identical(unified_fleet,
                                                       weights):
    comps, codes, reports, moved, (_, journal_left) = unified_fleet
    assert sorted(c.rid for c in comps) == [f"q{i}" for i in range(6)]
    assert journal_left == []           # every record compacted away
    assert codes[1] == -9 and codes[0] == 0
    assert moved["router/replica_deaths"] == 1
    assert moved["router/redispatched"] >= 1
    want = _reference(weights)
    assert {c.rid: c.tokens.tolist() for c in comps} == want
    assert set(reports) == {"r0"}
    assert reports["r0"]["pool_drained"] is True
    assert reports["r0"]["clean"] is True


def test_fleet_disaggregated_token_identical(disagg_fleet, weights):
    comps, codes, reports, moved, (kv_left, journal_left) = disagg_fleet
    assert sorted(c.rid for c in comps) == [f"q{i}" for i in range(6)]
    assert all(c.reason == "length" for c in comps)
    assert moved["router/handoffs"] >= 6
    want = _reference(weights)
    assert {c.rid: c.tokens.tolist() for c in comps} == want
    assert kv_left == []                 # payload refs swept at terminal
    assert journal_left == []
    assert codes[0] == 0 and codes[1] == 0
    assert reports["r0"]["pool_drained"] is True


def test_replica_without_cuda_raises():
    """The replica entry point defaults to the card and raises without
    one: no quiet fall back to the CPU."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    res = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.runtime.router", "--coord",
         "127.0.0.1:1", "--replica-id", "r0", "--rank", "0"],
        capture_output=True, text=True, timeout=120,
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert res.returncode != 0
    assert "cuda" in res.stderr.lower() or "CUDA" in res.stderr
