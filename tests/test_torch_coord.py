"""The port's coordination client (``tpudist_torch.runtime.coord``) over
the native store, held against tpudist's.

Interop: a tpudist client and a port client on one server (either
package's) see each other's keys, counters, barriers and leases, and
``join_live`` gives the same dense ranks for the same worker ids, alone
or in a mixed gang.  The retry split (idempotent verbs retry, the others
surface at once, a declared outage retries everywhere) follows the port's
``FaultPlan`` as tpudist's follows its own, verb for verb.  The rest are
the twins of ``tests/test_native_coord.py`` on the port: N worker threads
standing in for N hosts."""

import os
import signal
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from tpudist_torch import _native
from tpudist_torch.runtime import coord as port_coord
from tpudist_torch.runtime import faults as port_faults
from tpudist_torch.runtime.coord import (
    CoordClient,
    CoordServer,
    ElasticMonitor,
    NativeUnavailable,
    Rendezvous,
)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture()
def server():
    s = CoordServer(0)
    yield s
    s.stop()


@pytest.fixture()
def client(server):
    c = CoordClient("127.0.0.1", server.port)
    yield c
    c.close()


def test_set_get_del(client):
    assert client.get("missing") is None
    client.set("k", b"value-bytes")
    assert client.get("k") == b"value-bytes"
    client.set("k", "overwritten")
    assert client.get("k") == b"overwritten"
    client.delete("k")
    assert client.get("k") is None


def test_connect_resolves_hostnames(server):
    with CoordClient("localhost", server.port) as c:  # DNS path, not inet_pton
        c.set("via-hostname", b"1")
        assert c.get("via-hostname") == b"1"


def test_values_larger_than_default_buffer(client):
    big = bytes(range(256)) * (8 * 1024)  # 2 MiB > 1 MiB default read buffer
    client.set("big", big)
    assert client.get("big") == big


def test_counter_is_atomic_across_connections(server):
    n_threads, n_incs = 8, 50

    def bump():
        with CoordClient("127.0.0.1", server.port) as c:
            for _ in range(n_incs):
                c.add("ctr", 1)

    threads = [threading.Thread(target=bump) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with CoordClient("127.0.0.1", server.port) as c:
        # counters are stored as raw little-endian i64
        assert struct.unpack("<q", c.get("ctr"))[0] == n_threads * n_incs
        assert c.add("ctr", 0) == n_threads * n_incs


def test_wait_blocks_until_set(server, client):
    t0 = time.monotonic()
    assert not client.wait("later", timeout_s=0.2)  # times out, key absent
    assert time.monotonic() - t0 >= 0.2

    def setter():
        time.sleep(0.15)
        with CoordClient("127.0.0.1", server.port) as c:
            c.set("later", b"1")

    threading.Thread(target=setter).start()
    assert client.wait("later", timeout_s=5.0)


def test_keys_prefix(client):
    for k in ("a/1", "a/2", "b/1"):
        client.set(k, b"x")
    assert client.keys("a/") == ["a/1", "a/2"]
    assert set(client.keys("")) == {"a/1", "a/2", "b/1"}


def test_barrier_releases_all_and_reuses(server):
    world = 4
    released = []

    def worker(i):
        with CoordClient("127.0.0.1", server.port) as c:
            for round in range(3):  # same name is reusable across rounds
                assert c.barrier("b", world, timeout_s=10.0)
            released.append(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(released) == list(range(world))


def test_barrier_timeout_withdraws_arrival(server, client):
    assert not client.barrier("lonely", 2, timeout_s=0.2)
    # The timed-out arrival must not linger: a fresh pair releases cleanly.
    ok = []

    def arrive():
        with CoordClient("127.0.0.1", server.port) as c:
            ok.append(c.barrier("lonely", 2, timeout_s=5.0))

    threads = [threading.Thread(target=arrive) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ok == [True, True]


def test_heartbeat_liveness_and_expiry(client):
    client.heartbeat("w0", ttl_s=10.0)
    client.heartbeat("w1", ttl_s=0.15)
    assert client.live() == {"w0", "w1"}
    time.sleep(0.3)
    assert client.live() == {"w0"}  # w1's lease expired
    client.heartbeat("w0", ttl_s=0)  # graceful leave
    assert client.live() == set()


def test_rendezvous_assigns_dense_ranks(server):
    world = 5
    ranks = []
    lock = threading.Lock()

    def join():
        with CoordClient("127.0.0.1", server.port) as c:
            r = Rendezvous(c).join(round=0, world_size=world, timeout_s=10.0)
            with lock:
                ranks.append(r)

    threads = [threading.Thread(target=join) for _ in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(ranks) == list(range(world))


def test_elastic_monitor_detects_world_change(server):
    from tpudist_torch.elastic.loop import WorldChanged

    c0 = CoordClient("127.0.0.1", server.port)
    c1 = CoordClient("127.0.0.1", server.port)
    m0 = ElasticMonitor(c0, "w0", ttl_s=0.5, interval_s=0.1)
    m1 = ElasticMonitor(c1, "w1", ttl_s=0.5, interval_s=0.1)
    m0.start(expected_world=2)
    m1.start(expected_world=2)
    time.sleep(0.2)
    m0.check()  # both alive: no exception

    m1.stop(graceful=True)  # worker 1 leaves -> membership shrinks
    with pytest.raises(WorldChanged) as e:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            m0.check()
            time.sleep(0.05)
    assert e.value.new_world_size == 1
    m0.resize(1)
    m0.check()  # re-based expectation: healthy again
    m0.stop()
    c0.close()
    c1.close()


def test_elastic_rendezvous_restart_cycle(server):
    """Full elastic cycle: 3 workers train, one dies, survivors detect the
    change, re-rendezvous as a 2-world, and get fresh dense ranks."""
    from tpudist_torch.elastic.loop import WorldChanged

    results = {}
    lock = threading.Lock()

    def worker(wid, dies):
        c = CoordClient("127.0.0.1", server.port)
        rdzv = Rendezvous(c)
        # Under a loaded runner two races let a survivor see a world of 1
        # (it then re-formed alone: results {1: (1, 0, 1)}): a worker
        # starved between the barrier and its first heartbeat had no
        # lease yet when a peer first checked, and a 0.4 s lease lapsed
        # under a starved heartbeat thread.  So each worker takes its
        # lease BEFORE the rendezvous (the barrier then guarantees all
        # three exist before anyone checks), with the superseded-round
        # test's lease; the preempted worker leaves gracefully, which no
        # TTL delays.
        mon = ElasticMonitor(c, f"w{wid}", ttl_s=2.0, interval_s=0.3)
        mon.start(expected_world=3)
        rank = rdzv.join(0, 3, timeout_s=10.0)
        if dies:
            time.sleep(0.2)
            mon.stop(graceful=True)  # simulated preemption
            c.close()
            return
        try:
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                mon.check()
                time.sleep(0.05)
            raise AssertionError("membership change never detected")
        except WorldChanged as e:
            new_world = e.new_world_size
        mon.resize(new_world)
        new_rank = rdzv.join(1, new_world, timeout_s=10.0)
        with lock:
            results[wid] = (rank, new_rank, new_world)
        mon.stop()
        c.close()

    threads = [
        threading.Thread(target=worker, args=(i, i == 2)) for i in range(3)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(results) == {0, 1}, results
    assert {r for _, r, _ in results.values()} == {0, 1}, results  # dense
    assert all(w == 2 for _, _, w in results.values()), results


def test_join_live_superseded_round_aborts(server):
    """A worker lagging in a round the gang already moved past must abort
    (TimeoutError) instead of settling into a splinter world of one
    (code-review r3): the superseded_key publishes the highest FORMED
    round; seeing a higher value kills the join immediately."""
    c = CoordClient("127.0.0.1", server.port)
    mon = ElasticMonitor(c, "laggard", ttl_s=2.0, interval_s=0.3)
    mon.start(None)
    c.set("elastic/round", "7")
    rdzv = Rendezvous(c)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="superseded"):
        rdzv.join_live(5, "laggard", timeout_s=30.0, min_world=2,
                       superseded_key="elastic/round")
    assert time.monotonic() - t0 < 5.0  # aborted, not timed out
    mon.stop()
    c.close()


def test_stale_round_member_keys_swept(server):
    """Rank 0 of a formed round sweeps dead rounds' member registrations
    (the O(world)-keys-per-resize leak, ADVICE r2) without touching the
    current round's."""
    c = CoordClient("127.0.0.1", server.port)
    # litter: two dead rounds' worth of member keys
    for r in (0, 1):
        for w in ("a", "b", "c"):
            c.set(f"rdzv/{r}/member/{w}", b"1")
    mon = ElasticMonitor(c, "w0", ttl_s=2.0, interval_s=0.3)
    mon.start(None)
    rank, world, members = Rendezvous(c).join_live(
        2, "w0", timeout_s=10.0, settle_s=0.1)
    assert (rank, world) == (0, 1) and members == ["w0"]
    assert c.keys("rdzv/0/member/") == []
    assert c.keys("rdzv/1/member/") == []
    assert c.keys("rdzv/2/member/") == ["rdzv/2/member/w0"]
    mon.stop()
    c.close()


# ---------------------------------------------------------------------------
# interop with tpudist's client, and the same contracts


def _ref():
    from tpudist.runtime import coord as ref_coord
    from tpudist.runtime import faults as ref_faults

    return ref_coord, ref_faults


@pytest.fixture(params=["port", "tpudist"])
def any_server(request):
    """A store started by either package (one C++ source, two builds)."""
    mod = port_coord if request.param == "port" else _ref()[0]
    s = mod.CoordServer(0)
    yield s
    s.stop()


def test_clients_of_both_packages_share_one_store(any_server):
    ref_coord, _ = _ref()
    with CoordClient("127.0.0.1", any_server.port) as p, \
            ref_coord.CoordClient("127.0.0.1", any_server.port) as t:
        p.set("x/port", b"from-port")
        t.set("x/ref", b"from-ref")
        assert t.get("x/port") == b"from-port"
        assert p.get("x/ref") == b"from-ref"
        assert p.keys("x/") == t.keys("x/") == ["x/port", "x/ref"]
        assert p.add("ctr", 2) == 2 and t.add("ctr", 3) == 5
        assert p.add("ctr", 0) == 5
        t.delete("x/port")
        assert p.get("x/port") is None
        # leases: one side beats, the other sees it live and expire
        p.heartbeat("wp", 10.0)
        t.heartbeat("wt", 0.15)
        assert p.live() == t.live() == {"wp", "wt"}
        time.sleep(0.3)
        assert t.live() == {"wp"}
        p.heartbeat("wp", 0)
        # a blocking wait released by the other package's set
        threading.Timer(0.1, lambda: t.set("later", b"1")).start()
        assert p.wait("later", timeout_s=5.0)
        # a barrier of one client of each
        ok = []
        th = threading.Thread(target=lambda: ok.append(
            t.barrier("mixed", 2, timeout_s=10.0)))
        th.start()
        ok.append(p.barrier("mixed", 2, timeout_s=10.0))
        th.join()
        assert ok == [True, True]


def test_join_live_ranks_agree_across_packages(server):
    """The same worker ids get the same dense ranks and member list from
    tpudist's rendezvous, the port's, and a gang mixing the two."""
    ref_coord, _ = _ref()
    ids = ["w3", "a0", "w10", "b7"]

    def run(ns, which):
        out = {}
        lock = threading.Lock()

        def join(i, wid):
            mod = port_coord if which(i) else ref_coord
            with mod.CoordClient("127.0.0.1", server.port) as c:
                c.heartbeat(wid, 10.0)
                got = mod.Rendezvous(c, namespace=ns).join_live(
                    0, wid, timeout_s=30, min_world=len(ids))
                c.heartbeat(wid, 0)
            with lock:
                out[wid] = got

        threads = [threading.Thread(target=join, args=(i, w))
                   for i, w in enumerate(ids)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        return out

    ref = run("jl-ref", lambda i: False)
    port = run("jl-port", lambda i: True)
    mixed = run("jl-mixed", lambda i: i % 2 == 0)
    assert ref == port == mixed
    assert [ref[w][0] for w in sorted(ids)] == list(range(len(ids)))
    assert all(got == (ref[w][0], 4, sorted(ids)) for w, got in ref.items())


def _fail_first(faults_mod, n):
    """A plan raising on its first ``n`` coord ops (a transient blip)."""

    class FailFirstN(faults_mod.FaultPlan):
        def __init__(self):
            super().__init__()
            self.active = True
            self.calls = 0

        def coord_op(self, op):
            self.calls += 1
            if self.calls <= n:
                raise faults_mod.FaultInjected(f"injected: {op} #{self.calls}")

    return FailFirstN()


_VERBS = {
    "get": lambda c: c.get("k"),
    "keys": lambda c: c.keys("k"),
    "live": lambda c: c.live(),
    "heartbeat": lambda c: c.heartbeat("hb", 5.0),
    "set": lambda c: c.set("k2", b"v"),
    "add": lambda c: c.add("ctr-split", 1),
    "delete": lambda c: c.delete("k2"),
    "wait": lambda c: c.wait("k", timeout_s=0.1),
    "barrier": lambda c: c.barrier("solo", 1, timeout_s=1.0),
}


def _split_outcome(coord_mod, faults_mod, port, verb, plan):
    """(raised, attempts) of one verb under ``plan``."""
    with coord_mod.CoordClient("127.0.0.1", port, retries=2) as c:
        c.set("k", b"v")
        faults_mod.install(plan)
        try:
            try:
                _VERBS[verb](c)
                raised = False
            except faults_mod.FaultInjected:
                raised = True
        finally:
            faults_mod.reset()
        return raised, getattr(plan, "calls", None)


@pytest.mark.parametrize("verb", sorted(_VERBS))
@pytest.mark.parametrize("failures", [1, 2, 10])
def test_retry_split_follows_tpudist(server, verb, failures):
    """Under ``failures`` transient faults each verb retries (idempotent:
    get, keys, live, heartbeat) or surfaces at once (set, add, delete,
    wait, barrier) exactly as tpudist's client does; retries=2 rides
    through two faults, not ten."""
    ref_coord, ref_faults = _ref()
    got = _split_outcome(port_coord, port_faults, server.port, verb,
                         _fail_first(port_faults, failures))
    want = _split_outcome(ref_coord, ref_faults, server.port, verb,
                          _fail_first(ref_faults, failures))
    assert got == want
    idempotent = verb in ("get", "keys", "live", "heartbeat")
    assert got == ((failures > 2, min(failures, 2) + 1 if failures <= 2
                    else 3) if idempotent else (True, 1))


def test_retries_are_counted(server):
    before = port_coord.stats.retries
    plan = _fail_first(port_faults, 2)
    with CoordClient("127.0.0.1", server.port) as c:
        c.set("k", b"v")
        port_faults.install(plan)
        try:
            assert c.get("k") == b"v"
        finally:
            port_faults.reset()
    assert plan.calls == 3
    assert port_coord.stats.retries - before == 2
    assert port_coord.stats.backoff_s > 0


@pytest.mark.parametrize("verb", ["add", "set", "barrier"])
def test_declared_outage_retries_every_verb(server, verb):
    """During a declared outage the fault fires before the RPC leaves the
    process, so even a non-idempotent verb retries through a window that
    closes inside the budget — as in tpudist; the outage is counted."""
    outages = port_coord.outage.outages
    with CoordClient("127.0.0.1", server.port, retries=30) as c:
        port_faults.install(port_faults.FaultPlan(coord_outage_at_s=0.0,
                                                  coord_outage_s=0.15))
        try:
            _VERBS[verb](c)
            assert port_faults.plan().injected["coord_outage"] >= 1
        finally:
            port_faults.reset()
    assert port_coord.outage.outages > outages
    assert port_coord.outage.unavailable == 0


def test_heartbeat_drop_swallows_lease_refresh(server):
    with CoordClient("127.0.0.1", server.port) as c:
        port_faults.install(port_faults.FaultPlan(heartbeat_stop_after_s=0))
        try:
            c.heartbeat("hb-dropped", 5.0)
            assert "hb-dropped" not in c.live()
        finally:
            port_faults.reset()
        c.heartbeat("hb-live", 5.0)
        assert "hb-live" in c.live()
        c.heartbeat("hb-live", 0.0)


def test_missing_library_raises_native_unavailable(monkeypatch, tmp_path):
    """No Python stand-in for the store: without the library every
    constructor raises."""
    monkeypatch.setattr(_native, "_SOURCES", {
        **_native._SOURCES, "coord": tmp_path / "missing.cpp"})
    monkeypatch.setattr(_native, "_libs", {})
    with pytest.raises(NativeUnavailable, match="coord.cpp"):
        CoordServer(0)
    with pytest.raises(NativeUnavailable):
        CoordClient("127.0.0.1", 1)


def test_cli_serves_until_sigterm(tmp_path):
    """``python -m tpudist_torch.runtime.coord --port 0`` prints its port,
    serves a client, and exits 0 on SIGTERM."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpudist_torch.runtime.coord", "--port", "0"],
        env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "listening on :" in line, line
        port = int(line.rsplit(":", 1)[1])
        with CoordClient("127.0.0.1", port) as c:
            c.set("cli", b"up")
            assert c.get("cli") == b"up"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
