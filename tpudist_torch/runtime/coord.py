"""Rendezvous / coordination over the native (C++) store (counterpart of
:mod:`tpudist.runtime.coord`).

The control plane the reference delegates to external native libraries —
c10d TCPStore + torchrun rendezvous (`pytorch_elastic/mnist_ddp_elastic.py:5-6`)
and Horovod's C++ elastic controller with host discovery / blacklisting
(`horovod/horovod_mnist_elastic.py:108`): a small C++ TCP service
(``native/coord.cpp``, shared with the JAX package and loaded through
:func:`tpudist_torch._native.load_coord`) offering a key-value store,
blocking waits, named barriers, atomic counters, and TTL heartbeats.  The
wire protocol is the store's own, so a tpudist client and a port client
on one server see each other's keys, counters, barriers and leases.  On
top of it:

* :class:`CoordServer` / :class:`CoordClient` — thin ctypes handles.
* :class:`Rendezvous` — round-based worker assembly: every participant gets
  a dense rank and the round releases only when ``world_size`` workers have
  arrived (the c10d rendezvous contract).
* :class:`ElasticMonitor` — heartbeat publisher + liveness probe; its
  :meth:`check` raises :class:`~tpudist_torch.elastic.loop.WorldChanged`
  when membership shifts, which the elastic loop turns into rollback +
  re-rendezvous (Horovod-elastic semantics).

There is no Python stand-in for the store: without the library every
constructor raises :class:`NativeUnavailable`.

tpudist publishes the client's retries, backoffs and outages to its
metrics registry; the port has none yet (ROADMAP Queue A 10), so they are
plain counters on :data:`stats` and :data:`outage`.
"""

from __future__ import annotations

import ctypes
import os
import random
import threading
import time
import zlib

from tpudist_torch import _native
from tpudist_torch.runtime import faults as _faults

_VALUE_CAP = 1 << 20


class _Stats:
    """Process-wide client counters: ``retries`` (idempotent-op and
    refused-class retries) and ``backoff_s`` (the seconds their sleeps
    summed to)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.retries = 0
        self.backoff_s = 0.0

    def retried(self, nap: float) -> None:
        with self._lock:
            self.retries += 1
            self.backoff_s += nap


stats = _Stats()


class _OutageTracker:
    """Process-wide coord-availability bookkeeping.

    Every client op reports success/failure here; the first failure of a
    contiguous bad stretch opens an outage (``unavailable`` -> 1) and the
    first success after it closes it, adding the stretch to ``outages``
    and ``outage_s``.  The happy path is one lock-free attribute check."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._down_since: float | None = None
        self.unavailable = 0
        self.outages = 0
        self.outage_s = 0.0

    def down(self) -> None:
        with self._lock:
            if self._down_since is None:
                self._down_since = time.monotonic()
            self.unavailable = 1

    def up(self) -> None:
        if self._down_since is None:
            return
        with self._lock:
            since, self._down_since = self._down_since, None
            if since is None:
                return
            self.unavailable = 0
            self.outages += 1
            self.outage_s += time.monotonic() - since

    def is_down(self) -> bool:
        return self._down_since is not None


outage = _OutageTracker()


class NativeUnavailable(RuntimeError):
    """The native coordination library could not be built/loaded."""


def _lib():
    lib = _native.load_coord()
    if lib is None:
        raise NativeUnavailable(
            "the coordination library (native/coord.cpp) is unavailable: "
            "no g++ or the build failed")
    return lib


class CoordServer:
    """In-process coordination server; run one per job (usually on the
    coordinator host, or standalone via ``python -m
    tpudist_torch.runtime.coord``)."""

    def __init__(self, port: int = 0) -> None:
        self._lib = _lib()
        self._h = self._lib.tcs_server_start(port)
        if not self._h:
            raise OSError(f"could not bind coordination server on port {port}")
        self.port: int = self._lib.tcs_server_port(self._h)

    def stop(self) -> None:
        if self._h:
            self._lib.tcs_server_stop(self._h)
            self._h = None

    def __enter__(self) -> "CoordServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class CoordClient:
    """Client connection to a :class:`CoordServer` (possibly on another host;
    numeric IPs and hostnames both resolve).

    Transient-fault policy — the split is by IDEMPOTENCY, not by verb
    importance:

    * ``get`` / ``keys`` / ``live`` / ``heartbeat`` retry transparently
      on ``ConnectionError`` with bounded jittered exponential backoff
      (``retries`` attempts beyond the first; ``TPUDIST_COORD_RETRIES``
      overrides the default 2).  Re-running any of them is harmless: a
      read re-reads, and a heartbeat lease refresh applied twice is one
      refresh.  Each retry ticks :data:`stats` so a flaky control plane
      is visible before it becomes an outage.
    * ``add``, ``barrier`` — and the writes ``set`` / ``delete`` /
      ``wait`` — surface REAL RPC errors IMMEDIATELY.  They are not
      idempotent (or their failure is not observable as such): an
      ``add`` whose reply was lost may have been applied, so a blind
      client-side replay could double-count a rank or double-arrive at
      a barrier — exactly the split-brain the rendezvous layer exists
      to prevent.  Callers own the recovery semantics for those (e.g. a
      fresh rendezvous round).  The ONE exception is the
      "connection refused" class — a :class:`~tpudist_torch.runtime.
      faults.FaultInjected` outage fires BEFORE the request leaves the
      process, so nothing can have half-applied server-side and every
      verb retries it safely.

    Backoff is capped decorrelated jitter (``sleep = min(cap,
    uniform(base, 3 * prev_sleep))``): growth de-synchronizes a fleet
    of clients hit by the same blip, the cap bounds reconnect latency
    after a long brownout.  Each sleep adds to :data:`stats`;
    contiguous unreachability stretches drive the process-wide
    :data:`outage` tracker.

    Fault injection (:mod:`tpudist_torch.runtime.faults`) hooks every op, so
    both halves of this contract are exercised deterministically in
    tests."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout_ms: int = 10_000, retries: int | None = None,
                 retry_base_s: float = 0.02,
                 retry_cap_s: float | None = None) -> None:
        self._lib = _lib()
        self.host, self.port, self._timeout_ms = host, port, timeout_ms
        self._retries = (int(os.environ.get("TPUDIST_COORD_RETRIES", "2"))
                         if retries is None else int(retries))
        self._retry_base_s = float(retry_base_s)
        self._retry_cap_s = (
            float(os.environ.get("TPUDIST_COORD_RETRY_CAP_S", "1.0"))
            if retry_cap_s is None else float(retry_cap_s))
        self._h = self._lib.tcs_connect(host.encode(), port, timeout_ms)
        if not self._h:
            raise ConnectionError(f"could not reach coordination server {host}:{port}")
        # One request may be in flight per connection; serialize RPCs so a
        # client shared across threads (e.g. ElasticMonitor.check probing
        # from a collective's async worker while the owner thread polls)
        # cannot interleave frames on the socket.  RLock: keys() -> _joined.
        self._rpc_lock = threading.RLock()

    def clone(self) -> "CoordClient":
        """A fresh connection to the same server (one request is in flight
        per connection, so background threads need their own)."""
        return CoordClient(self.host, self.port, self._timeout_ms,
                           retries=self._retries,
                           retry_base_s=self._retry_base_s,
                           retry_cap_s=self._retry_cap_s)

    def _backoff(self, prev_sleep: float) -> float:
        """One capped decorrelated-jitter nap; returns the slept length
        (the next call's ``prev_sleep``)."""
        nap = min(self._retry_cap_s,
                  random.uniform(self._retry_base_s,
                                 max(self._retry_base_s, 3.0 * prev_sleep)))
        stats.retried(nap)
        time.sleep(nap)
        return nap

    def _retry(self, op: str, fn):
        """Run ``fn`` with the idempotent-op retry schedule (see class
        docstring)."""
        sleep = self._retry_base_s
        for attempt in range(self._retries + 1):
            try:
                result = fn()
            except ConnectionError:
                outage.down()
                if attempt >= self._retries:
                    raise
                sleep = self._backoff(sleep)
            else:
                outage.up()
                return result

    def _refused_gate(self, op: str) -> None:
        """Fault hook for the non-idempotent verbs.  During a DECLARED
        outage window FaultInjected fires BEFORE the RPC leaves the
        process — the refused class — so retrying it here cannot
        double-apply anything.  Probabilistic ``COORD_ERROR_P`` faults
        model an op whose server-side fate is unknown and keep
        surfacing immediately, like the real RPC errors raised by the
        verb body after this gate."""
        sleep = self._retry_base_s
        for attempt in range(self._retries + 1):
            try:
                _faults.coord_op(op)
            except _faults.FaultInjected:
                outage.down()
                if attempt >= self._retries \
                        or not _faults.plan().in_outage():
                    raise
                sleep = self._backoff(sleep)
            else:
                return

    def _direct(self, op: str, fn):
        """Run a non-idempotent verb: refused-class faults retry at the
        gate, the RPC itself runs at most once and surfaces its error
        immediately (split-brain rule)."""
        self._refused_gate(op)
        try:
            result = fn()
        except ConnectionError:
            outage.down()
            raise
        outage.up()
        return result

    # -- kv ----------------------------------------------------------------
    def set(self, key: str, value: bytes | str) -> None:
        if isinstance(value, str):
            value = value.encode()

        def once() -> None:
            with self._rpc_lock:
                if self._lib.tcs_set(self._h, key.encode(), value,
                                     len(value)) != 0:
                    raise ConnectionError("set failed")

        self._direct("set", once)

    def get(self, key: str) -> bytes | None:
        return self._retry("get", lambda: self._get_once(key))

    def _get_once(self, key: str) -> bytes | None:
        _faults.coord_op("get")
        cap = _VALUE_CAP
        while True:
            buf = ctypes.create_string_buffer(cap)
            out_len = ctypes.c_uint32()
            with self._rpc_lock:
                rc = self._lib.tcs_get(self._h, key.encode(), buf, cap,
                                       ctypes.byref(out_len))
            if rc == 1:
                return None
            if rc == 2:  # buffer too small; out_len holds the needed size
                cap = out_len.value
                continue
            if rc != 0:
                raise ConnectionError("get failed")
            return buf.raw[: out_len.value]

    def add(self, key: str, delta: int) -> int:
        # the RPC is NOT retried: a lost reply may still have
        # incremented the counter server-side — see the class docstring

        def once() -> int:
            with self._rpc_lock:
                v = self._lib.tcs_add(self._h, key.encode(), delta)
            if v == -(2**63):
                raise ConnectionError("add failed")
            return int(v)

        return self._direct("add", once)

    def wait(self, key: str, timeout_s: float = 30.0) -> bool:
        def once() -> bool:
            with self._rpc_lock:
                rc = self._lib.tcs_wait(self._h, key.encode(),
                                        int(timeout_s * 1000))
            if rc < 0:
                raise ConnectionError("wait failed")
            return rc == 0

        return self._direct("wait", once)

    def delete(self, key: str) -> None:
        def once() -> None:
            with self._rpc_lock:
                if self._lib.tcs_del(self._h, key.encode()) != 0:
                    raise ConnectionError("del failed")

        self._direct("delete", once)

    def keys(self, prefix: str = "") -> list[str]:
        def once() -> list[str]:
            _faults.coord_op("keys")
            joined = self._joined(
                lambda buf, cap, out: self._lib.tcs_keys(
                    self._h, prefix.encode(), buf, cap, out)
            )
            return joined.split(",") if joined else []

        return self._retry("keys", once)

    def _joined(self, call) -> str:
        cap = _VALUE_CAP
        while True:
            buf = ctypes.create_string_buffer(cap)
            out_len = ctypes.c_uint32()
            with self._rpc_lock:
                rc = call(buf, cap, ctypes.byref(out_len))
            if rc == 2:
                cap = out_len.value
                continue
            if rc != 0:
                raise ConnectionError("query failed")
            return buf.raw[: out_len.value].decode()

    # -- synchronization ---------------------------------------------------
    def barrier(self, name: str, count: int, timeout_s: float = 60.0) -> bool:
        """Block until ``count`` participants arrive at ``name``.  Returns
        False on timeout (the arrival is withdrawn server-side).

        Holds the connection's RPC lock for the whole wait — do not share
        a client between a thread that barriers and one that polls.

        NOT retried on error: a barrier arrival whose reply was lost may
        still be counted server-side, and a client-side replay would
        arrive twice — see the class docstring."""

        def once() -> bool:
            with self._rpc_lock:
                rc = self._lib.tcs_barrier(self._h, name.encode(), count,
                                           int(timeout_s * 1000))
            if rc < 0:
                raise ConnectionError("barrier failed")
            return rc == 0

        return self._direct("barrier", once)

    # -- liveness ----------------------------------------------------------
    def heartbeat(self, worker: str, ttl_s: float) -> None:
        """Refresh ``worker``'s liveness lease; ``ttl_s <= 0`` leaves.
        Idempotent (a lease refreshed twice is one refresh), so transient
        errors retry."""
        if _faults.drop_heartbeat():
            # injected heartbeat loss: the refresh silently never leaves
            # this process — the TTL plane will declare us dead while we
            # keep running (the false-positive a router must survive)
            return

        def once() -> None:
            _faults.coord_op("heartbeat")
            with self._rpc_lock:
                if self._lib.tcs_heartbeat(self._h, worker.encode(),
                                           int(ttl_s * 1000)) != 0:
                    raise ConnectionError("heartbeat failed")

        self._retry("heartbeat", once)

    def live(self) -> set[str]:
        def once() -> set[str]:
            _faults.coord_op("live")
            joined = self._joined(
                lambda buf, cap, out: self._lib.tcs_live(
                    self._h, buf, cap, out)
            )
            return set(joined.split(",")) if joined else set()

        return self._retry("live", once)

    def close(self) -> None:
        if self._h:
            self._lib.tcs_close(self._h)
            self._h = None

    def __enter__(self) -> "CoordClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Rendezvous:
    """Round-based rendezvous: dense rank assignment + all-arrived barrier.

    Each elastic restart is a new ``round``; all surviving/new workers call
    :meth:`join` with the same round number and world size, get back a dense
    rank in ``[0, world)``, and return together (the torchrun
    restart-on-membership-change contract, SURVEY.md §5)."""

    def __init__(self, client: CoordClient, namespace: str = "rdzv") -> None:
        self.client = client
        self.ns = namespace

    def join(self, round: int, world_size: int, timeout_s: float = 60.0) -> int:
        rank = self.client.add(f"{self.ns}/{round}/rank", 1) - 1
        if rank >= world_size:
            raise RuntimeError(
                f"rendezvous round {round} overflow: rank {rank} >= world {world_size}"
            )
        if not self.client.barrier(f"{self.ns}/{round}/barrier", world_size,
                                   timeout_s):
            raise TimeoutError(
                f"rendezvous round {round}: {world_size} workers did not arrive"
            )
        return rank

    def join_live(
        self,
        round: int,
        worker_id: str,
        timeout_s: float = 60.0,
        settle_s: float = 0.3,
        min_world: int = 1,
        min_world_grace_s: float = 10.0,
        superseded_key: str | None = None,
    ) -> tuple[int, int, list[str]]:
        """Dynamic-membership rendezvous: the round's world is whatever set
        of LIVE workers registers before membership stabilizes — the c10d
        contract torchrun relies on to re-form a world after failures
        (`mnist_ddp_elastic.py:5-6`), with the world size *discovered*, not
        prescribed.

        Protocol: register under ``{ns}/{round}/member/{id}``; poll until
        the registered-and-live set has been stable for ``settle_s``; then
        confirm agreement with a barrier keyed by the membership fingerprint
        — every participant must have computed the SAME set, else the
        barrier times out and the poll resumes (a straggler registered
        during someone's settle window).  Requires the caller's heartbeat
        (``ElasticMonitor.start``) to already be running so it appears in
        ``live()``.

        ``min_world`` is a SOFT assembly target: settling is deferred until
        that many members registered or ``min_world_grace_s`` elapsed —
        without it, the first arrival of a gang whose peers are still
        importing would form a world of one and force an immediate resize
        cascade.  After the grace the round forms with whoever is there
        (liveness over the target: a pre-registration death must not hang
        the gang).

        ``superseded_key`` names a store key publishing the highest round
        already FORMED (the elastic loop's ``elastic/round``).  If its
        value ever exceeds ``round``, this round is dead — the gang moved
        on while we lagged — and joining raises :class:`TimeoutError`
        immediately instead of settling into a splinter world of the
        leftovers (the caller's timeout handler re-reads the published
        round and jumps forward).

        Returns ``(rank, world_size, members)``; ranks are the sorted
        member order — dense, deterministic, identical everywhere.
        """
        self.client.set(f"{self.ns}/{round}/member/{worker_id}", b"1")
        start = time.monotonic()
        deadline = start + timeout_s
        grace_end = start + min(min_world_grace_s, timeout_s / 2)
        # second, longer grace for the defer-on-live-non-members rule
        # below: enough for a training gang to reach its next commit
        # point, but BOUNDED so one live-but-hung worker (heartbeat
        # thread alive, main thread wedged) cannot stall rendezvous to
        # the full timeout forever
        live_grace_end = start + min(3 * min_world_grace_s,
                                     0.75 * timeout_s)
        prefix = f"{self.ns}/{round}/member/"
        stable_since: float | None = None
        prev: frozenset[str] = frozenset()
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rendezvous round {round}: membership never stabilized "
                    f"(last saw {sorted(prev)})")
            if superseded_key is not None:
                raw = self.client.get(superseded_key)
                if raw is not None and int(raw) > round:
                    raise TimeoutError(
                        f"rendezvous round {round} superseded: round "
                        f"{int(raw)} already formed")
            live = self.client.live()
            registered = frozenset(
                k[len(prefix):] for k in self.client.keys(prefix))
            if worker_id not in registered:
                # re-assert: a concurrent newer round's rank 0 may have
                # swept this round's member keys while we were settling
                # (the rounds-form-concurrently race) — registration must
                # survive the sweep or we poll into the timeout
                self.client.set(f"{prefix}{worker_id}", b"1")
                registered = registered | {worker_id}
            members = registered & live
            now = time.monotonic()
            if len(members) < min_world and (
                    now < grace_end
                    or (live - members and now < live_grace_end)):
                # Defer sub-target formation while workers are ALIVE but
                # not yet registered here: their heartbeats force the
                # incumbents' next check() to raise WorldChanged, so they
                # WILL arrive (or we time out and jump forward).  Without
                # this, a laggard whose grace expires before the gang's
                # next commit point forms a splinter world of one.  A
                # worker that died pre-registration is not in live(), so
                # the liveness-over-target rule still holds — and the
                # defer itself expires at live_grace_end, so a hung-but-
                # heartbeating worker can only delay formation, not
                # starve it into the max_rounds crash.
                prev, stable_since = members, now
                time.sleep(0.05)
                continue
            if worker_id not in members or members != prev:
                prev, stable_since = members, now
                time.sleep(0.05)
                continue
            if now - (stable_since or now) < settle_s:
                time.sleep(0.05)
                continue
            ordered = sorted(members)
            fingerprint = ",".join(ordered)
            # agreement barrier: releases only if every member computed
            # this exact set; a mismatch (someone saw a different set)
            # times out server-side and withdraws the arrival
            # crc32, not hash(): str hashing is salted per-process and the
            # key must be identical on every participant
            if self.client.barrier(
                    f"{self.ns}/{round}/agree/"
                    f"{zlib.crc32(fingerprint.encode())}/{len(ordered)}",
                    len(ordered), timeout_s=max(2 * settle_s, 1.0)):
                rank = ordered.index(worker_id)
                if rank == 0:
                    self._sweep_stale_rounds(round)
                return rank, len(ordered), ordered
            # Disagreement: reset `prev` so the next poll re-arms the
            # settle clock and the barrier is retried — clearing only
            # stable_since would livelock when membership stays unchanged
            # (prev == members would skip every re-arm branch forever).
            prev = frozenset()

    def _sweep_stale_rounds(self, current_round: int) -> None:
        """Delete dead rounds' member registrations — without this a
        long-lived elastic job leaks O(world) store keys per resize round
        (ADVICE r2).  Run by the new round's rank 0 after agreement; old
        rounds' keys are only read during their own join, so survivors of
        round N never look at round < N again."""
        prefix = f"{self.ns}/"
        for k in self.client.keys(prefix):
            rest = k[len(prefix):]
            head, _, tail = rest.partition("/")
            if not tail.startswith("member/"):
                continue
            try:
                r = int(head)
            except ValueError:
                continue
            if r < current_round:
                self.client.delete(k)


class ElasticMonitor:
    """Heartbeat publisher + membership watcher for one worker.

    A daemon thread refreshes this worker's TTL lease over its OWN
    connection — the caller's connection may sit inside a long blocking
    barrier (rendezvous for a slow-restarting peer), which must not starve
    heartbeats past the TTL.  :meth:`check` (called at commit points, the
    moral twin of Horovod's per-batch membership poll) raises
    :class:`WorldChanged` when the live set no longer matches the expected
    world."""

    def __init__(
        self,
        client: CoordClient,
        worker_id: str,
        ttl_s: float = 3.0,
        interval_s: float = 1.0,
    ) -> None:
        self.client = client
        self.worker_id = worker_id
        self.ttl_s = ttl_s
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._beat_client: CoordClient | None = None
        self.expected_world: int | None = None

    def start(self, expected_world: int) -> None:
        self.expected_world = expected_world
        self._beat_client = self.client.clone()
        self._beat_client.heartbeat(self.worker_id, self.ttl_s)
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()

    def _beat(self) -> None:
        # a coord brownout must not permanently kill the lease thread:
        # keep trying with jittered exponential backoff (capped well
        # below nothing — the lease has already lapsed server-side, the
        # point is to re-establish it the moment the store returns) and
        # snap back to the normal cadence on the first success
        delay = self.interval_s
        while not self._stop.wait(delay):
            try:
                self._beat_client.heartbeat(self.worker_id, self.ttl_s)
                delay = self.interval_s
            except ConnectionError:
                delay = min(8.0, max(delay, self.interval_s) * 2.0) \
                    * (0.5 + random.random())

    def check(self) -> None:
        """Raise ``WorldChanged(new_size)`` if membership shifted."""
        from tpudist_torch.elastic.loop import WorldChanged

        live = self.client.live()
        if self.expected_world is not None and len(live) != self.expected_world:
            raise WorldChanged(len(live))

    def resize(self, new_world: int) -> None:
        self.expected_world = new_world

    def stop(self, graceful: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if graceful:
            try:
                self.client.heartbeat(self.worker_id, 0)  # leave
            except ConnectionError:
                pass
        if self._beat_client is not None:
            self._beat_client.close()
            self._beat_client = None


def main() -> None:  # pragma: no cover - CLI utility
    """Run a standalone coordination server: ``python -m
    tpudist_torch.runtime.coord``."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        description="tpudist_torch coordination server")
    ap.add_argument("--port", type=int, default=29400)
    args = ap.parse_args()
    server = CoordServer(args.port)
    print(f"tpudist_torch coordination server listening on "
          f":{server.port}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    while not stop.wait(1.0):
        pass
    server.stop()


if __name__ == "__main__":  # pragma: no cover
    main()
