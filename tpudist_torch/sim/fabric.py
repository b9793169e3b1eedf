"""In-memory coordination fabric for the offline fleet simulator
(counterpart of :mod:`tpudist.sim.fabric`).

The real fleet coordinates through :class:`tpudist_torch.runtime.coord
.CoordClient` verbs over a TCP KV service; the simulator swaps in this
process-local stand-in (the ``FakeCoord`` discipline the unit tests
already use, promoted to library code) so the REAL ``Router`` and
``Autoscaler`` run unmodified: same key layout (``{ns}/inbox/...``,
``{ns}/done/...``, ``{ns}/draining/...``), same wire encodings, same
heartbeat-lease liveness — just a dict and a set instead of sockets.

Leases are explicit (:meth:`up` / :meth:`down`): simulated replicas
flip their own liveness at virtual-time boundaries instead of running
heartbeat threads, which is exactly what makes death/drain timing
deterministic under the virtual clock.

Chaos: :meth:`add_outage` declares coord-brownout windows on
the VIRTUAL clock — every client verb raises
:class:`~tpudist_torch.runtime.faults.FaultInjected` (a ``ConnectionError``)
while one is open, which is exactly what the real store's
unreachability looks like to the router/replica/autoscaler brownout
paths.  Lease flips (:meth:`up`/:meth:`down`) model SERVER-side state
and stay outage-exempt: leases neither refresh nor lapse differently
because a client could not reach the store.
"""

from __future__ import annotations

import threading

from tpudist_torch.runtime.faults import FaultInjected

__all__ = ["SimFabric"]


class SimFabric:
    """Process-local CoordClient stand-in: the KV + liveness verbs the
    router, autoscaler, and metrics planes reach for.

    ``clock`` (a zero-arg monotonic, normally ``VirtualClock
    .monotonic``) is only needed when outage windows are declared."""

    def __init__(self, clock=None) -> None:
        self.kv: dict[str, bytes] = {}
        self.live_set: set[str] = set()
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()
        self._clock = clock
        self._outages: list[tuple[float, float]] = []

    # -- chaos -------------------------------------------------------------

    def add_outage(self, start_s: float, end_s: float) -> None:
        """Declare a coord-brownout window ``[start_s, end_s)`` on the
        clock: every client verb raises ``FaultInjected`` inside it."""
        if self._clock is None:
            raise ValueError("SimFabric needs a clock= for outages")
        if not end_s > start_s >= 0:
            raise ValueError(
                f"bad outage window [{start_s}, {end_s})")
        self._outages.append((float(start_s), float(end_s)))

    def in_outage(self) -> bool:
        if self._clock is None or not self._outages:
            return False
        now = self._clock()
        return any(s <= now < e for s, e in self._outages)

    def _gate(self, op: str) -> None:
        if self.in_outage():
            raise FaultInjected(
                f"injected fault: sim coord outage ({op})")

    # -- KV verbs ----------------------------------------------------------

    def keys(self, prefix: str = "") -> list[str]:
        self._gate("keys")
        with self._lock:
            return [k for k in self.kv if k.startswith(prefix)]

    def get(self, key: str) -> bytes | None:
        self._gate("get")
        with self._lock:
            return self.kv.get(key)

    def set(self, key: str, value: bytes) -> None:
        self._gate("set")
        with self._lock:
            self.kv[key] = value

    def delete(self, key: str) -> None:
        self._gate("delete")
        with self._lock:
            self.kv.pop(key, None)

    def add(self, key: str, delta: int) -> int:
        self._gate("add")
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + int(delta)
            return self.counters[key]

    # -- liveness (heartbeat leases, simulated) ----------------------------

    def live(self) -> set[str]:
        self._gate("live")
        with self._lock:
            return set(self.live_set)

    def up(self, name: str) -> None:
        """Grant a lease (a simulated replica's first heartbeat)."""
        with self._lock:
            self.live_set.add(name)

    def down(self, name: str) -> None:
        """Lapse a lease (clean exit or simulated death)."""
        with self._lock:
            self.live_set.discard(name)

    # -- client lifecycle (API-compat no-ops) ------------------------------

    def clone(self) -> "SimFabric":
        return self

    def close(self) -> None:
        pass
