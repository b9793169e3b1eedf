"""Quarantine: the router's third replica state besides live and dead
(counterpart of :mod:`tpudist.runtime.quarantine`).

The fleet's crash-fault machinery (the router's death sweep) handles
replicas that VANISH — lease lapses, inbox drained, work redispatched.
The byzantine
complement is a replica that stays alive and WRONG: flaky HBM flipping
payload bits, NaN-poisoned decode state, a link corrupting frames.
Killing it on the first bad payload is the wrong reflex (one flipped
bit on a healthy node would halve a two-replica fleet); trusting it is
worse (it keeps serving garbage).  Quarantine is the middle state:

* **strikes** — every integrity signal the fleet can attribute to a
  replica (a checksum mismatch on its committed payload, a
  ``corrupt_segment`` / ``wire_error`` verdict it reported, a failed
  golden probe) lands here as a STRIKE.  Strikes age out of a sliding
  window; ``strike_threshold`` strikes inside ``strike_window_s``
  quarantines the replica.
* **quarantined** — the replica is excluded from dispatch (the router
  drops it from candidates and redispatches its outstanding work) and
  marked in the store (``{ns}/quarantined/{rid}``) so the autoscaler
  counts its capacity as missing and backfills — but it is NOT
  stopped: it keeps heartbeating and polling its inbox, which is
  exactly what lets it be probed.
* **golden probes** — the quarantine loop periodically sends the
  replica a fixed probe request (``probe-{rid}-{seq}`` key, outside
  the router's request sequence space) whose greedy output is known
  exactly — the same warmed-but-wrong check the blue-green canary
  runs at rollout time, running in steady state.  ``reinstate_after``
  CONSECUTIVE exact passes lift the quarantine; ``retire_after_fails``
  total failures (mismatch, undecodable completion, or probe timeout)
  retire the replica with a terminal verdict — a targeted stop, after
  which the normal death sweep cleans up.

Every decision is driven by an injectable monotonic clock, so the
state machine is unit-testable without sleeping and runs unchanged on
the offline simulator's virtual clock.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from tpudist_torch import obs
from tpudist_torch.runtime import wire
from tpudist_torch.utils.logging import get_logger

log = get_logger(__name__)

__all__ = ["QuarantineConfig", "GoldenProbe", "QuarantineManager"]


@dataclasses.dataclass(frozen=True)
class QuarantineConfig:
    """Strike/probe/reinstate policy.

    Defaults are tuned for the tiny-fleet benches and tests; a real
    deployment would stretch the windows by the same factor as its
    heartbeat TTLs.
    """
    strike_threshold: int = 3      # strikes in window -> quarantine
    strike_window_s: float = 30.0  # sliding strike window
    probe_interval_s: float = 1.0  # gap between golden probes
    probe_timeout_s: float = 15.0  # unanswered probe counts as a fail
    reinstate_after: int = 3       # consecutive passes -> reinstate
    retire_after_fails: int = 5    # total fails -> terminal verdict

    def __post_init__(self) -> None:
        for name in ("strike_threshold", "reinstate_after",
                     "retire_after_fails"):
            if int(getattr(self, name)) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}")
        for name in ("strike_window_s", "probe_interval_s",
                     "probe_timeout_s"):
            if float(getattr(self, name)) <= 0:
                raise ValueError(
                    f"{name} must be > 0, got {getattr(self, name)}")


@dataclasses.dataclass(frozen=True)
class GoldenProbe:
    """A fixed probe request and its known-exact greedy output,
    computed against a reference loop on the fleet's weights (the same
    way ``roll_structural`` callers compute ``expect_tokens``)."""
    prompt: tuple
    expect: tuple
    max_new_tokens: int = 0   # 0: default to len(expect)

    def budget(self) -> int:
        return int(self.max_new_tokens) or len(self.expect)


class QuarantineManager:
    """Strike ledger + probe driver, owned by a router.

    The router calls :meth:`strike` from its integrity-failure paths
    and :meth:`tick` once per poll; everything else (marker keys,
    probe traffic, reinstatement, retirement) happens here.  All coord
    I/O is best-effort: a brownout skips a tick, never wedges it.
    """

    def __init__(self, client, *, namespace: str,
                 golden: GoldenProbe | None = None,
                 config: QuarantineConfig | None = None,
                 clock=time.monotonic) -> None:
        self.client = client
        self.ns = namespace
        self.golden = golden
        self.cfg = config or QuarantineConfig()
        self._clock = clock
        self._strikes: dict[str, list[tuple[float, str]]] = {}
        self._q: dict[str, dict] = {}   # rid -> quarantine state
        self._probe_seq = 0
        self._obs_strikes = obs.counter("quarantine/strikes",
                                        unit="strikes")
        self._obs_quarantines = obs.counter("router/quarantines",
                                            unit="replicas")
        self._obs_reinstated = obs.counter("router/reinstated",
                                           unit="replicas")
        self._obs_retired = obs.counter("router/retired",
                                        unit="replicas")
        self._obs_probe_sent = obs.counter("probe/sent", unit="probes")
        self._obs_probe_pass = obs.counter("probe/pass", unit="probes")
        self._obs_probe_fail = obs.counter("probe/fail", unit="probes")
        self._obs_quarantined = obs.gauge("router/quarantined",
                                          unit="replicas")

    # -- inspection --------------------------------------------------------

    def quarantined(self) -> set[str]:
        """Replica ids currently excluded from dispatch (retired ones
        stay here until the death sweep reaps them)."""
        return set(self._q)

    def state(self, rid: str) -> dict | None:
        """A copy of one replica's quarantine state, or ``None``."""
        st = self._q.get(rid)
        return dict(st) if st is not None else None

    def strikes(self, rid: str) -> int:
        """Strikes currently inside the sliding window."""
        return len(self._window(rid, self._clock()))

    # -- strikes -----------------------------------------------------------

    def _window(self, rid: str, now: float) -> list[tuple[float, str]]:
        w = [(t, kind) for t, kind in self._strikes.get(rid, ())
             if now - t <= self.cfg.strike_window_s]
        self._strikes[rid] = w
        return w

    def strike(self, rid: str, kind: str) -> bool:
        """Record one integrity strike against ``rid``; returns True
        when this strike tips the replica into quarantine."""
        if not rid:
            return False
        now = self._clock()
        self._obs_strikes.inc()
        w = self._window(rid, now)
        w.append((now, str(kind)))
        if rid in self._q:
            return False
        if len(w) < self.cfg.strike_threshold:
            log.warning("quarantine: integrity strike %d/%d against "
                        "replica %s (%s)", len(w),
                        self.cfg.strike_threshold, rid, kind)
            return False
        self._enter(rid, now, [k for _, k in w])
        return True

    def _enter(self, rid: str, now: float, kinds: list[str]) -> None:
        self._q[rid] = {"since": now, "passes": 0, "fails": 0,
                        "probe": None, "last_probe_at": float("-inf"),
                        "retired": False, "kinds": list(kinds)}
        self._obs_quarantines.inc()
        self._obs_quarantined.set(len(self._q))
        try:
            self.client.set(
                f"{self.ns}/quarantined/{rid}",
                wire.encode_record("heartbeat", {
                    "replica": rid, "kinds": kinds}))
        except ConnectionError:
            pass   # marker retried implicitly: tick() re-asserts it
        log.warning("quarantine: replica %s quarantined after strikes "
                    "%s — drained from dispatch, probing for "
                    "reinstatement", rid, kinds)

    # -- the probe loop ----------------------------------------------------

    def tick(self, live: set[str] | None = None) -> None:
        """Drive every quarantined replica's probe cycle one step:
        consume an answered probe (exact-match -> pass, anything else
        -> fail), time out an unanswered one, send the next when the
        interval has elapsed.  Without a golden probe configured the
        replica simply stays quarantined — exclusion is still the safe
        state, there is just no evidence path back in."""
        if not self._q:
            return
        now = self._clock()
        for rid in list(self._q):
            st = self._q[rid]
            if st["retired"]:
                continue
            if st["probe"] is not None:
                self._check_probe(rid, st, now)
            if (st["probe"] is None and not st["retired"]
                    and self.golden is not None
                    and (live is None or rid in live)
                    and now - st["last_probe_at"]
                    >= self.cfg.probe_interval_s):
                self._send_probe(rid, st, now)

    def _send_probe(self, rid: str, st: dict, now: float) -> None:
        key = f"probe-{rid}-{self._probe_seq:06d}"
        self._probe_seq += 1
        doc = {"key": key,
               "prompt": [int(t) for t in self.golden.prompt],
               "max_new_tokens": self.golden.budget(),
               "deadline_s": None, "priority": 0}
        try:
            self.client.set(f"{self.ns}/inbox/{rid}/{key}",
                            wire.encode_record("request", doc))
        except ConnectionError:
            return
        st["probe"] = {"key": key, "at": now}
        st["last_probe_at"] = now
        self._obs_probe_sent.inc()

    def _check_probe(self, rid: str, st: dict, now: float) -> None:
        probe = st["probe"]
        done_key = f"{self.ns}/done/{probe['key']}"
        try:
            raw = self.client.get(done_key)
        except ConnectionError:
            return
        if raw is None:
            if now - probe["at"] > self.cfg.probe_timeout_s:
                st["probe"] = None
                self._fail(rid, st, "probe timed out")
            return
        try:
            self.client.delete(done_key)
        except ConnectionError:
            pass
        st["probe"] = None
        try:
            doc = wire.decode_record(raw, expect="completion",
                                     namespace=self.ns,
                                     key=probe["key"], replica=rid)
        except wire.WireError as err:
            # a probe answer the replica corrupted IN TRANSIT is the
            # strongest possible fail signal
            self._fail(rid, st, f"undecodable probe answer "
                                f"({err.reason})")
            return
        got = np.asarray(doc.get("tokens", ()), np.int32)
        expect = np.asarray(self.golden.expect, np.int32)
        if (doc.get("reason") in ("stop", "length")
                and np.array_equal(got, expect)):
            self._pass(rid, st)
        else:
            self._fail(
                rid, st,
                f"output mismatch (got {got.tolist()}, expected "
                f"{expect.tolist()}, reason {doc.get('reason')!r})")

    def _pass(self, rid: str, st: dict) -> None:
        self._obs_probe_pass.inc()
        st["passes"] += 1
        log.info("quarantine: replica %s passed golden probe %d/%d",
                 rid, st["passes"], self.cfg.reinstate_after)
        if st["passes"] >= self.cfg.reinstate_after:
            self._reinstate(rid)

    def _fail(self, rid: str, st: dict, why: str) -> None:
        self._obs_probe_fail.inc()
        st["fails"] += 1
        st["passes"] = 0   # reinstatement needs CONSECUTIVE passes
        log.warning("quarantine: replica %s failed golden probe "
                    "(%d total): %s", rid, st["fails"], why)
        if st["fails"] >= self.cfg.retire_after_fails:
            self._retire(rid, st)

    def _reinstate(self, rid: str) -> None:
        del self._q[rid]
        self._strikes.pop(rid, None)
        self._obs_reinstated.inc()
        self._obs_quarantined.set(len(self._q))
        try:
            self.client.delete(f"{self.ns}/quarantined/{rid}")
        except ConnectionError:
            pass
        log.info("quarantine: replica %s reinstated after %d clean "
                 "probes", rid, self.cfg.reinstate_after)

    def _retire(self, rid: str, st: dict) -> None:
        st["retired"] = True
        self._obs_retired.inc()
        try:
            self.client.set(f"{self.ns}/stop/{rid}", b"1")
        except ConnectionError:
            pass
        log.error("quarantine: replica %s RETIRED after %d failed "
                  "probes — stopping it; the death sweep reaps the "
                  "residue and the autoscaler backfills", rid,
                  st["fails"])

    def drop(self, rid: str) -> None:
        """Forget a replica (called by the router's death sweep): its
        marker key is gone with the rest of its residue, and a future
        replica reusing the id starts with a clean ledger."""
        self._q.pop(rid, None)
        self._strikes.pop(rid, None)
        self._obs_quarantined.set(len(self._q))
