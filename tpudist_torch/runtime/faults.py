"""Deterministic fault injection for the coordination and serve planes
(counterpart of :mod:`tpudist.runtime.faults`, framework-free and kept
as the same code: the port reads the same ``TPUDIST_FAULT_*`` knobs).
Every hook has its caller in the port: the coordination client, the
heartbeats and collectives, the serve loop and its replicas, the router,
the KV hand-off and the autoscaler's poll.

Robustness code that is only exercised by real hardware failures is
robustness code that has never run.  This module is the harness that
makes the failure paths *testable*: a process-wide :class:`FaultPlan`,
parsed once from ``TPUDIST_FAULT_*`` environment variables, whose hooks
are threaded through the hot points where production faults actually
land —

* :meth:`FaultPlan.coord_op` — called by every
  :class:`~tpudist_torch.runtime.coord.CoordClient` RPC; injects a
  :class:`FaultInjected` (a ``ConnectionError`` subclass, so the
  production retry/error paths handle it exactly like a dropped TCP
  connection) with probability ``coord_error_p`` and/or a ``coord_delay_s``
  stall with probability ``coord_delay_p``;
* :meth:`FaultPlan.drop_heartbeat` — consulted by
  ``CoordClient.heartbeat``; once process uptime passes
  ``heartbeat_stop_after_s`` every lease refresh is silently swallowed,
  so the worker *looks* dead to the TTL plane while actually running
  (the false-positive case a router must survive);
* :meth:`FaultPlan.on_segment` — called by the serve loop after each
  dispatched decode segment; after ``kill_after_segments`` dispatches the
  process SIGKILLs *itself* — an uncatchable death mid-decode, the
  harshest replica-loss shape;
* :meth:`FaultPlan.drop_publish` — consulted by
  the metrics publisher's ``publish``; once uptime
  passes ``publish_drop_after_s`` every metrics publish is silently
  swallowed while heartbeats keep flowing — the replica stays LIVE to
  the TTL plane but its gauges age out, which is exactly the health
  monitor's ``stale`` verdict (a wedged metrics thread, a partitioned
  obs plane) as opposed to ``lost``.

Determinism: the probabilistic knobs draw from one ``random.Random``
seeded by ``TPUDIST_FAULT_SEED`` (default 0), so a failing CI run
replays bit-identically.  With no ``TPUDIST_FAULT_*`` variable set the
plan is inert and every hook is a near-free early return — production
code pays one attribute check.

Environment knobs (all optional):

==================================  =========================================
``TPUDIST_FAULT_COORD_ERROR_P``     probability a coord RPC raises
                                    :class:`FaultInjected` before running
``TPUDIST_FAULT_COORD_DELAY_P``     probability a coord RPC sleeps first
``TPUDIST_FAULT_COORD_DELAY_S``     the injected sleep (default 0.05 s)
``TPUDIST_FAULT_HEARTBEAT_STOP_AFTER_S``
                                    drop all heartbeats once process uptime
                                    exceeds this many seconds
``TPUDIST_FAULT_KILL_AFTER_SEGMENTS``
                                    SIGKILL self after this many dispatched
                                    serve segments
``TPUDIST_FAULT_PUBLISH_DROP``      drop all metrics publishes once process
                                    uptime exceeds this many seconds
                                    (heartbeats keep flowing: the replica
                                    goes ``stale``, not ``lost``)
``TPUDIST_FAULT_HEARTBEAT_DELAY_S``
                                    swallow heartbeats while process uptime
                                    is BELOW this many seconds — a slow
                                    joiner (snapshot restore + compile)
                                    that registers long before its first
                                    lease refresh lands
``TPUDIST_FAULT_KILL_AT_WARMUP``    SIGKILL self at the replica warmup
                                    point (after registration, before the
                                    first heartbeat) — a joiner torn down
                                    mid-warmup
``TPUDIST_FAULT_CANARY_CORRUPT``    flip a token in every completion whose
                                    request id starts with ``canary`` — a
                                    green pool that warms, heartbeats, and
                                    then serves WRONG output
``TPUDIST_FAULT_AUTOSCALE_POLL_DELAY_S``
                                    stall every autoscaler control poll by
                                    this many seconds — a wedged control
                                    plane that must not lose requests
``TPUDIST_FAULT_ROUTER_KILL_AFTER_POLLS``
                                    SIGKILL self after this many router
                                    ``_poll`` iterations — a control-plane
                                    crash mid-spike whose recovery path
                                    (``--recover``) must finish every
                                    in-flight request exactly once
``TPUDIST_FAULT_COORD_OUTAGE_AT_S``
                                    start of a full-store unreachability
                                    window (process uptime, seconds): EVERY
                                    coord RPC raises :class:`FaultInjected`
                                    while the window is open — a coord
                                    brownout, as distinct from the per-op
                                    ``COORD_ERROR_P`` coin flips.  Because
                                    the fault fires BEFORE the RPC leaves
                                    the process, no op can have half-
                                    applied — the "connection refused"
                                    class, safely retriable for all verbs
``TPUDIST_FAULT_COORD_OUTAGE_S``    the outage window's length (default
                                    5 s once ``COORD_OUTAGE_AT_S`` is set)
``TPUDIST_FAULT_FLIP_WIRE_BITS``    ``N`` or ``N:M`` — flip one bit in every
                                    Nth coord payload this process commits
                                    (``N:M`` stops after M flips total):
                                    silent wire corruption the checksummed
                                    frame must catch and the router must
                                    quarantine
``TPUDIST_FAULT_NAN_AFTER_TOKENS``  poison the decode segment's logits to
                                    NaN once the serve loop has emitted this
                                    many tokens — in-band compute corruption
                                    the lane guard must freeze into a
                                    ``corrupt_segment`` verdict
``TPUDIST_FAULT_PROBE_FAIL``        flip a token in the first N completions
                                    whose request id starts with ``probe`` —
                                    a quarantined replica that keeps failing
                                    its golden probes (N large: retirement;
                                    N small: fail-then-reinstate)
``TPUDIST_FAULT_HANDOFF_DROP``      swallow the first N KV-migration payload
                                    publishes: the prefill replica believes
                                    the handoff landed but the payload never
                                    reaches the store — the decode side must
                                    fall back to re-prefill with identical
                                    output
``TPUDIST_FAULT_KILL_AT_HANDOFF``   SIGKILL self immediately after
                                    publishing the Nth KV-migration payload,
                                    BEFORE committing the handoff done
                                    record — the router must redispatch the
                                    request exactly-once (re-prefill on a
                                    surviving replica, byte-identical
                                    output)
``TPUDIST_FAULT_MIGRATE_DROP``      swallow the first N preemption/rebalance
                                    MIGRATE payload publishes (the
                                    mid-decode analogue of
                                    ``HANDOFF_DROP``): the exporting
                                    replica believes the migration landed
                                    but the pages never reach the store —
                                    the adopting side must fall back to a
                                    byte-identical re-prefill
``TPUDIST_FAULT_KILL_AT_MIGRATE``   SIGKILL self immediately after
                                    publishing the Nth MIGRATE payload,
                                    BEFORE committing the migrate done
                                    record — the router's death sweep must
                                    redispatch the in-flight request
                                    exactly-once with byte-identical output
``TPUDIST_FAULT_COLL_KILL_PHASE``   SIGKILL self when the hierarchical
                                    allreduce reaches this phase boundary
                                    (``hier_intra`` / ``hier_cross`` /
                                    ``hier_ag``) — a rank dying between the
                                    intra-host and cross-host phases, which
                                    survivors must surface as ``PeerLost``
                                    within ONE shared ``timeout_s``
``TPUDIST_FAULT_COLL_KILL_RANK``    restrict ``COLL_KILL_PHASE`` to this
                                    collective rank (default: every rank —
                                    only useful with the in-process raise
                                    mode, see ``coll_kill_raise``)
``TPUDIST_FAULT_SEED``              RNG seed for the probabilistic knobs
==================================  =========================================
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time

__all__ = ["FaultInjected", "RouterKilled", "FaultPlan", "plan",
           "install", "reset", "coord_op", "drop_heartbeat",
           "drop_publish", "on_segment", "on_warmup", "corrupt_canary",
           "autoscale_poll", "on_router_poll", "flip_wire_bits",
           "poison_logits", "corrupt_probe", "drop_handoff",
           "on_handoff_published", "drop_migrate",
           "on_migrate_published", "on_coll_phase"]

ENV_PREFIX = "TPUDIST_FAULT_"


class FaultInjected(ConnectionError):
    """An injected coordination-plane failure.  Subclasses
    ``ConnectionError`` so production error handling (CoordClient's
    idempotent-op retry, callers' except clauses) treats it exactly like
    a real dropped connection."""


class RouterKilled(RuntimeError):
    """Raised by :meth:`FaultPlan.on_router_poll` instead of SIGKILL
    when ``router_kill_raise`` is set: the in-process router-crash shape
    the offline simulator uses — FleetSim catches it, builds a fresh
    Router on the same fabric, and runs the REAL ``recover()`` path on
    the virtual clock.  Live chaos keeps the real SIGKILL."""


def _env_float(environ, name: str) -> float | None:
    raw = environ.get(ENV_PREFIX + name)
    if raw is None or raw.strip() == "":
        return None
    return float(raw)


class FaultPlan:
    """One process's fault schedule.  Thread-safe: the serve loop, the
    heartbeat daemon, and collective workers all consult the same plan."""

    def __init__(
        self,
        coord_error_p: float = 0.0,
        coord_delay_p: float = 0.0,
        coord_delay_s: float = 0.05,
        heartbeat_stop_after_s: float | None = None,
        kill_after_segments: int | None = None,
        publish_drop_after_s: float | None = None,
        heartbeat_delay_s: float | None = None,
        kill_at_warmup: bool = False,
        canary_corrupt: bool = False,
        autoscale_poll_delay_s: float | None = None,
        router_kill_after_polls: int | None = None,
        router_kill_raise: bool = False,
        coord_outage_at_s: float | None = None,
        coord_outage_s: float = 5.0,
        flip_wire_bits: str | int | None = None,
        nan_after_tokens: int | None = None,
        probe_fail: int | None = None,
        handoff_drop: int | None = None,
        kill_at_handoff: int | None = None,
        migrate_drop: int | None = None,
        kill_at_migrate: int | None = None,
        coll_kill_phase: str | None = None,
        coll_kill_rank: int | None = None,
        coll_kill_raise: bool = False,
        seed: int = 0,
    ) -> None:
        if not 0.0 <= coord_error_p <= 1.0:
            raise ValueError(
                f"coord_error_p must be in [0, 1], got {coord_error_p}")
        if not 0.0 <= coord_delay_p <= 1.0:
            raise ValueError(
                f"coord_delay_p must be in [0, 1], got {coord_delay_p}")
        self.coord_error_p = float(coord_error_p)
        self.coord_delay_p = float(coord_delay_p)
        self.coord_delay_s = float(coord_delay_s)
        self.heartbeat_stop_after_s = heartbeat_stop_after_s
        self.kill_after_segments = (None if kill_after_segments is None
                                    else int(kill_after_segments))
        self.publish_drop_after_s = publish_drop_after_s
        self.heartbeat_delay_s = heartbeat_delay_s
        self.kill_at_warmup = bool(kill_at_warmup)
        self.canary_corrupt = bool(canary_corrupt)
        self.autoscale_poll_delay_s = autoscale_poll_delay_s
        if router_kill_after_polls is not None \
                and int(router_kill_after_polls) < 1:
            raise ValueError(
                f"router_kill_after_polls must be >= 1, got "
                f"{router_kill_after_polls}")
        self.router_kill_after_polls = (
            None if router_kill_after_polls is None
            else int(router_kill_after_polls))
        self.router_kill_raise = bool(router_kill_raise)
        if coord_outage_at_s is not None and coord_outage_s <= 0:
            raise ValueError(
                f"coord_outage_s must be > 0, got {coord_outage_s}")
        self.coord_outage_at_s = coord_outage_at_s
        self.coord_outage_s = float(coord_outage_s)
        # wire corruption spec "N" (every Nth payload, forever) or
        # "N:M" (every Nth, but stop after M flips — the transient
        # corruption shape whose reinstatement path the bench drives)
        self.flip_wire_every: int | None = None
        self.flip_wire_max: int | None = None
        if flip_wire_bits is not None:
            spec = str(flip_wire_bits)
            every, _, cap = spec.partition(":")
            try:
                self.flip_wire_every = int(every)
                self.flip_wire_max = int(cap) if cap else None
            except ValueError:
                raise ValueError(
                    f"flip_wire_bits must be 'N' or 'N:M', got {spec!r}"
                ) from None
            if self.flip_wire_every < 1 or (
                    self.flip_wire_max is not None
                    and self.flip_wire_max < 1):
                raise ValueError(
                    f"flip_wire_bits counts must be >= 1, got {spec!r}")
        if nan_after_tokens is not None and int(nan_after_tokens) < 0:
            raise ValueError(
                f"nan_after_tokens must be >= 0, got {nan_after_tokens}")
        self.nan_after_tokens = (None if nan_after_tokens is None
                                 else int(nan_after_tokens))
        if probe_fail is not None and int(probe_fail) < 1:
            raise ValueError(
                f"probe_fail must be >= 1, got {probe_fail}")
        self.probe_fail = None if probe_fail is None else int(probe_fail)
        if handoff_drop is not None and int(handoff_drop) < 1:
            raise ValueError(
                f"handoff_drop must be >= 1, got {handoff_drop}")
        self.handoff_drop = (None if handoff_drop is None
                             else int(handoff_drop))
        if kill_at_handoff is not None and int(kill_at_handoff) < 1:
            raise ValueError(
                f"kill_at_handoff must be >= 1, got {kill_at_handoff}")
        self.kill_at_handoff = (None if kill_at_handoff is None
                                else int(kill_at_handoff))
        if migrate_drop is not None and int(migrate_drop) < 1:
            raise ValueError(
                f"migrate_drop must be >= 1, got {migrate_drop}")
        self.migrate_drop = (None if migrate_drop is None
                             else int(migrate_drop))
        if kill_at_migrate is not None and int(kill_at_migrate) < 1:
            raise ValueError(
                f"kill_at_migrate must be >= 1, got {kill_at_migrate}")
        self.kill_at_migrate = (None if kill_at_migrate is None
                                else int(kill_at_migrate))
        _COLL_PHASES = ("hier_intra", "hier_cross", "hier_ag")
        if coll_kill_phase is not None and coll_kill_phase not in \
                _COLL_PHASES:
            raise ValueError(
                f"coll_kill_phase must be one of {_COLL_PHASES}, got "
                f"{coll_kill_phase!r}")
        self.coll_kill_phase = coll_kill_phase
        self.coll_kill_rank = (None if coll_kill_rank is None
                               else int(coll_kill_rank))
        self.coll_kill_raise = bool(coll_kill_raise)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._segments = 0
        self._router_polls = 0
        self._wire_payloads = 0
        self._handoffs_published = 0
        self._migrates_published = 0
        self._born = time.monotonic()
        # per-kind injection tallies, inspectable by tests
        self.injected = {"coord_error": 0, "coord_delay": 0,
                         "heartbeat_drop": 0, "publish_drop": 0,
                         "heartbeat_delay": 0, "canary_corrupt": 0,
                         "autoscale_delay": 0, "coord_outage": 0,
                         "router_kill": 0, "wire_flip": 0,
                         "nan_logits": 0, "probe_corrupt": 0,
                         "handoff_drop": 0, "handoff_kill": 0,
                         "migrate_drop": 0, "migrate_kill": 0,
                         "coll_kill": 0}
        self.active = bool(coord_error_p or coord_delay_p
                           or heartbeat_stop_after_s is not None
                           or kill_after_segments is not None
                           or publish_drop_after_s is not None
                           or heartbeat_delay_s is not None
                           or kill_at_warmup or canary_corrupt
                           or autoscale_poll_delay_s is not None
                           or router_kill_after_polls is not None
                           or coord_outage_at_s is not None
                           or self.flip_wire_every is not None
                           or self.nan_after_tokens is not None
                           or self.probe_fail is not None
                           or self.handoff_drop is not None
                           or self.kill_at_handoff is not None
                           or self.migrate_drop is not None
                           or self.kill_at_migrate is not None
                           or self.coll_kill_phase is not None)

    @classmethod
    def from_env(cls, environ=None) -> "FaultPlan":
        env = os.environ if environ is None else environ
        kill = _env_float(env, "KILL_AFTER_SEGMENTS")
        hb = _env_float(env, "HEARTBEAT_STOP_AFTER_S")
        rkill = _env_float(env, "ROUTER_KILL_AFTER_POLLS")
        outage_s = _env_float(env, "COORD_OUTAGE_S")
        return cls(
            coord_error_p=_env_float(env, "COORD_ERROR_P") or 0.0,
            coord_delay_p=_env_float(env, "COORD_DELAY_P") or 0.0,
            coord_delay_s=(_env_float(env, "COORD_DELAY_S")
                           if _env_float(env, "COORD_DELAY_S") is not None
                           else 0.05),
            heartbeat_stop_after_s=hb,
            kill_after_segments=None if kill is None else int(kill),
            publish_drop_after_s=_env_float(env, "PUBLISH_DROP"),
            heartbeat_delay_s=_env_float(env, "HEARTBEAT_DELAY_S"),
            kill_at_warmup=bool(_env_float(env, "KILL_AT_WARMUP") or 0),
            canary_corrupt=bool(_env_float(env, "CANARY_CORRUPT") or 0),
            autoscale_poll_delay_s=_env_float(env, "AUTOSCALE_POLL_DELAY_S"),
            router_kill_after_polls=None if rkill is None else int(rkill),
            coord_outage_at_s=_env_float(env, "COORD_OUTAGE_AT_S"),
            coord_outage_s=5.0 if outage_s is None else outage_s,
            flip_wire_bits=(env.get(ENV_PREFIX + "FLIP_WIRE_BITS") or None),
            nan_after_tokens=(
                None if _env_float(env, "NAN_AFTER_TOKENS") is None
                else int(_env_float(env, "NAN_AFTER_TOKENS"))),
            probe_fail=(None if _env_float(env, "PROBE_FAIL") is None
                        else int(_env_float(env, "PROBE_FAIL"))),
            handoff_drop=(
                None if _env_float(env, "HANDOFF_DROP") is None
                else int(_env_float(env, "HANDOFF_DROP"))),
            kill_at_handoff=(
                None if _env_float(env, "KILL_AT_HANDOFF") is None
                else int(_env_float(env, "KILL_AT_HANDOFF"))),
            migrate_drop=(
                None if _env_float(env, "MIGRATE_DROP") is None
                else int(_env_float(env, "MIGRATE_DROP"))),
            kill_at_migrate=(
                None if _env_float(env, "KILL_AT_MIGRATE") is None
                else int(_env_float(env, "KILL_AT_MIGRATE"))),
            coll_kill_phase=(env.get(ENV_PREFIX + "COLL_KILL_PHASE")
                             or None),
            coll_kill_rank=(
                None if _env_float(env, "COLL_KILL_RANK") is None
                else int(_env_float(env, "COLL_KILL_RANK"))),
            seed=int(_env_float(env, "SEED") or 0),
        )

    # -- hooks -------------------------------------------------------------

    def in_outage(self) -> bool:
        """True while the declared full-store unreachability window is
        open (uptime in ``[coord_outage_at_s, coord_outage_at_s +
        coord_outage_s)``)."""
        if self.coord_outage_at_s is None:
            return False
        uptime = time.monotonic() - self._born
        return (self.coord_outage_at_s
                <= uptime
                < self.coord_outage_at_s + self.coord_outage_s)

    def coord_op(self, op: str) -> None:
        """Maybe delay, maybe raise — called before every coord RPC.
        During a declared outage window EVERY op raises: the fault fires
        before the RPC leaves the process, so nothing can have half-
        applied server-side — the retriable "connection refused" class,
        unlike a real mid-RPC failure."""
        if self.in_outage():
            with self._lock:
                self.injected["coord_outage"] += 1
            raise FaultInjected(f"injected fault: coord outage ({op})")
        if not (self.coord_error_p or self.coord_delay_p):
            return
        with self._lock:
            delay = (self.coord_delay_p
                     and self._rng.random() < self.coord_delay_p)
            error = (self.coord_error_p
                     and self._rng.random() < self.coord_error_p)
            if delay:
                self.injected["coord_delay"] += 1
            if error:
                self.injected["coord_error"] += 1
        if delay:
            time.sleep(self.coord_delay_s)
        if error:
            raise FaultInjected(f"injected fault: coord {op}")

    def drop_heartbeat(self) -> bool:
        """True when this process's heartbeats should be swallowed —
        either forever once uptime passes ``heartbeat_stop_after_s`` (a
        dying worker), or only WHILE uptime is below ``heartbeat_delay_s``
        (a slow-warming joiner whose first lease refresh lags its
        registration)."""
        uptime = time.monotonic() - self._born
        if self.heartbeat_delay_s is not None \
                and uptime < self.heartbeat_delay_s:
            with self._lock:
                self.injected["heartbeat_delay"] += 1
            return True
        if self.heartbeat_stop_after_s is None:
            return False
        if uptime < self.heartbeat_stop_after_s:
            return False
        with self._lock:
            self.injected["heartbeat_drop"] += 1
        return True

    def drop_publish(self) -> bool:
        """True when this process's metrics publishes should be
        swallowed (the heartbeat keeps flowing — staleness, not
        death)."""
        if self.publish_drop_after_s is None:
            return False
        if time.monotonic() - self._born < self.publish_drop_after_s:
            return False
        with self._lock:
            self.injected["publish_drop"] += 1
        return True

    def on_segment(self) -> None:
        """Count one dispatched serve segment; SIGKILL self at the
        configured count.  SIGKILL (not sys.exit) on purpose: no atexit,
        no finally blocks, no graceful heartbeat leave — the process
        simply vanishes mid-decode, as a torn pod does."""
        if self.kill_after_segments is None:
            return
        with self._lock:
            self._segments += 1
            n = self._segments
        if n >= self.kill_after_segments:
            os.kill(os.getpid(), signal.SIGKILL)

    def on_warmup(self) -> None:
        """SIGKILL self at the replica warmup point — a joiner that
        registered but dies before its first heartbeat.  The router's
        grace window must not leave its registration pinned forever."""
        if self.kill_at_warmup:
            os.kill(os.getpid(), signal.SIGKILL)

    def corrupt_canary(self, rid: str) -> bool:
        """True when this completion's tokens should be corrupted: the
        green-pool failure the blue-green canary check exists to catch
        (warmed, heartbeating, and WRONG)."""
        if not (self.canary_corrupt and rid.startswith("canary")):
            return False
        with self._lock:
            self.injected["canary_corrupt"] += 1
        return True

    def flip_wire_bits(self, payload: bytes) -> bytes:
        """Maybe corrupt one coord payload about to be committed: every
        ``flip_wire_every``-th payload gets ONE bit flipped (capped at
        ``flip_wire_max`` flips when set).  The flip lands past any
        frame header, so the CHECKSUM — not a parse error — is what has
        to catch it, exactly like a real in-flight bit flip."""
        if self.flip_wire_every is None or not payload:
            return payload
        with self._lock:
            self._wire_payloads += 1
            fire = (self._wire_payloads % self.flip_wire_every == 0
                    and (self.flip_wire_max is None
                         or self.injected["wire_flip"]
                         < self.flip_wire_max))
            if fire:
                self.injected["wire_flip"] += 1
        if not fire:
            return payload
        pos = min(len(payload) - 1, max(9, len(payload) // 2))
        return (payload[:pos] + bytes([payload[pos] ^ 0x10])
                + payload[pos + 1:])

    def poison_logits(self, tokens_served: int) -> bool:
        """True when this decode segment's logits should be poisoned to
        NaN: the serve loop has emitted at least ``nan_after_tokens``
        tokens — overflowed-accumulator corruption appearing mid-run,
        which the in-graph lane guard must freeze rather than emit."""
        if (self.nan_after_tokens is None
                or tokens_served < self.nan_after_tokens):
            return False
        with self._lock:
            self.injected["nan_logits"] += 1
        return True

    def corrupt_probe(self, rid: str) -> bool:
        """True when this golden-probe completion's tokens should be
        corrupted (first ``probe_fail`` probes only): a quarantined
        replica that is still wrong when re-probed."""
        if not (self.probe_fail and rid.startswith("probe")):
            return False
        with self._lock:
            if self.injected["probe_corrupt"] >= self.probe_fail:
                return False
            self.injected["probe_corrupt"] += 1
        return True

    def drop_handoff(self) -> bool:
        """True when this KV-migration payload should be lost in flight:
        the first ``handoff_drop`` publishes are swallowed — the prefill
        replica's publish "succeeds" but the payload never lands, so the
        decode side's fetch misses and must re-prefill from the prompt
        (byte-identical output is the contract being tested)."""
        if self.handoff_drop is None:
            return False
        with self._lock:
            if self.injected["handoff_drop"] >= self.handoff_drop:
                return False
            self.injected["handoff_drop"] += 1
        return True

    def on_handoff_published(self) -> None:
        """Count one published KV-migration payload; SIGKILL self at the
        configured count — after the payload is in the store but BEFORE
        the handoff done record commits.  The harshest handoff-window
        death: the router's sweep must redispatch the request (the
        orphaned payload is garbage-collected) and the retry must
        produce byte-identical output."""
        if self.kill_at_handoff is None:
            return
        with self._lock:
            self._handoffs_published += 1
            n = self._handoffs_published
            if n >= self.kill_at_handoff:
                self.injected["handoff_kill"] += 1
        if n >= self.kill_at_handoff:
            os.kill(os.getpid(), signal.SIGKILL)

    def drop_migrate(self) -> bool:
        """True when this preemption/rebalance MIGRATE payload should be
        lost in flight: the first ``migrate_drop`` publishes are
        swallowed — the exporting replica's publish "succeeds" but the
        pages never land, so the adopting side's fetch misses and must
        re-prefill the original prompt (byte-identical output is the
        contract being tested)."""
        if self.migrate_drop is None:
            return False
        with self._lock:
            if self.injected["migrate_drop"] >= self.migrate_drop:
                return False
            self.injected["migrate_drop"] += 1
        return True

    def on_migrate_published(self) -> None:
        """Count one published MIGRATE payload; SIGKILL self at the
        configured count — after the pages are in the store but BEFORE
        the migrate done record commits.  The harshest migration-window
        death: the router's death sweep must redispatch the request
        (the orphaned payload is garbage-collected) and the retry must
        produce byte-identical output."""
        if self.kill_at_migrate is None:
            return
        with self._lock:
            self._migrates_published += 1
            n = self._migrates_published
            if n >= self.kill_at_migrate:
                self.injected["migrate_kill"] += 1
        if n >= self.kill_at_migrate:
            os.kill(os.getpid(), signal.SIGKILL)

    def on_coll_phase(self, phase: str, rank: int | None = None) -> None:
        """Kill this participant when the hierarchical allreduce crosses
        the configured phase boundary (``hier_intra`` → before the
        intra-host reduce-scatter, ``hier_cross`` → after it and before
        the cross-host ring, ``hier_ag`` → before the intra all-gather).
        SIGKILL by default — the process vanishes with its intra-phase
        contribution already consumed, the harshest mid-collective
        death; with ``coll_kill_raise`` it raises :class:`FaultInjected`
        instead so an in-process (thread-per-rank) harness can play the
        dying rank while its survivor threads assert the ``PeerLost``
        deadline.  ``coll_kill_rank`` scopes the fault to one collective
        rank — required in thread harnesses, where every rank shares the
        process-wide plan."""
        if self.coll_kill_phase is None or phase != self.coll_kill_phase:
            return
        if self.coll_kill_rank is not None and rank != self.coll_kill_rank:
            return
        with self._lock:
            self.injected["coll_kill"] += 1
        if self.coll_kill_raise:
            raise FaultInjected(
                f"injected fault: collective rank {rank} killed at {phase}")
        os.kill(os.getpid(), signal.SIGKILL)

    def autoscale_poll(self) -> None:
        """Stall one autoscaler control poll (a wedged control plane —
        the data plane must keep serving, just without scaling)."""
        if self.autoscale_poll_delay_s is None:
            return
        with self._lock:
            self.injected["autoscale_delay"] += 1
        time.sleep(self.autoscale_poll_delay_s)

    def on_router_poll(self) -> None:
        """Count one router ``_poll`` iteration; crash the router at the
        configured count.  SIGKILL by default (live chaos: no finally
        blocks, the assignment table simply vanishes); with
        ``router_kill_raise`` it raises :class:`RouterKilled` instead so
        an in-process harness (the simulator) can catch the crash and
        drive the real recovery path."""
        if self.router_kill_after_polls is None:
            return
        with self._lock:
            self._router_polls += 1
            n = self._router_polls
        if n >= self.router_kill_after_polls:
            with self._lock:
                self.injected["router_kill"] += 1
            if self.router_kill_raise:
                # one-shot: recovery's own polls must not re-trip it
                self.router_kill_after_polls = None
                raise RouterKilled(
                    f"injected fault: router killed at poll {n}")
            os.kill(os.getpid(), signal.SIGKILL)


_INERT = FaultPlan()
_plan: FaultPlan | None = None


def plan() -> FaultPlan:
    """The process-wide plan, parsed from the environment on first use."""
    global _plan
    if _plan is None:
        _plan = FaultPlan.from_env()
    return _plan


def install(new_plan: FaultPlan | None) -> None:
    """Replace the process-wide plan (tests); ``None`` re-reads the
    environment on next use."""
    global _plan
    _plan = new_plan


def reset() -> None:
    install(None)


# module-level conveniences: the hot-path call sites use these so the
# inert case is one global load + one attribute check
def coord_op(op: str) -> None:
    p = plan()
    if p.active:
        p.coord_op(op)


def drop_heartbeat() -> bool:
    p = plan()
    return p.active and p.drop_heartbeat()


def drop_publish() -> bool:
    p = plan()
    return p.active and p.drop_publish()


def on_segment() -> None:
    p = plan()
    if p.active:
        p.on_segment()


def on_warmup() -> None:
    p = plan()
    if p.active:
        p.on_warmup()


def corrupt_canary(rid: str) -> bool:
    p = plan()
    return p.active and p.corrupt_canary(rid)


def flip_wire_bits(payload: bytes) -> bytes:
    p = plan()
    return p.flip_wire_bits(payload) if p.active else payload


def poison_logits(tokens_served: int) -> bool:
    p = plan()
    return p.active and p.poison_logits(tokens_served)


def corrupt_probe(rid: str) -> bool:
    p = plan()
    return p.active and p.corrupt_probe(rid)


def drop_handoff() -> bool:
    p = plan()
    return p.active and p.drop_handoff()


def on_handoff_published() -> None:
    p = plan()
    if p.active:
        p.on_handoff_published()


def drop_migrate() -> bool:
    p = plan()
    return p.active and p.drop_migrate()


def on_migrate_published() -> None:
    p = plan()
    if p.active:
        p.on_migrate_published()


def on_coll_phase(phase: str, rank: int | None = None) -> None:
    p = plan()
    if p.active:
        p.on_coll_phase(phase, rank)


def autoscale_poll() -> None:
    p = plan()
    if p.active:
        p.autoscale_poll()


def on_router_poll() -> None:
    p = plan()
    if p.active:
        p.on_router_poll()
