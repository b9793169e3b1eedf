"""Fault-tolerant serve fleet: a router tier over N ``ServeLoop`` replicas
(counterpart of :mod:`tpudist.runtime.router`).

ROADMAP item 4's millions-of-users shape: capacity and availability come
from REPLICAS behind a router, not from one bigger loop.  Everything
rides the coordination planes that already exist — no new transport:

* **Liveness** — each replica holds a TTL heartbeat lease
  (``{ns}:{rid}`` via :class:`~tpudist_torch.runtime.coord.ElasticMonitor`);
  the router's death signal is the lease expiring, exactly the signal
  elastic training uses.
* **Load** — each replica publishes its metric snapshot
  (:class:`~tpudist_torch.obs.aggregate.MetricsPublisher` under
  ``{ns}/metrics``); the router admits least-loaded from the published
  ``serve/kv_blocks_free`` / ``serve/queue_depth`` gauges and the
  ``serve/queue_wait_s`` histogram, cross-checked by a
  :class:`~tpudist_torch.obs.health.HealthMonitor` over the same snapshots
  (a replica whose publisher went quiet is excluded before its
  heartbeat ever lapses).
* **Requests** — the router writes each admitted request to the chosen
  replica's inbox (``{ns}/inbox/{rid}/{key}``); the replica's
  :class:`ReplicaWorker` feeds them to ``ServeLoop.run``'s service mode
  and writes each completion to ``{ns}/done/{key}``.

Failure model (the robustness core):

* **Death detection** — a replica absent from ``live()`` (TTL lapsed,
  e.g. SIGKILL or an injected heartbeat drop) or classified ``lost`` by
  the health monitor is dead to the router.
* **Drain + redispatch** — the dead replica's inbox is swept and every
  request assigned to it (picked up or not) is re-enqueued and
  dispatched to a survivor.  Redispatched requests restart from the
  prompt; greedy decoding over identical replica weights makes the
  redispatched output token-identical to an uninterrupted run.
* **Exactly-once completion** — the router consumes ``done`` keys
  (get + delete) keyed by its own request id and returns the FIRST
  completion per request; a false-positive death (replica alive but
  presumed dead, e.g. dropped heartbeats) can produce a duplicate done
  write, but under greedy determinism the duplicate is byte-identical
  and is simply deleted.  Every admitted request returns exactly one
  :class:`~tpudist_torch.models.serving.Completion`.
* **Bounded time** — :meth:`Router.run` raises :class:`TimeoutError`
  at its ``timeout_s`` bound instead of hanging when no capacity
  remains (every replica dead).

Replica-side load shedding composes with routing: a replica that sheds
(``reason="rejected"``, ``serve/rejected`` counter) gets its requests
re-routed and is put on a short admission backoff instead of being
hammered while saturated.

Elastic membership (ROADMAP item 4's remainder — this is what makes the
fleet elastic UPWARD, not just shrink-on-death):

* **Live join** — the router discovers registrations on every poll
  (membership is never frozen at construction); a replica started
  against a running fleet (:func:`scale_fleet`) registers, restores the
  fleet's weight snapshot (``--snapshot-dir`` →
  :class:`~tpudist_torch.elastic.checkpoint.Checkpointer`), heartbeats, and
  takes traffic.  First-poll members are the baseline; later
  appearances tick ``router/joins``.
* **Rolling weight hot-swap** — :func:`roll_weights` persists the new
  weights to the snapshot dir (durability FIRST), then bumps
  ``{ns}/weights/version``.  Each replica notices the bump, takes a
  ticket (``add({ns}/weights/ticket/{v}, 1)``), and swaps only when the
  done counter (``{ns}/weights/done/{v}``) shows every earlier ticket
  finished — one replica at a time, so fleet capacity never drops by
  more than one replica.  The swap itself is
  :meth:`~tpudist_torch.models.serving.ServeLoop.request_swap`: drain
  in-flight decodes on the old weights, rebind, resume — zero lost or
  version-straddling requests.  While swapping, the replica publishes
  ``serve/swapping=1`` and the router steers admissions around it.  A
  ticket-holder that DIES mid-chain would stall it forever; after
  ``swap_turn_timeout_s`` a waiting replica proceeds anyway (liveness
  over strict seriality — the race is only two replicas briefly
  swapping at once).
* **Router-side SLO admission** — a deadline-bearing request is SHED at
  the router (``reason="shed"``, ``router/slo_shed``) when even the
  best candidate's published ``serve/queue_wait_s`` percentile
  (``slo_quantile``, default p99) predicts a miss — before the request
  ever costs any replica a prefill.

Fleet control plane (the policy layer over those mechanisms):

* **Join grace** — the death sweep covers registered-but-not-yet-live
  rids (so a joiner that died during warmup cannot pin its
  registration), but a NEVER-live registration younger than
  ``join_grace_s`` is forgiven: a slow-warming joiner (minutes of
  compile before its first heartbeat) must not be swept as dead.  Once
  a replica has ever heartbeated, a lapsed lease is death NOW — grace
  never stretches kill detection.
* **Graceful drain** — ``{ns}/draining/{rid}`` (:func:`request_drain`)
  steers admissions away immediately; :func:`drain_replicas` stops the
  replica only once its inbox is empty (the worker's close path
  finishes queued + in-flight work and commits every completion), then
  sweeps the coordination residue.  A draining departure ticks
  ``router/drains``, not the ``router/replica_deaths`` counter that
  pages an operator.
* **Blue-green structural rollout** — :meth:`Router.roll_structural`
  spins up a tagged green pool (``--pool``), warms it, exact-checks a
  canary request against a reference, then commits by shifting the
  ``{ns}/pool`` pin and draining blue; any warmup/canary failure rolls
  back with blue never touched.  The in-place hot-swap handles weight
  DELTAS; this handles changes a running loop cannot absorb.
* **Overload degradation** — past a replica's soft ``degrade_queue``
  watermark it advertises ``serve/degraded`` and clamps best-effort
  (``Request.priority <= 0``) budgets to ``degrade_max_new``; past the
  hard ``max_queue`` bound it sheds lowest-priority-newest-first.  The
  router mirrors the fleet's degraded state (``router/degraded``) and
  clamps best-effort budgets at dispatch (``degrade_max_new``).
* **Collision-safe scale-up** — replica indices come from an atomic
  add-chain (``{ns}/replica_index`` via :func:`alloc_replica_indices`),
  so concurrent :func:`scale_fleet` callers (autoscaler + operator)
  can never mint the same rid.

The autoscaler (:mod:`tpudist_torch.runtime.autoscaler`) closes the loop
over these mechanisms: it buys joiners through :func:`scale_fleet` and
drains idle replicas through the same protocol.

Replicas run on the card by default (``--device cuda``): each prefills
through the flash-forward kernel (K1) and decodes through the flash-decode
kernel (K2, dense) or its paged form (K5); a replica without a CUDA device
raises rather than fall back to the CPU.  Tests pass ``device="cpu"``.

The fault-injection harness (:mod:`tpudist_torch.runtime.faults`,
``TPUDIST_FAULT_*``) exercises all of this deterministically: coord-op
errors/delays hit the retry paths, ``KILL_AFTER_SEGMENTS`` SIGKILLs a
replica mid-decode, ``HEARTBEAT_STOP_AFTER_S`` fakes death without
stopping the worker, ``PUBLISH_DROP`` starves the obs plane so the
health monitor's ``stale`` verdict steers routing without a death,
``HEARTBEAT_DELAY_S`` recreates the slow-warming joiner,
``KILL_AT_WARMUP`` SIGKILLs a joiner between registration and its
first heartbeat, and ``CANARY_CORRUPT`` forces the green pool to serve
wrong canary output so the rollback path runs for real.

Data-plane integrity (the byzantine-fault complement to the crash
machinery above; see docs/DESIGN.md "Data-plane integrity"):

* **Checksummed wire** — requests, completions, and journal records
  are framed by :mod:`tpudist_torch.runtime.wire` (crc32c + schema tag);
  every decode site verifies before trusting.  A mismatch raises a
  typed :class:`~tpudist_torch.runtime.wire.WireError` carrying
  namespace/key/replica, which the router COUNTS
  (``integrity/checksum_mismatch``), attributes as a strike against
  the offending replica, and answers by deleting the corrupt key and
  redispatching the request — corruption is never delivered and never
  crashes the poll loop.  Unframed legacy payloads still decode (the
  simulator's fakes and hand-planted test keys ride that path).
* **In-band verdicts** — a replica that catches corruption itself
  (NaN/inf logits freezing a lane into ``reason="corrupt_segment"``,
  or an undecodable inbox payload surfacing as
  ``reason="wire_error"``) commits the verdict instead of output; the
  router re-routes the request like a rejection and records a strike.
* **Quarantine** — strikes accumulate in
  :class:`~tpudist_torch.runtime.quarantine.QuarantineManager`; past the
  threshold the replica is drained from dispatch (not killed), marked
  ``{ns}/quarantined/{rid}`` (the autoscaler backfills the capacity),
  and re-probed with golden queries — fixed prompt, known-exact greedy
  tokens, the blue-green canary check running in steady state — until
  it is reinstated by consecutive clean probes or retired.  The fault
  knobs ``FLIP_WIRE_BITS``, ``NAN_AFTER_TOKENS``, and ``PROBE_FAIL``
  drive all three paths deterministically.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from tpudist_torch import obs
from tpudist_torch.obs.aggregate import collect, MetricsPublisher
from tpudist_torch.obs.events import EventPublisher, TraceContext
from tpudist_torch.obs.health import HealthMonitor
from tpudist_torch.obs.registry import hist_quantile
from tpudist_torch.runtime import faults, wire
from tpudist_torch.runtime.coord import CoordClient, ElasticMonitor
from tpudist_torch.runtime.prefix_directory import (PrefixDirectory,
                                                    summary_ttl_from_env)
from tpudist_torch.runtime.quarantine import (GoldenProbe,
                                              QuarantineConfig,
                                              QuarantineManager)
from tpudist_torch.utils.logging import get_logger

log = get_logger(__name__)

__all__ = ["Router", "ReplicaWorker", "build_tiny_lm",
           "launch_local_fleet", "scale_fleet", "stop_fleet",
           "exit_reports", "wait_live", "roll_weights", "wait_swapped",
           "alloc_replica_indices", "request_drain", "drain_replicas",
           "JOURNAL_SCHEMA", "GoldenProbe", "QuarantineConfig",
           "QuarantineManager"]

DEFAULT_NAMESPACE = "fleet"

# version tag every {ns}/journal/* record carries (see docs/DESIGN.md
# "Control-plane recovery" for the schema and commit-point rules)
JOURNAL_SCHEMA = "tpudist.journal/1"


# -- wire format (checksummed JSON frames over the KV store; see
# tpudist_torch.runtime.wire for the crc32c framing and the legacy
# unframed-JSON fallback every decoder keeps) ------------------------------

def _request_doc(key: str, req, handoff_ref: str | None = None,
                 prefix_ref: str | None = None) -> dict:
    doc = {
        "key": key,
        "prompt": np.asarray(req.prompt).astype(int).tolist(),
        "max_new_tokens": int(req.max_new_tokens),
        "deadline_s": req.deadline_s,
        "priority": int(getattr(req, "priority", 0)),
    }
    # disaggregated decode-stage dispatch: the KV-migration payload's
    # transport ref rides the wire (never the payload itself — the
    # request stays small); the replica fetches and adopts, or
    # re-prefills from the prompt above when the fetch misses
    if handoff_ref is not None:
        doc["handoff_ref"] = str(handoff_ref)
    # pull-mode global prefix cache: the ref of a peer-exported prefix
    # payload — the replica fetches and installs the shared pages
    # BEFORE admission, so the prefill covers only the suffix (a miss
    # installs nothing and the full prefill runs: exact either way)
    if prefix_ref is not None:
        doc["prefix_ref"] = str(prefix_ref)
    # distributed tracing: the trace context rides the wire so the
    # replica's lifecycle events join the router's under one trace id
    # (and SURVIVE a redispatch — the router re-sends the same context)
    trace = getattr(req, "trace", None)
    if trace is not None:
        doc["trace"] = trace.to_wire()
    # prefix affinity: the OPAQUE client-stamped hash rides the wire so
    # the replica can advertise it back in its prefix summary — router
    # and replica never have to agree on block size or hash chaining
    phash = getattr(req, "prefix_hash", None)
    if phash is not None:
        doc["prefix_hash"] = int(phash)
    return doc


def _encode_request(key: str, req,
                    handoff_ref: str | None = None,
                    prefix_ref: str | None = None) -> bytes:
    return wire.encode_record(
        "request", _request_doc(key, req, handoff_ref=handoff_ref,
                                prefix_ref=prefix_ref))


def _decode_request(raw: bytes, *, namespace: str = "", key: str = "",
                    replica: str = ""):
    """Verify + decode one inbox payload into a ``Request``.  Raises
    :class:`~tpudist_torch.runtime.wire.WireError` on ANY failure — checksum,
    truncation, bad JSON, or a structurally valid document missing the
    request fields — so one except clause covers the whole corrupt
    surface at each call site."""
    from tpudist_torch.models.serving import Request

    d = wire.decode_record(raw, expect="request", namespace=namespace,
                           key=key, replica=replica)
    try:
        phash = d.get("prefix_hash")
        ref = d.get("handoff_ref")
        pref = d.get("prefix_ref")
        return Request(prompt=np.asarray(d["prompt"], np.int32),
                       max_new_tokens=int(d["max_new_tokens"]),
                       rid=d["key"], deadline_s=d.get("deadline_s"),
                       priority=int(d.get("priority", 0)),
                       trace=TraceContext.from_wire(d.get("trace")),
                       prefix_hash=None if phash is None else int(phash),
                       prefix_ref=None if pref is None else str(pref),
                       # a ref-only stub: the worker resolves it into
                       # the real payload (or None) before admission
                       kv_handoff=(None if ref is None
                                   else {"handoff_ref": str(ref)}))
    except (KeyError, ValueError, TypeError):
        raise wire.WireError("schema", kind="request",
                             namespace=namespace, key=key,
                             replica=replica) from None


def _encode_completion(replica_id: str, comp,
                       handoff_ref: str | None = None,
                       adopt_fallback: bool = False) -> bytes:
    doc = {
        "key": comp.rid,
        "tokens": np.asarray(comp.tokens).astype(int).tolist(),
        "reason": comp.reason,
        "replica": replica_id,
    }
    # reason="handoff"/"migrate" commits carry the migration payload's
    # transport ref, NOT the payload (that crossed separately, before
    # this commit): the router journals the ref and re-sends it on the
    # decode-stage dispatch
    if handoff_ref is not None:
        doc["handoff_ref"] = str(handoff_ref)
    if adopt_fallback:
        # this request was dispatched with a payload ref whose fetch
        # missed — the replica re-prefilled (exact); the router counts
        # it against router/migration_fallbacks when the entry migrated
        doc["adopt_fallback"] = True
    return wire.encode_record("completion", doc)


# -- the replica side ------------------------------------------------------

class ReplicaWorker:
    """One serve replica: a ``ServeLoop`` in service mode, wired to the
    fleet's coordination planes.

    Lifecycle: :meth:`serve` registers the replica
    (``{ns}/replica/{rid}``), starts the TTL heartbeat and the metrics
    publisher, then blocks in ``loop.run(source=..., sink=...)`` — the
    source polls the inbox (FIFO by key) and watches the stop keys
    (``{ns}/stop`` fleet-wide, ``{ns}/stop/{rid}`` targeted); the sink
    commits each completion to ``{ns}/done/{key}``.  On a clean exit an
    exit report (``{ns}/exit/{rid}``: served count, pool-drained flag)
    lets cross-process tests assert the no-orphaned-blocks invariant.

    Elastic pieces (see the module docstring's protocol sketch):

    * ``snapshot_dir`` — the fleet's shared weight snapshot.  At
      construction the worker restores the latest committed checkpoint
      (a JOINER starts on the fleet's current weights, keeping greedy
      output exact-match); at a version bump it is what
      ``restore_latest`` re-reads for the hot-swap.
    * the source poll watches ``{ns}/weights/version`` and drives the
      rolling one-at-a-time swap chain (ticket + done counter, turn
      timeout for dead ticket-holders), gating the actual rebind
      through ``loop.request_swap`` so in-flight decodes finish on the
      weights that admitted them.
    """

    def __init__(self, loop, client: CoordClient, replica_id: str, *,
                 rank: int = 0, namespace: str = DEFAULT_NAMESPACE,
                 ttl_s: float = 2.0, publish_interval_s: float = 0.25,
                 idle_wait_s: float = 0.01,
                 snapshot_dir: str | os.PathLike | None = None,
                 swap_turn_timeout_s: float = 10.0,
                 pool: str = "default",
                 kv_transport=None) -> None:
        from tpudist_torch.runtime.disagg import CoordKVTransport

        self.loop = loop
        self.client = client
        self.replica_id = replica_id
        # KV-migration channel for disaggregated handoffs: a prefill
        # replica publishes finished-slot KV here before committing the
        # handoff; a decode replica fetches by the dispatched ref.  The
        # coord store is the baseline; pass an IciKVTransport for the
        # device-to-device fast path (colocated loops share one
        # instance).  Unified ("both") replicas never touch it.
        self.kv_transport = (kv_transport if kv_transport is not None
                             else CoordKVTransport(client,
                                                   namespace=namespace))
        self.rank = int(rank)
        self.ns = namespace
        # blue-green pool tag: the router only dispatches to the ACTIVE
        # pool ({ns}/pool key); a structural rollout spawns replicas
        # under a new tag and shifts the key after the canary passes
        self.pool = str(pool)
        self.ttl_s = float(ttl_s)
        self.idle_wait_s = idle_wait_s
        self.snapshot_dir = snapshot_dir
        self.swap_turn_timeout_s = float(swap_turn_timeout_s)
        self._inbox = f"{namespace}/inbox/{replica_id}/"
        self._served = 0
        # coord-brownout degradation: completions that fail to commit
        # (store unreachable) park here and flush on reconnect — the
        # replica keeps decoding through the outage.  Bounded so a
        # never-ending outage cannot grow memory without limit; at the
        # bound the OLDEST is dropped (the router redispatches it after
        # the outage, and greedy determinism re-produces it).
        self._done_buf: list[tuple[str, bytes]] = []
        self._done_buf_cap = 4096
        # rids whose handoff/migration payload fetch missed (the loop
        # re-prefilled): their terminal commits carry adopt_fallback
        self._fallback_rids: set[str] = set()
        # last published prefix-affinity summary; republished on change
        # OR half-TTL age (the summary carries a wall-clock stamp the
        # router's staleness bound reads, so an unchanged-but-alive
        # summary must keep renewing itself)
        self._prefix_pub: tuple | None = None
        self._prefix_pub_t = 0.0
        self._prefix_ttl_s = summary_ttl_from_env()
        self._weights_version = 0
        self._roll: dict | None = None   # the in-progress swap-chain turn
        self._obs_version = obs.gauge("serve/weights_version",
                                      unit="version")
        self._obs_swapping = obs.gauge("serve/swapping", unit="flag")
        self._hb = ElasticMonitor(client, f"{namespace}:{replica_id}",
                                  ttl_s=ttl_s,
                                  interval_s=max(ttl_s / 4, 0.05))
        self._pub = MetricsPublisher(client, self.rank, obs.registry,
                                     namespace=f"{namespace}/metrics",
                                     interval_s=publish_interval_s)
        # request-event ring publisher: per-replica lifecycle events flow
        # to {ns}/events/{rank}; rank 0 (or the bench) merges them into
        # the fleet-wide timeline.  rid -> TraceContext for requests this
        # replica picked up, so the done-commit event can be recorded
        # without widening the completion wire format.
        self._epub = EventPublisher(client, self.rank, obs.events,
                                    namespace=f"{namespace}/events",
                                    interval_s=publish_interval_s)
        self._traces: dict[str, Any] = {}
        if snapshot_dir is not None:
            got = self._restore_latest()
            if got is not None:
                step, tree, meta = got
                self.loop.params = tree
                self._weights_version = int(
                    (meta or {}).get("version", step))
                if hasattr(self.loop, "weights_version"):
                    # the loop's KV version stamp must track the served
                    # weights from the first token: tier entries and
                    # pull payloads minted under this version are only
                    # adoptable by peers on the SAME version
                    self.loop.weights_version = self._weights_version
                log.info("replica %s: restored weights version %d from %s",
                         replica_id, self._weights_version, snapshot_dir)
        self._obs_version.set(self._weights_version)
        self._obs_swapping.set(0)

    def register(self) -> None:
        info = {
            "replica_id": self.replica_id,
            "rank": self.rank,
            "pid": os.getpid(),
            "num_slots": self.loop.B,
            "cache_layout": self.loop.cache_layout,
            "kv_num_blocks": self.loop.kv_num_blocks or None,
            "kv_block_size": self.loop.kv_block_size or None,
            "ttl_s": self.ttl_s,
            "pool": self.pool,
            # two-stage scheduling: the router sends fresh requests to
            # role prefill/both and handoff (decode-stage) requests to
            # role decode/both
            "role": getattr(self.loop, "role", "both"),
        }
        self.client.set(f"{self.ns}/replica/{self.replica_id}",
                        json.dumps(info).encode())

    # -- rolling weight hot-swap ------------------------------------------

    def _restore_latest(self):
        """``(step, tree, meta) | None`` from the fleet snapshot dir."""
        from tpudist_torch.elastic.checkpoint import Checkpointer

        return Checkpointer(self.snapshot_dir,
                            layout="steps").restore_latest(self.loop.params)

    def _restore_params(self):
        """The ``params_fn`` handed to ``request_swap``: the new tree,
        or ``None`` (swap aborts, old weights stay) when the snapshot
        is unreadable — a replica must not die over a failed roll."""
        try:
            got = self._restore_latest()
        except Exception as e:  # noqa: BLE001 - torn write, fs error
            log.warning("replica %s: weight restore failed (%s); "
                        "keeping current weights", self.replica_id, e)
            return None
        return None if got is None else got[1]

    def _finish_roll(self, version: int) -> None:
        """``on_swapped``: the drain-gated rebind just landed (or was
        aborted on a failed restore — either way this replica's TURN is
        over).  Advance the done chain so the next ticket-holder goes,
        and resume advertising for admissions."""
        self._weights_version = int(version)
        self._roll = None
        # the swap flushed the prefix cache AND tier: force a fresh
        # summary publish so the fleet directory unlearns this
        # replica's pre-swap residency immediately
        self._prefix_pub = None
        self._obs_version.set(self._weights_version)
        self._obs_swapping.set(0)
        try:
            self.client.add(f"{self.ns}/weights/done/{version}", 1)
        except ConnectionError:
            # peers fall back to their turn timeout; the chain still
            # completes, just slower
            log.warning("replica %s: could not advance swap done-chain "
                        "for version %d", self.replica_id, version)
        try:
            self._pub.publish()   # the router unlearns `swapping` now
        except Exception:  # noqa: BLE001
            pass
        log.info("replica %s: weights hot-swapped to version %d",
                 self.replica_id, version)

    def _check_weights_roll(self) -> None:
        """One poll of the rolling-upgrade protocol.  Coord errors
        abort the step (retried next poll); `add` is deliberately used
        both to TAKE a ticket (+1) and to READ the done counter (+0).

        One replica at a time: ticket ``t`` swaps when ``done >= t-1``.
        A dead ticket-holder (SIGKILLed mid-chain — the "swap racing a
        death" case) never advances ``done``; after
        ``swap_turn_timeout_s`` of waiting this replica proceeds
        anyway, trading strict seriality for liveness."""
        if self._pending_roll_requested():
            return
        try:
            raw = self.client.get(f"{self.ns}/weights/version")
        except ConnectionError:
            return
        if raw is None:
            return
        try:
            version = int(raw.decode())
        except ValueError:
            return
        if version <= self._weights_version:
            return
        if self._roll is None:
            try:
                ticket = self.client.add(
                    f"{self.ns}/weights/ticket/{version}", 1)
            except ConnectionError:
                return   # may or may not have taken one; see below
            self._roll = {"version": version, "ticket": int(ticket),
                          "since": time.monotonic(), "requested": False}
            log.info("replica %s: weights version %d published; holding "
                     "swap ticket %d", self.replica_id, version, ticket)
        roll = self._roll
        try:
            done = int(self.client.add(
                f"{self.ns}/weights/done/{roll['version']}", 0))
        except ConnectionError:
            return
        waited = time.monotonic() - roll["since"]
        if done < roll["ticket"] - 1 and waited <= self.swap_turn_timeout_s:
            return   # an earlier ticket is still swapping
        if waited > self.swap_turn_timeout_s and done < roll["ticket"] - 1:
            log.warning(
                "replica %s: swap chain for version %d stalled "
                "(done=%d, ticket=%d) after %.1fs; proceeding "
                "(a ticket-holder likely died)", self.replica_id,
                roll["version"], done, roll["ticket"], waited)
        roll["requested"] = True
        # stop advertising for admissions BEFORE draining: the router
        # steers around `swapping` replicas, so requests keep flowing
        # to the rest of the fleet while this one rebinds
        self._obs_swapping.set(1)
        try:
            self._pub.publish()
        except Exception:  # noqa: BLE001
            pass
        self.loop.request_swap(
            self._restore_params, version=roll["version"],
            on_swapped=lambda v=roll["version"]: self._finish_roll(v))

    def _pending_roll_requested(self) -> bool:
        return self._roll is not None and self._roll["requested"]

    def _flush_done_buffer(self) -> None:
        """Re-commit completions parked during a coord brownout, oldest
        first; stop at the first failure (still down)."""
        while self._done_buf:
            key, payload = self._done_buf[0]
            try:
                self.client.set(key, payload)
            except ConnectionError:
                return
            self._done_buf.pop(0)

    def _source(self):
        """One intake poll: ``None`` on a stop key (close and drain),
        else the inbox's requests in key order (the router's dispatch
        order — its keys are zero-padded sequence numbers).  Also the
        tick of the rolling-swap protocol — it rides the same poll
        cadence the loop already guarantees.

        A coord outage mid-poll yields ``[]``, NOT death: in-flight
        decode segments keep running and the poll retries on the
        loop's next tick — replicas ride a brownout out (the buffered
        done commits flush here too)."""
        try:
            self._flush_done_buffer()
            self._publish_prefix()
            self._serve_pulls()
            if getattr(self.loop, "preempt", "degrade") == "migrate":
                # live-migration control plane, checked BEFORE the stop
                # key: a drain sets draining and stop back-to-back once
                # the inbox is empty, and the evacuation armed on this
                # very poll must win that race — the loop keeps flushing
                # migrations after the source closes, so arming here is
                # enough.  Rebalance intents name the requests to
                # evacuate; an intent for a request that already
                # finished is a no-op loop-side (its terminal wins).  A
                # draining flag evacuates EVERYTHING — re-armed every
                # poll so work that arrives after the flag (a racing
                # final dispatch) bounces out too, collapsing drain
                # time to ~one handoff RTT.
                mig_prefix = f"{self.ns}/migrate_req/{self.replica_id}/"
                rids = []
                for key in sorted(self.client.keys(mig_prefix)):
                    self.client.delete(key)
                    rids.append(key[len(mig_prefix):])
                if rids:
                    self.loop.request_migrate(rids)
                if self.client.get(f"{self.ns}/draining/"
                                   f"{self.replica_id}") is not None:
                    self.loop.request_evacuate()
            if (self.client.get(f"{self.ns}/stop") is not None
                    or self.client.get(
                        f"{self.ns}/stop/{self.replica_id}") is not None):
                return None
            if self.snapshot_dir is not None:
                self._check_weights_roll()
            out = []
            for key in sorted(self.client.keys(self._inbox)):
                raw = self.client.get(key)
                self.client.delete(key)
                if raw is None:   # racing a sweep of a presumed death
                    continue
                k = key[len(self._inbox):]
                try:
                    req = _decode_request(raw, namespace=self.ns,
                                          key=k,
                                          replica=self.replica_id)
                except wire.WireError as e:
                    # a corrupt dispatch: silently dropping it would
                    # leave the router waiting until its death sweep or
                    # timeout.  Commit a wire_error VERDICT instead —
                    # the router re-routes the request immediately and
                    # counts the strike against this replica (the
                    # observation point; a replica whose memory or NIC
                    # flips bits accumulates these).
                    log.warning("replica %s: undecodable request %s "
                                "(%s); committing wire_error verdict",
                                self.replica_id, key, e.reason)
                    try:
                        self.client.set(
                            f"{self.ns}/done/{k}",
                            wire.encode_record("completion", {
                                "key": k, "tokens": [],
                                "reason": "wire_error",
                                "replica": self.replica_id,
                                "wire_reason": e.reason}))
                    except ConnectionError:
                        pass
                    continue
                if req.trace is not None:
                    self._traces[str(req.rid)] = req.trace
                req = self._resolve_handoff(req)
                req = self._resolve_prefix_pull(req)
                out.append(req)
        except ConnectionError:
            return []
        return out

    def _serve_pulls(self) -> None:
        """Owner half of the pull-mode global prefix cache: answer
        ``{ns}/pullreq/{rid}/{key}`` requests by exporting the longest
        resident run of the carried prompt's chain (HBM gather or
        host-tier read — the export is a COPY, local residency is
        untouched), publishing it over the KV transport, and committing
        a ``{ns}/pulldone/{key}`` record with the payload ref (or
        ``None`` on a miss — the router reverts the request to an
        ordinary prefill).  Every failure mode degrades to ref=None or
        to the router's pull timeout; a pull can slow a request but
        never lose one."""
        from tpudist_torch.models.kv_pages import chain_hashes

        prefix = f"{self.ns}/pullreq/{self.replica_id}/"
        for key in sorted(self.client.keys(prefix)):
            raw = self.client.get(key)
            self.client.delete(key)
            if raw is None:
                continue
            k = key[len(prefix):]
            ref = None
            try:
                doc = wire.decode_record(raw, expect="pullreq",
                                         namespace=self.ns, key=k,
                                         replica=self.replica_id)
                prompt = [int(t) for t in doc.get("prompt", ())]
                fn = getattr(self.loop, "export_prefix", None)
                bs = getattr(self.loop, "kv_block_size", 0) or 0
                if fn is not None and bs and prompt:
                    payload = fn(chain_hashes(prompt, bs))
                    if payload is not None:
                        payload = dict(payload)
                        payload["key"] = k
                        payload["rid"] = k
                        ref, _ = self.kv_transport.publish(
                            f"pull-{k}", payload)
                        obs.counter("serve/prefix_exports",
                                    unit="payloads").inc()
            except ConnectionError:
                raise   # the outer source poll's brownout handling
            except Exception as e:  # noqa: BLE001 - advisory path
                log.warning("replica %s: prefix export for %s failed "
                            "(%s); answering ref=None", self.replica_id,
                            k, e)
                ref = None
            self.client.set(
                f"{self.ns}/pulldone/{k}",
                wire.encode_record("pulldone", {
                    "key": k, "ref": ref, "owner": self.replica_id}))

    def _resolve_prefix_pull(self, req):
        """Requester half: fetch a dispatched ``prefix_ref`` payload
        and install the peer's pages as local cached-idle prefix blocks
        BEFORE admission, so the admission that follows hits locally
        and prefills only the suffix.  Any miss, corruption, or gate
        failure installs nothing — the ordinary full prefill is the
        byte-identical fallback — and this never raises."""
        ref = getattr(req, "prefix_ref", None)
        if not ref:
            return req
        fn = getattr(self.loop, "install_prefix", None)
        installed = 0
        if fn is not None:
            try:
                payload = self.kv_transport.fetch(ref)
                if payload is not None:
                    installed = int(fn(req.prompt, payload))
            except Exception as e:  # noqa: BLE001 - advisory path
                log.warning("replica %s: prefix install for %s failed "
                            "(%s); falling back to full prefill",
                            self.replica_id, req.rid, e)
        if installed:
            obs.counter("serve/prefix_pull_blocks", unit="blocks").inc(
                installed)
        else:
            obs.counter("serve/prefix_pull_fallbacks", unit="reqs").inc()
            log.info("replica %s: prefix pull for %s yielded no blocks;"
                     " re-prefilling", self.replica_id, req.rid)
        return dataclasses.replace(req, prefix_ref=None)

    def _resolve_handoff(self, req):
        """Swap a decode-stage request's ref stub for the real
        KV-migration payload.  A miss (dropped, corrupt, exporter died
        pre-publish) resolves to ``None`` — the loop re-prefills from
        the carried prompt, so this NEVER raises and never loses the
        request."""
        stub = getattr(req, "kv_handoff", None)
        if not (isinstance(stub, dict) and "handoff_ref" in stub
                and "layers" not in stub):
            return req
        payload = self.kv_transport.fetch(stub["handoff_ref"])
        if payload is None:
            obs.counter("serve/handoff_fallbacks", unit="reqs").inc()
            # remembered until this request's commit: the terminal
            # carries adopt_fallback=True so the router can attribute
            # a migrated request's lost-payload re-prefill
            self._fallback_rids.add(str(req.rid))
            log.warning("replica %s: KV payload %s missing; request %s "
                        "falls back to re-prefill", self.replica_id,
                        stub["handoff_ref"], req.rid)
        return dataclasses.replace(req, kv_handoff=payload)

    def _publish_prefix(self) -> None:
        """Advertise the loop's prefix residency at ``{ns}/prefix/{rid}``
        (checksummed frame, kind="prefix"): the recently admitted opaque
        affinity hashes (the affinity steer), plus — for the fleet-global
        prefix cache — the CHAIN hashes resident in HBM and the host
        tier, the KV block size, the weights version the bytes were
        computed under, and a wall-clock stamp the router's staleness
        bound reads.  Purely advisory: stale or missing summaries only
        cost cache hits, never correctness, so a publish failure is
        swallowed.  Republished on change or at half-TTL age."""
        fn = getattr(self.loop, "prefix_summary", None)
        summ = tuple(int(h) for h in fn()) if fn is not None else ()
        rfn = getattr(self.loop, "prefix_residency", None)
        res = rfn() if rfn is not None else {"chains": [], "tiered": []}
        now = time.time()
        memo = (summ, tuple(res["chains"]), tuple(res["tiered"]),
                self._weights_version)
        if (memo == self._prefix_pub
                and now - self._prefix_pub_t < self._prefix_ttl_s / 2):
            return
        try:
            self.client.set(
                f"{self.ns}/prefix/{self.replica_id}",
                wire.encode_record("prefix", {
                    "replica": self.replica_id,
                    "hashes": list(summ),
                    "chains": [int(h) for h in res["chains"]],
                    "tiered": [int(h) for h in res["tiered"]],
                    "block_size": getattr(self.loop, "kv_block_size",
                                          None) or None,
                    "version": self._weights_version,
                    "at": now}))
        except ConnectionError:
            return   # advisory: retry on the next poll
        self._prefix_pub = memo
        self._prefix_pub_t = now

    def _sink(self, comp) -> None:
        """Commit one completion.  This write is the commit point of the
        exactly-once contract: a replica that dies before it leaves no
        trace, and the router redispatches."""
        if faults.corrupt_canary(str(comp.rid)):
            # injected green-pool wrongness: the replica warms, beats,
            # and serves CORRUPT output — exactly what the blue-green
            # canary exact-check must catch before traffic shifts
            tokens = np.asarray(comp.tokens, np.int32)
            tokens = (tokens + 1 if tokens.size
                      else np.asarray([1], np.int32))
            comp = dataclasses.replace(comp, tokens=tokens)
        if faults.corrupt_probe(str(comp.rid)):
            # injected golden-probe wrongness: a quarantined replica
            # that is still corrupt when re-probed (the reinstatement
            # gate must hold it out; enough of these retires it)
            tokens = np.asarray(comp.tokens, np.int32)
            tokens = (tokens + 1 if tokens.size
                      else np.asarray([1], np.int32))
            comp = dataclasses.replace(comp, tokens=tokens)
        handoff_ref = None
        if comp.reason == "handoff" and comp.handoff is not None:
            # disaggregated handoff, publish-then-commit: the KV payload
            # crosses the transport FIRST, then the done record (with
            # the ref) commits.  A death in the window — exactly what
            # KILL_AT_HANDOFF injects below — leaves no done key, so the
            # router re-runs the prefill elsewhere: at-least-once
            # publish under an exactly-once commit, with greedy
            # determinism collapsing any re-run to identical output.
            doc = dict(comp.handoff)
            doc["key"] = str(comp.rid)
            try:
                handoff_ref, _ = self.kv_transport.publish(
                    str(comp.rid), doc)
            except ConnectionError:
                # coord brownout mid-publish: commit WITHOUT a ref —
                # the decode side re-prefills (exact), nothing is lost
                log.warning("replica %s: KV publish for %s failed; "
                            "decode side will re-prefill",
                            self.replica_id, comp.rid)
            faults.on_handoff_published()
        elif comp.reason == "migrate":
            # live migration, publish-then-commit like the handoff seam:
            # the exported KV crosses the transport first (kind="migrate"
            # routes it through the MIGRATE_DROP knob), then the commit
            # carries the ref.  A SIGKILL in the window — KILL_AT_MIGRATE
            # — leaves no done key; the router's death sweep redispatches
            # the request whole, and greedy determinism makes the re-run
            # byte-identical.  Queued/mid-prefill evacuations arrive
            # payload-less and commit ref-less: the redispatch
            # re-prefills.
            if comp.handoff is not None:
                doc = dict(comp.handoff)
                doc["key"] = str(comp.rid)
                try:
                    handoff_ref, _ = self.kv_transport.publish(
                        str(comp.rid), doc, kind="migrate")
                except ConnectionError:
                    log.warning("replica %s: KV publish for migrating "
                                "%s failed; target will re-prefill",
                                self.replica_id, comp.rid)
            faults.on_migrate_published()
        payload = _encode_completion(
            self.replica_id, comp, handoff_ref=handoff_ref,
            adopt_fallback=str(comp.rid) in self._fallback_rids)
        self._fallback_rids.discard(str(comp.rid))
        # injected wire corruption: flip a bit in the ENCODED frame, so
        # the router-side checksum — not any replica-side check — is
        # the thing that has to catch it
        payload = faults.flip_wire_bits(payload)
        done_key = f"{self.ns}/done/{comp.rid}"
        try:
            self._flush_done_buffer()
            if self._done_buf:   # still down: keep commit order
                raise ConnectionError("coord store still unreachable")
            self.client.set(done_key, payload)
        except ConnectionError:
            if len(self._done_buf) >= self._done_buf_cap:
                dropped, _ = self._done_buf.pop(0)
                log.warning("replica %s: done buffer full during coord "
                            "outage; dropping oldest (%s) — the router "
                            "will redispatch it", self.replica_id,
                            dropped)
            self._done_buf.append((done_key, payload))
        self._served += 1
        trace = self._traces.pop(str(comp.rid), None)
        if trace is not None:
            # the exactly-once commit point, in the timeline: everything
            # after this is router-side consumption
            obs.events.record("done_commit", trace=trace.trace_id,
                              replica=self.replica_id, reason=comp.reason,
                              tokens=int(np.asarray(comp.tokens).size))

    def pool_drained(self) -> bool | None:
        pool = self.loop.pool
        if pool is None:
            return None
        pool.check()
        return pool.free_blocks == pool.num_blocks

    def tier_drained(self) -> bool | None:
        """Host-tier invariants + emptiness for the exit report
        (``None`` when the loop has no tier)."""
        fn = getattr(self.loop, "tier_drained", None)
        return fn() if fn is not None else None

    def serve(self) -> None:
        self.register()
        # registered but not yet heartbeating: the joiner-death window
        # the router's registration grace must bound (KILL_AT_WARMUP
        # dies here — registration persists, no lease ever appears)
        faults.on_warmup()
        self._hb.start(0)
        self._pub.start()
        self._pub.publish()   # immediate: the router gates on load info
        self._epub.start()
        clean = False
        try:
            self.loop.run((), source=self._source, sink=self._sink,
                          idle_wait_s=self.idle_wait_s)
            clean = True
        finally:
            try:
                # release the warm prefix cache + host tier before the
                # drain checks: exit-report drained means the WHOLE KV
                # hierarchy unwound, not just the live slots
                flush = getattr(self.loop, "flush_prefix_cache", None)
                if flush is not None:
                    flush()
            except Exception:
                pass
            try:
                self.client.set(
                    f"{self.ns}/exit/{self.replica_id}",
                    wire.encode_record("heartbeat", {
                        "replica": self.replica_id,
                        "served": self._served,
                        "pool_drained": self.pool_drained(),
                        "tier_drained": self.tier_drained(),
                        "weights_version": self._weights_version,
                        "clean": clean}))
            except Exception:
                pass
            self._pub.stop(final_publish=True)
            self._epub.stop(final_publish=True)
            self._hb.stop(graceful=True)


# -- the router side -------------------------------------------------------

class Router:
    """Health-aware least-loaded request router over the fleet namespace.

    See the module docstring for the failure model.  One ``Router``
    instance serialises one stream of requests; run several routers on
    disjoint namespaces for more.

    Args:
      client: coord client (the router's own; not shared with threads).
      namespace: fleet namespace prefix in the KV store.
      poll_s: idle poll interval of :meth:`run`'s event loop.
      max_redispatch: death-redispatches per request before it completes
        with ``reason="failed"`` (rejection re-routes are not counted —
        they are bounded by ``timeout_s``, not by attempts).
      reject_backoff_s: admission backoff applied to a replica whose
        published ``serve/rejected`` counter grew (it is shedding load).
      stale_after_s / lost_after_s: publish-age bounds handed to the
        health monitor (scaled for serve cadence, not training's).
      slo_quantile: the ``serve/queue_wait_s`` percentile used for SLO
        admission.  A deadline-bearing request is shed at the router
        (``reason="shed"``) when even the BEST candidate's published
        queue-wait at this quantile predicts the deadline is already
        unmeetable — before the request costs any replica a prefill.
        Replicas with no wait samples yet predict 0 (admit; the
        replica-side deadline kill still bounds the damage).
    """

    def __init__(self, client: CoordClient, *,
                 namespace: str = DEFAULT_NAMESPACE,
                 poll_s: float = 0.02,
                 max_redispatch: int = 8,
                 reject_backoff_s: float = 0.25,
                 stale_after_s: float = 3.0,
                 lost_after_s: float = 10.0,
                 slo_quantile: float = 0.99,
                 join_grace_s: float = 30.0,
                 degrade_max_new: int | None = None,
                 use_health: bool = True,
                 journal: bool = True,
                 compact_every: int = 50,
                 outage_grace_s: float = 5.0,
                 pull_min_blocks: int = 2,
                 pull_timeout_s: float = 5.0,
                 rebalance_after_polls: int = 0,
                 rebalance_min_gap: int = 2,
                 rebalance_timeout_s: float = 5.0,
                 prefix_ttl_s: float | None = None,
                 quarantine: bool = True,
                 golden_probe: GoldenProbe | None = None,
                 quarantine_config: QuarantineConfig | None = None,
                 alerts=None,
                 clock=time.monotonic,
                 wall=time.time,
                 sleeper=time.sleep) -> None:
        self.client = client
        self.ns = namespace
        self.poll_s = float(poll_s)
        # optional AlertManager (tpudist_torch.obs.alerts): when wired,
        # the router reads fleet-level degradation through the declarative
        # alert interface — a firing FleetDegraded rule arms the same
        # admission clamp a replica-advertised degraded flag does —
        # instead of growing another bespoke threshold probe
        self.alerts = alerts
        # injectable time sources: an offline fleet simulator (tpudist.sim;
        # its port is still to come) runs this SAME event loop
        # against a virtual clock whose sleeper advances simulated
        # replicas instead of blocking — production keeps the defaults
        self._clock = clock
        self._wall = wall
        self._sleep = sleeper
        self.max_redispatch = int(max_redispatch)
        self.reject_backoff_s = float(reject_backoff_s)
        if not 0.0 < slo_quantile <= 1.0:
            raise ValueError(
                f"slo_quantile must be in (0, 1], got {slo_quantile}")
        self.slo_quantile = float(slo_quantile)
        self.join_grace_s = float(join_grace_s)
        self.degrade_max_new = (None if degrade_max_new is None
                                else int(degrade_max_new))
        # crash recovery: journal request lifecycle to {ns}/journal/*
        # (schema tpudist.journal/1) so a replacement router can rebuild
        # the outstanding-request table with Router.recover().  Journal
        # writes are best-effort (never block routing on a brownout);
        # terminal records are compacted away every `compact_every`
        # polls once delivered.
        self.journal = bool(journal)
        self.compact_every = int(compact_every)
        # coord-brownout degradation: a poll that dies on ConnectionError
        # marks the store down and is SKIPPED (no death verdicts on
        # blind data); after reconnect, death verdicts for ever-live
        # replicas are suppressed another `outage_grace_s` so leases
        # that lapsed server-side during the outage can re-establish
        self.outage_grace_s = float(outage_grace_s)
        # pull-mode global prefix cache: a prefill-stage request whose
        # longest peer coverage beats `pull_min_blocks` full KV blocks
        # — and whose covering peer is NOT dispatchable — parks in a
        # "pull" stage while the owner exports its pages over the KV
        # transport; `pull_timeout_s` (or the owner's death) reverts it
        # to an ordinary prefill.  A pull can delay a request, never
        # lose one.
        self.pull_min_blocks = int(pull_min_blocks)
        self.pull_timeout_s = float(pull_timeout_s)
        # hot/cold rebalancing: after `rebalance_after_polls` consecutive
        # polls showing the SAME replica at least `rebalance_min_gap`
        # outstanding requests above the coolest candidate (or with a
        # published queue wait >= 2x the coolest's), the router asks the
        # hot replica to migrate its oldest in-flight request out via a
        # {ns}/migrate_req control key.  0 (the default) disables it —
        # the least-loaded score then remains admission-time-only.
        self.rebalance_after_polls = int(rebalance_after_polls)
        self.rebalance_min_gap = int(rebalance_min_gap)
        self.rebalance_timeout_s = float(rebalance_timeout_s)
        self._skew_streak: tuple[str, int] | None = None  # (hot rid, n)
        self._migrating: dict[str, float] = {}   # entry key -> cooldown
        self.prefix_dir = PrefixDirectory(client, namespace=namespace,
                                          ttl_s=prefix_ttl_s, wall=wall)
        self._journal_docs: dict[str, dict] = {}
        self._polls = 0
        self._coord_down_since: float | None = None
        self._outage_grace_until = float("-inf")
        self._health = (HealthMonitor(
            client=client, namespace=f"{namespace}/metrics",
            signal="serve/queue_wait_s", skew_threshold=4.0,
            stale_after_s=stale_after_s, lost_after_s=lost_after_s,
            confirm_n=2, recover_n=1) if use_health else None)
        self._seq = 0
        self._dead: set[str] = set()
        self._known: set[str] | None = None  # live set at first poll +
        #   every member seen since; later arrivals are JOINS
        self._backoff: dict[str, float] = {}           # rid -> until (mono)
        self._rejected_seen: dict[str, float] = {}     # rid -> watermark
        # registration→first-heartbeat grace bookkeeping: when each
        # registration was FIRST observed, and which rids have ever held
        # a lease (grace only shields never-live joiners — a member that
        # heartbeat once and stops is a real death, not a slow warmup)
        self._reg_seen: dict[str, float] = {}
        self._ever_live: set[str] = set()
        self._last_pool: str | None = None
        self._pool_gen = 0
        self._obs_requests = obs.counter("router/requests", unit="reqs")
        self._obs_dispatched = obs.counter("router/dispatched", unit="reqs")
        self._obs_completions = obs.counter("router/completions",
                                            unit="reqs")
        self._obs_redispatched = obs.counter("router/redispatched",
                                             unit="reqs")
        self._obs_rerouted = obs.counter("router/rejected_rerouted",
                                         unit="reqs")
        self._obs_deaths = obs.counter("router/replica_deaths",
                                       unit="replicas")
        self._obs_joins = obs.counter("router/joins", unit="replicas")
        self._obs_slo_shed = obs.counter("router/slo_shed", unit="reqs")
        self._obs_prefix_affinity = obs.counter("router/prefix_affinity",
                                                unit="reqs")
        self._obs_drains = obs.counter("router/drains", unit="replicas")
        self._obs_rolls = obs.counter("router/structural_rolls",
                                      unit="rolls")
        self._obs_rollbacks = obs.counter("router/rollbacks", unit="rolls")
        self._obs_degrade_clamped = obs.counter("router/degrade_clamped",
                                                unit="reqs")
        self._obs_recoveries = obs.counter("router/recoveries",
                                           unit="recoveries")
        self._obs_replays = obs.counter("router/recovered_replays",
                                        unit="reqs")
        self._obs_dup_terminals = obs.counter("router/dup_terminals",
                                              unit="reqs")
        self._obs_compactions = obs.counter("router/journal_compactions",
                                            unit="records")
        self._obs_orphans = obs.counter("router/orphans_swept",
                                        unit="keys")
        self._obs_outage_polls = obs.counter("router/outage_polls",
                                             unit="polls")
        # disaggregated two-stage scheduling: handoff consumptions
        # (prefill done -> decode dispatch) and the per-stage depth of
        # the outstanding set — the two pools' load signals
        self._obs_handoffs = obs.counter("router/handoffs", unit="reqs")
        # live KV migration: migrate commits consumed (preemption
        # overflow, rebalance, fast drain), migrations that lost their
        # payload (ref-less commit or adopt-side fetch miss — the
        # request re-prefilled, slower but byte-identical), and
        # rebalance intents issued
        self._obs_migrations = obs.counter("router/migrations",
                                           unit="reqs")
        self._obs_migration_fallbacks = obs.counter(
            "router/migration_fallbacks", unit="reqs")
        self._obs_rebalances = obs.counter("router/rebalances",
                                           unit="reqs")
        self._obs_stage_depth = {
            stage: obs.gauge(f"router/stage_depth~stage={stage}",
                             unit="reqs")
            for stage in ("prefill", "decode")}
        # fleet-global prefix cache: pull-mode exports initiated, and
        # pulls that came back empty / timed out / lost their owner
        # (the request re-prefills — slower, still exact)
        self._obs_prefix_pulls = obs.counter("router/prefix_pulls",
                                             unit="reqs")
        self._obs_pull_fallbacks = obs.counter(
            "router/prefix_pull_fallbacks", unit="reqs")
        # data-plane integrity: payloads that failed checksum/schema
        # verification at a router decode site, and corrupt-segment
        # verdicts replicas reported in-band.  Both feed the quarantine
        # manager's strike ledger.
        self._obs_checksum = obs.counter("integrity/checksum_mismatch",
                                         unit="payloads")
        self._obs_corrupt_seg = obs.counter("integrity/corrupt_segment",
                                            unit="segments")
        # golden probes need known-exact output: without `golden_probe`
        # the manager still quarantines (exclusion is the safe default)
        # but has no evidence path to reinstatement
        self.quarantine = (QuarantineManager(
            client, namespace=namespace, golden=golden_probe,
            config=quarantine_config, clock=clock)
            if quarantine else None)
        self._obs_journal = obs.gauge("router/journal_records",
                                      unit="records")
        self._obs_live = obs.gauge("router/replicas_live", unit="replicas")
        self._obs_outstanding = obs.gauge("router/outstanding", unit="reqs")
        self._obs_pool = obs.gauge("router/pool", unit="generation")
        self._obs_degraded = obs.gauge("router/degraded", unit="bool")
        # per-reason terminal-decision counters: how each request LEFT
        # the router (completed normally, shed at admission, timed out,
        # failed past max_redispatch) plus the non-terminal re-route.
        # Surfaced by loads()' fleet view and the bench JSONL.
        self._obs_decisions = {
            reason: obs.counter(
                f"router/decisions/{reason}", unit="reqs",
                help=f"requests resolved by the router as {reason!r}")
            for reason in ("completed", "shed", "rejected", "failed",
                           "timeout")}

    def _decide(self, reason: str, e: dict | None = None,
                **fields) -> None:
        """Count a routing decision, feed the SLO tracker, and (for a
        traced request) append the matching timeline event."""
        c = self._obs_decisions.get(reason)
        if c is not None:
            c.inc()
        if reason != "rejected":   # re-routes are not terminal outcomes
            req = (e or {}).get("req")
            obs.slo.observe(reason if reason != "completed"
                            else fields.get("serve_reason", "stop"),
                            priority=int(getattr(req, "priority", 0) or 0))
        trace = (e or {}).get("trace")
        if trace is not None:
            kind = {"completed": "done", "rejected": "reroute"}.get(
                reason, reason)
            obs.events.record(kind, trace=trace.trace_id, **fields)

    def decisions(self) -> dict[str, float]:
        """Per-reason terminal decision counts (plus re-routes under
        ``rejected``): ``{reason: count}``."""
        return {reason: c.value()
                for reason, c in self._obs_decisions.items()}

    # -- fleet view --------------------------------------------------------

    def replicas(self) -> dict[str, dict]:
        """Registered replicas: ``{replica_id: registration info}``."""
        out = {}
        prefix = f"{self.ns}/replica/"
        for key in self.client.keys(prefix):
            raw = self.client.get(key)
            if raw is not None:
                out[key[len(prefix):]] = json.loads(raw.decode())
        return out

    def live(self) -> set[str]:
        """Replica ids currently holding a heartbeat lease."""
        mark = f"{self.ns}:"
        return {name[len(mark):] for name in self.client.live()
                if name.startswith(mark)}

    def draining(self) -> set[str]:
        """Replica ids marked for graceful drain (``{ns}/draining/{rid}``
        — set by the autoscaler's scale-down or a blue-green commit):
        the router stops dispatching to them, their in-flight work
        finishes, and their eventual departure counts as a DRAIN, not a
        death."""
        prefix = f"{self.ns}/draining/"
        try:
            return {k[len(prefix):] for k in self.client.keys(prefix)}
        except ConnectionError:
            return set()

    def _active_pool(self) -> str | None:
        """The pool tag traffic is pinned to (``{ns}/pool`` key), or
        ``None`` before any structural rollout — every pool eligible."""
        try:
            raw = self.client.get(f"{self.ns}/pool")
        except ConnectionError:
            return self._last_pool
        return raw.decode() if raw is not None else None

    def loads(self, regs: dict[str, dict]) -> dict[str, dict]:
        """Published load per replica id: queue depth + free KV blocks
        gauges, the lifetime queue-wait mean and ``slo_quantile``
        percentile (the SLO-admission predictor), the weights version,
        and the mid-hot-swap flag."""
        rank_to_rid = {int(info.get("rank", -1)): rid
                       for rid, info in regs.items()}
        out: dict[str, dict] = {}
        for rank, snap in collect(self.client,
                                  f"{self.ns}/metrics").items():
            rid = rank_to_rid.get(rank)
            if rid is None:
                continue
            gauges = snap.get("gauges", {})
            counters = snap.get("counters", {})
            wait = snap.get("histograms", {}).get("serve/queue_wait_s")
            out[rid] = {
                "queue_depth": (gauges.get("serve/queue_depth")
                                or {}).get("value") or 0.0,
                "kv_blocks_free": (gauges.get("serve/kv_blocks_free")
                                   or {}).get("value"),
                "queue_wait_mean": (wait["sum"] / wait["count"]
                                    if wait and wait["count"] else 0.0),
                "queue_wait_q": (hist_quantile(wait, self.slo_quantile)
                                 if wait and wait["count"] else 0.0),
                "rejected": (counters.get("serve/rejected")
                             or {}).get("value") or 0.0,
                "timeouts": (counters.get("serve/timeouts")
                             or {}).get("value") or 0.0,
                "swapping": bool((gauges.get("serve/swapping")
                                  or {}).get("value") or 0.0),
                "degraded": bool((gauges.get("serve/degraded")
                                  or {}).get("value") or 0.0),
                "weights_version": (gauges.get("serve/weights_version")
                                    or {}).get("value"),
                # RTT-amortization factor per replica: how many tokens
                # the last drained dispatch generated, and the lifetime
                # host round-trip count (fused multi-token decode)
                "steps_per_dispatch": (
                    gauges.get("serve/steps_per_dispatch")
                    or {}).get("value"),
                "dispatches": (counters.get("serve/dispatches")
                               or {}).get("value") or 0.0,
                "age_s": snap.get("age_s"),
            }
        return out

    def _update_backoffs(self, loads: dict[str, dict]) -> None:
        """A replica whose ``serve/rejected`` counter grew is shedding:
        pause new admissions to it briefly instead of feeding the shed."""
        now = self._clock()
        for rid, l in loads.items():
            seen = self._rejected_seen.get(rid, 0.0)
            if l["rejected"] > seen:
                self._backoff[rid] = now + self.reject_backoff_s
            self._rejected_seen[rid] = l["rejected"]

    def _prefix_map(self, candidates: Sequence[str]) -> dict[str, set[int]]:
        """One read of every candidate's published prefix-affinity
        summary, once per poll, through the fleet directory (which
        applies the ``TPUDIST_PREFIX_SUMMARY_TTL_S`` staleness bound —
        a dead-but-registered replica's last publish must not keep
        attracting affinity traffic).  Corrupt, missing, or stale
        summaries degrade to no-affinity — the hash steer is advisory,
        the least-loaded tie-break still places the request."""
        self.prefix_dir.refresh(candidates)
        return self.prefix_dir.affinity(candidates)

    def _pick(self, candidates: Sequence[str], loads: dict[str, dict],
              assigned: dict[str, int],
              prefix_hash: int | None = None,
              prefix_map: dict[str, set[int]] | None = None) -> str | None:
        """Least-loaded with prefix affinity: replicas whose published
        prefix-cache summary holds the request's prefix hash sort ahead
        (their shared KV pages make the admission nearly prefill-free),
        then fewest known-outstanding work (the router's own
        assignments are fresher than any published gauge), then
        shortest published queue wait, then most free KV blocks (a
        dense replica has no block limit and sorts as infinite)."""
        best, best_score = None, None
        for rid in candidates:
            l = loads.get(rid, {})
            free = l.get("kv_blocks_free")
            hit = (prefix_hash is not None and prefix_map is not None
                   and prefix_hash in prefix_map.get(rid, ()))
            score = (
                0 if hit else 1,
                assigned.get(rid, 0) + l.get("queue_depth", 0.0),
                l.get("queue_wait_mean", 0.0),
                -(free if free is not None else float("inf")),
            )
            if best_score is None or score < best_score:
                best, best_score = rid, score
        if best is not None and best_score[0] == 0:
            self._obs_prefix_affinity.inc()
        return best

    # -- hot/cold rebalancing ----------------------------------------------

    @staticmethod
    def rebalance_hot_cold(loads: dict[str, dict],
                           candidates: Sequence[str],
                           assigned: dict[str, int], *,
                           min_gap: int = 2) -> tuple[str, str] | None:
        """``(hot, cold)`` when one candidate carries at least
        ``min_gap`` more outstanding work (router assignments + its
        published queue depth) than the coolest — or advertises a
        queue-wait percentile at least 2x the coolest's non-zero one.
        Pure: the skew signal is unit-testable on synthetic loads."""
        if len(candidates) < 2:
            return None

        def depth(rid: str) -> float:
            return assigned.get(rid, 0) + (
                loads.get(rid, {}).get("queue_depth") or 0.0)

        hot = max(candidates, key=depth)
        cold = min(candidates, key=depth)
        if hot == cold:
            return None
        hot_wait = loads.get(hot, {}).get("queue_wait_q") or 0.0
        cold_wait = loads.get(cold, {}).get("queue_wait_q") or 0.0
        if (depth(hot) - depth(cold) >= min_gap
                or (cold_wait > 0.0 and hot_wait >= 2.0 * cold_wait)):
            return hot, cold
        return None

    @staticmethod
    def rebalance_victim(entries: dict[str, dict], done: dict,
                         hot: str, migrating=()) -> str | None:
        """The OLDEST outstanding request assigned to the hot replica
        (smallest dispatch key — the longest-running decode, whose
        remaining work is most worth moving) not already
        mid-migration."""
        keys = sorted(k for k, e in entries.items()
                      if k not in done and k not in migrating
                      and e.get("assigned") == hot
                      and e.get("stage", "prefill") != "pull")
        return keys[0] if keys else None

    def _sweep_dead(self, rid: str, regs: dict[str, dict]) -> None:
        """Remove a dead replica's coordination residue so restarted
        ids and fresh health rounds start clean."""
        for key in (list(self.client.keys(f"{self.ns}/inbox/{rid}/"))
                    # pending pull requests addressed to the dead
                    # owner: nobody will answer them (the waiting
                    # entries revert to prefill on their pull timeout)
                    + list(self.client.keys(f"{self.ns}/pullreq/{rid}/"))
                    # unconsumed migrate intents: the outstanding work
                    # is redispatched below anyway, and a replica
                    # reusing the id must not inherit stale evictions
                    + list(self.client.keys(
                        f"{self.ns}/migrate_req/{rid}/"))):
            try:
                self.client.delete(key)
            except ConnectionError:
                pass
        for key in (f"{self.ns}/replica/{rid}",
                    f"{self.ns}/metrics/{regs.get(rid, {}).get('rank')}",
                    f"{self.ns}/draining/{rid}",
                    f"{self.ns}/prefix/{rid}",
                    f"{self.ns}/quarantined/{rid}"):
            try:
                self.client.delete(key)
            except ConnectionError:
                pass
        if self.quarantine is not None:
            # its quarantine record dies with it: a future replica
            # reusing the id starts with a clean strike ledger
            self.quarantine.drop(rid)

    # -- crash-recovery journal --------------------------------------------
    #
    # One record per request at {ns}/journal/{key}, written full-record
    # (idempotent) at each lifecycle transition.  Write-ordering
    # invariants (see docs/DESIGN.md "Control-plane recovery"):
    #
    #   * dispatch: inbox set FIRST, then journal assigned-update — a
    #     crash in the window leaves the record open-unassigned, so
    #     recovery redispatches; under greedy determinism a resulting
    #     double-serve commits an identical duplicate done key, which
    #     consumption dedupes.
    #   * terminal: read done key -> journal terminal (WITH tokens) ->
    #     delete done key -> deliver.  Consumption is journaled before
    #     the done key is destroyed, so "journal open + no done key"
    #     always means the replica has not committed yet (safe to keep
    #     waiting), never "the outcome was consumed and lost".
    #
    # Journal writes are best-effort: a brownout skips them (routing
    # must not stall on the journal) and the record catches up on the
    # next transition's full-record write.

    def _journal_key(self, k: str) -> str:
        return f"{self.ns}/journal/{k}"

    def _journal_write(self, k: str) -> None:
        if not self.journal:
            return
        doc = self._journal_docs.get(k)
        if doc is None:
            return
        try:
            self.client.set(self._journal_key(k),
                            wire.encode_record("journal", doc))
        except ConnectionError:
            pass

    def _journal_submit(self, entries: dict[str, dict]) -> None:
        """Journal every request at submit time (terminal=None,
        unassigned), so recovery needs only the store — arrival
        schedules and caller rids ride in the record."""
        if not self.journal:
            return
        for k, e in entries.items():
            req = e["req"]
            self._journal_docs[k] = {
                "schema": JOURNAL_SCHEMA,
                "req": _request_doc(k, req),
                "rid": str(req.rid),
                "assigned": None,
                "attempts": 0,
                "at": float(e.get("at", 0.0)),
                "terminal": None,
            }
            self._journal_write(k)
        self._obs_journal.set(len(self._journal_docs))

    def _journal_assign(self, k: str, e: dict) -> None:
        doc = self._journal_docs.get(k)
        if doc is None:
            return
        doc["assigned"] = e["assigned"]
        doc["attempts"] = int(e["attempts"])
        self._journal_write(k)

    def _journal_handoff(self, k: str, e: dict, *,
                         stage: str = "decode") -> None:
        """The stage transition's journal record: the new stage plus the
        payload ref, written BEFORE the prefill done key is destroyed —
        a router crash in between recovers into a decode-stage entry
        and redispatches it exactly once (to the decode pool, payload
        ref intact; a lost payload degrades to re-prefill, never to a
        lost or doubled request).  Migrate commits ride the same record
        with ``stage="decode"`` (payload exported) or ``"prefill"``
        (ref-less: the redispatch re-prefills)."""
        doc = self._journal_docs.get(k)
        if doc is None:
            return
        doc["stage"] = stage
        doc["handoff_ref"] = e.get("handoff_ref")
        doc["assigned"] = None
        doc["attempts"] = int(e["attempts"])
        self._journal_write(k)

    def _journal_pull(self, k: str, e: dict) -> None:
        """Journal a pull-stage transition (initiation: stage="pull";
        resolution: stage back to "prefill" with the payload ref, or
        without one on a fallback).  A router crash mid-pull recovers
        the entry as an ordinary prefill — the pull was an
        optimization, the request's exactly-once contract never
        depended on it."""
        doc = self._journal_docs.get(k)
        if doc is None:
            return
        doc["stage"] = e.get("stage", "prefill")
        doc["prefix_ref"] = e.get("prefix_ref")
        doc["assigned"] = None
        doc["attempts"] = int(e["attempts"])
        self._journal_write(k)

    def _journal_terminal(self, k: str, reason: str, tokens,
                          serve_reason: str | None = None) -> None:
        doc = self._journal_docs.get(k)
        if doc is None:
            return
        doc["terminal"] = reason
        doc["serve_reason"] = serve_reason
        doc["tokens"] = np.asarray(tokens).astype(int).tolist()
        doc["assigned"] = None
        self._journal_write(k)

    def _compact_journal(self, done: dict) -> None:
        """Delete journal records for DELIVERED terminals — the journal
        stays bounded by the outstanding set, not by run length."""
        if not self.journal:
            return
        for k in [k for k, doc in self._journal_docs.items()
                  if doc.get("terminal") is not None and k in done]:
            try:
                self.client.delete(self._journal_key(k))
            except ConnectionError:
                continue   # keep the doc; retried next compaction
            del self._journal_docs[k]
            self._obs_compactions.inc()
        self._obs_journal.set(len(self._journal_docs))

    # -- the event loop ----------------------------------------------------

    def run(self, requests: Sequence[Any], *,
            timeout_s: float = 120.0,
            arrivals: Sequence[float] | None = None,
            on_complete=None) -> list[Any]:
        """Route ``requests`` across the fleet; returns one
        :class:`~tpudist_torch.models.serving.Completion` per request, in
        FINISH order, with each completion's ``rid`` restored to the
        caller's.  Raises :class:`TimeoutError` after ``timeout_s`` —
        the no-hang bound for total-fleet loss.

        ``arrivals`` (one offset in seconds per request, from run
        start) replays a TIMED workload through the same submit path:
        each request becomes visible to dispatch — and its trace is
        minted — only once its offset elapses, so a scenario's diurnal
        ramp or flash crowd hits the fleet with its real shape instead
        of as one up-front batch.

        ``on_complete(key, completion)`` is invoked as each terminal
        decision lands (AFTER its journal terminal record) — the
        incremental delivery hook the ``--route`` CLI uses to stream
        results to disk so a crashed router's successor knows what was
        already delivered."""
        if arrivals is not None and len(arrivals) != len(requests):
            raise ValueError(
                f"arrivals ({len(arrivals)}) must match requests "
                f"({len(requests)})")
        entries: dict[str, dict] = {}
        for i, req in enumerate(requests):
            key = f"{self._seq:08d}"
            self._seq += 1
            at = 0.0 if arrivals is None else max(0.0, float(arrivals[i]))
            entries[key] = {"req": req, "assigned": None, "attempts": 0,
                            "trace": None, "at": at, "arrived": False}
        self._journal_submit(entries)
        return self._drive(entries, timeout_s=timeout_s,
                           on_complete=on_complete)

    def recover(self, *, timeout_s: float = 120.0,
                delivered: Sequence[str] = (),
                on_complete=None) -> list[Any]:
        """Rebuild the outstanding-request table from ``{ns}/journal/*``
        + done keys and drive it to completion — the crashed-router
        failover path.  Live replicas are RE-ADOPTED without a restart
        (their open assignments stay assigned; their committed done
        keys are consumed normally); assignments to dead replicas flow
        through the ordinary death-redispatch machinery on the first
        poll; orphaned inbox entries (assigned elsewhere, or already
        terminal) are swept; terminal-journaled requests are replayed
        from their stored tokens — unless their caller rid is in
        ``delivered`` (rids the previous router already delivered, e.g.
        read back from the ``--results`` file) — and any duplicate done
        key they left behind is deleted and counted
        (``router/dup_terminals``).  Returns replayed + newly finished
        completions in finish order."""
        from tpudist_torch.models.serving import Completion

        self._obs_recoveries.inc()
        seen_delivered = {str(r) for r in delivered}
        prefix = f"{self.ns}/journal/"
        records: dict[str, dict] = {}
        for key in self.client.keys(prefix):
            raw = self.client.get(key)
            if raw is None:
                continue
            try:
                doc = wire.decode_record(raw, expect="journal",
                                         namespace=self.ns,
                                         key=key[len(prefix):])
            except wire.WireError as err:
                # a corrupt journal record cannot be recovered FROM —
                # count it and skip; the request it described either
                # has a live done key (consumed normally) or is lost
                # to this recovery, never a poll-loop crash
                self._obs_checksum.inc()
                log.warning("router: skipping corrupt journal record "
                            "%s (%s)", key, err.reason)
                continue
            if doc.get("schema") != JOURNAL_SCHEMA:
                continue
            records[key[len(prefix):]] = doc
        # never mint a key that could collide with a journaled one
        for k in records:
            try:
                self._seq = max(self._seq, int(k) + 1)
            except ValueError:
                pass
        self._journal_docs = dict(records)
        self._obs_journal.set(len(records))
        entries: dict[str, dict] = {}
        replays: list[tuple[str, Any]] = []
        for k in sorted(records):
            doc = records[k]
            rid = str(doc.get("rid", k))
            if doc.get("terminal") is not None:
                # the decision was made (and journaled) before the
                # crash: replay it from the stored tokens rather than
                # re-running, and delete the duplicate done key a
                # falsely-presumed-dead replica may have left
                try:
                    if self.client.get(f"{self.ns}/done/{k}") is not None:
                        self.client.delete(f"{self.ns}/done/{k}")
                        self._obs_dup_terminals.inc()
                except ConnectionError:
                    pass
                if rid in seen_delivered:
                    # terminal AND already delivered: nothing left to
                    # do — compact the record away right now
                    try:
                        self.client.delete(self._journal_key(k))
                        del self._journal_docs[k]
                        self._obs_compactions.inc()
                    except ConnectionError:
                        pass
                    continue
                replays.append((k, Completion(
                    rid=rid,
                    prompt=np.asarray(doc["req"]["prompt"], np.int32),
                    tokens=np.asarray(doc.get("tokens", ()), np.int32),
                    reason=doc["terminal"])))
                continue
            req = dataclasses.replace(
                _decode_request(json.dumps(doc["req"]).encode()),
                rid=rid)
            tc = TraceContext.mint(k)
            stage = doc.get("stage", "prefill")
            if stage == "pull":
                # a pull was in flight when the router died: the pull
                # was an OPTIMIZATION — recover the request as an
                # ordinary prefill (the orphaned pullreq/pulldone keys
                # are residue a later poll sweeps)
                stage = "prefill"
            entries[k] = {"req": req,
                          "assigned": doc.get("assigned"),
                          "attempts": int(doc.get("attempts", 0)),
                          # a journaled handoff recovers mid-pipeline:
                          # stage=decode + the payload ref, so the
                          # replacement router dispatches straight to
                          # the decode pool (ref missing -> re-prefill)
                          "stage": stage,
                          "handoff_ref": doc.get("handoff_ref"),
                          "prefix_ref": doc.get("prefix_ref"),
                          "trace": tc, "at": 0.0, "arrived": True}
            obs.events.record("recover_adopt", trace=tc.trace_id,
                              key=k, rid=rid,
                              assigned=doc.get("assigned"),
                              attempts=int(doc.get("attempts", 0)))
        if replays:
            self._obs_replays.inc(len(replays))
        # sweep orphaned inbox entries: anything not matching an open
        # journal assignment is residue of the crashed router (a
        # terminal request's leftover dispatch, or a dispatch superseded
        # by a redispatch) — a replica must not serve it again
        inbox_prefix = f"{self.ns}/inbox/"
        for key in self.client.keys(inbox_prefix):
            rid_part, _, k = key[len(inbox_prefix):].partition("/")
            e = entries.get(k)
            if e is not None and e["assigned"] == rid_part:
                continue
            try:
                self.client.delete(key)
                self._obs_orphans.inc()
            except ConnectionError:
                pass
        log.info("router: recovered %d open + %d terminal journal "
                 "records (%d replayed)", len(entries),
                 len(records) - len(entries), len(replays))
        return self._drive(entries, timeout_s=timeout_s,
                           on_complete=on_complete, preloaded=replays)

    def _drive(self, entries: dict[str, dict], *, timeout_s: float,
               on_complete=None, preloaded: Sequence[tuple] = ()
               ) -> list[Any]:
        done: dict[str, Any] = {}
        finish: list[str] = []
        remaining = set(entries)

        def complete(key: str, comp) -> None:
            done[key] = comp
            finish.append(key)
            remaining.discard(key)
            self._obs_completions.inc()
            # payload lifecycle belongs to the ROUTER (the request's
            # owner): KV-migration and prefix-pull payloads die with
            # the request's terminal, whatever the terminal was — an
            # exporter death cannot leak them
            e = entries.get(key) or {}
            for ref in (e.get("handoff_ref"), e.get("prefix_ref")):
                if ref:
                    try:
                        self.client.delete(ref)
                    except ConnectionError:
                        pass
            if on_complete is not None:
                on_complete(key, comp)

        for k, comp in preloaded:
            complete(k, comp)
        start = self._clock()
        deadline = start + timeout_s
        while remaining:
            if self._clock() > deadline:
                raise TimeoutError(
                    f"router: {len(remaining)} of "
                    f"{len(entries)} requests unresolved after "
                    f"{timeout_s:.0f}s (live replicas: "
                    f"{sorted(self._live_or(set()))})")
            progressed = self._arrive(entries, start) > 0
            try:
                progressed = (self._poll(entries, done, complete)
                              or progressed)
            except ConnectionError as err:
                # coord brownout: poll blind — keep in-flight decodes
                # running, make NO death verdicts, and retry.  The
                # store being unreachable is stale-not-lost, fleet-wide.
                if self._coord_down_since is None:
                    self._coord_down_since = self._clock()
                    log.warning("router: coord store unreachable (%s); "
                                "polling blind until it returns", err)
                self._obs_outage_polls.inc()
                progressed = False
            else:
                if self._coord_down_since is not None:
                    gap = self._clock() - self._coord_down_since
                    self._outage_grace_until = (self._clock()
                                                + self.outage_grace_s)
                    self._coord_down_since = None
                    log.info("router: coord store back after %.1fs; "
                             "suppressing death verdicts for %.1fs",
                             gap, self.outage_grace_s)
            self._polls += 1
            if (self.journal and self.compact_every > 0
                    and self._polls % self.compact_every == 0):
                self._compact_journal(done)
            self._obs_outstanding.set(len(remaining))
            if not progressed:
                self._sleep(self.poll_s)
        # sweep duplicate done keys (a presumed-dead replica may have
        # committed after its redispatch; greedy determinism makes the
        # duplicate identical, so it is just deleted), then compact the
        # journal to empty — every record is delivered now
        for key in entries:
            try:
                self.client.delete(f"{self.ns}/done/{key}")
            except ConnectionError:
                pass
        self._compact_journal(done)
        self._obs_outstanding.set(0)
        return [done[k] for k in finish]

    def _live_or(self, fallback: set[str]) -> set[str]:
        try:
            return self.live()
        except ConnectionError:
            return fallback

    def _arrive(self, entries: dict[str, dict], start: float) -> int:
        """Admit entries whose arrival offset has elapsed: mint the
        trace context — submit IS the trace root; it lives in the
        router entry (not just the request) so a redispatch re-sends
        the SAME context and the replica-side events of both attempts
        merge under one trace id — and record the enqueue event with
        the request's replayable shape (prompt length, budget,
        priority, relative deadline), which is what lets a recorded
        trace be turned back into a workload."""
        now = self._clock() - start
        n = 0
        for key, e in entries.items():
            if e.get("arrived", True) or e.get("at", 0.0) > now:
                continue
            e["arrived"] = True
            req = e["req"]
            tc = TraceContext.mint(key)
            e["trace"] = tc
            obs.events.record(
                "enqueue", trace=tc.trace_id, key=key,
                rid=str(req.rid),
                prompt_tokens=int(np.asarray(req.prompt).size),
                max_new=int(req.max_new_tokens),
                priority=int(getattr(req, "priority", 0) or 0),
                rel_deadline_s=(
                    None if req.deadline_s is None
                    else round(req.deadline_s - self._wall(), 6)))
            n += 1
        if n:
            self._obs_requests.inc(n)
        return n

    def _poll(self, entries: dict[str, dict], done: dict,
              complete) -> bool:
        from tpudist_torch.models.serving import Completion

        faults.on_router_poll()
        progressed = False
        regs = self.replicas()
        live = self.live() - self._dead
        self._obs_live.set(len(live))
        now_mono = self._clock()
        self._ever_live |= live
        for rid in regs:
            self._reg_seen.setdefault(rid, now_mono)
        draining = self.draining()
        pool = self._active_pool()
        if pool != self._last_pool:
            self._pool_gen += 1
            log.info("router: active pool is now %r (generation %d)",
                     pool, self._pool_gen)
            self._last_pool = pool
        self._obs_pool.set(self._pool_gen)

        # live-join discovery: membership is re-read every poll, so a
        # replica that registered after this router started (or even
        # mid-run) takes traffic on the very next dispatch.  The first
        # poll's live set is the baseline fleet, not a join.
        if self._known is None:
            self._known = set(live)
        else:
            joined = live - self._known
            if joined:
                self._known |= joined
                self._obs_joins.inc(len(joined))
                log.info("router: replica(s) %s joined the fleet",
                         sorted(joined))

        # 1) consume completions FIRST: work a replica committed just
        # before dying must not be re-run
        quarantined = (self.quarantine.quarantined()
                       if self.quarantine is not None else set())

        def reroute(key: str, k: str, e: dict, replica: str,
                    reason: str) -> None:
            """Un-deliver one done key: destroy it, clear the
            assignment so dispatch re-routes, and back the replica
            off — the shared tail of every shed/integrity verdict."""
            self.client.delete(key)
            e["assigned"] = None
            self._journal_assign(k, e)
            self._obs_rerouted.inc()
            if replica:
                self._backoff[replica] = (self._clock()
                                          + self.reject_backoff_s)
            self._decide("rejected", e, replica=replica or None,
                         verdict=reason)

        done_prefix = f"{self.ns}/done/"
        for key in self.client.keys(done_prefix):
            k = key[len(done_prefix):]
            if k.startswith("probe-"):
                continue   # golden-probe answers: the quarantine
                #            manager consumes these, not the run loop
            e = entries.get(k)
            if e is None or k in done:
                continue
            raw = self.client.get(key)
            if raw is None:
                continue
            try:
                payload = wire.decode_record(
                    raw, expect="completion", namespace=self.ns,
                    key=k, replica=e["assigned"] or "")
            except wire.WireError as err:
                # a corrupt commit must never be delivered: count it,
                # strike the replica the payload was assigned to (the
                # bytes are untrustworthy, so attribution comes from
                # the router's own assignment table), and redispatch
                progressed = True
                self._obs_checksum.inc()
                log.warning("router: corrupt done payload %s (%s) "
                            "from replica %r; redispatching", k,
                            err.reason, err.replica)
                if self.quarantine is not None and err.replica:
                    self.quarantine.strike(err.replica,
                                           f"wire/{err.reason}")
                    quarantined = self.quarantine.quarantined()
                reroute(key, k, e, err.replica, "checksum_mismatch")
                continue
            req = e["req"]
            comp = Completion(
                rid=req.rid, prompt=np.asarray(req.prompt),
                tokens=np.asarray(payload.get("tokens", ()), np.int32),
                reason=str(payload.get("reason")))
            progressed = True
            replica = str(payload.get("replica") or "")
            if comp.reason == "rejected":
                # replica-side load shed: re-route, don't surface —
                # the request was admitted to the FLEET, and some other
                # replica (or this one, later) can still serve it
                reroute(key, k, e, replica, "rejected")
            elif comp.reason in ("corrupt_segment", "wire_error"):
                # in-band integrity verdicts: the replica caught its
                # own corruption (NaN-frozen lane / undecodable inbox
                # payload).  Same answer as a checksum mismatch —
                # strike + redispatch — just attributed by the replica
                # itself instead of by this router's verification.
                if comp.reason == "corrupt_segment":
                    self._obs_corrupt_seg.inc()
                else:
                    self._obs_checksum.inc()
                log.warning("router: replica %s reported %s for %s; "
                            "redispatching", replica, comp.reason, k)
                if self.quarantine is not None and replica:
                    self.quarantine.strike(replica, comp.reason)
                    quarantined = self.quarantine.quarantined()
                reroute(key, k, e, replica, comp.reason)
            elif replica and replica in quarantined:
                # a quarantined replica's commit: the checksum proves
                # the BYTES crossed intact, not that the compute behind
                # them did — a replica under integrity suspicion does
                # not get to deliver.  Redispatch to a trusted one
                # (greedy determinism dedupes any duplicate).
                reroute(key, k, e, replica, "quarantined")
            elif comp.reason == "handoff":
                # two-stage scheduling: a prefill replica finished its
                # half and migrated the KV.  NOT a terminal — flip the
                # entry to the decode stage and let dispatch place it
                # on the decode pool.  Journal-then-delete ordering
                # mirrors the terminal path: a crash in between
                # recovers a decode-stage record (payload ref intact)
                # and redispatches exactly once.
                e["stage"] = "decode"
                e["handoff_ref"] = payload.get("handoff_ref")
                e["assigned"] = None
                self._journal_handoff(k, e)
                self.client.delete(key)
                self._obs_handoffs.inc()
                trace = e.get("trace")
                if trace is not None:
                    obs.events.record("handoff", trace=trace.trace_id,
                                      from_replica=replica,
                                      ref=e["handoff_ref"])
            elif comp.reason == "migrate":
                # live migration: the replica evacuated this request
                # (preemption overflow, rebalance intent, fast drain).
                # NOT a terminal — with a payload ref the entry becomes
                # a decode-stage redispatch (the target adopts the
                # mid-decode pages and continues); ref-less (queued or
                # mid-prefill at export time, or the publish browned
                # out) it reverts to an ordinary prefill, byte-identical
                # under greedy determinism.  Same journal-then-delete
                # ordering as the handoff stage, so recover() resumes a
                # mid-migration request exactly once.
                ref = payload.get("handoff_ref")
                e["stage"] = "decode" if ref else "prefill"
                e["handoff_ref"] = ref
                e["assigned"] = None
                e["migrated"] = True
                self._journal_handoff(k, e, stage=e["stage"])
                self.client.delete(key)
                self._obs_migrations.inc()
                if not ref:
                    self._obs_migration_fallbacks.inc()
                self._migrating.pop(k, None)
                trace = e.get("trace")
                if trace is not None:
                    obs.events.record("migrate", trace=trace.trace_id,
                                      from_replica=replica, ref=ref)
            else:
                # commit-point ordering: journal the terminal (WITH the
                # tokens) before destroying the done key, so a crash in
                # between leaves a replayable record instead of an
                # outcome that was consumed and lost
                if e.get("migrated") and payload.get("adopt_fallback"):
                    # the migrated payload crossed but the adopting
                    # replica's fetch missed (drop-injected or expired):
                    # it re-prefilled — exact, but the migration's
                    # latency win was lost.  Count it.
                    self._obs_migration_fallbacks.inc()
                self._journal_terminal(k, comp.reason, comp.tokens)
                self.client.delete(key)
                complete(k, comp)
                self._decide("completed", e, serve_reason=comp.reason,
                             replica=payload.get("replica"),
                             tokens=int(np.asarray(comp.tokens).size))

        # 1.5) pull-mode global prefix cache: consume owner export
        # answers, expire stalled pulls.  Resolution either way flips
        # the entry back to prefill stage so dispatch places it — with
        # the payload ref when the export landed, without one (full
        # re-prefill, still exact) on any miss/timeout/owner-death.
        pd_prefix = f"{self.ns}/pulldone/"
        for key in self.client.keys(pd_prefix):
            k = key[len(pd_prefix):]
            raw = self.client.get(key)
            if raw is None:
                continue
            try:
                payload = wire.decode_record(raw, expect="pulldone",
                                             namespace=self.ns, key=k)
                ref = payload.get("ref")
            except wire.WireError:
                ref = None
            e = entries.get(k)
            if e is None or k in done or e.get("stage") != "pull":
                # residue: the request resolved some other way (timeout,
                # terminal, recovery) before the owner answered — the
                # published payload dies here, never leaks
                self.client.delete(key)
                if ref:
                    try:
                        self.client.delete(str(ref))
                    except ConnectionError:
                        pass
                continue
            e["stage"] = "prefill"
            e["prefix_ref"] = str(ref) if ref else None
            e["pull_deadline"] = None
            self._journal_pull(k, e)
            self.client.delete(key)
            progressed = True
            if not ref:
                self._obs_pull_fallbacks.inc()
            trace = e.get("trace")
            if trace is not None:
                obs.events.record("pull_done", trace=trace.trace_id,
                                  owner=e.get("pull_owner"),
                                  ref=e.get("prefix_ref"))
        for k, e in entries.items():
            if k in done or e.get("stage") != "pull":
                continue
            owner = e.get("pull_owner")
            deadline = e.get("pull_deadline") or 0.0
            if owner in live and now_mono <= deadline:
                continue
            # stalled pull: the owner died, drained, or is just slow —
            # stop waiting and dispatch as an ordinary prefill (the
            # late answer, if any, is swept as residue above)
            e["stage"] = "prefill"
            e["prefix_ref"] = None
            e["pull_deadline"] = None
            self._journal_pull(k, e)
            self._obs_pull_fallbacks.inc()
            progressed = True
            try:
                self.client.delete(f"{self.ns}/pullreq/{owner}/{k}")
            except ConnectionError:
                pass
            log.info("router: pull for %s from %s %s; falling back to "
                     "re-prefill", k, owner,
                     "timed out" if owner in live else "lost its owner")
            trace = e.get("trace")
            if trace is not None:
                obs.events.record("pull_fallback", trace=trace.trace_id,
                                  owner=owner)

        # 2) death detection + drain/redispatch
        verdict_lost: set[str] = set()
        if self._health is not None:
            try:
                self._health.update()
                rank_to_rid = {int(info.get("rank", -1)): rid
                               for rid, info in regs.items()}
                verdict_lost = {
                    rank_to_rid[int(r)]
                    for r in self._health.verdict().get("lost", [])
                    if int(r) in rank_to_rid}
            except (ConnectionError, ValueError):
                pass
        assigned_to = {e["assigned"] for e in entries.values()
                       if e["assigned"] is not None}
        # scan every rid with assigned work OR a registration: a
        # registered replica whose lease is gone is swept even when
        # idle, so a joiner that died at warmup doesn't pin its
        # registration (and rank/metrics slot) forever
        for rid in sorted((assigned_to | set(regs)) - self._dead):
            lost = rid in verdict_lost
            if rid in live and not lost:
                continue
            if now_mono < self._outage_grace_until \
                    and rid in self._ever_live:
                # post-brownout grace: leases lapsed server-side while
                # the STORE was down; give every ever-live replica one
                # grace window to re-beat before calling it dead — an
                # outage must not become a mass-death redispatch storm
                continue
            if not lost and rid not in self._ever_live:
                # registration→first-heartbeat grace: a slow-warming
                # joiner (torch import + weight build) registers long before
                # its first lease refresh lands.  Declaring it dead now
                # would permanently ban a healthy replica and
                # pointlessly drain its (empty) inbox — wait the grace
                # out first.  Members that HAVE held a lease get no
                # grace: their lapse is the real death signal.
                if now_mono - self._reg_seen.get(rid, now_mono) \
                        < self.join_grace_s:
                    continue
            # dead or drained: lease lapsed (SIGKILL, heartbeat drop,
            # clean drain exit) or publisher lost.  Drain its inbox,
            # redispatch its outstanding.
            self._dead.add(rid)
            live.discard(rid)
            if rid in draining:
                # graceful scale-down/pool-drain departure: expected,
                # not a failure — but the sweep + redispatch below
                # still runs, so even a drain that raced a final
                # dispatch loses nothing
                self._obs_drains.inc()
                log.info("router: replica %s drained and left the "
                         "fleet", rid)
            else:
                self._obs_deaths.inc()
                log.warning("router: replica %s presumed dead; "
                            "redispatching its outstanding requests", rid)
            self._sweep_dead(rid, regs)
            for k, e in entries.items():
                if k in done or e["assigned"] != rid:
                    continue
                e["assigned"] = None
                e["attempts"] += 1
                self._journal_assign(k, e)
                progressed = True
                self._obs_redispatched.inc()
                trace = e.get("trace")
                if trace is not None:
                    obs.events.record("redispatch", trace=trace.trace_id,
                                      from_replica=rid,
                                      attempts=e["attempts"])
                if e["attempts"] > self.max_redispatch:
                    req = e["req"]
                    self._journal_terminal(k, "failed", ())
                    complete(k, Completion(
                        rid=req.rid, prompt=np.asarray(req.prompt),
                        tokens=np.zeros((0,), np.int32),
                        reason="failed"))
                    self._decide("failed", e, attempts=e["attempts"])

        # 2.5) quarantine probe cycle: golden-query the quarantined
        # (still-live) replicas toward reinstatement or retirement.
        # After the death sweep on purpose — a quarantined replica that
        # DIED was just dropped and must not be probed.
        if self.quarantine is not None:
            self.quarantine.tick(live=live)
            quarantined = self.quarantine.quarantined()

        # 3) dispatch unassigned requests least-loaded
        now = self._clock()
        self._backoff = {r: t for r, t in self._backoff.items() if t > now}
        loads = self.loads(regs)
        self._update_backoffs(loads)
        unhealthy: set[str] = set()
        if self._health is not None:
            v = self._health.verdict()
            rank_to_rid = {int(info.get("rank", -1)): rid
                           for rid, info in regs.items()}
            for r in v.get("stale", []) + v.get("lost", []):
                rid = rank_to_rid.get(int(r))
                if rid is not None:
                    unhealthy.add(rid)
        candidates = [rid for rid in sorted(live)
                      if rid not in self._backoff
                      and rid not in unhealthy
                      # graceful drain: admissions steer away; in-flight
                      # work finishes before the replica stops
                      and rid not in draining
                      # integrity quarantine: alive and heartbeating,
                      # but under suspicion — probed, never dispatched
                      and rid not in quarantined
                      # blue-green: traffic is pinned to the active pool
                      and (pool is None or regs.get(rid, {})
                           .get("pool", "default") == pool)
                      # steer around a replica mid-hot-swap: it has
                      # paused admission to drain; feeding it would just
                      # park requests behind the rebind
                      and not loads.get(rid, {}).get("swapping")]
        # fleet-wide overload state: any candidate replica in degraded
        # mode puts the ROUTER in degraded mode too — new best-effort
        # dispatches get their budgets clamped at the wire.  A wired
        # alert plane contributes through the same switch: a firing
        # FleetDegraded rule (merged serve/degraded > 0 in the TSDB)
        # arms the clamp even when the advertising replica is not a
        # current candidate.
        degraded = (any(loads.get(rid, {}).get("degraded")
                        for rid in candidates)
                    or (self.alerts is not None
                        and self.alerts.is_firing("FleetDegraded")))
        self._obs_degraded.set(1.0 if degraded else 0.0)
        # two-stage scheduling: fresh (prefill-stage) requests go to
        # prefill/both replicas, handoff (decode-stage) requests to
        # decode/both — a homogeneous "both" fleet degenerates to one
        # shared pool and nothing below changes
        stage_cands = {
            "prefill": [rid for rid in candidates
                        if regs.get(rid, {}).get("role", "both")
                        in ("prefill", "both")],
            "decode": [rid for rid in candidates
                       if regs.get(rid, {}).get("role", "both")
                       in ("decode", "both")]}
        depth = {"prefill": 0, "decode": 0}
        for k2, e2 in entries.items():
            if k2 not in done and e2.get("arrived", True):
                s2 = e2.get("stage", "prefill")
                # a pulling request is still pre-prefill work
                depth["prefill" if s2 == "pull" else s2] += 1
        for stage, g in self._obs_stage_depth.items():
            g.set(depth[stage])
        if candidates:
            assigned_counts: dict[str, int] = {}
            for e in entries.values():
                if e["assigned"] is not None:
                    assigned_counts[e["assigned"]] = (
                        assigned_counts.get(e["assigned"], 0) + 1)
            wall = self._wall()
            # prefix residency summaries: one coord read per replica
            # per poll, shared by every dispatch decision below.  The
            # refresh covers ALL live replicas, not just candidates — a
            # draining or backed-off replica cannot take the request,
            # but its resident pages can still be PULLED from it.
            self.prefix_dir.refresh(sorted(live | set(candidates)))
            prefix_map = self.prefix_dir.affinity(candidates)
            # the SLO predictor: the best queue-wait any candidate
            # advertises at the configured percentile — if even that
            # replica would (probably) blow a request's deadline, no
            # assignment can save it
            best_wait = min(
                (loads.get(rid, {}).get("queue_wait_q") or 0.0
                 for rid in candidates), default=0.0)
            for k, e in entries.items():
                if (k in done or e["assigned"] is not None
                        or not e.get("arrived", True)):
                    continue
                req = e["req"]
                if req.deadline_s is not None and wall > req.deadline_s:
                    self._journal_terminal(k, "timeout", ())
                    complete(k, Completion(
                        rid=req.rid, prompt=np.asarray(req.prompt),
                        tokens=np.zeros((0,), np.int32), reason="timeout"))
                    self._decide("timeout", e, stage="router")
                    progressed = True
                    continue
                if (req.deadline_s is not None and e["attempts"] == 0
                        and e.get("stage", "prefill") == "prefill"
                        and wall + best_wait > req.deadline_s):
                    # SLO admission: shed BEFORE any replica pays a
                    # prefill.  Only ever on first dispatch — a request
                    # already prefilled once (redispatch, or a
                    # decode-stage handoff) is sunk cost and races the
                    # deadline instead.
                    self._obs_slo_shed.inc()
                    self._journal_terminal(k, "shed", ())
                    complete(k, Completion(
                        rid=req.rid, prompt=np.asarray(req.prompt),
                        tokens=np.zeros((0,), np.int32), reason="shed"))
                    self._decide("shed", e, predicted_wait_s=best_wait)
                    progressed = True
                    continue
                stage = e.get("stage", "prefill")
                if stage == "pull":
                    continue   # parked on the owner's export (step 1.5)
                owner, cov = (None, 0)
                if (stage == "prefill" and len(self.prefix_dir)
                        and not e.get("pull_tried")
                        and e.get("prefix_ref") is None):
                    owner, cov = self.prefix_dir.best_owner(
                        req.prompt, live=live)
                if (owner is not None and cov >= self.pull_min_blocks
                        and owner in stage_cands["prefill"]):
                    # the covering replica can take the request itself:
                    # content-based affinity placement beats any pull
                    # (the pages are already where the request lands)
                    rid = owner
                elif (owner is not None
                        and cov >= self.pull_min_blocks):
                    # covering replica NOT dispatchable (draining,
                    # wrong role, backed off, quarantined): park the
                    # request in the pull stage and ask the owner to
                    # export its pages — journal FIRST, so a crash
                    # mid-initiation recovers an ordinary prefill
                    e["pull_tried"] = True
                    e["stage"] = "pull"
                    e["pull_owner"] = owner
                    e["pull_deadline"] = (self._clock()
                                          + self.pull_timeout_s)
                    self._journal_pull(k, e)
                    self.client.set(
                        f"{self.ns}/pullreq/{owner}/{k}",
                        wire.encode_record("pullreq", {
                            "key": k,
                            "prompt": np.asarray(req.prompt)
                            .astype(int).tolist()}))
                    self._obs_prefix_pulls.inc()
                    progressed = True
                    trace = e.get("trace")
                    if trace is not None:
                        obs.events.record(
                            "pull_start", trace=trace.trace_id,
                            owner=owner, blocks=cov)
                    continue
                else:
                    rid = self._pick(
                        stage_cands[stage], loads, assigned_counts,
                        # prefix affinity only steers PREFILL
                        # placement: a decode-stage admission adopts
                        # migrated private pages and never reads the
                        # prefix cache
                        prefix_hash=(getattr(req, "prefix_hash", None)
                                     if stage == "prefill" else None),
                        prefix_map=prefix_map)
                if rid is None:
                    # this stage's pool is empty right now; the OTHER
                    # stage may still have capacity — keep scanning
                    continue
                trace = e.get("trace")
                send = req if trace is None else dataclasses.replace(
                    req, trace=trace)
                if (degraded and self.degrade_max_new is not None
                        and getattr(req, "priority", 0) <= 0
                        and req.max_new_tokens > self.degrade_max_new):
                    # degrade tier 1: clamp best-effort budgets at the
                    # wire while the fleet is overloaded — a short
                    # answer now beats a rejection later.  Higher
                    # priority classes keep full budgets.
                    send = dataclasses.replace(
                        send, max_new_tokens=self.degrade_max_new)
                    self._obs_degrade_clamped.inc()
                    if trace is not None:
                        obs.events.record(
                            "degrade_clamp", trace=trace.trace_id,
                            stage="router",
                            max_new=self.degrade_max_new)
                self.client.set(
                    f"{self.ns}/inbox/{rid}/{k}",
                    _encode_request(k, send,
                                    handoff_ref=e.get("handoff_ref"),
                                    prefix_ref=e.get("prefix_ref")))
                e["assigned"] = rid
                # inbox FIRST, then journal: a crash in between leaves
                # the record open-unassigned -> recovery redispatches
                # (a double-serve dedupes at done-key consumption)
                self._journal_assign(k, e)
                assigned_counts[rid] = assigned_counts.get(rid, 0) + 1
                progressed = True
                self._obs_dispatched.inc()
                if trace is not None:
                    obs.events.record("dispatch", trace=trace.trace_id,
                                      replica=rid,
                                      attempt=e["attempts"])

        # 4) hot/cold rebalancing (opt-in): after a sustained skew
        # streak, write a {ns}/migrate_req control key naming the hot
        # replica's oldest outstanding request — the replica exports it
        # as a reason="migrate" commit (consumed in step 1), and the
        # redispatch lands least-loaded.  A cooldown per request key
        # keeps one intent in flight; an intent for a request that
        # finishes first is ignored replica-side (terminal wins).
        now_reb = self._clock()
        self._migrating = {k2: t for k2, t in self._migrating.items()
                           if t > now_reb and k2 in entries}
        if self.rebalance_after_polls and len(candidates) >= 2:
            counts: dict[str, int] = {}
            for e2 in entries.values():
                if e2["assigned"] is not None:
                    counts[e2["assigned"]] = counts.get(
                        e2["assigned"], 0) + 1
            skew = self.rebalance_hot_cold(
                loads, candidates, counts,
                min_gap=self.rebalance_min_gap)
            if skew is None:
                self._skew_streak = None
            else:
                hot, cold = skew
                prev = self._skew_streak
                n = prev[1] + 1 if prev and prev[0] == hot else 1
                self._skew_streak = (hot, n)
                if n >= self.rebalance_after_polls:
                    victim = self.rebalance_victim(
                        entries, done, hot, self._migrating)
                    if victim is not None:
                        self.client.set(
                            f"{self.ns}/migrate_req/{hot}/{victim}",
                            b"1")
                        self._migrating[victim] = (
                            now_reb + self.rebalance_timeout_s)
                        self._obs_rebalances.inc()
                        self._skew_streak = None
                        log.info("router: sustained skew on %s; "
                                 "migrating %s toward %s", hot,
                                 victim, cold)
                        trace = entries[victim].get("trace")
                        if trace is not None:
                            obs.events.record(
                                "rebalance", trace=trace.trace_id,
                                from_replica=hot, to=cold)
        return progressed


    # -- blue-green structural rollout -------------------------------------

    def roll_structural(self, spawn, n: int, *, canary, expect_tokens,
                        green_pool: str = "green",
                        warmup_timeout_s: float = 180.0,
                        canary_timeout_s: float = 60.0,
                        drain_timeout_s: float = 60.0) -> dict:
        """Blue-green rollout for STRUCTURAL changes (tokenizer/config
        version bumps the in-place weight hot-swap cannot express).

        State machine::

            spawn green --> warm (n registered+heartbeating) --> canary
              (exact-check) --> COMMIT (shift {ns}/pool, drain blue)
            any warmup/canary failure --> ROLLBACK (stop green, blue
              keeps serving untouched)

        Args:
          spawn: zero-arg callable launching the green replicas (e.g. a
            :func:`scale_fleet` closure with the new model args and
            ``--pool green``) and returning their ``Popen``\\ s.
          n: green replicas to wait for before the canary runs.
          canary: the probe :class:`~tpudist_torch.models.serving.Request`.
          expect_tokens: the EXACT token sequence the green pool must
            produce for the canary (computed against a reference loop
            under the new config) — a warmed, heartbeating pool serving
            WRONG output is precisely the failure health checks miss.

        Returns a dict: ``ok``, ``stage`` (``done`` | the stage that
        failed), ``green``/``blue`` rid lists, ``procs`` (the green
        workers — the CALLER reaps them; on rollback they are already
        stopped), and ``blue_drained`` on commit.

        Composes with death detection: a BLUE replica dying mid-rollout
        is redispatched by the normal poll machinery (this method never
        touches blue until commit), and a GREEN death during
        warmup/canary triggers rollback, with blue traffic never
        shifted."""
        regs0 = self.replicas()
        blue = sorted(rid for rid, info in regs0.items()
                      if info.get("pool", "default") != green_pool)
        blue_pool = (regs0[blue[0]].get("pool", "default") if blue
                     else "default")
        procs = list(spawn())

        def rollback(stage: str, why: str) -> dict:
            self._obs_rollbacks.inc()
            log.warning("roll_structural: %s failed (%s); rolling back "
                        "to pool %r", stage, why, blue_pool)
            regs = self.replicas()
            green_now = sorted(rid for rid, info in regs.items()
                               if info.get("pool", "default") == green_pool)
            for rid in green_now:
                try:
                    self.client.set(f"{self.ns}/stop/{rid}", b"1")
                except ConnectionError:
                    pass
            for p in procs:
                try:
                    p.wait(timeout=15.0)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            for rid in green_now:
                self._sweep_dead(rid, regs)
                try:
                    self.client.delete(f"{self.ns}/stop/{rid}")
                except ConnectionError:
                    pass
            return {"ok": False, "stage": stage, "reason": why,
                    "green": green_now, "blue": blue, "procs": procs}

        # -- warm: n green replicas registered AND heartbeating
        deadline = time.monotonic() + warmup_timeout_s
        green: list[str] = []
        while True:
            live = self.live()
            green = sorted(rid for rid, info in self.replicas().items()
                           if info.get("pool", "default") == green_pool
                           and rid in live)
            if len(green) >= n:
                break
            exited = [(p.pid, p.returncode) for p in procs
                      if p.poll() is not None]
            if exited:
                return rollback("warmup",
                                f"green worker(s) died: {exited}")
            if time.monotonic() > deadline:
                return rollback("warmup", f"only {len(green)} of {n} "
                                f"green replicas live after "
                                f"{warmup_timeout_s:.0f}s")
            time.sleep(0.1)

        # -- canary: one probe request, exact-checked.  The key's
        # "canary" prefix keeps it out of the request sequence space
        # (and is what the CANARY_CORRUPT injection targets).
        key = f"canary-{self._seq:08d}"
        self._seq += 1
        target = green[0]
        self.client.set(f"{self.ns}/inbox/{target}/{key}",
                        _encode_request(key, canary))
        deadline = time.monotonic() + canary_timeout_s
        tokens = None
        while time.monotonic() < deadline:
            try:
                raw = self.client.get(f"{self.ns}/done/{key}")
            except ConnectionError:
                raw = None
            if raw is not None:
                self.client.delete(f"{self.ns}/done/{key}")
                try:
                    doc = wire.decode_record(
                        raw, expect="completion", namespace=self.ns,
                        key=key, replica=target)
                except wire.WireError as err:
                    return rollback(
                        "canary",
                        f"undecodable canary answer ({err.reason})")
                tokens = np.asarray(doc.get("tokens", ()), np.int32)
                break
            if any(p.poll() is not None for p in procs):
                return rollback("canary", "green worker died mid-canary")
            time.sleep(0.05)
        if tokens is None:
            return rollback("canary", "canary timed out")
        expect = np.asarray(expect_tokens, np.int32)
        if not np.array_equal(tokens, expect):
            return rollback(
                "canary", f"output mismatch (got {tokens.tolist()}, "
                f"expected {expect.tolist()})")

        # -- commit: shift traffic, then drain blue gracefully (steer
        # admissions away, let in-flight finish, stop, wait out the
        # lease) — zero requests lost on either side of the cut
        self.client.set(f"{self.ns}/pool", green_pool.encode())
        self._obs_rolls.inc()
        log.info("roll_structural: canary exact-matched; pool shifted "
                 "to %r, draining blue %s", green_pool, blue)
        blue_drained = drain_replicas(self.client, blue,
                                      namespace=self.ns,
                                      timeout_s=drain_timeout_s)
        return {"ok": True, "stage": "done", "green": green,
                "blue": blue, "procs": procs,
                "blue_drained": blue_drained}


# -- fleet process helpers (tests, bench, example, CI) ---------------------

def build_tiny_lm(vocab: int = 64, layers: int = 2, heads: int = 4,
                  kv_heads: int = 2, embed: int = 64, seq_len: int = 96,
                  seed: int = 0):
    """The fleet's shared tiny model: every replica (and the reference
    single loop) builds IDENTICAL weights from the same seed, which is
    what makes redispatched greedy output exact-match verifiable.  The
    weights are drawn on the CPU from a ``torch.Generator`` seeded with
    ``seed`` (the same bits in every process, whatever its device) and
    returned as a state_dict of CPU tensors (f32)."""
    import torch

    from tpudist_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM)

    cfg = TransformerConfig(vocab_size=vocab, num_layers=layers,
                            num_heads=heads, num_kv_heads=kv_heads,
                            embed_dim=embed, max_seq_len=seq_len)
    gen = torch.Generator().manual_seed(int(seed))
    model = TransformerLM(cfg, device="cpu").init_weights(gen)
    return cfg, model.state_dict()


def request_drain(client: CoordClient, rids: Sequence[str], *,
                  namespace: str = DEFAULT_NAMESPACE) -> None:
    """Mark replicas for graceful drain (``{ns}/draining/{rid}``): the
    router steers new admissions away immediately; the replicas keep
    working their queues.  Follow with :func:`drain_replicas` (or the
    autoscaler's poll loop) to stop them once empty."""
    for rid in rids:
        client.set(f"{namespace}/draining/{rid}", b"1")


def drain_replicas(client: CoordClient, rids: Sequence[str], *,
                   namespace: str = DEFAULT_NAMESPACE,
                   timeout_s: float = 60.0,
                   poll_s: float = 0.1) -> bool:
    """Gracefully drain replicas to a stop, never losing a request:
    mark them draining (router admissions steer away), wait for each
    inbox to empty (everything dispatched has been picked up), set the
    targeted stop key (the worker's close path finishes its queued and
    in-flight work, commits every completion, then exits cleanly), and
    wait the heartbeat lease out.  Returns True when every replica is
    gone within ``timeout_s`` (residual coordination keys are cleaned
    up), False on timeout (drain keys left in place — the replicas are
    still steered away from, just not yet stopped)."""
    request_drain(client, rids, namespace=namespace)
    regs: dict[str, dict] = {}
    prefix = f"{namespace}/replica/"
    for rid in rids:
        raw = client.get(f"{prefix}{rid}")
        if raw is not None:
            regs[rid] = json.loads(raw.decode())
    mark = f"{namespace}:"
    deadline = time.monotonic() + timeout_s
    stopped: set[str] = set()
    while True:
        live = {n[len(mark):] for n in client.live()
                if n.startswith(mark)}
        remaining = [rid for rid in rids
                     if rid in live or rid not in stopped]
        for rid in remaining:
            if rid not in live:
                stopped.add(rid)   # already gone (death beat the drain)
            elif (rid not in stopped
                    and not client.keys(f"{namespace}/inbox/{rid}/")):
                client.set(f"{namespace}/stop/{rid}", b"1")
                stopped.add(rid)
        if not [rid for rid in rids
                if rid in live or rid not in stopped]:
            for rid in rids:   # residue: this drain owns the cleanup
                for key in (f"{namespace}/draining/{rid}",
                            f"{namespace}/stop/{rid}",
                            f"{namespace}/replica/{rid}",
                            f"{namespace}/metrics/"
                            f"{regs.get(rid, {}).get('rank')}"):
                    try:
                        client.delete(key)
                    except ConnectionError:
                        pass
            return True
        if time.monotonic() > deadline:
            return False
        time.sleep(poll_s)


def alloc_replica_indices(client: CoordClient, n: int, *,
                          namespace: str = DEFAULT_NAMESPACE) -> list[int]:
    """Reserve ``n`` fresh replica indices from the fleet's add-chain
    (``{ns}/replica_index``).  The coord ``add`` is atomic, so an
    operator-initiated and an autoscaler-initiated scale-up racing each
    other get DISJOINT index ranges — two replicas can never collide on
    a registration key, rank, or metrics slot."""
    end = int(client.add(f"{namespace}/replica_index", int(n)))
    return list(range(end - int(n), end))


def _seed_replica_index(client: CoordClient, upto: int, *,
                        namespace: str = DEFAULT_NAMESPACE) -> None:
    """Advance the index chain to at least ``upto`` (covers indices an
    explicit ``start_index`` caller placed outside the chain)."""
    cur = int(client.add(f"{namespace}/replica_index", 0))
    if cur < upto:
        client.add(f"{namespace}/replica_index", upto - cur)


def _spawn_replica(coord_addr: str, index: int, *,
                   namespace: str,
                   replica_args: Sequence[str] = (),
                   env_extra: dict | None = None,
                   device: str = "cuda") -> subprocess.Popen:
    """One replica worker subprocess (``replica-id r{index}``, rank
    ``index``, serving on ``device``) — the shared spawn body of
    :func:`launch_local_fleet` and :func:`scale_fleet`."""
    host, port = coord_addr.rsplit(":", 1)
    pkg_root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                      else []))
    env.update({k: str(v) for k, v in (env_extra or {}).items()})
    return subprocess.Popen(
        [sys.executable, "-m", "tpudist_torch.runtime.router",
         "--coord", f"{host}:{port}", "--replica-id", f"r{index}",
         "--rank", str(index), "--namespace", namespace,
         "--device", str(device), *replica_args],
        env=env)


def launch_local_fleet(coord_addr: str, n: int, *,
                       namespace: str = DEFAULT_NAMESPACE,
                       replica_args: Sequence[str] = (),
                       env_overrides: dict[int, dict] | None = None,
                       device: str = "cuda") -> list[subprocess.Popen]:
    """Spawn ``n`` replica worker subprocesses on this host (tests,
    bench, CI, the example).  ``env_overrides[i]`` adds env vars to
    replica ``i`` — the fault-injection knobs go in this way, so a kill
    schedule hits exactly the replica the scenario names.  Also seeds
    the fleet's replica-index add-chain past ``n`` so later
    :func:`scale_fleet` calls allocate collision-free indices."""
    try:
        host, port = coord_addr.rsplit(":", 1)
        _seed_replica_index(CoordClient(host, int(port)), n,
                            namespace=namespace)
    except (ConnectionError, OSError):
        pass   # chain seeds lazily on the first scale-up instead
    return [_spawn_replica(coord_addr, i, namespace=namespace,
                           replica_args=replica_args,
                           env_extra=(env_overrides or {}).get(i),
                           device=device)
            for i in range(n)]


def scale_fleet(coord_addr: str, n: int, *,
                start_index: int | None = None,
                namespace: str = DEFAULT_NAMESPACE,
                replica_args: Sequence[str] = (),
                env_overrides: dict[int, dict] | None = None,
                env_extra: dict | None = None,
                device: str = "cuda") -> list[subprocess.Popen]:
    """Scale a RUNNING fleet up by ``n`` joiner replicas.  Joiners
    register against the live coordination planes and the router admits
    them on its next poll; pass the same ``--snapshot-dir`` the fleet
    was launched with so a joiner restores the CURRENT weights (keeping
    greedy output exact-match with the incumbents).

    Indices (ids ``r{i}``, ranks to match — ranks key the metrics
    namespace, so they must never collide with existing members, dead
    ones included) are allocated from the fleet's atomic add-chain by
    default (:func:`alloc_replica_indices`), so two scale-ups racing
    each other — an operator and the autoscaler, say — get disjoint
    ranges.  An explicit ``start_index`` keeps the legacy caller-picked
    layout and advances the chain past it.

    ``env_overrides`` is keyed by absolute index (explicit
    ``start_index`` callers); ``env_extra`` applies to every joiner
    (chain-allocated callers don't know indices up front).  Each
    returned ``Popen`` carries its ``replica_index`` attribute."""
    host, port = coord_addr.rsplit(":", 1)
    if start_index is None:
        indices = alloc_replica_indices(CoordClient(host, int(port)), n,
                                        namespace=namespace)
    else:
        indices = list(range(start_index, start_index + n))
        try:
            _seed_replica_index(CoordClient(host, int(port)),
                                start_index + n, namespace=namespace)
        except (ConnectionError, OSError):
            pass
    procs = []
    for i in indices:
        extra = dict(env_extra or {})
        extra.update((env_overrides or {}).get(i) or {})
        p = _spawn_replica(coord_addr, i, namespace=namespace,
                           replica_args=replica_args,
                           env_extra=extra, device=device)
        p.replica_index = i
        procs.append(p)
    return procs


def stop_fleet(client: CoordClient, procs: Sequence[subprocess.Popen], *,
               namespace: str = DEFAULT_NAMESPACE,
               timeout_s: float = 30.0) -> list[int]:
    """Set the fleet-wide stop key, reap every worker, and return their
    exit codes (in ``procs`` order).  Unexpected terminations are
    SURFACED, not raised: a fault scenario's SIGKILLed replica is a
    legitimate nonzero exit the caller asserts on, so this logs a
    warning per casualty and leaves the verdict to the caller."""
    try:
        client.set(f"{namespace}/stop", b"1")
    except ConnectionError:
        pass
    deadline = time.monotonic() + timeout_s
    codes: list[int] = []
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            log.warning("stop_fleet: pid %d ignored the stop key for "
                        "%.0fs; killing it", p.pid, timeout_s)
            p.kill()
            p.wait()
        codes.append(p.returncode)
        if p.returncode != 0:
            log.warning("stop_fleet: pid %d exited with %d "
                        "(negative = killed by that signal)",
                        p.pid, p.returncode)
    return codes


def wait_live(client: CoordClient, n: int, *,
              namespace: str = DEFAULT_NAMESPACE,
              timeout_s: float = 60.0,
              procs: Sequence[subprocess.Popen] | None = None) -> set[str]:
    """Block until ``n`` replicas hold heartbeat leases (fleet warm-up:
    replica startup is torch import + weight build (+ kernel load on the
    card), and routing before
    the fleet assembles concentrates all early requests on whichever
    replica won the race).  Returns the live replica-id set.

    Pass ``procs`` to FAIL FAST: a worker that exits before the fleet
    assembles (bad args, import error) raises ``RuntimeError`` with its
    exit code immediately instead of burning the whole timeout.  Either
    way, the timeout diagnostic lists replicas that REGISTERED but hold
    no lease — the registered-then-died shape that otherwise reads as
    a silent hang."""
    mark = f"{namespace}:"
    deadline = time.monotonic() + timeout_s

    def registered_not_live(live: set[str]) -> list[str]:
        try:
            prefix = f"{namespace}/replica/"
            regs = {k[len(prefix):] for k in client.keys(prefix)}
        except ConnectionError:
            return []
        return sorted(regs - live)

    while True:
        live = {name[len(mark):] for name in client.live()
                if name.startswith(mark)}
        if len(live) >= n:
            return live
        if procs is not None:
            exited = [(p.pid, p.returncode) for p in procs
                      if p.poll() is not None]
            # a proc that exited may legitimately belong to an earlier,
            # already-finished scenario only if the caller passed it;
            # here any exit before assembly is fatal to the wait
            if exited:
                raise RuntimeError(
                    f"fleet: worker(s) died before {n} replicas went "
                    f"live: {[f'pid {pid} -> exit {rc}' for pid, rc in exited]} "
                    f"(live: {sorted(live)}, registered-but-dead: "
                    f"{registered_not_live(live)})")
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"fleet: only {sorted(live)} of {n} replicas live "
                f"after {timeout_s:.0f}s (registered-but-dead: "
                f"{registered_not_live(live)})")
        time.sleep(0.1)


def roll_weights(client: CoordClient, snapshot_dir: str | os.PathLike,
                 params, *, version: int,
                 namespace: str = DEFAULT_NAMESPACE,
                 meta: dict | None = None) -> None:
    """Publish a new weight version to a running fleet: persist
    ``params`` to the shared snapshot dir (synchronously — DURABILITY
    FIRST: no replica may learn of a version whose bytes are not yet
    committed on disk), then bump ``{ns}/weights/version``, which every
    replica's source poll watches.  The fleet then rolls one replica at
    a time (the ticket chain in the module docstring); follow with
    :func:`wait_swapped` to block until the roll completes."""
    from tpudist_torch.elastic.checkpoint import Checkpointer

    m = {"version": int(version)}
    if meta:
        m.update(meta)
    Checkpointer(snapshot_dir, layout="steps").save(
        int(version), params, meta=m)
    client.set(f"{namespace}/weights/version",
               str(int(version)).encode())


def wait_swapped(client: CoordClient, n: int, version: int, *,
                 namespace: str = DEFAULT_NAMESPACE,
                 timeout_s: float = 60.0) -> set[int]:
    """Block until ``n`` replicas publish ``serve/weights_version >=
    version`` (the gauge each one bumps when its drain-gated rebind
    lands).  Returns the swapped RANK set."""
    deadline = time.monotonic() + timeout_s
    while True:
        swapped: set[int] = set()
        try:
            snaps = collect(client, f"{namespace}/metrics")
        except ConnectionError:
            snaps = {}
        for rank, snap in snaps.items():
            v = (snap.get("gauges", {}).get("serve/weights_version")
                 or {}).get("value")
            if v is not None and v >= version:
                swapped.add(rank)
        if len(swapped) >= n:
            return swapped
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"fleet: only ranks {sorted(swapped)} of {n} replicas "
                f"reached weights version {version} after "
                f"{timeout_s:.0f}s")
        time.sleep(0.1)


def exit_reports(client: CoordClient, *,
                 namespace: str = DEFAULT_NAMESPACE) -> dict[str, dict]:
    """Clean-exit reports by replica id (a SIGKILLed replica leaves
    none — that absence is itself the assertion)."""
    out = {}
    prefix = f"{namespace}/exit/"
    for key in client.keys(prefix):
        raw = client.get(key)
        if raw is None:
            continue
        try:
            out[key[len(prefix):]] = wire.decode_record(
                raw, expect="heartbeat", namespace=namespace,
                key=key[len(prefix):])
        except wire.WireError as e:
            log.warning("exit_reports: undecodable report %s (%s)",
                        key, e.reason)
    return out


# -- replica / router CLI --------------------------------------------------

def _run_route_mode(args) -> None:  # pragma: no cover - subprocess entry
    """``--route``: drive a Router over an existing fleet from a
    requests file, streaming one JSONL result line per completion
    (append + flush, so a SIGKILLed router's partial output survives).
    ``--recover`` rebuilds from the journal instead of submitting: the
    results file read-back tells the recovered router which terminals
    the crashed one already delivered — the failover path of the
    module docstring, end to end."""
    from tpudist_torch.models.serving import Request

    host, port = args.coord.rsplit(":", 1)
    client = CoordClient(host, int(port))
    router = Router(client, namespace=args.namespace,
                    poll_s=args.poll_s,
                    lost_after_s=args.lost_after)
    results = Path(args.results)

    def deliver(key: str, comp) -> None:
        with results.open("a") as fh:
            fh.write(json.dumps({
                "rid": str(comp.rid),
                "tokens": np.asarray(comp.tokens).astype(int).tolist(),
                "reason": comp.reason}) + "\n")
            fh.flush()
            os.fsync(fh.fileno())

    if args.recover:
        delivered = []
        if results.exists():
            for line in results.read_text().splitlines():
                if line.strip():
                    delivered.append(str(json.loads(line)["rid"]))
        comps = router.recover(timeout_s=args.timeout,
                               delivered=delivered,
                               on_complete=deliver)
    else:
        docs = json.loads(Path(args.requests).read_text())
        reqs = [Request(prompt=np.asarray(d["prompt"], np.int32),
                        max_new_tokens=int(d["max_new_tokens"]),
                        rid=str(d["rid"]),
                        deadline_s=d.get("deadline_s"),
                        priority=int(d.get("priority", 0)))
                for d in docs]
        comps = router.run(reqs, timeout_s=args.timeout,
                           on_complete=deliver)
    log.info("router: %s finished %d completions",
             "recovery" if args.recover else "route", len(comps))


def main() -> None:  # pragma: no cover - subprocess entry point
    """Run one serve replica: ``python -m tpudist_torch.runtime.router --coord
    HOST:PORT --replica-id r0 --rank 0 [model/serve args]`` — or, with
    ``--route``, the ROUTER side from a requests file (``--recover``
    resumes a crashed router from its journal).

    Builds the deterministic tiny LM (same ``--seed`` across the fleet
    => identical weights => redispatch exact-match) on ``--device``
    (default ``cuda``; raises without a CUDA device, never falls back to
    the CPU) and serves until a stop key appears.  The fault-injection
    env (``TPUDIST_FAULT_*``) is read by the hooks already threaded
    through CoordClient/ServeLoop — nothing to wire here."""
    import argparse

    ap = argparse.ArgumentParser(
        description="tpudist_torch serve replica / router")
    ap.add_argument("--coord", required=True, help="coord server host:port")
    ap.add_argument("--route", action="store_true",
                    help="run the ROUTER side instead of a replica")
    ap.add_argument("--recover", action="store_true",
                    help="with --route: rebuild from {ns}/journal/* "
                         "instead of submitting --requests")
    ap.add_argument("--requests", default="",
                    help="route mode: JSON file of request docs "
                         "(rid, prompt, max_new_tokens, ...)")
    ap.add_argument("--results", default="",
                    help="route mode: JSONL file results append to")
    ap.add_argument("--poll-s", type=float, default=0.02)
    ap.add_argument("--lost-after", type=float, default=5.0)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--replica-id", default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--namespace", default=DEFAULT_NAMESPACE)
    ap.add_argument("--ttl", type=float, default=2.0)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--embed", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the replica serves (default cuda; "
                         "raises without a CUDA device)")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--steps-per-sync", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--stop-tokens", default="",
                    help="comma-separated stop token ids")
    ap.add_argument("--cache-layout", default="dense",
                    choices=["dense", "paged"])
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-num-blocks", type=int, default=0,
                    help="0 = dense-capacity default")
    ap.add_argument("--max-queue", type=int, default=-1,
                    help="-1 = unbounded")
    ap.add_argument("--degrade-queue", type=int, default=-1,
                    help="soft overload watermark (-1 = max-queue/2 "
                         "when max-queue is set)")
    ap.add_argument("--degrade-max-new", type=int, default=32,
                    help="degraded-mode max_new_tokens clamp for "
                         "priority-0 traffic")
    ap.add_argument("--pool", default="default",
                    help="blue-green pool tag; the router only "
                         "dispatches to the active pool")
    ap.add_argument("--role", default="both",
                    choices=["both", "prefill", "decode"],
                    help="disaggregated serving role: 'prefill' runs "
                         "chunked prefill to completion and hands the "
                         "KV off; 'decode' adopts migrated KV and "
                         "decodes; 'both' (default) is a unified "
                         "replica (requires --cache-layout paged for "
                         "prefill/decode)")
    ap.add_argument("--preempt", default="degrade",
                    choices=["degrade", "migrate"],
                    help="overload policy: 'degrade' clamps best-effort "
                         "budgets; 'migrate' pauses the lowest-priority "
                         "in-flight decode via KV-page export instead "
                         "(requires --cache-layout paged) and enables "
                         "fast drain + rebalance intents")
    ap.add_argument("--snapshot-dir", default="",
                    help="fleet weight snapshot dir (Checkpointer, "
                         "layout=steps): restored at startup (joiners "
                         "pick up the fleet's current weights) and on "
                         "every weights/version bump (rolling hot-swap)")
    ap.add_argument("--swap-turn-timeout", type=float, default=10.0,
                    help="seconds to wait on earlier swap tickets "
                         "before proceeding anyway (dead-holder "
                         "liveness fallback)")
    args = ap.parse_args()

    if args.route or args.recover:
        if not args.results:
            ap.error("--route/--recover require --results")
        if not args.recover and not args.requests:
            ap.error("--route requires --requests")
        _run_route_mode(args)
        return
    if args.replica_id is None or args.rank is None:
        ap.error("replica mode requires --replica-id and --rank")

    from tpudist_torch.models.serving import ServeLoop

    cfg, params = build_tiny_lm(args.vocab, args.layers, args.heads,
                                args.kv_heads, args.embed, args.seq_len,
                                args.seed)
    stop = ([int(t) for t in args.stop_tokens.split(",") if t.strip()]
            or None)
    loop = ServeLoop(
        cfg, params, num_slots=args.slots,
        steps_per_sync=args.steps_per_sync,
        prefill_chunk=args.prefill_chunk, stop_tokens=stop,
        cache_layout=args.cache_layout,
        kv_block_size=args.kv_block_size,
        kv_num_blocks=args.kv_num_blocks or None,
        max_queue=None if args.max_queue < 0 else args.max_queue,
        degrade_queue=None if args.degrade_queue < 0
        else args.degrade_queue,
        degrade_max_new=args.degrade_max_new,
        role=args.role, preempt=args.preempt, device=args.device)
    host, port = args.coord.rsplit(":", 1)
    client = CoordClient(host, int(port))
    worker = ReplicaWorker(loop, client, args.replica_id,
                           rank=args.rank, namespace=args.namespace,
                           ttl_s=args.ttl,
                           snapshot_dir=args.snapshot_dir or None,
                           swap_turn_timeout_s=args.swap_turn_timeout,
                           pool=args.pool)
    log.info("replica %s (rank %d) serving on %s", args.replica_id,
             args.rank, args.namespace)
    worker.serve()


if __name__ == "__main__":  # pragma: no cover
    main()
