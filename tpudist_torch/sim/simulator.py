"""The offline fleet simulator: real control-plane code, virtual time
(counterpart of :mod:`tpudist.sim.simulator`).

The point is NOT a queueing model of the fleet — it is the fleet's
actual decision code on a synthetic data plane.  :class:`FleetSim` runs
the real :class:`tpudist_torch.runtime.router.Router` event loop and the real
:class:`tpudist_torch.runtime.autoscaler.Autoscaler` policy, unmodified,
against:

* a :class:`VirtualClock` injected as the router's ``clock``/``wall``/
  ``sleeper`` and the autoscaler's ``clock`` — every sleep ADVANCES
  simulated time instead of burning wall time, so a 90-second diurnal
  scenario replays in well under a second;
* a :class:`~tpudist_torch.sim.fabric.SimFabric` in place of the coord TCP
  service — same key layout, same wire encodings;
* :class:`SimReplica` data planes in place of real ``ServeLoop``
  processes: each consumes its inbox through the REAL request decoder,
  serves FIFO at a configured seconds-per-token rate (recorded
  ``serve/seconds_per_token`` EMAs when replaying a trace), commits
  completions through the real done-key protocol, and publishes
  ``MetricsPublisher``-shaped snapshots — windowed queue-wait
  histograms included — so the router's SLO admission and the
  autoscaler's target tracking read exactly the signals they read in
  production.

Because the policy code is shared, a simulated run emits the same
decision counters, the same autoscaler ``decision_log``, and a summary
row in the same bench-JSONL schema as a live run — which is what makes
scenario envelopes (:class:`tpudist_torch.sim.scenario.Envelope`) meaningful
as CI gates, and what the sim-vs-live agreement check in ``bench.py``
leans on.
"""

from __future__ import annotations

import time

import numpy as np

from tpudist_torch import obs
from tpudist_torch.models.kv_pages import chain_hashes
from tpudist_torch.obs.alerts import AlertManager, default_rules
from tpudist_torch.obs.registry import values_to_hist
from tpudist_torch.obs.tsdb import TSDB, FleetScraper
from tpudist_torch.runtime import faults, wire
from tpudist_torch.runtime.autoscaler import AutoscaleConfig, Autoscaler
from tpudist_torch.runtime.router import (
    GoldenProbe,
    QuarantineConfig,
    Router,
    _decode_request,
)
from tpudist_torch.sim.fabric import SimFabric
from tpudist_torch.sim.scenario import Envelope, ScenarioSpec
from tpudist_torch.sim.workload import (
    Workload,
    service_rates_from_trace,
    synthesize,
    workload_from_trace,
)

__all__ = ["VirtualClock", "SimReplica", "FleetSim"]

# simulated epoch: virtual wall time starts here (any fixed base works —
# deadlines are relative arithmetic — but a realistic epoch keeps
# recorded docs plausible to tooling that renders wall stamps)
_WALL_BASE = 1_750_000_000.0


class VirtualClock:
    """Simulated time: a monotonic origin at 0 and a wall clock at a
    fixed epoch, both advanced EXPLICITLY by the simulation loop.
    Injected wherever production code takes ``clock=``/``wall=``."""

    def __init__(self, wall_base: float = _WALL_BASE) -> None:
        self._now = 0.0
        self._wall_base = float(wall_base)

    def monotonic(self) -> float:
        return self._now

    def wall(self) -> float:
        return self._wall_base + self._now

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"time only moves forward, got dt={dt}")
        self._now += dt


class SimReplica:
    """One simulated serve replica: the data-plane contract of a
    ``ReplicaWorker`` (inbox -> FIFO service -> done key; registration,
    lease, metrics snapshots; graceful-drain close path) at a scalar
    service rate instead of a model.

    Doubles as its own "process" for the autoscaler's spawner contract:
    ``poll()`` is ``None`` while running, ``0`` after departure, and
    ``replica_index`` matches the ``r{rank}`` id the pending-joiner
    check looks for."""

    def __init__(self, fabric: SimFabric, clock: VirtualClock, *,
                 rank: int, namespace: str,
                 role: str = "both",
                 seconds_per_token: float = 0.002,
                 prefill_s: float = 0.005,
                 prefill_per_token_s: float = 0.0002,
                 warmup_s: float = 0.0,
                 publish_interval_s: float = 0.25,
                 wait_window_s: float = 15.0,
                 kv_blocks_total: int = 0,
                 prefix_cache_blocks: int = 0,
                 tier_blocks: int = 0,
                 preempt: str = "degrade") -> None:
        self.fabric = fabric
        self.clock = clock
        self.rank = int(rank)
        self.replica_index = int(rank)   # the spawner/joiner contract
        self.rid = f"r{rank}"
        self.ns = namespace
        # the disaggregated stage split: a "prefill" replica
        # serves only the prompt pass and commits reason="handoff"; a
        # "decode" replica serves a handed-off request at decode cost
        # only (the pages arrived with it); "both" is the unified shape
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be both/prefill/decode, "
                             f"got {role!r}")
        self.role = role
        self.spt = float(seconds_per_token)
        self.prefill_s = float(prefill_s)
        self.prefill_per_token_s = float(prefill_per_token_s)
        self.publish_interval_s = float(publish_interval_s)
        self.wait_window_s = float(wait_window_s)
        # synthetic KV occupancy (decode-pool autoscale signal): each
        # resident request pins ceil((prompt + budget) / 16) of these
        self.kv_blocks_total = int(kv_blocks_total)
        # priority preemption: "migrate" makes this replica
        # the flow-model mirror of ``ServeLoop(preempt="migrate")`` — a
        # strictly-higher-priority arrival PAUSES the running request
        # (its remaining service time parks in ``_paused`` and it
        # re-queues at the FRONT, the sim analogue of export -> host
        # tier -> re-adopt) and admission picks priority-first.  The
        # default keeps every pre-migration scenario byte-stable.
        if preempt not in ("degrade", "migrate"):
            raise ValueError(f"preempt must be degrade/migrate, "
                             f"got {preempt!r}")
        self.preempt = preempt
        self.preempted = 0
        self.resumed = 0
        self._paused: dict[str, float] = {}   # rid -> remaining service s
        self.all_waits_priority: list[float] = []
        self._obs_preempted = obs.counter("serve/preempted", unit="reqs")
        self._obs_resumed = obs.counter("serve/resumed", unit="reqs")
        self.alive = True
        self.killed = False
        self.served = 0
        self.all_waits: list[float] = []          # every queue wait (sim s)
        self.all_ttfts: list[float] = []          # first-token latencies
        self._live = False
        self._live_at = clock.monotonic() + max(0.0, float(warmup_s))
        self._stopping = False
        self._queue: list[tuple] = []             # (req, enqueued_at)
        self._cur: tuple | None = None            # (req, finish_at)
        self._waits: list[tuple[float, float]] = []   # (t, wait) window
        self._next_pub = self._live_at
        # coord brownout: commits that can't reach the fabric park here
        # and flush on the next step after the window — the SimReplica
        # mirror of ReplicaWorker's bounded done buffer
        self._done_buf: list[tuple[str, bytes]] = []
        self._hb_resume_at: float | None = None
        # corrupt_replica chaos: every Nth framed commit gets a byte
        # flipped (None = healthy); _corrupt_left caps the episode so
        # the replica can heal and earn reinstatement
        self._corrupt_every: int | None = None
        self._corrupt_left: int | None = None
        self._commits = 0
        # prefix-affinity accounting: recently admitted prefix hashes
        # (the SimReplica mirror of ServeLoop._affinity_recent) — a
        # request whose stamped hash is already here would have hit the
        # replica's prefix cache.  Published at {ns}/prefix/{rid} so the
        # ROUTER's affinity steer runs the same code path offline.
        self._affinity: dict[int, None] = {}
        self._prefix_pub: tuple | None = None
        self._prefix_refresh_at = 0.0
        self.prefix_requests = 0
        self.prefix_hits = 0
        # tiered-KV cost model: a bounded "HBM" set of
        # resident prefix-chain block hashes (the rolling chain at the
        # sim's fixed block size 16) plus a bounded host-tier set that
        # catches LRU spills — the SimReplica mirror of BlockPool's
        # prefix cache over HostTier.  Coverage of an admitted prompt's
        # leading blocks skips that span's prefill cost, which is what
        # makes local/tier/pull hit rates and the TTFT win measurable
        # offline.  0 capacity disables the model (and the chains half
        # of the prefix publish), keeping pre-tier scenarios byte-stable.
        self.prefix_cache_blocks = int(prefix_cache_blocks)
        self.tier_blocks = int(tier_blocks)
        self._hbm_chains: dict[int, None] = {}   # LRU, insertion order
        self._tier_chains: dict[int, None] = {}  # LRU, insertion order
        self.chain_blocks_total = 0
        self.chain_blocks_local = 0
        self.chain_blocks_tier = 0
        self.chain_blocks_pull = 0
        self.tier_spills = 0
        self.pull_exports = 0
        # registration precedes the first heartbeat, exactly like a real
        # joiner mid-warmup (the router's join grace covers this window)
        import json
        fabric.set(f"{namespace}/replica/{self.rid}",
                   json.dumps({"replica_id": self.rid,
                               "rank": self.rank,
                               "role": self.role}).encode())

    # -- the spawner/process contract --------------------------------------

    def poll(self):
        return None if self.alive else 0

    # -- chaos (the FaultScript verbs) -------------------------------------

    def kill(self) -> None:
        """SIGKILL equivalent: the lease lapses (server-side TTL), the
        consumed-but-unserved queue vanishes, the registration stays as
        residue — the router's death path sweeps and redispatches."""
        self.alive = False
        self.killed = True
        self._queue.clear()
        self._cur = None
        self._done_buf.clear()
        self.fabric.down(f"{self.ns}:{self.rid}")

    def drop_heartbeats(self, for_s: float) -> None:
        """HEARTBEAT_STOP equivalent: the lease lapses but the replica
        keeps serving — the false-positive-death shape whose duplicate
        done writes the router's consumption dedupes.  The lease
        returns after ``for_s`` virtual seconds."""
        self.fabric.down(f"{self.ns}:{self.rid}")
        self._hb_resume_at = self.clock.monotonic() + float(for_s)

    def corrupt(self, *, every: int = 1, count: int | None = None) -> None:
        """FLIP_WIRE_BITS equivalent: from now on, every ``every``-th
        committed payload has one byte flipped AFTER framing — silent
        corruption the router's wire checksum must catch.  ``count``
        caps the episode (the replica heals), which is what lets the
        quarantine's golden probes eventually pass."""
        self._corrupt_every = max(1, int(every))
        self._corrupt_left = None if count is None else int(count)

    # -- service model -----------------------------------------------------

    def _prefill_s_of(self, req, covered_tokens: int = 0) -> float:
        prompt = int(np.asarray(req.prompt).size)
        billable = max(0, prompt - int(covered_tokens))
        return self.prefill_s + billable * self.prefill_per_token_s

    def _service_s(self, req, covered_tokens: int = 0) -> float:
        if self.role == "prefill":
            return self._prefill_s_of(req, covered_tokens)
        if getattr(req, "kv_handoff", None) is not None:
            # adopted pages: the prompt pass already ran upstream
            return int(req.max_new_tokens) * self.spt
        return (self._prefill_s_of(req, covered_tokens)
                + int(req.max_new_tokens) * self.spt)

    def _maybe_preempt(self, now: float) -> bool:
        """Pause the running request when a strictly-higher-priority
        one waits (preempt="migrate" only): remaining service parks in
        ``_paused`` and the request re-queues at the FRONT — the flow
        model of ServeLoop's export -> park -> resume, byte-exactness
        included (the sim data plane is deterministic either way).
        Returns True when it preempted (the caller re-picks)."""
        if (self.preempt != "migrate" or self.role == "prefill"
                or self._cur is None or not self._queue):
            return False
        req, enq_t, start, finish_at, covered = self._cur
        curp = int(getattr(req, "priority", 0) or 0)
        top = max(int(getattr(r, "priority", 0) or 0)
                  for r, _ in self._queue)
        if top <= curp:
            return False
        self._paused[str(req.rid)] = finish_at - now
        self._queue.insert(0, (req, enq_t))
        self._cur = None
        self.preempted += 1
        self._obs_preempted.inc()
        if req.trace is not None:
            obs.events.record("preempt", trace=req.trace.trace_id,
                              replica=self.rid,
                              remaining_s=round(finish_at - now, 6))
        return True

    # -- tiered prefix-chain model -------------------------------

    def _hbm_insert(self, h: int) -> None:
        """MRU-insert one chain hash into the bounded "HBM" set; LRU
        overflow spills into the tier set (the sim's host-RAM spill),
        whose own overflow drops the oldest entry outright."""
        self._hbm_chains.pop(h, None)
        self._hbm_chains[h] = None
        while len(self._hbm_chains) > self.prefix_cache_blocks:
            old = next(iter(self._hbm_chains))
            self._hbm_chains.pop(old)
            if self.tier_blocks > 0:
                self.tier_spills += 1
                self._tier_chains.pop(old, None)
                self._tier_chains[old] = None
                while len(self._tier_chains) > self.tier_blocks:
                    self._tier_chains.pop(next(iter(self._tier_chains)))

    def _pulled_chain(self, req) -> set[int]:
        """The chain hashes a router-initiated peer pull delivered with
        this request (``prefix_ref`` points at the owner's synthetic
        export payload) — the sim analogue of ``install_prefix``."""
        ref = getattr(req, "prefix_ref", None)
        if ref is None or self.prefix_cache_blocks <= 0:
            return set()
        import json
        try:
            raw = self.fabric.get(str(ref))
        except ConnectionError:
            return set()
        if raw is None:
            return set()
        try:
            doc = json.loads(raw.decode())
            return {int(h) for h in doc.get("chain", [])}
        except (ValueError, UnicodeDecodeError, AttributeError):
            return set()

    def _admit_chains(self, req) -> int:
        """Account an admission against the chain caches and return the
        covered leading tokens (whole blocks whose KV the replica did
        not have to recompute: HBM hit, tier re-admit, or peer pull).
        Admitting then caches the prompt's full chain locally, exactly
        like a real prefill populating the prefix cache."""
        if (self.prefix_cache_blocks <= 0
                or getattr(req, "kv_handoff", None) is not None):
            return 0
        chain = chain_hashes(
            [int(t) for t in np.asarray(req.prompt).tolist()], 16)
        if not chain:
            return 0
        pulled = self._pulled_chain(req)
        covered = 0
        for h in chain:
            if h in self._hbm_chains:
                self.chain_blocks_local += 1
            elif h in self._tier_chains:
                # tier re-admit: the page comes back from host RAM
                self._tier_chains.pop(h)
                self.chain_blocks_tier += 1
            elif h in pulled:
                self.chain_blocks_pull += 1
            else:
                break
            covered += 1
        self.chain_blocks_total += len(chain)
        for h in chain:
            self._hbm_insert(h)
        return covered * 16

    def _kv_blocks_of(self, req) -> int:
        prompt = int(np.asarray(req.prompt).size)
        return -(-(prompt + int(req.max_new_tokens)) // 16)

    def _kv_used(self) -> int:
        resident = [r for r, _ in self._queue]
        if self._cur is not None:
            resident.append(self._cur[0])
        return sum(self._kv_blocks_of(r) for r in resident)

    def _flush_done_buffer(self) -> None:
        while self._done_buf:
            key, payload = self._done_buf[0]
            try:
                self.fabric.set(key, payload)
            except ConnectionError:
                return
            self._done_buf.pop(0)

    def _commit(self, req, reason: str, tokens: list[int],
                extra: dict | None = None) -> None:
        # framed like a real worker's commit, so the router's checksum
        # verification (and the corrupt_replica chaos below) exercises
        # the same decode path as production
        payload = wire.encode_record("completion", {
            "key": str(req.rid), "tokens": tokens,
            "reason": reason, "replica": self.rid, **(extra or {})})
        self._commits += 1
        if (self._corrupt_every is not None
                and self._commits % self._corrupt_every == 0
                and (self._corrupt_left is None or self._corrupt_left > 0)):
            if self._corrupt_left is not None:
                self._corrupt_left -= 1
            pos = min(len(payload) - 1, max(9, len(payload) // 2))
            payload = (payload[:pos] + bytes([payload[pos] ^ 0x10])
                       + payload[pos + 1:])
        key = f"{self.ns}/done/{req.rid}"
        try:
            self._flush_done_buffer()
            if self._done_buf:   # still in the outage: keep order
                raise ConnectionError("sim coord outage")
            self.fabric.set(key, payload)
        except ConnectionError:
            self._done_buf.append((key, payload))
        self.served += 1
        if req.trace is not None:
            obs.events.record("done_commit", trace=req.trace.trace_id,
                              replica=self.rid, reason=reason,
                              tokens=len(tokens))

    def _publish(self) -> None:
        import json
        now = self.clock.monotonic()
        horizon = now - self.wait_window_s
        self._waits = [(t, w) for t, w in self._waits if t >= horizon]
        snap = {
            "rank": self.rank,
            # REAL wall stamp: collect()'s staleness cutoff measures
            # real seconds since publish, and the whole sim runs in
            # well under one — virtual stamps would look hours stale
            "published_at": time.time(),
            "gauges": {
                "serve/queue_depth": {"value": float(len(self._queue))},
                "serve/seconds_per_token": {"value": self.spt},
            },
            # the preempt/resume counters ride the snapshot exactly as
            # a live ServeLoop publishes them (empty dict when the mode
            # is off, keeping pre-migration snapshots byte-stable)
            "counters": (
                {"serve/preempted": {"value": float(self.preempted)},
                 "serve/resumed": {"value": float(self.resumed)}}
                if self.preempt == "migrate" else {}),
            "histograms": {},
        }
        if self.kv_blocks_total > 0:
            used = min(self._kv_used(), self.kv_blocks_total)
            snap["gauges"]["serve/kv_blocks_used"] = {"value": float(used)}
            snap["gauges"]["serve/kv_blocks_free"] = {
                "value": float(self.kv_blocks_total - used)}
        if self.tier_blocks > 0:
            # mirror the live TieredKV gauges (tpudist_torch/models/kv_tier.py)
            # so the fleet scraper's tier-headroom derivation — and the
            # TierHeadroomLow alert rule — runs on the sim's spill tier
            # exactly as on a real one.  A sim "block" is 16 tokens; the
            # byte scale is arbitrary but consistent across both gauges.
            block_bytes = 16 * 1024
            snap["gauges"]["serve/tier_bytes"] = {
                "value": float(len(self._tier_chains) * block_bytes)}
            snap["gauges"]["serve/tier_budget_bytes"] = {
                "value": float(self.tier_blocks * block_bytes)}
        if self._waits:
            snap["histograms"]["serve/queue_wait_s"] = values_to_hist(
                [w for _, w in self._waits], unit="s")
        try:
            self.fabric.set(f"{self.ns}/metrics/{self.rank}",
                            json.dumps(snap).encode())
        except ConnectionError:
            pass   # latest-wins snapshots: the next publish catches up
        if self.prefix_cache_blocks > 0:
            # tiered summary: resident chains (HBM + tier), the sim's
            # fixed block size, weights version, and a wall stamp in the
            # VIRTUAL wall domain — the router's PrefixDirectory runs on
            # the injected VirtualClock.wall, so its TTL measures these
            # stamps in sim-seconds.  Age-based republish keeps a
            # steady-state summary from going stale mid-scenario.
            summ = (tuple(self._affinity), tuple(self._hbm_chains),
                    tuple(self._tier_chains))
            if (summ != self._prefix_pub
                    or now >= self._prefix_refresh_at):
                try:
                    self.fabric.set(
                        f"{self.ns}/prefix/{self.rid}",
                        wire.encode_record("prefix", {
                            "replica": self.rid,
                            "hashes": list(summ[0])[-64:],
                            "chains": list(self._hbm_chains),
                            "tiered": list(self._tier_chains),
                            "block_size": 16,
                            "version": 0,
                            "at": self.clock.wall()}))
                    self._prefix_pub = summ
                    self._prefix_refresh_at = now + 5.0
                except ConnectionError:
                    pass
        else:
            summ = tuple(self._affinity)
            if summ != self._prefix_pub:
                try:
                    self.fabric.set(
                        f"{self.ns}/prefix/{self.rid}",
                        wire.encode_record("prefix", {
                            "replica": self.rid,
                            "hashes": list(summ)[-64:]}))
                    self._prefix_pub = summ
                except ConnectionError:
                    pass
        self._next_pub = now + self.publish_interval_s

    def _serve_pulls(self) -> None:
        """Answer the router's pull-mode KV export requests
        (``{ns}/pullreq/{rid}/``): compute the leading chain run this
        replica actually holds (HBM or tier), publish a synthetic
        payload carrying those hashes, and commit the pulldone record —
        the SimReplica mirror of ``ReplicaWorker._serve_pulls`` over
        ``ServeLoop.export_prefix``.  A run it does not hold commits
        ``ref=None`` (the requester re-prefills, byte-identically)."""
        import json
        for key in sorted(self.fabric.keys(
                f"{self.ns}/pullreq/{self.rid}/")):
            raw = self.fabric.get(key)
            self.fabric.delete(key)
            if raw is None:
                continue
            try:
                doc = wire.decode_record(raw, expect="pullreq",
                                         namespace=self.ns, key=key,
                                         replica=self.rid)
            except wire.WireError:
                continue
            k = str(doc.get("key"))
            chain = chain_hashes(
                [int(t) for t in doc.get("prompt", [])], 16)
            run: list[int] = []
            for h in chain:
                if h in self._hbm_chains or h in self._tier_chains:
                    run.append(h)
                else:
                    break
            ref = None
            if run:
                ref = f"{self.ns}/kv/pull-{k}"
                self.fabric.set(ref, json.dumps(
                    {"chain": run, "block_size": 16,
                     "version": 0}).encode())
                self.pull_exports += 1
            self.fabric.set(
                f"{self.ns}/pulldone/{k}",
                wire.encode_record("pulldone", {
                    "key": k, "ref": ref, "owner": self.rid}))

    def step(self) -> None:
        """Advance the replica to the clock's current instant: go live
        after warmup, consume the inbox, finish/start service, publish
        metrics, and run the graceful close path once stopped.  A coord
        brownout makes the fabric verbs raise; the replica rides it out
        exactly like a real worker — keep serving what it has, buffer
        the commits, skip the polls."""
        if not self.alive:
            return
        now = self.clock.monotonic()
        if now < self._live_at:
            return
        if (self._hb_resume_at is not None
                and now >= self._hb_resume_at):
            # the dropped heartbeat returns: the lease re-establishes
            self.fabric.up(f"{self.ns}:{self.rid}")
            self._hb_resume_at = None
        if not self._live:
            self._live = True
            self.fabric.up(f"{self.ns}:{self.rid}")
            try:
                self._publish()
            except ConnectionError:
                pass

        self._flush_done_buffer()
        try:
            if (self.fabric.get(f"{self.ns}/stop") is not None
                    or self.fabric.get(f"{self.ns}/stop/{self.rid}")
                    is not None):
                self._stopping = True

            # consume the inbox through the real decoder (also the final
            # sweep while stopping: zero-loss drain means nothing
            # accepted is ever abandoned)
            inbox = f"{self.ns}/inbox/{self.rid}/"
            for key in sorted(self.fabric.keys(inbox)):
                raw = self.fabric.get(key)
                self.fabric.delete(key)
                if raw is None:
                    continue
                self._queue.append((_decode_request(raw), now))

            self._serve_pulls()
        except ConnectionError:
            inbox = f"{self.ns}/inbox/{self.rid}/"

        # serve: finish whatever is due, start whatever fits — several
        # per step when service times are shorter than the quantum
        while True:
            if self._cur is not None:
                req, enq_t, start, finish_at, covered = self._cur
                if now < finish_at:
                    if not self._maybe_preempt(now):
                        break
                    continue
                if self.role == "prefill":
                    # stage done: first token exists, KV migrated.  The
                    # ref is synthetic (the sim carries no pages) — the
                    # decode side's adopted-cost model keys off the stub
                    self.all_ttfts.append(finish_at - enq_t)
                    self._commit(req, "handoff", [],
                                 extra={"handoff_ref":
                                        f"sim://{req.rid}"})
                else:
                    if getattr(req, "kv_handoff", None) is None:
                        # unified service: the first token landed when
                        # this replica's own prompt pass finished
                        self.all_ttfts.append(
                            start + self._prefill_s_of(req, covered)
                            - enq_t)
                    self._commit(req, "length",
                                 list(range(int(req.max_new_tokens))))
                self._cur = None
            if not self._queue:
                break
            if self.preempt == "migrate":
                # priority-first admission, FIFO within a class — the
                # sim mirror of ServeLoop's migrate-mode admit_free
                sel = max(range(len(self._queue)),
                          key=lambda i: (int(getattr(
                              self._queue[i][0], "priority", 0) or 0),
                              -i))
            else:
                sel = 0
            req, enq_t = self._queue.pop(sel)
            remaining = self._paused.pop(str(req.rid), None)
            wait = now - enq_t
            if remaining is None:
                self._waits.append((now, wait))
                self.all_waits.append(wait)
                if int(getattr(req, "priority", 0) or 0) > 0:
                    self.all_waits_priority.append(wait)
            else:
                # a paused lane resuming: its wait was already counted
                # at first admission
                self.resumed += 1
                self._obs_resumed.inc()
                if req.trace is not None:
                    obs.events.record("resume", trace=req.trace.trace_id,
                                      replica=self.rid)
            if (req.deadline_s is not None
                    and self.clock.wall() > req.deadline_s):
                # expired while queued: the replica-side deadline kill
                self._commit(req, "timeout", [])
                continue
            phash = getattr(req, "prefix_hash", None)
            hit = False
            if phash is not None:
                self.prefix_requests += 1
                hit = int(phash) in self._affinity
                self.prefix_hits += int(hit)
                self._affinity.pop(int(phash), None)
                self._affinity[int(phash)] = None
                while len(self._affinity) > 128:
                    self._affinity.pop(next(iter(self._affinity)))
            covered = 0 if remaining is not None \
                else self._admit_chains(req)
            if req.trace is not None:
                obs.events.record("admit", trace=req.trace.trace_id,
                                  replica=self.rid,
                                  queue_wait_s=round(wait, 6),
                                  prefix_hit=hit)
            self._cur = (req, enq_t, now,
                         now + (remaining if remaining is not None
                                else self._service_s(req, covered)),
                         covered)

        if now >= self._next_pub:
            self._publish()

        try:
            if (self._stopping and self._cur is None and not self._queue
                    and not self._done_buf
                    and not self.fabric.keys(inbox)):
                # clean drain exit: the lease lapses; the autoscaler's
                # sweep (or the router's drain-departure path) handles
                # the coordination residue, same as a real close
                self.fabric.down(f"{self.ns}:{self.rid}")
                self.alive = False
        except ConnectionError:
            pass   # can't verify an empty inbox blind; close next step


class FleetSim:
    """One offline scenario run (see module docstring).

    ``FleetSim(spec).run()`` returns the scenario summary row —
    the bench-JSONL payload the :class:`~tpudist_torch.sim.scenario.Envelope`
    checks — with ``envelope_ok`` / ``violations`` already folded in."""

    def __init__(self, spec: ScenarioSpec, *,
                 workload: Workload | None = None,
                 service_rates: dict[str, float] | None = None,
                 quantum_s: float = 0.01) -> None:
        self.spec = spec
        self.workload = workload if workload is not None \
            else synthesize(spec)
        self.rates = dict(service_rates or {})
        self.quantum_s = float(quantum_s)
        fleet = spec.fleet
        self.vc = VirtualClock()
        self.fabric = SimFabric(clock=self.vc.monotonic)
        self.ns = f"sim/{spec.name}"
        self.replicas: list[SimReplica] = []
        self._next_rank = 0
        # the declarative FaultScript: brownout windows arm the fabric
        # up front; timed replica faults queue for _advance to fire;
        # a router kill arms the process fault plan at run() time
        self._router_kill_poll: int | None = None
        self._fault_due: list[dict] = []
        for f in getattr(spec, "faults", ()):
            if f["kind"] == "coord_brownout":
                self.fabric.add_outage(f["at_s"],
                                       f["at_s"] + f["for_s"])
            elif f["kind"] == "kill_router":
                self._router_kill_poll = int(f["at_poll"])
            else:
                self._fault_due.append(dict(f))
        self._fault_due.sort(key=lambda f: f["at_s"])
        if int(fleet.get("prefill_replicas") or 0) > 0:
            # disaggregated fleet: two pools instead of a unified one
            for _ in range(int(fleet["prefill_replicas"])):
                self._spawn_one(warmup_s=0.0, role="prefill")
            for _ in range(int(fleet["decode_replicas"])):
                self._spawn_one(warmup_s=0.0, role="decode")
        else:
            for _ in range(int(fleet["replicas"])):
                self._spawn_one(warmup_s=0.0)
        # the alert plane: a real TSDB + FleetScraper + the
        # SHIPPED default alert rules, all on the virtual clock and the
        # same fabric the router polls.  Scenario envelopes pin which
        # rules fire per scenario, so the default thresholds become a
        # regression surface instead of folklore.
        self.tsdb = TSDB(retention_s=600.0, resolution_s=0.5,
                         downsample_after_s=120.0,
                         clock=self.vc.monotonic)
        self.alerts = AlertManager(self.tsdb, default_rules(),
                                   clock=self.vc.monotonic)
        self.scraper = FleetScraper(
            self.tsdb, client=self.fabric, namespace=self.ns,
            registry=obs.registry, alerts=self.alerts,
            interval_s=float(fleet["alert_scrape_s"]),
            clock=self.vc.monotonic)
        self._scrape_next = self.scraper.interval_s
        self.router = self._make_router()
        self.scaler: Autoscaler | None = None
        self.scalers: list[Autoscaler] = []
        if fleet.get("autoscale"):
            self.scaler = Autoscaler(
                self.fabric, namespace=self.ns,
                config=AutoscaleConfig(**fleet["autoscale"]),
                spawner=self._spawn_n, clock=self.vc.monotonic)
            self.scalers.append(self.scaler)
        for pool in ("prefill", "decode"):
            # one control loop per pool, each watching only its own
            # replicas' metrics — the live two-Autoscaler deployment
            if fleet.get(f"autoscale_{pool}"):
                self.scalers.append(Autoscaler(
                    self.fabric, namespace=self.ns,
                    config=AutoscaleConfig(**fleet[f"autoscale_{pool}"]),
                    spawner=(lambda n, p=pool: [
                        self._spawn_one(role=p) for _ in range(n)]),
                    pool=pool, clock=self.vc.monotonic))
        self._scaler_next = [s.cfg.poll_s for s in self.scalers]

    @classmethod
    def from_trace(cls, doc: dict, *, name: str = "trace_replay",
                   autoscale: dict | None = None,
                   replicas: int = 1,
                   fleet: dict | None = None,
                   envelope: Envelope | None = None,
                   **kw) -> "FleetSim":
        """A simulator replaying a recorded ``tpudist.events/1``
        document: the trace's enqueue events become the workload
        (:func:`workload_from_trace`) and its ``segment`` ``spt``
        stamps set each replica's service rate
        (:func:`service_rates_from_trace`) — the recorded incident,
        re-run through today's policy code."""
        wl = workload_from_trace(doc, name=name)
        rates = service_rates_from_trace(doc)
        f = {"replicas": replicas, **(fleet or {})}
        if autoscale is not None:
            f["autoscale"] = dict(autoscale)
        spec = ScenarioSpec(
            name=name, duration_s=max(wl.duration_s, 1e-3) + 1.0,
            arrival={"kind": "constant", "rate": 1.0},   # unused: replay
            fleet=f, **({"envelope": envelope} if envelope else {}))
        return cls(spec, workload=wl, service_rates=rates, **kw)

    # -- fleet construction ------------------------------------------------

    def _make_router(self) -> Router:
        # the sim's golden probe: a SimReplica serves ANY request as
        # tokens [0..max_new) with reason "length", so the known-exact
        # answer is range(budget) — deterministic unless the replica is
        # corrupting its commits, which is exactly what a probe tests
        golden = GoldenProbe(prompt=(1, 2, 3, 4),
                             expect=tuple(range(8)), max_new_tokens=8)
        qcfg = QuarantineConfig(
            strike_threshold=3, strike_window_s=30.0,
            probe_interval_s=0.5, probe_timeout_s=10.0,
            reinstate_after=3, retire_after_fails=10)
        return Router(
            self.fabric, namespace=self.ns,
            poll_s=float(self.spec.fleet["router_poll_s"]),
            use_health=False,
            golden_probe=golden, quarantine_config=qcfg,
            alerts=self.alerts,
            clock=self.vc.monotonic, wall=self.vc.wall,
            sleeper=self._advance)

    def _rate_for(self, rid: str) -> float:
        return float(self.rates.get(
            rid, self.rates.get("*",
                                self.spec.fleet["seconds_per_token"])))

    def _spawn_one(self, warmup_s: float | None = None,
                   role: str = "both") -> SimReplica:
        fleet = self.spec.fleet
        rank = self._next_rank
        self._next_rank += 1
        r = SimReplica(
            self.fabric, self.vc, rank=rank, namespace=self.ns,
            role=role,
            seconds_per_token=self._rate_for(f"r{rank}"),
            prefill_s=float(fleet["prefill_s"]),
            prefill_per_token_s=float(fleet["prefill_per_token_s"]),
            warmup_s=(float(fleet["warmup_s"]) if warmup_s is None
                      else warmup_s),
            publish_interval_s=float(fleet["publish_interval_s"]),
            wait_window_s=float(fleet["wait_window_s"]),
            kv_blocks_total=int(fleet.get("kv_blocks_total") or 0),
            prefix_cache_blocks=int(
                fleet.get("prefix_cache_blocks") or 0),
            tier_blocks=int(fleet.get("tier_blocks") or 0),
            preempt=str(fleet.get("preempt") or "degrade"))
        if warmup_s == 0.0:
            r.step()   # live (and publishing) before the first poll
        self.replicas.append(r)
        return r

    def _spawn_n(self, n: int) -> list[SimReplica]:
        """The autoscaler's spawner: joiners warm up for the configured
        virtual seconds before their first heartbeat, reproducing the
        real joiner's compile window."""
        return [self._spawn_one() for _ in range(n)]

    # -- the virtual-time engine -------------------------------------------

    def _advance(self, dt: float) -> None:
        """The router's injected sleeper: advance virtual time in
        quanta, stepping every replica and firing the autoscaler on its
        cadence — the whole world moves while the router 'sleeps'."""
        remaining = float(dt)
        while remaining > 1e-12:
            q = min(self.quantum_s, remaining)
            self.vc.advance(q)
            remaining -= q
            while (self._fault_due
                    and self.vc.monotonic() >= self._fault_due[0]["at_s"]):
                self._fire_fault(self._fault_due.pop(0))
            for r in self.replicas:
                r.step()
            for i, s in enumerate(self.scalers):
                if self.vc.monotonic() >= self._scaler_next[i]:
                    s.poll()
                    self._scaler_next[i] += s.cfg.poll_s
            if self.vc.monotonic() >= self._scrape_next:
                self.scraper.tick(self.vc.monotonic())
                self._scrape_next += self.scraper.interval_s

    def _fire_fault(self, ev: dict) -> None:
        target = next((r for r in self.replicas
                       if r.rid == ev.get("rid") and r.alive), None)
        if target is None:
            return
        if ev["kind"] == "kill_replica":
            target.kill()
        elif ev["kind"] == "drop_heartbeats":
            target.drop_heartbeats(ev["for_s"])
        elif ev["kind"] == "corrupt_replica":
            target.corrupt(every=int(ev.get("every", 1)),
                           count=ev.get("count"))

    # -- one scenario run --------------------------------------------------

    def run(self, *, timeout_s: float | None = None) -> dict:
        """Replay the workload through the real router; returns the
        scenario summary row (bench-JSONL schema, envelope-checked)."""
        # process-global SLO window: scrub the previous scenario's
        # observations so this run's burn gauges start clean
        obs.slo.clear()
        base = _counters_now(self.ns)
        reqs, arrivals = self.workload.requests(self.vc.wall())
        budget = (timeout_s if timeout_s is not None
                  else self.spec.duration_s + 900.0)
        installed = False
        if self._router_kill_poll is not None:
            faults.install(faults.FaultPlan(
                router_kill_after_polls=self._router_kill_poll,
                router_kill_raise=True))
            installed = True
        t0 = time.perf_counter()
        # on_complete is the sim's delivery journal (the results file of
        # the CLI route mode): completions the first router delivered
        # before a crash survive the crash, and recover() is told about
        # them so replayed terminals dedupe instead of double-counting
        comps: list = []
        delivered: list[str] = []

        def _deliver(key, comp):
            comps.append(comp)
            delivered.append(str(comp.rid))

        try:
            try:
                self.router.run(reqs, arrivals=arrivals,
                                timeout_s=budget, on_complete=_deliver)
            except faults.RouterKilled:
                # the injected router crash: a REPLACEMENT router on the
                # same fabric/namespace runs the real journal-recovery
                # path — re-adopting live replicas, sweeping orphans,
                # replaying journaled terminals
                self.router = self._make_router()
                self.router.recover(timeout_s=budget,
                                    delivered=delivered,
                                    on_complete=_deliver)
        finally:
            if installed:
                faults.reset()
        wall_s = time.perf_counter() - t0
        return self._summarize(reqs, comps, base, wall_s)

    def _prefix_hit_rate(self) -> float | None:
        """Fleet-wide offline prefix-cache hit rate: admissions whose
        stamped hash was already in the admitting replica's recent set,
        over all hash-stamped admissions.  ``None`` when the workload
        stamps no hashes (no tenant prefixes) — an envelope bound on an
        unstamped trace would be vacuous, not zero."""
        req_n = sum(r.prefix_requests for r in self.replicas)
        if req_n == 0:
            return None
        hits = sum(r.prefix_hits for r in self.replicas)
        return round(hits / req_n, 4)

    def _global_hit_rate(self) -> float | None:
        """Fleet-wide BLOCK-level KV reuse under the tiered model:
        prompt chain blocks whose pages were already somewhere the
        fleet could reuse them (local HBM, host tier re-admit, or a
        peer pull) over all chain blocks admitted.  ``None`` when no
        replica ran the chain model (``prefix_cache_blocks`` unset) —
        same vacuous-bound discipline as ``prefix_hit_rate``."""
        total = sum(r.chain_blocks_total for r in self.replicas)
        if total == 0:
            return None
        covered = sum(r.chain_blocks_local + r.chain_blocks_tier
                      + r.chain_blocks_pull for r in self.replicas)
        return round(covered / total, 4)

    def _summarize(self, reqs, comps, base: dict, wall_s: float) -> dict:
        spec = self.spec
        reasons: dict[str, int] = {}
        for c in comps:
            reasons[c.reason] = reasons.get(c.reason, 0) + 1
        waits = [w for r in self.replicas for w in r.all_waits]
        ttfts = [t for r in self.replicas for t in r.all_ttfts]
        pwaits = [w for r in self.replicas
                  for w in r.all_waits_priority]
        now = _counters_now(self.ns)
        delta = {k: now.get(k, 0.0) - base.get(k, 0.0) for k in now}

        ups = drains = 0
        ups_by_pool = {"prefill": 0, "decode": 0}
        recovery_s = 0.0
        for scaler in self.scalers:
            for rec in scaler.decision_log:
                if rec["action"] is not None:
                    if rec["action"][0] == "up":
                        ups += 1
                        if scaler.pool in ups_by_pool:
                            ups_by_pool[scaler.pool] += 1
                    else:
                        drains += 1
            breach_ts = [rec["t"] for rec in scaler.decision_log
                         if not rec.get("suppressed")
                         and rec["wait_q"] > scaler.cfg.target_wait_s]
            if breach_ts:
                recovery_s = max(recovery_s,
                                 max(breach_ts) - min(breach_ts)
                                 + scaler.cfg.poll_s)

        row = {
            "scenario": spec.name,
            "requests": len(reqs),
            "lost_requests": len(reqs) - len(comps),
            "completed_ok": (reasons.get("stop", 0)
                             + reasons.get("length", 0)),
            "p99_queue_wait_s": (
                round(float(np.percentile(waits, 99)), 6)
                if waits else 0.0),
            # first-token latency: replica-local wait +
            # prompt-pass time, sampled on whichever replica produced
            # the first token — a prefill replica at handoff, a unified
            # replica at its own prompt-pass finish
            "p99_ttft_s": (
                round(float(np.percentile(ttfts, 99)), 6)
                if ttfts else 0.0),
            "recovery_s": round(recovery_s, 3),
            "scale_ups": ups,
            "scale_ups_prefill": ups_by_pool["prefill"],
            "scale_ups_decode": ups_by_pool["decode"],
            "drains": drains,
            "priority_bad": delta.get("slo/bad~class=priority", 0.0),
            "final_replicas": sum(1 for r in self.replicas if r.alive),
            "virtual_s": round(self.vc.monotonic(), 3),
            "sim_wall_s": round(wall_s, 4),
            "speedup": (round(self.vc.monotonic() / wall_s, 1)
                        if wall_s > 0 else None),
            "seed": spec.seed,
            # chaos accounting: deaths the router declared,
            # journal recoveries it ran, and the 300s SLO burn — the
            # whole sim finishes in well under 300 real seconds, so
            # this window sees every terminal decision of the run
            "replica_deaths": delta.get("router/replica_deaths", 0.0),
            "router_recoveries": delta.get("router/recoveries", 0.0),
            "burn_rate_300s": round(
                obs.slo.burn_rates().get(300.0, 0.0), 4),
            # data-plane integrity accounting: flips the
            # wire checksum caught, quarantine lifecycle counts, and —
            # the one that must stay zero — terminals DELIVERED whose
            # tokens differ from the sim's deterministic service output
            "checksum_mismatches": delta.get(
                "integrity/checksum_mismatch", 0.0),
            "quarantines": delta.get("router/quarantines", 0.0),
            "reinstated": delta.get("router/reinstated", 0.0),
            "retired": delta.get("router/retired", 0.0),
            "probe_pass": delta.get("probe/pass", 0.0),
            "probe_fail": delta.get("probe/fail", 0.0),
            "corrupted_terminals": _corrupted_terminals(reqs, comps),
            # prefix-affinity accounting: the fleet-level hit
            # rate the router's hash steer is supposed to preserve under
            # scale-out, plus how many dispatches the steer decided
            "prefix_hit_rate": self._prefix_hit_rate(),
            "prefix_affinity_dispatches": delta.get(
                "router/prefix_affinity", 0.0),
            # tiered-KV accounting: block-level reuse across
            # the whole fleet memory hierarchy, its local/tier/pull
            # split, and the pull-mode traffic the router initiated
            "global_hit_rate": self._global_hit_rate(),
            "tier_hit_blocks": sum(r.chain_blocks_tier
                                   for r in self.replicas),
            "pull_hit_blocks": sum(r.chain_blocks_pull
                                   for r in self.replicas),
            "tier_spills": sum(r.tier_spills for r in self.replicas),
            "prefix_pulls": delta.get("router/prefix_pulls", 0.0),
            "prefix_pull_fallbacks": delta.get(
                "router/prefix_pull_fallbacks", 0.0),
            "prefix_stale_skips": delta.get(
                "router/prefix_stale_skips", 0.0),
            # migration accounting: preempt/resume volume on
            # the replicas, the PRIORITY class's own queue-wait tail
            # (the number preemption exists to hold down), and the
            # router-side migrate-stage commits and their fallbacks
            "preemptions": delta.get("serve/preempted", 0.0),
            "preempt_resumes": delta.get("serve/resumed", 0.0),
            "p99_priority_wait_s": (
                round(float(np.percentile(pwaits, 99)), 6)
                if pwaits else 0.0),
            "migrations": delta.get("router/migrations", 0.0),
            "migration_fallbacks": delta.get(
                "router/migration_fallbacks", 0.0),
        }
        for reason in ("completed", "shed", "rejected", "failed",
                       "timeout"):
            row[f"decisions_{reason}"] = delta.get(
                f"router/decisions/{reason}", 0.0)
        # alert accounting: every rule that reached firing at
        # any point in the run, plus the hash of the rule set it fired
        # under — the envelope's must_fire/must_not_fire checks read
        # these, and bench rows carry the hash for provenance
        row["alerts_fired"] = sorted(self.alerts.fired_names)
        row["alert_rules_hash"] = self.alerts.rules_hash
        violations = spec.envelope.check(row)
        row["envelope_ok"] = not violations
        row["violations"] = violations
        return row


def _corrupted_terminals(reqs, comps) -> int:
    """Delivered completions whose tokens are NOT the sim data plane's
    deterministic output (``range(max_new_tokens)`` with reason
    ``length``) — i.e. corruption that made it past every integrity
    gate to a caller.  The silent_corruption envelope pins this to 0."""
    want = {str(r.rid): int(r.max_new_tokens) for r in reqs}
    bad = 0
    for c in comps:
        if c.reason != "length" or str(c.rid) not in want:
            continue
        if [int(t) for t in np.asarray(c.tokens).tolist()] != list(
                range(want[str(c.rid)])):
            bad += 1
    return bad


def _counters_now(ns: str) -> dict[str, float]:
    """Current values of the process-global counters a scenario summary
    is computed from — summaries are before/after DELTAS because the
    obs registry is cumulative across scenarios in one process."""
    snap = obs.snapshot()
    out: dict[str, float] = {}
    for name, m in snap.get("counters", {}).items():
        if name.startswith(("router/decisions/", "slo/bad", "slo/good",
                            "autoscale/", "router/replica_deaths",
                            "router/recoveries", "coord/",
                            "integrity/", "probe/", "quarantine/",
                            "router/quarantines", "router/reinstated",
                            "router/retired", "router/prefix",
                            "serve/preempted", "serve/resumed",
                            "router/migrations",
                            "router/migration_fallbacks")):
            out[name] = float(m.get("value") or 0.0)
    return out


def first_up_rel(decision_log, action_seq, target_wait_s) -> int | None:
    """Polls between the first breach observation and the first scale-up
    (bench.py's ``_first_up_rel``): the hysteresis distance a live run
    and its replay must agree on (absolute poll indices differ by when
    each loop started; the breach-relative index is the policy's own)."""
    breaches = [r["poll"] for r in decision_log
                if r["wait_q"] > target_wait_s]
    ups = [a["poll"] for a in action_seq if a["kind"] == "up"]
    if not breaches or not ups:
        return None
    return ups[0] - breaches[0]


def decision_match(live_log, live_acts, sim_log, sim_acts,
                   target_wait_s) -> dict:
    """bench.py's sim-vs-live gate over two autoscalers' decision logs and
    action sequences: equal scale-up counts, and the first scale-up
    within one poll of the first breach on both.  Returns the verdict
    (``decision_match``) beside the counts and distances it read."""
    live_rel = first_up_rel(live_log, live_acts, target_wait_s)
    sim_rel = first_up_rel(sim_log, sim_acts, target_wait_s)
    live_ups = sum(1 for a in live_acts if a["kind"] == "up")
    sim_ups = sum(1 for a in sim_acts if a["kind"] == "up")
    return {"decision_match": bool(
                live_ups == sim_ups and live_rel is not None
                and sim_rel is not None and abs(live_rel - sim_rel) <= 1),
            "live_ups": live_ups, "sim_ups": sim_ups,
            "live_first_up_rel": live_rel, "sim_first_up_rel": sim_rel}
