"""Autoscaling control plane for the serve fleet (counterpart of
:mod:`tpudist.runtime.autoscaler`; the same polls make the same
decisions).

The router module has the fleet's *mechanisms* — live join
(:func:`~tpudist_torch.runtime.router.scale_fleet`), graceful drain
(``{ns}/draining/{rid}`` + the replica's zero-loss close path), health
-aware routing; without a policy a human watches queue-wait
percentiles and calls ``scale_fleet`` by hand.  This module closes the
loop: a
rank-0 control process watches the SAME merged ``serve/queue_wait_s``
percentiles the router's SLO gate reads (sliding-window, so an
hours-old spike can neither mask fresh load nor pin the fleet up) plus
``serve/queue_depth`` / ``serve/kv_blocks_free``, and drives the fleet
itself.

Policy — target-tracking with ASYMMETRIC hysteresis:

* **Scale up** after ``breach_polls`` CONSECUTIVE polls with the
  watched percentile above ``target_wait_s`` (a single slow poll is
  noise; a sustained breach is load), bounded by ``max_replicas`` and
  an ``up_cooldown_s`` per-direction cooldown so one breach episode
  produces one scale-up, not one per poll while the joiner compiles.
  Joiners mid-warmup (spawned, not yet heartbeating) count toward the
  bound for the same reason.
* **Scale down** only after a MUCH longer sustained-idle window
  (``idle_polls`` consecutive polls below ``low_wait_s`` with an empty
  queue) plus ``down_cooldown_s``: adding capacity late costs SLO,
  removing it early costs a re-scale-up — so up is eager, down is
  reluctant.
* **Scale-down is a graceful drain, never a kill**: the victim gets a
  ``draining`` mark (the router steers admissions away immediately),
  its inbox empties, THEN the targeted stop key lands — the worker's
  close path finishes queued and in-flight work, commits every
  completion, and exits cleanly.  The autoscaler never loses a
  request; ``autoscale/drain_completed`` ticks only after the lease is
  gone and the coordination residue is swept.

Every knob is env-tunable (``TPUDIST_AUTOSCALE_*`` — see
:meth:`AutoscaleConfig.from_env`), and the control loop is a plain
:meth:`Autoscaler.poll` method so tests drive it deterministically
against a fake coordination client; :meth:`Autoscaler.start` wraps it
in the background thread a deployment runs.

The ``TPUDIST_FAULT_AUTOSCALE_POLL_DELAY_S`` injection stalls each
poll — a wedged control plane.  The data plane must keep serving
through it (the autoscaler holds no locks and sits on no request
path); scaling is merely late.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Callable, Sequence

from tpudist_torch import obs
from tpudist_torch.obs.aggregate import collect, merge_snapshots
from tpudist_torch.obs.alerts import AlertManager, autoscale_rules
from tpudist_torch.obs.registry import hist_quantile
from tpudist_torch.obs.tsdb import TSDB
from tpudist_torch.runtime import faults
from tpudist_torch.runtime.coord import CoordClient
from tpudist_torch.runtime.router import DEFAULT_NAMESPACE, scale_fleet
from tpudist_torch.utils.logging import get_logger

log = get_logger(__name__)

__all__ = ["AutoscaleConfig", "Autoscaler"]

ENV_PREFIX = "TPUDIST_AUTOSCALE_"


def _env(environ, name: str) -> float | None:
    raw = environ.get(ENV_PREFIX + name)
    if raw is None or raw.strip() == "":
        return None
    return float(raw)


class AutoscaleConfig:
    """The target-tracking policy's knobs (all env-overridable).

    ``low_wait_s`` defaults to ``target_wait_s / 4``: the idle band and
    the breach band must not touch, or the policy oscillates at the
    boundary."""

    def __init__(self, *,
                 min_replicas: int = 1,
                 max_replicas: int = 4,
                 target_wait_s: float = 0.5,
                 low_wait_s: float | None = None,
                 quantile: float = 0.9,
                 breach_polls: int = 3,
                 idle_polls: int = 10,
                 up_cooldown_s: float = 5.0,
                 down_cooldown_s: float = 20.0,
                 poll_s: float = 0.5,
                 step: int = 1,
                 max_metric_age_s: float = 5.0,
                 max_burn_rate: float | None = None,
                 min_kv_free_frac: float | None = None,
                 min_tier_headroom_frac: float | None = None) -> None:
        if min_replicas < 0 or max_replicas < max(min_replicas, 1):
            raise ValueError(
                f"need 0 <= min_replicas <= max_replicas (>=1), got "
                f"{min_replicas}/{max_replicas}")
        if target_wait_s <= 0:
            raise ValueError(
                f"target_wait_s must be > 0, got {target_wait_s}")
        if low_wait_s is None:
            low_wait_s = target_wait_s / 4.0
        if not 0.0 <= low_wait_s < target_wait_s:
            raise ValueError(
                f"need 0 <= low_wait_s < target_wait_s, got "
                f"{low_wait_s} vs {target_wait_s}")
        if not 0.0 < quantile <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {quantile}")
        if breach_polls < 1 or idle_polls < 1 or step < 1:
            raise ValueError("breach_polls, idle_polls and step must "
                             "all be >= 1")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.target_wait_s = float(target_wait_s)
        self.low_wait_s = float(low_wait_s)
        self.quantile = float(quantile)
        self.breach_polls = int(breach_polls)
        self.idle_polls = int(idle_polls)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.poll_s = float(poll_s)
        self.step = int(step)
        self.max_metric_age_s = float(max_metric_age_s)
        if max_burn_rate is not None and max_burn_rate <= 0:
            raise ValueError(
                f"max_burn_rate must be > 0, got {max_burn_rate}")
        # SLO burn-rate pressure: a sustained burn above this (fleet
        # merged slo/burn_rate_* gauges, OR the local tracker) counts as
        # a breach poll even while queue-wait looks fine — bad outcomes
        # (sheds, timeouts, failures) scale the fleet up too, not just
        # slow queues.  None disables the signal.
        self.max_burn_rate = (None if max_burn_rate is None
                              else float(max_burn_rate))
        # KV-pressure up-signal: a poll where the pool's merged free
        # block fraction (free / (free + used)) sits below this counts
        # as a breach even with an empty queue — the DECODE pool's load
        # is resident cache, not queue wait, so waiting for queue-wait
        # breach means admissions are already stalling on pages.  None
        # disables the signal (the prefill pool's load IS queue wait).
        if min_kv_free_frac is not None and not 0.0 < min_kv_free_frac < 1.0:
            raise ValueError(f"min_kv_free_frac must be in (0, 1), got "
                             f"{min_kv_free_frac}")
        self.min_kv_free_frac = (None if min_kv_free_frac is None
                                 else float(min_kv_free_frac))
        # tiered-KV pressure up-signal: when the fleet's host spill
        # tiers run out of headroom (merged serve/tier_bytes vs
        # serve/tier_budget_bytes), the next evictions DISCARD warm
        # prefixes instead of spilling them — re-prefill load is about
        # to arrive even though queues still look fine.  A poll with
        # fleet tier headroom (1 - bytes/budget) below this counts as a
        # breach.  None disables the signal (and fleets with the tier
        # disabled publish no budget, which also disables it).
        if (min_tier_headroom_frac is not None
                and not 0.0 < min_tier_headroom_frac < 1.0):
            raise ValueError(
                f"min_tier_headroom_frac must be in (0, 1), got "
                f"{min_tier_headroom_frac}")
        self.min_tier_headroom_frac = (
            None if min_tier_headroom_frac is None
            else float(min_tier_headroom_frac))

    @classmethod
    def from_env(cls, environ=None, **overrides) -> "AutoscaleConfig":
        import os

        env = os.environ if environ is None else environ
        kw: dict = {}
        for name, key, cast in (
                ("MIN_REPLICAS", "min_replicas", int),
                ("MAX_REPLICAS", "max_replicas", int),
                ("TARGET_WAIT_S", "target_wait_s", float),
                ("LOW_WAIT_S", "low_wait_s", float),
                ("QUANTILE", "quantile", float),
                ("BREACH_POLLS", "breach_polls", int),
                ("IDLE_POLLS", "idle_polls", int),
                ("UP_COOLDOWN_S", "up_cooldown_s", float),
                ("DOWN_COOLDOWN_S", "down_cooldown_s", float),
                ("POLL_S", "poll_s", float),
                ("STEP", "step", int),
                ("MAX_METRIC_AGE_S", "max_metric_age_s", float),
                ("MAX_BURN_RATE", "max_burn_rate", float),
                ("MIN_KV_FREE_FRAC", "min_kv_free_frac", float),
                ("MIN_TIER_HEADROOM_FRAC", "min_tier_headroom_frac",
                 float)):
            v = _env(env, name)
            if v is not None:
                kw[key] = cast(v)
        kw.update(overrides)
        return cls(**kw)


class Autoscaler:
    """The rank-0 control loop.

    Args:
      client: coord client (the autoscaler's own).
      coord_addr: ``host:port`` handed to the default spawner
        (:func:`~tpudist_torch.runtime.router.scale_fleet` with chain-
        allocated indices).  Optional when ``spawner`` is injected.
      config: the policy; defaults to :meth:`AutoscaleConfig.from_env`.
      spawner: ``spawner(n) -> list[Popen]`` override (tests inject a
        fake; multi-host deployments inject their pod launcher).
      replica_args / device: forwarded to the default spawner so
        joiners run the same serve configuration as the fleet.  Joiners
        serve on ``device`` (default the card; a joiner asked for the
        card on a host without one raises, it does not fall back).
      pool: ``None`` (unified fleet — every replica) or a disaggregated
        stage, ``"prefill"`` / ``"decode"``.  A pool-scoped instance
        observes and acts ONLY on replicas registered with that role:
        its live/draining/quarantined views, metric merge, victim pick
        and spawner (joiners get ``--role {pool}``) all filter by the
        registration's role, and every ``autoscale/*`` metric it owns
        is suffixed ``~pool={pool}`` so the two control loops of a
        disaggregated fleet never collide.  The pools' load signals
        differ by design: prefill load is QUEUE WAIT (bursty compute),
        decode load is RESIDENT KV (steady memory) — size the decode
        pool with ``min_kv_free_frac``.
      clock: injectable monotonic clock (deterministic cooldown tests).

    :meth:`poll` is ONE control decision — observe, decide, act — and
    returns a record of what it saw and did.  :meth:`start` runs it on
    ``config.poll_s`` cadence in a daemon thread.
    """

    def __init__(self, client: CoordClient, *,
                 coord_addr: str | None = None,
                 namespace: str = DEFAULT_NAMESPACE,
                 config: AutoscaleConfig | None = None,
                 spawner: Callable[[int], list] | None = None,
                 replica_args: Sequence[str] = (),
                 env_extra: dict | None = None,
                 device: str = "cuda",
                 pool: str | None = None,
                 clock=time.monotonic) -> None:
        if pool not in (None, "prefill", "decode"):
            raise ValueError(f"pool must be None, 'prefill' or 'decode', "
                             f"got {pool!r}")
        self.client = client
        self.ns = namespace
        self.pool = pool
        self.cfg = config or AutoscaleConfig.from_env()
        self.replica_args = list(replica_args)
        self.env_extra = dict(env_extra or {})
        self.device = device
        self._clock = clock
        if spawner is None:
            if coord_addr is None:
                raise ValueError(
                    "need coord_addr for the default scale_fleet "
                    "spawner (or inject spawner=)")
            spawner = self._default_spawner
        self.coord_addr = coord_addr
        self.spawner = spawner
        self.procs: list = []          # joiners spawned by this loop
        self._drains: set[str] = set()  # rids THIS loop marked draining
        self._breach = 0
        self._idle = 0
        self._poll_n = 0
        # bounded history of every poll's decision record (stamped with
        # the poll index and clock): the replayable control-plane
        # artifact an offline simulator reproduces and a sim-vs-live
        # agreement check diffs against
        self.decision_log: list[dict] = []
        self.decision_log_max = 4096
        self._last_up: float | None = None
        self._last_down: float | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        tag = "" if pool is None else f"~pool={pool}"
        self._obs_ups = obs.counter(f"autoscale/scale_ups{tag}",
                                    unit="replicas")
        self._obs_downs = obs.counter(f"autoscale/scale_downs{tag}",
                                      unit="replicas")
        self._obs_drained = obs.counter(f"autoscale/drain_completed{tag}",
                                        unit="replicas")
        self._obs_drain_migrations = obs.counter(
            f"autoscale/drain_migrations{tag}", unit="reqs",
            help="requests a draining replica migrated out instead of "
                 "finishing in place (fast drain)")
        # fast-drain bookkeeping: a draining victim's serve/migrated_out
        # counter at drain start (base) and at the last tick (last) —
        # growth past base plus an empty queue means the work LEFT, so
        # the stop key must not keep waiting on completions
        self._drain_mig_base: dict[str, float] = {}
        self._drain_mig_last: dict[str, float] = {}
        self._obs_polls = obs.counter(f"autoscale/polls{tag}",
                                      unit="polls")
        self._obs_suppressed = obs.counter(
            f"autoscale/suppressed_polls{tag}", unit="polls",
            help="polls skipped because the coord store was unreachable "
                 "(no scaling verdicts on blind data)")
        self._obs_replicas = obs.gauge(f"autoscale/replicas{tag}",
                                       unit="replicas")
        self._obs_wait = obs.gauge(f"autoscale/wait_q{tag}", unit="s")
        self._obs_breach = obs.gauge(f"autoscale/breach_polls{tag}",
                                     unit="polls")
        self._obs_idle = obs.gauge(f"autoscale/idle_polls{tag}",
                                   unit="polls")
        self._obs_burn = obs.gauge(
            f"autoscale/burn_rate{tag}", unit="x",
            help="SLO burn rate the scaling decision saw (max of fleet "
                 "gauges and the local tracker's shortest window)")
        # breach predicates live in a declarative rule set evaluated
        # over a private per-poll TSDB (tpudist_torch.obs.alerts): each poll
        # records what it observed as autoscale/* series and reads
        # which rules fire instead of re-implementing thresholds
        # inline.  Absent signals (no KV/tier gauges published) are
        # recorded as NaN — present but matching no predicate — so
        # "signal missing" can never read as a stale previous value.
        self._tsdb = TSDB(retention_s=600.0, resolution_s=0.001,
                          downsample_after_s=60.0, clock=self._clock)
        self.alerts = AlertManager(self._tsdb, autoscale_rules(self.cfg),
                                   clock=self._clock)

    def _default_spawner(self, n: int) -> list:
        args = list(self.replica_args)
        if self.pool is not None and "--role" not in args:
            args += ["--role", self.pool]
        return scale_fleet(self.coord_addr, n, namespace=self.ns,
                           replica_args=args,
                           env_extra=self.env_extra,
                           device=self.device)

    # -- fleet observation -------------------------------------------------

    def live(self) -> set[str]:
        mark = f"{self.ns}:"
        return {name[len(mark):] for name in self.client.live()
                if name.startswith(mark)}

    def draining(self) -> set[str]:
        prefix = f"{self.ns}/draining/"
        return {k[len(prefix):] for k in self.client.keys(prefix)}

    def quarantined(self) -> set[str]:
        """Replicas the router's quarantine manager has marked
        (``{ns}/quarantined/{rid}``): alive and heartbeating, but
        excluded from dispatch while golden probes decide their fate —
        so their capacity is MISSING and the fleet must backfill."""
        prefix = f"{self.ns}/quarantined/"
        return {k[len(prefix):] for k in self.client.keys(prefix)}

    def _registrations(self) -> dict[str, dict]:
        out = {}
        prefix = f"{self.ns}/replica/"
        for key in self.client.keys(prefix):
            raw = self.client.get(key)
            if raw is not None:
                out[key[len(prefix):]] = json.loads(raw.decode())
        return out

    def _pool_rids(self, regs: dict[str, dict]) -> set[str] | None:
        """Replicas this instance manages: ``None`` means ALL (the
        unified loop); a pool-scoped loop keeps only registrations
        carrying its role.  A live-but-unregistered joiner is invisible
        until it registers — its capacity-on-the-way is already counted
        through :meth:`_pending_joiners`."""
        if self.pool is None:
            return None
        return {rid for rid, info in regs.items()
                if info.get("role", "both") == self.pool}

    def _observe(self) -> dict:
        """The merged fleet view one decision is made from (pool-scoped
        instances see only their own pool's replicas and metrics)."""
        live = self.live()
        draining = self.draining()
        quarantined = self.quarantined()
        regs = self._registrations()
        # membership cutoff: only ranks still registered in
        # {ns}/replica/* contribute snapshots.  A departed publisher's
        # final sliding-window histogram otherwise stays pinned in the
        # merged quantiles until max_age_s — a dead replica's queue
        # waits steering live scaling decisions.  No registrations at
        # all means no membership information (a bare metrics-only
        # fleet): fall back to the age cutoff alone.
        members: set[int] | None = None
        if regs:
            members = set()
            for info in regs.values():
                try:
                    members.add(int(info.get("rank")))
                except (TypeError, ValueError):
                    continue
        snaps = collect(self.client, f"{self.ns}/metrics",
                        max_age_s=self.cfg.max_metric_age_s,
                        members=members)
        mine = self._pool_rids(regs)
        if mine is not None:
            live &= mine
            draining &= mine
            quarantined &= mine
            rank_to_rid = {int(info.get("rank", -1)): rid
                           for rid, info in regs.items()}
            snaps = {rank: s for rank, s in snaps.items()
                     if rank_to_rid.get(rank) in mine}
        merged = merge_snapshots(snaps)
        wait = merged["histograms"].get("serve/queue_wait_s")
        wait_q = (hist_quantile(wait, self.cfg.quantile)
                  if wait and wait["count"] else 0.0)
        if math.isnan(wait_q):
            wait_q = 0.0
        depth = (merged["gauges"].get("serve/queue_depth")
                 or {}).get("value") or 0.0
        free = (merged["gauges"].get("serve/kv_blocks_free")
                or {}).get("value")
        used = (merged["gauges"].get("serve/kv_blocks_used")
                or {}).get("value")
        kv_free_frac = (free / (free + used)
                        if free is not None and used is not None
                        and free + used > 0 else None)
        tier_bytes = (merged["gauges"].get("serve/tier_bytes")
                      or {}).get("value")
        tier_budget = (merged["gauges"].get("serve/tier_budget_bytes")
                       or {}).get("value")
        tier_headroom_frac = (1.0 - tier_bytes / tier_budget
                              if tier_bytes is not None
                              and tier_budget else None)
        # burn rate: worst across the fleet's published slo/burn_rate_*
        # gauges (per_worker max — summing rates across replicas would
        # overstate) and the local tracker's shortest window (a rank-0
        # router records its own terminal decisions into obs.slo)
        burn = 0.0
        for name, g in merged["gauges"].items():
            if name.startswith("slo/burn_rate_"):
                vals = [v for v in g.get("per_worker", {}).values()
                        if v is not None]
                if vals:
                    burn = max(burn, max(vals))
        local = obs.slo.burn_rates()
        if local:
            burn = max(burn, local[min(local)])
        return {"live": live, "draining": draining,
                "quarantined": quarantined, "wait_q": wait_q,
                "queue_depth": depth, "kv_blocks_free": free,
                "kv_free_frac": kv_free_frac,
                "tier_headroom_frac": tier_headroom_frac,
                "burn_rate": burn, "snaps": snaps}

    def _pending_joiners(self, live: set[str]) -> list:
        """Spawned-but-not-yet-heartbeating joiners: count them toward
        the max bound (and as capacity-on-the-way) so a breach episode
        during a joiner's compile doesn't stack a second scale-up."""
        return [p for p in self.procs
                if p.poll() is None
                and f"r{getattr(p, 'replica_index', -1)}" not in live]

    # -- the drain state machine (one tick per poll) -----------------------

    def _tick_drains(self, live: set[str], draining: set[str],
                     snaps: dict[int, dict] | None = None) -> None:
        """Advance in-progress graceful drains: a draining replica with
        an empty inbox gets its targeted stop key (its close path
        finishes all accepted work first — zero loss); one whose lease
        is gone gets its coordination residue swept.

        A drain finishes two ways: the work COMPLETES in place, or —
        fast drain, ``preempt="migrate"`` replicas — the work MIGRATES
        out as ``reason="migrate"`` commits the router redispatches.
        The drain decision therefore observes BOTH signals: inbox
        empty, or the victim advertising migrated-out-empty (its
        ``serve/migrated_out`` counter grew since the drain began and
        its queue-depth gauge is back to zero).  Without the second
        condition a fast drain deadlocks: the inbox can hold a key
        that raced the drain flag in while every completion the state
        machine is waiting for already left the replica.  Stopping on
        the migrated-out signal is still zero-loss — unconsumed inbox
        keys are swept and redispatched by the router's drain-departure
        path."""
        regs = self._registrations()
        rank_to_rid = {int(info.get("rank", -1)): rid
                       for rid, info in regs.items()}
        mig: dict[str, tuple[float, float]] = {}
        for rank, snap in (snaps or {}).items():
            rid = rank_to_rid.get(rank)
            if rid is None:
                continue
            mig[rid] = (
                (snap.get("counters", {}).get("serve/migrated_out")
                 or {}).get("value") or 0.0,
                (snap.get("gauges", {}).get("serve/queue_depth")
                 or {}).get("value") or 0.0)
        # union with the loop's own memory: the router's drain-
        # departure path may sweep the coord key first (it polls on the
        # request path and usually wins the race) — completion must be
        # counted either way
        for rid in sorted(draining | self._drains):
            if rid in live:
                migrated_clear = False
                if rid in mig:
                    out, depth = mig[rid]
                    base = self._drain_mig_base.setdefault(rid, out)
                    last = self._drain_mig_last.get(rid, base)
                    if out > last:
                        self._obs_drain_migrations.inc(out - last)
                        self._drain_mig_last[rid] = out
                    migrated_clear = out > base and depth <= 0.0
                if (self.client.get(f"{self.ns}/stop/{rid}") is None
                        and (migrated_clear or not self.client.keys(
                            f"{self.ns}/inbox/{rid}/"))):
                    self.client.set(f"{self.ns}/stop/{rid}", b"1")
                    log.info("autoscale: replica %s %s; stopping it",
                             rid, "migrated its work out"
                             if migrated_clear else "inbox empty")
                continue
            for key in (f"{self.ns}/draining/{rid}",
                        f"{self.ns}/stop/{rid}",
                        f"{self.ns}/replica/{rid}",
                        f"{self.ns}/metrics/"
                        f"{regs.get(rid, {}).get('rank')}"):
                try:
                    self.client.delete(key)
                except OSError:
                    pass
            self._drains.discard(rid)
            self._drain_mig_base.pop(rid, None)
            self._drain_mig_last.pop(rid, None)
            self._obs_drained.inc()
            log.info("autoscale: replica %s drain complete", rid)

    def _pick_victim(self, active: set[str],
                     snaps: dict[int, dict]) -> str | None:
        """Least-loaded active replica: fewest queued requests, then
        most free KV blocks — draining it strands the least work."""
        regs = self._registrations()
        rank_to_rid = {int(info.get("rank", -1)): rid
                       for rid, info in regs.items()}
        scores: dict[str, tuple] = {}
        for rank, snap in snaps.items():
            rid = rank_to_rid.get(rank)
            if rid not in active:
                continue
            gauges = snap.get("gauges", {})
            depth = (gauges.get("serve/queue_depth") or {}).get(
                "value") or 0.0
            free = (gauges.get("serve/kv_blocks_free") or {}).get("value")
            scores[rid] = (depth, -(free if free is not None
                                    else float("inf")))
        if not scores:
            return sorted(active)[0] if active else None
        return min(sorted(scores), key=lambda r: scores[r])

    # -- one control decision ----------------------------------------------

    def poll(self) -> dict:
        """Observe -> decide -> act, once.  Returns the decision record
        (tests assert on it; the bench logs it)."""
        faults.autoscale_poll()
        self._obs_polls.inc()
        try:
            view = self._observe()
        except ConnectionError as err:
            # coord brownout: the STORE is the unreachable thing, not
            # the fleet.  No scaling verdict is safe on blind data —
            # reset both hysteresis streaks (they must re-earn their
            # polls against fresh observations) and record a suppressed
            # poll instead of an action.
            self._breach = 0
            self._idle = 0
            self._obs_suppressed.inc()
            record = {"action": None, "pool": self.pool,
                      "suppressed": True,
                      "error": str(err), "poll": self._poll_n,
                      "t": self._clock()}
            self._poll_n += 1
            self.decision_log.append(record)
            if len(self.decision_log) > self.decision_log_max:
                del self.decision_log[:-self.decision_log_max]
            log.warning("autoscale: coord store unreachable (%s); "
                        "suppressing this poll", err)
            return record
        live, draining = view["live"], view["draining"]
        self._tick_drains(live, draining, view["snaps"])
        # quarantined capacity is MISSING capacity: the router will not
        # dispatch to it, so counting it would starve the backfill —
        # and it must never be picked as a scale-down victim (it is
        # already out of rotation; draining it would mask the probe
        # verdict that decides whether it comes back)
        active = live - draining - view["quarantined"]
        pending = self._pending_joiners(live)
        now = self._clock()
        action = None

        # breach detection reads FIRED ALERTS, not inline thresholds:
        # the poll records its observations into the private TSDB and
        # the rule set from autoscale_rules(cfg) — the same engine the
        # fleet operator rules run on — says which pressures hold.
        # Missing signals are NaN samples (match no predicate), so the
        # decision is identical to the historical inline comparisons.
        nan = float("nan")
        self._tsdb.record("autoscale/wait_q", view["wait_q"], t=now)
        self._tsdb.record("autoscale/burn_rate", view["burn_rate"], t=now)
        self._tsdb.record(
            "autoscale/kv_free_frac",
            view["kv_free_frac"] if view["kv_free_frac"] is not None
            else nan, t=now)
        self._tsdb.record(
            "autoscale/tier_headroom_frac",
            view["tier_headroom_frac"]
            if view["tier_headroom_frac"] is not None else nan, t=now)
        self.alerts.evaluate(now)
        fired = {a["rule"] for a in self.alerts.firing()}
        burning = "AutoscaleBurnRate" in fired
        # decode-pool pressure: resident KV, not queue wait — scale up
        # BEFORE admissions stall on pages
        starved = "AutoscaleKVStarved" in fired
        # tiered-KV pressure: spill tiers nearly full means warm
        # prefixes are about to be DISCARDED, not spilled — the
        # re-prefill load arrives before queue wait shows it
        tier_pressed = "AutoscaleTierPressure" in fired
        if "AutoscaleQueueWait" in fired or burning \
                or starved or tier_pressed:
            self._breach += 1
            self._idle = 0
        elif (view["wait_q"] < self.cfg.low_wait_s
              and view["queue_depth"] <= 0):
            self._idle += 1
            self._breach = 0
        else:
            # the hysteresis band: neither direction makes progress
            self._breach = 0
            self._idle = 0

        capacity = len(active) + len(pending)
        if (self._breach >= self.cfg.breach_polls
                and capacity < self.cfg.max_replicas
                and (self._last_up is None
                     or now - self._last_up >= self.cfg.up_cooldown_s)):
            n = min(self.cfg.step, self.cfg.max_replicas - capacity)
            why = ("kv_free_frac=%.2f < %.2f" % (
                       view["kv_free_frac"], self.cfg.min_kv_free_frac)
                   if starved else
                   "tier_headroom=%.2f < %.2f" % (
                       view["tier_headroom_frac"],
                       self.cfg.min_tier_headroom_frac)
                   if tier_pressed else
                   "wait p%d=%.3fs > target %.3fs" % (
                       int(self.cfg.quantile * 100), view["wait_q"],
                       self.cfg.target_wait_s))
            log.info("autoscale%s: %s for %d polls; scaling up by %d "
                     "(active=%d pending=%d)",
                     "" if self.pool is None else f"[{self.pool}]", why,
                     self._breach, n, len(active), len(pending))
            self.procs.extend(self.spawner(n))
            self._obs_ups.inc(n)
            self._last_up = now
            self._breach = 0
            action = ("up", n)
        elif (self._idle >= self.cfg.idle_polls
                and len(active) > self.cfg.min_replicas
                and not draining   # one graceful drain at a time
                and not pending
                and (self._last_down is None
                     or now - self._last_down
                     >= self.cfg.down_cooldown_s)):
            victim = self._pick_victim(active, view["snaps"])
            if victim is not None:
                log.info("autoscale: idle for %d polls (wait=%.3fs); "
                         "draining %s down", self._idle, view["wait_q"],
                         victim)
                self.client.set(f"{self.ns}/draining/{victim}", b"1")
                self._drains.add(victim)
                self._obs_downs.inc()
                self._last_down = now
                self._idle = 0
                action = ("down", victim)

        self._obs_replicas.set(len(active))
        self._obs_wait.set(view["wait_q"])
        self._obs_breach.set(self._breach)
        self._obs_idle.set(self._idle)
        self._obs_burn.set(view["burn_rate"])
        record = {"action": action, "pool": self.pool,
                  "wait_q": view["wait_q"],
                  "active": sorted(active), "draining": sorted(draining),
                  "quarantined": sorted(view["quarantined"]),
                  "pending": len(pending),
                  "queue_depth": view["queue_depth"],
                  "kv_free_frac": view["kv_free_frac"],
                  "burn_rate": view["burn_rate"],
                  "breach": self._breach, "idle": self._idle,
                  "poll": self._poll_n, "t": now}
        self._poll_n += 1
        self.decision_log.append(record)
        if len(self.decision_log) > self.decision_log_max:
            del self.decision_log[:-self.decision_log_max]
        return record

    def action_seq(self) -> list[dict]:
        """The non-None decisions, in order: ``[{"poll", "t", "kind",
        "arg"}, ...]`` — the compact sequence the simulator-vs-live
        agreement check compares (a drain victim's rid is live-run
        specific, so ``arg`` keeps only scale-up counts)."""
        out = []
        for r in self.decision_log:
            if r["action"] is None:
                continue
            kind, arg = r["action"]
            out.append({"poll": r["poll"], "t": r["t"], "kind": kind,
                        "arg": (arg if kind == "up" else None)})
        return out

    # -- background loop ---------------------------------------------------

    def start(self) -> None:
        """Run :meth:`poll` on ``config.poll_s`` cadence in a daemon
        thread until :meth:`stop`.  Poll errors are logged and retried
        next tick — a flaky coord RPC must not kill the control
        plane."""
        if self._thread is not None:
            return
        self._stop.clear()

        # treat loop start as the most recent scale-down: a freshly
        # started control plane sees an idle fleet for the first few
        # polls (no traffic has produced metrics yet) and must not
        # drain capacity before down_cooldown_s of real observation
        if self._last_down is None:
            self._last_down = self._clock()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.poll()
                except Exception as e:  # noqa: BLE001
                    # the control plane must outlive any single bad
                    # poll (flaky RPC, torn metrics JSON, ...)
                    log.warning("autoscale: poll failed (%r); retrying "
                                "next tick", e)
                self._stop.wait(self.cfg.poll_s)

        self._thread = threading.Thread(target=loop,
                                        name="tpudist-autoscaler",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
