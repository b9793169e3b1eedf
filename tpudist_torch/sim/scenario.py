"""Declarative serve-fleet scenarios and their SLO envelopes (counterpart
of :mod:`tpudist.sim.scenario`; the scenario names and numbers are
tpudist's, letter for letter, and the module imports the stdlib only).

A :class:`ScenarioSpec` is the replayable unit of "as many scenarios as
you can imagine": one document describing a workload SHAPE (arrival
process, prompt-length distribution, token budgets, deadline
distribution, tenant mix), the fleet it runs against (replica count,
service rates, autoscaler policy), and the :class:`Envelope` of SLO
outcomes the run must land inside.  The same spec drives both
execution paths:

* the LIVE replayer (:func:`tpudist_torch.sim.workload.synthesize` ->
  ``Router.run(requests, arrivals=...)``) — real replicas, real chaos;
* the OFFLINE simulator (:class:`tpudist_torch.sim.simulator.FleetSim`) —
  the real router/autoscaler policy code against simulated replicas,
  seconds instead of chaos-bench minutes.

Specs are plain dicts (JSON-shaped) parsed by
:meth:`ScenarioSpec.from_dict`, which REJECTS unknown keys — a typo'd
knob must fail parsing, not silently run the default scenario.
``BUILTIN`` holds the named scenario matrix CI runs on every push;
each entry's envelope is its regression gate.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

__all__ = ["ScenarioSpec", "Envelope", "BUILTIN", "builtin", "names"]

ARRIVAL_KINDS = ("constant", "diurnal", "flash_crowd")
PROMPT_KINDS = ("uniform", "longtail")
DEADLINE_KINDS = ("none", "uniform", "adversarial")
# the FaultScript verbs, mirroring the TPUDIST_FAULT_* env knobs:
# KILL_AFTER_SEGMENTS, HEARTBEAT_STOP_AFTER_S, COORD_OUTAGE_AT_S/_S,
# ROUTER_KILL_AFTER_POLLS, FLIP_WIRE_BITS respectively
FAULT_KINDS = ("kill_replica", "drop_heartbeats", "coord_brownout",
               "kill_router", "corrupt_replica")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"scenario spec: {msg}")


def _check_keys(what: str, d: dict, allowed: set[str],
                required: set[str] = frozenset()) -> None:
    _require(isinstance(d, dict), f"{what} must be a dict, got {d!r}")
    unknown = set(d) - allowed
    _require(not unknown, f"{what} has unknown keys {sorted(unknown)} "
                          f"(allowed: {sorted(allowed)})")
    missing = required - set(d)
    _require(not missing, f"{what} missing required keys "
                          f"{sorted(missing)}")


def _validate_arrival(a: dict) -> None:
    _check_keys("arrival", a,
                {"kind", "rate", "base_rate", "peak_rate", "period_s",
                 "spike_rate", "spike_at_s", "spike_width_s"}, {"kind"})
    kind = a["kind"]
    _require(kind in ARRIVAL_KINDS,
             f"arrival.kind {kind!r} not in {ARRIVAL_KINDS}")
    if kind == "constant":
        _require(float(a.get("rate", 0)) > 0, "constant needs rate > 0")
    elif kind == "diurnal":
        base = float(a.get("base_rate", 0))
        peak = float(a.get("peak_rate", 0))
        _require(0 < base <= peak,
                 f"diurnal needs 0 < base_rate <= peak_rate, got "
                 f"{base}/{peak}")
        _require(float(a.get("period_s", 0)) > 0,
                 "diurnal needs period_s > 0")
    elif kind == "flash_crowd":
        _require(float(a.get("base_rate", 0)) > 0,
                 "flash_crowd needs base_rate > 0")
        _require(float(a.get("spike_rate", 0))
                 > float(a.get("base_rate", 0)),
                 "flash_crowd needs spike_rate > base_rate")
        _require(float(a.get("spike_width_s", 0)) > 0,
                 "flash_crowd needs spike_width_s > 0")


def _validate_prompt(p: dict) -> None:
    _check_keys("prompt", p,
                {"kind", "lo", "hi", "typical", "tail", "tail_frac"},
                {"kind"})
    kind = p["kind"]
    _require(kind in PROMPT_KINDS,
             f"prompt.kind {kind!r} not in {PROMPT_KINDS}")
    if kind == "uniform":
        lo, hi = int(p.get("lo", 0)), int(p.get("hi", 0))
        _require(0 < lo <= hi, f"prompt needs 0 < lo <= hi, got {lo}/{hi}")
    else:
        lo = int(p.get("lo", 0))
        typ = int(p.get("typical", 0))
        tail = int(p.get("tail", 0))
        frac = float(p.get("tail_frac", 0.05))
        _require(0 < lo <= typ < tail,
                 f"longtail needs 0 < lo <= typical < tail, got "
                 f"{lo}/{typ}/{tail}")
        _require(0.0 < frac < 1.0,
                 f"longtail tail_frac must be in (0, 1), got {frac}")


def _validate_deadline(d: dict) -> None:
    _check_keys("deadline", d,
                {"kind", "lo", "hi", "tight_frac", "tight_s", "loose_s"},
                {"kind"})
    kind = d["kind"]
    _require(kind in DEADLINE_KINDS,
             f"deadline.kind {kind!r} not in {DEADLINE_KINDS}")
    if kind == "uniform":
        lo, hi = float(d.get("lo", 0)), float(d.get("hi", 0))
        _require(0 < lo <= hi,
                 f"deadline needs 0 < lo <= hi, got {lo}/{hi}")
    elif kind == "adversarial":
        _require(0.0 < float(d.get("tight_frac", 0)) < 1.0,
                 "adversarial needs tight_frac in (0, 1)")
        _require(0 < float(d.get("tight_s", 0))
                 < float(d.get("loose_s", 0)),
                 "adversarial needs 0 < tight_s < loose_s")


def _validate_tenant(t: dict) -> None:
    _check_keys("tenant", t,
                {"name", "weight", "prefix_tokens", "priority"},
                {"name", "weight"})
    _require(float(t["weight"]) > 0,
             f"tenant {t.get('name')!r} needs weight > 0")
    _require(int(t.get("prefix_tokens", 0)) >= 0,
             "tenant prefix_tokens must be >= 0")


def _validate_fault(f: dict) -> None:
    _check_keys("fault", f,
                {"kind", "at_s", "for_s", "rid", "at_poll", "every",
                 "count"}, {"kind"})
    kind = f["kind"]
    _require(kind in FAULT_KINDS,
             f"fault.kind {kind!r} not in {FAULT_KINDS}")
    if kind == "kill_replica":
        _check_keys("fault(kill_replica)", f, {"kind", "at_s", "rid"},
                    {"kind", "at_s", "rid"})
        _require(float(f["at_s"]) >= 0, "kill_replica needs at_s >= 0")
    elif kind == "drop_heartbeats":
        _check_keys("fault(drop_heartbeats)", f,
                    {"kind", "at_s", "for_s", "rid"},
                    {"kind", "at_s", "for_s", "rid"})
        _require(float(f["at_s"]) >= 0,
                 "drop_heartbeats needs at_s >= 0")
        _require(float(f["for_s"]) > 0,
                 "drop_heartbeats needs for_s > 0")
    elif kind == "coord_brownout":
        _check_keys("fault(coord_brownout)", f,
                    {"kind", "at_s", "for_s"}, {"kind", "at_s", "for_s"})
        _require(float(f["at_s"]) >= 0,
                 "coord_brownout needs at_s >= 0")
        _require(float(f["for_s"]) > 0,
                 "coord_brownout needs for_s > 0")
    elif kind == "kill_router":
        _check_keys("fault(kill_router)", f, {"kind", "at_poll"},
                    {"kind", "at_poll"})
        _require(int(f["at_poll"]) >= 1,
                 "kill_router needs at_poll >= 1")
    elif kind == "corrupt_replica":
        # byzantine replica: from at_s, every Nth committed payload has
        # a byte flipped AFTER framing (so the wire checksum is what
        # catches it); an optional count cap lets the replica "heal" —
        # the path golden-probe reinstatement is gated on
        _check_keys("fault(corrupt_replica)", f,
                    {"kind", "at_s", "rid", "every", "count"},
                    {"kind", "at_s", "rid"})
        _require(float(f["at_s"]) >= 0,
                 "corrupt_replica needs at_s >= 0")
        _require(int(f.get("every", 1)) >= 1,
                 "corrupt_replica needs every >= 1")
        _require(f.get("count") is None or int(f["count"]) >= 1,
                 "corrupt_replica count must be >= 1 when set")


_FLEET_DEFAULTS: dict[str, Any] = {
    "replicas": 1,
    "seconds_per_token": 0.002,
    "prefill_s": 0.005,
    "prefill_per_token_s": 0.0002,
    "warmup_s": 2.0,
    "publish_interval_s": 0.25,
    "wait_window_s": 15.0,
    "router_poll_s": 0.05,
    "autoscale": None,          # dict of AutoscaleConfig overrides
    # disaggregated fleet: when prefill_replicas > 0 the fleet splits
    # into a prefill pool and a decode pool (``replicas`` is ignored)
    # and each pool can run its own autoscaler policy — the two-signal
    # split the live Autoscaler(pool=...) instances implement
    "prefill_replicas": 0,
    "decode_replicas": 0,
    "autoscale_prefill": None,
    "autoscale_decode": None,
    # per-replica KV capacity the sim's decode occupancy model publishes
    # through serve/kv_blocks_{used,free} (0 disables the gauges)
    "kv_blocks_total": 0,
    # tiered-KV model: per-replica "HBM" prefix-chain
    # capacity in 16-token blocks (0 disables the chain model entirely)
    # and the host-tier capacity its LRU spills land in
    "prefix_cache_blocks": 0,
    "tier_blocks": 0,
    # priority preemption: "migrate" turns on the replicas'
    # pause/resume flow model — a higher-priority arrival preempts the
    # running best-effort request instead of queueing behind it, the
    # sim mirror of ``ServeLoop(preempt="migrate")``
    "preempt": "degrade",
    # observability plane: cadence of the real
    # scrape->TSDB->alert-rules path every sim runs on the virtual
    # clock (the default rule set from tpudist_torch.obs.alerts; the
    # scenario's envelope.alerts pins which rules must/must not fire)
    "alert_scrape_s": 1.0,
}


@dataclass(frozen=True)
class Envelope:
    """The per-scenario SLO gate, asserted against the summary row a
    run emits (live bench or offline simulator — same schema).

    ``None`` bounds are unchecked.  ``decisions`` bounds the router's
    terminal decision counters: ``{"shed": {"min": 1, "max": 10}}``."""

    max_lost: int = 0
    max_p99_queue_wait_s: float | None = None
    max_recovery_s: float | None = None
    min_scale_ups: int = 0
    max_scale_ups: int | None = None
    min_drains: int = 0
    max_priority_bad: int | None = None
    max_burn_rate_300s: float | None = None
    max_replica_deaths: int | None = None
    min_router_recoveries: int = 0
    # data-plane integrity gates: quarantines the run must produce (a
    # corruption scenario that never quarantines is a failed detection),
    # reinstatements it must earn back, and the hard ceiling on
    # CORRUPTED terminals actually delivered to callers (0 is the whole
    # point of the checksummed wire)
    min_quarantines: int = 0
    min_reinstated: int = 0
    max_corrupted_terminals: int | None = None
    # prefix-cache affinity gate: the fleet-level hit rate a
    # shared-prefix workload must sustain — checked only when the row
    # reports one (a workload with no stamped hashes is exempt, not
    # failing at 0.0)
    min_prefix_hit_rate: float | None = None
    # tiered-KV gate: the fleet-wide BLOCK-level reuse rate
    # (local HBM + host-tier re-admit + peer pull, over all admitted
    # chain blocks) a cold-heavy shared-prefix workload must sustain —
    # checked only when the row reports one (the chain model off is
    # exempt, not failing at 0.0)
    min_global_hit_rate: float | None = None
    # disaggregated-serving gates: the TTFT ceiling the
    # prefill pool must hold under the mixed-length workload, and the
    # per-pool scale-up floors that prove the two control loops sized
    # their pools INDEPENDENTLY (one shared loop would show one signal)
    max_p99_ttft_s: float | None = None
    min_scale_ups_prefill: int = 0
    min_scale_ups_decode: int = 0
    # preemption gates: the queue-wait tail the PRIORITY
    # class alone must hold (the number preemption exists to protect —
    # the overall p99 is dominated by paused best-effort traffic and
    # would hide the win), and the preemption-volume floor that proves
    # the pause path actually ran rather than the fleet being oversized
    max_p99_priority_wait_s: float | None = None
    min_preemptions: int = 0
    decisions: dict = field(default_factory=dict)
    # alert-envelope: which alert RULES the run's real
    # scrape->TSDB->evaluate path must (and must not) have fired, read
    # from the row's ``alerts_fired`` list.  ``{"must_fire":
    # ["CoordOutage"], "must_not_fire": "*"}`` — the "*" wildcard means
    # any fired rule outside must_fire is a violation (the
    # zero-false-positive gate steady_state runs under).
    alerts: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "Envelope":
        allowed = {f.name for f in dataclasses.fields(cls)}
        _check_keys("envelope", d, allowed)
        dec = d.get("decisions", {})
        for reason, bound in dec.items():
            _check_keys(f"envelope.decisions[{reason!r}]", bound,
                        {"min", "max"})
        al = d.get("alerts", {})
        _check_keys("envelope.alerts", al, {"must_fire", "must_not_fire"})
        mnf = al.get("must_not_fire", [])
        _require(mnf == "*" or isinstance(mnf, (list, tuple)),
                 "envelope.alerts.must_not_fire must be a rule list "
                 "or the wildcard \"*\"")
        return cls(**d)

    def check(self, row: dict) -> list[str]:
        """Violations of this envelope in a scenario summary ``row``
        (empty list = the run landed inside the envelope)."""
        bad: list[str] = []

        def num(key, default=0.0):
            v = row.get(key)
            return default if v is None else float(v)

        lost = num("lost_requests")
        if lost > self.max_lost:
            bad.append(f"lost_requests={lost:g} > max_lost={self.max_lost}")
        if self.max_p99_queue_wait_s is not None:
            p99 = num("p99_queue_wait_s")
            if p99 > self.max_p99_queue_wait_s:
                bad.append(f"p99_queue_wait_s={p99:.4g} > "
                           f"{self.max_p99_queue_wait_s}")
        if self.max_recovery_s is not None:
            rec = num("recovery_s")
            if rec > self.max_recovery_s:
                bad.append(f"recovery_s={rec:.4g} > {self.max_recovery_s}")
        ups = num("scale_ups")
        if ups < self.min_scale_ups:
            bad.append(f"scale_ups={ups:g} < min {self.min_scale_ups}")
        if self.max_scale_ups is not None and ups > self.max_scale_ups:
            bad.append(f"scale_ups={ups:g} > max {self.max_scale_ups}")
        if num("drains") < self.min_drains:
            bad.append(f"drains={num('drains'):g} < min {self.min_drains}")
        if self.max_priority_bad is not None:
            pb = num("priority_bad")
            if pb > self.max_priority_bad:
                bad.append(f"priority_bad={pb:g} > "
                           f"{self.max_priority_bad}")
        if self.max_burn_rate_300s is not None:
            br = num("burn_rate_300s")
            if br > self.max_burn_rate_300s:
                bad.append(f"burn_rate_300s={br:.4g} > "
                           f"{self.max_burn_rate_300s}")
        if self.max_replica_deaths is not None:
            deaths = num("replica_deaths")
            if deaths > self.max_replica_deaths:
                bad.append(f"replica_deaths={deaths:g} > "
                           f"{self.max_replica_deaths}")
        recov = num("router_recoveries")
        if recov < self.min_router_recoveries:
            bad.append(f"router_recoveries={recov:g} < min "
                       f"{self.min_router_recoveries}")
        if num("quarantines") < self.min_quarantines:
            bad.append(f"quarantines={num('quarantines'):g} < min "
                       f"{self.min_quarantines}")
        if num("reinstated") < self.min_reinstated:
            bad.append(f"reinstated={num('reinstated'):g} < min "
                       f"{self.min_reinstated}")
        if self.max_corrupted_terminals is not None:
            ct = num("corrupted_terminals")
            if ct > self.max_corrupted_terminals:
                bad.append(f"corrupted_terminals={ct:g} > "
                           f"{self.max_corrupted_terminals}")
        if (self.min_prefix_hit_rate is not None
                and row.get("prefix_hit_rate") is not None):
            phr = num("prefix_hit_rate")
            if phr < self.min_prefix_hit_rate:
                bad.append(f"prefix_hit_rate={phr:.4g} < min "
                           f"{self.min_prefix_hit_rate}")
        if (self.min_global_hit_rate is not None
                and row.get("global_hit_rate") is not None):
            ghr = num("global_hit_rate")
            if ghr < self.min_global_hit_rate:
                bad.append(f"global_hit_rate={ghr:.4g} < min "
                           f"{self.min_global_hit_rate}")
        if self.max_p99_ttft_s is not None:
            ttft = num("p99_ttft_s")
            if ttft > self.max_p99_ttft_s:
                bad.append(f"p99_ttft_s={ttft:.4g} > "
                           f"{self.max_p99_ttft_s}")
        if self.max_p99_priority_wait_s is not None:
            pw = num("p99_priority_wait_s")
            if pw > self.max_p99_priority_wait_s:
                bad.append(f"p99_priority_wait_s={pw:.4g} > "
                           f"{self.max_p99_priority_wait_s}")
        if num("preemptions") < self.min_preemptions:
            bad.append(f"preemptions={num('preemptions'):g} < min "
                       f"{self.min_preemptions}")
        for pool in ("prefill", "decode"):
            floor = getattr(self, f"min_scale_ups_{pool}")
            v = num(f"scale_ups_{pool}")
            if v < floor:
                bad.append(f"scale_ups_{pool}={v:g} < min {floor}")
        for reason, bound in self.decisions.items():
            v = num(f"decisions_{reason}")
            lo, hi = bound.get("min"), bound.get("max")
            if lo is not None and v < lo:
                bad.append(f"decisions_{reason}={v:g} < min {lo}")
            if hi is not None and v > hi:
                bad.append(f"decisions_{reason}={v:g} > max {hi}")
        if self.alerts:
            fired = row.get("alerts_fired")
            if fired is None:
                bad.append("alerts envelope set but the row carries no "
                           "alerts_fired (alert plane did not run)")
            else:
                fired = set(fired)
                must = list(self.alerts.get("must_fire", []))
                for rule in must:
                    if rule not in fired:
                        bad.append(f"alert {rule} did not fire "
                                   f"(fired: {sorted(fired) or 'none'})")
                must_not = self.alerts.get("must_not_fire", [])
                if must_not == "*":
                    extra = fired - set(must)
                    if extra:
                        bad.append("unexpected alerts fired: "
                                   f"{sorted(extra)}")
                else:
                    for rule in must_not:
                        if rule in fired:
                            bad.append(f"alert {rule} fired but is in "
                                       f"must_not_fire")
        return bad


@dataclass(frozen=True)
class ScenarioSpec:
    """One named, seeded, replayable scenario (see module docstring)."""

    name: str
    duration_s: float
    arrival: dict
    prompt: dict = field(
        default_factory=lambda: {"kind": "uniform", "lo": 4, "hi": 12})
    max_new: dict = field(
        default_factory=lambda: {"kind": "uniform", "lo": 8, "hi": 24})
    deadline: dict = field(default_factory=lambda: {"kind": "none"})
    tenants: tuple = ()
    faults: tuple = ()
    seed: int = 0
    fleet: dict = field(default_factory=dict)
    envelope: Envelope = field(default_factory=Envelope)

    def __post_init__(self):
        _require(bool(self.name), "name must be non-empty")
        _require(self.duration_s > 0,
                 f"duration_s must be > 0, got {self.duration_s}")
        _validate_arrival(self.arrival)
        _validate_prompt(self.prompt)
        _check_keys("max_new", self.max_new, {"kind", "lo", "hi", "value"},
                    {"kind"})
        _require(self.max_new["kind"] in ("uniform", "const"),
                 f"max_new.kind {self.max_new['kind']!r} not in "
                 f"('uniform', 'const')")
        if self.max_new["kind"] == "uniform":
            lo = int(self.max_new.get("lo", 0))
            hi = int(self.max_new.get("hi", 0))
            _require(0 < lo <= hi,
                     f"max_new needs 0 < lo <= hi, got {lo}/{hi}")
        else:
            _require(int(self.max_new.get("value", 0)) > 0,
                     "max_new const needs value > 0")
        _validate_deadline(self.deadline)
        for t in self.tenants:
            _validate_tenant(t)
        for f in self.faults:
            _validate_fault(f)
        _require(sum(1 for f in self.faults
                     if f["kind"] == "kill_router") <= 1,
                 "at most one kill_router fault per scenario")
        _check_keys("fleet", self.fleet, set(_FLEET_DEFAULTS))
        merged = {**_FLEET_DEFAULTS, **self.fleet}
        if int(merged["prefill_replicas"]) > 0:
            _require(int(merged["decode_replicas"]) >= 1,
                     "a disaggregated fleet needs decode_replicas >= 1")
        else:
            _require(int(merged["decode_replicas"]) == 0
                     and merged["autoscale_prefill"] is None
                     and merged["autoscale_decode"] is None,
                     "decode_replicas / per-pool autoscale need "
                     "prefill_replicas >= 1")
            _require(int(merged["replicas"]) >= 1,
                     "fleet.replicas must be >= 1")
        _require(float(merged["seconds_per_token"]) > 0,
                 "fleet.seconds_per_token must be > 0")
        _require(merged["preempt"] in ("degrade", "migrate"),
                 f"fleet.preempt must be 'degrade' or 'migrate', "
                 f"got {merged['preempt']!r}")
        # frozen dataclass: route the normalized fleet through __setattr__
        object.__setattr__(self, "fleet", merged)
        object.__setattr__(self, "tenants", tuple(self.tenants))
        object.__setattr__(self, "faults", tuple(self.faults))

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        allowed = {f.name for f in dataclasses.fields(cls)}
        _check_keys(f"scenario {d.get('name', '?')!r}", d, allowed,
                    {"name", "duration_s", "arrival"})
        kw = dict(d)
        env = kw.pop("envelope", None)
        if env is not None and not isinstance(env, Envelope):
            env = Envelope.from_dict(env)
        return cls(**kw, **({"envelope": env} if env is not None else {}))

    @classmethod
    def from_json(cls, path: str) -> "ScenarioSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tenants"] = list(self.tenants)
        d["faults"] = list(self.faults)
        return d


# -- the named scenario matrix (the CI regression suite) --------------------
#
# Each entry stresses a different policy surface; each envelope is the
# regression gate a future serving PR must keep green.  Rates are sized
# for the offline simulator's default service rate (2 ms/token, ~16
# token budgets => one replica saturates around 20-25 req/s).

_AUTOSCALE_FAST = {
    # scale-up after 3 sustained breach polls at 0.5 s cadence; drain
    # back after a long idle window — sim-seconds, not wall-seconds
    "min_replicas": 1, "max_replicas": 4, "target_wait_s": 0.5,
    "low_wait_s": 0.1, "quantile": 0.9, "breach_polls": 3,
    "idle_polls": 10, "up_cooldown_s": 8.0, "down_cooldown_s": 20.0,
    "poll_s": 0.5, "max_metric_age_s": 10.0,
}

BUILTIN: dict[str, dict] = {
    "steady_state": {
        "name": "steady_state",
        "duration_s": 30.0,
        "arrival": {"kind": "constant", "rate": 8.0},
        "seed": 11,
        "fleet": {"replicas": 1, "autoscale": dict(_AUTOSCALE_FAST)},
        "envelope": {
            "max_lost": 0,
            "max_p99_queue_wait_s": 0.5,
            "max_scale_ups": 0,      # steady load must not flap the fleet
            "decisions": {"completed": {"min": 150}},
            # the alert plane's zero-false-positive gate: a healthy
            # steady fleet must fire NOTHING
            "alerts": {"must_fire": [], "must_not_fire": "*"},
        },
    },
    "diurnal_ramp": {
        "name": "diurnal_ramp",
        "duration_s": 90.0,
        "arrival": {"kind": "diurnal", "base_rate": 3.0,
                    "peak_rate": 40.0, "period_s": 60.0},
        "seed": 12,
        "fleet": {"replicas": 1, "autoscale": dict(_AUTOSCALE_FAST)},
        "envelope": {
            "max_lost": 0,
            "min_scale_ups": 1,      # the ramp must buy capacity
            "min_drains": 1,         # ... and the trough must return it
            "max_recovery_s": 90.0,
            "decisions": {"failed": {"max": 0}},
            # the peak saturates one replica before the scale-up lands,
            # so queue-wait MUST page — and nothing else may
            "alerts": {"must_fire": ["QueueWaitHigh"],
                       "must_not_fire": "*"},
        },
    },
    "flash_crowd": {
        "name": "flash_crowd",
        "duration_s": 60.0,
        "arrival": {"kind": "flash_crowd", "base_rate": 4.0,
                    "spike_rate": 120.0, "spike_at_s": 10.0,
                    "spike_width_s": 4.0},
        "seed": 13,
        "fleet": {"replicas": 1, "autoscale": dict(_AUTOSCALE_FAST)},
        "envelope": {
            "max_lost": 0,
            "min_scale_ups": 1,
            "max_recovery_s": 60.0,  # breach episode must end
            "decisions": {"failed": {"max": 0}},
            "alerts": {"must_fire": ["QueueWaitHigh"],
                       "must_not_fire": "*"},
        },
    },
    "shared_prefix_tenants": {
        "name": "shared_prefix_tenants",
        "duration_s": 30.0,
        "arrival": {"kind": "constant", "rate": 10.0},
        "tenants": [
            {"name": "sysA", "weight": 5.0, "prefix_tokens": 24,
             "priority": 0},
            {"name": "sysB", "weight": 3.0, "prefix_tokens": 48,
             "priority": 0},
            {"name": "paid", "weight": 2.0, "prefix_tokens": 12,
             "priority": 1},
        ],
        "seed": 14,
        "fleet": {"replicas": 2, "autoscale": dict(_AUTOSCALE_FAST)},
        "envelope": {
            "max_lost": 0,
            "max_p99_queue_wait_s": 0.5,
            "max_priority_bad": 0,   # paid traffic burns zero budget
            # the router's prefix-affinity steer must keep tenant
            # traffic landing where its prefix is cached: after each
            # tenant's first admission per replica, everything else
            # should hit (three tenants, two replicas — ≥ 0.5 is a
            # loose floor well below the steady-state rate)
            "min_prefix_hit_rate": 0.5,
            "decisions": {"completed": {"min": 200}},
            "alerts": {"must_fire": [], "must_not_fire": "*"},
        },
    },
    "cold_prefix_tenants": {
        "name": "cold_prefix_tenants",
        "duration_s": 30.0,
        "arrival": {"kind": "constant", "rate": 10.0},
        # eight tenants, each with a 4-block (64-token) system prefix:
        # the fleet-wide prefix working set is 32 blocks, but each
        # replica's "HBM" chain capacity holds only 12 — no single
        # replica can keep every tenant resident, which is exactly the
        # shape the host tier exists for.  LRU churn spills cold
        # tenants' chains into the tier; their next request re-admits
        # from host RAM instead of re-prefilling.  The tier budget is
        # deliberately TIGHT (4 blocks vs the steady ~5-block spill
        # residency): the tier still delivers the hit-rate floor, but
        # runs pinned at capacity — TierHeadroomLow must page
        "tenants": [
            {"name": f"t{i}", "weight": 1.0, "prefix_tokens": 64,
             "priority": 0} for i in range(8)
        ],
        "seed": 22,
        "fleet": {"replicas": 2,
                  "prefix_cache_blocks": 12,
                  "tier_blocks": 4},
        "envelope": {
            "max_lost": 0,
            "max_p99_queue_wait_s": 1.0,
            # the tiered-KV gate: nearly every admitted chain block
            # after each tenant's cold first admission must be reused
            # (local HBM, tier re-admit, or peer pull) — without the
            # tier the 32-block working set thrashes 12-block HBM and
            # this floor is unreachable
            "min_global_hit_rate": 0.8,
            "decisions": {"completed": {"min": 200}},
            "alerts": {"must_fire": ["TierHeadroomLow"],
                       "must_not_fire": "*"},
        },
    },
    "long_tail_prompts": {
        "name": "long_tail_prompts",
        "duration_s": 40.0,
        "arrival": {"kind": "constant", "rate": 8.0},
        "prompt": {"kind": "longtail", "lo": 4, "typical": 16,
                   "tail": 512, "tail_frac": 0.06},
        "seed": 15,
        "fleet": {"replicas": 1, "autoscale": dict(_AUTOSCALE_FAST)},
        "envelope": {
            "max_lost": 0,
            "max_p99_queue_wait_s": 2.0,  # tail prompts queue behind
            "decisions": {"failed": {"max": 0}},
            "alerts": {"must_fire": [], "must_not_fire": "*"},
        },
    },
    "deadline_storm": {
        "name": "deadline_storm",
        "duration_s": 40.0,
        "arrival": {"kind": "flash_crowd", "base_rate": 6.0,
                    "spike_rate": 80.0, "spike_at_s": 8.0,
                    "spike_width_s": 4.0},
        "deadline": {"kind": "adversarial", "tight_frac": 0.3,
                     "tight_s": 0.08, "loose_s": 30.0},
        "seed": 16,
        "fleet": {"replicas": 1, "autoscale": dict(_AUTOSCALE_FAST)},
        "envelope": {
            "max_lost": 0,
            # tight deadlines under the spike MUST be shed/timed out at
            # admission (not served late, not failed): the SLO gate's
            # reason-to-decide regression
            "decisions": {"failed": {"max": 0},
                          "completed": {"min": 150}},
            # the spike sheds tight deadlines (SLO burn) while the queue
            # backs up behind it — BOTH pages, and nothing fleet-fatal
            "alerts": {"must_fire": ["QueueWaitHigh", "SLOBurnHigh"],
                       "must_not_fire": "*"},
        },
    },
    "replica_death_storm": {
        "name": "replica_death_storm",
        "duration_s": 45.0,
        "arrival": {"kind": "constant", "rate": 30.0},
        "seed": 17,
        # no scale-DOWNs here: the pre-kill fleet is lightly loaded and
        # a drain before the kills would leave zero replicas publishing
        # metrics (nothing for breach detection to see) — this scenario
        # gates death recovery, not idle drain
        "fleet": {"replicas": 3,
                  "autoscale": {**_AUTOSCALE_FAST, "idle_polls": 200}},
        # two of three replicas die mid-run: the survivor saturates,
        # the router redispatches every orphaned request, and the
        # autoscaler must buy the capacity back
        "faults": [
            {"kind": "kill_replica", "at_s": 5.0, "rid": "r1"},
            {"kind": "kill_replica", "at_s": 7.0, "rid": "r2"},
        ],
        "envelope": {
            "max_lost": 0,
            "max_replica_deaths": 2,
            "min_scale_ups": 1,
            "max_recovery_s": 45.0,
            "max_burn_rate_300s": 40.0,
            "decisions": {"failed": {"max": 0}},
            # two kills -> router/replica_deaths moves -> ReplicaLost
            # pages; the survivor saturates -> QueueWaitHigh.  A coord
            # outage here would be a false positive: the store is UP
            "alerts": {"must_fire": ["ReplicaLost", "QueueWaitHigh"],
                       "must_not_fire": "*"},
        },
    },
    "router_failover": {
        "name": "router_failover",
        "duration_s": 40.0,
        "arrival": {"kind": "flash_crowd", "base_rate": 5.0,
                    "spike_rate": 60.0, "spike_at_s": 8.0,
                    "spike_width_s": 4.0},
        "seed": 18,
        "fleet": {"replicas": 2, "autoscale": dict(_AUTOSCALE_FAST)},
        # the router dies mid-spike (~poll 200 at 0.05 s cadence); a
        # fresh router must rebuild its table from the journal, re-adopt
        # the live replicas, and finish every request
        "faults": [{"kind": "kill_router", "at_poll": 200}],
        "envelope": {
            "max_lost": 0,
            "min_router_recoveries": 1,
            "decisions": {"failed": {"max": 0},
                          "completed": {"min": 250}},
            # a router crash is NOT a replica death and NOT a coord
            # outage — only the spike's queue wait may page
            "alerts": {"must_fire": ["QueueWaitHigh"],
                       "must_not_fire": "*"},
        },
    },
    "silent_corruption": {
        "name": "silent_corruption",
        "duration_s": 30.0,
        "arrival": {"kind": "constant", "rate": 10.0},
        "seed": 20,
        # no scale-downs: the quarantine window leaves one active
        # replica, and draining IT would zero the fleet mid-probe
        "fleet": {"replicas": 2,
                  "autoscale": {**_AUTOSCALE_FAST, "idle_polls": 200}},
        # r1 goes byzantine at 3 s: every committed payload has a byte
        # flipped post-framing, for 8 payloads, then it "heals".  The
        # wire checksum must catch every flip BEFORE delivery (zero
        # corrupted terminals), the strike ledger must quarantine r1,
        # golden probes must burn through the residual corruption and
        # then reinstate it — all with zero lost requests, because
        # every rejected completion is redispatched
        "faults": [{"kind": "corrupt_replica", "at_s": 3.0,
                    "rid": "r1", "every": 1, "count": 8}],
        "envelope": {
            "max_lost": 0,
            "min_quarantines": 1,
            "min_reinstated": 1,
            "max_corrupted_terminals": 0,
            "max_replica_deaths": 0,
            "decisions": {"failed": {"max": 0}},
            "alerts": {"must_fire": ["QuarantineActive"],
                       "must_not_fire": "*"},
        },
    },
    "disagg_mixed_prompts": {
        "name": "disagg_mixed_prompts",
        "duration_s": 40.0,
        "arrival": {"kind": "constant", "rate": 20.0},
        # the disaggregation workload: mostly short prompts with a long
        # tail — on a unified fleet the tail's prefill stalls every
        # decoding lane behind it; split pools keep TTFT bounded
        "prompt": {"kind": "longtail", "lo": 4, "typical": 16,
                   "tail": 512, "tail_frac": 0.08},
        "max_new": {"kind": "uniform", "lo": 16, "hi": 48},
        "seed": 21,
        # both pools start at 1 and BOTH are undersized, but for
        # different resources: the prefill pool drowns in queue wait
        # (compute), the decode pool drowns in resident KV (memory).
        # Each pool's autoscaler watches only its own signal — the
        # decode loop's queue-wait target is parked out of reach so a
        # scale-up there can only come from the kv-pressure signal
        "fleet": {"prefill_replicas": 1, "decode_replicas": 1,
                  "prefill_per_token_s": 0.002,
                  "kv_blocks_total": 64,
                  "autoscale_prefill": {
                      **_AUTOSCALE_FAST, "max_replicas": 3,
                      "idle_polls": 200},
                  "autoscale_decode": {
                      **_AUTOSCALE_FAST, "max_replicas": 3,
                      "idle_polls": 200, "target_wait_s": 30.0,
                      "low_wait_s": 0.1, "min_kv_free_frac": 0.3}},
        "envelope": {
            "max_lost": 0,
            "max_p99_ttft_s": 6.0,
            "min_scale_ups_prefill": 1,
            "min_scale_ups_decode": 1,
            "decisions": {"failed": {"max": 0}},
            "alerts": {"must_fire": ["QueueWaitHigh"],
                       "must_not_fire": "*"},
        },
    },
    "priority_saturation": {
        "name": "priority_saturation",
        "duration_s": 30.0,
        "arrival": {"kind": "constant", "rate": 12.0},
        # one replica, preemption ON, no autoscaler: a flood of fat
        # best-effort budgets oversaturates the lane (~0.1 s per
        # request at the default service rate — ~1.2x capacity, so the
        # backlog grows all run and QueueWaitHigh pages), and the
        # steady paid stream can only hold its wait floor by PAUSING
        # whatever is running.  With preempt="degrade" the same
        # workload parks paid p99 behind the multi-second best-effort
        # backlog; the envelope's priority-wait ceiling is unreachable
        # there, which is the regression gate on the preemption path.
        "max_new": {"kind": "const", "value": 44},
        "tenants": [
            {"name": "batch", "weight": 8.0, "priority": 0},
            {"name": "paid", "weight": 2.0, "priority": 1},
        ],
        "seed": 23,
        "fleet": {"replicas": 1, "preempt": "migrate"},
        "envelope": {
            "max_lost": 0,
            "max_priority_bad": 0,    # paid burns zero SLO budget
            "max_p99_priority_wait_s": 0.5,
            "min_preemptions": 5,     # the pause path must actually run
            "decisions": {"failed": {"max": 0}},
            "alerts": {"must_fire": ["QueueWaitHigh"],
                       "must_not_fire": "*"},
        },
    },
    "coord_brownout": {
        "name": "coord_brownout",
        "duration_s": 35.0,
        "arrival": {"kind": "constant", "rate": 8.0},
        "seed": 19,
        "fleet": {"replicas": 2, "autoscale": dict(_AUTOSCALE_FAST)},
        # the coord store goes dark for 6 s: in-flight decode keeps
        # running, completions buffer and flush on reconnect, and
        # NOBODY gets declared dead (stale, not lost)
        "faults": [{"kind": "coord_brownout", "at_s": 8.0, "for_s": 6.0}],
        "envelope": {
            "max_lost": 0,
            "max_replica_deaths": 0,
            "max_burn_rate_300s": 25.0,
            "decisions": {"failed": {"max": 0}},
            # the headline case of the alert plane: the scraper's collect()
            # round-trips fail during the brownout -> fleet/coord_up
            # drops -> CoordOutage pages.  ReplicaLost must NOT fire:
            # stale is not dead
            "alerts": {"must_fire": ["CoordOutage"],
                       "must_not_fire": "*"},
        },
    },
}


def names() -> list[str]:
    return sorted(BUILTIN)


def builtin(name: str) -> ScenarioSpec:
    """The named builtin scenario, parsed and validated."""
    if name not in BUILTIN:
        raise KeyError(
            f"unknown scenario {name!r} (have: {', '.join(names())})")
    return ScenarioSpec.from_dict(BUILTIN[name])
