"""Declarative alert rules over the TSDB (counterpart of
:mod:`tpudist.obs.alerts`; the same rule docs hash alike).

A rule is a query + predicate + hold duration, declared as data the
same way ``ScenarioSpec`` declares a scenario: a dict (or JSON doc)
with unknown keys rejected, so a typo'd rule fails at load time
instead of silently never firing.

    {"name": "CoordOutage", "metric": "fleet/coord_up",
     "fn": "last", "window_s": 5, "op": "<", "threshold": 0.5,
     "for_s": 1.0, "severity": "page"}

:class:`AlertManager` evaluates a rule set against a :class:`~.tsdb.TSDB`
on each tick and runs the pending -> firing -> resolved lifecycle: a
breach opens a *pending* alert, which *fires* once it has held for
``for_s`` seconds, and *resolves* the first tick the predicate stops
holding.  Alerts are deduplicated by rule name; lifecycle counts are
exported as ``alerts/*`` counters and gauges when a registry is given.

Two rule sets ship with the repo:

* :func:`default_rules` — the fleet operator set (SLO burn, KV/tier
  headroom, coord outage, quarantine, stale publishers,
  handoff-fallback spikes, replica loss).  The sim's builtin scenarios
  regression-test these: each scenario's ``alerts:`` envelope says
  which rules must and must not fire.
* :func:`autoscale_rules` — the Autoscaler's breach predicates,
  expressed as rules over its own private TSDB so scaling decisions
  read fired alerts through the same interface instead of bespoke
  threshold probes.

:func:`rules_hash` gives a stable short hash of a loaded rule set; the
bench stamps it onto every JSONL row so trajectory comparisons detect
silent rule drift.
"""

from __future__ import annotations

import hashlib
import json
import operator
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

from tpudist_torch.obs.tsdb import TSDB

__all__ = ["AlertRule", "AlertManager", "default_rules", "autoscale_rules",
           "load_rules", "rules_hash", "ALERT_FNS", "ALERT_OPS",
           "SEVERITIES"]

ALERT_FNS = ("last", "rate", "delta", "avg_over_time", "max_over_time",
             "min_over_time", "quantile_over_time")
ALERT_OPS: dict[str, Callable[[float, float], bool]] = {
    ">": operator.gt, "<": operator.lt, ">=": operator.ge,
    "<=": operator.le, "==": operator.eq, "!=": operator.ne,
}
SEVERITIES = ("info", "warn", "page")

_RULE_KEYS = {"name", "metric", "fn", "window_s", "q", "op", "threshold",
              "for_s", "severity", "labels", "match", "help"}


@dataclass(frozen=True)
class AlertRule:
    """One declarative rule: ``fn(metric, window_s) op threshold``
    holding for ``for_s`` seconds."""

    name: str
    metric: str
    op: str
    threshold: float
    fn: str = "last"
    window_s: float | None = None
    q: float | None = None          # quantile_over_time only
    for_s: float = 0.0
    severity: str = "warn"
    labels: dict = field(default_factory=dict)   # attached to the alert
    match: dict = field(default_factory=dict)    # series label selector
    help: str = ""

    def __post_init__(self):
        if not self.name or not self.metric:
            raise ValueError("alert rule needs name and metric")
        if self.fn not in ALERT_FNS:
            raise ValueError(f"rule {self.name}: unknown fn {self.fn!r} "
                             f"(choose from {ALERT_FNS})")
        if self.op not in ALERT_OPS:
            raise ValueError(f"rule {self.name}: unknown op {self.op!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"rule {self.name}: unknown severity "
                             f"{self.severity!r} (choose from {SEVERITIES})")
        if self.fn != "last" and self.window_s is None:
            raise ValueError(f"rule {self.name}: fn {self.fn!r} needs "
                             f"window_s")
        if self.fn == "quantile_over_time" and self.q is None:
            raise ValueError(f"rule {self.name}: quantile_over_time needs q")
        if self.for_s < 0:
            raise ValueError(f"rule {self.name}: for_s must be >= 0")

    @classmethod
    def from_dict(cls, d: dict) -> "AlertRule":
        if not isinstance(d, dict):
            raise TypeError(f"alert rule must be a dict, got {type(d)}")
        unknown = set(d) - _RULE_KEYS
        if unknown:
            raise ValueError(
                f"alert rule {d.get('name', '?')!r}: unknown keys "
                f"{sorted(unknown)} (allowed: {sorted(_RULE_KEYS)})")
        for key in ("name", "metric", "op", "threshold"):
            if key not in d:
                raise ValueError(f"alert rule missing required key {key!r}")
        kw = dict(d)
        kw["threshold"] = float(kw["threshold"])
        if kw.get("window_s") is not None:
            kw["window_s"] = float(kw["window_s"])
        if kw.get("q") is not None:
            kw["q"] = float(kw["q"])
        kw["for_s"] = float(kw.get("for_s", 0.0))
        return cls(**kw)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"name": self.name, "metric": self.metric,
                             "fn": self.fn, "op": self.op,
                             "threshold": self.threshold,
                             "for_s": self.for_s,
                             "severity": self.severity}
        if self.window_s is not None:
            d["window_s"] = self.window_s
        if self.q is not None:
            d["q"] = self.q
        if self.labels:
            d["labels"] = dict(sorted(self.labels.items()))
        if self.match:
            d["match"] = dict(sorted(self.match.items()))
        if self.help:
            d["help"] = self.help
        return d

    def value(self, tsdb: TSDB, at: float | None = None) -> float | None:
        """Evaluate the query half against the store."""
        m, w, sel = self.metric, self.window_s, (self.match or None)
        if self.fn == "last":
            return tsdb.latest(m, labels=sel, window_s=w, at=at)
        if self.fn == "rate":
            return tsdb.rate(m, w, labels=sel, at=at)
        if self.fn == "delta":
            return tsdb.delta(m, w, labels=sel, at=at)
        if self.fn == "avg_over_time":
            return tsdb.avg_over_time(m, w, labels=sel, at=at)
        if self.fn == "max_over_time":
            return tsdb.max_over_time(m, w, labels=sel, at=at)
        if self.fn == "min_over_time":
            return tsdb.min_over_time(m, w, labels=sel, at=at)
        return tsdb.quantile_over_time(m, self.q, w, labels=sel, at=at)

    def test(self, value: float | None) -> bool:
        """Predicate half; absent (None) never breaches, and NaN
        compares False under every op."""
        if value is None:
            return False
        return ALERT_OPS[self.op](value, self.threshold)


def load_rules(docs: Iterable[dict] | str) -> tuple[AlertRule, ...]:
    """Rules from a list of dicts, a JSON string, or a JSON file path
    (the doc may be a bare list or ``{"rules": [...]}``)."""
    if isinstance(docs, str):
        text = docs
        if not docs.lstrip().startswith(("[", "{")):
            with open(docs, encoding="utf-8") as f:
                text = f.read()
        parsed = json.loads(text)
        docs = parsed.get("rules", []) if isinstance(parsed, dict) else parsed
    rules = tuple(AlertRule.from_dict(d) if isinstance(d, dict) else d
                  for d in docs)
    seen: set[str] = set()
    for r in rules:
        if r.name in seen:
            raise ValueError(f"duplicate alert rule name {r.name!r}")
        seen.add(r.name)
    return rules


def rules_hash(rules: Iterable[AlertRule]) -> str:
    """Stable short hash of a rule set (order-insensitive): bench rows
    carry it so silent rule drift shows up in trajectory diffs."""
    canon = json.dumps(sorted((r.to_dict() for r in rules),
                              key=lambda d: d["name"]),
                       sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:12]


def default_rules() -> tuple[AlertRule, ...]:
    """The shipped fleet-operator rule set.  Thresholds are regression
    -tested by the sim scenario matrix (each builtin scenario's
    ``alerts:`` envelope pins which of these must and must not fire)."""
    mk = AlertRule
    return (
        mk(name="CoordOutage", metric="fleet/coord_up", fn="last",
           window_s=5.0, op="<", threshold=0.5, for_s=1.0, severity="page",
           help="metric collection cannot reach the coordinator"),
        mk(name="ReplicaLost", metric="router/replica_deaths", fn="delta",
           window_s=30.0, op=">", threshold=0.0, severity="page",
           help="the router declared a replica dead in the last 30s"),
        mk(name="QuarantineActive", metric="router/quarantines", fn="delta",
           window_s=30.0, op=">", threshold=0.0, severity="warn",
           help="a replica was quarantined for output corruption"),
        mk(name="SLOBurnHigh", metric="slo/burn_rate_60s", fn="last",
           window_s=10.0, op=">", threshold=2.0, for_s=2.0, severity="page",
           help="error budget burning >2x sustainable in the 60s window"),
        mk(name="QueueWaitHigh", metric="serve/queue_wait_s/p90",
           fn="last", window_s=5.0, op=">", threshold=1.0, for_s=2.0,
           severity="warn",
           help="p90 admission wait over 1s across the fleet"),
        mk(name="KVHeadroomLow", metric="fleet/kv_free_frac", fn="last",
           window_s=5.0, op="<", threshold=0.10, for_s=2.0, severity="warn",
           help="fleet KV pool nearly exhausted (<10% free)"),
        mk(name="TierHeadroomLow", metric="fleet/tier_headroom_frac",
           fn="last", window_s=5.0, op="<", threshold=0.10, for_s=2.0,
           severity="warn",
           help="host-RAM spill tier nearly full (<10% headroom)"),
        mk(name="StalePublisher", metric="fleet/max_publish_age_s",
           fn="max_over_time", window_s=10.0, op=">", threshold=15.0,
           severity="warn",
           help="a replica's metrics snapshot is older than 15s"),
        mk(name="HandoffFallbackSpike", metric="serve/handoff_fallbacks",
           fn="delta", window_s=60.0, op=">", threshold=3.0, severity="warn",
           help="disagg prefill->decode handoffs falling back to "
                "re-prefill faster than 3/min"),
        mk(name="MigrationFallbackSpike",
           metric="router/migration_fallbacks",
           fn="delta", window_s=60.0, op=">", threshold=3.0, severity="warn",
           help="live KV migrations losing their payload (ref-less "
                "commit or adopt-side fetch miss -> re-prefill) faster "
                "than 3/min"),
        mk(name="FleetDegraded", metric="serve/degraded", fn="last",
           window_s=5.0, op=">", threshold=0.0, severity="warn",
           help="a replica is advertising degraded service"),
    )


def autoscale_rules(cfg) -> tuple[AlertRule, ...]:
    """The Autoscaler's breach predicates as declarative rules over its
    private per-poll TSDB (``autoscale/*`` series recorded each poll).

    These mirror the historical inline thresholds exactly — fn="last"
    with no staleness window reads the value recorded by the current
    poll (absent signals are recorded as NaN, which no predicate
    matches), and for_s=0 fires in the same evaluation, so the breach
    streak/cooldown hysteresis above stays byte-identical.
    """
    rules = [AlertRule(name="AutoscaleQueueWait", metric="autoscale/wait_q",
                       op=">", threshold=cfg.target_wait_s, severity="info",
                       help="queue wait quantile above target_wait_s")]
    if getattr(cfg, "max_burn_rate", None) is not None:
        rules.append(AlertRule(
            name="AutoscaleBurnRate", metric="autoscale/burn_rate",
            op=">", threshold=cfg.max_burn_rate, severity="info",
            help="SLO burn above max_burn_rate"))
    if getattr(cfg, "min_kv_free_frac", None) is not None:
        rules.append(AlertRule(
            name="AutoscaleKVStarved", metric="autoscale/kv_free_frac",
            op="<", threshold=cfg.min_kv_free_frac, severity="info",
            help="KV free fraction under min_kv_free_frac"))
    if getattr(cfg, "min_tier_headroom_frac", None) is not None:
        rules.append(AlertRule(
            name="AutoscaleTierPressure",
            metric="autoscale/tier_headroom_frac",
            op="<", threshold=cfg.min_tier_headroom_frac, severity="info",
            help="spill-tier headroom under min_tier_headroom_frac"))
    return tuple(rules)


class AlertManager:
    """Evaluates a rule set against a TSDB and tracks alert lifecycle.

    One alert instance per rule name (dedup); states are *pending*
    (breaching, hold not yet met) and *firing*.  ``fired_names`` keeps
    every rule that ever reached firing during this manager's lifetime
    — the sim's ``alerts:`` envelope checks against it.
    """

    def __init__(self, tsdb: TSDB, rules: Iterable[AlertRule] | None = None,
                 *, registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 history: int = 256) -> None:
        self.tsdb = tsdb
        self.rules: tuple[AlertRule, ...] = \
            load_rules(rules if rules is not None else default_rules())
        self._clock = clock
        self._states: dict[str, dict] = {}
        self.fired_names: set[str] = set()
        self.resolved: deque = deque(maxlen=history)
        self.evaluations = 0
        self._obs = None
        if registry is not None:
            self._obs = {
                "evals": registry.counter("alerts/evaluations",
                                          unit="evaluations"),
                "fired": registry.counter("alerts/fired", unit="alerts"),
                "resolved": registry.counter("alerts/resolved",
                                             unit="alerts"),
                "firing": registry.gauge("alerts/firing", unit="alerts"),
                "pending": registry.gauge("alerts/pending", unit="alerts"),
            }

    @property
    def rules_hash(self) -> str:
        return rules_hash(self.rules)

    def evaluate(self, now: float | None = None) -> list[dict]:
        """One evaluation pass; returns the lifecycle transitions that
        happened (``{"rule", "event": "pending"|"firing"|"resolved",
        "value", "t"}``)."""
        now = self._clock() if now is None else now
        self.evaluations += 1
        transitions: list[dict] = []
        for rule in self.rules:
            try:
                v = rule.value(self.tsdb, at=now)
            except Exception:  # noqa: BLE001 - a bad rule must not stop others
                v = None
            st = self._states.get(rule.name)
            if rule.test(v):
                if st is None:
                    st = self._states[rule.name] = {
                        "rule": rule.name, "severity": rule.severity,
                        "labels": dict(rule.labels), "state": "pending",
                        "since": now, "value": v,
                    }
                    transitions.append({"rule": rule.name,
                                        "event": "pending",
                                        "value": v, "t": now})
                st["value"] = v
                if (st["state"] == "pending"
                        and now - st["since"] >= rule.for_s):
                    st["state"] = "firing"
                    st["fired_at"] = now
                    self.fired_names.add(rule.name)
                    transitions.append({"rule": rule.name, "event": "firing",
                                        "value": v, "t": now})
                    if self._obs:
                        self._obs["fired"].inc()
            elif st is not None:
                del self._states[rule.name]
                if st["state"] == "firing":
                    st["resolved_at"] = now
                    self.resolved.append(st)
                    transitions.append({"rule": rule.name,
                                        "event": "resolved",
                                        "value": v, "t": now})
                    if self._obs:
                        self._obs["resolved"].inc()
        if self._obs:
            self._obs["evals"].inc()
            firing = sum(1 for s in self._states.values()
                         if s["state"] == "firing")
            self._obs["firing"].set(float(firing))
            self._obs["pending"].set(float(len(self._states) - firing))
        return transitions

    # ------------------------------------------------------------- read

    def active(self) -> list[dict]:
        """Pending + firing alerts, firing first, then by severity."""
        rank = {"page": 0, "warn": 1, "info": 2}
        return sorted((dict(s) for s in self._states.values()),
                      key=lambda s: (s["state"] != "firing",
                                     rank.get(s["severity"], 3), s["rule"]))

    def firing(self, severity: str | None = None) -> list[dict]:
        return [s for s in self.active() if s["state"] == "firing"
                and (severity is None or s["severity"] == severity)]

    def is_firing(self, *names: str) -> bool:
        """The one-call consumer interface: is any of these rules
        currently firing?  (No names = any rule at all.)"""
        firing = {s["rule"] for s in self._states.values()
                  if s["state"] == "firing"}
        return bool(firing if not names else firing & set(names))

    def to_doc(self) -> dict:
        """JSON body of the ``/alerts`` endpoint and the console
        snapshot's ``alerts`` key."""
        return {
            "schema": "tpudist.alerts/1",
            "rules_hash": self.rules_hash,
            "rules": [r.to_dict() for r in self.rules],
            "active": self.active(),
            "resolved": list(self.resolved),
            "fired_ever": sorted(self.fired_names),
            "evaluations": self.evaluations,
        }

