"""Workload synthesis and trace replay for the serve fleet (counterpart
of :mod:`tpudist.sim.workload`).

Two ways to produce the same thing — a time-ordered list of
:class:`WorkItem` (arrival offset + request shape) that both the live
replayer and the offline simulator consume:

* :func:`synthesize` draws one from a :class:`ScenarioSpec` — a
  nonhomogeneous Poisson arrival process (thinning against the
  scenario's rate curve: constant, diurnal sinusoid, flash-crowd
  spike), prompt lengths (uniform or long-tail), token budgets,
  deadline distributions (including the adversarial tight/loose mix),
  and a weighted tenant mix whose shared system prefixes reproduce the
  prefix-cache-shaped traffic real fleets see.  Deterministic under
  ``spec.seed``.
* :func:`workload_from_trace` reconstructs one from a recorded
  ``tpudist.events/1`` document: the router's ``enqueue`` events carry
  ``prompt_tokens`` / ``max_new`` / ``priority`` / ``rel_deadline_s``
  exactly so a production incident's arrival pattern can be replayed —
  against the live fleet or the offline simulator — as a regression
  scenario.

:meth:`Workload.requests` materializes real
:class:`tpudist_torch.models.serving.Request` objects plus the ``arrivals``
offset list ``Router.run(..., arrivals=...)`` expects, so the SAME
workload drives the SAME router code on both execution paths.  A
tenant's shared prefix is drawn from a seed that mixes in the CRC-32 of
its name (tpudist mixes in ``hash(name)``, which Python salts per
process, so its prompts differ from run to run); the arrivals, shapes
and summary rows are tpudist's.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass

import numpy as np

from tpudist_torch.sim.scenario import ScenarioSpec

__all__ = ["WorkItem", "Workload", "synthesize", "workload_from_trace",
           "service_rates_from_trace"]

# synthesized prompts draw token ids from this range; the tiny fleet
# models all have vocab >= 64 and the simulator never embeds them
_VOCAB = 64


@dataclass(frozen=True)
class WorkItem:
    """One arrival: WHEN (offset seconds from workload start) and WHAT
    (request shape).  ``prefix_tokens`` > 0 marks the leading span of
    the prompt as the tenant's shared system prefix."""

    at: float
    prompt_tokens: int
    max_new: int
    rel_deadline_s: float | None = None
    priority: int = 0
    tenant: str | None = None
    prefix_tokens: int = 0


@dataclass(frozen=True)
class Workload:
    """A materializable arrival schedule (see module docstring)."""

    items: tuple[WorkItem, ...]
    name: str = "workload"
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(
            self, "items",
            tuple(sorted(self.items, key=lambda w: w.at)))

    def __len__(self) -> int:
        return len(self.items)

    @property
    def duration_s(self) -> float:
        return self.items[-1].at if self.items else 0.0

    def requests(self, base_wall: float):
        """(requests, arrivals) for ``Router.run``: real ``Request``
        objects whose absolute ``deadline_s`` is anchored at
        ``base_wall + at + rel_deadline`` (pass the clock the router
        will read — ``time.time()`` live, ``VirtualClock.wall()``
        simulated), plus the matching arrival-offset list."""
        from tpudist_torch.models.kv_pages import request_prefix_hash
        from tpudist_torch.models.serving import Request

        rng = np.random.default_rng(self.seed ^ 0x5EED)
        # one stable shared prefix per tenant: the whole tenant's
        # traffic opens with the same token span (prefix-cache shape)
        prefixes: dict[str, np.ndarray] = {}
        reqs, arrivals = [], []
        for n, w in enumerate(self.items):
            pre = np.zeros((0,), np.int32)
            if w.tenant is not None and w.prefix_tokens > 0:
                if w.tenant not in prefixes:
                    # crc32, not hash(): str hashes are salted per
                    # process, so hash() would draw other prefixes in
                    # every run
                    trng = np.random.default_rng(
                        (self.seed << 8)
                        ^ zlib.crc32(w.tenant.encode()) & 0xFFFF)
                    prefixes[w.tenant] = trng.integers(
                        1, _VOCAB, size=w.prefix_tokens).astype(np.int32)
                pre = prefixes[w.tenant]
            tail_n = max(1, w.prompt_tokens - pre.size)
            prompt = np.concatenate(
                [pre, rng.integers(1, _VOCAB, size=tail_n).astype(np.int32)])
            deadline = None if w.rel_deadline_s is None else \
                base_wall + w.at + w.rel_deadline_s
            # the tenant's shared system prefix, stamped as the opaque
            # affinity hash the router's prefix steering matches on (and
            # FleetSim's offline hit-rate accounting counts)
            phash = (request_prefix_hash(pre) if pre.size else None)
            reqs.append(Request(
                prompt=prompt, max_new_tokens=int(w.max_new),
                rid=f"{self.name}-{n:05d}", deadline_s=deadline,
                priority=int(w.priority), prefix_hash=phash))
            arrivals.append(float(w.at))
        return reqs, arrivals


# -- arrival processes ------------------------------------------------------

def _rate_fn(arrival: dict):
    """(rate(t), rate_max) for the scenario's arrival law — the inputs
    Lewis-Shedler thinning needs."""
    kind = arrival["kind"]
    if kind == "constant":
        r = float(arrival["rate"])
        return (lambda t: r), r
    if kind == "diurnal":
        base = float(arrival["base_rate"])
        peak = float(arrival["peak_rate"])
        period = float(arrival["period_s"])
        mid, amp = (base + peak) / 2.0, (peak - base) / 2.0

        def rate(t: float) -> float:
            # trough at t=0, peak at period/2: a compressed day
            return mid - amp * math.cos(2.0 * math.pi * t / period)
        return rate, peak
    if kind == "flash_crowd":
        base = float(arrival["base_rate"])
        spike = float(arrival["spike_rate"])
        at = float(arrival.get("spike_at_s", 0.0))
        width = float(arrival["spike_width_s"])

        def rate(t: float) -> float:
            return spike if at <= t < at + width else base
        return rate, spike
    raise ValueError(f"unknown arrival kind {kind!r}")


def _thin_arrivals(arrival: dict, duration_s: float,
                   rng: np.random.Generator) -> list[float]:
    """Nonhomogeneous Poisson arrival times on [0, duration) by
    thinning: candidates at the max rate, kept with probability
    rate(t)/rate_max."""
    rate, rate_max = _rate_fn(arrival)
    out: list[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_max)
        if t >= duration_s:
            return out
        if rng.random() * rate_max <= rate(t):
            out.append(t)


def _draw_prompt(prompt: dict, rng: np.random.Generator) -> int:
    if prompt["kind"] == "uniform":
        return int(rng.integers(prompt["lo"], prompt["hi"] + 1))
    # longtail: mostly short (lo..typical), a tail_frac slice drawn
    # log-uniform out to `tail` — the mixed-context-length reality that
    # stresses queueing behind long prefills
    if rng.random() < float(prompt.get("tail_frac", 0.05)):
        lo, hi = math.log(prompt["typical"]), math.log(prompt["tail"])
        return int(round(math.exp(rng.uniform(lo, hi))))
    return int(rng.integers(prompt["lo"], prompt["typical"] + 1))


def _draw_max_new(max_new: dict, rng: np.random.Generator) -> int:
    if max_new["kind"] == "const":
        return int(max_new["value"])
    return int(rng.integers(max_new["lo"], max_new["hi"] + 1))


def _draw_deadline(deadline: dict,
                   rng: np.random.Generator) -> float | None:
    kind = deadline["kind"]
    if kind == "none":
        return None
    if kind == "uniform":
        return float(rng.uniform(deadline["lo"], deadline["hi"]))
    # adversarial: a tight_frac slice gets near-impossible deadlines
    # (exercising shed/timeout-at-admission), the rest are loose
    if rng.random() < float(deadline["tight_frac"]):
        return float(deadline["tight_s"])
    return float(deadline["loose_s"])


def _pick_tenant(tenants: tuple, rng: np.random.Generator) -> dict | None:
    if not tenants:
        return None
    weights = np.asarray([float(t["weight"]) for t in tenants])
    idx = rng.choice(len(tenants), p=weights / weights.sum())
    return tenants[int(idx)]


def synthesize(spec: ScenarioSpec) -> Workload:
    """Draw the scenario's workload (deterministic under ``spec.seed``)."""
    rng = np.random.default_rng(spec.seed)
    items = []
    for at in _thin_arrivals(spec.arrival, spec.duration_s, rng):
        tenant = _pick_tenant(spec.tenants, rng)
        items.append(WorkItem(
            at=round(at, 6),
            prompt_tokens=_draw_prompt(spec.prompt, rng),
            max_new=_draw_max_new(spec.max_new, rng),
            rel_deadline_s=_draw_deadline(spec.deadline, rng),
            priority=int(tenant.get("priority", 0)) if tenant else 0,
            tenant=tenant["name"] if tenant else None,
            prefix_tokens=int(tenant.get("prefix_tokens", 0))
            if tenant else 0))
    return Workload(items=tuple(items), name=spec.name, seed=spec.seed)


# -- trace replay -----------------------------------------------------------

def workload_from_trace(doc: dict, name: str = "trace-replay") -> Workload:
    """A replayable workload from a recorded ``tpudist.events/1``
    document: every router ``enqueue`` event becomes a :class:`WorkItem`
    at its original offset from the first arrival, with the original
    prompt length, token budget, priority, and RELATIVE deadline — the
    incident's arrival pattern, detached from its wall clock."""
    enq = [e for e in doc.get("events", [])
           if e.get("kind") == "enqueue" and "prompt_tokens" in e]
    if not enq:
        raise ValueError(
            "trace has no replayable enqueue events (need "
            "prompt_tokens/max_new fields — recorded by Router._arrive)")
    t0 = min(e["t"] for e in enq)
    items = [WorkItem(
        at=round(float(e["t"]) - t0, 6),
        prompt_tokens=int(e["prompt_tokens"]),
        max_new=int(e["max_new"]),
        rel_deadline_s=e.get("rel_deadline_s"),
        priority=int(e.get("priority", 0) or 0)) for e in enq]
    return Workload(items=tuple(items), name=name)


def service_rates_from_trace(doc: dict,
                             default: float = 0.002) -> dict[str, float]:
    """Per-replica seconds-per-token from a recorded trace: the median
    of each source's ``segment`` events' ``spt`` stamps (the ServeLoop's
    realized-rate EMA at that moment).  This is what makes the offline
    simulator's replicas serve at the RECORDED fleet's pace.  Sources
    with no stamped segments fall back to ``default`` (also the return
    value's ``"*"`` entry, for replicas the autoscaler spawns that the
    trace never saw)."""
    by_src: dict[str, list[float]] = {}
    for e in doc.get("events", []):
        if e.get("kind") == "segment" and e.get("spt"):
            by_src.setdefault(str(e.get("src", "?")), []).append(
                float(e["spt"]))
    out = {"*": float(default)}
    for src, vals in by_src.items():
        out[src] = float(np.median(vals))
    return out
