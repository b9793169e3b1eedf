"""tpudist_torch.obs.events (per-request tracing and SLO accounting)
against the JAX package's ``tpudist.obs.events``: the same seeded event
streams and completions give the same wire documents, merged fleet logs,
timelines, completeness verdicts and burn rates."""

import importlib

import numpy as np
import pytest

from tpudist_torch import obs as tobs

tev = importlib.import_module("tpudist_torch.obs.events")
treg = importlib.import_module("tpudist_torch.obs.registry")

KINDS = ("enqueue", "dispatch", "redispatch", "reroute", "admit",
         "segment", "done", "shed", "timeout", "failed")


@pytest.fixture(scope="module")
def ref():
    return (importlib.import_module("tpudist.obs.events"),
            importlib.import_module("tpudist.obs.registry"))


def _stream(seed: int) -> list[dict]:
    """A seeded fleet's event rings: three sources, five traces, times
    with ties (the merge's tie-break on source and sequence)."""
    rng = np.random.default_rng(seed)
    out = []
    for src in range(3):
        evs = []
        for i in range(int(rng.integers(5, 15))):
            trace = (None if rng.random() < 0.1
                     else f"q{int(rng.integers(0, 5))}-abc")
            evs.append({"t": float(rng.integers(0, 20)) / 4.0, "i": i,
                        "kind": str(rng.choice(KINDS)), "trace": trace,
                        "rid": f"q{int(rng.integers(0, 5))}"})
        out.append({"schema": "tpudist.events/1",
                    "dropped": int(rng.integers(0, 3)), "events": evs})
    return out


def test_trace_context_wire_round_trip(ref):
    ev, _ = ref
    for key, parent in ((None, None), ("00000007", "p1")):
        t = tev.TraceContext.mint(key, parent=parent)
        assert set(t.to_wire()) == {"id", "parent", "enq"}
        assert t.trace_id.startswith(f"{key}-" if key else "")
        back = ev.TraceContext.from_wire(t.to_wire())
        assert (back.trace_id, back.parent, back.enqueued_at) == \
            (t.trace_id, t.parent, t.enqueued_at)
        mine = tev.TraceContext.from_wire(back.to_wire())
        assert mine == t
    for bad in (None, {}, {"id": None}):
        assert tev.TraceContext.from_wire(bad) is None
        assert ev.TraceContext.from_wire(bad) is None


def test_event_ring_bounds_and_snapshot(ref):
    ev, _ = ref
    rings = [ev.RequestEventLog(capacity=4), tev.RequestEventLog(capacity=4)]
    for ring in rings:
        for i in range(6):
            ring.record("segment", trace=f"t{i % 2}", slot=i)
    docs = [r.snapshot() for r in rings]
    for d in docs:
        for e in d["events"]:
            e.pop("t")
    assert docs[1] == docs[0]
    assert rings[1].dropped == 2 and len(rings[1].tail(3)) == 3
    with pytest.raises(ValueError):
        tev.RequestEventLog(capacity=0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_group_and_complete_equal(ref, seed):
    ev, _ = ref
    rings = _stream(seed)
    collected = {0: rings[0], 1: rings[1]}
    want = ev.merge_events(collected, router=rings[2])
    got = tev.merge_events(collected, router=rings[2])
    assert got == want
    # a ring published twice merges without duplicates
    assert tev.merge_events({0: rings[0]}, again=rings[0])["events"] == \
        ev.merge_events({0: rings[0]}, again=rings[0])["events"]
    tw, tg = ev.group_timelines(want["events"]), tev.group_timelines(
        got["events"])
    assert tg == tw
    for tid, tl in tg.items():
        assert tev.is_complete(tl) == ev.is_complete(tw[tid])
    for rid in range(5):
        assert tev.timeline_for_rid(tg, f"q{rid}") == \
            ev.timeline_for_rid(tw, f"q{rid}")


@pytest.mark.parametrize("kinds", [
    ["enqueue", "dispatch", "done"],
    ["enqueue", "dispatch", "redispatch", "dispatch", "done"],
    ["enqueue", "dispatch", "redispatch", "done"],
    ["enqueue", "shed"], ["dispatch", "done"], ["enqueue", "admit"], []])
def test_is_complete_verdicts(ref, kinds):
    ev, _ = ref
    tl = [{"kind": k, "t": float(i)} for i, k in enumerate(kinds)]
    assert tev.is_complete(tl) == ev.is_complete(tl)


def test_slo_tracker_burn_rates_on_an_injected_clock(ref):
    """The same completions, at the same injected times, give the same
    counts, burn rates and registry snapshot."""
    ev, reg = ref
    rng = np.random.default_rng(7)
    reasons = ["stop", "length", "shed", "timeout", "failed", "rejected",
               "invalid"]
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    regs = [reg.MetricRegistry(), treg.MetricRegistry()]
    trackers = [ev.SLOTracker(regs[0], windows=(60.0, 300.0), clock=clock),
                tev.SLOTracker(regs[1], windows=(60.0, 300.0), clock=clock)]
    for _ in range(80):
        t[0] += float(rng.exponential(8.0))
        reason = str(rng.choice(reasons))
        prio = int(rng.integers(0, 3))
        for tr in trackers:
            tr.observe(reason, priority=prio)
        for cls in (None, "priority", "best_effort"):
            assert trackers[1].burn_rates(cls) == trackers[0].burn_rates(cls)
    snaps = [r.snapshot() for r in regs]
    snaps[1]["time"] = snaps[0]["time"]
    assert snaps[1] == snaps[0]
    for p in (None, -1, 0, 1, 5):
        assert tev.slo_class(p) == ev.slo_class(p)
    for tr in trackers:
        tr.clear()
    assert trackers[1].burn_rates() == trackers[0].burn_rates()


def test_event_publisher_round_trip():
    class Store:
        def __init__(self):
            self.kv = {}

        def set(self, k, v):
            self.kv[k] = v

        def get(self, k):
            return self.kv.get(k)

        def keys(self, prefix=""):
            return [k for k in self.kv if k.startswith(prefix)]

    store = Store()
    ring = tev.RequestEventLog()
    ring.record("admit", trace="t1", slot=0)
    pub = tev.EventPublisher(store, 3, ring, namespace="ns/events",
                             interval_s=60.0)
    pub.publish()
    got = tev.collect_events(store, "ns/events")
    assert list(got) == [3]
    assert got[3]["events"][0]["kind"] == "admit"
    merged = tobs.merge_events(got, router=tobs.RequestEventLog().snapshot())
    assert merged["sources"] == ["r3", "router"]
