"""Request-timeline reconstruction: ``python -m tpudist_torch.obs.timeline``
(counterpart of :mod:`tpudist.obs.timeline`).

Loads a fleet event log — the merged ``tpudist.events/1`` document
(:func:`tpudist_torch.obs.events.merge_events` output, e.g. the file the
``serve_fleet`` bench writes), a ``tpudist.postmortem/1`` crash bundle
(whose ``request_events`` tail this tool understands), or a raw
published ring snapshot — and reconstructs each request's causal
history: one time-ordered timeline per trace id, spanning every
process the request touched (router enqueue/dispatch, replica
admit/segments, a SIGKILL's redispatch, the replica-side done-commit,
the router-side done).

Text mode prints each timeline with per-event offsets from its enqueue;
``--chrome OUT`` additionally exports the merged view as Chrome-trace
JSON (chrome://tracing / Perfetto): each trace id becomes one track,
consecutive lifecycle events become the "X" slices between them, so a
request's wait / decode / redispatch phases are visible as bars.

Usage::

    python -m tpudist_torch.obs.timeline events.json                # all traces
    python -m tpudist_torch.obs.timeline events.json --trace ID     # one trace
    python -m tpudist_torch.obs.timeline events.json --rid q3       # by caller rid
    python -m tpudist_torch.obs.timeline events.json --chrome t.json
    python -m tpudist_torch.obs.timeline events.json --summary   # percentiles
    python -m tpudist_torch.obs.timeline events.json --require-complete

``--require-complete`` exits 1 unless every resolved trace passes
:func:`tpudist_torch.obs.events.is_complete` — the CI gate that no completed
request has a gap in its recorded history.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpudist_torch.obs.events import (
    EVENTS_SCHEMA,
    group_timelines,
    is_complete,
    timeline_for_rid,
)
from tpudist_torch.obs.spans import atomic_write_json

__all__ = ["load_events", "render_timeline", "summarize_timelines",
           "render_summary", "to_chrome", "main"]


def load_events(path: str) -> list[dict]:
    """Events from any of the recognized on-disk shapes (see module
    docstring); raises ``ValueError`` on an unrecognizable document."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):
        return doc
    if isinstance(doc, dict):
        if doc.get("schema") == EVENTS_SCHEMA or "events" in doc and \
                not doc.get("schema", "").startswith("tpudist.postmortem"):
            evs = doc.get("events")
            if isinstance(evs, list):
                return evs
        if "request_events" in doc:    # a postmortem bundle's tail
            return doc["request_events"] or []
    raise ValueError(
        f"{path}: not an event log ({EVENTS_SCHEMA}), postmortem "
        f"bundle, or raw event list")


def render_timeline(trace_id: str, timeline: list[dict]) -> list[str]:
    """Human-readable causal history, offsets relative to the first
    event (the router enqueue when the timeline is complete)."""
    if not timeline:
        return [f"trace {trace_id}: (no events)"]
    t0 = timeline[0].get("t", 0.0)
    status = "complete" if is_complete(timeline) else "INCOMPLETE"
    lines = [f"trace {trace_id} [{status}] "
             f"({len(timeline)} events over "
             f"{timeline[-1].get('t', t0) - t0:.3f}s)"]
    for ev in timeline:
        detail = " ".join(
            f"{k}={ev[k]}" for k in sorted(ev)
            if k not in ("t", "i", "kind", "trace", "src")
            and ev[k] is not None)
        lines.append(f"  +{ev.get('t', t0) - t0:9.4f}s "
                     f"{ev.get('src', '?'):>8} {ev.get('kind', '?'):<14}"
                     f" {detail}".rstrip())
    return lines


def _pct(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated percentile of an already-sorted list."""
    if not sorted_vals:
        return float("nan")
    pos = (len(sorted_vals) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def summarize_timelines(timelines: dict) -> dict:
    """Per-stage latency samples across every trace: where requests
    actually spend their time, fleet-wide.

    Stages (seconds):

    * ``enqueue_to_admit`` — router submit to the replica slot admit
      (queueing + dispatch + inbox transit: the congestion signal);
    * ``admit_to_first_token`` — admit to the first ``segment`` drain
      (prefill + first decode segment: the TTFT proxy);
    * ``inter_token`` — per-token pace inside decode: each consecutive
      segment gap divided by the later segment's ``steps``;
    * ``enqueue_to_terminal`` — the whole request, submit to its
      terminal router event.

    Plus ``redispatches`` — ``{count: requests}`` over redispatch
    events per trace (the death-recovery tail: anything over 0 means a
    request outlived a replica).
    """
    stages: dict[str, list[float]] = {
        "enqueue_to_admit": [], "admit_to_first_token": [],
        "inter_token": [], "enqueue_to_terminal": []}
    redispatches: dict[int, int] = {}
    n_traces = 0
    for tid, tl in timelines.items():
        if tid is None:
            continue
        n_traces += 1
        t_enq = t_admit = None
        segs: list[dict] = []
        n_re = 0
        t_term = None
        for ev in tl:
            kind, t = ev.get("kind"), ev.get("t")
            if kind == "enqueue" and t_enq is None:
                t_enq = t
            elif kind == "admit" and t_admit is None:
                t_admit = t
            elif kind == "segment":
                segs.append(ev)
            elif kind == "redispatch":
                n_re += 1
            elif kind in ("done", "shed", "timeout", "failed"):
                t_term = t
        redispatches[n_re] = redispatches.get(n_re, 0) + 1
        if t_enq is not None and t_admit is not None:
            stages["enqueue_to_admit"].append(t_admit - t_enq)
        if t_admit is not None and segs:
            stages["admit_to_first_token"].append(
                segs[0]["t"] - t_admit)
        for a, b in zip(segs, segs[1:]):
            steps = int(b.get("steps") or 1)
            if steps > 0 and b["t"] >= a["t"]:
                stages["inter_token"].append((b["t"] - a["t"]) / steps)
        if t_enq is not None and t_term is not None:
            stages["enqueue_to_terminal"].append(t_term - t_enq)
    out: dict = {"traces": n_traces, "redispatches": dict(sorted(
        redispatches.items()))}
    for stage, vals in stages.items():
        vals.sort()
        out[stage] = {
            "n": len(vals),
            "p50": _pct(vals, 0.50), "p90": _pct(vals, 0.90),
            "p99": _pct(vals, 0.99),
            "max": vals[-1] if vals else float("nan")}
    return out


def render_summary(summary: dict) -> list[str]:
    lines = [f"per-stage latency percentiles over "
             f"{summary['traces']} traces:"]
    for stage in ("enqueue_to_admit", "admit_to_first_token",
                  "inter_token", "enqueue_to_terminal"):
        s = summary[stage]
        lines.append(
            f"  {stage:<22} n={s['n']:<6} "
            f"p50={s['p50']:.4f}s p90={s['p90']:.4f}s "
            f"p99={s['p99']:.4f}s max={s['max']:.4f}s"
            if s["n"] else f"  {stage:<22} n=0      (no samples)")
    redis = summary["redispatches"]
    lines.append("redispatches per request: " + (" ".join(
        f"{k}x{v}" for k, v in redis.items()) or "(none)"))
    return lines


def to_chrome(events: list[dict]) -> dict:
    """Chrome-trace JSON of the merged view: one tid per trace id
    (trace-less fleet events land on tid 0), consecutive events drawn
    as the slice between them, terminal events as instants."""
    timelines = group_timelines(events)
    tids = {tid: n for n, tid in enumerate(
        sorted((t for t in timelines if t is not None)), start=1)}
    out: list[dict] = []
    for tid, timeline in sorted(timelines.items(),
                                key=lambda kv: str(kv[0])):
        track = tids.get(tid, 0)
        out.append({"name": "thread_name", "ph": "M", "pid": 0,
                    "tid": track,
                    "args": {"name": f"trace {tid or '(fleet)'}"}})
        for ev, nxt in zip(timeline, timeline[1:]):
            out.append({
                "name": ev.get("kind", "?"), "ph": "X",
                "ts": ev.get("t", 0.0) * 1e6,
                "dur": max(1.0, (nxt.get("t", 0.0) - ev.get("t", 0.0))
                           * 1e6),
                "pid": 0, "tid": track,
                "args": {k: v for k, v in ev.items()
                         if k not in ("t", "kind") and v is not None}})
        if timeline:
            last = timeline[-1]
            out.append({
                "name": last.get("kind", "?"), "ph": "i", "s": "t",
                "ts": last.get("t", 0.0) * 1e6, "pid": 0, "tid": track,
                "args": {k: v for k, v in last.items()
                         if k not in ("t", "kind") and v is not None}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpudist_torch.obs.timeline",
        description="Reconstruct per-request fleet timelines from a "
                    "merged event log (see tpudist_torch.obs.events).")
    ap.add_argument("path", help="event log / postmortem JSON")
    ap.add_argument("--trace", help="show only this trace id")
    ap.add_argument("--rid", help="show only the trace whose enqueue "
                                  "carries this caller rid")
    ap.add_argument("--chrome", metavar="OUT",
                    help="also write Chrome-trace JSON (atomic)")
    ap.add_argument("--summary", action="store_true",
                    help="print per-stage latency percentiles "
                         "(enqueue->admit, admit->first-token, "
                         "inter-token) and the redispatch histogram "
                         "instead of per-trace timelines")
    ap.add_argument("--require-complete", action="store_true",
                    help="exit 1 unless every resolved trace is "
                         "gap-free (CI gate)")
    args = ap.parse_args(argv)

    events = load_events(args.path)
    timelines = group_timelines(events)

    selected = timelines
    if args.trace is not None:
        if args.trace not in timelines:
            print(f"trace {args.trace!r} not in log "
                  f"({len(timelines)} traces)", file=sys.stderr)
            return 2
        selected = {args.trace: timelines[args.trace]}
    elif args.rid is not None:
        tl = timeline_for_rid(timelines, args.rid)
        if tl is None:
            print(f"no trace with enqueue rid={args.rid!r}",
                  file=sys.stderr)
            return 2
        selected = {tl[0].get("trace"): tl}

    if args.summary:
        print("\n".join(render_summary(summarize_timelines(selected))))
    else:
        for tid, timeline in sorted(selected.items(),
                                    key=lambda kv: str(kv[0])):
            if tid is None:
                continue   # trace-less fleet events: chrome export only
            print("\n".join(render_timeline(tid, timeline)))

    if args.chrome:
        atomic_write_json(args.chrome, to_chrome(events))
        print(f"chrome trace: {args.chrome}", file=sys.stderr)

    if args.require_complete:
        bad = [tid for tid, tl in timelines.items()
               if tid is not None
               and any(e.get("kind") in ("done", "shed", "timeout",
                                         "failed") for e in tl)
               and not is_complete(tl)]
        if bad:
            print(f"INCOMPLETE timelines: {bad}", file=sys.stderr)
            return 1
        print(f"all {sum(1 for t in timelines if t is not None)} "
              f"timelines complete", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
