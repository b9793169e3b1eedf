"""``python -m tpudist_torch.obs.console`` — the fleet operations console
(counterpart of :mod:`tpudist.obs.console`; a doc renders to the same
bytes).

A terminal dashboard over the observability plane this package already
ships: fleet topology from ``{ns}/replica/*`` registrations + live
leases, per-pool queue/KV sparklines from the :class:`~.tsdb.TSDB`,
firing alerts from the :class:`~.alerts.AlertManager`, and the most
recent request trace terminals from the merged event timeline.

Two modes:

* **Live** (default): connect to the coordinator, run a
  :class:`~.tsdb.FleetScraper` + default alert rules in-process, and
  redraw every ``--interval`` seconds.
* **Snapshot** (``--once [--snapshot FILE]``): render ONE frame — from
  a recorded ``tpudist.console/1`` doc (CI smoke: must exit 0 against
  the checked-in fixture) or from a single live scrape — and exit.

Everything renders through :func:`render`, a pure function of the doc,
so tests and CI never need a terminal or a fleet.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from tpudist_torch.obs.alerts import AlertManager, default_rules
from tpudist_torch.obs.events import TERMINAL_KINDS
from tpudist_torch.obs.tsdb import TSDB, FleetScraper

__all__ = ["gather", "render", "main", "CONSOLE_SCHEMA"]

CONSOLE_SCHEMA = "tpudist.console/1"

_SPARK = "▁▂▃▄▅▆▇█"

# the series panel: what an operator triages from, in order.  Only
# series present in the doc render; suffix-matching keeps pool/label
# variants (e.g. serve/queue_wait_s/p90~pool=decode) visible.
_PANEL_SERIES = (
    "serve/queue_depth",
    "serve/queue_wait_s/p90",
    "fleet/kv_free_frac",
    "fleet/tier_headroom_frac",
    "fleet/coord_up",
    "fleet/replicas_publishing",
    "slo/burn_rate_60s",
)


def sparkline(values: list[float], width: int = 32) -> str:
    """Unicode sparkline of the last ``width`` values (empty-safe)."""
    vals = [v for v in values if v == v][-width:]   # drop NaN
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(vals)
    return "".join(_SPARK[min(len(_SPARK) - 1,
                              int((v - lo) / span * (len(_SPARK) - 1)))]
                   for v in vals)


def gather(client, namespace: str, *, tsdb: TSDB | None = None,
           alerts: AlertManager | None = None,
           events: list[dict] | None = None) -> dict:
    """One ``tpudist.console/1`` doc from a live coordinator: replica
    topology, merged metrics, TSDB dump, alert state, recent events."""
    from tpudist_torch.obs.aggregate import collect, merge_snapshots

    doc: dict = {"schema": CONSOLE_SCHEMA, "namespace": namespace,
                 "generated_at": time.time(), "replicas": {},
                 "merged": {}, "tsdb": None, "alerts": None, "events": []}
    live = set()
    try:
        mark = f"{namespace}:"
        live = {name[len(mark):] for name in client.live()
                if name.startswith(mark)}
    except Exception:  # noqa: BLE001 - no lease API on this client
        pass
    draining = {k.rsplit("/", 1)[-1]
                for k in client.keys(f"{namespace}/draining/")}
    quarantined = {k.rsplit("/", 1)[-1]
                   for k in client.keys(f"{namespace}/quarantined/")}
    prefix = f"{namespace}/replica/"
    for key in client.keys(prefix):
        raw = client.get(key)
        if raw is None:
            continue
        rid = key[len(prefix):]
        info = json.loads(raw.decode()) if isinstance(raw, bytes) else raw
        doc["replicas"][rid] = {
            "rank": info.get("rank"),
            "role": info.get("role", "both"),
            "live": rid in live,
            "draining": rid in draining,
            "quarantined": rid in quarantined,
        }
    snaps = collect(client, f"{namespace}/metrics", max_age_s=30.0)
    doc["merged"] = merge_snapshots(snaps)
    if tsdb is not None:
        doc["tsdb"] = tsdb.to_doc(window_s=120.0)
    if alerts is not None:
        doc["alerts"] = alerts.to_doc()
    if events is not None:
        doc["events"] = events[-200:]
    else:
        # merge_events returns the tpudist.events/1 doc; tpudist slices
        # the doc itself, which raises, so its live frames show no
        # terminals (ROADMAP Queue C 12)
        try:
            from tpudist_torch.obs.events import collect_events, merge_events
            doc["events"] = merge_events(collect_events(
                client, f"{namespace}/events"))["events"][-200:]
        except Exception:  # noqa: BLE001 - no event ring published
            doc["events"] = []
    return doc


def _fmt_val(v: float | None) -> str:
    if v is None:
        return "-"
    if v != v:
        return "nan"
    if abs(v) >= 1000 or v == int(v):
        return f"{v:.0f}"
    return f"{v:.3f}"


def render(doc: dict, width: int = 96) -> str:
    """One frame of the console, as plain text (pure function)."""
    out: list[str] = []
    ns = doc.get("namespace", "?")
    stamp = doc.get("generated_at")
    when = (time.strftime("%H:%M:%S", time.localtime(stamp))
            if stamp else "?")
    out.append(f"tpudist fleet console — ns={ns} — {when}")
    out.append("=" * min(width, 96))

    replicas = doc.get("replicas") or {}
    n_live = sum(1 for r in replicas.values() if r.get("live"))
    n_drain = sum(1 for r in replicas.values() if r.get("draining"))
    n_quar = sum(1 for r in replicas.values() if r.get("quarantined"))
    out.append(f"REPLICAS  ({n_live} live, {n_drain} draining, "
               f"{n_quar} quarantined)")
    if replicas:
        out.append(f"  {'rid':<10}{'rank':<6}{'role':<10}{'state':<14}")
        for rid in sorted(replicas):
            r = replicas[rid]
            state = ("quarantined" if r.get("quarantined")
                     else "draining" if r.get("draining")
                     else "live" if r.get("live") else "lost")
            out.append(f"  {rid:<10}{str(r.get('rank', '?')):<6}"
                       f"{r.get('role', 'both'):<10}{state:<14}")
    else:
        out.append("  (none registered)")

    alerts = doc.get("alerts") or {}
    active = alerts.get("active") or []
    firing = [a for a in active if a.get("state") == "firing"]
    pending = [a for a in active if a.get("state") == "pending"]
    out.append("")
    out.append(f"ALERTS    ({len(firing)} firing, {len(pending)} pending, "
               f"rules={alerts.get('rules_hash', '-')})")
    if active:
        for a in active:
            out.append(f"  [{a.get('severity', '?').upper():<4}] "
                       f"{a.get('rule'):<24} {a.get('state'):<8} "
                       f"value={_fmt_val(a.get('value'))}")
    else:
        out.append("  (none)")
    fired_ever = alerts.get("fired_ever") or []
    if fired_ever:
        out.append(f"  fired this session: {', '.join(fired_ever)}")

    tsdb = doc.get("tsdb") or {}
    series = tsdb.get("series") or {}
    out.append("")
    stats = tsdb.get("stats") or {}
    out.append(f"SERIES    ({stats.get('series', 0)} series, "
               f"~{stats.get('approx_bytes', 0) // 1024} KiB of "
               f"{stats.get('byte_budget', 0) // 1024} KiB budget)")
    shown = 0
    for want in _PANEL_SERIES:
        for name in sorted(series):
            if name != want and not name.startswith(want + "~"):
                continue
            pts = series[name].get("points") or []
            vals = [p[1] for p in pts]
            last = _fmt_val(vals[-1]) if vals else "-"
            out.append(f"  {name:<34} {sparkline(vals):<32} {last:>8}")
            shown += 1
    if not shown:
        out.append("  (no series scraped yet)")

    events = doc.get("events") or []
    terminals = [e for e in events if e.get("kind") in TERMINAL_KINDS]
    out.append("")
    out.append(f"RECENT TERMINALS  (last {min(len(terminals), 8)} of "
               f"{len(terminals)})")
    for e in terminals[-8:]:
        t = e.get("t")
        hhmm = (time.strftime("%H:%M:%S", time.localtime(t))
                if isinstance(t, (int, float)) else "?")
        trace = str(e.get("trace", ""))[:12]
        req = e.get("rid", e.get("i", "?"))
        out.append(f"  {hhmm}  {e.get('kind', '?'):<8} "
                   f"req={req!s:<12} trace={trace}")
    if not terminals:
        out.append("  (none)")
    out.append("")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpudist_torch.obs.console",
        description="tpudist fleet operations console")
    p.add_argument("--coord", default=None,
                   help="coordinator host:port (live mode)")
    p.add_argument("--namespace", default="fleet")
    p.add_argument("--interval", type=float, default=2.0,
                   help="redraw cadence in live mode")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit 0 (CI mode)")
    p.add_argument("--snapshot", default=None,
                   help="render a recorded tpudist.console/1 doc "
                        "instead of connecting (implies --once)")
    p.add_argument("--width", type=int, default=96)
    args = p.parse_args(argv)

    if args.snapshot is not None:
        with open(args.snapshot, encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("schema") != CONSOLE_SCHEMA:
            print(f"error: {args.snapshot} is not a {CONSOLE_SCHEMA} doc",
                  file=sys.stderr)
            return 2
        print(render(doc, width=args.width))
        return 0

    if args.coord is None:
        print("error: need --coord host:port (or --snapshot FILE)",
              file=sys.stderr)
        return 2

    from tpudist_torch.runtime.coord import CoordClient

    host, port = args.coord.rsplit(":", 1)
    client = CoordClient(host, int(port))
    tsdb = TSDB.from_env()
    alerts = AlertManager(tsdb, default_rules())
    scraper = FleetScraper(tsdb, client=client, namespace=args.namespace,
                           alerts=alerts, interval_s=args.interval)
    try:
        while True:
            scraper.tick()
            doc = gather(client, args.namespace, tsdb=tsdb, alerts=alerts)
            frame = render(doc, width=args.width)
            if args.once:
                print(frame)
                return 0
            # clear + home, then the frame (plain ANSI; no curses dep)
            sys.stdout.write("\x1b[2J\x1b[H" + frame)
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
