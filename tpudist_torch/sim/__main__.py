"""CLI: run scenarios through the offline fleet simulator (counterpart of
``python -m tpudist.sim``).

Examples::

    # one scenario, summary row to stdout
    python -m tpudist_torch.sim --scenario flash_crowd

    # the whole builtin matrix, envelope-gated (CI's scenario job)
    python -m tpudist_torch.sim --all --check --jsonl SCENARIOS.jsonl

    # a spec file of your own
    python -m tpudist_torch.sim --spec my_scenario.json --check

    # replay a recorded tpudist.events/1 trace through the simulator
    python -m tpudist_torch.sim --replay trace.json

Rows are bench-schema JSONL (``metric``/``value``/``unit`` first, the
scenario summary as extra keys) — the same schema a live run emits, so
:mod:`tpudist_torch.sim.envelope` gates both identically.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpudist_torch.obs.export import jsonl_line
from tpudist_torch.sim.scenario import ScenarioSpec, builtin, names


def _row_line(row: dict) -> str:
    extra = {k: v for k, v in row.items() if k != "completed_ok"}
    return jsonl_line(f"scenario/{row['scenario']}", row["completed_ok"],
                      "reqs", None, **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Offline fleet simulator: run scenarios against the "
                    "real router/autoscaler code on a virtual clock")
    ap.add_argument("--scenario", action="append", default=[],
                    metavar="NAME",
                    help=f"builtin scenario (repeatable); one of: "
                         f"{', '.join(names())}")
    ap.add_argument("--all", action="store_true",
                    help="run every builtin scenario")
    ap.add_argument("--spec", action="append", default=[],
                    metavar="FILE.json",
                    help="scenario spec file (repeatable)")
    ap.add_argument("--replay", metavar="TRACE.json",
                    help="replay a recorded tpudist.events/1 document")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero on any envelope violation")
    ap.add_argument("--jsonl", metavar="PATH",
                    help="also append the rows to this file")
    args = ap.parse_args(argv)

    from tpudist_torch.sim.simulator import FleetSim

    specs: list[ScenarioSpec] = []
    for name in (names() if args.all else args.scenario):
        specs.append(builtin(name))
    for path in args.spec:
        specs.append(ScenarioSpec.from_json(path))
    if not specs and not args.replay:
        ap.error("pick --all, --scenario, --spec, or --replay")

    rows: list[dict] = []
    for spec in specs:
        rows.append(FleetSim(spec).run())
    if args.replay:
        with open(args.replay) as f:
            doc = json.load(f)
        rows.append(FleetSim.from_trace(doc).run())

    ok = True
    lines = [_row_line(r) for r in rows]
    for r, line in zip(rows, lines):
        print(line)
        if not r["envelope_ok"]:
            ok = False
            print(f"# envelope VIOLATED ({r['scenario']}): "
                  f"{'; '.join(r['violations'])}", file=sys.stderr)
    if args.jsonl:
        with open(args.jsonl, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if ok or not args.check else 1


if __name__ == "__main__":
    raise SystemExit(main())
