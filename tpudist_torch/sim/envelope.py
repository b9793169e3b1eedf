"""The shared SLO-envelope checker CI gates scenario runs on (counterpart
of :mod:`tpudist.sim.envelope`).

Both execution paths — live replay and offline simulation — emit one
bench-JSONL row per scenario (``"metric": "scenario/{name}"`` with the
summary fields as extra keys).  This module is the one place that
decides whether such a row is inside its envelope, so the live bench,
the offline matrix, and the CI job cannot drift apart on what "green"
means.

Deliberately light: imports only :mod:`tpudist_torch.sim.scenario` (pure
stdlib), so the CI gate can run it without torch installed —
the same discipline as ``bench.py``'s heredoc asserts.

CLI::

    python -m tpudist_torch.sim.envelope BENCH.jsonl --min-scenarios 5

exits nonzero when any scenario row violates its envelope, a builtin
scenario is missing, or fewer than ``--min-scenarios`` rows are found.
"""

from __future__ import annotations

import json

from tpudist_torch.sim.scenario import BUILTIN, Envelope, ScenarioSpec

__all__ = ["scenario_rows", "check_row", "check_rows", "main"]


def scenario_rows(path: str) -> list[dict]:
    """The ``scenario/*`` rows of a bench-JSONL file (non-JSON lines —
    log noise around the bench output — are skipped)."""
    rows: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            metric = row.get("metric", "")
            if metric.startswith("scenario/"):
                rows.append(row)
    return rows


def check_row(row: dict, envelope: Envelope | None = None) -> list[str]:
    """Violations for one scenario row.  With no explicit envelope the
    scenario's BUILTIN envelope is used (re-checked from the row's raw
    fields — the emitter's own ``envelope_ok`` flag is evidence, not
    authority); a non-builtin scenario with no envelope passed is only
    held to its embedded verdict."""
    name = str(row.get("scenario")
               or row.get("metric", "")[len("scenario/"):])
    if envelope is None and name in BUILTIN:
        envelope = ScenarioSpec.from_dict(BUILTIN[name]).envelope
    bad = list(envelope.check(row)) if envelope is not None else []
    if row.get("envelope_ok") is False and not bad:
        bad.extend(row.get("violations")
                   or ["emitter flagged envelope_ok=false"])
    return bad


def check_rows(rows: list[dict], *, min_scenarios: int = 5,
               require_builtin: bool = True) -> tuple[bool, list[str]]:
    """(ok, report) for a matrix run: every row inside its envelope,
    at least ``min_scenarios`` distinct scenarios, and (by default)
    every BUILTIN scenario present."""
    report: list[str] = []
    ok = True
    seen: set[str] = set()
    for row in rows:
        name = str(row.get("scenario")
                   or row.get("metric", "")[len("scenario/"):])
        seen.add(name)
        bad = check_row(row)
        if bad:
            ok = False
            report.append(f"FAIL {name}: " + "; ".join(bad))
        else:
            report.append(
                f"ok   {name}: completed_ok={row.get('completed_ok')} "
                f"p99_wait={row.get('p99_queue_wait_s')}s "
                f"ups={row.get('scale_ups')} drains={row.get('drains')}")
    if len(seen) < min_scenarios:
        ok = False
        report.append(f"FAIL matrix: only {len(seen)} scenario(s), "
                      f"need >= {min_scenarios}")
    if require_builtin:
        missing = sorted(set(BUILTIN) - seen)
        if missing:
            ok = False
            report.append(f"FAIL matrix: builtin scenario(s) missing "
                          f"from the run: {missing}")
    return ok, report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Gate a bench-JSONL file on per-scenario SLO "
                    "envelopes")
    ap.add_argument("jsonl", help="bench JSONL file (scenario/* rows)")
    ap.add_argument("--min-scenarios", type=int, default=5)
    ap.add_argument("--no-require-builtin", action="store_true",
                    help="don't demand every builtin scenario be present")
    args = ap.parse_args(argv)
    rows = scenario_rows(args.jsonl)
    ok, report = check_rows(rows, min_scenarios=args.min_scenarios,
                            require_builtin=not args.no_require_builtin)
    for line in report:
        print(line)
    print("ENVELOPES", "OK" if ok else "VIOLATED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
