#!/usr/bin/env python3
"""Time the flash-attention backward of two trees on one NVIDIA GPU.

    python3 scripts/flash_bwd_compare.py --parent DIR [--phases P,...]
        [--order pccp] [--out FILE] [--seed N]

DIR holds an unpacked older tree of this repository (``git archive``).
Each run imports ``chip_smoke`` from one tree in a fresh subprocess, so
that tree's ``tpudist_torch`` builds and runs its own kernels, and runs
the named ``chip_smoke`` phases there (default ``kernels_bwd`` and
``kernels_ring``; ``train`` and ``train_sp`` give the steps).  The trees
run in turns, ``--order`` naming them (p = parent, c = change, u = change
with the backward's planner held to one split, so that the split's share
of a gain shows; default parent, change, change, parent), so drift of the
card shows as a difference between a tree's two runs.  Prints each run's
phase lines, then one JSON summary: per timed case, each kernel's device
ms in every run, the bound and SDPA's backward; per step phase, ms per
step and the profiled attention ms.  ``--out`` writes the summary there
as well.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = {
    "kernels_bwd": "chip_smoke.phase_backward_kernels(torch, dev, {seed})",
    "kernels_ring": "chip_smoke.phase_ring_kernels(torch, dev, {seed})",
    "train": "chip_smoke.phase_train(torch, dev, {seed})",
    "train_sp": "chip_smoke.phase_train_sp(torch, dev, {seed})",
}
RUNNER = r"""
import sys
sys.path.insert(0, {tree!r})
import torch
import chip_smoke
import tpudist_torch
assert tpudist_torch.__file__.startswith({tree!r}), tpudist_torch.__file__
dev = torch.device("cuda", 0)
{patch}
{calls}
"""
# u: every backward call takes one split, its walk whole
UNSPLIT = """
from tpudist_torch.ops import flash_attention as fa
fa._bwd_plan_for = lambda q, k, **kw: fa.BwdPlan(1, 1 << 30, 1, 1 << 30)
"""


def run_tree(tree: Path, phases: list[str], seed: int,
             unsplit: bool = False) -> dict:
    """Run the phases in a subprocess importing ``tree``; return
    ``{phase: its JSON line}``."""
    calls = "\n".join(PHASES[p].format(seed=seed) for p in phases)
    res = subprocess.run(
        [sys.executable, "-c", RUNNER.format(
            tree=str(tree), calls=calls, patch=UNSPLIT if unsplit else "")],
        capture_output=True, text=True, timeout=1800, cwd=tree)
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: runner failed\n{res.stderr[-4000:]}")
    lines = {}
    for line in res.stdout.splitlines():
        if line.startswith("{"):
            doc = json.loads(line)
            if doc.get("phase") in PHASES:
                lines[doc["phase"]] = doc
    return lines


def kernel_times(lines: dict) -> dict:
    """``{case: {kernel: ms}}`` from the kernels_bwd and kernels_ring
    lines, with the bound and SDPA's backward beside them."""
    out = {}
    for row in lines.get("kernels_bwd", {}).get("cases", []):
        out[f"bwd/{row['case']}"] = {
            "K3": row["K3"]["ms"], "K4": row["K4"]["ms"],
            "K3_bound": row["K3"]["bound_ms"],
            "K4_bound": row["K4"]["bound_ms"],
            "sdpa_bwd": row["library_ms"], "plan": row.get("plan")}
    for row in lines.get("kernels_ring", {}).get("K8", []):
        t = {"K8": row["ms"], "K8_bound": row["bound_ms"],
             "plan": row.get("plan")}
        if "K3_ms" in row:
            t["K3"] = row["K3_ms"]
        if "ms" in row["K4"]:
            t["K4"], t["K4_bound"] = row["K4"]["ms"], row["K4"]["bound_ms"]
        if row.get("library_ms") is not None:
            t["sdpa_bwd"] = row["library_ms"]
        out[f"ring/{row['case']}"] = t
    return out


def step_times(lines: dict) -> dict:
    out = {}
    for phase in ("train", "train_sp"):
        doc = lines.get(phase)
        if doc:
            fam = doc["profile"]["by_family_ms"]
            out[phase] = {"ms_per_step": doc["ms_per_step"],
                          "device_ms": doc["profile"]["device_ms"],
                          "attention_ms": sum(
                              t for f, t in fam.items()
                              if f.startswith("attention")),
                          "dense_flash_ms_per_step":
                              doc.get("dense_flash_ms_per_step")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--phases", default="kernels_bwd,kernels_ring")
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    trees = {"p": Path(args.parent).resolve(), "c": ROOT, "u": ROOT}
    runs = []
    for i, key in enumerate(args.order):
        lines = run_tree(trees[key], phases, args.seed, unsplit=key == "u")
        for doc in lines.values():
            print(json.dumps({"run": i, "tree": key, **doc}), flush=True)
        runs.append((key, lines))
    summary = {"order": args.order, "kernels": {}, "steps": {}}
    for i, (key, lines) in enumerate(runs):
        for case, t in kernel_times(lines).items():
            summary["kernels"].setdefault(case, {})[f"{i}{key}"] = t
        for phase, t in step_times(lines).items():
            summary["steps"].setdefault(phase, {})[f"{i}{key}"] = t
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
