#!/usr/bin/env python3
"""Mutation check of the port's backward kernels, on an NVIDIA GPU.

    python3 scripts/torch_kernel_mutants.py [--out DIR] [--seed N]

For each mutant — K3 with its first live K/V tile's contribution dropped,
K4 with its first live q-tile's dropped — copies ``tpudist_torch/`` into
``DIR/<mutant>/`` (default ``_scratch/mutants``, git-ignored), breaks the
kernel source there, and runs ``chip_smoke.phase_backward_kernels``
against the broken copy in a subprocess, with ``chip_smoke.check``
replaced by a collector.  Prints one JSON line per mutant: the worst
``tol_ratio`` of each kernel in each case and the checks that failed.
Exits non-zero if any mutant passes every check (the check would not see
the fault).  Needs the CUDA toolkit; each copy builds its own kernels.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = "csrc/flash_attention_bwd.cu"
K3_PRODUCTS = "    two_products<T, NT, D>(s, dp, Qw, Kw, dOw, Vw, r0, g, t4);\n"
K4_PRODUCTS = ("      two_products<T, NT, D>(s, dp, Kw, Qw, Vw, dOw, r0, g, "
               "t4);\n")
MUTANTS = {
    "K3_drop_first_k_tile": (
        K3_PRODUCTS, "    if (kt == kv_lo) continue;\n" + K3_PRODUCTS),
    "K4_drop_first_q_tile": (
        K4_PRODUCTS, "      if (qt == q_lo) continue;\n" + K4_PRODUCTS),
}

RUNNER = r"""
import json, sys
sys.path.insert(0, {mut!r})
sys.path.insert(1, {root!r})
import torch
import chip_smoke
failed = []
chip_smoke.check = lambda cond, msg: None if cond else failed.append(msg)
rows, _ = chip_smoke.phase_backward_kernels(torch, torch.device("cuda", 0),
                                            {seed})
import tpudist_torch
assert tpudist_torch.__file__.startswith({mut!r}), tpudist_torch.__file__
print(json.dumps({{"failed_checks": failed, "tol_ratio": {{
    r["case"]: {{"K3": r["K3"]["tol_ratio"], "K4": r["K4"]["tol_ratio"]}}
    for r in rows}}}}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "_scratch" / "mutants"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    missed = []
    for name, (old, new) in MUTANTS.items():
        mut = Path(args.out) / name
        shutil.rmtree(mut, ignore_errors=True)
        shutil.copytree(ROOT / "tpudist_torch", mut / "tpudist_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = mut / "tpudist_torch" / SRC
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: mutation site not found once")
        src.write_text(text.replace(old, new))
        res = subprocess.run(
            [sys.executable, "-c", RUNNER.format(mut=str(mut),
                                                 root=str(ROOT),
                                                 seed=args.seed)],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"{name}: runner failed\n{res.stderr[-4000:]}")
        result = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"mutant": name, **result}), flush=True)
        if not result["failed_checks"]:
            missed.append(name)
    if missed:
        print(f"mutants not caught: {missed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
