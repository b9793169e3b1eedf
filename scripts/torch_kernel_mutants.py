#!/usr/bin/env python3
"""Mutation check of the port's kernels, on an NVIDIA GPU.

    python3 scripts/torch_kernel_mutants.py [--out DIR] [--seed N]

For each mutant — K1 with its walk's first K/V tile dropped, K1's split
merge leaving out each row's last non-empty split, K3 with its first
live K/V tile's contribution dropped,
K4 with its first live q-tile's dropped (every group member's), the
split walks' sum (K3, K8 and K4) leaving out each tile's last non-empty
split, K5 reading each page's table entry one page too far
(``table[b, page + 1]``), the decode merge (K2, K5, K6) leaving out each
row's last live split, K6 with the V scale left out of the value
product, K7's mma.sync path with the gate left out of its epilogue,
K7's wgmma path skipping its last f-chunk, writing the second half of d
into the first's columns, or dropping the gate on every slot that has
one, K8 reading the caller's Delta as zero, K9 taking the variance as
``E[x²]`` (the ``mean²`` dropped), K10 with the ReLU mask left out (both
on the cluster and the two-pass path: one expression serves both), and
the cluster path's sum over its CTAs (K9 and K10) leaving out the last
CTA's partials — copies
``tpudist_torch/`` into ``DIR/<mutant>/`` (default ``_scratch/mutants``,
git-ignored) with this tree's built kernel libraries (so only the broken
source rebuilds), breaks the kernel source there, and runs the
``chip_smoke`` phase that holds that kernel against its plain version
(``phase_kernels``, ``phase_backward_kernels``, ``phase_paged_kernels``,
``phase_moe_kernels``, ``phase_ring_kernels``, or for K9 and K10
``phase_gn_kernels`` and gn_sites' check against the closed form,
``gn_sites_check``) against the broken copy in a subprocess, with
``chip_smoke.check`` replaced by a collector.
Prints one JSON line per mutant: the worst ``tol_ratio`` of each kernel
in each case and the checks that failed.  Exits non-zero if any mutant
passes every check (the check would not see the fault).  Needs the CUDA
toolkit; each copy builds its own kernels.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FWD = "csrc/flash_attention.cu"
BWD, DEC = "csrc/flash_attention_bwd.cu", "csrc/flash_decode.cu"
GMM, GN = "csrc/moe_gmm.cu", "csrc/group_norm.cu"
K1_FIRST = "      softmax_tile(s, rows, a, off, q0, w.lo * kBK, t4, sl2);\n"
K1_MERGE_END = "(w.hi + a.chunk - 1) / a.chunk : first;"
K3_STEP = ("    const int kt = w.lo + i * kBK;\n"
           "    uint8_t* Ks = kv_stage(i);\n")
K4_STEP = "    const int qt = w.lo + (i / group) * BQ;\n"
SPLIT_SUM = "      for (int sp = 0; sp < parts; ++sp) {\n"
K5_TABLE = "a.table[(long long)b * a.M + first + i]"
MERGE_SUM = "  for (int j = 0; j < n_live; ++j) {"
K6_PV = "sr[j] = round_to<__nv_bfloat16>(p * vsc[j]);"
K7_GATE = "const float gt = a.gate[row0 + r];"
K7_CHUNKS = "const int nc = (f + kFC - 1) / kFC;"
K7_OUT_COL = "const long long out_col = (long long)half * kNT;"
K7_WG_GATE = "const float g0 = a.gate[row0 + r0], g1 = a.gate[row0 + r0 + 8];"
K8_DELTA = "Dl[r] = q0 + r < a.Sq ? a.delta[row_base + q0 + r] : 0.f;"
K9_VAR = "const float var = a2 / n - mean * mean;"
K10_MASK = "(pre > 0.f ? dy : 0.f)"
RANK_SUM = "if (r < ranks) a += v[r];"
# the chip_smoke phase that holds the kernel, and the expression (over its
# return value `out`) giving {case: {kernel: tol_ratio}}
FWD_RUN = ("k1, _ = chip_smoke.phase_kernels(torch, dev, {seed})",
           '{r["q_offset"]: {"tol_ratio": r["tol_ratio"], '
           '"lse_err": r["lse_err"], "plan": r["plan"]} for r in k1}')
BWD_RUN = ("rows, _ = chip_smoke.phase_backward_kernels(torch, dev, {seed})",
           '{r["case"]: {"K3": r["K3"]["tol_ratio"], '
           '"K4": r["K4"]["tol_ratio"]} for r in rows}')
DEC_RUN = ("out = chip_smoke.phase_paged_kernels(torch, dev, {seed})",
           '{k + "_" + r["case"]: r["tol_ratio"] for k in ("K5", "K6") '
           'for r in out[k]}')
GMM_RUN = ("rows, _ = chip_smoke.phase_moe_kernels(torch, dev, {seed})",
           '{r["case"]: r["tol_ratio"] for r in rows}')
RING_RUN = ("rows = chip_smoke.phase_ring_kernels(torch, dev, {seed})",
            '{r["case"]: r["tol_ratio"] for r in rows}')
# kernels_gn's worst ratio by case; gn_sites' worst y ratio and share of
# gradient elements beyond the limit, by site mode
GN_RUN = ("rows = chip_smoke.phase_gn_kernels(torch, dev, {seed})\n"
          "_, _, sites = chip_smoke.gn_sites_check(torch, dev, {seed})",
          '{"kernels_gn": {r["case"]: r["tol_ratio"] for r in rows}, '
          '"gn_sites": {m: {k: max(s[k] for s in sites if s["mode"] == m) '
          'for k in ("y_ratio", "beyond_share", "grad_ratio_held")} '
          'for m in ("relu", "add_relu", "plain")}}')
MUTANTS = {
    "K1_drop_first_k_tile": (
        FWD, FWD_RUN, K1_FIRST,
        "      if (w.lo == fwd_walk(a, off, q0).lo)\n"
        "        for (int j = 0; j < kBK / 2; ++j) s[j] = -INFINITY;\n"
        + K1_FIRST),
    "K1_merge_drops_last_split": (
        FWD, FWD_RUN, K1_MERGE_END,
        "(w.hi + a.chunk - 1) / a.chunk - 1 : first;"),
    "K3_drop_first_k_tile": (BWD, BWD_RUN, K3_STEP,
                             "    if (i == 0) continue;\n" + K3_STEP),
    "K4_drop_first_q_tile": (BWD, BWD_RUN, K4_STEP,
                             "    if (i < group) continue;\n" + K4_STEP),
    "split_sum_drops_last_split": (
        BWD, RING_RUN, SPLIT_SUM,
        "      for (int sp = 0; sp < parts - 1; ++sp) {\n"),
    "K5_table_entry_plus_one": (
        DEC, DEC_RUN, K5_TABLE, "a.table[(long long)b * a.M + first + i + 1]"),
    "merge_drops_last_live_split": (
        DEC, DEC_RUN, MERGE_SUM, "  for (int j = 0; j < n_live - 1; ++j) {"),
    "K6_skip_v_scale": (DEC, DEC_RUN, K6_PV,
                        "sr[j] = round_to<__nv_bfloat16>(p);"),
    "K7_no_gate_in_epilogue": (GMM, GMM_RUN, K7_GATE,
                               "const float gt = 1.f;"),
    "K7_skips_last_chunk": (GMM, GMM_RUN, K7_CHUNKS,
                            "const int nc = (f + kFC - 1) / kFC - 1;"),
    "K7_second_half_into_first": (GMM, GMM_RUN, K7_OUT_COL,
                                  "const long long out_col = 0;"),
    "K7_wgmma_no_gate": (
        GMM, GMM_RUN, K7_WG_GATE,
        "const float g0 = a.gate[row0 + r0] != 0.f ? 1.f : 0.f,\n"
        "              g1 = a.gate[row0 + r0 + 8] != 0.f ? 1.f : 0.f;"),
    "K8_delta_read_as_zero": (BWD, RING_RUN, K8_DELTA, "Dl[r] = 0.f;"),
    "K9_variance_without_mean_sq": (GN, GN_RUN, K9_VAR,
                                    "const float var = a2 / n;"),
    "K10_no_relu_mask": (GN, GN_RUN, K10_MASK, "dy"),
    "cluster_sum_drops_last_rank": (GN, GN_RUN, RANK_SUM,
                                    "if (r < ranks - 1) a += v[r];"),
}

RUNNER = r"""
import json, sys
sys.path.insert(0, {mut!r})
sys.path.insert(1, {root!r})
import torch
import chip_smoke
failed = []
chip_smoke.check = lambda cond, msg: None if cond else failed.append(msg)
dev = torch.device("cuda", 0)
{run}
import tpudist_torch
assert tpudist_torch.__file__.startswith({mut!r}), tpudist_torch.__file__
print(json.dumps({{"failed_checks": failed, "tol_ratio": {ratios}}}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "_scratch" / "mutants"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from tpudist_torch.ops import _cuda

    built = _cuda.build()   # the unbroken libraries, reused by each copy
    missed = []
    for name, (rel, (run, ratios), old, new) in MUTANTS.items():
        mut = Path(args.out) / name
        shutil.rmtree(mut, ignore_errors=True)
        shutil.copytree(ROOT / "tpudist_torch", mut / "tpudist_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        (mut / "tpudist_torch" / "_build").mkdir()
        for lib in built.values():
            shutil.copy2(lib, mut / "tpudist_torch" / "_build" / lib.name)
        src = mut / "tpudist_torch" / rel
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: mutation site not found once")
        src.write_text(text.replace(old, new))
        res = subprocess.run(
            [sys.executable, "-c", RUNNER.format(
                mut=str(mut), root=str(ROOT), ratios=ratios,
                run=run.format(seed=args.seed))],
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
