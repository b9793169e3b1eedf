#!/usr/bin/env python3
"""Time the port's kernels of two trees on one NVIDIA GPU, in turns.

    python3 scripts/flash_bwd_compare.py --parent DIR [--phases P,...]
        [--order pccp] [--out FILE] [--seed N]

DIR holds an unpacked older tree of this repository (``git archive``).
Each run imports ``chip_smoke`` from one tree in a fresh subprocess, so
that tree's ``tpudist_torch`` builds and runs its own kernels, and runs
the named ``chip_smoke`` phases there (default ``kernels_bwd`` and
``kernels_ring``): ``kernels`` gives K1 at the serve offsets and K2 at
the serve decode rows, ``kernels_paged`` K5 and K6 there,
``kernels_moe`` K7 at bench_moe's layer, the training shape, skewed
routing and block 16, ``kernels_bwd`` and ``kernels_ring`` the backward
(K3, K8, K4), ``kernels_gn`` K9 and K10 (fused GroupNorm) at ResNet50's
site shapes, the f32 layer1 tail and the 224 px stem, with the path each
took; ``train``, ``train_sp``, ``train_moe`` and ``serve`` give the steps
and the prefill, ``gn_sites`` the 53 GroupNorm sites of a ResNet50 step,
fused and closed form, summed.  This script's own phases: ``k1_sp`` (K1 at
train_sp's shape, B=1, S=8192, H=8, Hkv=2, D=64, beside SDPA's forward,
which older trees' phases do not time) and ``prefill`` (one 7,680-token
prompt admitted in one shot by the serve model's ServeLoop, on the host
clock and under torch.profiler: device ms, K1's share).  The trees run in
turns, ``--order`` naming them (p = parent, c = change, u = change with
the backward's planner held to one split, f = change with K1's planner
held to one split, so that a split's share of a gain shows; default
parent, change, change, parent), so drift of the card shows as a
difference between a tree's two runs.  Prints each run's phase lines,
then one JSON summary: per timed case, each kernel's device ms in every
run (K1 at the serve offsets, the training shape and train_sp's shape;
K2, K5, K6 with their split pass and merge apart where the tree times
them; K3, K8, K4; K7 with the path it took; K9 and K10 with theirs),
the bound, the library call's time; per step phase, ms per step, the profiled attention ms and
K7's; for serve, prefill and decode tokens/s.  ``--out`` writes the
summary there as well.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = {
    "kernels": "chip_smoke.phase_kernels(torch, dev, {seed})",
    "kernels_paged": "chip_smoke.phase_paged_kernels(torch, dev, {seed})",
    "kernels_moe": "chip_smoke.phase_moe_kernels(torch, dev, {seed})",
    "train_moe": "chip_smoke.phase_train_moe(torch, dev, {seed})",
    "kernels_bwd": "chip_smoke.phase_backward_kernels(torch, dev, {seed})",
    "kernels_ring": "chip_smoke.phase_ring_kernels(torch, dev, {seed})",
    "train": "chip_smoke.phase_train(torch, dev, {seed})",
    "train_sp": "chip_smoke.phase_train_sp(torch, dev, {seed})",
    "serve": "chip_smoke.phase_serve(torch, dev, {seed})",
    "kernels_gn": "chip_smoke.phase_gn_kernels(torch, dev, {seed})",
    "gn_sites": "chip_smoke.phase_gn_sites(torch, dev, {seed})",
    "k1_sp": "k1_sp(torch, dev, {seed})",
    "prefill": "prefill(torch, dev, {seed})",
}
# this script's phases, defined in the runner (they use only what every
# tree of the port has: _flash_forward, ServeLoop._admit, chip_smoke's
# timing and model helpers)
OWN_PHASES = r"""
def k1_sp(torch, dev, seed):
    import torch.nn.functional as F
    from tpudist_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush = buf.zero_
    B, S, H, HKV, D = 1, 8192, 8, 2, 64
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=dev).to(
        torch.bfloat16) for n in (H, HKV, HKV))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    pairs = B * H * S * (S + 1) // 2
    bound = chip_smoke.bound(4 * (q.numel() + k.numel()) + B * H * S * 4,
                             4.0 * pairs * D)
    chip_smoke.emit({"phase": "k1_sp", "shape": [B, S, H, HKV, D],
        "ms": chip_smoke.timed_ms(lambda: fa._flash_forward(q, k, v, True),
                                  10, flush),
        "sdpa_ms": chip_smoke.timed_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 10, flush),
        "bound_ms": bound[0], "bound_by": bound[1]})

def prefill(torch, dev, seed):
    import time
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from tpudist_torch.models.serving import Request, ServeLoop
    from tpudist_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig(vocab_size=32000, num_layers=8, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=8192,
                            compute_dtype=torch.bfloat16)
    sd = chip_smoke.random_model(torch, cfg, dev, seed + 1).state_dict()
    loop = ServeLoop(cfg, sd, num_slots=4, steps_per_sync=32,
                     prefill_chunk=512, pipeline_depth=1, device=dev)
    loop.chunked = False
    prompt = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, 7680).astype(np.int32)
    loop._admit(0, Request(prompt, 4))           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop._admit(1, Request(prompt, 4))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop._admit(2, Request(prompt, 4))
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    device = sum(t for _, t in rows)
    k1 = sum(t for key, t in rows if "flash_fwd" in key)
    chip_smoke.emit({"phase": "prefill", "prompt": 7680, "chunk": 512,
                     "wall_ms": wall, "device_ms": device, "k1_ms": k1,
                     "device_busy_share": device / wall})
"""
RUNNER = r"""
import sys
sys.path.insert(0, {tree!r})
import torch
import chip_smoke
import tpudist_torch
assert tpudist_torch.__file__.startswith({tree!r}), tpudist_torch.__file__
dev = torch.device("cuda", 0)
{own}
{patch}
{calls}
"""
# u: every backward call takes one split, its walk whole
UNSPLIT = """
from tpudist_torch.ops import flash_attention as fa
fa._bwd_plan_for = lambda q, k, **kw: fa.BwdPlan(1, 1 << 30, 1, 1 << 30)
"""
# f: every K1 call takes one split, its walk whole
UNSPLIT_FWD = """
from tpudist_torch.ops import flash_attention as fa
fa._fwd_plan_for = lambda q, k, **kw: fa.FwdPlan(1, 1 << 30)
"""
PATCHES = {"u": UNSPLIT, "f": UNSPLIT_FWD}


def run_tree(tree: Path, phases: list[str], seed: int,
             patch: str = "") -> dict:
    """Run the phases in a subprocess importing ``tree`` (after ``patch``);
    return ``{phase: its JSON line}``."""
    calls = "\n".join(PHASES[p].format(seed=seed) for p in phases)
    res = subprocess.run(
        [sys.executable, "-c", RUNNER.format(
            tree=str(tree), calls=calls, own=OWN_PHASES, patch=patch)],
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
    """``{case: {kernel: ms}}`` from the kernels, kernels_bwd and
    kernels_ring lines, with the bound, SDPA's time and the plan beside
    them."""
    out = {}
    for row in lines.get("kernels", {}).get("K1", []):
        out[f"serve/q_offset_{row['q_offset']}"] = {
            "K1": row["ms"], "K1_bound": row["bound_ms"],
            "sdpa": row["library_ms"], "plan": row.get("plan")}
    decode = [("K2", row) for row in lines.get("kernels", {}).get("K2", [])]
    for key in ("K5", "K6"):
        decode += [(key, row)
                   for row in lines.get("kernels_paged", {}).get(key, [])]
    for key, row in decode:
        out[f"decode/{key}_{row['case']}"] = {
            key: row["ms"], f"{key}_bound": row["bound_ms"],
            "library": row.get("library_ms"),
            **{k: row[k] for k in ("partial_ms", "merge_ms") if k in row}}
    for row in lines.get("kernels_moe", {}).get("K7", []):
        out[f"moe/{row['case']}"] = {
            "K7": row["ms"], "K7_bound": row["bound_ms"],
            "library": row.get("library_ms"),
            **{k: row[k] for k in ("design_bound_ms", "variant")
               if k in row}}
    sp = lines.get("k1_sp")
    if sp:
        out["train_sp/K1"] = {"K1": sp["ms"], "K1_bound": sp["bound_ms"],
                              "sdpa": sp["sdpa_ms"]}
    k1_train = lines.get("kernels_bwd", {}).get("K1_train")
    if k1_train:
        out["train/K1"] = {"K1": k1_train["ms"],
                           "K1_bound": k1_train["bound_ms"],
                           "sdpa": k1_train["library_ms"],
                           "plan": k1_train.get("plan")}
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
        if "ms" in row["K1"]:
            t.update({"K1": row["K1"]["ms"],
                      "K1_bound": row["K1"]["bound_ms"],
                      "K1_sdpa": row["K1"]["library_ms"],
                      "K1_plan": row["K1"]["plan"]})
        out[f"ring/{row['case']}"] = t
    for row in lines.get("kernels_gn", {}).get("cases", []):
        t = {}
        for key in ("K9", "K10"):
            k = row[key]
            t.update({key: k["ms"], f"{key}_bound": k["bound_ms"],
                      f"{key}_library": k["library_ms"]})
            if "path" in k:   # trees before the cluster path have one
                t[f"{key}_path"] = k["path"]
                t[f"{key}_parts"] = k["parts"]
                if "other" in k:
                    t[f"{key}_other"] = k["other"]
        out[f"gn/{row['case']}"] = t
    return out


def step_times(lines: dict) -> dict:
    out = {}
    for phase in ("train", "train_sp", "train_moe"):
        doc = lines.get(phase)
        if doc:
            fam = doc["profile"]["by_family_ms"]
            out[phase] = {"ms_per_step": doc["ms_per_step"],
                          "device_ms": doc["profile"]["device_ms"],
                          "attention_ms": sum(
                              t for f, t in fam.items()
                              if f.startswith("attention")),
                          "k7_ms": fam.get("MoE grouped GEMM (K7)"),
                          "by_family_ms": fam,
                          "dense_flash_ms_per_step":
                              doc.get("dense_flash_ms_per_step")}
    doc = lines.get("prefill")
    if doc:
        out["prefill"] = {k: doc[k] for k in (
            "wall_ms", "device_ms", "k1_ms", "device_busy_share")}
    doc = lines.get("gn_sites")
    if doc:
        out["gn_sites"] = {k: doc[k] for k in (
            "fused_fwd_ms", "fused_fwd_bwd_ms", "closed_fwd_ms",
            "closed_fwd_bwd_ms", "bound_fwd_ms", "bound_fwd_bwd_ms")}
        out["gn_sites"]["launches"] = doc["launches"]
    doc = lines.get("serve")
    if doc:
        out["serve"] = {k: doc[k] for k in (
            "wall_s", "prefill_s", "prefill_tokens_per_s",
            "decode_tokens_per_s", "decode_ms_per_tick")}
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
    trees = {"p": Path(args.parent).resolve(), "c": ROOT, "u": ROOT,
             "f": ROOT}
    runs = []
    for i, key in enumerate(args.order):
        lines = run_tree(trees[key], phases, args.seed,
                         patch=PATCHES.get(key, ""))
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
