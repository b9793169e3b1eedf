#!/usr/bin/env python3
"""Time K9 and K10 (fused GroupNorm) over their launch configurations, on
an NVIDIA GPU.

    python3 scripts/gn_sweep.py [--shapes sites|tail] [--out FILE]

At each ResNet50 GroupNorm site shape (``chip_smoke.GN_SITE_SHAPES``,
batch 128, bf16, each mode the shape takes) and the 224 px stem, runs
both kernels on the two-pass path and on the cluster path at every
cluster size (1, 2, 4, 8) and CTA width (256, 512 threads) that the card
can launch, each held against the plain versions at ``chip_smoke``'s
tolerances (a configuration that disagrees fails the run), and prints
one JSON line per shape: each configuration's device ms (CUDA-graph
replays after an L2 flush, ``chip_smoke.timed_ms``), its clusters
resident at once (``cudaOccupancyMaxActiveClusters``), the bound, the
planner's choice.  This is what the planner's cluster sizes rest on.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def configs(gn, b, hw, c, dt, mode, backward):
    """The plans to time: two-pass, and every cluster size and width
    that fits."""
    es = dt.itemsize
    vpr = c * es // 16
    out = [gn._gn_plan(b, hw, c, dt, mode, backward, path="two_pass")]
    for n in (1, 2, 4, 8):
        if n > hw:
            continue
        for threads in (256, 512):
            if threads < vpr:
                continue
            rows = -(-hw // n)
            smem = gn._cluster_smem(rows, c, 32, es, threads // vpr,
                                    backward)
            if smem <= gn._SMEM_OPTIN:
                out.append(gn.GnPlan("cluster", n, rows, threads, smem))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="sites", choices=("sites", "tail"))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from tpudist_torch.ops import group_norm as gn

    if not torch.cuda.is_available():
        print("gn_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    cases = [(128, hw, c, mode, bf) for (hw, c), modes in cs.GN_SITE_SHAPES
             for mode in modes]
    cases.append((64, 12544, 64, "relu", bf))
    if args.shapes == "tail":
        cases = [(128, 1024, 256, "add_relu", bf)]
    buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush = buf.zero_
    g = torch.Generator(device=dev).manual_seed(7)
    lines = [cs.nvidia_smi()]
    print(lines[0], flush=True)
    for b, hw, c, mode, dt in cases:
        h = int(round(hw ** 0.5))
        x = (torch.randn(b, h, h, c, generator=g, device=dev)
             + torch.randn(c, generator=g, device=dev)).to(dt)
        res, dy = (torch.randn(b, h, h, c, generator=g, device=dev).to(dt)
                   for _ in range(2))
        scale = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        r = res if mode == "add_relu" else None
        flat = (lambda t: None if t is None else t.reshape(b, hw, c))
        py, pmean, prstd = gn._fused_fwd_plain(flat(x), scale, bias, flat(r),
                                               32, 1e-6, mode)
        pdx, _, _, pdres = gn._fused_bwd_plain(flat(x), flat(dy), scale,
                                               bias, pmean, prstd, flat(r),
                                               32, mode)
        row = {"shape": [b, hw, c], "mode": mode,
               "planned": {k: gn._gn_plan(b, hw, c, dt, mode, bw).path
                           for k, bw in (("K9", False), ("K10", True))},
               "bound_ms": {k: cs.gn_bound(b, hw, c, mode, 2, bw)[0]
                            for k, bw in (("K9", False), ("K10", True))},
               "K9": [], "K10": []}
        for key, backward in (("K9", False), ("K10", True)):
            for plan in configs(gn, b, hw, c, dt, mode, backward):
                fits = (gn._cluster_fit(dt, mode, backward, hw, c, 32, plan)
                        if plan.path == "cluster" else None)
                if backward:
                    def run():
                        return gn._fused_call_bwd(x, dy, scale, bias, pmean,
                                                  prstd, r, 32, mode, plan)
                    out = run()
                    ok = cs.grad_ratio(out[0].reshape(pdx.shape), pdx) <= 1
                    if pdres is not None:
                        ok &= torch.equal(out[3].reshape(pdres.shape), pdres)
                else:
                    def run():
                        return gn._fused_call_fwd(x, scale, bias, r, 32,
                                                  1e-6, mode, plan)
                    ok = cs.o_ratio(run()[0].reshape(py.shape), py) <= 1
                cs.check(ok, f"gn_sweep: {key} {plan} disagrees with the "
                         f"plain version at {[b, hw, c]} {mode}")
                row[key].append({"path": plan.path, "parts": plan.parts,
                                 "threads": plan.threads, "smem": plan.smem,
                                 "clusters_resident": fits,
                                 "ms": cs.timed_ms(run, 10, flush)})
        print(json.dumps(row), flush=True)
        lines.append(row)
    if args.out:
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
