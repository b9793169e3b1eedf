#!/usr/bin/env python3
"""Time edited variants of a kernel source on one NVIDIA GPU.

    python3 scripts/kernel_variants.py {k7,merge} [--seed N]

Each variant is the kernel's source in ``tpudist_torch/csrc`` with a few
text edits; every variant is built with the port's nvcc flags (all at
once, into the git-ignored ``_scratch/variants/``), loaded with ctypes in
place of the wrapper's library, checked against the plain version and
timed as ``chip_smoke`` times kernels (CUDA-graph replays after an L2
flush).  A variant that drops work is expected to disagree: its
``tol_ratio`` is reported, not checked.

* ``k7``: K7's wgmma path at the training shape (T=16,384, d=512,
  f=2048, E=8, top-2, block 128): ``base``; ``loads_only`` (the products
  removed: the producer's weight stream alone); ``products_only`` (every
  weight copy zero-filled, so no L2 read: the products, GELU and shared
  stores alone); ``no_gelu`` (GELU replaced by a multiply).
* ``merge``: K2 at the serve decode rows (lengths 7680/5120/2560/300 and
  17 side tokens, H=8, Hkv=2, D=64, bf16) with the merge at one warp a
  CTA (``base``) and at four warps a CTA (``warps4``); the split pass's
  and the merge's device ms apart.

Prints the card (nvidia-smi), then one JSON line per variant.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

K7_UP = ("      Wgmma<kFC, 1>::ss(\n", "      if (0) Wgmma<kFC, 1>::ss(\n")
K7_DOWN = (("      Wgmma<128, 1>::rs(y0,", "      if (0) Wgmma<128, 1>::rs(y0,"),
           ("      Wgmma<128, 1>::rs(y1,", "      if (0) Wgmma<128, 1>::rs(y1,"))
VARIANTS = {
    "k7": ("moe_gmm", {
        "base": [],
        "loads_only": [K7_UP, *K7_DOWN],
        "products_only": [
            ("const bool ok = c * kFC + uch * 8 < f;", "const bool ok = false;"),
            ("const bool ok = f0 + r < f;", "const bool ok = false;")],
        "no_gelu": [("h[j] = gelu_fast(h[j]);", "h[j] = h[j] * 0.5f;")],
    }),
    "merge": ("flash_decode", {
        "base": [],
        "warps4": [
            ("__global__ void __launch_bounds__(32)\n    decode_merge_kernel(",
             "__global__ void __launch_bounds__(128)\n    decode_merge_kernel("),
            ("  const int lane = threadIdx.x;\n"
             "  const int g = H / Hkv, b = blockIdx.x / H, h = blockIdx.x % H,"
             " r = h % g;",
             "  const int lane = threadIdx.x % 32;\n"
             "  const int wq = blockIdx.x * 4 + threadIdx.x / 32;\n"
             "  const int g = H / Hkv, b = wq / H, h = wq % H, r = h % g;"),
            ("  float* w_s = merge_s;",
             "  float* w_s = merge_s + 2 * (threadIdx.x / 32) * n_split;"),
            ("decode_merge_kernel<T, D><<<a.B * a.H, 32, merge_bytes, stream>>>(",
             "decode_merge_kernel<T, D><<<a.B * a.H / 4, 128, 4 * merge_bytes,"
             " stream>>>(")],
    }),
}


def build(stem: str, variants: dict) -> dict[str, Path]:
    """Write and build every variant of csrc/<stem>.cu; {name: library}."""
    from tpudist_torch.ops import _cuda

    src = (_cuda.CSRC / f"{stem}.cu").read_text()
    out = ROOT / "_scratch" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: edit site not found once: {old!r}")
            text = text.replace(old, new)
        cu = out / f"{stem}_{name}.cu"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            cu.with_suffix(".so"))
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = lib
    return libs


def bind(kernel, lib: Path) -> None:
    """Point a wrapper's Kernel at a variant's library."""
    fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    kernel._fn = fn


def run_k7(torch, chip_smoke, libs, dev, seed) -> None:
    from tpudist_torch.models.moe import _gate_choices
    from tpudist_torch.ops import moe_dispatch as md

    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    T, E, K, bn, D, FF = 16384, 8, 2, 128, 512, 2048
    w_up = (torch.randn(E, D, FF, generator=g, device=dev) / D ** 0.5).to(bf)
    w_down = (torch.randn(E, FF, D, generator=g, device=dev)
              / FF ** 0.5).to(bf)
    x = torch.randn(T, D, generator=g, device=dev).to(bf)
    tv, ti, _ = _gate_choices(
        torch.softmax(torch.randn(T, E, generator=g, device=dev), -1), K)
    _, xs, gate, be, live = md._fused_layout(x, ti, tv, E, bn)
    want = md._gmm_plain(be, xs, gate, w_up, w_down, bn).float()
    lim = (chip_smoke.MOE_ATOL_REL * want.abs().max()
           + chip_smoke.MOE_RTOL * want.abs())
    for name, lib in libs.items():
        bind(md.MOE_GMM, lib)

        def call():
            return md._gmm(be, xs, gate, w_up, w_down, bn, live)

        ratio = ((call().float() - want).abs() / lim).max().item()
        chip_smoke.emit({"variant": name, "case": "train",
                         "ms": chip_smoke.timed_ms(call, 10, buf.zero_),
                         "tol_ratio": ratio})


def run_merge(torch, chip_smoke, libs, dev, seed) -> None:
    from tpudist_torch.ops import flash_decode as fd

    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    H, HKV, D, S, B, CAP = 8, 2, 64, 8192, 4, 32

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    q, kc, vc = rnd(B, 1, H, D), rnd(B, S, HKV * D), rnd(B, S, HKV * D)
    kw = dict(cache_len=torch.tensor([7680, 5120, 2560, 300],
                                     dtype=torch.int32, device=dev),
              side_k=rnd(B, CAP, HKV * D), side_v=rnd(B, CAP, HKV * D),
              side_len=torch.tensor(17, dtype=torch.int32, device=dev),
              packed_kv_heads=HKV)
    want = fd.flash_decode_plain(q, kc, vc, **kw).float()
    for name, lib in libs.items():
        bind(fd.FLASH_DECODE, lib)

        def call():
            return fd.flash_decode(q, kc, vc, **kw)

        err = (call().float() - want).abs()
        ratio = (err / (chip_smoke.O_ATOL
                        + chip_smoke.O_RTOL * want.abs())).max().item()
        chip_smoke.emit({"variant": name, "case": "serve_decode",
                         "ms": chip_smoke.timed_ms(call, 50, buf.zero_),
                         **chip_smoke.decode_split_ms(call, 20, buf.zero_),
                         "tol_ratio": ratio})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(VARIANTS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi(), flush=True)
    stem, variants = VARIANTS[args.kernel]
    libs = build(stem, variants)
    run = run_k7 if args.kernel == "k7" else run_merge
    run(torch, chip_smoke, libs, torch.device("cuda", 0), args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
