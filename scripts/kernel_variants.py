#!/usr/bin/env python3
"""Time edited variants of a kernel source on one NVIDIA GPU.

    python3 scripts/kernel_variants.py {k7,decode,decode_splits} [--seed N]
        [--only NAME,...] [--split-keys N,...]

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
* ``decode``: the decode split pass and merge at the serve decode rows
  (lengths 7680/5120/2560/300 of an 8k cache, H=8, Hkv=2, D=64, bf16;
  K2 and K5 with 17 of 32 side tokens, K5 at block 128, K6 over the int8
  cache without side tokens) under each split size the kernel is held
  at (32, 64, 128, 256 keys, the wrappers' split set to each):
  ``base``; ``warps8`` (the split pass at eight warps a
  CTA); ``merge_warps4`` (the merge at four warps a CTA); ``exit_at_len``,
  ``exit_at_k``, ``exit_at_scores``, ``exit_at_v`` (the split pass's live
  CTAs return once their range is known, once K has landed, after the
  scores, once V has landed: a timeline of its chain);
  each call's device ms and the split pass's and the merge's apart;
  first, the card's read rate under the same flush (``read_floor``: one
  ``torch.sum`` over each whole cache) and under a flush that reads
  instead of writing, with K2 (the tree's own build and split) timed
  there too.
* ``decode_splits``: the tree's own K2, K5 and K6 at the shapes the
  port's callers give them (``SPLIT_SHAPES``), each whole call timed
  under every split size the kernel is held at, in the order 32, 64,
  128, 256 then back, with the split pass and merge apart, the fastest
  size and the wrappers' ``_SPLIT_KEYS`` beside it.  Exits 1 if a result
  disagrees with its plain version.

``--only`` builds and times the named variants alone; ``--split-keys``
(decode, decode_splits) times those split sizes alone.  Prints the card
(nvidia-smi), then one JSON line per variant (or shape).
"""

from __future__ import annotations

import argparse
import contextlib
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
    "decode_splits": ("flash_decode", {"base": []}),
    "decode": ("flash_decode", {
        "base": [],
        "warps8": [("constexpr int kThreads = 128;",
                    "constexpr int kThreads = 256;")],
        # the split pass cut short at successive points (live CTAs return
        # there; the partials are left unwritten): a timeline of its chain
        "exit_at_len": [("  const int n = hi - lo;\n",
                         "  const int n = hi - lo;\n  if (n > 0) return;\n")],
        "exit_at_k": [("  // scores: lane (kk, c) takes bytes",
                       "  if (n > 0) return;\n"
                       "  // scores: lane (kk, c) takes bytes")],
        "exit_at_scores": [("  __syncthreads();\n\n  // per query row: max",
                            "  __syncthreads();\n  if (n > 0) return;\n\n"
                            "  // per query row: max")],
        "exit_at_v": [("  // unnormalized output: lane (kk, c) sums",
                       "  if (n > 0) return;\n"
                       "  // unnormalized output: lane (kk, c) sums")],
        "merge_warps4": [
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


# decode_splits: the shapes the port's callers give the decode kernels (H 8,
# Hkv 2, D 64): name: (kernel, dtype, rows B, capacity S, lengths, page
# block, side tokens of a side buffer's capacity, pos_offset)
SERVE_LENS = [7680, 5120, 2560, 300]
SPLIT_SHAPES = {
    # the serve rows (kernels, paged_kernels, decode_q8 phases)
    "serve_rows_K2": ("K2", "bf16", 4, 8192, SERVE_LENS, None, (17, 32), 0),
    "serve_rows_K5": ("K5", "bf16", 4, 8192, SERVE_LENS, 128, (17, 32), 0),
    "serve_rows_K6": ("K6", "bf16", 4, 8192, SERVE_LENS, None, None, 0),
    # serve_pipelined's ticks (4 lanes of 300 prompt + up to 256 new) and
    # serve_roles' paged mix (512-2,048 prompt + up to 256 new, block 128)
    "serve_tick_K2": ("K2", "bf16", 4, 8192, [556, 480, 400, 320], None,
                      (17, 32), 0),
    "serve_roles_K5": ("K5", "bf16", 4, 8192, [2200, 1150, 640, 1100], 128,
                       (17, 32), 0),
    # sharded_generate's rollouts (2 rows, 1,000 prompt + 32 new) and its
    # beams of 4, f32 over the 8k cache
    "sharded_generate": ("K2", "f32", 2, 8192, [1016] * 2, None, None, 0),
    "beam": ("K2", "f32", 4, 8192, [1016] * 4, None, None, 0),
    # the fleet's replicas: 4 slots over 4,224 keys, f32, segments of 16,
    # unified (K2) and paged at block 128 (K5)
    "fleet_K2": ("K2", "f32", 4, 4224, [4000, 2600, 1200, 600], None,
                 (9, 16), 0),
    "fleet_K5": ("K5", "f32", 4, 4224, [4000, 2600, 1200, 600], 128,
                 (9, 16), 0),
    # kv_tier: 2 slots over a 2k paged cache at block 32, segments of 8
    "kv_tier_K5": ("K5", "bf16", 2, 2048, [1040, 200], 32, (5, 8), 0),
    # sp_decode: the second of 4 shards of the serve rows' 8k cache
    "sp_shard": ("K2", "bf16", 4, 2048, SERVE_LENS, None, None, 2048),
    # a one-row decode
    "one_row": ("K2", "bf16", 1, 8192, [4000], None, None, 0),
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


@contextlib.contextmanager
def split_of(fd, ck):
    """The decode wrappers' split set to ``ck`` keys."""
    real = fd._SPLIT_KEYS
    fd._SPLIT_KEYS = ck
    try:
        yield
    finally:
        fd._SPLIT_KEYS = real


def run_k7(torch, chip_smoke, libs, dev, seed, _split_keys) -> None:
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


def run_decode(torch, chip_smoke, libs, dev, seed, split_keys) -> None:
    from tpudist_torch.ops import flash_decode as fd

    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    H, HKV, D, S, B, CAP, BS = 8, 2, 64, 8192, 4, 32, 128

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    q, kc, vc = rnd(B, 1, H, D), rnd(B, S, HKV * D), rnd(B, S, HKV * D)
    lens = torch.tensor([7680, 5120, 2560, 300], dtype=torch.int32,
                        device=dev)
    side = dict(side_k=rnd(B, CAP, HKV * D), side_v=rnd(B, CAP, HKV * D),
                side_len=torch.tensor(17, dtype=torch.int32, device=dev),
                packed_kv_heads=HKV)
    table = torch.randperm(B * S // BS, generator=g, device=dev).to(
        torch.int32).view(B, S // BS)
    kp, vp = kc.view(B * S // BS, BS, HKV * D), vc.view(B * S // BS, BS,
                                                         HKV * D)
    q8 = fd.quantize_kv(kc.view(B, S, HKV, D), vc.view(B, S, HKV, D))
    cases = {
        "K2": (fd.FLASH_DECODE,
               lambda: fd.flash_decode(q, kc, vc, lens, **side),
               fd.flash_decode_plain(q, kc, vc, lens, **side)),
        "K5": (fd.PAGED_FLASH_DECODE,
               lambda: fd.paged_flash_decode(q, kp, vp, table, lens, **side),
               fd.paged_flash_decode_plain(q, kp, vp, table, lens, **side)),
        "K6": (fd.FLASH_DECODE_Q8,
               lambda: fd.flash_decode_q8(q, *q8, lens),
               fd.flash_decode_q8_plain(q, *q8, lens)),
    }
    # the card's read rate under the same L2 flush: one torch.sum over each
    # whole cache (16.8 MB), the yardstick of the split pass's byte phase;
    # and under a flush that reads (leaving clean lines, nothing to write
    # back), with K2 timed there too
    for flush_name, flush in (("zero", buf.zero_), ("read", buf.sum)):
        floor = chip_smoke.timed_ms(lambda: (kc.sum(), vc.sum()), 50, flush)
        chip_smoke.emit({"case": "read_floor", "flush": flush_name,
                         "ms": floor, "bytes": 2 * kc.numel() * 2,
                         "gb_per_s": 2 * kc.numel() * 2 / floor / 1e6})
    k2 = cases["K2"][1]
    chip_smoke.emit({"case": "K2", "flush": "read",
                     "ms": chip_smoke.timed_ms(k2, 50, buf.sum),
                     **chip_smoke.decode_split_ms(k2, 20, buf.sum)})
    for name, lib in libs.items():
        for kernel, _, _ in cases.values():
            bind(kernel, lib)
        for case, (_, launch, want) in cases.items():
            for ck in split_keys or fd._SPLIT_SIZES:
                with split_of(fd, ck):
                    err = (launch().float() - want.float()).abs()
                    ratio = (err / (chip_smoke.O_ATOL + chip_smoke.O_RTOL
                                    * want.float().abs())).max().item()
                    chip_smoke.emit({
                        "variant": name, "case": case, "split_keys": ck,
                        "ms": chip_smoke.timed_ms(launch, 50, buf.zero_),
                        **chip_smoke.decode_split_ms(launch, 20, buf.zero_),
                        "tol_ratio": ratio})


def run_decode_splits(torch, chip_smoke, libs, dev, seed, split_keys) -> int:
    from tpudist_torch.ops import flash_decode as fd

    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    H, HKV, D = 8, 2, 64
    sizes = split_keys or list(fd._SPLIT_SIZES)
    order = sorted(sizes) + sorted(sizes, reverse=True)
    bad = 0
    for kernel in (fd.FLASH_DECODE, fd.PAGED_FLASH_DECODE,
                   fd.FLASH_DECODE_Q8):
        bind(kernel, libs["base"])
    for name, (kind, dt, B, S, lens, bs, side, off) in SPLIT_SHAPES.items():
        dt = torch.bfloat16 if dt == "bf16" else torch.float32

        def rnd(*shape, dt=dt):
            return torch.randn(*shape, generator=g, device=dev).to(dt)

        q, kc, vc = rnd(B, 1, H, D), rnd(B, S, HKV * D), rnd(B, S, HKV * D)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        kw = dict(packed_kv_heads=HKV)
        if side is not None:
            kw.update(side_k=rnd(B, side[1], HKV * D),
                      side_v=rnd(B, side[1], HKV * D),
                      side_len=torch.tensor(side[0], dtype=torch.int32,
                                            device=dev))
        if kind == "K5":
            table = torch.randperm(B * S // bs, generator=g, device=dev).to(
                torch.int32).view(B, S // bs)
            kp = kc.view(B * S // bs, bs, HKV * D)
            vp = vc.view(B * S // bs, bs, HKV * D)
            def call():
                return fd.paged_flash_decode(q, kp, vp, table, lens_t, **kw)

            want = fd.paged_flash_decode_plain(q, kp, vp, table, lens_t, **kw)
        elif kind == "K6":
            q8 = fd.quantize_kv(kc.view(B, S, HKV, D), vc.view(B, S, HKV, D))
            def call():
                return fd.flash_decode_q8(q, *q8, lens_t, pos_offset=off)

            want = fd.flash_decode_q8_plain(q, *q8, lens_t, pos_offset=off)
        else:
            def call():
                return fd.flash_decode(q, kc, vc, lens_t, pos_offset=off,
                                       **kw)

            want = fd.flash_decode_plain(q, kc, vc, lens_t, pos_offset=off,
                                         **kw)
        ours = fd._SPLIT_KEYS
        row = {"case": name, "kernel": kind, "split_keys": ours,
               "ms": {ck: [] for ck in sizes}, "parts": {}, "tol_ratio": 0.0}
        for i, ck in enumerate(order):
            with split_of(fd, ck):
                if i < len(sizes):
                    err = (call().float() - want.float()).abs()
                    row["tol_ratio"] = max(row["tol_ratio"], (err / (
                        chip_smoke.O_ATOL + chip_smoke.O_RTOL
                        * want.float().abs())).max().item())
                    row["parts"][ck] = chip_smoke.decode_split_ms(
                        call, 20, buf.zero_)
                row["ms"][ck].append(chip_smoke.timed_ms(call, 50, buf.zero_))
        best = min(sizes, key=lambda ck: sum(row["ms"][ck]))
        row.update(best=best, ours_over_best=sum(row["ms"][ours])
                   / sum(row["ms"][best]) if ours in row["ms"] else None)
        bad += row["tol_ratio"] > 1
        chip_smoke.emit(row)
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(VARIANTS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="")
    ap.add_argument("--split-keys", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi(), flush=True)
    stem, variants = VARIANTS[args.kernel]
    if args.only:
        variants = {k: variants[k] for k in args.only.split(",")}
    libs = build(stem, variants)
    run = {"k7": run_k7, "decode": run_decode,
           "decode_splits": run_decode_splits}[args.kernel]
    return run(torch, chip_smoke, libs, torch.device("cuda", 0), args.seed,
               [int(x) for x in args.split_keys.split(",") if x]) or 0


if __name__ == "__main__":
    sys.exit(main())
