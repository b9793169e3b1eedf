#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpudist_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line and each fatal on failure:

1. device  — the card (nvidia-smi name and power limit) and the CUDA build;
2. build   — nvcc builds every kernel in tpudist_torch/csrc;
3. kernels — each kernel against its plain PyTorch version on the card, in
   bf16, at the serve path's shapes (each O element within 2e-3 + 2e-2
   times the plain value, the LSE within 1e-3), with its time, the plain
   version's, one PyTorch library call's (a yardstick only; the port never calls it)
   and the least time the card could take (bytes or operations bound);
4. parity  — a full-width 2-layer f32 model: ServeLoop completions (per-row
   and side-buffer decode) equal each request's own greedy_generate rollout
   (scalar decode), both through flash-prefill; cached-prefill logits on
   the card agree with the CPU plain path;
5. serve   — the full-width 8-layer bf16 serve model (random weights from
   --seed): 8 mixed-length requests through a 4-slot ServeLoop, with
   kernel launch counts reset just before and read just after;
6. profile — one 32-tick decode segment of the serve model on the host
   clock and under torch.profiler (device busy share, the kernels that
   take the device's time);
7. kernels_bwd — the backward kernels K3 (dQ and Delta) and K4 (dK, dV)
   against their plain versions in bf16 at the training shape (causal,
   and with a 512 window) and at bench.py's flash shape, each gradient
   element within 1e-2 * max|plain| + 2e-2 * |plain|, Delta within 1e-3,
   with times beside the bound and SDPA's backward; K1 at the training
   shape beside its bound;
8. train_parity — a full-width 2-layer f32 model trained 3 Adam steps
   through flash attention (K1, K3, K4) and through the plain sdpa from
   the same weights and batches: losses and every gradient agree;
9. train — the full-width 8-layer serve model trained in bf16 with f32
   master weights (seq 2048, batch 8, the markov stream from --seed):
   20 steps through make_dp_train_step with launch counts reset just
   before and read just after (K1 = K3 = K4 = steps x layers), the loss
   falling; ms per step, tokens/s, model FLOPs and their share of the
   bf16 peak, peak memory; then one step under torch.profiler.

Kernel times are device times: CUDA-graph replays with the L2 cache
flushed before each call (see ``timed_ms``).

Then the card's name and power limit as nvidia-smi prints them, the kernel
summary as one JSON line, and last the result line.  Exits non-zero
without a result when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# Kernel against its plain version, bf16 inputs: each O element within
# O_ATOL + O_RTOL * |plain O| (O's scale falls as the softmax spreads:
# about sqrt(e / n) over n keys, 0.02 at 8k), the f32 LSE within LSE_ATOL
O_ATOL, O_RTOL, LSE_ATOL = 2e-3, 2e-2, 1e-3
# Backward kernels against their plain versions, bf16: each dQ/dK/dV
# element within GRAD_ATOL_REL * max|plain| + GRAD_RTOL * |plain|.  Both
# round dS and P to bf16 at the same points, but sum in other orders, so
# an element of dS may land one bf16 ulp (2^-8 relative) away and its
# error spreads over a whole row of the next product: an error of order
# 2^-8 times the gradient's typical size.  A flat limit relative to the
# gradient's largest element covers that; the relative term covers the
# largest elements.  Delta is f32 in both, within DELTA_ATOL.
GRAD_ATOL_REL, GRAD_RTOL, DELTA_ATOL = 1e-2, 2e-2, 1e-3
# train_parity: flash (K1/K3/K4, exact f32 FMAs) against the plain sdpa
# (f32 einsum and softmax, TF32 off): the loss within LOSS_RTOL relative,
# each parameter's gradient within PGRAD_TOL * max|sdpa gradient| (sums in
# other orders, through 2 layers and a 32000-way softmax)
LOSS_RTOL, PGRAD_TOL = 1e-5, 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int, flush) -> float:
    """Device time of one ``fn`` call with a cold L2 cache (the serve path
    finds a layer's K/V cold: 8 layers of cache exceed the 50 MB L2).

    ``iters`` rounds of (flush, ``fn``) are captured in one CUDA graph and
    a second graph holds the flushes alone; the difference of their
    replay times, per round, is ``fn``'s device time.  Replaying a graph
    leaves no host gap between launches, so the wrapper's Python and
    ctypes overhead is not counted as device time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up: builds, allocator, handles
        flush()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = []
    for with_fn in (True, False):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                flush()
                if with_fn:
                    fn()
        graphs.append(graph)

    def replay_ms(graph) -> float:
        graph.replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    ms = (replay_ms(graphs[0]) - replay_ms(graphs[1])) / iters
    del graphs
    torch.cuda.synchronize()
    return ms


def compare(o, lse, po, plse) -> tuple[float, float, float]:
    """(max |O| error, max |LSE| error, worst ratio of an O element's error
    to its limit O_ATOL + O_RTOL * |plain|); the kernel agrees when the
    ratio is at most 1 and the LSE error at most LSE_ATOL."""
    diff = (o.float() - po.float()).abs()
    ratio = (diff / (O_ATOL + O_RTOL * po.float().abs())).max().item()
    return diff.max().item(), (lse - plse).abs().max().item(), ratio


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, dev, seed):
    import torch.nn.functional as F

    from tpudist_torch.ops import flash_attention as fa
    from tpudist_torch.ops import flash_decode as fd

    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    # K1 at the prefill shapes: a 512-token chunk of one request against
    # the packed 8k cache of the serve model (H=8, Hkv=2, D=64)
    H, HKV, D, S, C = 8, 2, 64, 8192, 512
    k1 = []
    kc, vc = rnd(1, S, HKV * D), rnd(1, S, HKV * D)
    k4, v4 = kc.view(1, S, HKV, D), vc.view(1, S, HKV, D)
    for q_off in (0, 4096, 7168):
        q = rnd(1, C, H, D)
        off = torch.tensor(q_off, dtype=torch.int32, device=dev)
        o, lse = fa._flash_forward(q, k4, v4, True, q_offset=off)
        po, plse = fa._flash_forward_plain(q, k4, v4, True, q_offset=off)
        err_o, err_l, ratio = compare(o, lse, po, plse)
        check(ratio <= 1.0 and err_l <= LSE_ATOL,
              f"K1 disagrees with its plain version at q_offset={q_off}: "
              f"O {err_o} (ratio to limit {ratio}) LSE {err_l}")
        live = min(S, q_off + C)
        pairs = sum(min(S, q_off + r + 1) for r in range(C))
        nbytes = (2 * q.numel() * 2 + H * C * 4 + 2 * live * HKV * D * 2)
        b_ms, b_by = bound(nbytes, 4.0 * pairs * D * H)
        qt, kt, vt = q.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2)
        mask = (torch.arange(S, device=dev)[None, :]
                <= torch.arange(q_off, q_off + C, device=dev)[:, None])
        k1.append({
            "q_offset": q_off, "max_abs_err": err_o, "lse_err": err_l,
            "tol_ratio": ratio,
            "ms": timed_ms(lambda: fa._flash_forward(q, k4, v4, True,
                                                     q_offset=off), 20, flush),
            "plain_ms": timed_ms(lambda: fa._flash_forward_plain(
                q, k4, v4, True, q_offset=off), 5, flush),
            "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 20, flush),
            "bound_ms": b_ms, "bound_by": b_by})

    # K2 at the decode shapes: 4 slots at per-row lengths, the side buffer
    # (capacity steps_per_sync = 32) holding 17 tokens; and a scalar length
    B, CAP = 4, 32
    lens = torch.tensor([7680, 5120, 2560, 300], dtype=torch.int32,
                        device=dev)
    kc, vc = rnd(B, S, HKV * D), rnd(B, S, HKV * D)
    sk, sv = rnd(B, CAP, HKV * D), rnd(B, CAP, HKV * D)
    side_len = torch.tensor(17, dtype=torch.int32, device=dev)
    # greedy_generate's scalar decode passes the cache index as a 0-D
    # device tensor
    scalar_len = torch.tensor(7000, dtype=torch.int32, device=dev)
    q = rnd(B, 1, H, D)
    k2 = []
    for name, kw, n_live in (
            ("per_row_side", dict(cache_len=lens, side_k=sk, side_v=sv,
                                  side_len=side_len),
             int(lens.sum()) + B * 17),
            ("scalar", dict(cache_len=scalar_len), B * 7000)):
        o, lse = fd.flash_decode(q, kc, vc, packed_kv_heads=HKV,
                                 return_lse=True, **kw)
        po, plse = fd.flash_decode_plain(q, kc, vc, packed_kv_heads=HKV,
                                         return_lse=True, **kw)
        err_o, err_l, ratio = compare(o, lse, po, plse)
        check(ratio <= 1.0 and err_l <= LSE_ATOL,
              f"K2 disagrees with its plain version ({name}): O {err_o} "
              f"(ratio to limit {ratio}) LSE {err_l}")
        nbytes = 2 * n_live * HKV * D * 2 + 2 * q.numel() * 2
        b_ms, b_by = bound(nbytes, 4.0 * n_live * H * D)
        # the library yardstick: SDPA over main cache + side buffer with
        # a boolean mask (the concatenation is made outside the timing)
        if "side_k" in kw:
            keys = torch.cat([kc, sk], 1).view(B, S + CAP, HKV, D)
            vals = torch.cat([vc, sv], 1).view(B, S + CAP, HKV, D)
            pos = torch.arange(S + CAP, device=dev)
            m = torch.where(pos < S, pos < lens[:, None],
                            pos - S < 17)[:, None, None, :]
        else:
            keys, vals = kc.view(B, S, HKV, D), vc.view(B, S, HKV, D)
            m = (torch.arange(S, device=dev) < 7000)[None, None, None, :]
        qt, kt, vt = q.transpose(1, 2), keys.transpose(1, 2), \
            vals.transpose(1, 2)
        k2.append({
            "case": name, "max_abs_err": err_o, "lse_err": err_l,
            "tol_ratio": ratio,
            "ms": timed_ms(lambda: fd.flash_decode(
                q, kc, vc, packed_kv_heads=HKV, **kw), 50, flush),
            "plain_ms": timed_ms(lambda: fd.flash_decode_plain(
                q, kc, vc, packed_kv_heads=HKV, **kw), 10, flush),
            "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=m, enable_gqa=True), 50, flush),
            "bound_ms": b_ms, "bound_by": b_by})
    del flush_buf
    emit({"phase": "kernels", "K1": k1, "K2": k2,
          "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                        "lse_atol": LSE_ATOL}})
    return k1, k2


def _counters() -> dict:
    from tpudist_torch.ops import flash_attention as fa
    from tpudist_torch.ops.flash_decode import FLASH_DECODE

    return {"K1": fa.FLASH_FORWARD, "K2": FLASH_DECODE,
            "K3": fa.FLASH_BWD_DQ, "K4": fa.FLASH_BWD_DKV}


def reset_launches():
    for kernel in _counters().values():
        kernel.launches = 0


def read_launches() -> dict:
    return {name: k.launches for name, k in _counters().items()}


def random_model(torch, cfg, dev, seed):
    from tpudist_torch.models.transformer import TransformerLM

    g = torch.Generator(device=dev).manual_seed(seed)
    return TransformerLM(cfg, device=dev).init_weights(g)


def phase_parity(torch, dev, seed):
    import numpy as np

    from tpudist_torch.models.generate import (
        _prefill,
        build_model,
        greedy_generate,
    )
    from tpudist_torch.models.serving import Request, ServeLoop
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        blank_cache,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(vocab_size=32000, num_layers=2, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=8192,
                            compute_dtype=torch.float32)
    sd = random_model(torch, cfg, dev, seed).state_dict()
    rng = np.random.default_rng(seed)
    lens, new = [1100, 37, 600, 513], 24
    reqs = [Request(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    new, rid=i) for i, n in enumerate(lens)]
    reset_launches()
    loop = ServeLoop(cfg, sd, num_slots=2, steps_per_sync=8,
                     prefill_chunk=512, device=dev)
    comps = loop.run(reqs)
    serve_launches = read_launches()
    check(len(comps) == len(reqs), "parity: missing completions")
    check(serve_launches["K1"] > 0 and serve_launches["K2"] > 0,
          f"parity: ServeLoop did not run both kernels {serve_launches}")
    reset_launches()
    mismatched = []
    for c in comps:
        want = greedy_generate(cfg, sd, c.prompt[None], new,
                               prefill_chunk=512,
                               device=dev).cpu().numpy()[0, len(c.prompt):]
        if not np.array_equal(c.tokens, want):
            mismatched.append(c.rid)
    greedy_launches = read_launches()
    check(not mismatched, f"parity: ServeLoop != greedy_generate for "
          f"requests {mismatched}")
    check(greedy_launches["K1"] > 0 and greedy_launches["K2"] > 0,
          f"parity: greedy_generate did not run both kernels "
          f"{greedy_launches}")
    # cached-prefill logits on the card (K1) against the CPU plain path
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 96)))
    with torch.no_grad():
        m_gpu = build_model(cfg, sd, device=dev)
        _, lg = _prefill(m_gpu, blank_cache(cfg, 1, device=dev),
                         toks.to(dev), 32)
        cpu_sd = {k: v.cpu() for k, v in sd.items()}
        m_cpu = build_model(cfg, cpu_sd, device="cpu")
        _, lc = _prefill(m_cpu, blank_cache(cfg, 1, device="cpu"), toks, 32)
    logit_err = (lg.cpu() - lc).abs().max().item()
    check(bool(torch.isfinite(lg).all()) and lg.shape == (1, 32, 32000),
          "parity: non-finite or misshapen logits")
    check(logit_err <= 1e-3, f"parity: card logits differ from the CPU "
          f"plain path by {logit_err}")
    emit({"phase": "parity", "requests": len(comps), "tokens_each": new,
          "exact": True, "launches_serve": serve_launches,
          "launches_greedy": greedy_launches,
          "logit_max_abs_err_vs_cpu": logit_err})


def phase_serve(torch, dev, seed):
    import numpy as np

    from tpudist_torch.models.serving import Request, ServeLoop, ServeStats
    from tpudist_torch.models.transformer import TransformerConfig

    # bench.py's serve_loop model at its TPU widths
    cfg = TransformerConfig(vocab_size=32000, num_layers=8, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=8192,
                            compute_dtype=torch.bfloat16)
    sd = random_model(torch, cfg, dev, seed + 1).state_dict()
    loop = ServeLoop(cfg, sd, num_slots=4, steps_per_sync=32,
                     prefill_chunk=512, device=dev)
    rng = np.random.default_rng(seed + 1)
    # warm-up (cuBLAS handles, allocator) outside the measured run
    loop.run([Request(rng.integers(0, 32000, 600).astype(np.int32), 4)])
    lens = [7680, 5120, 2560, 7680, 2560, 5120, 7680, 2560]
    new = 64
    reqs = [Request(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    new, rid=i) for i, n in enumerate(lens)]
    loop.stats = ServeStats()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    comps = loop.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = loop.stats
    check(len(comps) == len(reqs), "serve: missing completions")
    for c in comps:
        check(c.reason == "length" and c.tokens.shape == (new,)
              and int(c.tokens.min()) >= 0
              and int(c.tokens.max()) < cfg.vocab_size,
              f"serve: bad completion {c.rid}: {c.reason} "
              f"{c.tokens.shape}")
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"serve: a kernel of the path was never launched {launches}")
    emit({"phase": "serve",
          "completions": [{"rid": c.rid, "reason": c.reason,
                           "tokens": len(c.tokens),
                           "head": [int(t) for t in c.tokens[:6]]}
                          for c in comps],
          "launches": launches, "wall_s": wall,
          "prefill_s": st.prefill_seconds,
          "prefill_tokens_per_s": st.prompt_tokens / st.prefill_seconds,
          "decode_s": st.decode_seconds,
          "decode_tokens": st.decode_tokens,
          "decode_tokens_per_s": st.decode_tokens / st.decode_seconds,
          "segments": st.segments, "ticks": st.ticks,
          "decode_ms_per_tick": st.decode_seconds / st.ticks * 1e3,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev)})
    return launches, loop


def phase_profile(torch, loop, seed):
    """Where a decode tick's time goes: 4 lanes admitted at lengths
    7680/5120/2560/300, one 32-tick segment timed on the host clock, and
    the same segment's device kernels read with ``torch.profiler`` (CUDA
    activity only).  Device busy share = kernel time / host wall."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tpudist_torch.models.serving import Request

    rng = np.random.default_rng(seed + 2)
    v = loop.cfg.vocab_size
    loop.chunked = False               # one-shot admission: lanes decode
    for slot, n in enumerate((7680, 5120, 2560, 300)):
        loop._admit(slot, Request(rng.integers(0, v, n).astype(np.int32),
                                  200))
    loop._segment(32)                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop._segment(32)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop._segment(32)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    check(device_ms > 0, "profile: the profiler saw no device time")
    emit({"phase": "profile", "ticks": 32, "wall_ms": wall_ms,
          "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
          "top": [{"kernel": k[:80], "ms": ms, "count": n}
                  for k, ms, n in rows[:12]]})


def grad_ratio(got, want) -> float:
    """Worst ratio of an element's error to its limit GRAD_ATOL_REL *
    max|plain| + GRAD_RTOL * |plain|; the kernel agrees at <= 1."""
    got, want = got.float(), want.float()
    lim = GRAD_ATOL_REL * want.abs().max() + GRAD_RTOL * want.abs()
    return ((got - want).abs() / lim).max().item()


def live_pairs(s: int, window) -> int:
    """Live (query, key) pairs of one head under a causal mask over s
    positions, within the window when given."""
    return sum(min(r + 1, window or s) for r in range(s))


def phase_backward_kernels(torch, dev, seed):
    """K3 and K4 against their plain versions (bf16) in three cases: the
    train phase's attention shape (B=8, S=2048, H=8, Hkv=2, D=64, causal),
    the same with a 512 window, and bench.py's flash shape (B=4, S=2048,
    H=8, Hkv=8, D=128, causal).  Returns the per-case rows and K1's row
    at the training shape."""
    import torch.nn.functional as F

    from tpudist_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed + 3)
    bf = torch.bfloat16
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    rows, k1_train = [], None
    for case, (B, S, H, HKV, D, W) in (
            ("train", (8, 2048, 8, 2, 64, None)),
            ("train_window512", (8, 2048, 8, 2, 64, 512)),
            ("bench_flash", (4, 2048, 8, 8, 128, None))):
        q, k, v, do = rnd(B, S, H, D), rnd(B, S, HKV, D), rnd(B, S, HKV, D), \
            rnd(B, S, H, D)
        kw = dict(causal=True, window=W)
        out, lse = fa._flash_forward(q, k, v, True, window=W)
        dq, delta = fa._flash_bwd_dq(q, k, v, do, out, lse, **kw)
        dk, dv = fa._flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        pdq, pdelta = fa._flash_bwd_dq_plain(q, k, v, do, out, lse, **kw)
        pdk, pdv = fa._flash_bwd_dkv_plain(q, k, v, do, lse, pdelta, **kw)
        torch.cuda.synchronize()
        errs = {n: ((a.float() - b.float()).abs().max().item(),
                    grad_ratio(a, b))
                for n, a, b in (("dq", dq, pdq), ("dk", dk, pdk),
                                ("dv", dv, pdv))}
        d_err = (delta - pdelta).abs().max().item()
        ratio_k3, ratio_k4 = errs["dq"][1], max(errs["dk"][1], errs["dv"][1])
        check(ratio_k3 <= 1.0 and d_err <= DELTA_ATOL,
              f"K3 disagrees with its plain version ({case}): dq "
              f"{errs['dq']} delta {d_err}")
        check(ratio_k4 <= 1.0,
              f"K4 disagrees with its plain version ({case}): dk "
              f"{errs['dk']} dv {errs['dv']}")
        pairs = live_pairs(S, W) * B * H
        nb, nf = 2, 4   # bytes of a bf16 / f32 element
        qn, kn = q.numel(), k.numel()
        # K3 reads q k v dO O lse, writes dQ and Delta; K4 reads q k v dO
        # lse Delta, writes dK dV
        b3 = bound((3 * qn + 2 * kn) * nb + B * H * S * nf
                   + qn * nb + B * H * S * nf, 6.0 * pairs * D)
        b4 = bound((2 * qn + 2 * kn) * nb + 2 * B * H * S * nf
                   + 2 * kn * nb, 8.0 * pairs * D)
        row = {"case": case, "shape": [B, S, H, HKV, D], "window": W,
               "K3": {"max_abs_err": errs["dq"][0], "tol_ratio": ratio_k3,
                      "delta_err": d_err,
                      "ms": timed_ms(lambda: fa._flash_bwd_dq(
                          q, k, v, do, out, lse, **kw), 10, flush),
                      "plain_ms": timed_ms(lambda: fa._flash_bwd_dq_plain(
                          q, k, v, do, out, lse, **kw), 2, flush),
                      "bound_ms": b3[0], "bound_by": b3[1]},
               "K4": {"max_abs_err": max(errs["dk"][0], errs["dv"][0]),
                      "tol_ratio": ratio_k4,
                      "ms": timed_ms(lambda: fa._flash_bwd_dkv(
                          q, k, v, do, lse, delta, **kw), 10, flush),
                      "plain_ms": timed_ms(lambda: fa._flash_bwd_dkv_plain(
                          q, k, v, do, lse, delta, **kw), 2, flush),
                      "bound_ms": b4[0], "bound_by": b4[1]},
               "library_ms": None}
        if W is None:
            # the yardstick: SDPA's backward on the same inputs, fwd+bwd
            # minus fwd (autograd captured in the graph); once for the pair
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            dot = do.transpose(1, 2)

            def sdpa_fwd():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

            row["library_ms"] = (timed_ms(sdpa_fwd_bwd, 10, flush)
                                 - timed_ms(sdpa_fwd, 10, flush))
        if case == "train":
            # K1 on the training forward (q_offset 0), and SDPA's forward
            b1 = bound(2 * qn * nb + 2 * kn * nb + B * H * S * nf,
                       4.0 * pairs * D)
            k1_train = {"case": case, "ms": timed_ms(
                lambda: fa._flash_forward(q, k, v, True), 10, flush),
                "bound_ms": b1[0], "bound_by": b1[1],
                "library_ms": timed_ms(sdpa_fwd, 10, flush)}
        rows.append(row)
        del q, k, v, do, out, lse, dq, dk, dv, pdq, pdk, pdv
    del flush_buf
    torch.cuda.empty_cache()
    emit({"phase": "kernels_bwd", "cases": rows, "K1_train": k1_train,
          "tolerance": {"grad_atol_rel": GRAD_ATOL_REL,
                        "grad_rtol": GRAD_RTOL, "delta_atol": DELTA_ATOL}})
    return rows, k1_train


def train_loss_fn(torch, cfg):
    from tpudist_torch.ops.losses import cross_entropy

    def loss_fn(model, batch, _gen):
        (toks,) = batch
        logits = model(toks)
        return cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                             toks[:, 1:].reshape(-1)), {}

    return loss_fn


def phase_train_parity(torch, dev, seed):
    """Flash (K1/K3/K4) against the plain sdpa: a full-width 2-layer f32
    model (vocab 32000, H=8, Hkv=2, embed 512), B=2, S=512, 3 Adam steps
    from the same weights and batches."""
    import numpy as np

    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        sdpa,
    )
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, adam

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(vocab_size=32000, num_layers=2, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=512,
                            compute_dtype=torch.float32)
    sd = random_model(torch, cfg, dev, seed + 4).state_dict()
    rng = np.random.default_rng(seed + 4)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512)))
               .to(dev) for _ in range(3)]
    runs = {}
    for name, attn in (("flash", flash_attention_fn()), ("sdpa", sdpa)):
        model = TransformerLM(cfg, attention_fn=attn,
                              param_dtype=torch.float32, device=dev)
        model.load_state_dict(sd)
        state = TrainState.create(model, adam(3e-4), seed=seed)
        step = make_dp_train_step(train_loss_fn(torch, cfg))
        reset_launches()
        losses, grads = [], []
        for toks in batches:
            state, m = step(state, toks)
            losses.append(float(m["loss"]))
            grads.append({n: p.grad.clone()
                          for n, p in model.named_parameters()})
        runs[name] = (losses, grads, read_launches())
        del model, state
    (fl, fg, fla), (sl, sg, sla) = runs["flash"], runs["sdpa"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(fl, sl))
    worst = max(((a[n] - b[n]).abs().max().item()
                 / max(b[n].abs().max().item(), 1e-30), i, n)
                for i, (a, b) in enumerate(zip(fg, sg)) for n in b)
    want = 3 * cfg.num_layers
    check(all(np.isfinite(fl)) and loss_err <= LOSS_RTOL,
          f"train_parity: flash losses {fl} vs sdpa {sl}")
    check(worst[0] <= PGRAD_TOL,
          f"train_parity: gradient of {worst[2]} at step {worst[1]} differs "
          f"by {worst[0]} of its max")
    check(fla["K1"] == fla["K3"] == fla["K4"] == want,
          f"train_parity: flash run launches {fla}, want {want} each")
    check(sla["K1"] == sla["K3"] == sla["K4"] == 0,
          f"train_parity: the sdpa run launched kernels {sla}")
    torch.cuda.empty_cache()
    emit({"phase": "train_parity", "losses_flash": fl, "losses_sdpa": sl,
          "loss_max_rel_err": loss_err, "grad_worst_rel_to_max": worst[0],
          "grad_worst_param": worst[2], "grad_worst_step": worst[1],
          "launches_flash": fla, "tolerance": {"loss_rtol": LOSS_RTOL,
                                               "grad_rel_to_max": PGRAD_TOL}})


def kernel_family(name: str) -> str:
    """The train profile's grouping of device kernels by name."""
    for family, keys in (("attention (K1, K3, K4)", ("flash_",)),
                         ("GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
                         ("optimizer", ("multi_tensor", "adam")),
                         ("reduction", ("reduce_kernel",))):
        if any(k in name for k in keys):
            return family
    return "elementwise and copies"


def phase_train(torch, dev, seed):
    """bench.py's serve-loop model at full width, trained: bf16 compute,
    f32 master weights, flash attention, Adam 3e-4, seq 2048, batch 8,
    the markov stream from --seed; 2 warm-up steps, then 20 measured."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tpudist_torch.data import markov_tokens
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, adam

    cfg = TransformerConfig(vocab_size=32000, num_layers=8, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=8192,
                            compute_dtype=torch.bfloat16)
    B, S, steps = 8, 2048, 20
    model = TransformerLM(cfg, attention_fn=flash_attention_fn(),
                          param_dtype=torch.float32, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed + 5))
    tokens = torch.from_numpy(markov_tokens(B, S, cfg.vocab_size,
                                            seed)).to(dev)
    state = TrainState.create(model, adam(3e-4), seed=seed)
    step = make_dp_train_step(train_loss_fn(torch, cfg))
    for _ in range(2):                 # warm-up: cuBLAS, allocator
        state, _ = step(state, tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, tokens)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    losses = [float(x) for x in losses]
    want = steps * cfg.num_layers
    check(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"train: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(launches["K1"] == launches["K3"] == launches["K4"] == want,
          f"train: launches {launches}, want {want} of K1, K3 and K4")
    ms = wall / steps * 1e3
    # model FLOPs: 6 per weight per token for the projections and lm_head
    # (the embeddings are lookups), and 3x the attention forward's 4 per
    # live (q, k) pair, head and head dim (no recompute counted)
    weights = sum(p.numel() for n, p in model.named_parameters()
                  if n.endswith(".weight") and "embed" not in n)
    attn = 3 * 4.0 * live_pairs(S, None) * B * cfg.num_heads \
        * cfg.head_dim * cfg.num_layers
    flops = 6.0 * weights * B * S + attn
    # one more step on the host clock, then the same under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, tokens)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, tokens)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    check(device_ms > 0, "train: the profiler saw no device time")
    families = {}
    for k, t, _ in rows:
        families[kernel_family(k)] = families.get(kernel_family(k), 0.0) + t
    emit({"phase": "train", "steps": steps, "batch": B, "seq_len": S,
          "loss_first": losses[0], "loss_last": losses[-1],
          "losses": losses, "launches": launches, "wall_s": wall,
          "ms_per_step": ms, "tokens_per_s": B * S / (ms / 1e3),
          "model_flops_per_step": flops,
          "bf16_peak_share": flops / (ms / 1e3) / BF16_FLOPS,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
          "profile": {"step_wall_ms": step_ms, "device_ms": device_ms,
                      "device_busy_share": device_ms / step_ms,
                      "by_family_ms": families,
                      "top": [{"kernel": k[:80], "ms": t, "count": n}
                              for k, t, n in rows[:12]]}})
    del model, state
    torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from tpudist_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = _cuda.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(p.name for p in libs.values())})

    k1, k2 = phase_kernels(torch, dev, args.seed)
    phase_parity(torch, dev, args.seed)
    launches, loop = phase_serve(torch, dev, args.seed)
    phase_profile(torch, loop, args.seed)
    del loop
    bwd_rows, k1_train = phase_backward_kernels(torch, dev, args.seed)
    phase_train_parity(torch, dev, args.seed)
    train_launches = phase_train(torch, dev, args.seed)

    main_k1 = next(r for r in k1 if r["q_offset"] == 7168)
    main_k2 = next(r for r in k2 if r["case"] == "per_row_side")
    kernels = [
        {"name": "flash_forward (K1)", "route": "cuda",
         "source": "tpudist_torch/csrc/flash_attention.cu",
         "replaces": "tpudist/ops/flash_attention.py:127",
         "launches": launches["K1"],
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "tol_ratio": max(r["tol_ratio"] for r in k1),
         **{k: main_k1[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
         "launches_train": train_launches["K1"],
         "train_ms": k1_train["ms"], "train_bound_ms": k1_train["bound_ms"],
         "train_library_ms": k1_train["library_ms"]},
        {"name": "flash_decode (K2)", "route": "cuda",
         "source": "tpudist_torch/csrc/flash_decode.cu",
         "replaces": "tpudist/ops/flash_decode.py:62",
         "launches": launches["K2"],
         "max_abs_err": max(r["max_abs_err"] for r in k2),
         "tol_ratio": max(r["tol_ratio"] for r in k2),
         **{k: main_k2[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}},
    ]
    main_bwd = next(r for r in bwd_rows if r["case"] == "train")
    for key, name, src_line in (
            ("K3", "flash_bwd_dq (K3)", "tpudist/ops/flash_attention.py:320"),
            ("K4", "flash_bwd_dkv (K4)",
             "tpudist/ops/flash_attention.py:364")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tpudist_torch/csrc/flash_attention_bwd.cu",
            "replaces": src_line, "launches": train_launches[key],
            "max_abs_err": max(r[key]["max_abs_err"] for r in bwd_rows),
            "tol_ratio": max(r[key]["tol_ratio"] for r in bwd_rows),
            **{k: main_bwd[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")},
            # SDPA's whole backward, one call for the pair K3 + K4
            "library_ms": main_bwd["library_ms"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
