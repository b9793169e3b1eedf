"""Sharded decode across cards: one NCCL process a card, each sharded
rollout held against the one-card rollout and timed beside it.

    torchrun --standalone --nproc-per-node 4 scripts/decode_nccl_check.py
    torchrun --standalone --nproc-per-node 4 scripts/decode_nccl_check.py \\
        --device cpu --layers 2 --vocab 256 --embed 64 --heads 4 \\
        --kv-heads 2 --max-seq 256 --prompt 100 --new 8    # gloo rehearsal

Rows (4 processes; a ``rep`` axis of 2 fills the mesh where a row needs
2 processes, and both replicas decode):

* ``tp2`` — ``tp_generate`` over ``rep 2 × model 2``: the Megatron weights
  and a head-sharded cache (each card one of the 2 KV heads);
* ``sp4`` — ``sp_generate`` over ``seq 4``: each card owns a quarter of
  the 8k cache's slots, partial softmaxes merged by log-sum-exp;
* ``tp2_sp2`` — ``tp_sp_generate`` over ``model 2 × seq 2``;
* ``tp2_spec`` — ``tp_speculative_generate`` over ``rep 2 × model 2``
  with bench.py's draft (1 layer, 1 head, embed 128, a 1,024 window), K 4.

Every row decodes with ``decode_attention="flash"`` (K1, K2 at the shard's
heads and offsets).  The model is the serve cell's width (vocab 32000, 8
heads over 2 KV heads, embed 512, ``--max-seq`` 8,192), random weights
drawn on the CPU from ``--seed`` (the same on every card); 2 rows of
``--prompt`` tokens, ``--new`` new.  f32: every card's tokens equal the
one-card ``greedy_generate``'s exactly.  bf16: the share of tokens equal
to the one-card bf16 rollout's, and the first position where they part
(the LSE merge rounds apart from one pass).  Timing (bf16, after a
warm-up rollout): ms a token on the host clock after a synchronize,
beside the one-card rollout's.  Memory: the cache bytes each card
allocates, which must be 1/tp, 1/sp or 1/(tp·sp) of the one-card cache's,
and each card's peak device memory in the rollout.  Rank 0 prints one
JSON line; the exit code is non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

ROWS = {
    "tp2": ("tp_generate", {"rep": 2, "model": 2}, 2),
    "sp4": ("sp_generate", {"seq": 4}, 4),
    "tp2_sp2": ("tp_sp_generate", {"model": 2, "seq": 2}, 4),
    "tp2_spec": ("tp_speculative_generate", {"rep": 2, "model": 2}, 2),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--embed", type=int, default=512)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=8192)
    ap.add_argument("--prompt", type=int, default=6000)
    ap.add_argument("--new", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tpudist_torch.models import generate as gen
    from tpudist_torch.models import speculative as spec
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.runtime import initialize, make_mesh, shutdown
    from tpudist_torch.utils.device import resolve_device

    ctx = initialize(device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = ctx.process_index, ctx.process_count
    if world != 4:
        raise SystemExit(f"decode_nccl_check needs 4 processes, got {world}")
    failures = []
    out = {"processes": world, "device": str(device),
           "config": {k: v for k, v in vars(args).items()
                      if k not in ("device",)}}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def cfg_of(dtype, **kw):
        base = dict(vocab_size=args.vocab, num_layers=args.layers,
                    num_heads=args.heads, num_kv_heads=args.kv_heads,
                    embed_dim=args.embed, max_seq_len=args.max_seq)
        return TransformerConfig(**{**base, **kw}, compute_dtype=dtype)

    def weights(cfg, seed):
        """The whole model, drawn on the CPU (the same on every rank)."""
        g = torch.Generator().manual_seed(seed)
        return TransformerLM(cfg, device="cpu").init_weights(g).state_dict()

    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(
        0, args.vocab, (2, args.prompt)).astype(np.int32))
    draft_kw = dict(num_layers=1, num_heads=1, num_kv_heads=1,
                    embed_dim=args.embed // 4,
                    attention_window=min(1024, args.max_seq))

    cache_bytes = []
    orig_blank = gen._blank_cache

    def spy(*a, **k):
        cache = orig_blank(*a, **k)
        if not cache_bytes:
            cache_bytes.append(sum(
                t.numel() * t.element_size() for layer in cache
                for name, t in layer.items() if t.dim() == 3))
        return cache

    gen._blank_cache = spy
    spec._blank_cache = spy

    def rollout(fn, dtype, sd, dsd, mesh):
        """One rollout (greedy when ``fn`` is None) and its wall seconds,
        the first cache's bytes and the peak device memory."""
        cfg = cfg_of(dtype)
        kw = dict(prefill_chunk=args.chunk, device=device)
        cache_bytes.clear()
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        sync()
        t0 = time.perf_counter()
        if fn is None:
            toks = gen.greedy_generate(cfg, sd, prompt, args.new, **kw)
        elif fn == "tp_speculative_generate":
            toks = spec.tp_speculative_generate(
                cfg, sd, cfg_of(dtype, **draft_kw), dsd, prompt, args.new,
                mesh, num_draft=4, decode_attention="flash", **kw)
        else:
            toks = getattr(gen, fn)(cfg, sd, prompt, args.new, mesh,
                                    decode_attention="flash", **kw)
        sync()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        return toks.cpu(), wall, cache_bytes[0], peak

    rows = {}
    try:
        ref = {}
        for dtype in (torch.float32, torch.bfloat16):
            sd = weights(cfg_of(dtype), args.seed)
            dsd = weights(cfg_of(dtype, **draft_kw), args.seed + 1)
            rollout(None, dtype, sd, dsd, None)           # warm-up
            toks, wall, nbytes, peak = rollout(None, dtype, sd, dsd, None)
            ref[dtype] = toks
            name = str(dtype).split(".")[1]
            out[f"one_card_{name}"] = {
                "ms_per_token": wall / args.new * 1e3,
                "cache_bytes": nbytes, "peak_bytes": peak}
            for row, (fn, axes, n) in ROWS.items():
                mesh = make_mesh(axes)
                if dtype == torch.bfloat16:
                    rollout(fn, dtype, sd, dsd, mesh)     # warm-up
                got, wall, nbytes, peak = rollout(fn, dtype, sd, dsd, mesh)
                r = rows.setdefault(row, {"shards": n})
                gen_got = got[:, args.prompt:]
                gen_want = ref[dtype][:, args.prompt:]
                same = (gen_got == gen_want)
                part = [int(np.argmax(~s.numpy())) if not bool(s.all())
                        else None for s in same]
                r[name] = {"ms_per_token": wall / args.new * 1e3,
                           "equal_share": float(same.float().mean()),
                           "first_divergence": part,
                           "cache_bytes": nbytes, "peak_bytes": peak}
                whole = out[f"one_card_{name}"]["cache_bytes"]
                if nbytes * n != whole:
                    failures.append(f"{row} {name}: cache {nbytes} bytes a "
                                    f"card, one card's {whole} / {n}")
                if dtype == torch.float32 and not torch.equal(
                        got, ref[dtype]):
                    failures.append(f"{row}: f32 tokens differ from the "
                                    f"one-card rollout at {part}")
    finally:
        gen._blank_cache = orig_blank
        spec._blank_cache = orig_blank
    out["rows"] = rows
    out["failures"] = failures
    if rank == 0:
        print(json.dumps(out), flush=True)
    shutdown()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
