"""The 1F1B pipeline across cards: one stage a process over NCCL P2P,
held against the same pipeline with every stage in one process, and
timed beside it and beside the unpipelined step.

    torchrun --nproc-per-node 4 scripts/pp_nccl_check.py
    torchrun --nproc-per-node 4 scripts/pp_nccl_check.py --device cpu \\
        --layers 4 --vocab 256 --embed 64 --heads 4 --kv-heads 2 \\
        --seq 32 --parity-seq 32 --steps 2      # gloo rehearsal

The world is one ``data 1 × stage P`` mesh (P = the process count).
Parity: a ``P``-layer model in f32 (TF32 off) takes 2 Adam steps through
``make_1f1b_pipeline_train_step`` in its real-model mode, one stage a
process; rank 0 then takes the same 2 steps with all P stages in its own
process (``local_stages=P``) from the same weights and batch.  Each
step's loss within 1e-5 relative, each parameter after the steps within
1e-5 of its tensor's largest element (the same kernels on the same
inputs; the embedding's and head's gradients are summed over the stages
by an all-reduce in one run and accumulated in one tensor in the other).
Timing: the ``--layers`` model in bf16 with f32 master weights at
``--seq`` × ``--batch`` and ``--micro`` micro-batches, at V = 1 and
V = 2, ms per step across the cards; then on rank 0 alone the same step
with every stage in its process and the unpipelined
``make_dp_train_step``.  Rank 0 prints one JSON line; the exit code is
non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def _fns(torch, cfg):
    """block_fn, embed_fn, head_loss_fn of a TransformerLM on its own
    modules built on the meta device (chip_smoke's pp_lm_fns)."""
    from torch.func import functional_call

    from tpudist_torch.models.transformer import TransformerLM
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.ops.losses import cross_entropy

    tmpl = TransformerLM(cfg, attention_fn=flash_attention_fn(),
                         param_dtype=torch.float32, device="meta")
    blk = tmpl.blocks[0]

    def block_fn(p, a):
        for j in range(next(iter(p.values())).shape[0]):
            a = functional_call(blk, {k: v[j] for k, v in p.items()}, (a,))
        return a

    def embed_fn(ex, x):
        pos = torch.arange(x.shape[1], device=x.device)[None]
        return (functional_call(tmpl.tok_embed,
                                {"weight": ex["tok_embed.weight"]}, (x,))
                + functional_call(tmpl.pos_embed,
                                  {"weight": ex["pos_embed.weight"]},
                                  (pos,)))

    def head_loss_fn(ex, out, y):
        h = functional_call(tmpl.ln_f, {"scale": ex["ln_f.scale"],
                                        "bias": ex["ln_f.bias"]}, (out,))
        logits = functional_call(tmpl.lm_head,
                                 {"weight": ex["lm_head.weight"]},
                                 (h,)).float()
        return cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                             y[:, :-1].reshape(-1))

    return block_fn, embed_fn, head_loss_fn


def _step(torch, cfg, sd, mesh, P, V, M, device):
    from tpudist_torch.models import stack_block_params
    from tpudist_torch.parallel import pipeline as pl
    from tpudist_torch.train import TrainState, adam

    tree = stack_block_params(sd, cfg.num_layers, P, V)
    specs = pl.stacked_state_specs(tree, P * V, overrides={"extra": ()})
    part = pl.shard_stage_params(tree, mesh, specs)
    state = TrainState.create(pl.ParamTree(part, device=device), adam(3e-4))
    block_fn, embed_fn, head_loss_fn = _fns(torch, cfg)
    step = pl.make_1f1b_pipeline_train_step(
        block_fn, None, mesh, M, state, virtual_stages=V,
        embed_fn=embed_fn, head_loss_fn=head_loss_fn,
        local_stages=None if mesh is not None else P)
    return state, step


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--embed", type=int, default=512)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--parity-seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch.data import markov_tokens
    from tpudist_torch.models import unstack_block_params
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.runtime import initialize, pipeline_mesh, shutdown
    from tpudist_torch.train import TrainState, adam
    from tpudist_torch.utils.device import resolve_device

    ctx = initialize(device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    P, rank = ctx.process_count, ctx.process_index
    mesh = pipeline_mesh(P)
    failures, out = [], {"processes": P, "device": str(device)}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)

    def lm(cfg, seed):
        g = torch.Generator().manual_seed(seed)   # the same on every rank
        model = TransformerLM(cfg, attention_fn=flash_attention_fn(),
                              param_dtype=torch.float32, device="cpu")
        return model.init_weights(g).to(device)

    def tokens_for(cfg, seq, seed):
        t = torch.from_numpy(markov_tokens(args.batch, seq, cfg.vocab_size,
                                           seed)).to(device)
        return t, torch.roll(t, -1, 1)

    # parity: P layers in f32, one stage a process against all here
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(vocab_size=args.vocab, num_layers=P,
                            num_heads=args.heads, num_kv_heads=args.kv_heads,
                            embed_dim=args.embed, max_seq_len=args.parity_seq,
                            compute_dtype=torch.float32)
    sd = {k: v.detach().clone() for k, v in lm(cfg, args.seed + 1)
          .state_dict().items()}
    x, y = tokens_for(cfg, args.parity_seq, args.seed + 1)
    runs = {}
    for where in ("ranks", "local"):
        if where == "local" and rank != 0:
            continue
        state, step = _step(torch, cfg, sd, mesh if where == "ranks"
                            else None, P, 1, args.micro, device)
        losses = []
        for _ in range(2):
            state, m = step(state, x, y)
            losses.append(float(m["loss"]))
        tree = {k: {n: t.detach().cpu() for n, t in v.items()}
                for k, v in state.model.tree().items()}
        runs[where] = (losses, tree)
    parts = [None] * P
    dist.all_gather_object(parts, runs["ranks"][1])
    if rank == 0:
        stages = {n: torch.cat([p["stages"][n] for p in parts])
                  for n in parts[0]["stages"]}
        got = unstack_block_params({"stages": stages,
                                    "extra": parts[0]["extra"]}, P, 1)
        want = unstack_block_params(runs["local"][1], P, 1)
        (lr_, _), (ll, _) = runs["ranks"], runs["local"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lr_, ll))
        param_err = max(float((got[n] - want[n]).abs().max()
                              / want[n].abs().max().clamp_min(1e-30))
                        for n in want)
        out["parity"] = {"layers": P, "seq": args.parity_seq,
                         "losses_ranks": lr_, "losses_local": ll,
                         "loss_rel_err": loss_err,
                         "param_max_rel_to_max": param_err}
        if not (loss_err <= 1e-5 and param_err <= 1e-5):
            failures.append(f"parity: loss {loss_err}, params {param_err}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    del runs, parts

    # timing: the --layers model in bf16 with f32 master weights
    cfg = TransformerConfig(vocab_size=args.vocab, num_layers=args.layers,
                            num_heads=args.heads, num_kv_heads=args.kv_heads,
                            embed_dim=args.embed, max_seq_len=args.seq,
                            compute_dtype=torch.bfloat16)
    model = lm(cfg, args.seed + 5)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    x, y = tokens_for(cfg, args.seq, args.seed)

    def timed(step, state, *batch):
        for _ in range(2):
            state, _ = step(state, *batch)
        _sync(torch, device)
        losses = []
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state, *batch)
            losses.append(m["loss"])
        _sync(torch, device)
        ms = (time.perf_counter() - t0) * 1e3 / args.steps
        losses = [float(v) for v in losses]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            failures.append(f"losses {losses}")
        return {"ms_per_step": ms, "losses": losses,
                "tokens_per_s": args.batch * args.seq / ms * 1e3}

    rows = []
    for V in (1, 2):
        if args.layers % (P * V):
            continue
        state, step = _step(torch, cfg, sd, mesh, P, V, args.micro, device)
        rows.append({"virtual_stages": V, "across_processes": True,
                     "bubble_fraction": step.bubble_fraction,
                     **timed(step, state, x, y)})
        del state, step
    dist.barrier()
    if rank == 0:
        for V in (1, 2):
            if args.layers % (P * V):
                continue
            state, step = _step(torch, cfg, sd, None, P, V, args.micro,
                                device)
            rows.append({"virtual_stages": V, "across_processes": False,
                         **timed(step, state, x, y)})
            del state, step

        def loss_fn(m, batch, _g):
            (toks,) = batch
            logits = m(toks)
            from tpudist_torch.ops.losses import cross_entropy

            return cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                                 toks[:, 1:].reshape(-1)), {}

        # the mesh's data axis has one process: no collective
        out["unpipelined"] = timed(make_dp_train_step(loss_fn, mesh),
                                   TrainState.create(model, adam(3e-4)), x)
    dist.barrier()
    out["timing"] = rows
    out["shape"] = {"layers": args.layers, "seq": args.seq,
                    "batch": args.batch, "micro": args.micro}
    all_failures = [None] * P
    dist.all_gather_object(all_failures, failures)
    shutdown()
    if rank == 0:
        out["failures"] = [f for fs in all_failures for f in fs]
        print(json.dumps(out), flush=True)
    return 1 if any(all_failures) else 0


if __name__ == "__main__":
    sys.exit(main())
