"""Long-context transformer LM training on NVIDIA GPUs (the PyTorch port).

The twin of ``long_context_lm_tpu.py``'s data-parallel, tensor-parallel
and sequence-parallel branches, through ``tpudist_torch``:
``TransformerLM`` with flash attention (kernel K1 forward, K3/K4 backward
on the card), ``cross_entropy``, Adam and ``make_dp_train_step``; with
``--tp N``, the Megatron layout over the ``model`` axis of a ``data ×
model`` mesh (``make_tp_state``, ``make_spmd_train_step``: each process
runs its H/N heads through the same kernels); or, with ``--sp N``, the
sequence split over N processes through ring, ring flash (K1 forward,
K8/K4 backward) or Ulysses attention and ``make_sp_train_step`` over a
``data × seq`` mesh.  Weights are random, drawn from a fixed seed; the
token stream is made with numpy from the same seed.  ``--generate N``
then greedy-decodes N tokens past a prompt cut from the stream, through
the layout the run trained in: under ``--tp`` ``tp_generate`` (the
Megatron weights and a head-sharded cache, each process its own heads),
under ``--sp`` ``sp_generate`` (a sequence-sharded cache, partial
softmaxes merged by log-sum-exp), both with ``decode_attention="flash"``
(K1 and K2 at the shard's heads and offsets), else ``greedy_generate``
on one device.

Run (one card):  python3 examples/long_context_lm_gpu.py --bf16
Run (N cards, sequence-parallel):
    torchrun --nproc-per-node N examples/long_context_lm_gpu.py \
        --attn ring_flash --sp N --bf16
Run (N cards, tensor-parallel, data × model over the processes):
    torchrun --nproc-per-node N examples/long_context_lm_gpu.py \
        --tp 2 --kv-heads 2 --bf16
Run (CPU, plain versions of the kernels, tiny):
    python3 examples/long_context_lm_gpu.py --device cpu --seq-len 64 \
        --batch-size 2 --layers 2 --embed-dim 64 --steps 3
    (add --attn ring_flash --sp 2, or --tp 2, under torchrun
    --nproc-per-node 2 for the sequence- or tensor-parallel step over
    gloo)

tpudist's ``--speculative K`` branch (a draft trained beside the model,
then a draft/verify rollout) is not wired into this example;
``tpudist_torch.models.speculative.speculative_generate`` is ported, and
``examples/serve_continuous_gpu.py --speculative K`` serves speculatively.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seq-len", default=2048, type=int)
    parser.add_argument("--batch-size", default=8, type=int,
                        help="batch in sequences")
    parser.add_argument("--steps", default=50, type=int)
    parser.add_argument("--layers", default=4, type=int)
    parser.add_argument("--heads", default=8, type=int)
    parser.add_argument("--kv-heads", default=None, type=int,
                        help="grouped-query attention: K/V heads "
                             "(default: --heads)")
    parser.add_argument("--embed-dim", default=512, type=int)
    parser.add_argument("--vocab", default=256, type=int)
    parser.add_argument("--data", default="random",
                        choices=["random", "markov"],
                        help="training stream: 'random' (nothing "
                             "learnable) or 'markov' (a fixed "
                             "token-permutation language)")
    parser.add_argument("--lr", default=3e-4, type=float)
    parser.add_argument("--attn", default="flash",
                        choices=["flash", "sdpa", "ring", "ring_flash",
                                 "ulysses"])
    parser.add_argument("--sp", default=1, type=int,
                        help="sequence-parallel processes (with ring, "
                             "ring_flash or ulysses attention, under "
                             "torchrun)")
    parser.add_argument("--tp", default=1, type=int,
                        help="tensor-parallel processes (the model axis of "
                             "a data x model mesh, under torchrun)")
    parser.add_argument("--generate", default=0, type=int,
                        help="after training, greedy-decode this many "
                             "tokens past a prompt from the stream")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (f32 params)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute block activations in the backward")
    parser.add_argument("--log-every", default=10, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu' (plain versions of "
                             "the kernels)")
    args = parser.parse_args(argv)
    sequence_parallel = ("ring", "ring_flash", "ulysses")
    if args.sp > 1 and args.attn not in sequence_parallel:
        parser.error(f"--sp needs ring/ring_flash/ulysses attention, got "
                     f"{args.attn}")
    if args.attn in sequence_parallel and args.sp <= 1:
        parser.error(f"--attn {args.attn} is sequence-parallel; pass --sp N "
                     "(N>1)")
    if args.tp > 1 and args.sp > 1:
        parser.error("--tp and --sp are separate branches (as in "
                     "long_context_lm_tpu.py); pass one")

    import torch

    from tpudist_torch.data import markov_tokens, random_tokens
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        sdpa,
    )
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.ops.losses import cross_entropy, cross_entropy_per_token
    from tpudist_torch.parallel import (
        broadcast_params,
        gather_tree,
        make_dp_train_step,
        make_sp_train_step,
        make_spmd_train_step,
        make_tp_state,
        ring_attention_fn,
        ring_flash_attention_fn,
        shard_batch,
        ulysses_attention_fn,
    )
    from tpudist_torch.runtime import (
        data_model_mesh,
        initialize,
        local_block,
        make_mesh,
        shutdown,
    )
    from tpudist_torch.train import TrainState, adam
    from tpudist_torch.utils.device import resolve_device

    ctx = initialize(device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = TransformerConfig(
        vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
        num_kv_heads=args.kv_heads, embed_dim=args.embed_dim,
        max_seq_len=args.seq_len,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    make = markov_tokens if args.data == "markov" else random_tokens
    tokens = torch.from_numpy(make(args.batch_size, args.seq_len, args.vocab,
                                   args.seed)).to(device)

    mesh = None
    if args.sp > 1:
        mesh = make_mesh({"data": -1, "seq": args.sp})
        attn_fn = {"ring": ring_attention_fn, "ring_flash":
                   ring_flash_attention_fn,
                   "ulysses": ulysses_attention_fn}[args.attn]("seq",
                                                               mesh=mesh)
    else:
        attn_fn = flash_attention_fn() if args.attn == "flash" else sdpa
    model = TransformerLM(cfg, attention_fn=attn_fn, remat=args.remat,
                          param_dtype=torch.float32, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    broadcast_params(model, mesh)
    state = TrainState.create(model, adam(args.lr), seed=args.seed)

    def loss_fn(m, batch, _gen):
        (toks,) = batch
        logits = m(toks)
        return cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                             toks[:, 1:].reshape(-1)), {}

    specs = None
    if args.tp > 1:
        # this process's shard of the whole model's weights (every
        # process drew the same ones from the seed)
        mesh = data_model_mesh(model=args.tp)
        whole = {k: v.detach().clone() for k, v in
                 model.state_dict().items()}
        del model, state
        model = TransformerLM(cfg, attention_fn=attn_fn, remat=args.remat,
                              param_dtype=torch.float32, tp_axis="model",
                              mesh=mesh, device=device)
        state, specs = make_tp_state(model, whole, adam(args.lr), mesh,
                                     seed=args.seed)
        del whole
        tp_step = make_spmd_train_step(loss_fn, mesh, specs)
        batch = shard_batch((tokens,), mesh, "data")
        step = lambda s, _toks: tp_step(s, *batch)
        strategy = (f"dp{mesh.size(0)}×tp{args.tp} ({args.attn}) on "
                    f"{ctx.process_count} {device.type} processes")
    elif mesh is not None:
        # next-token prediction with the final position masked out
        targets = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1],
                                                            -1)], 1)

        def loss_per_token(logits, tgt):
            mask = (tgt >= 0).float()
            return cross_entropy_per_token(logits, tgt.clamp_min(0)) * mask

        sp_step = make_sp_train_step(
            model, loss_per_token, mesh,
            total_tokens=args.batch_size * (args.seq_len - 1))
        batch = (local_block(tokens, mesh), local_block(targets, mesh))
        step = lambda s, _toks: sp_step(s, *batch)
        strategy = (f"dp{mesh.size(0)}×sp{args.sp} ({args.attn}) on "
                    f"{ctx.process_count} {device.type} processes")
    else:
        step = make_dp_train_step(loss_fn)
        strategy = f"one {device.type} device ({args.attn})"
    log = print if ctx.is_coordinator else (lambda *a, **k: None)
    log(f"strategy: {strategy}, seq_len={args.seq_len}, "
        f"batch={args.batch_size}, "
        f"{sum(p.numel() for p in model.parameters()):,} params")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    loss = float("nan")
    t0 = None
    for i in range(args.steps):
        state, metrics = step(state, tokens)
        if i == 0:
            sync()
            t0 = time.perf_counter()
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            log(f"step {i}: loss {loss:.4f}")
    if args.steps > 1:
        sync()
        dt = time.perf_counter() - t0
        tps = (args.steps - 1) * tokens.numel() / dt
        log(f"throughput: {tps:,.0f} tokens/sec")
    if args.generate > 0:
        generate(args, cfg, state, mesh, specs, tokens, device, log,
                 gather_tree)
    shutdown()
    return loss


def generate(args, cfg, state, mesh, specs, tokens, device, log,
             gather_tree) -> None:
    """Greedy decoding past a prompt cut from the stream, through the
    run's layout: ``tp_generate`` under ``--tp`` (the whole weights are
    gathered from the blocks, then each process keeps its block of them
    and caches its own heads), ``sp_generate`` under ``--sp`` (each
    process owns a slice of the cache), else ``greedy_generate``.  Every
    process decodes; the coordinator prints."""
    import torch

    from tpudist_torch.models.generate import (
        greedy_generate,
        sp_generate,
        tp_generate,
    )

    if args.generate >= cfg.max_seq_len:
        raise SystemExit(f"--generate must be < max_seq_len "
                         f"({cfg.max_seq_len}); got {args.generate}")
    params = dict(state.model.named_parameters())
    if specs is not None:
        params = gather_tree(params, mesh, specs)
    params = {k: v.detach() for k, v in params.items()}
    prompt_len = max(1, min(args.seq_len // 4,
                            cfg.max_seq_len - args.generate))
    prompt = tokens[:2, :prompt_len]
    t0 = time.perf_counter()
    if args.tp > 1 and cfg.kv_heads % args.tp == 0:
        out, lengths = tp_generate(
            cfg, params, prompt, args.generate, mesh,
            decode_attention="flash", stop_tokens=[0], device=device)
        serve = f"tp{args.tp} flash"
    elif args.sp > 1 and cfg.max_seq_len % args.sp == 0:
        out, lengths = sp_generate(
            cfg, params, prompt, args.generate, mesh,
            decode_attention="flash", stop_tokens=[0], device=device)
        serve = f"sp{args.sp} flash"
    else:
        out, lengths = greedy_generate(
            cfg, params, prompt, args.generate, stop_tokens=[0],
            device=device)
        serve = "single-program flash"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"generated {args.generate} tokens/seq via {serve} (prompt "
        f"{prompt_len}) in {time.perf_counter() - t0:.2f}s; lengths "
        f"(EOS=0): {lengths.tolist()}; sample: {out[0, -16:].tolist()}")


if __name__ == "__main__":
    main()
