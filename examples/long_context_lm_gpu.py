"""Long-context transformer LM training on one NVIDIA GPU (the PyTorch port).

The twin of the plain data-parallel branch of ``long_context_lm_tpu.py``,
through ``tpudist_torch``: ``TransformerLM`` with flash attention (kernel
K1 forward, K3/K4 backward on the card), ``cross_entropy``, Adam and
``make_dp_train_step``.  Weights are random, drawn from a fixed seed; the
token stream is made with numpy from the same seed.

Run (on the card):  python3 examples/long_context_lm_gpu.py --bf16
Run (CPU, plain versions of the kernels, tiny):
    python3 examples/long_context_lm_gpu.py --device cpu --seq-len 64 \
        --batch-size 2 --layers 2 --embed-dim 64 --steps 3

Sequence and tensor parallelism (``--sp``, ``--tp``) and speculative
decoding are not ported yet (ROADMAP Queue A 4 and 7).
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
    parser.add_argument("--attn", default="flash", choices=["flash", "sdpa"])
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

    import torch

    from tpudist_torch.data import markov_tokens, random_tokens
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        sdpa,
    )
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.ops.losses import cross_entropy
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, adam
    from tpudist_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
        num_kv_heads=args.kv_heads, embed_dim=args.embed_dim,
        max_seq_len=args.seq_len,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    make = markov_tokens if args.data == "markov" else random_tokens
    tokens = torch.from_numpy(make(args.batch_size, args.seq_len, args.vocab,
                                   args.seed)).to(device)

    attn_fn = flash_attention_fn() if args.attn == "flash" else sdpa
    model = TransformerLM(cfg, attention_fn=attn_fn, remat=args.remat,
                          param_dtype=torch.float32, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))

    def loss_fn(m, batch, _gen):
        (toks,) = batch
        logits = m(toks)
        return cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                             toks[:, 1:].reshape(-1)), {}

    state = TrainState.create(model, adam(args.lr), seed=args.seed)
    step = make_dp_train_step(loss_fn)
    print(f"strategy: one {device.type} device ({args.attn}), "
          f"seq_len={args.seq_len}, batch={args.batch_size}, "
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
            print(f"step {i}: loss {loss:.4f}")
    if args.steps > 1:
        sync()
        dt = time.perf_counter() - t0
        tps = (args.steps - 1) * tokens.numel() / dt
        print(f"throughput: {tps:,.0f} tokens/sec")
    return loss


if __name__ == "__main__":
    main()
