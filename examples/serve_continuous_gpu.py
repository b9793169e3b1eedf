"""Continuous-batching serving demo on the GPU: mixed requests through
fixed slots (the PyTorch/CUDA twin of ``serve_continuous_tpu.py``).

A small LM is trained in-process on the Markov-permutation language (next
token = perm[token]), then a queue of requests with MIXED prompt lengths
and budgets is served through ``--slots`` decode lanes of
``tpudist_torch.models.serving.ServeLoop`` (mid-flight admission,
per-request stop/budget, slot reuse), and each completion is checked
against the language's ground truth.  With ``--speculative K`` a 1-layer
draft trained alike proposes K tokens a round and the target verifies
them (the same tokens as plain greedy serving); the acceptance rate is
printed.

Run (on the card by default; ``--device cpu`` for the CPU):

    python examples/serve_continuous_gpu.py --slots 2 --requests 6
    python examples/serve_continuous_gpu.py --speculative 4
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--slots", type=int, default=2,
                        help="decode lanes (the fixed batch the card sees)")
    parser.add_argument("--requests", type=int, default=6)
    parser.add_argument("--seq-len", type=int, default=256,
                        help="model context (cache slots per lane)")
    parser.add_argument("--train-steps", type=int, default=200)
    parser.add_argument("--steps-per-sync", type=int, default=16)
    parser.add_argument("--speculative", type=int, default=0, metavar="K",
                        help="serve speculatively with K draft tokens a "
                             "round (0: plain decoding)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.seq_len < 80:
        parser.error("--seq-len must be >= 80 (the in-process trainer "
                     "uses 64-token windows at random offsets and serving "
                     "needs headroom past them)")
    if args.speculative < 0:
        parser.error("--speculative must be >= 0")

    import torch

    from tpudist_torch.models.serving import Request, ServeLoop
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
        vocab_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        embed_dim=128, max_seq_len=args.seq_len)
    draft_cfg = TransformerConfig(
        vocab_size=128, num_layers=1, num_heads=2, num_kv_heads=1,
        embed_dim=64, max_seq_len=args.seq_len)

    # the Markov-permutation language: next token = perm[token] — easy to
    # learn, and every served continuation has a known ground truth
    rng = np.random.default_rng(0)
    perm = rng.permutation(cfg.vocab_size)

    def stream(start, length):
        out = np.empty((len(start), length), np.int64)
        tok = np.asarray(start)
        for i in range(length):
            out[:, i] = tok
            tok = perm[tok]
        return out

    data = torch.from_numpy(
        stream(rng.integers(0, cfg.vocab_size, 32), 65)).to(device)
    offsets = rng.integers(0, cfg.max_seq_len - 65, (args.train_steps,))
    # the training forward runs the flash kernels on the card (K1, K3,
    # K4) and plain attention on the CPU
    attn = flash_attention_fn() if device.type == "cuda" else sdpa

    def train(model_cfg, seed):
        model = TransformerLM(model_cfg, attention_fn=attn,
                              param_dtype=torch.float32, device=device)
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
        with torch.no_grad():
            model.pos_embed.weight.zero_()
        state = TrainState.create(model, adam(3e-3), seed=seed)

        def loss_fn(m, batch, _gen):
            toks, pos = batch
            logits = m(toks[:, :-1], positions=pos)
            return cross_entropy(logits.reshape(-1, model_cfg.vocab_size),
                                 toks[:, 1:].reshape(-1)), {}

        step = make_dp_train_step(loss_fn)
        metrics = {}
        window = torch.arange(64, device=device).expand(len(data), 64)
        for off in offsets:
            state, metrics = step(state, data, window + int(off))
        return model, float(metrics["loss"])

    model, loss = train(cfg, 0)
    print(f"trained {args.train_steps} steps on {device.type}, loss "
          f"{loss:.4f}")
    spec_kw = {}
    if args.speculative:
        draft, dloss = train(draft_cfg, 1)
        print(f"trained the draft {args.train_steps} steps, loss "
              f"{dloss:.4f}")
        spec_kw = dict(decode_mode="speculative", draft_cfg=draft_cfg,
                       draft_params=draft.state_dict(),
                       num_draft=args.speculative)

    reqs = []
    headroom = max(args.speculative - 1, 0)
    for i in range(args.requests):
        plen = int(rng.integers(4, cfg.max_seq_len // 2))
        budget = int(rng.integers(4, cfg.max_seq_len - plen - headroom))
        reqs.append(Request(
            stream(rng.integers(0, cfg.vocab_size, 1), plen)[0],
            budget, rid=i))

    loop = ServeLoop(cfg, model.state_dict(), num_slots=args.slots,
                     steps_per_sync=args.steps_per_sync, prefill_chunk=32,
                     device=device, **spec_kw)
    t0 = time.perf_counter()
    comps = loop.run(reqs)
    wall = time.perf_counter() - t0

    total = correct = 0
    for c in sorted(comps, key=lambda c: c.rid):
        want = stream(c.prompt[-1:], len(c.tokens) + 1)[0, 1:]
        ok = int(np.sum(c.tokens == want))
        total += len(c.tokens)
        correct += ok
        print(f"request {c.rid}: prompt {len(c.prompt):3d} -> "
              f"{len(c.tokens):3d} tokens ({c.reason}), "
              f"{ok}/{len(c.tokens)} match the language")
    acc = correct / max(total, 1)
    print(f"{len(comps)} requests, {total} tokens in {wall:.2f}s "
          f"through {args.slots} slots | continuation accuracy "
          f"{acc:.1%}")
    if args.speculative:
        st = loop.stats
        rate = st.spec_accepted / max(st.spec_row_rounds * args.speculative,
                                      1)
        print(f"speculative K={args.speculative}: {st.spec_rounds} rounds, "
              f"draft acceptance {rate:.1%}, "
              f"{st.decode_tokens / max(st.spec_rounds, 1):.2f} tokens a "
              "round")
    return 0 if acc > 0.9 else 1


if __name__ == "__main__":
    sys.exit(main())
