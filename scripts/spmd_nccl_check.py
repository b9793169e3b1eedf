"""Tensor, ZeRO-3 and expert parallelism across cards: one process a
card over NCCL, each layout held against the one-card unsharded step and
timed beside it.

    torchrun --nproc-per-node 4 scripts/spmd_nccl_check.py
    torchrun --nproc-per-node 4 scripts/spmd_nccl_check.py --device cpu \\
        --layers 2 --vocab 256 --embed 64 --heads 4 --kv-heads 2 \\
        --seq 32 --parity-seq 32 --moe-seq 32 --steps 2    # gloo rehearsal

Rows (4 processes):

* ``dp2_tp2`` and ``fsdp2_tp2`` — ``make_composed_train_step`` over
  ``MeshSpec(dp=2, tp=2)`` / ``MeshSpec(fsdp=2, tp=2)`` with
  ``transformer_tp_rules("tp")``: the train cell's ``TransformerLM``
  (vocab 32000, 8 heads, 2 KV heads, embed 512) in the Megatron layout;
* ``dp2_ep2`` — ``MeshSpec(dp=2, ep=2)`` with ``moe_ep_rules("ep")``:
  the same widths with every MLP an MoE MLP (E = 8, top-2, einsum),
  tokens replicated over ``ep`` (partial outputs all-reduced);
* ``ep_shard_d2_e2`` — ``make_ep_shard_train_step`` over a ``data 2 ×
  expert 2`` mesh: the all-to-all dispatch, tpudist's sum contract.

Parity: a 2-layer model in f32 (TF32 off), batch ``--batch`` at
``--parity-seq``, one Adam step (3e-4) of the row's layout against rank
0's unsharded step on the whole batch from the same weights: the loss
within 1e-5 relative and every gradient within 1e-3 of its largest
element (chip_smoke's train_parity limits: the same math summed in other
orders), and every parameter after the step within 2·lr (one Adam step
moves an element by at most lr, so a misplaced block shows at the
weights' own scale).  MoE rows use capacity factor 4 (no token dropped
in either layout) and no aux loss (the load-balance term is a statistic
of each data shard's tokens).  Timing: bf16 on f32 masters, ``--layers``
deep at ``--seq`` × ``--batch`` for the dense rows, 2 MoE layers at
``--moe-seq`` × ``--batch`` for the MoE rows (the einsum dispatch's
[T, E, C] routing tensors bound the one-card reference), 2 warm-up and
``--steps`` measured steps: ms a step across the cards and peak memory by
rank, beside rank 0's unsharded step.  Rank 0 prints one JSON line; the
exit code is non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

LOSS_RTOL, GRAD_TOL, LR = 1e-5, 1e-3, 3e-4


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
    ap.add_argument("--moe-seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch.data import markov_tokens
    from tpudist_torch.models.moe import MoEConfig, MoETransformerLM
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.ops.losses import cross_entropy, cross_entropy_per_token
    from tpudist_torch.parallel import (
        MeshSpec,
        gather_tree,
        make_composed_state,
        make_composed_train_step,
        make_ep_shard_train_step,
        make_ep_state,
        moe_ep_rules,
        shard_batch,
        shard_composed_batch,
        transformer_tp_rules,
    )
    from tpudist_torch.runtime import initialize, make_mesh, shutdown
    from tpudist_torch.train import TrainState, adam
    from tpudist_torch.utils.device import resolve_device

    ctx = initialize(device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank, world = ctx.process_index, ctx.process_count
    if world != 4:
        raise SystemExit(f"spmd_nccl_check needs 4 processes, got {world}")
    failures = []
    out = {"processes": world, "device": str(device)}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def peak():
        return (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)

    def reset_peak():
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)

    def dense_cfg(layers, seq, dtype):
        return TransformerConfig(vocab_size=args.vocab, num_layers=layers,
                                 num_heads=args.heads,
                                 num_kv_heads=args.kv_heads,
                                 embed_dim=args.embed, max_seq_len=seq,
                                 compute_dtype=dtype)

    def whole_model(moe, cfg, seed):
        """The whole model's weights, drawn on the CPU from ``seed`` (the
        same on every rank), on this rank's device."""
        g = torch.Generator().manual_seed(seed)
        if moe is None:
            m = TransformerLM(cfg, attention_fn=flash_attention_fn(),
                              param_dtype=torch.float32, device="cpu")
        else:
            m = MoETransformerLM(cfg, moe, attention_fn=flash_attention_fn(),
                                 device="cpu")
        return m.init_weights(g).to(device)

    def mean_loss(cfg, moe):
        def loss_fn(model, batch, _gen):
            (toks,) = batch
            logits = model(toks)
            aux = 0.0
            if moe is not None:
                logits, aux = logits
            return cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                                 toks[:, 1:].reshape(-1)) + aux, {}

        return loss_fn

    def build(row, cfg, moe, sd, tokens):
        """The row's state, step and this process's batch."""
        loss_fn = mean_loss(cfg, moe)
        if row == "ep_shard_d2_e2":
            mesh = make_mesh({"data": 2, "expert": 2})
            model = MoETransformerLM(cfg, moe,
                                     attention_fn=flash_attention_fn(),
                                     ep_axis="expert", mesh=mesh,
                                     device=device)
            state, specs = make_ep_state(model, sd, adam(LR), mesh)
            total = tokens.shape[0] * (tokens.shape[1] - 1)

            def shard_loss(model, batch):
                (toks,) = batch
                logits, aux = model(toks)
                per_tok = cross_entropy_per_token(
                    logits[:, :-1].reshape(-1, cfg.vocab_size),
                    toks[:, 1:].reshape(-1))
                return per_tok.sum() / total + aux / world

            step = make_ep_shard_train_step(shard_loss, mesh, state)
            return (state, step, mesh, specs,
                    shard_batch((tokens,), mesh, ("data", "expert")))
        if row == "dp2_ep2":
            spec = MeshSpec(dp=2, ep=2, rules=tuple(moe_ep_rules("ep")))
            mesh = spec.build()
            model = MoETransformerLM(cfg, moe,
                                     attention_fn=flash_attention_fn(),
                                     ep_axis="ep", mesh=mesh,
                                     ep_tokens="replicated", device=device)
        else:
            sizes = {"dp2_tp2": dict(dp=2, tp=2),
                     "fsdp2_tp2": dict(fsdp=2, tp=2)}[row]
            spec = MeshSpec(rules=tuple(transformer_tp_rules("tp")),
                            **sizes)
            mesh = spec.build()
            model = TransformerLM(cfg, attention_fn=flash_attention_fn(),
                                  param_dtype=torch.float32, tp_axis="tp",
                                  mesh=mesh, device=device)
        state, specs = make_composed_state(model, sd, adam(LR), spec, mesh)
        step = make_composed_train_step(spec, mesh, loss_fn,
                                        param_specs=specs)
        return (state, step, mesh, specs,
                shard_composed_batch((tokens,), mesh, spec))

    def plain_step(model, loss_fn, tokens):
        """One unsharded Adam step on this process alone (no
        collective): the loss, the gradients, the parameters after."""
        opt = adam(LR)(model.parameters())
        loss, _ = loss_fn(model, (tokens,), None)
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        opt.step()
        return float(loss.detach()), grads, {n: p.detach().clone()
                                    for n, p in model.named_parameters()}

    rows = ("dp2_tp2", "fsdp2_tp2", "dp2_ep2", "ep_shard_d2_e2")
    moe_parity = MoEConfig(num_experts=8, top_k=2, dispatch="einsum",
                           capacity_factor=4.0, aux_loss_weight=0.0)
    moe_timing = MoEConfig(num_experts=8, top_k=2, dispatch="einsum")

    # parity: 2 layers, f32
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parity = {}
    for row in rows:
        moe = moe_parity if "ep" in row else None
        cfg = dense_cfg(2, args.parity_seq, torch.float32)
        model = whole_model(moe, cfg, args.seed + 1)
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        tokens = torch.from_numpy(markov_tokens(
            args.batch, args.parity_seq, cfg.vocab_size,
            args.seed + 1)).to(device)
        state, step, mesh, specs, batch = build(row, cfg, moe, sd, tokens)
        state, m = step(state, *batch)
        named = dict(state.model.named_parameters())
        grads = gather_tree({n: p.grad for n, p in named.items()}, mesh,
                            specs)
        params = gather_tree(named, mesh, specs)
        loss = float(m["loss"])
        del state, step
        if rank == 0:
            l_ref, g_ref, p_ref = plain_step(model, mean_loss(cfg, moe),
                                             tokens)
            rel = abs(loss - l_ref) / abs(l_ref)
            g_err = max((float((grads[n] - g_ref[n]).abs().max()
                               / g_ref[n].abs().max().clamp_min(1e-30)), n)
                        for n in g_ref)
            p_err = max((float((params[n] - p_ref[n]).abs().max()), n)
                        for n in p_ref)
            parity[row] = {"loss": loss, "loss_unsharded": l_ref,
                           "loss_rel_err": rel,
                           "grad_worst_rel_to_max": g_err[0],
                           "grad_worst_param": g_err[1],
                           "param_max_abs_diff": p_err[0],
                           "param_worst": p_err[1]}
            if not (rel <= LOSS_RTOL and g_err[0] <= GRAD_TOL
                    and p_err[0] <= 2 * LR * 1.001):
                failures.append(f"{row} parity: {parity[row]}")
        del model, grads, params
        dist.barrier()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    out["parity"] = parity

    # timing: bf16 on f32 masters
    def timed(step, state, batch):
        for _ in range(2):
            state, _ = step(state, *batch)
        sync()
        reset_peak()
        losses = []
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state, *batch)
            losses.append(m["loss"])
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / args.steps
        losses = [float(v) for v in losses]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            failures.append(f"losses {losses}")
        return {"ms_per_step": ms, "losses": losses}, peak()

    timing = {}
    for row in rows:
        moe = moe_timing if "ep" in row else None
        layers, seq = (2, args.moe_seq) if moe else (args.layers, args.seq)
        cfg = dense_cfg(layers, seq, torch.bfloat16)
        model = whole_model(moe, cfg, args.seed + 5)
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model
        tokens = torch.from_numpy(markov_tokens(
            args.batch, seq, cfg.vocab_size, args.seed)).to(device)
        state, step, _, _, batch = build(row, cfg, moe, sd, tokens)
        res, mem = timed(step, state, batch)
        del state, step
        mems = [None] * world
        dist.all_gather_object(mems, mem)
        timing[row] = {"layers": layers, "seq": seq, "batch": args.batch,
                       **res, "tokens_per_s": args.batch * seq
                       / res["ms_per_step"] * 1e3,
                       "max_memory_allocated_bytes_by_rank": mems}
    dist.barrier()
    if rank == 0:
        # the unsharded step on one card, per model
        for key, moe in (("dense", None), ("moe", moe_timing)):
            layers, seq = (2, args.moe_seq) if moe else (args.layers,
                                                         args.seq)
            cfg = dense_cfg(layers, seq, torch.bfloat16)
            reset_peak()
            model = whole_model(moe, cfg, args.seed + 5)
            tokens = torch.from_numpy(markov_tokens(
                args.batch, seq, cfg.vocab_size, args.seed)).to(device)
            loss_fn = mean_loss(cfg, moe)
            state = TrainState.create(model, adam(LR))

            def one_card(st, toks, loss_fn=loss_fn):
                st.optimizer.zero_grad(set_to_none=True)
                loss, _ = loss_fn(st.model, (toks,), None)
                loss.backward()
                return st.apply_gradients(), {"loss": loss.detach()}

            res, mem = timed(one_card, state, (tokens,))
            timing["unsharded_" + key] = {
                "layers": layers, "seq": seq, "batch": args.batch, **res,
                "tokens_per_s": args.batch * seq / res["ms_per_step"] * 1e3,
                "max_memory_allocated_bytes": mem}
            del model, state
        for row in rows:
            key = "unsharded_moe" if "ep" in row else "unsharded_dense"
            timing[row]["vs_unsharded"] = (timing[row]["ms_per_step"]
                                           / timing[key]["ms_per_step"])
    dist.barrier()
    out["timing"] = timing
    all_failures = [None] * world
    dist.all_gather_object(all_failures, failures)
    shutdown()
    if rank == 0:
        out["failures"] = [f for fs in all_failures for f in fs]
        print(json.dumps(out), flush=True)
    return 1 if any(all_failures) else 0


if __name__ == "__main__":
    sys.exit(main())
