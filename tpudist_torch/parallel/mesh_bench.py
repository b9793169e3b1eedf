"""The composition-matrix bench (counterpart of
:mod:`tpudist.parallel.mesh_bench`).

Runs :func:`~tpudist_torch.parallel.mesh.make_composed_train_step` at six
points of the dp × fsdp × tp × pp × ep space and BITWISE-compares the
loss and the updated parameters against the single-strategy entry point
for the same math at the same global batch (same init, same optimizer,
same data — only the axis names and the entry point differ).  Then it
trains a real multi-stage :class:`~tpudist_torch.models.transformer.
TransformerLM` through the interleaved 1F1B schedule (P=4, M=16, V=4 —
the acceptance point) and reports the schedule bubble fraction, the step
time and whether the FLOP counter (:func:`tpudist_torch.obs.xla.
cost_flops`, the ``xla/step_tflops``/``xla/mfu`` feed) counted the
composed step (``mfu_reported``).

The bench is one program across 8 processes, one a device.  ``python -m
tpudist_torch.parallel.mesh_bench --out f`` spawns them, one NCCL rank a
card, and stops with an error on a host with fewer than 8 cards;
``--force-cpu`` runs 8 gloo ranks on the CPU instead (as tpudist's
``--force-cpu`` forces 8 CPU devices).  In the ranks, :func:`run_all`
returns every row.  A row on 4 devices runs in 8 processes as two
replicas of its mesh (a leading ``rep`` axis of 2 that no step reads).
Weights come from a seeded ``torch.Generator`` (drawn on the CPU), or
from the state dicts passed in (the tests pass tpudist's flax weights,
converted).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

WORLD = 8
LM = dict(vocab_size=32, num_heads=2, embed_dim=16, max_seq_len=8)
RANK_TIMEOUT_S = 900.0


# ---- the mesh and the comparison --------------------------------------------

def _device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _mesh(axes: dict):
    """A mesh of ``axes`` over the world; a world larger than the mesh
    holds replicas of it along a leading ``rep`` axis."""
    from tpudist_torch.runtime.mesh import make_mesh

    n = int(np.prod(list(axes.values())))
    world = dist.get_world_size()
    if world % n:
        raise ValueError(f"a mesh of {axes} does not tile {world} processes")
    return make_mesh(axes if world == n else {"rep": world // n, **axes})


def _composed_mesh(spec):
    if dist.get_world_size() == spec.n_devices:
        return spec.build()
    return _mesh(spec.axis_sizes())


def _bitwise_equal(a: list, b: list) -> tuple[bool, float]:
    """(bitwise_equal, max_abs_diff) over two lists of tensors, across
    every process (each compares the blocks it holds)."""
    la = [t.detach().cpu().numpy() for t in a]
    lb = [t.detach().cpu().numpy() for t in b]
    if len(la) != len(lb) or any(x.shape != y.shape
                                 for x, y in zip(la, lb)):
        exact, diff = False, float("inf")
    else:
        exact = all(x.tobytes() == y.tobytes() for x, y in zip(la, lb))
        diff = max((float(np.max(np.abs(x.astype(np.float64) - y)))
                    if x.size else 0.0) for x, y in zip(la, lb))
    flags = torch.tensor([0.0 if exact else 1.0, diff], dtype=torch.float64,
                         device=_device())
    dist.all_reduce(flags, op=dist.ReduceOp.MAX)
    return bool(flags[0] == 0), float(flags[1])


def _params(state) -> list:
    return list(state.model.parameters())


@contextlib.contextmanager
def _throwaway(state):
    """Run steps on ``state`` and leave it as it was: the parameters, the
    optimizer's state and the step count are restored on exit, so a
    timed or counted step is not one the reported losses include."""
    saved = [p.detach().clone() for p in state.model.parameters()]
    opt = copy.deepcopy(state.optimizer.state_dict())
    step = state.step
    try:
        yield state
    finally:
        with torch.no_grad():
            for p, s in zip(state.model.parameters(), saved):
                p.copy_(s)
        state.optimizer.load_state_dict(opt)
        state.step = step


def _sync() -> None:
    if dist.get_backend() == "nccl":
        torch.cuda.synchronize()


def _run(step, state, batch, steps):
    metrics = None
    for _ in range(steps):
        state, metrics = step(state, *batch)
    _sync()
    return state, metrics


def _time_step(step, state, batch, iters=3) -> float:
    """Best-of-N wall seconds for one step, on a throwaway state."""
    best = float("inf")
    with _throwaway(state):
        for _ in range(iters):
            dist.barrier()
            t0 = time.perf_counter()
            step(state, *batch)
            _sync()
            best = min(best, time.perf_counter() - t0)
    return best


def _mfu_reported(step, state, batch) -> bool:
    """The composed step must yield counted FLOPs — the Trainer's
    ``xla/step_tflops``/``xla/mfu`` feed — under any axis combination.
    The counter runs the step, so it runs on a throwaway state."""
    from tpudist_torch.obs import xla as obs_xla

    with _throwaway(state):
        return obs_xla.cost_flops(step, state, *batch) is not None


def _row(name, spec, step, state, metrics, ref_state, ref_metrics, batch,
         steps):
    exact, diff = _bitwise_equal(
        [metrics["loss"]] + _params(state),
        [ref_metrics["loss"]] + _params(ref_state))
    return {
        "combo": name, "devices": spec.n_devices, "steps": steps,
        "exact_match": exact, "max_abs_diff": diff,
        "loss": float(metrics["loss"]), "ref_loss": float(ref_metrics["loss"]),
        "step_time_ms": round(_time_step(step, state, batch) * 1e3, 3),
        "mfu_reported": _mfu_reported(step, state, batch),
        "bubble_fraction": step.bubble_fraction,
    }


# ---- the one-layer LM of the GSPMD rows -------------------------------------

def _seeded_state_dict(model_cls, *args) -> dict:
    gen = torch.Generator().manual_seed(0)
    model = model_cls(*args, device="cpu").init_weights(gen)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _lm_setup(state_dict=None):
    """tpudist's ``_lm_setup``: the one-layer config, the whole weights
    (``state_dict`` or seeded), ``loss_fn(model, batch, generator)`` and
    the batch of 8 sequences of 8 tokens."""
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.ops.losses import cross_entropy

    cfg = TransformerConfig(num_layers=1, **LM)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 8)))
    targets = torch.roll(tokens, -1, dims=1)
    params = (state_dict if state_dict is not None
              else _seeded_state_dict(TransformerLM, cfg))

    def loss_fn(model, batch, _gen):
        toks, tgts = batch
        logits = model(toks)
        return cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             tgts.reshape(-1)), {}

    return cfg, params, loss_fn, (tokens, targets)


def _gspmd_row(name, spec, ref_axes, ref_specs_fn, ref_data_axes,
               model_fn, params, loss_fn, batch, steps=2):
    """One GSPMD matrix point: the composed step against the
    single-strategy step assembled from the same building blocks.
    ``model_fn(mesh, composed)`` builds the model for the mesh's layout
    (the composed mesh's axis names, or the reference's)."""
    from tpudist_torch.parallel.mesh import (
        make_composed_state,
        make_composed_train_step,
        shard_composed_batch,
    )
    from tpudist_torch.parallel.tensor_parallel import (
        make_spmd_train_step,
        shard_batch,
        sharded_state,
    )
    from tpudist_torch.train import sgd

    dev = _device()
    batch = tuple(x.to(dev) for x in batch)
    ref_mesh = _mesh(ref_axes)
    ref_model = model_fn(ref_mesh, False)
    ref_specs = ref_specs_fn(ref_mesh, ref_model)
    ref_state = sharded_state(ref_model, params, sgd(0.1), ref_mesh,
                              ref_specs)
    ref_step = make_spmd_train_step(loss_fn, ref_mesh, ref_specs,
                                    donate=False, batch_axes=ref_data_axes)
    ref_batch = shard_batch(batch, ref_mesh, ref_data_axes)
    ref_state, ref_metrics = _run(ref_step, ref_state, ref_batch, steps)

    mesh = _composed_mesh(spec)
    state, specs = make_composed_state(model_fn(mesh, True), params,
                                       sgd(0.1), spec, mesh)
    step = make_composed_train_step(spec, mesh, loss_fn, param_specs=specs,
                                    donate=False)
    cbatch = shard_composed_batch(batch, mesh, spec)
    state, metrics = _run(step, state, cbatch, steps)
    return _row(name, spec, step, state, metrics, ref_state, ref_metrics,
                cbatch, steps)


# ---- the pipeline rows ------------------------------------------------------

def _pipeline_rows():
    """dp×pp (1F1B) and dp×pp×tp (stacked schedule + Megatron block)
    composed points against the direct pipeline entry points."""
    from tpudist_torch.ops.losses import mse_loss
    from tpudist_torch.parallel import pipeline as pl
    from tpudist_torch.parallel.common import id_fwd_psum_bwd, psum_fwd_id_bwd
    from tpudist_torch.parallel.mesh import (
        MeshSpec,
        make_composed_train_step,
        shard_composed_batch,
    )
    from tpudist_torch.parallel.tensor_parallel import shard_batch
    from tpudist_torch.train import TrainState, sgd

    dev = _device()
    rows = []
    rng = np.random.default_rng(0)
    M, d, ff = 4, 8, 16

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def state_of(params, mesh, specs):
        part = pl.shard_stage_params(params, mesh, specs)
        return TrainState.create(pl.ParamTree(part, device=dev), sgd(0.1))

    # -- dp2 × pp2: homogeneous tanh blocks through the 1F1B schedule ----
    P_ = 2
    params = {"w": f32(rng.standard_normal((P_, d, d)) * 0.3),
              "b": f32(np.zeros((P_, d)))}

    def block(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    x = f32(rng.standard_normal((16, d)))
    y = f32(rng.standard_normal((16, d)))

    ref_mesh = _mesh({"data": 2, "stage": P_})
    ref_state = state_of(params, ref_mesh,
                         pl.stacked_state_specs(params, P_, "stage"))
    ref_step = pl.make_1f1b_pipeline_train_step(
        block, mse_loss, ref_mesh, M, ref_state, donate=False)
    ref_state, ref_metrics = _run(ref_step, ref_state,
                                  shard_batch((x, y), ref_mesh, "data"), 2)

    spec = MeshSpec(dp=2, pp=P_, num_microbatches=M)
    mesh = _composed_mesh(spec)
    state = state_of(params, mesh, pl.stacked_state_specs(params, P_, "pp"))
    step = make_composed_train_step(
        spec, mesh, block_fn=block, stage_loss_fn=mse_loss,
        state_example=state, donate=False)
    batch = shard_composed_batch((x, y), mesh, spec)
    state, metrics = _run(step, state, batch, 2)
    rows.append(_row("dp2_pp2", spec, step, state, metrics, ref_state,
                     ref_metrics, batch, 2))

    # -- dp2 × pp2 × tp2: stacked schedule, Megatron MLP block ------------
    params3 = {"up": f32(rng.standard_normal((P_, d, ff)) * 0.3),
               "down": f32(rng.standard_normal((P_, ff, d)) * 0.3)}

    def tp_block(group):
        def fn(p, a):
            a = id_fwd_psum_bwd(a, group)
            h = torch.tanh(a @ p["up"])
            return psum_fwd_id_bwd(h @ p["down"], group)
        return fn

    def tp_step(mesh, stage, model, entry, **kw):
        specs = {"up": (stage, None, model), "down": (stage, model, None)}
        st = state_of(params3, mesh, specs)
        stp = entry(tp_block(mesh.get_group(model)), mse_loss, mesh, st,
                    pl.state_specs_like(st, specs), (model,), **kw)
        return st, stp

    ref_mesh = _mesh({"data": 2, "stage": P_, "model": 2})
    ref_state, ref_step = tp_step(
        ref_mesh, "stage", "model",
        lambda blk, loss, m, st, ss, gs: pl.make_stacked_pipeline_train_step(
            blk, loss, m, M, st, state_specs=ss, grad_sync_axes=gs,
            donate=False))
    ref_state, ref_metrics = _run(ref_step, ref_state,
                                  shard_batch((x, y), ref_mesh, "data"), 2)

    spec = MeshSpec(dp=2, pp=P_, tp=2, num_microbatches=M)
    mesh = _composed_mesh(spec)
    state, step = tp_step(
        mesh, "pp", "tp",
        lambda blk, loss, m, st, ss, gs: make_composed_train_step(
            spec, m, block_fn=blk, stage_loss_fn=loss, state_example=st,
            state_specs=ss, grad_sync_axes=gs, donate=False))
    batch = shard_composed_batch((x, y), mesh, spec)
    state, metrics = _run(step, state, batch, 2)
    rows.append(_row("dp2_pp2_tp2", spec, step, state, metrics, ref_state,
                     ref_metrics, batch, 2))
    return rows


def _ep_row(state_dict=None):
    """dp×ep against the expert-parallel step over ``data × expert``.  The
    load-balance term is a statistic of each data shard's tokens here and
    of the global batch in tpudist's GSPMD program, so the two packages'
    losses differ by that term's share (ROADMAP Queue C 15)."""
    from tpudist_torch.models.moe import MoEConfig, MoETransformerLM
    from tpudist_torch.models.transformer import TransformerConfig
    from tpudist_torch.ops.losses import cross_entropy
    from tpudist_torch.parallel.expert_parallel import moe_ep_rules
    from tpudist_torch.parallel.mesh import MeshSpec
    from tpudist_torch.parallel.tensor_parallel import spec_tree_from_rules

    cfg = TransformerConfig(num_layers=1, **LM)
    moe = MoEConfig(num_experts=2, top_k=1, capacity_factor=4.0)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 32, (8, 8)))
    params = (state_dict if state_dict is not None
              else _seeded_state_dict(MoETransformerLM, cfg, moe))

    def loss_fn(model, batch, _gen):
        (toks,) = batch
        logits, aux = model(toks)
        ce = cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                           toks[:, 1:].reshape(-1))
        return ce + aux, {}

    def model_fn(mesh, composed):
        return MoETransformerLM(cfg, moe, ep_axis="ep" if composed
                                else "expert", mesh=mesh,
                                ep_tokens="replicated", device=_device())

    spec = MeshSpec(dp=2, ep=2, rules=tuple(moe_ep_rules("ep")))
    return _gspmd_row(
        "dp2_ep2", spec, {"data": 2, "expert": 2},
        lambda m, model: spec_tree_from_rules(model, moe_ep_rules("expert")),
        ("data",), model_fn, params, loss_fn, (tokens,))


def run_matrix(weights: dict | None = None) -> list:
    """The six-combo composition matrix, bitwise against the references.
    ``weights`` may hold ``"lm"`` (the one-layer LM's state dict) and
    ``"moe"`` (the MoE LM's); a missing one is seeded."""
    from tpudist_torch.models.transformer import TransformerLM
    from tpudist_torch.parallel.fsdp import fsdp_specs
    from tpudist_torch.parallel.mesh import MeshSpec
    from tpudist_torch.parallel.tensor_parallel import (
        spec_tree_from_rules,
        transformer_tp_rules,
    )

    weights = weights or {}
    cfg, params, loss_fn, batch = _lm_setup(state_dict=weights.get("lm"))
    rules = tuple(transformer_tp_rules("tp"))

    def tp_model(mesh, composed):
        return TransformerLM(cfg, tp_axis="tp" if composed else "model",
                             mesh=mesh, device=_device())

    def fsdp_tp(m, model):
        return fsdp_specs(model, m, axis="fsdp",
                          tp_rules=transformer_tp_rules("model"))

    rows = [
        _gspmd_row("dp2_tp2", MeshSpec(dp=2, tp=2, rules=rules),
                   {"data": 2, "model": 2},
                   lambda m, model: spec_tree_from_rules(
                       model, transformer_tp_rules("model")),
                   ("data",), tp_model, params, loss_fn, batch),
        _gspmd_row("fsdp2_tp2", MeshSpec(fsdp=2, tp=2, rules=rules),
                   {"fsdp": 2, "model": 2}, fsdp_tp, ("fsdp",), tp_model,
                   params, loss_fn, batch),
        _gspmd_row("dp2_fsdp2_tp2", MeshSpec(dp=2, fsdp=2, tp=2, rules=rules),
                   {"data": 2, "fsdp": 2, "model": 2}, fsdp_tp,
                   ("data", "fsdp"), tp_model, params, loss_fn, batch),
    ]
    rows.extend(_pipeline_rows())
    rows.append(_ep_row(weights.get("moe")))
    return rows


# ---- the acceptance point: a real LM through interleaved 1F1B ---------------

def _lm_fns(cfg):
    """block_fn, embed_fn, head_loss_fn of the real-model 1F1B mode: a
    chunk is a run of DecoderBlocks (plain attention, as tpudist's bench
    builds them), the embedding, and the norm + head + cross-entropy."""
    from torch.func import functional_call

    from tpudist_torch.models.transformer import DecoderBlock, LayerNorm, sdpa
    from tpudist_torch.ops.losses import cross_entropy

    blk = DecoderBlock(cfg, sdpa, device="meta")
    ln_f = LayerNorm(cfg.embed_dim, cfg.compute_dtype, "meta")

    def block_fn(p, a):
        for j in range(next(iter(p.values())).shape[0]):
            a = functional_call(blk, {k: v[j] for k, v in p.items()}, (a,))
        return a

    def embed_fn(ex, x):
        return ex["tok_embed.weight"][x] \
            + ex["pos_embed.weight"][:x.shape[1]][None]

    def head_loss_fn(ex, out, y):
        h = functional_call(ln_f, {"scale": ex["ln_f.scale"],
                                   "bias": ex["ln_f.bias"]}, (out,))
        logits = h @ ex["lm_head.weight"].T
        return cross_entropy(logits.reshape(-1, cfg.vocab_size),
                             y.reshape(-1))

    return block_fn, embed_fn, head_loss_fn


def run_real_lm(n_stages=4, microbatches=16, virtual=4, dp=2, steps=3,
                state_dict=None):
    """The acceptance point: a REAL multi-stage TransformerLM trained
    end-to-end through the interleaved 1F1B schedule — stage-boundary
    activations hopping between processes, embedding and head gradients
    riding the extra-params path, the bubble measured from the schedule
    that actually ran (P=4/M=16/V=4 → ≤ 0.08)."""
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.parallel import pipeline as pl
    from tpudist_torch.parallel.mesh import (
        MeshSpec,
        make_composed_train_step,
        shard_composed_batch,
    )
    from tpudist_torch.train import TrainState, sgd

    L = n_stages * virtual
    cfg = TransformerConfig(num_layers=L, **LM)
    seq = cfg.max_seq_len
    rng = np.random.default_rng(0)
    per_shard = microbatches * 2          # micro-batch of 2 sequences
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (per_shard * dp, seq)))
    targets = torch.roll(tokens, -1, dims=1)

    sd = (state_dict if state_dict is not None
          else _seeded_state_dict(TransformerLM, cfg))
    names = [k[len("blocks.0."):] for k in sd if k.startswith("blocks.0.")]
    stages = {n: torch.stack([torch.as_tensor(sd[f"blocks.{i}.{n}"])[None]
                              for i in range(L)]) for n in names}
    stages = pl.interleave_params(stages, n_stages, virtual)
    extra = {k: torch.as_tensor(v) for k, v in sd.items()
             if not k.startswith("blocks.")}
    params = {"stages": stages, "extra": extra}

    spec = MeshSpec(dp=dp, pp=n_stages, num_microbatches=microbatches,
                    virtual_stages=virtual)
    mesh = _composed_mesh(spec)
    dev = _device()
    specs = pl.stacked_state_specs(params, spec.n_stages, "pp",
                                   overrides={"extra": ()})
    part = pl.shard_stage_params(params, mesh, specs)
    state = TrainState.create(pl.ParamTree(part, device=dev), sgd(0.1))
    block_fn, embed_fn, head_loss_fn = _lm_fns(cfg)
    step = make_composed_train_step(
        spec, mesh, block_fn=block_fn, embed_fn=embed_fn,
        head_loss_fn=head_loss_fn, state_example=state, donate=True)
    batch = shard_composed_batch((tokens.to(dev), targets.to(dev)), mesh,
                                 spec)

    losses = []
    for _ in range(steps):
        state, metrics = step(state, *batch)
        losses.append(float(metrics["loss"]))
    mfu = _mfu_reported(step, state, batch)
    dist.barrier()
    t0 = time.perf_counter()
    state, metrics = step(state, *batch)
    _sync()
    steady_ms = (time.perf_counter() - t0) * 1e3
    losses.append(float(metrics["loss"]))
    return {
        "combo": f"real_lm_pp{n_stages}_dp{dp}_1f1b",
        "devices": spec.n_devices, "P": n_stages, "M": microbatches,
        "V": virtual, "layers": L, "steps": len(losses),
        "global_batch": int(tokens.shape[0]),
        "bubble_fraction": round(step.bubble_fraction, 4),
        "schedule_ticks": int(step.schedule.T),
        "loss_first": losses[0], "loss_last": losses[-1],
        "trained": bool(losses[-1] < losses[0])
        and all(np.isfinite(losses)),
        "step_time_ms": round(steady_ms, 3),
        "mfu_reported": mfu,
    }


def run_all(weights: dict | None = None) -> list:
    """Every row, in tpudist's order; called in each of the 8 processes.
    ``weights`` may also hold ``"real_lm"`` (the 16-layer LM's state
    dict)."""
    rows = run_matrix(weights)
    rows.append(run_real_lm(state_dict=(weights or {}).get("real_lm")))
    return rows


# ---- the CLI: spawn the ranks -----------------------------------------------

def _rank_main(rank: int, world: int) -> list:
    if dist.get_backend() == "gloo":
        # eight CPU ranks on one host: one thread each (more oversubscribe
        # the cores while gloo waits)
        torch.set_num_threads(1)
    return run_all()


def spawn_run_all(device: str = "cuda") -> list:
    """:func:`run_all` in ``WORLD`` spawned processes: one NCCL rank a
    card (``cuda``; the host must have ``WORLD`` cards), or gloo ranks on
    the CPU (``cpu``).  Returns rank 0's rows."""
    from tpudist_torch.runtime.distributed import spawn_ranks

    if device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < WORLD:
            raise RuntimeError(
                f"mesh_bench runs one NCCL rank a card and needs {WORLD} "
                f"cards; this host has {n} (--force-cpu runs {WORLD} gloo "
                f"ranks on the CPU)")
    elif device != "cpu":
        raise ValueError(f"mesh_bench runs on cuda or cpu, got {device!r}")
    return spawn_ranks(_rank_main, WORLD, device=device,
                       timeout=RANK_TIMEOUT_S)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="write JSON rows here (one per line); else stdout")
    ap.add_argument("--force-cpu", action="store_true",
                    help=f"run the {WORLD} ranks on the CPU (gloo, one "
                         f"thread each) instead of one NCCL rank a card")
    args = ap.parse_args(argv)
    rows = spawn_run_all("cpu" if args.force_cpu else "cuda")
    text = "\n".join(json.dumps(r) for r in rows) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
