"""tpudist_torch's pipeline steps against tpudist's, on the same seeded
numpy weights and batch.

The port's steps run two ways: one stage a process, in 4 gloo ranks
spawned once for the module (``run_ranks``) on ``data × stage`` meshes of
2 × 2 and 1 × 4, and all stages in this one process (``mesh=None,
local_stages=P``, as ``chip_smoke.py`` runs them on one card) with the
whole global batch.  tpudist's run on the same mesh shape of conftest's
virtual CPU devices.  Cases: GPipe with heterogeneous dense stages, its
forward alone, packed, stacked, interleaved, 1F1B at V = 1 and 2 and its
real-model mode on a tiny ``TransformerLM`` with flash attention (the
plain versions of K1/K3/K4 on the CPU; tpudist's Pallas kernels in
interpret mode).  The same ranks run the 3-D step of tpudist's
``TestThreeDParallel`` (data 1 × stage 2 × model 2: the stacked pipeline
of Megatron MLP blocks through ``state_specs=``/``grad_sync_axes=``),
held against tpudist's sequential full-weight step with its limits.

Tolerances (f32, SGD steps): the loss within rtol 1e-5 and every
parameter within atol 1e-5 + rtol 1e-4 of tpudist's (tpudist's own
pipeline tests' limits: the schedules sum the micro-batches' gradients in
other orders than one batch does); the real-model case within atol 2e-5
(tpudist's own for it).  Every data replica of a stage ends bitwise equal
to the first.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_data_parallel import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
LM_TOL = dict(atol=2e-5, rtol=1e-4)
GLOBAL_BATCH = 16
LM = dict(vocab_size=32, num_heads=2, embed_dim=16, max_seq_len=8)


def _case(name, kind, data, P, M, V=1, lr=0.2, steps=1, seed=0):
    return dict(name=name, kind=kind, data=data, P=P, M=M, V=V, lr=lr,
                steps=steps, seed=seed)


# every case runs on 4 ranks; the local-stage run takes the same batch
CASES = [
    _case("gpipe_2x2", "gpipe", 2, 2, 4),
    _case("gpipe_1x4", "gpipe", 1, 4, 2),
    _case("forward_2x2", "forward", 2, 2, 2),
    _case("packed_2x2", "packed", 2, 2, 4),
    _case("packed_1x4", "packed", 1, 4, 2, seed=1),
    _case("stacked_2x2", "stacked", 2, 2, 2, lr=0.3, steps=2),
    _case("interleaved_2x2_v2", "interleaved", 2, 2, 4, V=2, lr=0.1),
    _case("1f1b_2x2", "1f1b", 2, 2, 4, lr=0.3),
    _case("1f1b_1x4", "1f1b", 1, 4, 4, lr=0.3),
    _case("1f1b_2x2_v2", "1f1b", 2, 2, 4, V=2),
    _case("lm_1f1b_2x2", "lm", 2, 2, 2, lr=0.1),
    _case("lm_1f1b_2x2_v2", "lm", 2, 2, 4, V=2, lr=0.1),
]
BY_NAME = {c["name"]: c for c in CASES}
DIMS = [12, 24, 16, 20, 8]
D = 16


# ---- inputs (numpy, seeded) -------------------------------------------------

def _inputs(case):
    """``(params, x, y)``: the parameters in the port's layout (stacked
    cases in device order) and the global batch."""
    rng = np.random.default_rng(case["seed"])
    P, V = case["P"], case["V"]
    if case["kind"] == "lm":
        from tpudist_torch.models.convert import from_flax_stacked_blocks

        flax_params, _ = _flax_lm(case)
        params = {k: {n: t.numpy() for n, t in v.items()} for k, v in
                  from_flax_stacked_blocks(flax_params, _lm_cfg(case), P,
                                           V).items()}
        tokens = rng.integers(0, LM["vocab_size"], (GLOBAL_BATCH,
                                                    LM["max_seq_len"]))
        return params, tokens.astype(np.int64), np.roll(tokens, -1, 1)
    if case["kind"] in ("gpipe", "forward", "packed"):
        dims = DIMS[:P + 1]
        params = tuple(
            {"w": (rng.standard_normal((dims[s], dims[s + 1])) * 0.1
                   ).astype(np.float32),
             "b": (rng.standard_normal(dims[s + 1]) * 0.1).astype(
                 np.float32)}
            for s in range(P))
        din, dout = dims[0], dims[-1]
    else:
        L = P * V
        chunks = {"w": (rng.standard_normal((L, D, D)) * 0.2).astype(
                      np.float32),
                  "b": (rng.standard_normal((L, D)) * 0.1).astype(
                      np.float32)}
        params = _interleave(chunks, P, V)
        din = dout = D
    x = rng.standard_normal((GLOBAL_BATCH, din)).astype(np.float32)
    y = rng.standard_normal((GLOBAL_BATCH, dout)).astype(np.float32)
    return params, x, y


def _interleave(tree, P, V):
    from tpudist_torch.parallel.pipeline import interleave_params

    return interleave_params(tree, P, V)


def _lm_cfg(case, torch_side=True):
    L = case["P"] * case["V"]
    if torch_side:
        from tpudist_torch.models.transformer import TransformerConfig
    else:
        from tpudist.models import TransformerConfig
    return TransformerConfig(num_layers=L, **LM)


def _flax_lm(case):
    import jax
    import jax.numpy as jnp

    from tpudist.models import TransformerLM

    cfg = _lm_cfg(case, torch_side=False)
    params = TransformerLM(cfg).init(
        jax.random.key(case["seed"]),
        jnp.zeros((2, LM["max_seq_len"]), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params), cfg


# ---- the port's side (ranks and this process) -------------------------------

def _dense(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _lm_fns(case):
    """block_fn, embed_fn, head_loss_fn of the port's real-model mode:
    each chunk a run of DecoderBlocks (flash attention), the embedding
    and the norm + head + cross-entropy as tpudist's test writes them."""
    from torch.func import functional_call

    from tpudist_torch.models.transformer import DecoderBlock, LayerNorm
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.ops.losses import cross_entropy

    cfg = _lm_cfg(case)
    blk = DecoderBlock(cfg, flash_attention_fn(), device="meta")
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


def run_port_case(case, mesh, x, y, params):
    """One case of the port on ``mesh`` (None: all stages here), from this
    process's part of the parameters: losses (or the forward's output)
    and this process's parameters after the steps, in numpy."""
    from tpudist_torch.ops.losses import mse_loss
    from tpudist_torch.parallel import pipeline as pl
    from tpudist_torch.train import TrainState, sgd

    kind, P, M, V = case["kind"], case["P"], case["M"], case["V"]
    local = None if mesh is not None else P
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    if kind in ("gpipe", "forward"):
        model = pl.ParamTree(params, device="cpu")
        if kind == "forward":
            fwd = pl.make_pipeline_forward([_dense] * P, mesh, M,
                                           local_stages=local)
            return {"out": fwd(model, x).numpy()}
        step = pl.make_pipeline_train_step([_dense] * P, mse_loss, mesh, M,
                                           local_stages=local)
        state = TrainState.create(model, sgd(case["lr"]))
    elif kind == "packed":
        flat, meta = pl.pack_stage_params(params)
        part = pl.shard_stage_params(flat, mesh, {".": ("stage",)})
        state = TrainState.create(pl.ParamTree(part, device="cpu"),
                                  sgd(case["lr"]))
        step = pl.make_packed_pipeline_train_step(
            [_dense] * P, mse_loss, mesh, M, meta, state, local_stages=local)
    else:
        specs = pl.stacked_state_specs(params, P * V,
                                       overrides={"extra": ()})
        part = pl.shard_stage_params(params, mesh, specs)
        state = TrainState.create(pl.ParamTree(part, device="cpu"),
                                  sgd(case["lr"]))
        if kind == "stacked":
            step = pl.make_stacked_pipeline_train_step(
                _dense, mse_loss, mesh, M, state, local_stages=local)
        elif kind == "interleaved":
            step = pl.make_interleaved_pipeline_train_step(
                _dense, mse_loss, mesh, M, V, state, local_stages=local)
        elif kind == "1f1b":
            step = pl.make_1f1b_pipeline_train_step(
                _dense, mse_loss, mesh, M, state, virtual_stages=V,
                local_stages=local)
        else:
            block_fn, embed_fn, head_loss_fn = _lm_fns(case)
            step = pl.make_1f1b_pipeline_train_step(
                block_fn, None, mesh, M, state, virtual_stages=V,
                embed_fn=embed_fn, head_loss_fn=head_loss_fn,
                local_stages=local)
    losses = []
    for _ in range(case["steps"]):
        state, metrics = step(state, x, y)
        losses.append(float(metrics["loss"]))
    tree = state.model.tree()
    from tpudist_torch.utils.trees import tree_to_numpy

    return {"losses": losses, "params": tree_to_numpy(tree),
            "bubble": getattr(step, "bubble_fraction", None)}


def _pipeline_rank(rank, world, payload, three_d):
    """Every case, in turn, on this rank (``payload``: each case with its
    inputs, made by the parent); the 3-D cases; and the error probes."""
    from tpudist_torch.runtime.mesh import local_block, make_mesh

    out = {}
    for case, (params, x, y) in payload:
        mesh = make_mesh({"data": case["data"], "stage": case["P"]})
        xb = local_block(torch.from_numpy(x), mesh, ("data",)).numpy()
        yb = local_block(torch.from_numpy(y), mesh, ("data",)).numpy()
        out[case["name"]] = run_port_case(case, mesh, xb, yb, params)
    for name, (params, x, y) in three_d.items():
        out[name] = run_three_d(params, x, y)
    out["errors"] = _probe_errors()
    return out


# ---- 3-D: data × stage × model (tpudist's TestThreeDParallel) --------------

THREE_D_SPECS = {"scale": ("stage",), "up": ("stage", None, "model"),
                 "down": ("stage", "model", None)}
THREE_D_AXES = {"data": 1, "stage": 2, "model": 2}


def _three_d_inputs(seed, with_scale):
    """tpudist's TestThreeDParallel weights and batch: L = 2 stacked
    chunks, d 8, ff 16."""
    rng = np.random.default_rng(seed)
    L, d, ff = 2, 8, 16
    params = {}
    if with_scale:
        params["scale"] = (1.0 + 0.1 * rng.standard_normal((L, d))).astype(
            np.float32)
    params["up"] = (rng.standard_normal((L, d, ff)) * 0.3).astype(
        np.float32)
    params["down"] = (rng.standard_normal((L, ff, d)) * 0.3).astype(
        np.float32)
    x = rng.standard_normal((16, d)).astype(np.float32)
    y = rng.standard_normal((16, d)).astype(np.float32)
    return params, x, y


def run_three_d(params, x, y):
    """The stacked GPipe step of a Megatron MLP block over the model
    axis (f before the column-parallel up, g after the row-parallel
    down; a scale replicated over the model axis between them), one SGD
    step at M = 4, the blocks gathered back whole."""
    from tpudist_torch.ops.losses import mse_loss
    from tpudist_torch.parallel import pipeline as pl
    from tpudist_torch.parallel.common import id_fwd_psum_bwd, psum_fwd_id_bwd
    from tpudist_torch.parallel.tensor_parallel import gather_tree
    from tpudist_torch.runtime.mesh import make_mesh
    from tpudist_torch.train import TrainState, sgd

    mesh = make_mesh(THREE_D_AXES)
    group = mesh.get_group("model")
    specs = {k: THREE_D_SPECS[k] for k in params}
    part = pl.shard_stage_params(params, mesh, specs)
    state = TrainState.create(pl.ParamTree(part, device="cpu"), sgd(0.1))

    def tp_block(p, a):
        a = id_fwd_psum_bwd(a, group)
        if "scale" in p:
            a = a * p["scale"]
        h = torch.tanh(a @ p["up"])
        return psum_fwd_id_bwd(h @ p["down"], group)

    step = pl.make_stacked_pipeline_train_step(
        tp_block, mse_loss, mesh, 4, state,
        state_specs=pl.state_specs_like(state, specs),
        grad_sync_axes=("model",))
    state, metrics = step(state, torch.from_numpy(x), torch.from_numpy(y))
    tree = state.model.tree()
    full = gather_tree({k: tree[k] for k in specs}, mesh, specs)
    errors = {}
    try:
        pl.make_stacked_pipeline_train_step(
            tp_block, mse_loss, mesh, 4, state,
            state_specs=pl.state_specs_like(state, specs))
    except ValueError as e:
        errors["sync"] = str(e)
    try:
        pl.make_stacked_pipeline_train_step(
            tp_block, mse_loss, mesh, 4, state,
            state_specs=pl.state_specs_like(
                state, {k: ("model",) + tuple(v[1:]) for k, v in
                        specs.items()}), grad_sync_axes=())
    except ValueError as e:
        errors["stage"] = str(e)
    return {"loss": float(metrics["loss"]), "errors": errors,
            "params": {k: v.numpy() for k, v in full.items()}}


def _probe_errors():
    """The factories' and steps' refusals on a 2 × 2 mesh: a stage count
    that is not the mesh's, a batch M does not divide, an integer stage
    boundary."""
    from tpudist_torch.ops.losses import mse_loss
    from tpudist_torch.parallel import pipeline as pl
    from tpudist_torch.runtime.mesh import make_mesh
    from tpudist_torch.train import TrainState, sgd

    mesh = make_mesh({"data": 2, "stage": 2})
    msgs = {}
    try:
        pl.make_pipeline_train_step([_dense] * 3, mse_loss, mesh, 2)
    except ValueError as e:
        msgs["stages"] = str(e)
    params = tuple({"w": torch.zeros(4, 4), "b": torch.zeros(4)}
                   for _ in range(2))
    state = TrainState.create(pl.ParamTree(params, device="cpu"), sgd(0.1))
    step = pl.make_pipeline_train_step([_dense] * 2, mse_loss, mesh, 2)
    for key, x in (("batch", torch.zeros(7, 4)),
                   ("integer", torch.zeros(8, 4, dtype=torch.int32))):
        try:
            step(state, x, torch.zeros(x.shape[0], 4))
        except ValueError as e:
            msgs[key] = str(e)
    return msgs


THREE_D = {"three_d": (0, False), "three_d_scale": (1, True)}


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    payload = [(case, _inputs(case)) for case in CASES]
    three_d = {k: _three_d_inputs(*v) for k, v in THREE_D.items()}
    return run_ranks(_pipeline_rank, 4, tmp_path_factory.mktemp("pp"),
                     payload, three_d)


# ---- tpudist's side ---------------------------------------------------------

_JAX_CACHE: dict = {}


def jax_case(name):
    """tpudist's run of a case on its mesh shape: losses (or the forward's
    output) and the parameters after the steps, in the port's layout."""
    if name in _JAX_CACHE:
        return _JAX_CACHE[name]
    import jax
    import jax.numpy as jnp
    import optax

    from tpudist.ops.losses import mse_loss
    from tpudist.parallel import pipeline as jpl
    from tpudist.train.state import TrainState as JState

    case = BY_NAME[name]
    kind, P, M, V = case["kind"], case["P"], case["M"], case["V"]
    params, x, y = _inputs(case)
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:case["data"] * P]).reshape(case["data"], P),
        ("data", "stage"))
    tx = optax.sgd(case["lr"])

    def dense(p, a):
        return jnp.tanh(a @ p["w"] + p["b"])

    jparams = jax.tree.map(jnp.asarray, params)
    if kind == "forward":
        fwd = jpl.make_pipeline_forward([dense] * P, mesh, M)
        result = {"out": np.asarray(fwd(jparams, jnp.asarray(x)))}
        _JAX_CACHE[name] = result
        return result
    to_port = lambda p: p  # noqa: E731
    if kind == "gpipe":
        state = JState.create(None, jparams, tx)
        step = jpl.make_pipeline_train_step([dense] * P, mse_loss, mesh, M,
                                            donate=False)
    elif kind == "packed":
        flat, meta = jpl.pack_stage_params(jparams)
        state = JState.create(None, flat, tx)
        step = jpl.make_packed_pipeline_train_step(
            [dense] * P, mse_loss, mesh, M, meta, state, donate=False)
    elif kind == "stacked":
        state = JState.create(None, jparams, tx)
        step = jpl.make_stacked_pipeline_train_step(
            dense, mse_loss, mesh, M, state, donate=False)
    elif kind == "interleaved":
        state = JState.create(None, jparams, tx)
        step = jpl.make_interleaved_pipeline_train_step(
            dense, mse_loss, mesh, M, V, state, donate=False)
    elif kind == "1f1b":
        state = JState.create(None, jparams, tx)
        step = jpl.make_1f1b_pipeline_train_step(
            dense, mse_loss, mesh, M, state, donate=False, virtual_stages=V)
    else:
        state, step, to_port = _jax_lm_step(case, mesh, tx)
        x, y = x.astype(np.int32), y.astype(np.int32)
    losses = []
    for _ in range(case["steps"]):
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(metrics["loss"]))
    result = {"losses": losses,
              "params": to_port(jax.tree.map(np.asarray, state.params)),
              "bubble": getattr(step, "bubble_fraction", None)}
    _JAX_CACHE[name] = result
    return result


def _jax_lm_step(case, mesh, tx):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from tpudist.models.transformer import DecoderBlock
    from tpudist.ops.flash_attention import flash_attention_fn
    from tpudist.ops.losses import cross_entropy
    from tpudist.parallel import pipeline as jpl
    from tpudist.train.state import TrainState as JState
    from tpudist_torch.models.convert import from_flax_stacked_blocks

    P, V, M = case["P"], case["V"], case["M"]
    L = P * V
    flat, cfg = _flax_lm(case)
    stages = jpl.interleave_params(jax.tree.map(
        lambda *xs: jnp.stack(xs), *[flat[f"block{i}"] for i in range(L)]),
        P, V)
    extra = {k: v for k, v in flat.items() if not k.startswith("block")}
    state = JState.create(None, {"stages": stages, "extra": extra}, tx)
    blk = DecoderBlock(cfg, attention_fn=flash_attention_fn())
    ln_f = nn.LayerNorm(name="ln_f")

    def block_fn(p, a):
        return blk.apply({"params": p}, a)

    def embed_fn(ex, x_mb):
        a = jnp.take(ex["tok_embed"]["embedding"], x_mb, axis=0)
        pos = jnp.arange(x_mb.shape[1])
        return a + jnp.take(ex["pos_embed"]["embedding"], pos, axis=0)[None]

    def head_loss_fn(ex, out, y_mb):
        h = ln_f.apply({"params": ex["ln_f"]}, out)
        logits = h @ ex["lm_head"]["kernel"]
        return cross_entropy(logits.reshape(-1, cfg.vocab_size),
                             y_mb.reshape(-1))

    step = jpl.make_1f1b_pipeline_train_step(
        block_fn, None, mesh, M, state, donate=False, virtual_stages=V,
        embed_fn=embed_fn, head_loss_fn=head_loss_fn)

    def to_port(p):
        pos = {v * P + q: q * V + v for q in range(P) for v in range(V)}
        tree = dict(p["extra"])
        for c in range(L):
            tree[f"block{c}"] = jax.tree.map(lambda leaf: leaf[pos[c]],
                                             p["stages"])
        sd = from_flax_stacked_blocks(tree, _lm_cfg(case), P, V)
        return {k: {n: t.numpy() for n, t in v.items()}
                for k, v in sd.items()}

    return state, step, to_port


# ---- comparison -------------------------------------------------------------

def _flat(tree):
    from tpudist_torch.utils.trees import flatten_with_names

    return flatten_with_names(tree)


def _assemble(case, results):
    """The whole parameter tree from the ranks' parts (data row 0 by
    stage), after checking every data replica equals its row-0 twin."""
    P = case["P"]
    parts = [_flat(r[case["name"]]["params"]) for r in results]
    for r, part in enumerate(parts):
        for k, v in part.items():
            np.testing.assert_array_equal(v, parts[r % P][k],
                                          err_msg=f"rank {r} {k}")
    if case["kind"] == "gpipe":
        return parts[0]
    specs_full = {}
    for k in parts[0]:
        lead = "extra" not in k
        specs_full[k] = (np.concatenate([parts[s][k] for s in range(P)])
                         if lead else parts[0][k])
    return specs_full


def _hold(case, got_losses, got_params, want):
    tol = LM_TOL if case["kind"] == "lm" else PARAM_TOL
    np.testing.assert_allclose(got_losses, want["losses"], rtol=LOSS_RTOL)
    want_params = _flat(want["params"])
    assert set(got_params) == set(want_params)
    for k in want_params:
        np.testing.assert_allclose(got_params[k], want_params[k],
                                   err_msg=k, **tol)


TRAIN = [c["name"] for c in CASES if c["kind"] != "forward"]


@pytest.mark.parametrize("name", TRAIN)
def test_ranks_match_tpudist(name, rank_results):
    case = BY_NAME[name]
    want = jax_case(name)
    losses = [r[name]["losses"] for r in rank_results]
    assert all(ls == losses[0] for ls in losses), losses
    _hold(case, losses[0], _assemble(case, rank_results), want)
    if want["bubble"] is not None:
        assert rank_results[0][name]["bubble"] == pytest.approx(
            want["bubble"], abs=0)


@pytest.mark.parametrize("name", TRAIN)
def test_local_stages_match_tpudist(name):
    """All P stages in this one process, the whole batch."""
    case = BY_NAME[name]
    params, x, y = _inputs(case)
    got = run_port_case(case, None, x, y, params)
    _hold(case, got["losses"], _flat(got["params"]), jax_case(name))


def test_forward_matches_tpudist(rank_results):
    want = jax_case("forward_2x2")["out"]
    for r, res in enumerate(rank_results):
        half = want[(r // 2) * 8:(r // 2 + 1) * 8]
        np.testing.assert_allclose(res["forward_2x2"]["out"], half,
                                   rtol=1e-5, atol=1e-6)
    case = BY_NAME["forward_2x2"]
    params, x, y = _inputs(case)
    got = run_port_case(case, None, x, y, params)["out"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key,match", [
    ("stages", "3 stage fns but mesh stage=2"),
    ("batch", "not divisible by 2 micro-batches"),
    ("integer", "cannot round-trip"),
])
def test_errors(rank_results, key, match):
    for res in rank_results:
        assert match in res["errors"][key]


def test_local_stage_count_and_mesh_errors():
    from tpudist_torch.ops.losses import mse_loss
    from tpudist_torch.parallel import pipeline as pl

    with pytest.raises(ValueError, match="3 stage fns but mesh stage=2"):
        pl.make_pipeline_train_step([_dense] * 3, mse_loss, None, 2,
                                    local_stages=2)
    with pytest.raises(ValueError, match="local_stages=P"):
        pl.make_pipeline_train_step([_dense] * 2, mse_loss, None, 2)


@pytest.mark.parametrize("name", list(THREE_D))
def test_three_d_matches_sequential_training(name, rank_results):
    """DP × PP × TP (data 1 × stage 2 × model 2): the stacked pipeline of
    Megatron MLP blocks trains like tpudist's sequential full-weight
    model (its TestThreeDParallel, whose limits these are: the loss
    within rtol 1e-5, parameters within atol 1e-5); with a scale
    replicated over the model axis between f and g, its partial
    gradients summed over ``grad_sync_axes``."""
    import jax
    import jax.numpy as jnp

    params, x, y = _three_d_inputs(*THREE_D[name])

    def full_block(p, a):
        if "scale" in p:
            a = a * p["scale"]
        return jnp.tanh(a @ p["up"]) @ p["down"]

    def seq_loss(p):
        h = jnp.asarray(x)
        for c in range(2):
            h = full_block(jax.tree.map(lambda t: t[c], p), h)
        return jnp.mean((h - jnp.asarray(y)) ** 2)

    loss, grads = jax.value_and_grad(seq_loss)(
        jax.tree.map(jnp.asarray, params))
    want = {k: params[k] - 0.1 * np.asarray(grads[k]) for k in params}
    for res in rank_results:
        got = res[name]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k], v, atol=1e-5,
                                       err_msg=k)


def test_three_d_spec_errors(rank_results):
    """tpudist's refusals: extra mesh axes need an explicit
    grad_sync_axes; a spec must shard the leading dim over the stage
    axis."""
    for res in rank_results:
        errors = res["three_d"]["errors"]
        assert "pass grad_sync_axes explicitly" in errors["sync"]
        assert "leading (stage) dim" in errors["stage"]


def test_specs_and_shards():
    """The port's statement of what a stage-sharded step slices, and the
    optimizer state it mirrors."""
    from tpudist_torch.parallel import pipeline as pl
    from tpudist_torch.train import TrainState, adam

    tree = {"w": np.zeros((4, 3, 3), np.float32),
            "extra": {"b": np.zeros(3, np.float32)}}
    specs = pl.stacked_state_specs(tree, 4)
    assert specs == {"w": ("stage",), "extra/b": ()}
    assert pl.stacked_state_specs(tree, 4, overrides={"w": ()})["w"] == ()
    state = TrainState.create(pl.ParamTree(tree, device="cpu"), adam(1e-3))
    tree_p = state.model.tree()
    (tree_p["w"].sum() + tree_p["extra"]["b"].sum()).backward()
    state.apply_gradients()
    full = pl.state_specs_like(state, specs)
    assert full["opt_state"][0] == {"step": (), "exp_avg": ("stage",),
                                    "exp_avg_sq": ("stage",)}
    assert full["opt_state"][1] == {"step": (), "exp_avg": (),
                                    "exp_avg_sq": ()}


@pytest.mark.cuda
def test_cuda_tensors_on_gloo_raise(tmp_path):
    """One card, a gloo group of one: a pipeline step handed CUDA tensors
    raises before any work (gloo has no CUDA send/recv)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = run_ranks(_gloo_cuda_rank, 1, tmp_path)
    assert "need an NCCL group" in res[0]


def _gloo_cuda_rank(rank, world):
    from tpudist_torch.ops.losses import mse_loss
    from tpudist_torch.parallel import pipeline as pl
    from tpudist_torch.runtime.mesh import pipeline_mesh
    from tpudist_torch.train import TrainState, sgd

    mesh = pipeline_mesh(1)
    model = pl.ParamTree(({"w": torch.zeros(4, 4), "b": torch.zeros(4)},),
                         device="cuda")
    state = TrainState.create(model, sgd(0.1))
    step = pl.make_pipeline_train_step([_dense], mse_loss, mesh, 2)
    try:
        step(state, torch.zeros(4, 4, device="cuda"),
             torch.zeros(4, 4, device="cuda"))
    except ValueError as e:
        return str(e)
    return "did not raise"


# ---- ResNet50 stages --------------------------------------------------------

def test_resnet_stages_pipeline_matches_one_model():
    """resnet50_stages(2) from one flax-layout tree through
    from_flax_resnet_stages, as GPipe (2 local stages, 2 micro-batches)
    and packed, against the whole ResNet50 step on the same weights:
    f32, 32 px, 10 classes, SGD, MSE on one-hot labels."""
    import jax

    from tpudist.models import resnet50_stages as jax_stages
    from tpudist_torch.models import ResNet50, resnet50_stages
    from tpudist_torch.models.convert import (
        from_flax_resnet_params,
        from_flax_resnet_stages,
    )
    from tpudist_torch.ops.losses import mse_loss
    from tpudist_torch.parallel import pipeline as pl
    from tpudist_torch.train import TrainState, sgd

    segs = jax_stages(2, num_classes=10)
    shapes = [(1, 32, 32, 3), (1, 4, 4, 512)]
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        # tpudist's layout (names, shapes) with seeded numpy values
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(
            np.float32)

    trees = [jax.tree_util.tree_map_with_path(fill, jax.eval_shape(
        seg.init, jax.random.key(s),
        np.zeros(shapes[s], np.float32))["params"])
        for s, seg in enumerate(segs)]
    sds = from_flax_resnet_stages(trees)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(
        np.float32))
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[rng.integers(0, 10,
                                                                   4)])
    kw = dict(num_classes=10, compute_dtype=torch.float32, device="cpu")

    whole = ResNet50(**kw)
    merged = dict(sds[0])
    n0 = len(resnet50_stages(2, **kw)[0].blocks)
    for k, v in sds[1].items():
        if k.startswith("blocks."):
            i, rest = k[len("blocks."):].split(".", 1)
            merged[f"blocks.{int(i) + n0}.{rest}"] = v
        else:
            merged[k] = v
    whole.load_state_dict(merged)
    loss = mse_loss(whole(x), y)
    loss.backward()
    ref = {n: p.grad for n, p in whole.named_parameters()}

    stages = torch.nn.ModuleList(resnet50_stages(2, **kw))
    for st, sd in zip(stages, sds):
        st.load_state_dict(sd)
    state = TrainState.create(stages, sgd(0.1))
    step = pl.make_pipeline_train_step([lambda m, a: m(a)] * 2, mse_loss,
                                       None, 2, local_stages=2)
    state, metrics = step(state, x, y)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=1e-5)
    got = {}
    for s, st in enumerate(stages):
        for n, p in st.named_parameters():
            if n.startswith("blocks."):
                i, rest = n[len("blocks."):].split(".", 1)
                n = f"blocks.{int(i) + n0 * s}.{rest}"
            got[n] = p.grad
    for n, g in ref.items():
        np.testing.assert_allclose(got[n].numpy(), g.numpy(), rtol=1e-3,
                                   atol=1e-6, err_msg=n)

    templates = resnet50_stages(2, num_classes=10,
                                compute_dtype=torch.float32, device="meta")
    fns = [lambda p, a, m=m: torch.func.functional_call(m, p, (a,))
           for m in templates]
    flat, meta = pl.pack_stage_params(sds)
    pstate = TrainState.create(pl.ParamTree(flat, device="cpu"), sgd(0.1))
    pstep = pl.make_packed_pipeline_train_step(fns, mse_loss, None, 2, meta,
                                               pstate, local_stages=2)
    pstate, pm = pstep(pstate, x, y)
    np.testing.assert_allclose(float(pm["loss"]), float(loss), rtol=1e-5)
    grads = pl.unpack_stage_params(pstate.model.tree().grad, meta)
    for s, st in enumerate(stages):
        for n, p in st.named_parameters():
            np.testing.assert_allclose(grads[s][n].numpy(),
                                       p.grad.numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=n)
    assert from_flax_resnet_params(trees[0]).keys() == sds[0].keys()


# ---- the example twin -------------------------------------------------------

def test_model_parallel_resnet50_twin():
    """examples/model_parallel_resnet50_gpu.py under torchrun, 2 gloo
    processes (data 1 × stage 2), tiny images, GPipe and packed."""
    for extra in ([], ["--packed"]):
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2",
             os.path.join(REPO, "examples", "model_parallel_resnet50_gpu.py"),
             "--device", "cpu", "--image-size", "32", "--batch-size", "4",
             "--num-splits", "2", "--num-batches", "1", "--num-classes",
             "10", *extra],
            capture_output=True, text=True, timeout=300, cwd=REPO,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        assert "number of splits = 2, execution time =" in proc.stdout


@pytest.mark.parametrize("P,V", [(2, 1), (2, 2), (1, 2), (4, 1)])
def test_stack_block_params_round_trip(P, V):
    """The 1F1B real-model layout: chunk v·P + p at position p·V + v,
    k = layers / (P·V) blocks a chunk, and back by name."""
    from tpudist_torch.models import (
        TransformerConfig,
        TransformerLM,
        stack_block_params,
        unstack_block_params,
    )

    cfg = TransformerConfig(num_layers=4, **LM)
    sd = TransformerLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    tree = stack_block_params(sd, 4, P, V)
    k = 4 // (P * V)
    assert tree["stages"]["ln1.scale"].shape[:2] == (P * V, k)
    for p in range(P):
        for v in range(V):
            c = v * P + p
            torch.testing.assert_close(
                tree["stages"]["attn.qkv.weight"][p * V + v, 0],
                sd[f"blocks.{c * k}.attn.qkv.weight"], rtol=0, atol=0)
    back = unstack_block_params(tree, P, V)
    assert set(back) == set(sd)
    for name, t in sd.items():
        torch.testing.assert_close(back[name], t, rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not cut"):
        stack_block_params(sd, 4, 3, 1)
