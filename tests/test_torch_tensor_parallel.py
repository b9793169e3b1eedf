"""tpudist_torch's tensor parallelism against tpudist's.

The port's Megatron ``TransformerLM`` (``tp_axis="model"``) trains two SGD
steps through ``make_tp_state`` and ``make_spmd_train_step`` in 4 gloo
ranks spawned once for the module (``run_ranks``), on meshes of data 1 ×
model 2, data 2 × model 2 and data 2 × model 1 (a leading ``rep`` axis
of 2 fills the 4 ranks where the mesh needs 2: each replica runs the same
steps), plus a GQA model with flash attention (the plain versions of K1,
K3 and K4 on the CPU; tpudist's side runs its plain attention, the same
math) at data 1 × model 2.  tpudist runs its
``make_tp_state``/``make_spmd_train_step`` (GSPMD) on the same mesh shapes
of conftest's virtual CPU devices, from the same flax weights and batch.
Each rank gathers its blocks back whole (``gather_tree``), and the parent
compares them by name.

Tolerances are tpudist's own test's (``test_tp_matches_single_device``):
the loss within atol 1e-4, parameters within atol 2e-4 + rtol 2e-3.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_data_parallel import run_ranks

LOSS_ATOL = 1e-4
PARAM_TOL = dict(atol=2e-4, rtol=2e-3)
BASE = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
            max_seq_len=16)
CASES = [
    dict(name="data1_model2", axes={"rep": 2, "data": 1, "model": 2}),
    dict(name="data2_model2", axes={"data": 2, "model": 2}),
    dict(name="data2_model1", axes={"rep": 2, "data": 2, "model": 1}),
    dict(name="gqa_flash_data1_model2", axes={"rep": 2, "data": 1,
                                              "model": 2},
         kv_heads=2, flash=True),
]
BY_NAME = {c["name"]: c for c in CASES}
STEPS, LR = 2, 0.1


def _cfg(case, torch_side=True):
    if torch_side:
        from tpudist_torch.models.transformer import TransformerConfig
    else:
        from tpudist.models import TransformerConfig
    return TransformerConfig(num_kv_heads=case.get("kv_heads"), **BASE)


_FLAX: dict = {}


def _flax(case):
    """tpudist's model, its weights and the batch (numpy seed 0)."""
    key = case.get("kv_heads")
    if key not in _FLAX:
        import jax
        import jax.numpy as jnp

        from tpudist.models import TransformerLM

        model = TransformerLM(_cfg(case, False))
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, BASE["vocab_size"], (8, 16)).astype(
            np.int32)
        params = model.init(jax.random.key(0), jnp.asarray(tokens))[
            "params"]
        _FLAX[key] = (model, jax.tree.map(np.asarray, params), tokens)
    return _FLAX[key]


def _port_sd(case):
    from tpudist_torch.models.convert import from_flax_params

    _, params, _ = _flax(case)
    return {k: v.numpy() for k, v in from_flax_params(params,
                                                       _cfg(case)).items()}


def _loss_fn(model, batch, _gen):
    from tpudist_torch.ops.losses import cross_entropy

    tokens, targets = batch
    logits = model(tokens)
    return cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1)), {}


def _tp_rank(rank, world, payload):
    from tpudist_torch.models.transformer import TransformerLM
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.parallel import (
        gather_tree,
        make_spmd_train_step,
        make_tp_state,
        shard_batch,
    )
    from tpudist_torch.parallel.common import CALLS, reset_calls
    from tpudist_torch.runtime.mesh import make_mesh
    from tpudist_torch.train import sgd
    from tpudist_torch.utils.trees import tree_to_numpy

    out = {}
    for case, sd, tokens in payload:
        mesh = make_mesh(case["axes"])
        attn = {"attention_fn": flash_attention_fn()} if case.get(
            "flash") else {}
        model = TransformerLM(_cfg(case), tp_axis="model", mesh=mesh,
                              device="cpu", **attn)
        state, specs = make_tp_state(model, sd, sgd(LR), mesh)
        shapes = {k: tuple(p.shape) for k, p in
                  state.model.named_parameters()}
        step = make_spmd_train_step(_loss_fn, mesh, specs)
        tok = torch.from_numpy(tokens).long()
        batch = shard_batch((tok, torch.roll(tok, -1, 1)), mesh, "data")
        losses = []
        reset_calls()
        for _ in range(STEPS):
            state, metrics = step(state, *batch)
            losses.append(float(metrics["loss"]))
        calls = dict(CALLS)
        full = gather_tree(dict(state.model.named_parameters()), mesh,
                           specs)
        out[case["name"]] = {"losses": losses, "calls": calls,
                             "shapes": shapes,
                             "params": tree_to_numpy(full)}
    return out


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    payload = [(c, _port_sd(c), _flax(c)[2]) for c in CASES]
    return run_ranks(_tp_rank, 4, tmp_path_factory.mktemp("tp"), payload)


_JAX: dict = {}


def jax_case(name):
    """tpudist's two TP steps on the case's mesh shape: losses and the
    parameters in the port's names."""
    if name in _JAX:
        return _JAX[name]
    import jax
    import jax.numpy as jnp
    import optax

    from tpudist.ops.losses import cross_entropy
    from tpudist.parallel.tensor_parallel import (
        make_spmd_train_step,
        make_tp_state,
        shard_batch,
    )
    from tpudist.runtime.mesh import make_mesh
    from tpudist_torch.models.convert import from_flax_params

    case = BY_NAME[name]
    model, params, tokens = _flax(case)
    axes = {k: v for k, v in case["axes"].items() if k != "rep"}
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, jax.devices()[:n])

    def loss_fn(p, batch, rng):
        toks, tgts = batch
        logits = model.apply({"params": p}, toks)
        return cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             tgts.reshape(-1)), {}

    state, specs = make_tp_state(model.apply, params, optax.sgd(LR), mesh)
    step = make_spmd_train_step(loss_fn, mesh, specs, donate=False)
    tok = jnp.asarray(tokens)
    batch = shard_batch((tok, jnp.roll(tok, -1, axis=1)), mesh)
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, *batch)
        losses.append(float(metrics["loss"]))
    got = {k: v.numpy() for k, v in from_flax_params(
        jax.tree.map(np.asarray, state.params), _cfg(case)).items()}
    _JAX[name] = {"losses": losses, "params": got}
    return _JAX[name]


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_tp_matches_tpudist(name, rank_results):
    want = jax_case(name)
    for r, res in enumerate(rank_results):
        got = res[name]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   atol=LOSS_ATOL, rtol=0)
        assert set(got["params"]) == set(want["params"])
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, **PARAM_TOL,
                                       err_msg=f"rank {r} {k}")


def test_tp_shards_and_collectives(rank_results):
    """Each rank holds its block (whole heads, its vocabulary block), and
    a step's collectives are the Megatron pair's all-reduces and the
    logits' all-gather, never a reduce-scatter or an all-to-all."""
    got = rank_results[0]["data2_model2"]
    assert got["shapes"]["blocks.0.attn.qkv.weight"] == (48, 32)
    assert got["shapes"]["blocks.0.attn.proj.weight"] == (32, 16)
    assert got["shapes"]["tok_embed.weight"] == (32, 32)
    assert got["shapes"]["lm_head.weight"] == (32, 32)
    assert got["shapes"]["blocks.0.ln1.scale"] == (32,)
    calls = got["calls"]
    assert calls.get("reduce_scatter", 0) == 0
    assert calls.get("all_to_all", 0) == 0
    # per step: the embedding's g, each block's two g's and two f's, the
    # head's f (backward) and its logits' join
    layers = BASE["num_layers"]
    assert calls["all_gather"] == STEPS
    assert calls["all_reduce"] == STEPS * (1 + 4 * layers + 1)
    gqa = rank_results[0]["gqa_flash_data1_model2"]["shapes"]
    assert gqa["blocks.0.attn.q.weight"] == (16, 32)
    assert gqa["blocks.0.attn.kv.weight"] == (16, 32)


def test_spec_rules_cover_transformer():
    """The port's rules are tpudist's layout in torch's weight order:
    tpudist's ``P(None, "model")`` on a flax kernel is ``("model", None)``
    on the ``[out, in]`` weight."""
    import jax
    from jax.sharding import PartitionSpec as P

    from tpudist.parallel.tensor_parallel import (
        spec_tree_from_rules as jax_specs,
        transformer_tp_rules as jax_rules,
    )
    from tpudist_torch.models.transformer import TransformerLM
    from tpudist_torch.parallel import (
        spec_tree_from_rules,
        transformer_tp_rules,
    )

    for case in (CASES[0], CASES[-1]):
        _, params, _ = _flax(case)
        want = jax_specs(params, jax_rules())
        flat = {"/".join(str(k.key) for k in path): spec for path, spec in
                jax.tree_util.tree_leaves_with_path(
                    want, is_leaf=lambda x: isinstance(x, P))}
        got = spec_tree_from_rules(
            TransformerLM(_cfg(case), device="cpu"), transformer_tp_rules())
        names = {"tok_embed.weight": "tok_embed/embedding",
                 "pos_embed.weight": "pos_embed/embedding",
                 "lm_head.weight": "lm_head/kernel",
                 "ln_f.scale": "ln_f/scale"}
        for i in range(BASE["num_layers"]):
            for mod in (("attn", "qkv"), ("attn", "q"), ("attn", "kv"),
                        ("attn", "proj"), ("mlp", "up"), ("mlp", "down")):
                names[f"blocks.{i}.{mod[0]}.{mod[1]}.weight"] = \
                    f"block{i}/{mod[0]}/{mod[1]}/kernel"
        for port, flax_name in names.items():
            if port not in got:
                continue
            spec = tuple(flat[flax_name])
            if flax_name.endswith("kernel"):
                spec = tuple(reversed(spec + (None,) * (2 - len(spec))))
                spec = () if spec == (None, None) else spec
            assert got[port] == spec, (port, got[port], spec)


def test_tp_rules_cover_gqa_projections():
    from tpudist_torch.models.transformer import TransformerLM
    from tpudist_torch.parallel import (
        spec_tree_from_rules,
        transformer_tp_rules,
    )

    specs = spec_tree_from_rules(
        TransformerLM(_cfg(CASES[-1]), device="cpu"), transformer_tp_rules())
    assert specs["blocks.0.attn.q.weight"] == ("model", None)
    assert specs["blocks.0.attn.kv.weight"] == ("model", None)
    assert specs["blocks.0.attn.kv.weight"][0].parts == 2
    assert specs["blocks.0.attn.proj.weight"] == (None, "model")


@pytest.mark.parametrize("kv_heads,tp", [(None, 2), (None, 4), (2, 2)])
def test_converter_round_trip(kv_heads, tp):
    """``from_flax_tp_params`` cuts whole heads of each of q, k and v and
    ``gather_tp_params`` joins the shards back bit for bit."""
    from tpudist_torch.models.convert import (
        from_flax_params,
        from_flax_tp_params,
        gather_tp_params,
    )

    case = {"kv_heads": kv_heads}
    cfg = _cfg(case)
    _, params, _ = _flax(case)
    shards = [from_flax_tp_params(params, cfg, r, tp) for r in range(tp)]
    whole = from_flax_params(params, cfg)
    back = gather_tp_params(shards, cfg)
    assert set(back) == set(whole)
    for k, v in whole.items():
        assert torch.equal(back[k], v), k
    d = cfg.head_dim
    h = cfg.num_heads // tp
    if kv_heads is None:
        q, k, v = whole["blocks.0.attn.qkv.weight"].view(3, cfg.num_heads,
                                                         d, -1)
        got = shards[1]["blocks.0.attn.qkv.weight"].view(3, h, d, -1)
        assert torch.equal(got[0], q[h:2 * h])
        assert torch.equal(got[2], v[h:2 * h])


def test_gqa_heads_must_divide():
    from tpudist_torch.models.transformer import TensorParallel

    tp = TensorParallel()
    tp.axis, tp.size = "tp", 4
    with pytest.raises(ValueError, match="kv_heads 2 not divisible by "
                                         "'tp' size 4"):
        tp.check(2, "kv_heads")


def test_example_tp2_under_torchrun(capsys):
    """``examples/long_context_lm_gpu.py --tp 2`` on two CPU processes
    under ``torch.distributed.run`` trains like the one-process run (its
    printed losses within the loss tolerance above) and, with
    ``--generate``, decodes the gathered parameters on one process, saying
    so, to the one-process run's tokens."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    script = str(root / "examples" / "long_context_lm_gpu.py")
    args = ["--device", "cpu", "--layers", "1", "--embed-dim", "32",
            "--heads", "4", "--kv-heads", "2", "--seq-len", "32",
            "--batch-size", "2", "--steps", "2", "--log-every", "1",
            "--generate", "4"]
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", script, "--tp", "2", *args],
        capture_output=True, text=True, cwd=root, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    sys.path.insert(0, str(root / "examples"))
    try:
        import long_context_lm_gpu
    finally:
        sys.path.pop(0)
    long_context_lm_gpu.main(args)
    runs = [res.stdout, capsys.readouterr().out]
    losses = [[float(line.split("loss")[1]) for line in out.splitlines()
               if line.startswith("step ")] for out in runs]
    assert len(losses[0]) == 2
    np.testing.assert_allclose(losses[0], losses[1], atol=LOSS_ATOL, rtol=0)
    assert "dp1×tp2 (flash)" in runs[0]
    assert "tp_generate waits for ROADMAP A9" in runs[0]
    sample = [out.split("sample:")[1].strip() for out in runs]
    assert sample[0] == sample[1]
