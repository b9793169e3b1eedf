"""tpudist_torch's FSDP / ZeRO-3 against tpudist's.

``fsdp_specs`` is held leaf by leaf to tpudist's on the same trees (its
MLP over an 8-way data axis, its transformer over fsdp 4 × model 2 with
the Megatron rules claiming first): the port's spec of an ``nn.Linear``
weight is tpudist's kernel spec transposed.  ``make_zero3_train_step``
runs one Adam step in 4 gloo ranks spawned once for the module
(``run_ranks``) and is held against tpudist's ``make_zero3_train_step``
on 4 of conftest's virtual CPU devices from the same weights and batch;
each rank's parameter blocks and Adam moments are shown to be a quarter
of their leaf, and the step's collectives an all-gather and a
reduce-scatter per sharded leaf.

Tolerances: the loss within rtol 1e-5 (tpudist's own ZeRO-3 test);
parameters after the Adam step by ``assert_params_close``
(``tests/test_torch_data_parallel.py``: every element within 1e-4 and
all but one in 10,000 within 3e-6, as Adam moves an element whose
gradient is near zero by up to lr on a difference in that gradient's
last bits).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_data_parallel import assert_params_close, run_ranks

LOSS_RTOL = 1e-5
N = 4
LR = 1e-3


def _mlp_setup():
    """tpudist's ``tests/test_fsdp.py`` MLP and batch."""
    import jax

    from tpudist.models import MLP

    model = MLP(hidden_layers=2, features=64)
    x = np.random.default_rng(0).standard_normal((32, 784)).astype(
        np.float32)
    y = np.random.default_rng(1).integers(0, 10, (32,))
    params = model.init(jax.random.key(0), x[:1])["params"]
    return model, jax.tree.map(np.asarray, params), x, y


def _flat_specs(specs):
    import jax
    from jax.sharding import PartitionSpec as P

    return {"/".join(str(k.key) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda s: isinstance(s, P))}


def _torch_spec(flax_spec, ndim, kernel):
    spec = tuple(flax_spec) + (None,) * (ndim - len(flax_spec))
    if kernel:
        spec = tuple(reversed(spec))
    return () if all(s is None for s in spec) else spec


def test_fsdp_specs_match_tpudist_mlp():
    from tpudist.parallel.fsdp import fsdp_specs as jax_fsdp_specs
    from tpudist.runtime.mesh import data_mesh
    from tpudist_torch.models import MLP
    from tpudist_torch.parallel import fsdp_specs

    _, params, _, _ = _mlp_setup()
    want = _flat_specs(jax_fsdp_specs(params, data_mesh(8)))
    got = fsdp_specs(MLP(2, 64, device="cpu"), {"data": 8})
    for name, spec in want.items():
        layer, leaf = name.split("/")
        port = f"dense.{layer.split('_')[1]}." + (
            "weight" if leaf == "kernel" else "bias")
        ndim = 2 if leaf == "kernel" else 1
        assert got[port] == _torch_spec(spec, ndim, leaf == "kernel"), (
            port, got[port], spec)


def test_fsdp_specs_compose_with_tp_rules():
    """tpudist's ``test_fsdp_composes_with_tp_rules`` layout: fsdp 4 ×
    model 2 on a one-layer transformer; every leaf's spec is tpudist's."""
    import jax
    import jax.numpy as jnp

    from tpudist.models import TransformerConfig as JCfg
    from tpudist.models import TransformerLM as JLM
    from tpudist.parallel.fsdp import fsdp_specs as jax_fsdp_specs
    from tpudist.parallel.tensor_parallel import (
        transformer_tp_rules as jax_rules,
    )
    from tpudist.runtime.mesh import data_model_mesh
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.parallel import fsdp_specs, transformer_tp_rules

    dims = dict(vocab_size=64, num_layers=1, num_heads=2, embed_dim=32,
                max_seq_len=16)
    params = JLM(JCfg(**dims)).init(jax.random.key(0),
                                    jnp.zeros((4, 16), jnp.int32))["params"]
    want = _flat_specs(jax_fsdp_specs(params, data_model_mesh(model=2, n=8),
                                      axis="data",
                                      tp_rules=jax_rules("model")))
    assert "model" in want["block0/attn/qkv/kernel"]
    assert "data" in want["block0/attn/qkv/kernel"]
    got = fsdp_specs(TransformerLM(TransformerConfig(**dims), device="cpu"),
                     {"data": 4}, axis="data",
                     tp_rules=transformer_tp_rules("model"))
    names = {"tok_embed.weight": "tok_embed/embedding",
             "pos_embed.weight": "pos_embed/embedding",
             "lm_head.weight": "lm_head/kernel",
             "ln_f.scale": "ln_f/scale", "ln_f.bias": "ln_f/bias"}
    for mod in ("attn/qkv", "attn/proj", "mlp/up", "mlp/down"):
        names["blocks.0." + mod.replace("/", ".") + ".weight"] = \
            f"block0/{mod}/kernel"
    for ln in ("ln1", "ln2"):
        for leaf in ("scale", "bias"):
            names[f"blocks.0.{ln}.{leaf}"] = f"block0/{ln}/{leaf}"
    assert set(names) == set(got)
    for port, flax_name in names.items():
        kernel = flax_name.endswith("kernel")
        ndim = 1 if flax_name.endswith(("scale", "bias")) else 2
        assert got[port] == _torch_spec(want[flax_name], ndim, kernel), (
            port, got[port], want[flax_name])


def _zero3_rank(rank, world, sd, x, y):
    from tpudist_torch.models import MLP
    from tpudist_torch.ops.losses import cross_entropy
    from tpudist_torch.parallel import (
        gather_tree,
        make_fsdp_state,
        make_zero3_train_step,
        shard_batch,
    )
    from tpudist_torch.parallel.common import CALLS, reset_calls
    from tpudist_torch.runtime.mesh import data_mesh
    from tpudist_torch.train import adam

    mesh = data_mesh(world)
    state, specs = make_fsdp_state(MLP(2, 64, device="cpu"), sd, adam(LR),
                                   mesh)

    def loss_fn(model, batch, _gen):
        bx, by = batch
        return cross_entropy(model(bx), by), {}

    step = make_zero3_train_step(loss_fn, mesh, specs, state)
    batch = shard_batch((torch.from_numpy(x), torch.from_numpy(y)), mesh)
    reset_calls()
    state, metrics = step(state, *batch)
    calls = dict(CALLS)
    named = dict(state.model.named_parameters())
    opt = state.optimizer.state
    shards = {k: {"param": tuple(p.shape),
                  "exp_avg": tuple(opt[p]["exp_avg"].shape),
                  "exp_avg_sq": tuple(opt[p]["exp_avg_sq"].shape)}
              for k, p in named.items()}
    full = gather_tree(named, mesh, specs)
    return {"loss": float(metrics["loss"]), "calls": calls,
            "shards": shards, "specs": {k: tuple(v) for k, v in
                                        specs.items()},
            "params": {k: v.numpy() for k, v in full.items()}}


@pytest.fixture(scope="module")
def zero3_results(tmp_path_factory):
    from tpudist_torch.models.convert import from_flax_mlp_params

    _, params, x, y = _mlp_setup()
    sd = {k: v.numpy() for k, v in from_flax_mlp_params(params).items()}
    return run_ranks(_zero3_rank, N, tmp_path_factory.mktemp("zero3"), sd,
                     x, y)


def test_zero3_matches_tpudist(zero3_results):
    import jax
    import jax.numpy as jnp
    import optax

    from tpudist.ops.losses import cross_entropy
    from tpudist.parallel.fsdp import make_fsdp_state, make_zero3_train_step
    from tpudist.runtime.mesh import make_mesh
    from tpudist_torch.models.convert import from_flax_mlp_params

    model, params, x, y = _mlp_setup()
    mesh = make_mesh({"data": N}, jax.devices()[:N])

    def loss_fn(p, batch, rng):
        bx, by = batch
        return cross_entropy(model.apply({"params": p}, bx), by), {}

    state, specs = make_fsdp_state(model.apply, params, optax.adam(LR),
                                   mesh)
    step = make_zero3_train_step(loss_fn, mesh, specs, state, donate=False)
    state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
    want = {k: v.numpy() for k, v in from_flax_mlp_params(
        jax.tree.map(np.asarray, state.params)).items()}
    for res in zero3_results:
        np.testing.assert_allclose(res["loss"], float(metrics["loss"]),
                                   rtol=LOSS_RTOL)
        assert_params_close(res["params"], want)


def test_zero3_shards_params_and_moments(zero3_results):
    """Each rank's parameter blocks and Adam moments are 1/4 of their
    leaf, on the dimension ``fsdp_specs`` names; the ranks' blocks
    differ (each holds its own)."""
    from tpudist_torch.models import MLP

    whole = {k: tuple(p.shape) for k, p in
             MLP(2, 64, device="cpu").named_parameters()}
    res = zero3_results[0]
    for name, shape in whole.items():
        spec = res["specs"][name]
        want = tuple(s // N if i < len(spec) and spec[i] == "data" else s
                     for i, s in enumerate(shape))
        got = res["shards"][name]
        assert got["param"] == got["exp_avg"] == got["exp_avg_sq"] == want
    # the input layer's kernel [784, 64]: 784 sharded (torch dim 1)
    assert res["shards"]["dense.0.weight"]["param"] == (64, 784 // N)
    sharded = sum(1 for s in res["specs"].values() if "data" in s)
    calls = res["calls"]
    assert calls["all_gather"] == sharded
    assert calls["reduce_scatter"] == sharded
    assert calls.get("all_to_all", 0) == 0


def test_fsdp_train_step_is_zero3_schedule():
    """tpudist's ``make_fsdp_train_step`` (the GSPMD program) and the
    explicit ZeRO-3 step are one schedule here: the same step over the
    batch axis."""
    from tpudist_torch.parallel import make_fsdp_train_step

    step = make_fsdp_train_step(lambda *a: None, _FakeMesh(),
                                {"w": ("data", None), "b": ()})
    assert step.batch_axes == ("data",)
    assert step.param_specs == {"w": ("data", None), "b": ()}


class _FakeMesh:
    """Enough of a mesh for a step's construction (sizes only)."""

    mesh_dim_names = ("data",)

    def size(self, dim):
        return 4

    def get_local_rank(self, axis):
        return 0
