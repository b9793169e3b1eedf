"""tpudist_torch's composed MeshSpec step against tpudist's.

In 4 gloo ranks spawned once for the module (``run_ranks``), on
tpudist's ``mesh_bench`` model (vocab 32, 1 layer, 2 heads, embed 16, 8
sequences of 8 tokens, SGD 0.1):

* ``dp2_tp2`` and ``fsdp2_tp2``: two steps of ``make_composed_train_step``
  on a state from ``make_composed_state`` against tpudist's composed
  (GSPMD) step on the same spec over 4 of conftest's virtual CPU devices;
* ``grow_shrink``: one step under ``MeshSpec(dp=4)`` (the data-parallel
  step), the weights gathered, then one step under ``dp=2, tp=2`` from
  them, against two single-device steps of tpudist's (its
  ``test_meshspec_grow_shrink_recompile``);
* the refusals of a pipeline with fsdp or ep and of a mesh that is not
  the spec's, and the step's gauges;
* ``dp2_fsdp2_tp2`` in 8 ranks of its own, marked slow (as tpudist's
  composition matrix is).

Tolerances: tpudist's tensor-parallel test's (the loss within atol 1e-4,
parameters within atol 2e-4 + rtol 2e-3); tpudist's matrix asserts
bitwise equality between two GSPMD programs, which two frameworks do not
give.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_data_parallel import run_ranks

LOSS_ATOL = 1e-4
PARAM_TOL = dict(atol=2e-4, rtol=2e-3)
LM = dict(vocab_size=32, num_layers=1, num_heads=2, embed_dim=16,
          max_seq_len=8)
CASES = {"dp2_tp2": dict(dp=2, tp=2), "fsdp2_tp2": dict(fsdp=2, tp=2)}
STEPS = 2


def _setup():
    """tpudist's ``mesh_bench._lm_setup``: model, flax weights, batch."""
    from tpudist.parallel import mesh_bench

    cfg, model, params, loss_fn, (tokens, targets) = mesh_bench._lm_setup()
    import jax

    return (model, jax.tree.map(np.asarray, params), loss_fn,
            np.asarray(tokens), np.asarray(targets))


def _port_sd():
    from tpudist_torch.models.convert import from_flax_params
    from tpudist_torch.models.transformer import TransformerConfig

    _, params, _, _, _ = _setup()
    return {k: v.numpy() for k, v in from_flax_params(
        params, TransformerConfig(**LM)).items()}


def _loss_fn(model, batch, _gen):
    from tpudist_torch.ops.losses import cross_entropy

    toks, tgts = batch
    logits = model(toks)
    return cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tgts.reshape(-1)), {}


def _composed(spec, sd, tokens, targets, steps, specs_from="state"):
    """``steps`` composed steps from the whole ``sd``: losses, the
    gathered parameters, the step.  The step's specs come from the state
    (``make_composed_state``'s), from the model (``params=``), or
    (``None``) from nothing: the data-parallel step."""
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.parallel import (
        gather_tree,
        make_composed_state,
        make_composed_train_step,
        shard_composed_batch,
    )
    from tpudist_torch.train import sgd

    mesh = spec.build()
    model = TransformerLM(TransformerConfig(**LM), device="cpu",
                          tp_axis="tp", mesh=mesh)
    state, specs = make_composed_state(model, sd, sgd(0.1), spec, mesh)
    how = {"state": {"param_specs": specs}, "model": {"params": state.model},
           None: {}}[specs_from]
    step = make_composed_train_step(spec, mesh, _loss_fn, **how)
    batch = shard_composed_batch((torch.from_numpy(tokens).long(),
                                  torch.from_numpy(targets).long()),
                                 mesh, spec)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, *batch)
        losses.append(float(metrics["loss"]))
    full = gather_tree(dict(state.model.named_parameters()), mesh, specs)
    shapes = {k: tuple(p.shape) for k, p in state.model.named_parameters()}
    return losses, {k: v.numpy() for k, v in full.items()}, step, shapes


def _compose_rank(rank, world, sd, tokens, targets):
    from tpudist_torch.parallel import MeshSpec, transformer_tp_rules
    from tpudist_torch.train import TrainState, sgd

    rules = tuple(transformer_tp_rules("tp"))
    out = {}
    for name, sizes in CASES.items():
        losses, params, step, shapes = _composed(
            MeshSpec(rules=rules, **sizes), sd, tokens, targets, STEPS,
            specs_from="model" if name == "dp2_tp2" else "state")
        out[name] = {"losses": losses, "params": params, "shapes": shapes,
                     "gauges": step.mesh_gauges,
                     "bubble": step.bubble_fraction}
    # grow / shrink: dp=4, then dp=2 x tp=2 from the updated weights
    la, pa, step_a, _ = _composed(MeshSpec(dp=4), sd, tokens, targets, 1,
                                  specs_from=None)
    lb, pb, _, _ = _composed(MeshSpec(dp=2, tp=2, rules=rules), pa, tokens,
                             targets, 1)
    out["grow_shrink"] = {"losses": la + lb, "params": pb,
                          "dp_param_specs": step_a.param_specs}
    # TrainState.create_sharded: make_composed_state's layout
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    spec = MeshSpec(fsdp=2, tp=2, rules=rules)
    model = TransformerLM(TransformerConfig(**LM), device="cpu",
                          tp_axis="tp", mesh=spec.build())
    state = TrainState.create_sharded(model, sgd(0.1), spec, params=sd)
    out["create_sharded"] = {k: tuple(p.shape) for k, p in
                             state.model.named_parameters()}
    errors = {}
    from tpudist_torch.parallel import make_composed_train_step

    spec = MeshSpec(fsdp=2, pp=2, num_microbatches=2)
    try:
        make_composed_train_step(
            spec, spec.build(), block_fn=lambda p, a: a,
            stage_loss_fn=lambda o, y: o.mean(),
            state_example=TrainState.create(torch.nn.Linear(2, 2), sgd(0.1)))
    except ValueError as e:
        errors["pp_fsdp"] = str(e)
    spec = MeshSpec(ep=2, pp=2, num_microbatches=2)
    try:
        make_composed_train_step(spec, spec.build(), block_fn=lambda p, a: a,
                                 state_example=object())
    except ValueError as e:
        errors["pp_ep"] = str(e)
    try:
        make_composed_train_step(MeshSpec(dp=2, tp=2),
                                 MeshSpec(dp=4).build(), _loss_fn)
    except ValueError as e:
        errors["mismatch"] = str(e)
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    _, _, _, tokens, targets = _setup()
    return run_ranks(_compose_rank, 4, tmp_path_factory.mktemp("compose"),
                     _port_sd(), tokens, targets)


def _jax_params(params):
    import jax

    from tpudist_torch.models.convert import from_flax_params
    from tpudist_torch.models.transformer import TransformerConfig

    return {k: v.numpy() for k, v in from_flax_params(
        jax.tree.map(np.asarray, params), TransformerConfig(**LM)).items()}


def jax_composed(sizes):
    import jax
    import optax

    from tpudist.parallel.mesh import (
        MeshSpec,
        make_composed_state,
        make_composed_train_step,
        shard_composed_batch,
    )
    from tpudist.parallel.tensor_parallel import transformer_tp_rules

    model, params, loss_fn, tokens, targets = _setup()
    spec = MeshSpec(rules=tuple(transformer_tp_rules("tp")), **sizes)
    mesh = spec.build(jax.devices()[:spec.n_devices])
    step = make_composed_train_step(spec, mesh, loss_fn, params=params,
                                    donate=False)
    state, _ = make_composed_state(model.apply, params, optax.sgd(0.1),
                                   spec, mesh)
    batch = shard_composed_batch((tokens, targets), mesh, spec)
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, *batch)
        losses.append(float(metrics["loss"]))
    return losses, _jax_params(state.params)


def _hold(got, want_losses, want_params):
    np.testing.assert_allclose(got["losses"], want_losses, atol=LOSS_ATOL,
                               rtol=0)
    assert set(got["params"]) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(got["params"][k], v, **PARAM_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_composed_matches_tpudist(name, rank_results):
    losses, params = jax_composed(CASES[name])
    for res in rank_results:
        _hold(res[name], losses, params)


def test_composed_layouts(rank_results):
    """dp2_tp2 holds the tp blocks; fsdp2_tp2 also halves the dimension
    fsdp takes (the qkv weight's input columns, tpudist's flax dim 0)."""
    res = rank_results[0]
    assert res["dp2_tp2"]["shapes"]["blocks.0.attn.qkv.weight"] == (24, 16)
    assert res["fsdp2_tp2"]["shapes"]["blocks.0.attn.qkv.weight"] == (24, 8)
    assert res["fsdp2_tp2"]["shapes"]["blocks.0.ln1.scale"] == (8,)
    gauges = res["dp2_tp2"]["gauges"]
    assert gauges["mesh/axis_size~axis=dp"] == 2.0
    assert gauges["mesh/axis_size~axis=tp"] == 2.0
    assert gauges["mesh/axis_size~axis=fsdp"] == 1.0
    assert gauges["train/bubble_fraction"] == res["dp2_tp2"]["bubble"] == 0.0


def test_create_sharded_is_composed_state(rank_results):
    for res in rank_results:
        assert res["create_sharded"] == res["fsdp2_tp2"]["shapes"]


def test_meshspec_grow_shrink(rank_results):
    """Step 1 under dp=4 and step 2 under dp=2 × tp=2 from its weights
    continue tpudist's single-device trajectory."""
    import jax
    import optax

    from tpudist.train.state import TrainState

    model, params, loss_fn, tokens, targets = _setup()
    state = TrainState.create(model.apply, params, optax.sgd(0.1))
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    losses = []
    for _ in range(2):
        (loss, _), grads = grad_fn(state.params, (tokens, targets),
                                   state.rng)
        losses.append(float(loss))
        state = state.apply_gradients(grads)
    for res in rank_results:
        assert res["grow_shrink"]["dp_param_specs"] is None
        _hold(res["grow_shrink"], losses, _jax_params(state.params))


@pytest.mark.parametrize("key,match", [
    ("pp_fsdp", "not supported"), ("pp_ep", "not supported"),
    ("mismatch", "build the mesh with")])
def test_composed_errors(rank_results, key, match):
    for res in rank_results:
        assert match in res["errors"][key]


class TestMeshSpecSurface:
    def test_parse_and_sizes(self):
        from tpudist_torch.parallel import MESH_AXES, MeshSpec

        assert MESH_AXES == ("dp", "fsdp", "ep", "pp", "tp")
        spec = MeshSpec.parse("dp=2, fsdp=2,tp=2")
        assert (spec.dp, spec.fsdp, spec.tp, spec.pp, spec.ep) == (
            2, 2, 2, 1, 1)
        assert spec.n_devices == 8
        assert spec.data_axes() == ("dp", "fsdp")
        assert spec.batch_spec() == (("dp", "fsdp"),)
        assert MeshSpec(pp=2, virtual_stages=2).n_stages == 4
        assert MeshSpec(pp=2).data_axes() == ("dp",)
        with pytest.raises(ValueError, match="unknown mesh axis"):
            MeshSpec.parse("dp=2,bogus=2")
        with pytest.raises(ValueError, match="must be >= 1"):
            MeshSpec(tp=0)

    def test_param_specs_match_tpudist(self):
        """``MeshSpec.param_specs`` is tpudist's (rules first, then fsdp)
        in torch's order."""
        import jax
        from jax.sharding import PartitionSpec as P

        from tpudist.parallel.mesh import MeshSpec as JSpec
        from tpudist.parallel.tensor_parallel import (
            transformer_tp_rules as jax_rules,
        )
        from tpudist_torch.models.transformer import (
            TransformerConfig,
            TransformerLM,
        )
        from tpudist_torch.parallel import MeshSpec, transformer_tp_rules

        _, params, _, _, _ = _setup()
        want = {"/".join(str(k.key) for k in path): tuple(s)
                for path, s in jax.tree_util.tree_leaves_with_path(
                    JSpec(fsdp=2, tp=2, rules=tuple(jax_rules("tp")))
                    .param_specs(params),
                    is_leaf=lambda x: isinstance(x, P))}
        got = MeshSpec(fsdp=2, tp=2, rules=tuple(transformer_tp_rules(
            "tp"))).param_specs(TransformerLM(TransformerConfig(**LM),
                                              device="cpu"))
        assert got["blocks.0.attn.qkv.weight"] == tuple(reversed(
            want["block0/attn/qkv/kernel"]))
        assert got["blocks.0.mlp.down.weight"] == tuple(reversed(
            want["block0/mlp/down/kernel"]))
        assert got["tok_embed.weight"] == want["tok_embed/embedding"]
        assert got["blocks.0.ln1.scale"] == want["block0/ln1/scale"]

    def test_build_needs_a_process_group(self):
        from tpudist_torch.parallel import MeshSpec

        with pytest.raises(RuntimeError, match="process group"):
            MeshSpec(dp=2).build()


def trainer_rank(rank, world, sd, arrays, batch, snap):
    """The Trainer under ``MeshSpec(fsdp=2, tp=2)`` (the MLP has no tp
    rules: its leaves replicate over tp and shard over fsdp): one epoch,
    then a second Trainer resuming from the snapshot for epoch 2.  For
    ``tests/test_torch_trainer.py``'s ``test_trainer_takes_meshspec``."""
    from tpudist_torch.data import ShardedLoader
    from tpudist_torch.models import MLP
    from tpudist_torch.parallel import MeshSpec
    from tpudist_torch.train import Trainer, TrainerConfig, adam

    spec = MeshSpec.parse("fsdp=2,tp=2")
    mesh = spec.build()
    train_x, train_y, test_x, test_y = arrays
    loaders = [ShardedLoader([x, y], batch, mesh, data_axis=("dp", "fsdp"),
                             drop_last=drop, device="cpu")
               for x, y, drop in ((train_x, train_y, True),
                                  (test_x, test_y, False))]

    def trainer(mesh_arg, axes):
        model = MLP(1, 64, device="cpu")
        cfg = TrainerConfig(total_epochs=2, batch_size=batch,
                            snapshot_path=snap, log_every=1000,
                            mesh_axes=axes)
        return Trainer(cfg, model, adam(1e-3), mesh_arg, *loaders,
                       params=sd)

    first = trainer(mesh, "fsdp=2,tp=2")
    s1 = first.train(max_epochs=1)
    shapes = {k: tuple(p.shape) for k, p in
              first.state.model.named_parameters()}
    after_1 = first._snapshot_tree()["params"]
    second = trainer(spec, "")
    resumed = second._snapshot_tree()["params"]
    s2 = second.train(max_epochs=2)
    final = second._snapshot_tree()["params"]
    np_ = lambda t: {k: v.numpy() for k, v in t.items()}  # noqa: E731
    return {"summaries": [s1, s2], "mesh_spec": second.mesh_spec,
            "epochs_run": second.epochs_run, "shapes": shapes,
            "after_1": np_(after_1), "resumed": np_(resumed),
            "final": np_(final)}


def _dp2_fsdp2_tp2_rank(rank, world, sd, tokens, targets):
    from tpudist_torch.parallel import MeshSpec, transformer_tp_rules

    losses, params, _, _ = _composed(
        MeshSpec(dp=2, fsdp=2, tp=2, rules=tuple(transformer_tp_rules("tp"))),
        sd, tokens, targets, STEPS)
    return {"losses": losses, "params": params}


@pytest.mark.slow
def test_dp2_fsdp2_tp2_matches_tpudist(tmp_path):
    """All three non-pipeline axes above 1 (8 gloo ranks; tpudist's
    TestCompositionMatrix row of the same name is slow-marked too)."""
    _, _, _, tokens, targets = _setup()
    results = run_ranks(_dp2_fsdp2_tp2_rank, 8, tmp_path, _port_sd(), tokens,
                        targets)
    losses, params = jax_composed(dict(dp=2, fsdp=2, tp=2))
    for res in results:
        _hold(res, losses, params)
