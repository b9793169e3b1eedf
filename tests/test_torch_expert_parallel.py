"""tpudist_torch's expert parallelism against tpudist's.

Four cases run in 4 gloo ranks spawned once for the module
(``run_ranks``), each against tpudist on conftest's virtual CPU devices
from the same flax weights and tokens (tpudist's ``tests/test_moe.py``
configurations, the expert axis cut from 4 to 2 so the worlds stay at 4
ranks):

* ``make_ep_train_step`` (tokens replicated over the expert axis, partial
  outputs summed, the model routing over ``data``) at data 1 × expert 2
  (a leading ``rep`` axis of 2 fills the ranks) with the aux loss on: two
  SGD steps against tpudist's GSPMD ``make_ep_train_step`` on the same
  mesh shape (``:259``), then eight Adam steps whose loss falls
  (``:155``);
* the same step at data 2 × expert 2, aux weight 0: one SGD step against
  tpudist's;
* ``ep_d2_e2_routed``: the same step at data 2 × expert 2 with the aux
  loss on (1e-2) and capacity factor 1.0 (top-2 of 4 experts: tokens
  drop), where the routing over the global batch (load-balance term,
  capacity, slot order) decides the result: two SGD steps against
  tpudist's.  On the same tokens, per-shard routing keeps other
  token-expert pairs than the global one (asserted), so this case fails
  on a step that routes each data shard alone;
* ``make_ep_shard_train_step`` (the all-to-all pair, tokens over ``(data,
  expert)``, tpudist's sum contract) at data 2 × expert 2, capacity 8, aux
  weight 0: one SGD step against tpudist's dense single-device step
  (``:189``), with the all-to-alls counted.  Each shard routes its own
  tokens there (tpudist's ``shard_map`` contract).

Tolerances are tpudist's own tests': the loss within rtol 1e-5 (``:259``;
1e-4 for the shard step, ``:189``), parameters within atol 1e-4
(``:189``).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_data_parallel import run_ranks

LOSS_RTOL, SHARD_LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-4
CFG = dict(vocab_size=32, num_heads=2, embed_dim=16, max_seq_len=8)
CASES = [
    dict(name="ep_d1_e2", axes={"rep": 2, "data": 1, "expert": 2},
         layers=2, moe={}, batch=8, seed=0, kind="replicated", steps=2),
    dict(name="ep_d2_e2", axes={"data": 2, "expert": 2}, layers=2,
         moe=dict(aux_loss_weight=0.0), batch=8, seed=3, kind="replicated",
         steps=1),
    dict(name="ep_d2_e2_routed", axes={"data": 2, "expert": 2}, layers=2,
         moe=dict(capacity_factor=1.0, aux_loss_weight=1e-2), batch=8,
         seed=5, kind="replicated", steps=2),
    dict(name="ep_shard_d2_e2", axes={"data": 2, "expert": 2}, layers=1,
         moe=dict(capacity_factor=8.0, aux_loss_weight=0.0), batch=16,
         seed=0, kind="sharded", steps=1),
]
BY_NAME = {c["name"]: c for c in CASES}
ADAM_STEPS = 8


def _cfgs(case, torch_side=True):
    if torch_side:
        from tpudist_torch.models.moe import MoEConfig
        from tpudist_torch.models.transformer import TransformerConfig
    else:
        from tpudist.models import MoEConfig, TransformerConfig
    return (TransformerConfig(num_layers=case["layers"], **CFG),
            MoEConfig(num_experts=4, top_k=2, **case["moe"]))


_FLAX: dict = {}


def _flax(case):
    name = case["name"]
    if name not in _FLAX:
        import jax
        import jax.numpy as jnp

        from tpudist.models import MoETransformerLM

        model = MoETransformerLM(*_cfgs(case, False))
        tokens = np.random.default_rng(case["seed"]).integers(
            0, CFG["vocab_size"], (case["batch"], 8)).astype(np.int32)
        params = model.init(jax.random.key(0), jnp.asarray(tokens))[
            "params"]
        _FLAX[name] = (model, jax.tree.map(np.asarray, params), tokens)
    return _FLAX[name]


def _port_sd(case):
    from tpudist_torch.models.convert import from_flax_moe_params

    _, params, _ = _flax(case)
    cfg, _ = _cfgs(case)
    return {k: v.numpy() for k, v in
            from_flax_moe_params(params, cfg).items()}


def _mean_loss(cfg):
    from tpudist_torch.ops.losses import cross_entropy

    def loss_fn(model, batch, _gen):
        (toks,) = batch
        logits, aux = model(toks)
        ce = cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                           toks[:, 1:].reshape(-1))
        return ce + aux, {}

    return loss_fn


def _run_case(case, sd, tokens):
    from tpudist_torch.models.moe import MoETransformerLM
    from tpudist_torch.ops.losses import cross_entropy_per_token
    from tpudist_torch.parallel import (
        gather_tree,
        make_ep_shard_train_step,
        make_ep_state,
        make_ep_train_step,
        shard_batch,
    )
    from tpudist_torch.parallel.common import CALLS, reset_calls
    from tpudist_torch.runtime.mesh import make_mesh
    from tpudist_torch.train import adam, sgd

    cfg, moe = _cfgs(case)
    mesh = make_mesh(case["axes"])
    tok = torch.from_numpy(tokens).long()

    def build(optimizer, routing_axes=(
            ("data",) if case["kind"] == "replicated" else None)):
        model = MoETransformerLM(cfg, moe, ep_axis="expert", mesh=mesh,
                                 ep_tokens=case["kind"],
                                 routing_axes=routing_axes, device="cpu")
        return make_ep_state(model, sd, optimizer, mesh)

    out = {}
    reset_calls()
    if case["kind"] == "replicated":
        state, specs = build(sgd(0.1))
        step = make_ep_train_step(_mean_loss(cfg), mesh, specs)
        batch = shard_batch((tok,), mesh, "data")
    else:
        state, specs = build(sgd(0.1))
        total = tok.shape[0] * (tok.shape[1] - 1)
        shards = 4

        def local_loss(model, batch):
            (toks,) = batch
            logits, aux = model(toks)
            per_tok = cross_entropy_per_token(
                logits[:, :-1].reshape(-1, cfg.vocab_size),
                toks[:, 1:].reshape(-1))
            return per_tok.sum() / total + aux / shards

        step = make_ep_shard_train_step(local_loss, mesh, state)
        batch = shard_batch((tok,), mesh, ("data", "expert"))
    out["w_up_shape"] = tuple(state.model.blocks[0].moe.w_up.shape)
    losses = []
    for _ in range(case["steps"]):
        state, metrics = step(state, *batch)
        losses.append(float(metrics["loss"]))
    out["calls"] = dict(CALLS)
    out["losses"] = losses
    out["params"] = {k: v.numpy() for k, v in gather_tree(
        dict(state.model.named_parameters()), mesh, specs).items()}
    if case["name"] == "ep_d2_e2_routed":
        # a model routing each data shard alone: the step refuses it
        unrouted, unrouted_specs = build(sgd(0.1), routing_axes=None)
        try:
            make_ep_train_step(_mean_loss(cfg), mesh, unrouted_specs)(
                unrouted, *batch)
        except ValueError as e:
            out["unrouted_error"] = str(e)
    if case["name"] == "ep_d1_e2":
        state, specs = build(adam(1e-2))
        step = make_ep_train_step(_mean_loss(cfg), mesh, specs)
        out["adam_losses"] = [float(step(state, *batch)[1]["loss"])
                              for _ in range(ADAM_STEPS)]
    return out


def _ep_rank(rank, world, payload):
    return {case["name"]: _run_case(case, sd, tokens)
            for case, sd, tokens in payload}


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    payload = [(c, _port_sd(c), _flax(c)[2]) for c in CASES]
    return run_ranks(_ep_rank, 4, tmp_path_factory.mktemp("ep"), payload)


def jax_case(name):
    """tpudist's run: its ``make_ep_train_step`` on the case's mesh shape,
    or (the shard step) its dense single-device reference step."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpudist.ops.losses import cross_entropy
    from tpudist.parallel.expert_parallel import (
        make_ep_state,
        make_ep_train_step,
    )
    from tpudist.parallel.tensor_parallel import shard_batch
    from tpudist.runtime.mesh import make_mesh
    from tpudist.train.state import TrainState
    from tpudist_torch.models.convert import from_flax_moe_params

    case = BY_NAME[name]
    model, params, tokens = _flax(case)
    cfg = _cfgs(case, False)[0]
    tok = jnp.asarray(tokens)

    def loss_fn(p, batch, rng):
        (toks,) = batch
        logits, aux = model.apply({"params": p}, toks)
        ce = cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                           toks[:, 1:].reshape(-1))
        return ce + aux, {}

    losses = []
    if case["kind"] == "replicated":
        axes = {k: v for k, v in case["axes"].items() if k != "rep"}
        n = int(np.prod(list(axes.values())))
        mesh = make_mesh(axes, jax.devices()[:n])
        state, specs = make_ep_state(model.apply, params, optax.sgd(0.1),
                                     mesh)
        step = make_ep_train_step(loss_fn, mesh, specs, donate=False)
        batch = shard_batch(tok, mesh)
        for _ in range(case["steps"]):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        new = state.params
    else:
        (loss, _), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, (tok,), None)
        losses.append(float(loss))
        new = TrainState.create(None, params, optax.sgd(0.1)
                                ).apply_gradients(grads).params
    got = {k: v.numpy() for k, v in from_flax_moe_params(
        jax.tree.map(np.asarray, new), _cfgs(case)[0]).items()}
    return {"losses": losses, "params": got}


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_ep_matches_tpudist(name, rank_results):
    case = BY_NAME[name]
    want = jax_case(name)
    rtol = SHARD_LOSS_RTOL if case["kind"] == "sharded" else LOSS_RTOL
    for r, res in enumerate(rank_results):
        got = res[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
        assert set(got["params"]) == set(want["params"])
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=PARAM_ATOL,
                                       rtol=0, err_msg=f"rank {r} {k}")


def test_ep_holds_its_experts_and_trains(rank_results):
    """Each rank holds E/n experts; eight Adam steps (lr 1e-2) lower the
    loss (tpudist's ``test_moe_lm_ep_train_step_on_mesh``)."""
    for res in rank_results:
        for name in BY_NAME:
            assert res[name]["w_up_shape"] == (2, 16, 64)
        losses = res["ep_d1_e2"]["adam_losses"]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_ep_collectives_counted(rank_results):
    """The shard step dispatches by all-to-all (two a layer forward, two
    backward) and routes each shard alone; the replicated-token step
    dispatches by all-reduces only (per layer and step: the partial
    outputs' sum, and the cotangents of ``x`` and the combine weights)
    and routes over ``data`` (per layer and step: the gate sums'
    all-reduce forward and backward, one all-gather of the counts)."""
    for res in rank_results:
        shard = res["ep_shard_d2_e2"]["calls"]
        layers = BY_NAME["ep_shard_d2_e2"]["layers"]
        assert shard["all_to_all"] == 4 * layers
        assert shard.get("all_reduce", 0) == 0
        rep = res["ep_d2_e2"]["calls"]
        case = BY_NAME["ep_d2_e2"]
        assert rep.get("all_to_all", 0) == 0
        assert rep["all_reduce"] == 5 * case["layers"] * case["steps"]
        assert rep["all_gather"] == case["layers"] * case["steps"]


def test_ep_rules_and_dispatch_errors():
    from tpudist_torch.models.moe import MoEConfig, MoEMLP
    from tpudist_torch.models.moe import MoETransformerLM
    from tpudist_torch.parallel import moe_ep_rules, spec_tree_from_rules

    cfg, moe = _cfgs(CASES[0])
    specs = spec_tree_from_rules(MoETransformerLM(cfg, moe, device="cpu"),
                                 moe_ep_rules())
    assert specs["blocks.0.moe.w_up"] == ("expert", None, None)
    assert specs["blocks.0.moe.w_down"] == ("expert", None, None)
    assert specs["blocks.0.moe.router.weight"] == ()
    assert specs["blocks.0.attn.proj.weight"] == ()
    with pytest.raises(ValueError, match="ep_tokens"):
        MoEMLP(16, 32, MoEConfig(num_experts=4), ep_axis="expert",
               ep_tokens="both", device="cpu")


def test_ep_step_refuses_a_model_routing_per_shard(rank_results):
    """``make_ep_train_step`` runs tpudist's GSPMD program: a model built
    without ``routing_axes=("data",)`` would route each data shard alone,
    and the step raises instead."""
    for res in rank_results:
        msg = res["ep_d2_e2_routed"].get("unrouted_error", "")
        assert "routes over None" in msg and "('data',)" in msg, msg


def test_ep_routed_case_discriminates():
    """On ``ep_d2_e2_routed``'s tokens and first layer's router, the
    port's routing of each data shard alone keeps another set of
    token-expert pairs than its routing of the global batch: the case
    fails on a step that routes per shard."""
    from tpudist_torch.models.moe import MoETransformerLM, _top_k_routing

    case = BY_NAME["ep_d2_e2_routed"]
    cfg, moe = _cfgs(case)
    model = MoETransformerLM(cfg, moe, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _port_sd(case).items()})
    layer, inputs = model.blocks[0].moe, []
    layer.register_forward_pre_hook(lambda mod, args: inputs.append(args[0]))
    with torch.no_grad():
        model(torch.from_numpy(_flax(case)[2]).long())
        gates = torch.softmax(layer.router(inputs[0].float()), -1)
    t, k, e, cf = gates.shape[0], moe.top_k, moe.num_experts, \
        moe.capacity_factor
    kept = _top_k_routing(gates, k, int(cf * t * k / e))[0].sum(-1)
    shards = case["axes"]["data"]
    per_shard = torch.cat([
        _top_k_routing(g, k, int(cf * (t // shards) * k / e))[0].sum(-1)
        for g in gates.chunk(shards)])
    assert kept.sum() < t * k and not torch.equal(kept, per_shard)
