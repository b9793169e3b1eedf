"""tpudist_torch's Mixture-of-Experts model against the JAX package's.

Layer level: the routing head, GShard routing, the counting sort (with the
fused layout's block→expert map), the ragged path and ``MoEMLP`` under each
dispatch.  Model level: ``MoETransformerLM`` logits and aux loss with the
weights carried across by ``from_flax_moe_params``, the fused path's
gradients (the port's remat backward against ``jax.grad`` through the JAX
``custom_vjp``), and 3 Adam steps through ``make_dp_train_step`` — the
slice's training path, fused dispatch and flash attention on both sides.
On the CPU the port runs K7's and the attention kernels' plain versions;
the JAX side runs its Pallas kernels in interpret mode.  Inputs are seeded
numpy.

Tolerances (f32): the counting sort, ``block_expert`` and the top-k choices
are compared exactly; gates, dispatch/combine tensors and the aux loss
within 1e-6; layer outputs within atol 2e-5 + rtol 1e-4, and logits
within 1e-4 (XLA's CPU dot and ATen sum in other orders, and the fused
path multiplies the gate in f32 inside the kernel where the ragged one
multiplies after the product); gradients within atol 1e-6 + rtol 1e-4;
after 3 Adam steps every parameter within 1e-4 and all but one in 10,000
within 3e-6 (Adam moves an element whose gradient is near zero by up to
lr on a difference in that gradient's last bits).  bf16 (layer, same
bf16 input on both sides): each output element within 1e-2·max|JAX| +
2e-2·|JAX| — both round h to bf16 between the products, at points that
agree in kind but may land one bf16 ulp apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpudist.models.moe import MoEConfig as JaxMoEConfig
from tpudist.models.moe import MoEMLP as JaxMoEMLP
from tpudist.models.moe import MoETransformerLM as JaxMoELM
from tpudist.models.moe import _counting_sort as jax_counting_sort
from tpudist.models.moe import _gate_choices as jax_gate_choices
from tpudist.models.moe import _ragged_moe as jax_ragged_moe
from tpudist.models.moe import _top_k_routing as jax_top_k_routing
from tpudist.models.transformer import TransformerConfig as JaxConfig
from tpudist.ops.flash_attention import flash_attention_fn as jax_flash_fn
from tpudist.ops.losses import cross_entropy as jax_cross_entropy
from tpudist.parallel.data_parallel import broadcast_params
from tpudist.parallel.data_parallel import make_dp_train_step as jax_dp_step
from tpudist.train.state import TrainState as JaxState
from tpudist_torch.models import moe as tm
from tpudist_torch.models.convert import from_flax_moe_params
from tpudist_torch.models.transformer import TransformerConfig
from tpudist_torch.ops import moe_dispatch as td
from tpudist_torch.ops.flash_attention import flash_attention_fn
from tpudist_torch.ops.losses import cross_entropy
from tpudist_torch.parallel import make_dp_train_step
from tpudist_torch.train import TrainState, adam

OUT_TOL = dict(atol=2e-5, rtol=1e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
BASE = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
            max_seq_len=32)
CONFIGS = {"mha": {}, "gqa": {"num_kv_heads": 2}}
SEQ = 16
DISPATCHES = ("einsum", "ragged", "fused")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _gates(seed, t, e):
    logits = np.random.default_rng(seed).standard_normal((t, e))
    g = np.exp(logits - logits.max(-1, keepdims=True))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


def _routing(kind, seed, t, e, k):
    """``[t, k]`` expert ids: random, all on experts 0 and 1 (skewed), or
    only on experts 1, 3 and 6 (empty groups at both ends and between)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, e, (t, k))
    if kind == "skewed":
        return np.stack([np.zeros(t, np.int64), np.ones(t, np.int64)],
                        1)[:, :k]
    return rng.choice([1, 3, 6], (t, k))


# ---- the routing head ------------------------------------------------------

@pytest.mark.parametrize("e,k", [(4, 1), (4, 2), (8, 2), (8, 3)])
def test_gate_choices_match_jax(e, k):
    gates = _gates(e * 10 + k, 48, e)
    jv, ji, ja = jax_gate_choices(jnp.asarray(gates), k)
    tv, ti, ta = tm._gate_choices(_t(gates), k)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_allclose(tv.numpy(), _np(jv), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ta.item(), float(ja), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("cf", [0.25, 1.0, 2.0, 8.0])
def test_top_k_routing_matches_jax(cf):
    """Capacity from 1 slot (most tokens dropped) to ample."""
    t, e, k = 32, 4, 2
    gates = _gates(int(cf * 4), t, e)
    capacity = max(1, int(cf * t * k / e))
    jd, jc, ja = jax_top_k_routing(jnp.asarray(gates), k, capacity)
    d, c, a = tm._top_k_routing(_t(gates), k, capacity)
    np.testing.assert_array_equal(d.numpy(), _np(jd))
    np.testing.assert_allclose(c.numpy(), _np(jc), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(a.item(), float(ja), atol=1e-6, rtol=1e-6)


# ---- the counting sort and the fused layout --------------------------------

@pytest.mark.parametrize("block_rows", [None, 8, 16, 128])
@pytest.mark.parametrize("kind", ["random", "skewed", "empty"])
def test_counting_sort_is_exact(kind, block_rows):
    """``pos``, ``order``, ``group_sizes``, ``starts`` and ``np_pad``
    equal the JAX function's, and so does the block→expert map the fused
    path builds from ``starts``."""
    e = 8
    flat = _routing(kind, 7, 40, e, 2).reshape(-1)
    want = jax_counting_sort(jnp.asarray(flat, jnp.int32), e, block_rows)
    got = tm._counting_sort(_t(flat), e, block_rows)
    for name, a, b in zip(("pos", "order", "group_sizes", "starts"),
                          got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), _np(b), err_msg=name)
    assert got[4] == want[4]
    if block_rows is None:
        return
    # the JAX expression of tpudist/ops/moe_dispatch.py:125-127
    nb = want[4] // block_rows
    ids = jnp.zeros((nb,), jnp.int32).at[
        jnp.minimum(want[3] // block_rows, nb - 1)].add(1)
    want_be = jnp.clip(jnp.cumsum(ids) - 1, 0, e - 1)
    got_be = td._block_expert(got[3], nb, e, block_rows)
    assert got_be.dtype == torch.int32
    np.testing.assert_array_equal(got_be.numpy(), _np(want_be))


# ---- the ragged path and the layer -----------------------------------------

def _weights(seed, e, d, f):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, d, f), np.float32) * 0.1,
            rng.standard_normal((e, f, d), np.float32) * 0.1)


@pytest.mark.parametrize("k", [1, 2])
def test_ragged_moe_matches_jax(k):
    t, d, f, e = 40, 16, 32, 4
    x = np.random.default_rng(k).standard_normal((t, d), np.float32)
    w_up, w_down = _weights(k, e, d, f)
    tv, ti, _ = jax_gate_choices(jnp.asarray(_gates(k, t, e)), k)
    want = jax_ragged_moe(jnp.asarray(x), jnp.asarray(w_up),
                          jnp.asarray(w_down), ti, tv)
    got = tm._ragged_moe(_t(x), _t(w_up), _t(w_down), _t(ti).long(), _t(tv))
    np.testing.assert_allclose(got.numpy(), _np(want), **OUT_TOL)


def _layer_pair(dispatch, d=32, f=64, e=4, k=2, cf=2.0, block_rows=16,
                seed=0):
    """A flax MoEMLP initialised from ``seed`` and the port's with its
    weights."""
    x = np.random.default_rng(seed).standard_normal((64, d), np.float32)
    jl = JaxMoEMLP(d, f, JaxMoEConfig(num_experts=e, top_k=k,
                                      capacity_factor=cf, dispatch=dispatch,
                                      fused_block_rows=block_rows))
    params = jl.init(jax.random.key(seed), jnp.asarray(x))["params"]
    tl = tm.MoEMLP(d, f, tm.MoEConfig(num_experts=e, top_k=k,
                                      capacity_factor=cf, dispatch=dispatch,
                                      fused_block_rows=block_rows),
                   device="cpu")
    tl.load_state_dict({
        "router.weight": _t(params["router"]["kernel"]).T.contiguous(),
        "w_up": _t(params["w_up"]), "w_down": _t(params["w_down"])})
    return jl, params, tl, x


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_moe_mlp_matches_jax(dispatch, cf):
    """f32; ``cf=0.5`` drops tokens on the einsum path (and is ignored by
    the other two)."""
    jl, params, tl, x = _layer_pair(dispatch, cf=cf)
    want, want_aux = jl.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got, aux = tl(_t(x))
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **OUT_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_mlp_bf16_matches_jax(dispatch):
    """bf16 activations, f32 parameters (cast at use), the router in
    f32: the output stays bf16 and agrees element-wise."""
    jl, params, tl, x = _layer_pair(dispatch, seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, want_aux = jl.apply({"params": params}, xb)
    with torch.no_grad():
        got, aux = tl(_t(np.asarray(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    for p in tl.parameters():
        assert p.dtype == torch.float32
    w = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - w)
    assert (err <= 1e-2 * np.abs(w).max() + 2e-2 * np.abs(w)).all(), \
        err.max()
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-6,
                               rtol=1e-5)


def test_moe_mlp_errors_match_jax():
    """``ep_axis`` under ragged/fused is single-shard (ValueError on both
    sides); an unknown dispatch is a ValueError on both sides; ``ep_axis``
    under einsum (the all_to_all path) is not ported yet."""
    x = jnp.zeros((8, 16), jnp.float32)
    for dispatch in ("ragged", "fused"):
        with pytest.raises(ValueError, match="single-shard"):
            JaxMoEMLP(16, 32, JaxMoEConfig(num_experts=4, dispatch=dispatch),
                      ep_axis="expert").init(jax.random.key(0), x)
        with pytest.raises(ValueError, match="single-shard"):
            tm.MoEMLP(16, 32, tm.MoEConfig(num_experts=4, dispatch=dispatch),
                      ep_axis="expert", device="cpu")
    with pytest.raises(ValueError, match="unknown dispatch 'dense'"):
        JaxMoEMLP(16, 32, JaxMoEConfig(dispatch="dense")).init(
            jax.random.key(0), x)
    with pytest.raises(ValueError, match="unknown dispatch 'dense'"):
        tm.MoEMLP(16, 32, tm.MoEConfig(dispatch="dense"), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A 7"):
        tm.MoEMLP(16, 32, tm.MoEConfig(num_experts=4), ep_axis="expert",
                  device="cpu")


def test_config_defaults_match_jax():
    want = {f.name: f.default for f in dataclasses.fields(JaxMoEConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tm.MoEConfig)}
    assert got == want


# ---- the model ---------------------------------------------------------------

def _tokens(seed, batch=2):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab_size"], (batch, SEQ)).astype(np.int32)


def _setup(name, dispatch, *, bf16=False, seed=0):
    kw = dict(BASE, **CONFIGS[name])
    jcfg = JaxConfig(**kw, compute_dtype=jnp.bfloat16 if bf16
                     else jnp.float32)
    jmoe = JaxMoEConfig(num_experts=4, top_k=2, dispatch=dispatch,
                        fused_block_rows=8)
    params = JaxMoELM(jcfg, jmoe).init(
        jax.random.key(seed), jnp.zeros((1, 2), jnp.int32))["params"]
    cfg = TransformerConfig(**kw, compute_dtype=torch.bfloat16 if bf16
                            else torch.float32)
    moe = tm.MoEConfig(num_experts=4, top_k=2, dispatch=dispatch,
                       fused_block_rows=8)
    return jcfg, jmoe, cfg, moe, params


def _port_lm(cfg, moe, params, attention_fn=None):
    kw = {} if attention_fn is None else {"attention_fn": attention_fn}
    model = tm.MoETransformerLM(cfg, moe, device="cpu", **kw)
    model.load_state_dict(from_flax_moe_params(_np_tree(params), cfg))
    return model


def test_converter_covers_every_parameter():
    _, _, cfg, moe, params = _setup("gqa", "fused")
    sd = from_flax_moe_params(_np_tree(params), cfg)
    model = tm.MoETransformerLM(cfg, moe, device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
        assert v.dtype == torch.float32, k
    assert sd["blocks.0.moe.router.weight"].shape == (4, BASE["embed_dim"])


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lm_logits_and_aux_match_jax(name, dispatch):
    jcfg, jmoe, cfg, moe, params = _setup(name, dispatch)
    toks = _tokens(1)
    want, want_aux = JaxMoELM(jcfg, jmoe).apply({"params": params},
                                               jnp.asarray(toks))
    with torch.no_grad():
        got, aux = _port_lm(cfg, moe, params)(_t(toks).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **LOGIT_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-6,
                               rtol=1e-5)


def _jax_loss_fn(jcfg, jmoe, attention_fn=None):
    kw = {} if attention_fn is None else {"attention_fn": attention_fn}
    model = JaxMoELM(jcfg, jmoe, **kw)

    def loss_fn(p, batch, _rng):
        (toks,) = batch
        logits, aux = model.apply({"params": p}, toks)
        ce = jax_cross_entropy(logits[:, :-1].reshape(-1, jcfg.vocab_size),
                               toks[:, 1:].reshape(-1))
        return ce + aux, {"aux": aux}

    return loss_fn


def _loss_fn(model, batch, _gen):
    (toks,) = batch
    logits, aux = model(toks)
    ce = cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                       toks[:, 1:].reshape(-1))
    return ce + aux, {"aux": aux}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_lm_grads_match_jax(name):
    """The port's ``_FusedMoE`` backward (remat through ``_ragged_moe``)
    against ``jax.grad`` through the JAX ``custom_vjp``: loss and every
    parameter's gradient, by name."""
    jcfg, jmoe, cfg, moe, params = _setup(name, "fused", seed=2)
    toks = _tokens(2)
    (want_loss, _), jgrads = jax.value_and_grad(
        _jax_loss_fn(jcfg, jmoe), has_aux=True)(
            params, (jnp.asarray(toks),), None)
    want = from_flax_moe_params(_np_tree(jgrads), cfg)
    model = _port_lm(cfg, moe, params)
    loss, _ = _loss_fn(model, (_t(toks).long(),), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5,
                               rtol=1e-5)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   **GRAD_TOL, err_msg=k)


def test_fused_and_ragged_lm_train_alike():
    """The port's own fused and ragged dispatch give the same loss and
    gradients (the JAX test of the fused custom_vjp, on the port)."""
    _, _, cfg, moe, params = _setup("gqa", "fused", seed=4)
    toks = (_t(_tokens(4)).long(),)
    runs = []
    for dispatch in ("fused", "ragged"):
        model = _port_lm(cfg, dataclasses.replace(moe, dispatch=dispatch),
                         params)
        loss, _ = _loss_fn(model, toks, None)
        loss.backward()
        runs.append((loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()}))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-6)
    for k in runs[0][1]:
        np.testing.assert_allclose(runs[0][1][k].numpy(),
                                   runs[1][1][k].numpy(), **GRAD_TOL,
                                   err_msg=k)


def test_three_adam_steps_match_jax():
    """The slice's training path at small size: fused dispatch (K7's plain
    version, the remat backward) and flash attention, 3 steps of
    ``make_dp_train_step`` + Adam against 3 of JAX's on a 1-device mesh:
    loss and aux at each step and every parameter after."""
    jcfg, jmoe, cfg, moe, params = _setup("gqa", "fused", seed=5)
    toks = _tokens(6)
    lr = 1e-3
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jstate = JaxState.create(JaxMoELM(jcfg, jmoe).apply,
                             broadcast_params(params, mesh), optax.adam(lr))
    jstep = jax_dp_step(_jax_loss_fn(jcfg, jmoe, jax_flash_fn()), mesh)
    model = _port_lm(cfg, moe, params, flash_attention_fn())
    state = TrainState.create(model, adam(lr), seed=0)
    step = make_dp_train_step(_loss_fn)
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        state, m = step(state, _t(toks).long())
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]),
                                   atol=1e-6, rtol=1e-5, err_msg=f"step {i}")
    assert state.step == 3 and int(jstate.step) == 3
    want = from_flax_moe_params(_np_tree(jstate.params), cfg)
    diff = torch.cat([(p - want[k]).abs().flatten()
                      for k, p in model.state_dict().items()])
    assert diff.max().item() <= 1e-4
    assert int((diff > 3e-6).sum()) <= diff.numel() * 1e-4


def test_init_weights_follow_flax():
    """f32 storage; the expert stacks drawn with lecun_normal's fan_in
    over the expert axis too (std 1/sqrt(E·fan_in)); the router and
    attention with 1/sqrt(d); LayerNorm at 1 and 0."""
    cfg = TransformerConfig(vocab_size=64, num_layers=1, num_heads=4,
                            embed_dim=64, max_seq_len=32)
    moe = tm.MoEConfig(num_experts=8, top_k=2)
    model = tm.MoETransformerLM(cfg, moe, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    sd = model.state_dict()
    trunc = 0.8796   # std of a normal truncated at 2 sigma, per sigma
    for name, fan_in in (("blocks.0.moe.w_up", 8 * 64),
                         ("blocks.0.moe.w_down", 8 * 256),
                         ("blocks.0.moe.router.weight", 64),
                         ("blocks.0.attn.qkv.weight", 64)):
        std = sd[name].std().item()
        want = trunc / fan_in ** 0.5
        assert abs(std - want) <= 0.1 * want, (name, std, want)
    assert torch.equal(sd["blocks.0.ln2.scale"], torch.ones(64))
    assert all(v.dtype == torch.float32 for v in sd.values())
