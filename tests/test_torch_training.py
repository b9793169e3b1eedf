"""tpudist_torch's training path against the JAX package's.

A 2-layer TransformerLM (embed 64, 4 heads, seq 64) with flash attention
on both sides — the port's plain versions of K1/K3/K4 under its autograd
wrapper, the Pallas kernels in interpret mode under the JAX custom_vjp.
Weights come from the flax init through ``from_flax_params``, and the JAX
gradient tree goes through the same converter, so gradients are compared
by parameter name.  Tokens are seeded numpy.

Tolerances (f32): loss atol = rtol = 1e-5; each gradient atol 1e-6 plus
rtol 1e-4.  Both sides compute in f32 through different matmul libraries
(XLA's CPU dot vs ATen), so sums run in other orders and differences of a
few ulp grow through the layers.  Parameters after 3 Adam steps (lr 1e-3,
so up to 3e-3 of movement): every element within 1e-4, and all but one in
10,000 within 3e-6.  Adam scales each element's step by its own
gradient's size, so an element whose gradient is near zero moves by up to
lr on a difference in that gradient's last bits (2-3 elements of 103,040
here).  bf16 compute with f32 master weights: loss within
1e-2 relative, and each gradient within 5e-2·max|JAX grad| — bf16
activations are rounded after every projection, at points that match in
kind but not bit for bit (XLA and ATen round a bf16 matmul's f32 sum at
different steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpudist.models.transformer import TransformerConfig as JaxConfig
from tpudist.models.transformer import TransformerLM as JaxLM
from tpudist.ops.flash_attention import flash_attention_fn as jax_flash_fn
from tpudist.ops.losses import cross_entropy as jax_cross_entropy
from tpudist.parallel.data_parallel import broadcast_params
from tpudist.parallel.data_parallel import make_dp_train_step as jax_dp_step
from tpudist.train.state import TrainState as JaxState
from tpudist_torch.models.convert import from_flax_params
from tpudist_torch.models.transformer import TransformerConfig, TransformerLM
from tpudist_torch.ops.flash_attention import flash_attention_fn
from tpudist_torch.ops.losses import cross_entropy
from tpudist_torch.parallel import make_dp_train_step
from tpudist_torch.train import TrainState, adam

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
BASE = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=64,
            max_seq_len=64)
CONFIGS = {
    "mha": {},
    "gqa": {"num_kv_heads": 2},
    "window": {"num_kv_heads": 2, "attention_window": 8},
}
SEQ = 64


def _tokens(seed, batch=2):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab_size"], (batch, SEQ)).astype(np.int32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(name, seed=0, *, bf16=False, scan=False):
    kw = dict(BASE, **CONFIGS[name])
    jcfg = JaxConfig(**kw, scan_layers=scan,
                     compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    params = JaxLM(jcfg).init(jax.random.key(seed),
                              jnp.zeros((1, 2), jnp.int32))["params"]
    cfg = TransformerConfig(**kw, scan_layers=scan,
                            compute_dtype=torch.bfloat16 if bf16
                            else torch.float32)
    return jcfg, cfg, params


def _jax_loss_fn(jcfg):
    model = JaxLM(jcfg, attention_fn=jax_flash_fn())

    def loss_fn(p, batch, _rng):
        (toks,) = batch
        logits = model.apply({"params": p}, toks)
        return jax_cross_entropy(logits[:, :-1].reshape(-1, jcfg.vocab_size),
                                 toks[:, 1:].reshape(-1)), {}

    return loss_fn


def _loss_fn(model, batch, _gen):
    (toks,) = batch
    logits = model(toks)
    return cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                         toks[:, 1:].reshape(-1)), {}


def _port_model(cfg, params, **kw):
    model = TransformerLM(cfg, attention_fn=flash_attention_fn(),
                          param_dtype=torch.float32, device="cpu", **kw)
    model.load_state_dict(from_flax_params(_np_tree(params), cfg))
    return model


def _port_grads(model, toks):
    model.zero_grad(set_to_none=True)
    loss, _ = _loss_fn(model, (torch.from_numpy(toks).long(),), None)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def _jax_grads(jcfg, params, toks):
    (loss, _), grads = jax.value_and_grad(_jax_loss_fn(jcfg), has_aux=True)(
        params, (jnp.asarray(toks),), None)
    return float(loss), grads


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_loss_and_grads_match_jax(name, scan):
    """Every parameter's gradient, by name; a scanned JAX model's gradient
    tree is unstacked by the converter."""
    jcfg, cfg, params = _setup(name, scan=scan)
    assert ("blocks" in params) == scan
    toks = _tokens(1)
    want_loss, jgrads = _jax_grads(jcfg, params, toks)
    want = from_flax_params(_np_tree(jgrads), cfg)
    loss, got = _port_grads(_port_model(cfg, params), toks)
    np.testing.assert_allclose(loss.numpy(), want_loss, **LOSS_TOL)
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("name", ["gqa", "window"])
def test_three_adam_steps_match_jax(name):
    """3 steps of ``make_dp_train_step`` + Adam against 3 of JAX's on a
    1-device mesh: losses at each step and every parameter after."""
    jcfg, cfg, params = _setup(name)
    toks = _tokens(2)
    lr = 1e-3
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jstate = JaxState.create(JaxLM(jcfg).apply,
                             broadcast_params(params, mesh), optax.adam(lr))
    jstep = jax_dp_step(_jax_loss_fn(jcfg), mesh)
    model = _port_model(cfg, params)
    state = TrainState.create(model, adam(lr), seed=0)
    step = make_dp_train_step(_loss_fn)
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        state, m = step(state, torch.from_numpy(toks).long())
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **LOSS_TOL, err_msg=f"step {i}")
    assert state.step == 3 and int(jstate.step) == 3
    want = from_flax_params(_np_tree(jstate.params), cfg)
    diff = torch.cat([(p - want[k]).abs().flatten()
                      for k, p in model.state_dict().items()])
    assert diff.max().item() <= 1e-4
    assert int((diff > 3e-6).sum()) <= diff.numel() * 1e-4


def test_remat_gives_the_same_grads():
    _, cfg, params = _setup("gqa")
    toks = _tokens(3)
    l0, g0 = _port_grads(_port_model(cfg, params), toks)
    l1, g1 = _port_grads(_port_model(cfg, params, remat=True), toks)
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-7, msg=k)


def test_accum_steps_matches_single_pass():
    _, cfg, params = _setup("gqa")
    toks = torch.from_numpy(_tokens(4, batch=4)).long()
    grads, losses = [], []
    for accum in (1, 2):
        model = _port_model(cfg, params)
        state = TrainState.create(model, adam(1e-3))
        _, m = make_dp_train_step(_loss_fn, accum_steps=accum)(state, toks)
        losses.append(m["loss"])
        grads.append({n: p.grad for n, p in model.named_parameters()})
    torch.testing.assert_close(losses[1], losses[0], atol=1e-6, rtol=1e-6)
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], atol=1e-7,
                                   rtol=1e-5, msg=k)
    with pytest.raises(ValueError, match="not divisible"):
        make_dp_train_step(_loss_fn, accum_steps=3)(state, toks)


def test_bf16_compute_with_f32_master_weights_matches_jax():
    jcfg, cfg, params = _setup("gqa", bf16=True)
    toks = _tokens(5)
    want_loss, jgrads = _jax_grads(jcfg, params, toks)
    want = from_flax_params(_np_tree(jgrads), cfg)
    model = _port_model(cfg, params)
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32, n
    loss, got = _port_grads(model, toks)
    np.testing.assert_allclose(loss.numpy(), want_loss, rtol=1e-2)
    for k in sorted(want):
        w = want[k]
        err = (got[k] - w).abs().max().item()
        assert err <= 5e-2 * w.abs().max().item(), (k, err)


def test_serve_weights_stay_in_compute_dtype():
    """``param_dtype=None`` keeps the serve path's storage: weights in the
    compute dtype (LayerNorm scale and bias stay f32, as before)."""
    _, cfg, _ = _setup("gqa", bf16=True)
    model = TransformerLM(cfg, device="cpu")
    for n, p in model.named_parameters():
        want = torch.float32 if n.endswith((".scale", ".bias")) \
            else torch.bfloat16
        assert p.dtype == want, n


def test_factory_window_mismatch_raises():
    _, cfg, _ = _setup("window")
    with pytest.raises(ValueError, match="attention_window"):
        TransformerLM(cfg, attention_fn=flash_attention_fn(window=4),
                      device="cpu")
    plain = dataclasses.replace(cfg, attention_window=None)
    with pytest.raises(ValueError, match="attention_window"):
        TransformerLM(plain, attention_fn=flash_attention_fn(window=8),
                      device="cpu")
    TransformerLM(cfg, attention_fn=flash_attention_fn(window=8),
                  device="cpu")


def test_multi_process_step_raises(monkeypatch):
    """Under a world of 2 the step all-reduces its gradients and loss in
    one flat buffer and averages them: two identical ranks (the
    all-reduce faked as the sum over them) give the one-process step.  A
    mesh without the data axis raises.  (The multi-process step itself
    is held against tpudist in tests/test_torch_data_parallel.py.)"""
    import torch.distributed as dist

    _, cfg, params = _setup("mha")
    toks = torch.from_numpy(_tokens(6)).long()
    ref = TrainState.create(_port_model(cfg, params), adam(1e-3))
    _, ref_m = make_dp_train_step(_loss_fn)(ref, toks)
    state = TrainState.create(_port_model(cfg, params), adam(1e-3))
    calls = []

    def all_reduce(t, op=None, group=None):
        calls.append(t.numel())
        t.mul_(2)

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    _, m = make_dp_train_step(_loss_fn)(state, toks)
    n_params = sum(p.numel() for p in state.model.parameters())
    assert calls == [n_params + 1]
    torch.testing.assert_close(m["loss"], ref_m["loss"], rtol=0, atol=0)
    for (k, p), q in zip(state.model.named_parameters(),
                         ref.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=k)

    class SeqOnly:
        mesh_dim_names = ("seq",)

    with pytest.raises(ValueError, match="not 'data'"):
        make_dp_train_step(_loss_fn, mesh=SeqOnly())


def test_dp_step_keeps_aux_as_given(monkeypatch):
    """aux entries come back as the loss_fn gave them: one process returns
    each unchanged (any shape and dtype, as tpudist's pmean takes any
    shape); under a world of 2 (the all-reduce faked as the sum over two
    identical ranks) each is averaged and keeps its shape."""
    import torch.distributed as dist

    _, cfg, params = _setup("mha")
    toks = torch.from_numpy(_tokens(6)).long()
    aux = {"counts": torch.tensor([3, 5, 7]),
           "scale": torch.tensor(0.5, dtype=torch.bfloat16),
           "grid": torch.arange(6.0).reshape(2, 3)}

    def loss_fn(model, batch, gen):
        loss, _ = _loss_fn(model, batch, gen)
        return loss, dict(aux)

    state = TrainState.create(_port_model(cfg, params), adam(1e-3))
    _, m = make_dp_train_step(loss_fn)(state, toks)
    for k, v in aux.items():
        assert m[k].dtype == v.dtype and m[k].shape == v.shape, k
        torch.testing.assert_close(m[k], v, rtol=0, atol=0)

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "all_reduce",
                        lambda t, op=None, group=None: t.mul_(2))
    state = TrainState.create(_port_model(cfg, params), adam(1e-3))
    _, m = make_dp_train_step(loss_fn)(state, toks)
    for k, v in aux.items():
        assert m[k].shape == v.shape, k
        torch.testing.assert_close(m[k].float(), v.float(), rtol=0, atol=0)
