"""tpudist_torch's MNIST models and embedding classifier against the JAX
package's, on the same weights and inputs.

Weights are drawn with numpy from a seed in the shapes ``jax.eval_shape``
gives the flax init (no JAX init pass), then carried to the port by
``from_flax_{mlp,convnet,embedding}_params``.  Tolerance (f32): logits
within atol = rtol = 1e-5; both sides sum f32 products in other orders
(XLA's CPU dot and conv against ATen's).  bf16 compute: logits within
5e-2 of the f32 ones relative to their largest magnitude.
"""

import jax
import numpy as np
import pytest
import torch

from tpudist.models import ConvNet as JaxConvNet
from tpudist.models import EmbeddingBagClassifier as JaxEmbedding
from tpudist.models import MLP as JaxMLP
from tpudist_torch.models import (
    MLP,
    ConvNet,
    EmbeddingBagClassifier,
    from_flax_convnet_params,
    from_flax_embedding_params,
    from_flax_mlp_params,
)
from tpudist_torch.models.convnet import flax_dropout

TOL = dict(atol=1e-5, rtol=1e-5)


def drawn_params(model, *inputs, seed=0):
    """flax parameters in the shapes of ``model.init``, drawn with numpy:
    kernels normal(0, 1/sqrt(fan_in)), biases and tables normal(0, 0.1)
    and normal(0, 1)."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), *inputs)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        scale = 1.0 if name == "embedding" else 0.1
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images(n, hw=(28, 28), seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, *hw, 1)).astype(np.float32)


def _load(model, sd):
    """Load a converted state dict strictly: every port parameter is
    given, and no converted entry is left over."""
    model.load_state_dict(sd, strict=True)
    return model


def _n_leaves(params) -> int:
    return len(jax.tree.leaves(params))


def test_mlp_matches_flax():
    jm = JaxMLP(hidden_layers=2, features=64)
    x = _images(8)
    params = drawn_params(jm, x[:1])
    sd = from_flax_mlp_params(params)
    assert len(sd) == _n_leaves(params)
    model = _load(MLP(2, 64, device="cpu"), sd)
    want = np.asarray(jm.apply({"params": params}, x))
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_convnet_eval_matches_flax():
    jm = JaxConvNet()
    x = _images(8)
    params = drawn_params(jm, x[:1])
    sd = from_flax_convnet_params(params)
    assert len(sd) == _n_leaves(params)
    model = _load(ConvNet(device="cpu"), sd)
    want = np.asarray(jm.apply({"params": params}, x))
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_convnet_flatten_order_non_square():
    """The flatten is flax's (h, w, c): at a 28 × 36 input the features
    are 4 × 6 × 20, and a (w, h, c) or (c, h, w) order would permute
    ``Dense_0``'s rows and miss flax's logits."""
    jm = JaxConvNet(width_mult=2)
    x = _images(4, hw=(28, 36))
    params = drawn_params(jm, x[:1], seed=3)
    assert params["Dense_0"]["kernel"].shape == (4 * 6 * 40, 100)
    model = _load(ConvNet(width_mult=2, input_hw=(28, 36), device="cpu"),
                  from_flax_convnet_params(params))
    want = np.asarray(jm.apply({"params": params}, x))
    np.testing.assert_allclose(
        model(torch.from_numpy(x)).detach().numpy(), want, **TOL)


def test_embedding_matches_flax():
    from tpudist.data.synthetic import ragged_embedding_batches

    jm = JaxEmbedding()
    idx, mask, _ = next(ragged_embedding_batches(1, batch=12, seed=5))
    params = drawn_params(jm, idx[:1], mask[:1])
    sd = from_flax_embedding_params(params)
    assert len(sd) == _n_leaves(params)
    model = _load(EmbeddingBagClassifier(device="cpu"), sd)
    want = np.asarray(jm.apply({"params": params}, idx, mask))
    got = model(torch.from_numpy(idx), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("which", ["mlp", "convnet"])
def test_bf16_compute_returns_f32_logits(which):
    x = torch.from_numpy(_images(8))
    g = torch.Generator().manual_seed(0)
    if which == "mlp":
        make = lambda dt: MLP(2, 64, compute_dtype=dt, device="cpu")
    else:
        make = lambda dt: ConvNet(compute_dtype=dt, device="cpu")
    ref = make(torch.float32).init_weights(g)
    low = make(torch.bfloat16)
    low.load_state_dict(ref.state_dict())
    want, got = ref(x).detach(), low(x).detach()
    assert got.dtype == torch.float32
    assert (got - want).abs().max() <= 5e-2 * want.abs().max()


@pytest.mark.parametrize("convert,flax_leaf", [
    (from_flax_mlp_params, {"Conv_0": {"kernel": np.zeros((1, 1))}}),
    (from_flax_convnet_params, {"Dense_0": {"scale": np.zeros((1,))}}),
    (from_flax_embedding_params, {"table": np.zeros((1, 1))}),
])
def test_converters_reject_unknown_leaves(convert, flax_leaf):
    with pytest.raises(ValueError, match="unexpected leaf"):
        convert(flax_leaf)


def test_dropout_is_flax_dropout_from_the_generator():
    """Kept with probability 1 - rate and scaled by 1 / (1 - rate), the
    mask a function of the generator's seed alone; training without a
    generator raises; evaluation draws nothing."""
    x = torch.ones(64, 256)
    y1 = flax_dropout(x, 0.5, torch.Generator().manual_seed(7))
    y2 = flax_dropout(x, 0.5, torch.Generator().manual_seed(7))
    assert torch.equal(y1, y2)
    assert set(torch.unique(y1).tolist()) == {0.0, 2.0}
    assert abs(float((y1 > 0).float().mean()) - 0.5) < 0.02
    y3 = flax_dropout(x, 0.5, torch.Generator().manual_seed(8))
    assert not torch.equal(y1, y3)
    model = ConvNet(device="cpu").init_weights(torch.Generator().manual_seed(0))
    imgs = torch.from_numpy(_images(4))
    with pytest.raises(ValueError, match="generator"):
        model(imgs, train=True)
    assert torch.equal(model(imgs), model(imgs, train=False,
                                          generator=torch.Generator()))
    a = model(imgs, train=True, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(a, model(imgs))


def test_init_weights_follows_flax_initialisers():
    g = torch.Generator().manual_seed(0)
    model = MLP(1, 512, device="cpu").init_weights(g)
    w = model.dense[1].weight.detach()
    assert float(w.std()) == pytest.approx(1 / np.sqrt(512), rel=0.05)
    assert float(w.abs().max()) <= 2 / np.sqrt(512) / 0.8796 + 1e-6
    assert not model.dense[1].bias.any()
    emb = EmbeddingBagClassifier(device="cpu").init_weights(g)
    assert float(emb.embedding.detach().std()) == pytest.approx(1.0, rel=0.1)


def test_models_need_a_device_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is usable")
    for make in (MLP, ConvNet, EmbeddingBagClassifier):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
