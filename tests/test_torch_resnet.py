"""tpudist_torch's ResNet50 against the JAX package's
(:mod:`tpudist.models.resnet`), weights carried by
``from_flax_resnet_params``, in f32 on the same seeded numpy inputs.

* A ``ResNetSegment`` with the stem, layer1 and layer2's stride-2
  projection block at their real widths (batch 2, 16 px: the stride-2 3×3
  conv sees an even input, where flax's ``"SAME"`` pads (0, 1)): the loss
  and every gradient of one SGD step through ``make_dp_train_step``
  within tpudist's own 5e-4 (``tests/test_group_norm.py``), and the
  parameters after the step.
* The whole ResNet50 at 32 px: logits within 1e-4 (50 layers of f32 sums
  in other orders), every flax leaf converted exactly once.
* The two-stage split of ``tests/test_models.py``, its parameter trees
  loaded strictly from tpudist's.
* ``norm="group_flax"`` and ``"batch_local"`` at batch 8, 64 px:
  tpudist's logits, and BatchNorm's running statistics.

Parameters are drawn with numpy into the tree ``jax.eval_shape`` gives
(no JAX init pass), so the file stays well under a minute.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from tpudist_torch.models import resnet as tr
from tpudist_torch.models.convert import _flatten, from_flax_resnet_params

TOL = dict(rtol=5e-4, atol=5e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BN_TOL = dict(rtol=2e-3, atol=2e-3)
LR = 0.05


@pytest.fixture(scope="module")
def jres():
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    return importlib.import_module("tpudist.models.resnet")


def _random_variables(module, x, seed):
    """The module's variables as numpy, drawn from ``seed``: kernels
    normal with std 1/sqrt(fan_in), norm scales near 1, biases and
    running means near 0, running variances near 1."""
    import jax

    shapes = jax.eval_shape(module.init, jax.random.key(0), x)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = {"scale": 1.0, "var": 1.0}.get(name, 0.0)
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images(batch, hw, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, hw, hw, 3)).astype(np.float32)


def _port(module, variables):
    module.load_state_dict(from_flax_resnet_params(
        variables["params"], variables.get("batch_stats")))
    return module


def test_segment_sgd_step_matches_jax(jres):
    """Stem + layer1 + layer2's first block (stride 2, projection), batch
    2 at 16 px, f32: one SGD step of mean(out²)."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpudist.parallel.data_parallel import make_dp_train_step as jstep
    from tpudist.train.state import TrainState as JState
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, sgd

    plan = tr._block_plan()[:4]
    assert plan[-1].strides == 2
    jmod = jres.ResNetSegment(blocks=tuple(jres._block_plan()[:4]),
                              with_stem=True, compute_dtype=jnp.float32)
    x = _images(2, 16)
    v = _random_variables(jmod, jnp.asarray(x), seed=1)

    def jloss(p, batch, _rng):
        out = jmod.apply({"params": p}, batch[0])
        return jnp.mean(jnp.square(out)), {}

    (want_loss, _), want_g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(v["params"], (jnp.asarray(x),), None)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    state = JState.create(jmod.apply, v["params"], optax.sgd(LR))
    state, _ = jstep(jloss, mesh)(state, jnp.asarray(x))

    port = _port(tr.ResNetSegment(plan, with_stem=True,
                                  compute_dtype=torch.float32,
                                  device="cpu"), v)

    def loss_fn(m, batch, _gen):
        return m(batch[0]).square().mean(), {}

    tstate = TrainState.create(port, sgd(LR))
    tstate, metrics = make_dp_train_step(loss_fn)(tstate, torch.from_numpy(x))
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss),
                               rtol=1e-5)
    want = from_flax_resnet_params(jax.tree.map(np.asarray, want_g))
    after = from_flax_resnet_params(jax.tree.map(np.asarray, state.params))
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert set(grads) == set(want)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(grads[name].numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   err_msg=name, **TOL)


def test_resnet50_forward_and_converter(jres):
    """The whole network at 32 px, batch 1, 1000 classes: logits, and
    each flax leaf mapped to one port name, the names being exactly the
    port's."""
    import jax
    import jax.numpy as jnp

    jmod = jres.ResNet50(compute_dtype=jnp.float32)
    x = _images(1, 32, seed=2)
    v = _random_variables(jmod, jnp.asarray(x), seed=2)
    want = jax.jit(jmod.apply)(v, jnp.asarray(x))
    sd = from_flax_resnet_params(v["params"])
    assert len(sd) == len(_flatten(v["params"]))
    port = tr.ResNet50(compute_dtype=torch.float32, device="cpu")
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (1, 1000)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    with pytest.raises(ValueError, match="unexpected ResNet leaf"):
        from_flax_resnet_params({**v["params"], "Extra_0": {"Conv_0": {
            "kernel": np.zeros((1, 1, 1, 1), np.float32)}}})


def test_stage_split_matches_tpudist(jres):
    """``tests/test_models.py``'s split: 3+4 blocks with the stem, 6+3
    with the head, the layer2 output at 64 px, f32 logits; each stage
    loads tpudist's stage tree strictly."""
    import jax
    import jax.numpy as jnp

    stages = tr.resnet50_stages(2, num_classes=13, device="cpu")
    jstages = jres.resnet50_stages(2, num_classes=13)
    assert len(stages) == 2
    assert len(stages[0].blocks) == 7 and stages[0].stem is not None
    assert len(stages[1].blocks) == 9 and stages[1].head is not None
    x = torch.zeros(2, 64, 64, 3)
    h = stages[0](x)
    assert h.shape == (2, 8, 8, 512)
    logits = stages[1](h)
    assert logits.shape == (2, 13) and logits.dtype == torch.float32
    inputs = (jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 8, 8, 512)))
    for port, jstage, inp in zip(stages, jstages, inputs):
        shapes = jax.eval_shape(jstage.init, jax.random.key(0), inp)
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                             shapes["params"])
        port.load_state_dict(from_flax_resnet_params(zeros))   # strict
    assert [len(s.blocks) for s in tr.resnet50_stages(4, device="cpu")] == \
        [len(s.blocks) for s in jres.resnet50_stages(4)]


@pytest.mark.parametrize("norm", ["group_flax", "batch_local"])
def test_norm_variants_match_jax(jres, norm):
    """ResNet50 at 64 px, batch 8, 10 classes: tpudist's logits, and for
    BatchNorm its running statistics after the call.  GroupNorm within
    1e-4; BatchNorm within BN_TOL, because XLA's f32 mean over B·H·W on
    the CPU is the less exact side (over the stem's 8×32×32 values it is
    8.6e-6 from the f64 mean, torch's 4.9e-7) and sixteen blocks of batch
    statistics carry that forward (the gap grows block by block, from
    1.4e-4 after the first)."""
    import jax
    import jax.numpy as jnp

    jmod = jres.ResNet50(num_classes=10, norm=norm,
                         compute_dtype=jnp.float32)
    x = _images(8, 64, seed=3)
    v = _random_variables(jmod, jnp.asarray(x), seed=3)
    port = _port(tr.ResNet50(num_classes=10, norm=norm,
                             compute_dtype=torch.float32, device="cpu"), v)
    got = port(torch.from_numpy(x))
    if "batch_stats" in v:
        want, upd = jax.jit(functools.partial(
            jmod.apply, mutable=["batch_stats"]))(v, jnp.asarray(x))
        stats = from_flax_resnet_params({}, jax.tree.map(
            np.asarray, upd["batch_stats"]))
        buffers = dict(port.named_buffers())
        assert set(stats) == set(buffers)
        for name, t in stats.items():
            np.testing.assert_allclose(buffers[name].numpy(), t.numpy(),
                                       err_msg=name, **BN_TOL)
    else:
        want = jax.jit(jmod.apply)(v, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(BN_TOL if "batch" in norm else LOGIT_TOL))


def test_same_padding_per_side():
    """flax's SAME: the odd pixel after; a stride-2 3×3 conv at an even
    input pads (0, 1), at an odd input (1, 1); a 1×1 stride-2 conv pads
    nothing."""
    assert tr._same_pads(32, 3, 2) == (0, 1)
    assert tr._same_pads(33, 3, 2) == (1, 1)
    assert tr._same_pads(32, 3, 1) == (1, 1)
    assert tr._same_pads(32, 1, 2) == (0, 0)
    conv = tr.Conv(4, 8, 3, 2, compute_dtype=torch.float32, device="cpu")
    with torch.no_grad():
        conv.weight.normal_()
    x = torch.randn(1, 6, 6, 4)
    y = conv(x)
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1)),
        conv.weight, stride=2).permute(0, 2, 3, 1)
    assert y.shape == (1, 3, 3, 8)
    torch.testing.assert_close(y, want)
