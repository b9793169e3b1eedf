"""tpudist_torch's losses against the JAX package's, on the same seeded
numpy inputs.  Tolerance (f32): atol = rtol = 1e-6 — both compute a
stable log-softmax in f32 and differ only in summation order."""

import numpy as np
import pytest
import torch

from tpudist_torch.ops import losses as tl

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def jl():
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    from tpudist.ops import losses
    return losses


def _data(seed, lead, classes):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((*lead, classes))).astype(np.float32)
    labels = rng.integers(0, classes, lead).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("name", ["cross_entropy", "cross_entropy_per_token",
                                  "nll_loss", "accuracy"])
@pytest.mark.parametrize("lead", [(12,), (3, 7)], ids=["rows", "sequences"])
def test_label_losses_match_jax(jl, name, lead):
    import jax.numpy as jnp

    logits, labels = _data(len(lead), lead, 11)
    want = np.asarray(getattr(jl, name)(jnp.asarray(logits),
                                        jnp.asarray(labels)))
    got = getattr(tl, name)(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_log_softmax_and_mse_match_jax(jl):
    import jax.numpy as jnp

    logits, _ = _data(4, (5, 9), 13)
    np.testing.assert_allclose(
        tl.log_softmax(torch.from_numpy(logits)).numpy(),
        np.asarray(jl.log_softmax(jnp.asarray(logits))), **TOL)
    target = np.random.default_rng(5).standard_normal((5, 9, 13))
    np.testing.assert_allclose(
        tl.mse_loss(torch.from_numpy(logits),
                    torch.from_numpy(target)).numpy(),
        np.asarray(jl.mse_loss(jnp.asarray(logits), jnp.asarray(target))),
        **TOL)


def test_bf16_logits_are_upcast():
    logits, labels = _data(6, (4, 5), 7)
    lo = torch.from_numpy(logits)
    got = tl.cross_entropy(lo.bfloat16(), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    want = tl.cross_entropy(lo.bfloat16().float(), torch.from_numpy(labels))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cross_entropy_gradient_is_softmax_minus_onehot():
    logits, labels = _data(7, (6,), 5)
    lo = torch.from_numpy(logits).requires_grad_()
    tl.cross_entropy(lo, torch.from_numpy(labels)).backward()
    want = (torch.softmax(lo.detach(), -1)
            - torch.nn.functional.one_hot(torch.from_numpy(labels).long(),
                                          5)) / 6
    torch.testing.assert_close(lo.grad, want, **TOL)


def test_mismatched_shapes_raise():
    logits = torch.zeros(2, 3, 5)
    with pytest.raises(ValueError, match="trailing class axis"):
        tl.cross_entropy_per_token(logits, torch.zeros(2, dtype=torch.long))
    with pytest.raises(ValueError, match="trailing class axis"):
        tl.cross_entropy(logits, torch.zeros(3, 2, dtype=torch.long))
