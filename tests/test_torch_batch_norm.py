"""tpudist_torch's BatchNorm against the JAX package's
(:mod:`tpudist.ops.batch_norm`), on the same seeded numpy inputs.

Forward within 1e-5, gradients within 1e-4 (the same closed form, sums in
other orders), running statistics within 1e-5.  Synchronised BatchNorm
over 2 gloo ranks (``run_ranks``) equals one process on the whole batch,
as ``tests/test_batch_norm.py`` holds tpudist's pmapped one: outputs,
the input's gradient and the summed parameter gradients.  JAX is imported
inside a fixture; the ranks never import it.
"""

import importlib

import numpy as np
import pytest
import torch

from tests.test_torch_data_parallel import run_ranks
from tpudist_torch.ops import batch_norm as tb

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jbn():
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    return importlib.import_module("tpudist.ops.batch_norm")


def _data(seed=0, shape=(4, 6, 5, 16)):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def test_batch_norm_train_matches_jax(jbn):
    import jax
    import jax.numpy as jnp

    x, scale, bias = _data()
    jargs = [jnp.asarray(a) for a in (x, scale, bias)]
    want, wmean, wvar = jbn.batch_norm_train(*jargs)
    gwant = jax.grad(lambda *a: jnp.sum(jnp.tanh(jbn.batch_norm_train(*a)[0])),
                     argnums=(0, 1, 2))(*jargs)
    xt, st, bt = (torch.from_numpy(a).requires_grad_()
                  for a in (x, scale, bias))
    got, mean, var = tb.batch_norm_train(xt, st, bt)
    assert not mean.requires_grad and not var.requires_grad
    for a, w in ((got, want), (mean, wmean), (var, wvar)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   **FWD_TOL)
    torch.tanh(got).sum().backward()
    for t, w, name in zip((xt, st, bt), gwant, ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)


def test_module_matches_jax_stats_and_eval(jbn):
    """Same param and buffer names and shapes as tpudist's ``params`` and
    ``batch_stats``, the same momentum update over two calls, and the same
    eval-mode output from the running statistics."""
    import jax
    import jax.numpy as jnp

    x, scale, bias = _data(1)
    x2 = _data(2)[0]
    mod = jbn.BatchNorm(use_running_average=False, momentum=0.9)
    v = mod.init(jax.random.key(0), jnp.asarray(x))
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": v["batch_stats"]}
    stats = v["batch_stats"]
    for batch in (x, x2):
        want, upd = mod.apply({**v, "batch_stats": stats}, jnp.asarray(batch),
                              mutable=["batch_stats"])
        stats = upd["batch_stats"]
    port = tb.BatchNorm(16, momentum=0.9, device="cpu")
    assert {k: tuple(t.shape) for k, t in port.state_dict().items()} == {
        **{k: a.shape for k, a in v["params"].items()},
        **{k: a.shape for k, a in v["batch_stats"].items()}}
    port.load_state_dict({"scale": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias),
                          "mean": torch.zeros(16), "var": torch.ones(16)})
    for batch in (x, x2):
        got = port(torch.from_numpy(batch))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, k).numpy(),
                                   np.asarray(stats[k]), **FWD_TOL)
    ev = jbn.BatchNorm(use_running_average=True).apply(
        {"params": v["params"], "batch_stats": stats}, jnp.asarray(x))
    port.use_running_average = True
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ev), **FWD_TOL)


def test_module_dtype_and_local_branch_in_one_process():
    """``axis_name`` with no process group is the local branch; ``dtype``
    casts the output."""
    x, _, _ = _data(3)
    xt = torch.from_numpy(x)
    synced = tb.BatchNorm(16, axis_name="data", dtype=torch.bfloat16,
                          device="cpu")
    local = tb.BatchNorm(16, dtype=torch.bfloat16, device="cpu")
    a, b = synced(xt), local(xt)
    assert a.dtype == torch.bfloat16
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(synced.var, local.var, rtol=0, atol=0)


def _sync_rank(rank, world, x, scale, bias):
    """BatchNorm(axis_name="data") on this rank's half of ``x``: outputs,
    gradients of ``sum(tanh(y))`` and the running statistics."""
    torch.manual_seed(0)
    mod = tb.BatchNorm(x.shape[-1], axis_name="data", device="cpu")
    mod.load_state_dict({"scale": torch.from_numpy(scale),
                         "bias": torch.from_numpy(bias),
                         "mean": torch.zeros(x.shape[-1]),
                         "var": torch.ones(x.shape[-1])})
    half = x.shape[0] // world
    xt = torch.from_numpy(x[rank * half:(rank + 1) * half].copy())
    xt.requires_grad_()
    y = mod(xt)
    torch.tanh(y).sum().backward()
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dscale": mod.scale.grad.numpy(), "dbias": mod.bias.grad.numpy(),
            "mean": mod.mean.numpy(), "var": mod.var.numpy()}


def test_sync_batch_norm_two_ranks_equals_whole_batch(jbn, tmp_path):
    import jax.numpy as jnp

    x, scale, bias = _data(2, shape=(8, 4, 4, 8))
    ranks = run_ranks(_sync_rank, 2, tmp_path, x, scale, bias)
    whole = tb.BatchNorm(8, device="cpu")
    whole.load_state_dict({"scale": torch.from_numpy(scale),
                           "bias": torch.from_numpy(bias),
                           "mean": torch.zeros(8), "var": torch.ones(8)})
    xt = torch.from_numpy(x).requires_grad_()
    y = whole(xt)
    torch.tanh(y).sum().backward()
    want_y = np.asarray(jbn.batch_norm_train(
        *(jnp.asarray(a) for a in (x, scale, bias)))[0])
    np.testing.assert_allclose(y.detach().numpy(), want_y, **FWD_TOL)
    np.testing.assert_allclose(
        np.concatenate([r["y"] for r in ranks]), want_y, **FWD_TOL)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks]),
                               xt.grad.numpy(), **GRAD_TOL)
    for k, want in (("dscale", whole.scale.grad), ("dbias", whole.bias.grad)):
        np.testing.assert_allclose(ranks[0][k] + ranks[1][k], want.numpy(),
                                   **GRAD_TOL)
    for r in ranks:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r[k], getattr(whole, k).numpy(),
                                       **FWD_TOL)
