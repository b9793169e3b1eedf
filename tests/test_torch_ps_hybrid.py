"""tpudist_torch's parameter-server hybrid step against tpudist's, and the
collectives under autograd it stands on.

The port runs in 4 gloo ranks (``run_ranks``) on a ``data 2 × model 2``
mesh: each rank holds 50 of the table's 100 rows and the whole dense
layer; tpudist runs on the same mesh shape of conftest's virtual CPU
devices.  Both start from one flax ``EmbeddingBagClassifier`` tree
(``from_flax_embedding_params``) and take 3 SGD steps (lr 0.05) on
``ragged_embedding_batches``' stream, each data shard its half of the
global batch.  Tolerances (f32): losses within rtol 1e-5, parameters
within rtol 1e-4 + atol 1e-6 (tpudist's own test's); the forward within
rtol 1e-5 + atol 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_data_parallel import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, DIM, CLASSES, BATCH, STEPS, LR = 100, 16, 8, 16, 3, 0.05


def _batches():
    from tpudist_torch.data import ragged_embedding_batches

    return list(ragged_embedding_batches(STEPS, batch=BATCH, seed=3))


def _flax_params():
    import jax
    import jax.numpy as jnp

    from tpudist.models import EmbeddingBagClassifier

    idx, mask, _ = _batches()[0]
    model = EmbeddingBagClassifier(num_embeddings=ROWS, embedding_dim=DIM,
                                   num_classes=CLASSES)
    params = model.init(jax.random.key(0), jnp.asarray(idx),
                        jnp.asarray(mask))["params"]
    return jax.tree.map(np.asarray, params)


def _dense_apply(model, bag):
    from tpudist_torch.models.mlp import linear_as

    return linear_as(bag, model.fc, torch.float32).float()


def _ps_rank(rank, world, sd, batches):
    """3 steps and one forward on the data 2 × model 2 mesh; the common
    collectives' values and gradients; the refusals."""
    from tpudist_torch.models import EmbeddingBagClassifier
    from tpudist_torch.ops.losses import cross_entropy
    from tpudist_torch.parallel import common
    from tpudist_torch.parallel.ps_hybrid import (
        make_ps_hybrid_forward,
        make_ps_hybrid_train_step,
        ps_state_specs,
    )
    from tpudist_torch.runtime.mesh import data_model_mesh, local_block
    from tpudist_torch.train import TrainState, sgd

    mesh = data_model_mesh(2)
    model = EmbeddingBagClassifier(ROWS // 2, DIM, CLASSES, device="cpu")
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    sd["embedding"] = local_block(sd["embedding"], mesh, ("model",))
    model.load_state_dict(sd)
    state = TrainState.create(model, sgd(LR))
    step = make_ps_hybrid_train_step(_dense_apply, cross_entropy, mesh,
                                     state, num_embeddings=ROWS)
    fwd = make_ps_hybrid_forward(_dense_apply, mesh, state,
                                 num_embeddings=ROWS)

    def shard(a):
        return local_block(torch.from_numpy(a), mesh, ("data",))

    idx, mask, _ = batches[0]
    out = {"logits": fwd(model, shard(idx), shard(mask)).numpy()}
    losses = []
    for idx, mask, tgt in batches:
        state, m = step(state, shard(idx), shard(mask), shard(tgt))
        losses.append(float(m["loss"]))
    out["losses"] = losses
    out["params"] = {k: v.detach().numpy().copy()
                     for k, v in model.state_dict().items()}
    out["specs"] = ps_state_specs(state)["params"]

    group = mesh.get_group("model")
    mine = float(rank % 2 + 1)
    x = torch.full((3,), mine, requires_grad=True)
    coll = {}
    for name in ("psum", "psum_fwd_id_bwd", "id_fwd_psum_bwd"):
        x.grad = None
        y = getattr(common, name)(x, group)
        (y * mine).sum().backward()
        coll[name] = (y.detach().numpy().copy(), x.grad.numpy().copy())
    out["collectives"] = coll
    try:
        make_ps_hybrid_train_step(_dense_apply, cross_entropy, mesh, state,
                                  num_embeddings=101)
    except ValueError as e:
        out["rows_error"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from tpudist_torch.models.convert import from_flax_embedding_params

    sd = {k: v.numpy() for k, v in
          from_flax_embedding_params(_flax_params()).items()}
    return run_ranks(_ps_rank, 4, tmp_path_factory.mktemp("ps"), sd,
                     _batches())


@pytest.fixture(scope="module")
def jax_run():
    """tpudist's step and forward on a data 2 × model 2 mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpudist.ops.losses import cross_entropy
    from tpudist.parallel.ps_hybrid import (
        make_ps_hybrid_forward,
        make_ps_hybrid_train_step,
    )
    from tpudist.train.state import TrainState
    from tpudist_torch.models.convert import from_flax_embedding_params

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    params = jax.tree.map(jnp.asarray, _flax_params())

    def dense_apply(rest, bag):
        return (bag @ rest["fc"]["kernel"]
                + rest["fc"]["bias"]).astype(jnp.float32)

    state = TrainState.create(None, params, optax.sgd(LR))
    step = make_ps_hybrid_train_step(dense_apply, cross_entropy, mesh, state,
                                     num_embeddings=ROWS, donate=False)
    fwd = make_ps_hybrid_forward(dense_apply, mesh, params,
                                 num_embeddings=ROWS)
    idx, mask, _ = _batches()[0]
    logits = np.asarray(fwd(params, jnp.asarray(idx), jnp.asarray(mask)))
    losses = []
    for idx, mask, tgt in _batches():
        state, m = step(state, jnp.asarray(idx), jnp.asarray(mask),
                        jnp.asarray(tgt))
        losses.append(float(m["loss"]))
    sd = {k: v.numpy() for k, v in from_flax_embedding_params(
        jax.tree.map(np.asarray, state.params)).items()}
    return {"losses": losses, "params": sd, "logits": logits}


def test_losses_match_tpudist(ranks, jax_run):
    for res in ranks:
        np.testing.assert_allclose(res["losses"], jax_run["losses"],
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["embedding", "fc.weight", "fc.bias"])
def test_params_match_tpudist(ranks, jax_run, name):
    want = jax_run["params"][name]
    if name == "embedding":
        got = np.concatenate([ranks[0]["params"][name],
                              ranks[1]["params"][name]])
        np.testing.assert_array_equal(ranks[2]["params"][name],
                                      ranks[0]["params"][name])
    else:
        got = ranks[0]["params"][name]
        for res in ranks[1:]:
            np.testing.assert_array_equal(res["params"][name], got)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_forward_matches_tpudist(ranks, jax_run):
    for r, res in enumerate(ranks):
        half = jax_run["logits"][(r // 2) * 8:(r // 2 + 1) * 8]
        np.testing.assert_allclose(res["logits"], half, rtol=1e-5,
                                   atol=1e-6)


def test_table_actually_sharded(ranks):
    for res in ranks:
        assert res["params"]["embedding"].shape == (ROWS // 2, DIM)
        assert res["specs"] == {"embedding": ("model",), "fc.weight": (),
                                "fc.bias": ()}


@pytest.mark.parametrize("name,value,grad", [
    ("psum", 3.0, 3.0),              # the VJP of an all-reduce: all-reduce
    ("psum_fwd_id_bwd", 3.0, None),  # identity VJP: the rank's own seed
    ("id_fwd_psum_bwd", None, 3.0),
])
def test_collectives_under_autograd(ranks, name, value, grad):
    """Model groups {0, 1} and {2, 3}: the group's first rank holds 1,
    its second 2, and each seeds its output's cotangent with its own
    value."""
    for r, res in enumerate(ranks):
        y, g = res["collectives"][name]
        mine = r % 2 + 1
        np.testing.assert_array_equal(y, value if value is not None
                                      else mine)
        np.testing.assert_array_equal(g, grad if grad is not None
                                      else mine)


def test_rows_must_divide_by_model(ranks):
    for res in ranks:
        assert "101 embedding rows not divisible by model=2" \
            in res["rows_error"]


def test_virtual_shards_match_whole_table():
    """The per-shard gather of two virtual model shards, summed, against
    the whole-table lookup (the model's own); one shard through
    sharded_bag_lookup without a mesh is the whole lookup."""
    from tpudist_torch.models import EmbeddingBagClassifier
    from tpudist_torch.parallel.ps_hybrid import (
        _bag_contrib,
        sharded_bag_lookup,
    )

    model = EmbeddingBagClassifier(ROWS, DIM, CLASSES, device="cpu")
    model.init_weights(torch.Generator().manual_seed(1))
    idx, mask, _ = (torch.from_numpy(a) for a in _batches()[0])
    table = model.embedding.detach()
    want = torch.einsum("blh,bl->bh", table[idx.long()], mask)
    got = sum(_bag_contrib(part, idx, mask, s)
              for s, part in enumerate(table.chunk(2)))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sharded_bag_lookup(table, idx, mask), want,
                               rtol=0, atol=0)


def test_server_model_data_parallel_twin():
    """examples/server_model_data_parallel_gpu.py under torchrun, 4 gloo
    processes (data 2 × model 2), 3 epochs."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4",
         os.path.join(REPO, "examples", "server_model_data_parallel_gpu.py"),
         "--device", "cpu", "--epochs", "3", "--log-every", "1"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("Training done for epoch")]
    assert len(lines) == 3
    loss = float(lines[-1].rsplit(" ", 1)[1])
    assert np.isfinite(loss) and loss < 5.0
