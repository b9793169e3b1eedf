"""The port's pipeline schedule tables against tpudist's, field for field.

tpudist_torch keeps its own copy of the tables (pure Python and numpy,
no JAX): the 1F1B tables (plain and interleaved, canonical and greedy),
the canonical Megatron op order and the interleaved GPipe table, over a
grid of (P, V, M) that holds M % P != 0 and V > 1.  The bubble fractions
the port's steps report are tpudist's formulas over the same tables, and
``interleave_params`` permutes as tpudist's does.
"""

import dataclasses

import numpy as np
import pytest

from tpudist_torch.parallel import pipeline as port

GRID = [(P, V, M) for P in (1, 2, 3, 4) for V in (1, 2, 3)
        for M in (1, 2, 4, 5, 8) if not (V > 1 and M < 2)]


def _same(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("P,V,M", GRID)
def test_one_f_one_b_tables(P, V, M):
    from tpudist.parallel import pipeline as ref

    _same(port._one_f_one_b_schedule(P, M, V),
          ref._one_f_one_b_schedule(P, M, V))


@pytest.mark.parametrize("P,V,M", GRID)
def test_interleave_tables(P, V, M):
    from tpudist.parallel import pipeline as ref

    _same(port._interleave_schedule(P, V, M),
          ref._interleave_schedule(P, V, M))


@pytest.mark.parametrize("P,V,M", [(2, 2, 4), (4, 2, 8), (4, 4, 8),
                                   (3, 2, 6), (8, 2, 16)])
def test_canonical_interleaved_order(P, V, M):
    from tpudist.parallel import pipeline as ref

    assert port._canonical_interleaved_order(P, V, M) \
        == ref._canonical_interleaved_order(P, V, M)


def test_gpipe_is_the_one_chunk_interleave():
    """GPipe's fill-drain, as the port walks it: stage p runs micro-batch
    t − p at tick t, over M + P − 1 ticks."""
    for P, M in [(2, 4), (4, 2), (3, 7)]:
        s = port._interleave_schedule(P, 1, M)
        assert s.T == M + P - 1
        for t in range(s.T):
            for p in range(P):
                m = t - p
                want = m if 0 <= m < M else -1
                assert s.exec_m[t, p] == want


@pytest.mark.parametrize("P,V,M", [(2, 1, 4), (2, 2, 4), (4, 2, 8),
                                   (3, 1, 7), (4, 2, 6)])
def test_bubble_fractions(P, V, M):
    """The steps' ``bubble_fraction`` against tpudist's steps' on a stage
    mesh of P fake devices."""
    import jax
    import optax

    from tpudist.ops.losses import mse_loss
    from tpudist.parallel import pipeline as ref
    from tpudist.train.state import TrainState as JState
    from tpudist_torch.ops.losses import mse_loss as port_mse
    from tpudist_torch.train import TrainState, sgd

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:P]), ("stage",))
    tree = {"w": np.zeros((P * V, 2, 2), np.float32)}
    jstate = JState.create(None, tree, optax.sgd(0.1))
    state = TrainState.create(port.ParamTree(tree, device="cpu"), sgd(0.1))

    def block(p, x):
        return x

    pairs = [(port.make_1f1b_pipeline_train_step(
                block, port_mse, None, M, state, virtual_stages=V,
                local_stages=P),
              ref.make_1f1b_pipeline_train_step(
                block, mse_loss, mesh, M, jstate, data_axis="stage",
                virtual_stages=V))]
    if V > 1:
        pairs.append((port.make_interleaved_pipeline_train_step(
                          block, port_mse, None, M, V, state,
                          local_stages=P),
                      ref.make_interleaved_pipeline_train_step(
                          block, mse_loss, mesh, M, V, jstate,
                          data_axis="stage")))
    else:
        pairs.append((port.make_stacked_pipeline_train_step(
                          block, port_mse, None, M, state, local_stages=P),
                      ref.make_stacked_pipeline_train_step(
                          block, mse_loss, mesh, M, jstate,
                          data_axis="stage")))
    for mine, theirs in pairs:
        assert mine.bubble_fraction == theirs.bubble_fraction


def test_interleave_params_matches_tpudist():
    from tpudist.parallel import pipeline as ref

    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((6, 3)), "scalar": np.float32(2.0),
            "other": rng.standard_normal((5, 2))}
    got = port.interleave_params(tree, 3, 2)
    want = ref.interleave_params(tree, 3, 2)
    for k in tree:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))
