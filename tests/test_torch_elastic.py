"""The port's elastic state and loop (``tpudist_torch.elastic``): twins of
``tests/test_elastic.py``'s eight cases on the port's ``TrainState``, the
optimizer state made as optax's ``init`` makes it, ``adamw`` against
``optax.adamw``, and the worker's refusals (no CUDA, an unknown data plane)."""

import numpy as np
import pytest
import torch
from torch import nn

from tpudist_torch.elastic import (
    Checkpointer,
    ElasticState,
    HostDataState,
    WorkerFailure,
    WorldChanged,
    elastic_run,
)
from tpudist_torch.elastic.state import load_state_tree, state_tree
from tpudist_torch.train.state import (
    TrainState,
    adam,
    adamw,
    init_optimizer_state,
    sgd,
)

ADAMW_RTOL = 1e-6


class _W(nn.Module):
    def __init__(self, seed):
        super().__init__()
        self.w = nn.Parameter(torch.arange(4.0) + seed)


def _train_state(seed=0, opt=None):
    return TrainState.create(_W(seed), opt or sgd(0.1), seed=seed)


def _bump(state: TrainState) -> TrainState:
    state.model.w.grad = torch.ones(4)
    return state.apply_gradients()


class TestCommitRollback:
    def test_rollback_restores_exact_state(self):
        es = ElasticState(_train_state())
        w0 = es.state.model.w.detach().clone()
        es.state = _bump(es.state)
        es.host.epoch = 3
        es.rollback()
        assert torch.equal(es.state.model.w.detach(), w0)
        assert es.host.epoch == 0
        assert es.state.step == 0

    def test_commit_moves_restore_point(self):
        es = ElasticState(_train_state())
        es.state = _bump(es.state)
        es.host = HostDataState(epoch=1, batch=30)
        es.commit()
        es.state = _bump(es.state)
        es.rollback()
        assert es.host == HostDataState(epoch=1, batch=30)
        assert es.state.step == 1

    def test_commit_is_snapshot_not_alias(self):
        """The optimizer updates its tensors in place: a commit must copy."""
        es = ElasticState(_train_state(opt=adam(0.1)))
        committed = {k: v.copy() for k, v in
                     es._committed_state["opt_state"][0].items()}
        w = es._committed_state["params"]["w"].copy()
        es.state = _bump(es.state)
        np.testing.assert_array_equal(es._committed_state["params"]["w"], w)
        for k, v in committed.items():
            np.testing.assert_array_equal(
                es._committed_state["opt_state"][0][k], v)

    def test_durable_commit(self, tmp_path):
        ckpt = Checkpointer(tmp_path)
        es = ElasticState(_train_state(), checkpointer=ckpt)
        es.state = _bump(es.state)
        es.commit()
        restored = ckpt.restore_latest(state_tree(es.state))
        assert restored is not None
        step, tree, meta = restored
        assert step == 1
        assert meta["epoch"] == 0 and "world_size" in meta


class TestElasticRun:
    def test_world_change_triggers_reset_callback(self):
        es = ElasticState(_train_state(), world_size=4)
        seen = []
        es.register_reset_callbacks([lambda s, old, new: seen.append((old, new))])

        attempts = []

        def train(state):
            attempts.append(1)
            if len(attempts) == 1:
                state.state = _bump(state.state)
                raise WorldChanged(2)

        elastic_run(train, es)
        assert seen == [(4, 2)]
        assert es.world_size == 2
        assert es.state.step == 0  # rolled back
        assert len(attempts) == 2

    def test_worker_failure_rolls_back_without_resize(self):
        es = ElasticState(_train_state(), world_size=4)
        attempts = []

        def train(state):
            attempts.append(1)
            if len(attempts) < 3:
                raise WorkerFailure("chip lost")

        elastic_run(train, es)
        assert es.world_size == 4
        assert len(attempts) == 3

    def test_max_restarts(self):
        es = ElasticState(_train_state())

        def always_fail(state):
            raise WorkerFailure("boom")

        with pytest.raises(WorkerFailure):
            elastic_run(always_fail, es, max_restarts=2)

    def test_resume_from_committed_position(self):
        """5 epochs x 4 batches, commits every 2 batches, a fault at
        (epoch 2, batch 1): only the last commit's window is replayed and
        the final step count is exact."""
        es = ElasticState(_train_state())
        processed = []
        fault = {"armed": True}

        def train(state: ElasticState):
            for epoch in range(state.host.epoch, 5):
                start = state.host.batch if epoch == state.host.epoch else 0
                for batch in range(start, 4):
                    if fault["armed"] and (epoch, batch) == (2, 1):
                        fault["armed"] = False
                        raise WorkerFailure("injected")
                    state.state = _bump(state.state)
                    processed.append((epoch, batch))
                    if (batch + 1) % 2 == 0:
                        state.host = HostDataState(epoch=epoch, batch=batch + 1)
                        state.commit()
                state.host = HostDataState(epoch=epoch + 1, batch=0)

        elastic_run(train, es)
        assert set(processed) == {(e, b) for e in range(5) for b in range(4)}
        replayed = [p for p in set(processed) if processed.count(p) > 1]
        assert replayed == [(2, 0)]
        assert es.state.step == 20


# ---- the port's own contracts ------------------------------------------


def _mlp(device="cpu"):
    from tpudist_torch.models import MLP

    model = MLP(hidden_layers=1, features=16, device=device)
    return model.init_weights(torch.Generator().manual_seed(0))


def test_rollback_restores_adam_state_lr_and_counters_bitwise():
    """Parameters, Adam's moments and count, the lr a reset callback
    changed, the step and the host position all come back bit for bit."""
    es = ElasticState(TrainState.create(_mlp(), adamw(1e-2), seed=3))
    es.register_reset_callbacks([lambda s, old, new: s.state.optimizer
                                 .param_groups[0].update(lr=1e-2 * new / old)])
    x = torch.randn(8, 784, generator=torch.Generator().manual_seed(1))
    for _ in range(3):
        es.state.model(x).square().mean().backward()
        es.state.apply_gradients()
        es.state.model.zero_grad()
    es.host = HostDataState(epoch=2, batch=7)
    es.commit()
    want = state_tree(es.state)
    want = {"params": {k: v.clone() for k, v in want["params"].items()},
            "opt": {i: {k: v.clone() for k, v in s.items()}
                    for i, s in want["opt_state"].items()}}
    es.state.model(x).sum().backward()
    es.state.apply_gradients()
    es.host.batch = 9
    es.on_world_change(2)          # rollback, then the callback: lr x 2
    assert es.state.step == 3 and es.host == HostDataState(2, 7)
    assert es.state.optimizer.param_groups[0]["lr"] == 2e-2
    got = state_tree(es.state)
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    for i, s in want["opt"].items():
        for k, v in s.items():
            assert torch.equal(got["opt_state"][i][k], v), (i, k)
    es.rollback()                   # the lr is in the commit too
    assert es.state.optimizer.param_groups[0]["lr"] == 1e-2


def test_load_state_tree_keeps_the_optimizer_bound_to_the_parameters():
    """A load writes into the live tensors: the optimizer still steps
    the model's own parameters afterwards."""
    ts = TrainState.create(_mlp(), adam(1e-2))
    es = ElasticState(ts)
    other = ElasticState(TrainState.create(
        _mlp().init_weights(torch.Generator().manual_seed(5)), adam(1e-2)))
    load_state_tree(ts, other._committed_state)
    p = next(ts.model.parameters())
    assert p is ts.optimizer.param_groups[0]["params"][0]
    before = p.detach().clone()
    p.grad = torch.ones_like(p)
    ts.apply_gradients()
    assert not torch.equal(p.detach(), before)
    assert es.state is ts


@pytest.mark.parametrize("factory", [adam(1e-2), adamw(1e-2), sgd(0.1, 0.9),
                                     sgd(0.1)], ids=["adam", "adamw",
                                                     "sgd_momentum", "sgd"])
def test_init_optimizer_state_leaves_the_first_step_unchanged(factory):
    """Made state equals what the first step would make: the step from it
    is the lazy first step bit for bit, and making it moves nothing."""
    x = torch.randn(8, 784, generator=torch.Generator().manual_seed(1))

    def one_step(init):
        model = _mlp()
        opt = factory(model.parameters())
        if init:
            before = [p.detach().clone() for p in model.parameters()]
            init_optimizer_state(opt)
            assert all(torch.equal(a, p.detach())
                       for a, p in zip(before, model.parameters()))
            for s in opt.state.values():
                assert all(float(v.abs().sum()) == 0 for v in s.values())
        model(x).square().mean().backward()
        opt.step()
        return [p.detach().clone() for p in model.parameters()], opt

    lazy, lazy_opt = one_step(False)
    made, made_opt = one_step(True)
    assert all(torch.equal(a, b) for a, b in zip(lazy, made))
    assert len(lazy_opt.state) == len(made_opt.state)


def test_init_optimizer_state_refuses_an_unknown_optimizer():
    opt = torch.optim.RMSprop(_mlp().parameters())
    with pytest.raises(NotImplementedError, match="RMSprop"):
        init_optimizer_state(opt)


def test_adamw_matches_optax_adamw():
    """Five steps of ``adamw(lr)`` on flax-initialised MLP weights against
    ``optax.adamw(lr)`` on the same gradients: every element within
    ADAMW_RTOL of its tensor's largest magnitude.  optax runs in float64
    here: in float32 it computes the bias correction ``1 - 0.999**t`` in
    f32, whose cancellation alone moves its update by ~1e-5 relative
    (torch computes that scalar in f64), so the f64 run is the function
    both compute; an element-wise rtol is meaningless where an update
    cancels a weight to ~0."""
    import jax
    import optax

    from tpudist.models import MLP as FlaxMLP
    from tpudist_torch.models import MLP, from_flax_mlp_params

    lr = 1e-2
    params = jax.tree.map(np.asarray, FlaxMLP(hidden_layers=1, features=32)
                          .init(jax.random.key(0),
                                np.zeros((1, 784), np.float32))["params"])
    model = MLP(hidden_layers=1, features=32, device="cpu")
    model.load_state_dict(from_flax_mlp_params(params))
    opt = adamw(lr)(model.parameters())
    rng = np.random.default_rng(0)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda x: x.astype(np.float64), params)
        tx = optax.adamw(lr)
        opt_state = tx.init(p64)
        for _ in range(5):
            grads = jax.tree.map(
                lambda p: rng.standard_normal(p.shape).astype(np.float32),
                params)
            updates, opt_state = tx.update(
                jax.tree.map(lambda g: g.astype(np.float64), grads),
                opt_state, p64)
            p64 = jax.tree.map(np.asarray, optax.apply_updates(p64, updates))
            for name, g in from_flax_mlp_params(grads).items():
                model.get_parameter(name).grad = g
            opt.step()
            want = from_flax_mlp_params(p64)
            for name, p in model.named_parameters():
                w = want[name].numpy()
                err = np.max(np.abs(p.detach().numpy() - w)) / np.max(
                    np.abs(w))
                assert err <= ADAMW_RTOL, (name, err)


def test_worker_device_needs_cuda_unless_told(monkeypatch):
    from tpudist_torch.elastic.worker import worker_device

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is usable")
    monkeypatch.delenv("TPUDIST_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        worker_device()
    monkeypatch.setenv("TPUDIST_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        worker_device()
    assert worker_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("TPUDIST_DEVICE", "cpu")
    assert worker_device() == torch.device("cpu")


def test_context_host_plane_defaults():
    """tests/test_ici_unit.py's TestElasticContextDefaults: no group on
    the host plane."""
    from tpudist_torch.elastic.worker import ElasticContext

    ctx = ElasticContext(0, 1, 0, None, None)
    assert ctx.mesh is None and ctx.data_plane == "host"


def test_unknown_data_plane_rejected():
    from tpudist_torch.elastic.worker import run_elastic_worker

    es = ElasticState(_train_state())
    with pytest.raises(ValueError, match="data_plane"):
        run_elastic_worker(lambda s, c: None, es, coord_addr="127.0.0.1:1",
                           data_plane="dcn")


def test_backward_hooks_feed_buckets_in_backward_order():
    """``OverlappedGradSync.hook``: each parameter's gradient reaches
    ``grad_ready`` as backward accumulates it, output layer first."""
    from tpudist_torch.elastic.worker import OverlappedGradSync

    class Recorder:
        world = 2

        def __init__(self):
            self.calls = []

        def allreduce_sum(self, tree):
            self.calls.append(list(tree))
            return {k: v * self.world for k, v in tree.items()}

    coll = Recorder()
    sync = OverlappedGradSync(coll, bucket_bytes=1)   # a bucket a name
    model = _mlp()
    handles = sync.hook(model)
    x = torch.randn(4, 784, generator=torch.Generator().manual_seed(2))
    model(x).sum().backward()
    out = sync.reduce(mean=True)
    for h in handles:
        h.remove()
    names = [n for n, _ in model.named_parameters()]
    fired = [c[0] for c in coll.calls]
    assert sorted(fired) == sorted(names)
    assert fired.index("dense.2.weight") < fired.index("dense.0.weight")
    for n, p in model.named_parameters():
        assert torch.equal(out[n], p.grad)
