"""tpudist_torch's data parallelism across processes against the JAX
package's, and the process-group bootstrap and mesh it runs on.

The port's ranks are real processes: :func:`run_ranks` spawns them with
``torch.multiprocessing``, they join a gloo group through a ``file://``
store under the test's temporary directory (no port to collide on under
xdist) and return numpy results to the parent, which compares them with
tpudist's run on the same mesh shape of ``tests/conftest.py``'s virtual
CPU devices.  JAX is imported only by the parent's reference helpers, so
the ranks never import it.  Every spawn has its own time limits: the
ranks must have joined the group within ``RANK_START_S`` (spawning a
process and importing torch, which a loaded host can slow by minutes)
and then finish within ``RANK_TIMEOUT_S``; past either, the ranks are
killed and the test fails, with each rank's output, instead of stalling
the run.  A rank leaves the group only once every rank has its result, so
none tears down its gloo connections while a peer still uses them.

Tolerances (f32) are ``tests/test_torch_training.py``'s for Adam steps:
losses atol = rtol = 1e-5; parameters after the steps every element
within 1e-4 and all but one in 10,000 within 3e-6 (Adam moves an element
whose gradient is near zero by up to lr on a difference in that
gradient's last bits).
"""

import os
import pickle
import time
import traceback
import uuid

import numpy as np
import pytest
import torch

RANK_TIMEOUT_S = 120     # a rank's work, once every rank has joined
RANK_START_S = 600       # spawning, importing torch, joining the group
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
BASE = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            embed_dim=64, max_seq_len=64)
SEQ, LR, STEPS = 64, 1e-3, 2


def _done(out_dir, world) -> bool:
    """Every rank has left its result, or some rank its traceback."""
    def left(r, ext):
        return os.path.exists(os.path.join(out_dir, f"rank{r}{ext}"))

    return (any(left(r, ".err") for r in range(world))
            or all(left(r, ".pkl") for r in range(world)))


def _rank_entry(fn, rank, world, init_method, out_dir, args):
    """A spawned rank: its output to ``rank<r>.log``; join the gloo group
    (then ``rank<r>.up``), run ``fn(rank, world, *args)``, leave its
    result (or its traceback) in ``out_dir``, and wait for every rank's
    before leaving the group."""
    log = open(os.path.join(out_dir, f"rank{rank}.log"), "w", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    torch.set_num_threads(1)
    from tpudist_torch.runtime import initialize, shutdown

    try:
        initialize(init_method, world, rank, device="cpu")
        open(os.path.join(out_dir, f"rank{rank}.up"), "w").close()
        result = fn(rank, world, *args)
        tmp = os.path.join(out_dir, f"rank{rank}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(out_dir, f"rank{rank}.pkl"))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while not _done(out_dir, world) and time.monotonic() < deadline:
            time.sleep(0.02)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        shutdown()


def run_ranks(fn, world, tmp_path, *args, timeout=RANK_TIMEOUT_S):
    """``fn(rank, world, *args)`` in ``world`` spawned gloo processes; the
    list of their return values, by rank.  The ranks must join the group
    within ``RANK_START_S`` seconds and then finish within ``timeout``;
    past either they are killed and the test fails, showing each rank's
    output."""
    ctx = torch.multiprocessing.get_context("spawn")
    out_dir = tmp_path / f"ranks-{uuid.uuid4().hex[:8]}"
    out_dir.mkdir()
    init = f"file://{out_dir / 'store'}"
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, init, str(out_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()

    def logs() -> str:
        return "".join(
            f"\n--- rank {r} output ---\n"
            + (out_dir / f"rank{r}.log").read_text()[-4000:]
            for r in range(world) if (out_dir / f"rank{r}.log").exists())

    start = time.monotonic()
    while not all((out_dir / f"rank{r}.up").exists() for r in range(world)):
        if (time.monotonic() - start > RANK_START_S
                or any(not p.is_alive() for p in procs)):
            break
        time.sleep(0.05)
    started = [r for r in range(world) if (out_dir / f"rank{r}.up").exists()]
    deadline = time.monotonic() + (timeout if len(started) == world else 0)
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(out_dir / f"rank{r}.err").read_text()
              for r in range(world) if (out_dir / f"rank{r}.err").exists()]
    if len(started) < world and not errors:
        pytest.fail(f"only ranks {started} of {world} joined the group "
                    f"within {RANK_START_S} s; exit codes "
                    f"{[p.exitcode for p in procs]}" + logs())
    if hung:
        pytest.fail(f"ranks {hung} still running {timeout} s after joining "
                    f"the group; killed" + "".join("\n" + e for e in errors)
                    + logs())
    if errors or any(p.exitcode for p in procs):
        pytest.fail("a rank failed:\n" + "\n".join(errors)
                    + f"\nexit codes {[p.exitcode for p in procs]}" + logs())
    results = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def assert_params_close(got: dict, want: dict) -> None:
    """Parameters after Adam steps, by name (the module docstring's
    tolerance)."""
    assert set(got) == set(want)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diff.max() <= 1e-4, diff.max()
    assert int((diff > 3e-6).sum()) <= diff.size * 1e-4


# ---- the reference (parent process only) ----------------------------------

def _jax_setup(seed=0):
    import jax
    import jax.numpy as jnp

    from tpudist.models.transformer import TransformerConfig, TransformerLM

    jcfg = TransformerConfig(**BASE)
    params = TransformerLM(jcfg).init(jax.random.key(seed),
                                      jnp.zeros((1, 2), jnp.int32))["params"]
    return jcfg, jax.tree.map(np.asarray, params)


def _state_dict(params) -> dict:
    """The flax tree as the port's state dict, in numpy."""
    from tpudist_torch.models.convert import from_flax_params
    from tpudist_torch.models.transformer import TransformerConfig

    return {k: v.numpy()
            for k, v in from_flax_params(params, TransformerConfig(
                **BASE)).items()}


def _jax_dp_run(devices, params, tokens, accum_steps):
    """tpudist's make_dp_train_step on a 2-device data mesh: losses and
    final parameters (as the port's state dict)."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpudist.models.transformer import TransformerConfig, TransformerLM
    from tpudist.ops.losses import cross_entropy
    from tpudist.parallel.data_parallel import (
        broadcast_params,
        make_dp_train_step,
    )
    from tpudist.train.state import TrainState

    model = TransformerLM(TransformerConfig(**BASE))

    def loss_fn(p, batch, _rng):
        (toks,) = batch
        logits = model.apply({"params": p}, toks)
        return cross_entropy(logits[:, :-1].reshape(-1, BASE["vocab_size"]),
                             toks[:, 1:].reshape(-1)), {}

    mesh = jax.sharding.Mesh(np.array(devices[:2]), ("data",))
    state = TrainState.create(model.apply, broadcast_params(params, mesh),
                              optax.adam(LR))
    step = make_dp_train_step(loss_fn, mesh, accum_steps=accum_steps)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, jnp.asarray(tokens))
        losses.append(float(m["loss"]))
    return losses, _state_dict(jax.tree.map(np.asarray, state.params))


# ---- the ranks -------------------------------------------------------------

def _port_model(sd):
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    model = TransformerLM(TransformerConfig(**BASE),
                          param_dtype=torch.float32, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


def _dp_rank(rank, world, sd, tokens, accum_steps):
    from tpudist_torch.ops.losses import cross_entropy
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.runtime import data_mesh, local_block
    from tpudist_torch.train import TrainState, adam

    mesh = data_mesh()

    def loss_fn(m, batch, _gen):
        (toks,) = batch
        logits = m(toks)
        return cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                             toks[:, 1:].reshape(-1)), {}

    model = _port_model(sd)
    state = TrainState.create(model, adam(LR))
    step = make_dp_train_step(loss_fn, accum_steps=accum_steps, mesh=mesh)
    toks = local_block(torch.from_numpy(tokens).long(), mesh, ("data",))
    losses = []
    for _ in range(STEPS):
        state, m = step(state, toks)
        losses.append(float(m["loss"]))
    return losses, {k: v.detach().numpy().copy()
                    for k, v in model.state_dict().items()}


def _broadcast_rank(rank, world):
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.parallel import broadcast_params
    from tpudist_torch.runtime import data_mesh

    model = TransformerLM(TransformerConfig(**BASE), device="cpu")
    model.init_weights(torch.Generator().manual_seed(100 + rank))
    own = {k: v.clone() for k, v in model.state_dict().items()}
    broadcast_params(model, data_mesh())
    return ({k: v.numpy() for k, v in own.items()},
            {k: v.numpy() for k, v in model.state_dict().items()})


def _mesh_rank(rank, world):
    """What the bootstrap and the meshes report, and the errors they
    raise, on this rank."""
    from tpudist_torch.parallel import ring_flash_attention_fn
    from tpudist_torch.runtime import (
        initialize,
        local_batch_size,
        local_block,
        make_mesh,
        world_info,
    )
    from tpudist_torch.runtime.mesh import axis_index, axis_size

    info = initialize("file:///nonexistent", world, rank, device="cpu")
    out = {"info": info, "same_info": info == world_info()}
    grid = make_mesh({"data": -1, "seq": 2})
    out["grid"] = (axis_size(grid, "data"), axis_size(grid, "seq"),
                   axis_index(grid, "data"), axis_index(grid, "seq"))
    out["local_batch"] = local_batch_size(8, grid, "data")
    x = torch.arange(4 * 6).reshape(4, 6)
    out["block"] = local_block(x, grid).numpy()
    for name, fn in (
            ("too_big", lambda: make_mesh({"data": 2 * world})),
            ("two_wild", lambda: make_mesh({"data": -1, "seq": -1})),
            ("no_mesh", lambda: ring_flash_attention_fn("seq")),
            ("indivisible", lambda: local_batch_size(3, grid, "seq"))):
        try:
            fn()
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


# ---- tests -----------------------------------------------------------------

@pytest.mark.parametrize("accum_steps", [1, 2])
def test_dp_step_matches_jax_on_two_ranks(devices8, tmp_path, accum_steps):
    """2 Adam steps of ``make_dp_train_step`` over 2 gloo ranks, each on
    half of a batch of 4, against tpudist's step on a 2-device data mesh:
    the averaged loss at each step on every rank, and every parameter
    after."""
    _, params = _jax_setup()
    tokens = np.random.default_rng(1).integers(
        0, BASE["vocab_size"], (8 if accum_steps > 1 else 4, SEQ)).astype(
            np.int32)
    want_losses, want = _jax_dp_run(devices8, params, tokens, accum_steps)
    results = run_ranks(_dp_rank, 2, tmp_path, _state_dict(params), tokens,
                        accum_steps)
    for losses, sd in results:
        np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
        assert_params_close(sd, want)
    for k in want:  # replicas stay identical
        np.testing.assert_array_equal(results[0][1][k], results[1][1][k])


def test_broadcast_params_makes_ranks_equal(tmp_path):
    results = run_ranks(_broadcast_rank, 2, tmp_path)
    (own0, got0), (own1, got1) = results
    for k in own0:
        np.testing.assert_array_equal(got0[k], own0[k])
        np.testing.assert_array_equal(got1[k], own0[k])
    assert any(not np.array_equal(own1[k], own0[k]) for k in own0)


def test_initialize_and_make_mesh(tmp_path):
    """Two ranks: the world as the bootstrap reports it (a second
    ``initialize`` is a no-op that reports the same), ``-1`` resolved,
    coordinates, blocks cut by ``local_block``, and the errors."""
    from tpudist_torch.runtime import initialize

    # one process alone needs no bootstrap
    solo = initialize(device="cpu")
    assert (solo.process_index, solo.process_count) == (0, 1)
    results = run_ranks(_mesh_rank, 2, tmp_path)
    x = np.arange(4 * 6).reshape(4, 6)
    for rank, out in enumerate(results):
        info = out["info"]
        assert (info.process_index, info.process_count,
                info.global_device_count) == (rank, 2, 2)
        assert info.is_coordinator == (rank == 0) and out["same_info"]
        assert out["grid"] == (1, 2, 0, rank)
        assert out["local_batch"] == 8
        np.testing.assert_array_equal(out["block"],
                                      x[:, 3 * rank:3 * (rank + 1)])
        assert "needs 4 processes, the world has 2" in out["too_big"]
        assert "at most one -1" in out["two_wild"]
        assert "pass mesh=" in out["no_mesh"]
        assert "not divisible" in out["indivisible"]


# ---- the step's random stream and its signature ----------------------------

def _stream_rank(rank, world, seed):
    """Two steps of accum_steps=2 built in tpudist's call form
    ``make_dp_train_step(loss_fn, mesh, accum_steps=...)``: the 4 values
    the loss_fn drew from its generator at each (step, micro-batch), twice
    from the same seed."""
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.runtime import data_mesh
    from tpudist_torch.train import TrainState, sgd

    draws = []

    def loss_fn(m, batch, gen):
        draws.append(torch.rand(4, generator=gen).numpy())
        (x,) = batch
        return (m(x) ** 2).mean(), {}

    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        model = torch.nn.Linear(3, 1)
        state = TrainState.create(model, sgd(0.1), seed=seed)
        step = make_dp_train_step(loss_fn, data_mesh(), accum_steps=2)
        draws.clear()
        for _ in range(2):
            state, _ = step(state, torch.ones(4, 3))
        runs.append(np.stack(draws))
    return runs


def test_dp_step_streams_differ_by_rank_micro_and_step(tmp_path):
    """tpudist folds the data-shard index and the micro-batch index into
    the step's key and splits the key every step: the port's loss_fn
    generators differ between ranks, micro-batches and steps, and repeat
    from the same seed."""
    ranks = run_ranks(_stream_rank, 2, tmp_path, 7)
    other = run_ranks(_stream_rank, 2, tmp_path, 8)
    for runs in ranks + other:
        np.testing.assert_array_equal(runs[0], runs[1])   # repeats
    draws = np.concatenate([ranks[0][0], ranks[1][0]])     # [2 ranks x 4, 4]
    assert len({row.tobytes() for row in draws}) == len(draws)
    assert not np.array_equal(ranks[0][0], other[0][0])


def test_train_steps_take_tpudists_signatures():
    """``make_dp_train_step`` and ``make_sp_train_step`` take tpudist's
    parameters in tpudist's order (``donate`` accepted)."""
    import inspect

    from tpudist.parallel import data_parallel as jdp
    from tpudist.parallel import ring_attention as jra
    from tpudist_torch.parallel import data_parallel as tdp
    from tpudist_torch.parallel import ring_attention as tra

    for port, ref in ((tdp.make_dp_train_step, jdp.make_dp_train_step),
                      (tra.make_sp_train_step, jra.make_sp_train_step)):
        assert list(inspect.signature(port).parameters) == \
            list(inspect.signature(ref).parameters)


def test_fold_in_mixes_every_argument():
    from tpudist_torch.train import fold_in

    seeds = {fold_in(s, shard, step, micro) for s in (0, 1)
             for shard in (0, 1) for step in (0, 1, 2) for micro in (0, 1)}
    assert len(seeds) == 24 and all(0 <= s < 2 ** 64 for s in seeds)
    assert fold_in(3, 1, 2) == fold_in(3, 1, 2) != fold_in(3, 2, 1)


def test_loop_and_eval_steps_take_tpudists_signatures():
    """``make_dp_train_loop``, ``make_dp_eval_step`` and
    ``make_dp_masked_eval_step`` take tpudist's parameters in tpudist's
    order."""
    import inspect

    from tpudist.parallel import data_parallel as jdp
    from tpudist_torch.parallel import data_parallel as tdp

    for name in ("make_dp_train_loop", "make_dp_eval_step",
                 "make_dp_masked_eval_step"):
        assert list(inspect.signature(getattr(tdp, name)).parameters) == \
            list(inspect.signature(getattr(jdp, name)).parameters), name


# ---- the Trainer and the eval steps across ranks ----------------------------

MNIST_N, MNIST_TEST_N, MNIST_BATCH, MNIST_LR = 128, 90, 32, 0.05


def _convnet_trainer(snapshot, images, labels, test_images, test_labels):
    """A ConvNet (dropout off) Trainer, SGD 0.05, batch 32, on this
    process's shard; the same weights on every rank."""
    from tpudist_torch.data import ShardedLoader
    from tpudist_torch.models import ConvNet
    from tpudist_torch.train import Trainer, TrainerConfig, sgd

    model = ConvNet(device="cpu").init_weights(
        torch.Generator().manual_seed(3))
    cfg = TrainerConfig(total_epochs=1, batch_size=MNIST_BATCH,
                        snapshot_path=snapshot, log_every=1000)
    train = ShardedLoader([images, labels], MNIST_BATCH, shuffle=True,
                          device="cpu")
    test = ShardedLoader([test_images, test_labels], MNIST_BATCH,
                         drop_last=False, device="cpu")
    return Trainer(cfg, model, sgd(MNIST_LR), None, train, test)


def _trainer_rank(rank, world, snapshot, *arrays):
    trainer = _convnet_trainer(snapshot, *arrays)
    loader = trainer.train_loader
    summary = trainer.train()
    return ((loader.num_shards, loader.shard, loader.local_batch), summary,
            {k: v.numpy().copy()
             for k, v in trainer.state.model.state_dict().items()})


def _mnist_arrays():
    from tpudist_torch.data.mnist import synthetic_mnist

    train = synthetic_mnist("train", n=MNIST_N, seed=1)
    test = synthetic_mnist("test", n=MNIST_TEST_N, seed=1)
    return train.images, train.labels, test.images, test.labels


def test_trainer_epoch_on_two_ranks_equals_one_process(tmp_path):
    """One Trainer epoch of ConvNet (dropout off) over 2 gloo ranks, each
    on its 16 rows of every batch of 32, against one process on the whole
    batch: the epoch's mean loss and the parameters after its 4 SGD steps
    within atol = rtol = 1e-6 (two half-batch gradients averaged sum in
    another order than one whole-batch gradient), the exact test accuracy
    over the 90 test rows (45 a rank) equal, and the snapshot written by
    rank 0."""
    arrays = _mnist_arrays()
    want_summary, want = None, None
    one = _convnet_trainer(str(tmp_path / "one.npz"), *arrays)
    want_summary = one.train()
    want = {k: v.numpy() for k, v in one.state.model.state_dict().items()}
    snap = str(tmp_path / "two.npz")
    for rank, (layout, summary, sd) in enumerate(
            run_ranks(_trainer_rank, 2, tmp_path, snap, *arrays)):
        assert layout == (2, rank, MNIST_BATCH // 2)
        np.testing.assert_allclose(summary["loss"], want_summary["loss"],
                                   atol=1e-6, rtol=1e-6)
        assert summary["test_accuracy"] == want_summary["test_accuracy"]
        for k in want:
            np.testing.assert_allclose(sd[k], want[k], atol=1e-6, rtol=1e-6)
    assert os.path.exists(snap)


def _eval_rank(rank, world, state_dict, test_images, test_labels):
    from tpudist_torch.data import ShardedLoader
    from tpudist_torch.models import ConvNet
    from tpudist_torch.parallel import (
        make_dp_eval_step,
        make_dp_masked_eval_step,
    )

    model = ConvNet(device="cpu")
    model.load_state_dict(state_dict)
    loader = ShardedLoader([test_images, test_labels], MNIST_BATCH,
                           drop_last=False, device="cpu")

    def predict(m, inputs):
        return m(*inputs)

    masked = make_dp_masked_eval_step(predict)
    plain = make_dp_eval_step(predict)
    out = []
    for step, (x, y) in enumerate(loader.epoch(0)):
        c, t = masked(model, x, y, loader.valid_mask(step))
        out.append((int(c), int(t), int(plain(model, x, y))))
    return out


def test_masked_eval_counts_on_two_ranks_equal_one_process(tmp_path):
    """``make_dp_masked_eval_step`` over 2 ranks of a drop_last=False
    loader (90 rows: 45 a rank, the last batch of 16 a rank partial)
    gives, at every step, the counts one process computes over both
    ranks' rows; the unmasked ``make_dp_eval_step`` counts every row fed.
    Exact integers."""
    from tpudist_torch.data import ShardedLoader
    from tpudist_torch.models import ConvNet

    _, _, images, labels = _mnist_arrays()
    model = ConvNet(device="cpu").init_weights(
        torch.Generator().manual_seed(4))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    shards = [ShardedLoader([images, labels], MNIST_BATCH, drop_last=False,
                            num_shards=2, shard=r, device="cpu")
              for r in range(2)]
    want = []
    with torch.no_grad():
        for step, batches in enumerate(zip(*(s.epoch(0) for s in shards))):
            x = torch.cat([b[0] for b in batches])
            y = torch.cat([b[1] for b in batches])
            mask = torch.from_numpy(np.concatenate(
                [s.valid_mask(step) for s in shards]))
            hit = model(x).argmax(-1) == y
            want.append((int((hit & mask).sum()), int(mask.sum()),
                         int(hit.sum())))
    assert sum(w[1] for w in want) == MNIST_TEST_N
    for got in run_ranks(_eval_rank, 2, tmp_path, sd, images, labels):
        assert got == want
