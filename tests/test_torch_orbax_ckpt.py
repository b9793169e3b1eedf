"""tpudist_torch's OrbaxCheckpointer (on torch.distributed.checkpoint)
against tpudist's (on Orbax), on the same sequences of saves.

Each case saves the same values (a numpy tree for tpudist, tensors for
the port) with the same steps and metadata, then restores both: the
restored step, metadata and every leaf must be EQUAL (a checkpoint is a
copy: tolerance 0), and the physical steps kept on disk must be as many.
The cases are ``tests/test_orbax_ckpt.py``'s: a round trip, retention,
same and regressing steps, async quick commits and an ``ElasticState``
commit.  A last case writes one checkpoint from 2 gloo ranks, each its
own shards, into one directory.
"""

import numpy as np
import pytest
import torch

from tpudist.elastic.orbax_ckpt import HAVE_ORBAX
from tpudist.elastic.orbax_ckpt import OrbaxCheckpointer as JaxCkpt
from tpudist_torch.elastic.orbax_ckpt import OrbaxCheckpointer

pytestmark = pytest.mark.skipif(not HAVE_ORBAX, reason="orbax unavailable")


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "b": np.ones((4,), np.float32),
            "step": np.asarray(3, np.int64)}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _both(tmp_path, saves, keep, async_save=False):
    """Run ``saves`` ([(step, seed, meta)]) through both checkpointers;
    returns their restores and their kept physical steps."""
    jax_ck = JaxCkpt(tmp_path / "jax", keep=keep, async_save=async_save)
    port_ck = OrbaxCheckpointer(tmp_path / "port", keep=keep,
                                async_save=async_save)
    for step, seed, meta in saves:
        jax_ck.save(step, _tree(seed), meta=meta)
        port_ck.save(step, _torch(_tree(seed)), meta=meta)
    jax_ck.wait()
    port_ck.wait()
    template = _tree(99)
    want = JaxCkpt(tmp_path / "jax").restore_latest(template)
    reader = OrbaxCheckpointer(tmp_path / "port")
    got = reader.restore_latest(_torch(template))
    kept = (len(jax_ck._mngr.all_steps()), len(reader.all_steps()))
    jax_ck.close()
    port_ck.close()
    return want, got, kept


def _assert_same(want, got):
    wstep, wtree, wmeta = want
    gstep, gtree, gmeta = got
    assert gstep == wstep and gmeta == wmeta
    assert sorted(gtree) == sorted(wtree)
    for k in wtree:
        assert isinstance(gtree[k], torch.Tensor)
        np.testing.assert_array_equal(gtree[k].numpy(), np.asarray(wtree[k]))


def test_roundtrip_matches_orbax(tmp_path):
    want, got, kept = _both(tmp_path, [(3, 1, {"epoch": 1, "batch": 30})],
                            keep=2)
    _assert_same(want, got)
    assert got[0] == 3 and got[2] == {"epoch": 1, "batch": 30}
    assert kept == (1, 1)


def test_retention_keeps_latest(tmp_path):
    want, got, kept = _both(tmp_path, [(s, s, None) for s in (1, 2, 3, 4)],
                            keep=2)
    _assert_same(want, got)
    assert got[0] == 4 and kept == (2, 2)
    assert OrbaxCheckpointer(tmp_path / "port").all_steps() == [3, 4]


def test_same_and_regressing_steps_never_dropped(tmp_path):
    """tests/test_orbax_ckpt.py:89: a repeated and a regressing step both
    land; the newest commit wins with the caller's step."""
    saves = [(7, 1, {"tag": "a"}), (7, 2, {"tag": "b"}), (2, 3, {"tag": "c"})]
    want, got, kept = _both(tmp_path, saves, keep=5)
    _assert_same(want, got)
    assert got[0] == 2 and got[2] == {"tag": "c"}
    assert kept == (3, 3)


def test_async_quick_commits_never_dropped(tmp_path):
    """tests/test_orbax_ckpt.py:108: three async saves issued before the
    first finishes all land."""
    saves = [(3, 1, {"tag": "a"}), (3, 2, {"tag": "b"}), (1, 3, {"tag": "c"})]
    want, got, kept = _both(tmp_path, saves, keep=8, async_save=True)
    _assert_same(want, got)
    assert got[0] == 1 and got[2] == {"tag": "c"}
    assert kept == (3, 3)


def test_async_save_copies_before_in_place_update(tmp_path):
    """An async save writes the values the tree held at ``save()``, not
    what an in-place update made of them afterwards."""
    ck = OrbaxCheckpointer(tmp_path / "port", async_save=True)
    tree = _torch(_tree(5))
    ck.save(1, tree)
    tree["w"].add_(100.0)
    ck.wait()
    _, got, _ = ck.restore_latest(_torch(_tree(0)))
    np.testing.assert_array_equal(got["w"].numpy(), _tree(5)["w"])


def test_elastic_state_commit_restores(tmp_path):
    """A durable ElasticState commit through the DCP checkpointer is
    restored by a fresh ElasticState: parameters, position, step."""
    from tpudist_torch.elastic.state import ElasticState
    from tpudist_torch.models import MLP
    from tpudist_torch.train.state import TrainState, sgd

    def make():
        model = MLP(hidden_layers=1, features=8, device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        return model, TrainState.create(model, sgd(0.1), seed=0)

    model, ts = make()
    es = ElasticState(ts, checkpointer=OrbaxCheckpointer(
        tmp_path / "ck", keep=3, async_save=True))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(3.0)
    es.host.epoch, es.host.batch = 2, 60
    es.commit()
    es.checkpointer.wait()
    model2, ts2 = make()
    es2 = ElasticState(ts2, checkpointer=OrbaxCheckpointer(tmp_path / "ck"))
    assert es2.restored_step is not None
    assert (es2.host.epoch, es2.host.batch) == (2, 60)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


def _sharded_rank(rank, world, directory):
    import torch.distributed as dist

    group = dist.group.WORLD
    ck = OrbaxCheckpointer(directory, keep=2, process_group=group)
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "n": np.asarray(5, np.int64)}
    ck.save(4, tree, meta={"batch": 8})
    ck.save(4, tree, meta={"batch": 9})     # the same step again: remapped
    step, got, meta = ck.restore_latest(
        {"w": torch.zeros(3, 4), "n": np.asarray(0, np.int64)})
    ck.close()
    return step, got["w"].numpy(), int(got["n"]), meta, ck.all_steps()


def test_process_group_writes_one_checkpoint(tmp_path):
    """2 gloo ranks write one checkpoint into one directory through a
    process group and each restores it whole."""
    from tests.test_torch_data_parallel import run_ranks

    out = run_ranks(_sharded_rank, 2, tmp_path, str(tmp_path / "ck"))
    for step, w, n, meta, steps in out:
        assert step == 4 and n == 5 and meta == {"batch": 9}
        np.testing.assert_array_equal(w, np.arange(12).reshape(3, 4))
        assert steps == [4, 5]
