"""tpudist_torch's checkpoints and state-tree helpers: the twins of
``tests/test_checkpoint.py`` and the tree cases of ``tests/test_utils.py``
on nested state of tensors (a model's and an optimizer's state dicts),
plus a round trip of a checkpoint written by the port and read by the
JAX package's ``restore_pytree``.  Exact equality throughout."""

import threading

import numpy as np
import pytest
import torch

from tpudist_torch.elastic import checkpoint as ck
from tpudist_torch.elastic.checkpoint import (
    Checkpointer,
    latest_step,
    restore_pytree,
    save_pytree,
)
from tpudist_torch.utils.trees import (
    flatten_with_names,
    tree_size_bytes,
    tree_to_numpy,
    unflatten_like,
)


def _tree(v=0.0):
    return {"params": {"w": torch.full((4, 3), float(v)),
                       "b": torch.arange(3.0)},
            "opt": {0: {"step": torch.tensor(2.0),
                        "m": torch.zeros(4, 3, dtype=torch.float64)}},
            "count": 7}


def _assert_tree_equal(got, want):
    assert flatten_with_names(got).keys() == flatten_with_names(want).keys()
    for k, w in flatten_with_names(want).items():
        np.testing.assert_array_equal(flatten_with_names(got)[k], w)


def test_names_are_slash_joined_paths():
    names = flatten_with_names(_tree())
    assert set(names) == {"params/w", "params/b", "opt/0/step", "opt/0/m",
                          "count"}
    assert all(isinstance(v, np.ndarray) for v in names.values())


def test_unflatten_returns_the_templates_kind():
    tree = _tree(1.5)
    back = unflatten_like(tree, flatten_with_names(tree))
    assert isinstance(back["params"]["w"], torch.Tensor)
    assert back["opt"][0]["m"].dtype == torch.float64
    assert back["count"] == 7 and isinstance(back["count"], int)
    _assert_tree_equal(back, tree)
    # a copy, not an alias
    back["params"]["w"].add_(1)
    assert float(tree["params"]["w"][0, 0]) == 1.5


def test_tree_to_numpy_copies_and_size_bytes():
    t = {"x": torch.zeros(2, 3), "y": np.zeros(4, np.int32)}
    host = tree_to_numpy(t)
    t["x"].add_(1)
    t["y"] += 1
    assert not host["x"].any() and not host["y"].any()
    assert tree_size_bytes(t) == 2 * 3 * 4 + 4 * 4
    bf = {"z": torch.ones(3, dtype=torch.bfloat16)}
    assert tree_to_numpy(bf)["z"].dtype == np.float32
    assert tree_size_bytes(bf) == 6


def test_roundtrip(tmp_path):
    tree = _tree(3.0)
    save_pytree(tmp_path / "c.npz", tree, meta={"step": 5})
    got, meta = restore_pytree(tmp_path / "c.npz", _tree())
    _assert_tree_equal(got, tree)
    assert meta == {"step": 5}


def test_readable_by_the_jax_packages_restore(tmp_path):
    """No framework object inside: tpudist's restore reads the port's
    archive given a numpy template of the same paths."""
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    from tpudist.elastic.checkpoint import restore_pytree as jax_restore

    tree = _tree(2.0)
    save_pytree(tmp_path / "c.npz", tree, meta={"step": 1})
    template = {"params": {"w": np.zeros((4, 3), np.float32),
                           "b": np.zeros(3, np.float32)},
                "opt": {"0": {"step": np.float32(0),
                              "m": np.zeros((4, 3))}},
                "count": np.int64(0)}
    got, meta = jax_restore(tmp_path / "c.npz", template)
    np.testing.assert_array_equal(got["params"]["w"], np.full((4, 3), 2.0))
    assert meta == {"step": 1}


@pytest.mark.parametrize("bad", ["shape", "dtype", "missing", "extra"])
def test_mismatched_leaves_rejected(tmp_path, bad):
    save_pytree(tmp_path / "c.npz", _tree())
    template = _tree()
    if bad == "shape":
        template["params"]["w"] = torch.zeros(3, 4)
    elif bad == "dtype":
        template["params"]["w"] = torch.zeros(4, 3, dtype=torch.float64)
    elif bad == "missing":
        template["params"]["v"] = torch.zeros(1)
    else:
        del template["params"]["b"]
    err = ValueError if bad in ("shape", "dtype") else KeyError
    with pytest.raises(err, match=bad if bad != "extra" else "lacks"):
        restore_pytree(tmp_path / "c.npz", template)


def test_checkpointer_latest_and_retention(tmp_path):
    ckpt = Checkpointer(tmp_path, keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, _tree(step))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_3"]
    assert latest_step(tmp_path) == 3
    step, tree, _ = ckpt.restore_latest(_tree())
    assert step == 3 and float(tree["params"]["w"][0, 0]) == 3.0


def test_checkpointer_ignores_uncommitted(tmp_path):
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, _tree(1))
    ckpt.save(2, _tree(2))
    (tmp_path / "step_2" / "COMMITTED").unlink()
    assert latest_step(tmp_path) == 1
    assert ckpt.restore_latest(_tree())[0] == 1


def test_restore_latest_empty_and_bad_layout(tmp_path):
    assert Checkpointer(tmp_path / "none").restore_latest(_tree()) is None
    assert Checkpointer(tmp_path / "none.npz",
                        layout="flat").restore_latest(_tree()) is None
    with pytest.raises(ValueError, match="layout"):
        Checkpointer(tmp_path, layout="zip")


def test_flat_layout_roundtrip_and_replace(tmp_path):
    path = tmp_path / "snap.npz"
    ckpt = Checkpointer(path, layout="flat")
    ckpt.save(4, _tree(4), meta={"step": 4, "epochs_run": 2})
    ckpt.save(9, _tree(9), meta={"step": 9, "epochs_run": 3})
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "snap.meta.json", "snap.npz"]
    step, tree, meta = ckpt.restore_latest(_tree())
    assert step == 9 and meta["epochs_run"] == 3
    assert float(tree["params"]["w"][0, 0]) == 9.0


@pytest.mark.parametrize("layout", ["flat", "steps"])
def test_async_save_survives_in_place_updates(tmp_path, layout,
                                              monkeypatch):
    """The optimizer updates in place right after save() returns: the
    writer (held back here until the updates are done) still writes the
    values the tree had at save(), tensors and meta alike."""
    gate = threading.Event()
    real = ck.tree_to_numpy

    def gated(tree):
        gate.wait(timeout=10)
        return real(tree)

    monkeypatch.setattr(ck, "tree_to_numpy", gated)
    tree = _tree(1.0)
    step = torch.tensor(3)
    target = tmp_path / ("s.npz" if layout == "flat" else "ckpt")
    ckpt = Checkpointer(target, async_save=True, layout=layout)
    ckpt.save(3, tree, meta={"step": step, "tag": "e2e"})
    tree["params"]["w"].add_(5.0)
    tree["opt"][0]["step"].add_(1)
    step.add_(1)
    gate.set()
    ckpt.wait()
    assert ckpt.last_blocked_s > 0
    _, got, meta = ckpt.restore_latest(_tree())
    _assert_tree_equal(got, _tree(1.0))
    assert meta == {"step": 3, "tag": "e2e"}


def test_async_save_failure_raises_from_wait(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "save_pytree", boom)
    ckpt = Checkpointer(tmp_path / "s.npz", async_save=True, layout="flat")
    ckpt.save(0, _tree())
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    ckpt.wait()  # raised once, then cleared


def test_async_save_failure_raises_from_next_save(tmp_path, monkeypatch):
    calls = {"n": 0}
    real = ck.save_pytree

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("boom")
        return real(*a, **k)

    monkeypatch.setattr(ck, "save_pytree", flaky)
    ckpt = Checkpointer(tmp_path / "s.npz", async_save=True, layout="flat")
    ckpt.save(0, _tree())
    with pytest.raises(OSError, match="boom"):
        ckpt.save(1, _tree(1))
    ckpt.save(2, _tree(2))              # the error was raised once
    ckpt.wait()
    assert float(ckpt.restore_latest(_tree())[1]["params"]["w"][0, 0]) == 2.0


def test_optimizer_state_round_trip(tmp_path):
    """A model's and an Adam optimizer's state dicts through a snapshot:
    loaded back into fresh objects, the next step is bit-identical."""
    def make():
        torch.manual_seed(0)
        m = torch.nn.Linear(5, 3)
        return m, torch.optim.Adam(m.parameters(), lr=1e-2)

    x = torch.randn(8, 5)
    m, opt = make()
    for _ in range(3):
        opt.zero_grad()
        m(x).square().mean().backward()
        opt.step()
    save_pytree(tmp_path / "s.npz", {"params": m.state_dict(),
                                     "opt": opt.state_dict()["state"]})
    m2, opt2 = make()
    opt2.zero_grad()
    m2(x).square().mean().backward()
    opt2.step()                       # makes the state the template needs
    tree, _ = restore_pytree(tmp_path / "s.npz",
                             {"params": m2.state_dict(),
                              "opt": opt2.state_dict()["state"]})
    m2.load_state_dict(tree["params"])
    sd = opt2.state_dict()
    sd["state"] = tree["opt"]
    opt2.load_state_dict(sd)
    for mm, oo in ((m, opt), (m2, opt2)):
        oo.zero_grad()
        mm(x).square().mean().backward()
        oo.step()
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_async_save_survives_in_place_updates(tmp_path):
    """On the card: in-place updates queued right after save() (the
    optimizer's) do not reach the snapshot; the copies go through pinned
    buffers on a side stream that the caller's stream waits for."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (side-stream copies)")
    w = torch.arange(1 << 22, dtype=torch.float32, device="cuda")
    want = w.cpu().numpy()
    ckpt = Checkpointer(tmp_path / "s.npz", async_save=True, layout="flat")
    ckpt.save(0, {"w": w}, meta={"step": torch.tensor(1, device="cuda")})
    for _ in range(10):
        w.mul_(2.0).add_(1.0)
    ckpt.wait()
    _, got, meta = ckpt.restore_latest({"w": w})
    np.testing.assert_array_equal(got["w"].cpu().numpy(), want)
    assert meta["step"] == 1
