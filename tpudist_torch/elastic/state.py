"""Commit/rollback elastic state — the ``hvd.elastic.TorchState`` twin
(counterpart of :mod:`tpudist.elastic.state`).

The reference wraps model+optimizer+counters in a ``TorchState`` whose
``commit()`` is a consistency barrier + in-memory backup, rolled back when
membership changes (`horovod_mnist_elastic.py:104,71-72` — SURVEY.md §3.3).
tpudist's train state is one pytree; the port's is a
:class:`~tpudist_torch.train.state.TrainState` — a module holding the
parameters, an optimizer holding its state, the integer step and seed —
seen as one tree by :func:`state_tree`::

    {"params": model.state_dict(),
     "opt_state": the optimizer's state by parameter index,
     "hyper": [each param group's numeric hyperparameters (lr, ...)],
     "step": int, "seed": int}

The learning rate is in the tree (as tpudist's ``inject_hyperparams``
puts it in ``opt_state``), so a rollback restores it and a reset callback
rescales it in place.  The optimizer's state is made at construction
(:func:`~tpudist_torch.train.state.init_optimizer_state`), because a
fresh torch optimizer has none until its first step and every rank's
tree must have the same structure when a round broadcasts its root's
state into it.

Commit = a host copy of the tree (numpy; also the durable checkpoint's
form), rollback = a copy back INTO the live tensors (``copy_``, so the
optimizer's references to the parameters stay valid).  A host copy and
not a device clone: a commit every few dozen steps costs a device sync
and the state's bytes over PCIe (PERF.md gives the card's times), and a
clone would hold a second copy of the state in device memory.  Both are
bit-exact (bf16 leaves round-trip through f32 exactly).

The reference's committed batch index lags the true position by one batch and
only protects the first resumed epoch (quirk documented in SURVEY.md §3.3);
here ``HostDataState`` is committed atomically with the device state, so
resume lands exactly on the committed (epoch, batch).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from tpudist_torch.elastic.checkpoint import Checkpointer
from tpudist_torch.train.state import TrainState, init_optimizer_state
from tpudist_torch.utils.trees import tree_to_numpy

ResetCallback = Callable[["ElasticState", int, int], None]


def _hyper(group: dict) -> dict:
    return {k: v for k, v in group.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def state_tree(ts: TrainState) -> dict:
    """The train state as one tree of the LIVE tensors (see the module
    docstring); :func:`tree_to_numpy` of it is a snapshot."""
    return {"params": ts.model.state_dict(),
            "opt_state": ts.optimizer.state_dict()["state"],
            "hyper": [_hyper(g) for g in ts.optimizer.param_groups],
            "step": ts.step, "seed": ts.seed}


def _copy_into(dst: Any, src: Any) -> None:
    """Copy ``src``'s leaves into the tensors of ``dst`` (same
    structure; leaves numpy arrays or tensors)."""
    if isinstance(dst, Mapping):
        for k, v in dst.items():
            _copy_into(v, src[k])
        return
    with torch.no_grad():
        dst.copy_(src if isinstance(src, torch.Tensor)
                  else torch.from_numpy(np.asarray(src)))


def load_state_tree(ts: TrainState, tree: Mapping) -> TrainState:
    """Write ``tree`` (host arrays or tensors, :func:`state_tree`'s
    structure) into ``ts`` in place; returns ``ts``."""
    _copy_into(ts.model.state_dict(), tree["params"])
    _copy_into(ts.optimizer.state_dict()["state"], tree["opt_state"])
    for group, hyper in zip(ts.optimizer.param_groups, tree["hyper"]):
        for k, v in hyper.items():
            group[k] = type(group[k])(np.asarray(v).item())
    ts.step = int(np.asarray(tree["step"]))
    ts.seed = int(np.asarray(tree["seed"]))
    return ts


@dataclasses.dataclass
class HostDataState:
    """Host-side progress counters committed with the device state
    (epoch + batch offset, the ``TorchState(batch=0, epoch=0)`` fields,
    `horovod_mnist_elastic.py:104`)."""

    epoch: int = 0
    batch: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ElasticState:
    """Holds the live :class:`TrainState` plus host counters, with
    commit/rollback and world-size reset callbacks."""

    def __init__(
        self,
        state: TrainState,
        host: HostDataState | None = None,
        checkpointer: Checkpointer | None = None,
        world_size: int = 1,
        restore: bool = True,
    ) -> None:
        self.state = state
        init_optimizer_state(state.optimizer)
        self.host = host or HostDataState()
        self.checkpointer = checkpointer
        self.world_size = world_size
        self._reset_callbacks: list[ResetCallback] = []
        self._committed_state: Any = None
        self._committed_host: HostDataState | None = None
        self.commits = 0
        self.rollbacks = 0
        # Durable resume (``restore=False`` opts out): adopt the latest
        # checkpoint BEFORE the initial commit, so a restarted gang — even
        # a FULL-gang loss, where no surviving peer can re-broadcast the
        # state — resumes from the last durable commit rather than from
        # scratch (the torch.save/load snapshot contract,
        # `mnist_ddp_elastic.py:95-104`, extended to elastic restarts).
        self.restored_step: int | None = None
        if checkpointer is not None and restore:
            hit = checkpointer.restore_latest(state_tree(self.state))
            if hit is not None:
                step, tree, meta = hit
                load_state_tree(self.state, tree)
                self.host.epoch = int(meta.get("epoch", self.host.epoch))
                self.host.batch = int(meta.get("batch", self.host.batch))
                if "world_size" in meta:
                    self.world_size = int(meta["world_size"])
                self.restored_step = step
        # initial state is always restorable; when it was JUST restored,
        # skip the durable re-write (identical content — re-saving on
        # every restart would churn the keep window and pay a full
        # serialize for zero new durability)
        self.commit(durable=self.restored_step is None)

    def register_reset_callbacks(self, callbacks: Sequence[ResetCallback]) -> None:
        """`state.register_reset_callbacks([on_state_reset])` parity
        (`horovod_mnist_elastic.py:105`)."""
        self._reset_callbacks.extend(callbacks)

    def commit(self, durable: bool = True) -> None:
        """Consistency point: snapshot the train state to host memory; also
        a durable checkpoint when a checkpointer is attached (strictly
        stronger than the reference's memory-only commit)."""
        self._committed_state = tree_to_numpy(state_tree(self.state))
        self._committed_host = dataclasses.replace(self.host)
        self.commits += 1
        if durable and self.checkpointer is not None:
            self.checkpointer.save(
                self.state.step, self._committed_state,
                meta={**self.host.as_dict(), "world_size": self.world_size},
            )

    def rollback(self) -> None:
        """Restore the last committed (train state, host counters)."""
        if self._committed_state is None:
            raise RuntimeError("nothing committed")
        load_state_tree(self.state, self._committed_state)
        self.host = dataclasses.replace(self._committed_host)
        self.rollbacks += 1

    def on_world_change(self, new_world_size: int) -> None:
        """Rollback + fire reset callbacks — what ``@hvd.elastic.run`` does on
        worker add/drop (`horovod_mnist_elastic.py:80-82`: lr/√N rescale)."""
        old = self.world_size
        self.rollback()
        self.world_size = new_world_size
        for cb in self._reset_callbacks:
            cb(self, old, new_world_size)

    def apply_world(self, new_world_size: int) -> None:
        """Adopt a world size WITHOUT rolling back, firing reset callbacks
        if it differs.  The rendezvous-exit hook: a restarted gang that
        restored a durable commit taken at a different world (or a gang
        that lost ANOTHER member while re-rendezvousing) must still
        rescale its world-dependent hyperparameters."""
        if new_world_size == self.world_size:
            return
        old = self.world_size
        self.world_size = new_world_size
        for cb in self._reset_callbacks:
            cb(self, old, new_world_size)
