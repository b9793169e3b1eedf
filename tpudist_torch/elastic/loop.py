"""The elastic run loop — ``@hvd.elastic.run`` and TorchElastic's
restart-on-membership-change, unified (SURVEY.md §5); counterpart of
:mod:`tpudist.elastic.loop`.

Two failure models, one mechanism:

* **In-process** (worker drop/add detected while the controller survives,
  Horovod-elastic style): training raises :class:`WorldChanged` /
  :class:`WorkerFailure`; :func:`elastic_run` rolls the state back to its
  last commit, fires reset callbacks on a resize, and re-enters the train
  function — `horovod_mnist_elastic.py:55-77` semantics.
* **Process-restart** (TorchElastic style, `mnist_ddp_elastic.py:5-6`): the
  process dies; on relaunch the trainer restores the newest durable
  checkpoint (``Checkpointer.restore_latest``) and resumes — granularity =
  the commit interval instead of the reference's epoch granularity.

Fault injection for tests: pass ``fault=`` a callable invoked before every
train attempt; tests raise on chosen (epoch, batch) positions to prove
rollback exactness (the reference has no fault injection at all, SURVEY.md
§4/§5).
"""

from __future__ import annotations

from typing import Callable

from tpudist_torch.elastic.state import ElasticState
from tpudist_torch.utils.logging import get_logger

log = get_logger(__name__)


class WorkerFailure(RuntimeError):
    """A worker died; world size is unchanged after recovery."""


class WorldChanged(RuntimeError):
    """Membership changed; carries the new world size."""

    def __init__(self, new_world_size: int, msg: str = "") -> None:
        super().__init__(msg or f"world resized to {new_world_size}")
        self.new_world_size = new_world_size


def elastic_run(
    train_fn: Callable[[ElasticState], None],
    state: ElasticState,
    max_restarts: int = 10,
) -> ElasticState:
    """Run ``train_fn(state)`` to completion, restarting on elastic events.

    ``train_fn`` must call ``state.commit()`` at its commit points and read
    its starting position from ``state.host`` (epoch/batch) — exactly the
    contract of the reference's ``train(state)``
    (`horovod_mnist_elastic.py:55-77`).
    """
    restarts = 0
    while True:
        try:
            train_fn(state)
            return state
        except WorldChanged as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            log.warning(
                "world resized %d -> %d; rolling back to commit #%d "
                "(epoch %d, batch %d)",
                state.world_size, e.new_world_size, state.commits,
                state._committed_host.epoch, state._committed_host.batch,
            )
            state.on_world_change(e.new_world_size)
        except WorkerFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            log.warning("worker failure (%s); rolling back to last commit", e)
            state.rollback()
