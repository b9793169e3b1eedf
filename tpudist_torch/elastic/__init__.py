"""Elastic training (counterpart of :mod:`tpudist.elastic`): checkpoints,
commit/rollback (:class:`ElasticState`), the restart loop
(:func:`elastic_run`) and the TTL-driven elastic worker
(:func:`run_elastic_worker`) over the coordination store or a process
group a round.  ``examples/horovod_mnist_elastic_gpu.py`` drives them.
tpudist's orbax checkpointer is :class:`OrbaxCheckpointer` on
``torch.distributed.checkpoint``."""

from tpudist_torch.elastic.checkpoint import (
    Checkpointer,
    latest_step,
    restore_pytree,
    save_pytree,
)
from tpudist_torch.elastic.loop import WorkerFailure, WorldChanged, elastic_run
from tpudist_torch.elastic.orbax_ckpt import OrbaxCheckpointer
from tpudist_torch.elastic.state import ElasticState, HostDataState
from tpudist_torch.elastic.worker import ElasticContext, run_elastic_worker

__all__ = [
    "Checkpointer",
    "ElasticContext",
    "ElasticState",
    "HostDataState",
    "OrbaxCheckpointer",
    "WorkerFailure",
    "WorldChanged",
    "elastic_run",
    "latest_step",
    "restore_pytree",
    "run_elastic_worker",
    "save_pytree",
]
