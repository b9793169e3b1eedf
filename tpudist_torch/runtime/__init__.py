"""The port's runtime (counterpart of :mod:`tpudist.runtime`): the
process-group bootstrap and the process mesh, exported here; the
coordination store (``coord``), its host collectives (``collectives``),
fault injection (``faults``) and the launcher (``launch``), imported from
their modules, as tpudist's package leaves them."""

from tpudist_torch.runtime.distributed import (
    DistributedContext,
    initialize,
    local_rank,
    process_count,
    process_index,
    shutdown,
    world_info,
)
from tpudist_torch.runtime.mesh import (
    data_mesh,
    data_model_mesh,
    local_batch_size,
    local_block,
    make_mesh,
    pipeline_mesh,
)

__all__ = [
    "DistributedContext",
    "data_mesh",
    "data_model_mesh",
    "initialize",
    "local_batch_size",
    "local_block",
    "local_rank",
    "make_mesh",
    "pipeline_mesh",
    "process_count",
    "process_index",
    "shutdown",
    "world_info",
]
