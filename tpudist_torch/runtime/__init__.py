"""The port's runtime (counterpart of :mod:`tpudist.runtime`): so far the
process-group bootstrap and the process mesh."""

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
    local_batch_size,
    local_block,
    make_mesh,
)

__all__ = [
    "DistributedContext",
    "data_mesh",
    "initialize",
    "local_batch_size",
    "local_block",
    "local_rank",
    "make_mesh",
    "process_count",
    "process_index",
    "shutdown",
    "world_info",
]
