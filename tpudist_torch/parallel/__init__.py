"""The port's parallel strategies (counterpart of :mod:`tpudist.parallel`):
data parallelism across processes, sequence parallelism (ring, ring
flash and Ulysses attention, the DP×SP train step), pipeline parallelism
(GPipe, packed, stacked, interleaved and 1F1B schedules over P2P hops)
and the parameter-server hybrid (a row-sharded embedding table)."""

from tpudist_torch.parallel.data_parallel import (
    broadcast_params,
    make_dp_eval_step,
    make_dp_masked_eval_step,
    make_dp_train_loop,
    make_dp_train_step,
)
from tpudist_torch.parallel.pipeline import (
    ParamTree,
    StagePacking,
    interleave_params,
    make_1f1b_pipeline_train_step,
    make_interleaved_pipeline_train_step,
    make_packed_pipeline_train_step,
    make_pipeline_forward,
    make_pipeline_train_step,
    make_stacked_pipeline_train_step,
    pack_stage_params,
    shard_stage_params,
    stacked_state_specs,
    state_specs_like,
    unpack_stage_params,
)
from tpudist_torch.parallel.ps_hybrid import (
    make_ps_hybrid_forward,
    make_ps_hybrid_train_step,
    ps_state_specs,
    sharded_bag_lookup,
)
from tpudist_torch.parallel.ring_attention import (
    make_sp_train_step,
    ring_attention_fn,
    ring_flash_attention_fn,
    sp_forward,
    ulysses_attention_fn,
)

__all__ = [
    "ParamTree",
    "StagePacking",
    "broadcast_params",
    "interleave_params",
    "make_1f1b_pipeline_train_step",
    "make_interleaved_pipeline_train_step",
    "make_packed_pipeline_train_step",
    "make_pipeline_forward",
    "make_pipeline_train_step",
    "make_ps_hybrid_forward",
    "make_ps_hybrid_train_step",
    "make_stacked_pipeline_train_step",
    "pack_stage_params",
    "ps_state_specs",
    "shard_stage_params",
    "sharded_bag_lookup",
    "stacked_state_specs",
    "state_specs_like",
    "unpack_stage_params",
    "make_dp_eval_step",
    "make_dp_masked_eval_step",
    "make_dp_train_loop",
    "make_dp_train_step",
    "make_sp_train_step",
    "ring_attention_fn",
    "ring_flash_attention_fn",
    "sp_forward",
    "ulysses_attention_fn",
]
