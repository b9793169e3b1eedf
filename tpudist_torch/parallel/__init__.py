"""The port's parallel strategies (counterpart of :mod:`tpudist.parallel`):
one composed mesh (:mod:`~tpudist_torch.parallel.mesh`: a
:class:`MeshSpec` of dp × fsdp × tp × pp × ep axis sizes and
:func:`make_composed_train_step`), built from data parallelism across
processes, tensor (Megatron) parallelism and the per-shard step every
sharded layout shares, FSDP / ZeRO-3, expert parallelism, pipeline
parallelism (GPipe, packed, stacked, interleaved and 1F1B schedules over
P2P hops, with tensor-parallel blocks), sequence parallelism (ring, ring
flash and Ulysses attention, the DP×SP train step) and the
parameter-server hybrid (a row-sharded embedding table)."""

# the trainer imports this package's modules, and they import
# tpudist_torch.train.state: load the train package first, so whichever of
# the two is imported first, neither meets the other half-initialised
import tpudist_torch.train  # noqa: F401, I001

from tpudist_torch.parallel.data_parallel import (
    broadcast_params,
    make_dp_eval_step,
    make_dp_masked_eval_step,
    make_dp_train_loop,
    make_dp_train_step,
)
from tpudist_torch.parallel.expert_parallel import (
    make_ep_shard_train_step,
    make_ep_state,
    make_ep_train_step,
    moe_ep_rules,
)
from tpudist_torch.parallel.fsdp import (
    fsdp_specs,
    make_fsdp_state,
    make_fsdp_train_step,
    make_zero3_train_step,
)
from tpudist_torch.parallel.mesh import (
    MESH_AXES,
    MeshSpec,
    make_composed_eval_step,
    make_composed_state,
    make_composed_train_step,
    shard_composed_batch,
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
from tpudist_torch.parallel.tensor_parallel import (
    gather_tree,
    make_spmd_train_step,
    make_tp_state,
    shard_batch,
    shard_tree,
    spec_tree_from_rules,
    transformer_tp_rules,
)

__all__ = [
    "MESH_AXES",
    "MeshSpec",
    "fsdp_specs",
    "gather_tree",
    "make_composed_eval_step",
    "make_composed_state",
    "make_composed_train_step",
    "make_ep_shard_train_step",
    "make_ep_state",
    "make_ep_train_step",
    "make_fsdp_state",
    "make_fsdp_train_step",
    "make_spmd_train_step",
    "make_tp_state",
    "make_zero3_train_step",
    "moe_ep_rules",
    "shard_batch",
    "shard_composed_batch",
    "shard_tree",
    "spec_tree_from_rules",
    "transformer_tp_rules",
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
