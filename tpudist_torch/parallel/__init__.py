"""The port's parallel strategies (counterpart of :mod:`tpudist.parallel`):
data parallelism across processes and sequence parallelism (ring, ring
flash and Ulysses attention, the DP×SP train step)."""

from tpudist_torch.parallel.data_parallel import (
    broadcast_params,
    make_dp_eval_step,
    make_dp_masked_eval_step,
    make_dp_train_loop,
    make_dp_train_step,
)
from tpudist_torch.parallel.ring_attention import (
    make_sp_train_step,
    ring_attention_fn,
    ring_flash_attention_fn,
    sp_forward,
    ulysses_attention_fn,
)

__all__ = [
    "broadcast_params",
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
