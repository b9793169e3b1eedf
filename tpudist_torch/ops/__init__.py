"""The port's ops, each TPU kernel a hand-written CUDA kernel for Hopper
with its plain PyTorch version beside it (counterpart of
:mod:`tpudist.ops`): :mod:`~tpudist_torch.ops.flash_attention` (kernels
K1, K3, K4, K8), :mod:`~tpudist_torch.ops.flash_decode` (K2, K5, K6),
:mod:`~tpudist_torch.ops.moe_dispatch` (K7, :func:`fused_moe_mlp`) and
:mod:`~tpudist_torch.ops.group_norm` (K9, K10, the fused GroupNorm);
:mod:`~tpudist_torch.ops.batch_norm` has no kernel.  The closed-form
``group_norm`` function is not re-exported here: ``from tpudist_torch.ops
import group_norm`` is the module."""

from tpudist_torch.ops.batch_norm import BatchNorm, batch_norm_train
from tpudist_torch.ops.group_norm import (
    GroupNorm,
    GroupNormFast,
    group_norm_act,
    group_norm_add_relu,
)
from tpudist_torch.ops.moe_dispatch import fused_moe_mlp

__all__ = [
    "BatchNorm",
    "GroupNorm",
    "GroupNormFast",
    "batch_norm_train",
    "fused_moe_mlp",
    "group_norm_act",
    "group_norm_add_relu",
]
