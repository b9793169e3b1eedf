"""The port's ops, each TPU kernel a hand-written CUDA kernel for Hopper
with its plain PyTorch version beside it (counterpart of
:mod:`tpudist.ops`): :mod:`~tpudist_torch.ops.flash_attention` (kernels
K1, K3, K4), :mod:`~tpudist_torch.ops.flash_decode` (K2, K5, K6) and
:mod:`~tpudist_torch.ops.moe_dispatch` (K7, :func:`fused_moe_mlp`)."""

from tpudist_torch.ops.moe_dispatch import fused_moe_mlp

__all__ = ["fused_moe_mlp"]
