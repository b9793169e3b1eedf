"""The port's attention ops, each a hand-written CUDA kernel for Hopper
with its plain PyTorch version beside it (counterpart of
:mod:`tpudist.ops`): :mod:`~tpudist_torch.ops.flash_attention` (kernel K1)
and :mod:`~tpudist_torch.ops.flash_decode` (kernel K2)."""
