"""Collectives under autograd (counterpart of :mod:`tpudist.parallel.common`).

tpudist differentiates through ``lax.psum`` inside ``shard_map`` with
``check_vma=False``, where the transpose of a ``psum`` is a ``psum``, and
adds the Megatron pair of custom-VJP operators for tensor-parallel
layers.  Here each is a ``torch.autograd.Function`` over a process group
(``None``: a group of one, where all three are the identity):

* :func:`psum` — an all-reduce whose VJP is an all-reduce of the
  cotangent (tpudist's ``psum`` as autodiff sees it).  A loss computed
  after it on every process of the group over-counts its cotangent by
  the group's size, so callers mask the loss to one process (as
  :func:`tpudist_torch.parallel.ps_hybrid.sharded_bag_lookup`'s step
  does) and sum what should be whole outside the differentiated path;
* :func:`psum_fwd_id_bwd` — an all-reduce whose VJP is the identity
  ("g": ends a row-parallel layer);
* :func:`id_fwd_psum_bwd` — the identity whose VJP is an all-reduce
  ("f": starts a column-parallel layer).

Every process of the group must make the same calls in the same order,
forward and backward.  tpudist's ``jit_sharded_step`` (``jit`` of a
``shard_map``) has no counterpart: an eager step is already the per-shard
program, and each strategy makes its own collectives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _PsumFwdIdBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IdFwdPsumBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its VJP sums the cotangent over
    ``group`` too."""
    return x if group is None else _Psum.apply(x, group)


def psum_fwd_id_bwd(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its VJP is the identity."""
    return x if group is None else _PsumFwdIdBwd.apply(x, group)


def id_fwd_psum_bwd(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its VJP sums the cotangent over ``group``."""
    return x if group is None else _IdFwdPsumBwd.apply(x, group)
