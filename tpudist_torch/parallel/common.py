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
  ("f": starts a column-parallel layer);
* :func:`all_gather` — the blocks of every process joined along a
  dimension, whose VJP is the reduce-scatter of the cotangent (ZeRO-3's
  parameter gather: ``lax.all_gather(tiled=True)`` and its transpose);
* :func:`all_gather_fwd_slice_bwd` — the same join whose VJP takes this
  process's block of the cotangent (a vocabulary-parallel head's logits,
  after which every process of the group computes the same loss);
* :func:`all_to_all` — ``lax.all_to_all(tiled=True)``: block ``j`` of one
  dimension to process ``j``, the blocks received joined along another;
  its VJP is the reverse exchange (expert parallelism's token dispatch).

:data:`CALLS` counts the collectives these functions issue, by kind
(``all_reduce``, ``all_gather``, ``reduce_scatter``, ``all_to_all``),
forward and backward, so a test can tell the schedules apart as
tpudist's tests read them from the compiled HLO.

Every process of the group must make the same calls in the same order,
forward and backward.  tpudist's ``jit_sharded_step`` (``jit`` of a
``shard_map``) has no counterpart: an eager step is already the per-shard
program, and each strategy makes its own collectives.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# collectives issued by this module's functions, by kind
CALLS: collections.Counter = collections.Counter()

# torch renamed the tensor forms (2.13); the card's build may predate it
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def reset_calls() -> None:
    CALLS.clear()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    CALLS["all_reduce"] += 1
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((n * front.shape[0], *front.shape[1:]))
    CALLS["all_gather"] += 1
    _ALL_GATHER(out, front, group=group)
    # the whole tensor in its own layout: a product then takes the same
    # path (and rounding) as on an unsharded tensor
    return out.movedim(0, dim).contiguous()


def _scatter_sum(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    front = g.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
    CALLS["reduce_scatter"] += 1
    _REDUCE_SCATTER(out, front, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


def _block(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return g.chunk(n, dim)[dist.get_rank(group)].contiguous()


def _exchange(x: torch.Tensor, group, split: int, concat: int
              ) -> torch.Tensor:
    """Tiled all-to-all: block ``j`` of dimension ``split`` to process
    ``j``; the blocks received, in process order, joined along
    ``concat``."""
    n = dist.get_world_size(group)
    front = x.movedim(split, 0)
    rest = front.shape[1:]
    send = front.reshape(n, front.shape[0] // n, *rest).contiguous()
    recv = torch.empty_like(send)
    CALLS["all_to_all"] += 1
    dist.all_to_all_single(recv, send, group=group)
    at = concat + 1 if concat < split else concat
    return torch.cat(recv.unbind(0), dim=at).movedim(0, split)


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


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


class _AllGatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _exchange(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g, ctx.group, ctx.concat, ctx.split), None, None,
                None)


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


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every process's block of ``x`` joined along ``dim`` in process
    order; its VJP sums the cotangent over ``group`` and keeps this
    process's block (a reduce-scatter)."""
    return x if group is None else _AllGather.apply(x, group, dim)


def all_gather_fwd_slice_bwd(x: torch.Tensor, group,
                             dim: int = 0) -> torch.Tensor:
    """The join of :func:`all_gather`; its VJP is this process's block
    of the cotangent, which every process of the group holds whole."""
    return x if group is None else _AllGatherSlice.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group, split: int,
               concat: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split, concat_axis=concat,
    tiled=True)``: block ``j`` of dimension ``split`` goes to process
    ``j``, and the blocks received are joined along ``concat``; its VJP
    is the reverse exchange."""
    return x if group is None else _AllToAll.apply(x, group, split, concat)
