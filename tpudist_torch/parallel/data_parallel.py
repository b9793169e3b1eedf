"""Data parallelism: the gradient all-reduce over the mesh's data axis
(counterpart of :mod:`tpudist.parallel.data_parallel`).

Each process holds the whole model and its own shard of the batch: it
computes its gradients, averages them with every other process of the
data axis (one all-reduce per dtype of gradient, all parameters in one
flat buffer — tpudist's ``lax.pmean``), and applies the optimizer step
redundantly but identically.  The eval steps count correct predictions
and sum the counts over the axis.  :func:`broadcast_params` is the
``hvd.broadcast_parameters(root_rank=0)`` twin that makes the replicas
equal to begin with.  A world of one process is the plain step: no
collective is issued.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterable

import torch
import torch.distributed as dist
from torch import nn

from tpudist_torch.runtime.mesh import axis_index
from tpudist_torch.train.state import TrainState

# loss_fn(model, batch, generator) -> (loss, aux_dict); batch is a tuple of
# tensors
LossFn = Callable[[nn.Module, tuple, torch.Generator],
                  tuple[torch.Tensor, dict]]


def axis_groups(mesh, axes: Iterable[str]) -> list:
    """The process groups of ``axes`` on ``mesh`` (``None``: the whole
    world as one axis) that have more than one process."""
    if not (dist.is_available() and dist.is_initialized()):
        return []
    if mesh is None:
        return [dist.group.WORLD] if dist.get_world_size() > 1 else []
    return [mesh.get_group(a) for a in axes
            if dist.get_world_size(mesh.get_group(a)) > 1]


def all_reduce_sum(tensors: list[torch.Tensor], groups: list) -> None:
    """Sum ``tensors`` in place over each group in turn (over a grid of
    groups, the sum over the grid): one flat all-reduce per dtype."""
    if not groups:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        for group in groups:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))


def broadcast_params(model: nn.Module, mesh=None) -> nn.Module:
    """Give every process the parameters and buffers of the mesh's first
    rank (the whole world's rank 0 when ``mesh`` is None), in place."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return model
    src = 0 if mesh is None else int(mesh.mesh.flatten()[0])
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=src)
    return model


def _shard_index(mesh, axis: str) -> int:
    """This process's index along the data axis (its rank in the world
    when ``mesh`` is None; 0 without a process group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    if mesh is None:
        return dist.get_rank()
    return axis_index(mesh, axis)


def make_dp_train_step(loss_fn: LossFn, mesh=None, axis: str = "data",
                       donate: bool = True, accum_steps: int = 1):
    """Build ``train_step(state, *batch) -> (state, metrics)``; tpudist's
    signature and argument order.

    ``batch`` is this process's shard.  After the local backward the
    gradients, the loss and the ``aux`` entries are averaged over the
    mesh's ``axis`` group (``mesh=None``: over the whole world; a world
    of one: not at all), then the optimizer steps.  ``metrics["loss"]``
    is a detached device scalar and the ``aux`` entries detached tensors
    of the shape the loss_fn gave them (reading them syncs the host).
    With ``accum_steps > 1`` the local batch is split into that many
    sequential micro-batches whose gradients and metrics are averaged
    first — the same numerics as the single pass, activation memory
    divided by ``accum_steps``.

    ``loss_fn`` gets a generator of its own for each (data shard, step,
    micro-batch): :meth:`TrainState.generator`, so dropout masks differ
    between shards, micro-batches and steps and repeat from the state's
    seed.  ``donate`` is accepted for tpudist's signature and does
    nothing: an eager step updates the parameters in place, so there is
    no second copy to donate."""
    del donate
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mesh is not None and axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has axes {mesh.mesh_dim_names}, not "
                         f"{axis!r}")

    def train_step(state: TrainState, *batch: Any):
        for x in batch:
            if x.shape[0] % accum_steps:
                raise ValueError(f"batch {x.shape[0]} not divisible by "
                                 f"accum_steps={accum_steps}")
        state.optimizer.zero_grad(set_to_none=True)
        micro = zip(*(x.chunk(accum_steps) for x in batch))
        shard = _shard_index(mesh, axis)
        loss_sum, aux_sum = None, {}
        for i, mb in enumerate(micro):
            loss, aux = loss_fn(state.model, tuple(mb),
                                state.generator(shard, i))
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for k, v in aux.items():
                v = torch.as_tensor(v).detach()
                aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
        groups = axis_groups(mesh, [axis])
        n = 1
        for g in groups:
            n *= dist.get_world_size(g)
        if accum_steps > 1 or n > 1:
            grads = [p.grad for p in state.model.parameters()
                     if p.grad is not None]
            # the metrics as they come (any shape, any dtype), summed in
            # place with the gradients
            metrics = [loss_sum.clone()] + [v.clone()
                                            for v in aux_sum.values()]
            all_reduce_sum(grads + metrics, groups)
            inv = 1.0 / (accum_steps * n)
            for p in grads:
                p.mul_(inv)
            loss_sum = metrics[0] * inv
            aux_sum = {k: m * inv for k, m in zip(aux_sum, metrics[1:])}
        return state.apply_gradients(), {"loss": loss_sum, **aux_sum}

    return train_step


def make_dp_train_loop(loss_fn: LossFn, mesh=None, axis: str = "data",
                       donate: bool = True):
    """Build ``train_loop(state, *batches) -> (state, metrics)``;
    tpudist's signature.  Each batch tensor is ``[n_steps, local_batch,
    ...]`` (:meth:`ShardedLoader.epoch_stacked`); the loop runs the
    ``n_steps`` steps of :func:`make_dp_train_step` in order, so its
    numerics are those of ``n_steps`` calls of the step, and returns each
    metric stacked as ``[n_steps]``.  tpudist compiles the steps into one
    program to cut dispatches; an eager step dispatches each kernel
    anyway, so here the loop is the steps one after another."""
    step = make_dp_train_step(loss_fn, mesh, axis, donate)

    def train_loop(state: TrainState, *batches: torch.Tensor):
        n = batches[0].shape[0]
        if any(b.shape[0] != n for b in batches):
            raise ValueError("stacked batches disagree on the step count: "
                             f"{[b.shape[0] for b in batches]}")
        history = []
        for i in range(n):
            state, metrics = step(state, *(b[i] for b in batches))
            history.append(metrics)
        return state, {k: torch.stack([m[k] for m in history])
                       for k in history[0]}

    return train_loop


@contextlib.contextmanager
def _eval_mode(model: nn.Module):
    """``model`` in eval mode for the duration, in its own mode after."""
    was = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was)


def make_dp_eval_step(predict_fn: Callable[[nn.Module, tuple],
                                           torch.Tensor],
                      mesh=None, axis: str = "data"):
    """Build ``eval_step(model, *inputs, labels) -> correct``: this
    process's count of ``argmax(predict_fn(model, inputs)) == labels``,
    summed over the data axis (an int64 tensor on the model's device;
    reading it syncs the host).  Runs under ``torch.no_grad()`` with the
    model in eval mode.  Counts, not fractions, so the caller divides by
    what it fed; for padding-exact accuracy use
    :func:`make_dp_masked_eval_step`."""

    def eval_step(model: nn.Module, *batch: torch.Tensor) -> torch.Tensor:
        *inputs, labels = batch
        with torch.no_grad(), _eval_mode(model):
            logits = predict_fn(model, tuple(inputs))
        correct = (logits.argmax(-1) == labels).sum(dtype=torch.int64)
        all_reduce_sum([correct], axis_groups(mesh, [axis]))
        return correct

    return eval_step


def make_dp_masked_eval_step(predict_fn: Callable[[nn.Module, tuple],
                                                  torch.Tensor],
                             mesh=None, axis: str = "data"):
    """Exact counts: ``eval_step(model, *inputs, labels, mask) ->
    (correct, total)``, int64 tensors summed over the data axis.
    ``mask`` (bool, one per row; a numpy array or a tensor) marks real
    samples: the wrap-around padding of a ``drop_last=False`` loader
    (:meth:`ShardedLoader.valid_mask`) counts in neither, so accuracy is
    exact over the true dataset."""

    def eval_step(model: nn.Module, *batch):
        *inputs, labels, mask = batch
        with torch.no_grad(), _eval_mode(model):
            logits = predict_fn(model, tuple(inputs))
        mask = torch.as_tensor(mask, device=logits.device, dtype=torch.bool)
        hit = (logits.argmax(-1) == labels) & mask
        counts = [hit.sum(dtype=torch.int64), mask.sum(dtype=torch.int64)]
        all_reduce_sum(counts, axis_groups(mesh, [axis]))
        return counts[0], counts[1]

    return eval_step
