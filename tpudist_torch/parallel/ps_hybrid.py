"""Parameter-server hybrid parallelism: a row-sharded embedding table and
data-parallel dense layers on a ``data × model`` mesh (counterpart of
:mod:`tpudist.parallel.ps_hybrid`).

The reference hosts an ``EmbeddingBag(100, 16)`` on a parameter-server
rank behind ``RemoteModule`` lookups, runs DDP over a ``Linear(16, 8)``
on two trainers and routes the table's gradients back by
``dist_autograd`` (``server_model_data_parallel.py:114-185``).  As in
tpudist the server is a sharding:

* the table's rows are cut over ``model`` (each process of a model group
  holds ``V / model`` consecutive rows);
* the bag lookup is a masked gather over this process's rows plus one
  all-reduce over the model group (:func:`sharded_bag_lookup`), whose
  VJP is an all-reduce of the cotangent
  (:func:`tpudist_torch.parallel.common.psum`);
* the loss is masked to the first process of each model group, so that
  all-reduce hands every shard exactly one copy of the cotangent;
* the table's gradients are averaged over data; the dense gradients,
  produced on the first model process only, are summed over model and
  averaged over data (the DDP all-reduce).

``state.model`` is a module with the table as its parameter
``table_key`` (this process's rows) and the dense layers beside it, e.g.
:class:`~tpudist_torch.models.embedding.EmbeddingBagClassifier` built with
``num_embeddings = V / model``; ``dense_apply(model, bag)`` computes the
logits from the bag sums and must not read the table.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from tpudist_torch.parallel.common import psum
from tpudist_torch.parallel.data_parallel import all_reduce_sum, axis_groups
from tpudist_torch.runtime.mesh import axis_index, axis_size
from tpudist_torch.train.state import TrainState

# dense_apply(model, bag[b, D]) -> logits[b, C]
DenseApply = Callable[[nn.Module, torch.Tensor], torch.Tensor]


def _model_coords(mesh, model_axis: str):
    """``(group or None, shards, this process's shard)``."""
    if mesh is None:
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise ValueError(
                f"a sharded lookup over {dist.get_world_size()} processes "
                f"needs the mesh whose {model_axis!r} axis holds the table "
                "(pass mesh=)")
        return None, 1, 0
    n = axis_size(mesh, model_axis)
    group = mesh.get_group(model_axis) if n > 1 else None
    return group, n, axis_index(mesh, model_axis)


def _bag_contrib(local_table: torch.Tensor, indices: torch.Tensor,
                 mask: torch.Tensor, shard: int) -> torch.Tensor:
    """Shard ``shard``'s part of the bag sums: rows ``[shard·V_local,
    (shard+1)·V_local)`` of the table gathered and mask-weighted, other
    rows contributing zero."""
    v_local = local_table.shape[0]
    loc = indices.long() - shard * v_local
    in_shard = (loc >= 0) & (loc < v_local)
    rows = local_table[loc.clamp(0, v_local - 1)]
    weight = torch.where(in_shard, mask.to(rows.dtype),
                         torch.zeros((), dtype=rows.dtype,
                                     device=rows.device))
    return torch.einsum("blh,bl->bh", rows, weight)


def sharded_bag_lookup(local_table: torch.Tensor, indices: torch.Tensor,
                       mask: torch.Tensor, model_axis: str = "model", *,
                       mesh=None) -> torch.Tensor:
    """Masked bag-sum lookup over a row-sharded table (the reference's
    ``EmbeddingBag(mode="sum")``): ``local_table`` is this process's
    ``[V_local, D]`` rows, global row ``r`` living on model shard ``r //
    V_local``; ``indices``/``mask`` ``[B, L]``.  One all-reduce over the
    model group assembles the sums; its VJP all-reduces the cotangent.
    ``mesh=None``: one shard, no collective."""
    group, _, shard = _model_coords(mesh, model_axis)
    return psum(_bag_contrib(local_table, indices, mask, shard), group)


def ps_state_specs(state: TrainState, table_key: str = "embedding",
                   model_axis: str = "model") -> dict:
    """Which leaves are row-sharded: ``{"params": {name: spec},
    "opt_state": {index: {key: spec}}}``.  A parameter whose dotted name
    has ``table_key`` as a component (the table) and its optimizer state
    of the table's shape (the moments) get ``(model_axis,)``: rows cut
    over the model axis; everything else ``()``.  Matched by name, not by
    shape, so a dense weight of the table's shape is never cut."""
    params, opt = {}, {}
    for i, (name, p) in enumerate(state.model.named_parameters()):
        spec = (model_axis,) if table_key in name.split(".") \
            and p.dim() >= 1 else ()
        params[name] = spec
        opt[i] = {key: spec if getattr(val, "shape", ()) == p.shape else ()
                  for key, val in state.optimizer.state.get(p, {}).items()}
    return {"params": params, "opt_state": opt}


def _check_rows(num_embeddings: int, n: int, model_axis: str) -> None:
    if num_embeddings % n:
        raise ValueError(f"{num_embeddings} embedding rows not divisible by "
                         f"{model_axis}={n}")


def _table(model: nn.Module, table_key: str, rows: int) -> nn.Parameter:
    table = model.get_parameter(table_key)
    if table.shape[0] != rows:
        raise ValueError(f"{table_key} holds {table.shape[0]} rows, this "
                         f"process's shard is {rows}")
    return table


def make_ps_hybrid_train_step(
    dense_apply: DenseApply,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mesh,
    state_example: TrainState,
    num_embeddings: int,
    table_key: str = "embedding",
    data_axis: str = "data",
    model_axis: str = "model",
    donate: bool = True,
):
    """Build ``train_step(state, indices, mask, targets) -> (state,
    metrics)``, ``_run_trainer``'s forward, backward and step
    (``server_model_data_parallel.py:93-105``): ``state.model`` holds
    this process's ``V / model`` rows as ``table_key``; ``indices``,
    ``mask``, ``targets`` are this process's data shard (the same on
    every process of a model group).  ``metrics["loss"]`` is
    ``pmean(psum(masked loss, model), data)``.  ``donate`` is accepted
    for tpudist's signature."""
    del donate
    group, n, shard = _model_coords(mesh, model_axis)
    _check_rows(num_embeddings, n, model_axis)
    _table(getattr(state_example, "model", state_example), table_key,
           num_embeddings // n)
    model_groups = axis_groups(mesh, [model_axis]) if mesh is not None \
        else []
    data_groups = axis_groups(mesh, [data_axis]) if mesh is not None else []
    n_data = axis_size(mesh, data_axis) if mesh is not None else 1

    def train_step(state: TrainState, indices: torch.Tensor,
                   mask: torch.Tensor, targets: torch.Tensor):
        model = state.model
        table = _table(model, table_key, num_embeddings // n)
        state.optimizer.zero_grad(set_to_none=True)
        bag = psum(_bag_contrib(table, indices, mask, shard), group)
        loss = loss_fn(dense_apply(model, bag), targets)
        # masked to model column 0: the all-reduce in the backward then
        # gives every shard one copy of the cotangent
        torch.autograd.backward(loss, torch.full_like(
            loss, 1.0 if shard == 0 else 0.0))
        loss = loss.detach().float() * (1.0 if shard == 0 else 0.0)
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        dense = [p.grad for p in params if p is not table]
        all_reduce_sum(dense + [loss], model_groups)
        grads = [p.grad for p in params]
        all_reduce_sum(grads + [loss], data_groups)
        if n_data > 1:
            for g in grads:
                g.mul_(1.0 / n_data)
            loss.mul_(1.0 / n_data)
        return state.apply_gradients(), {"loss": loss}

    return train_step


def make_ps_hybrid_forward(
    dense_apply: DenseApply,
    mesh,
    state_example: TrainState,
    num_embeddings: int,
    table_key: str = "embedding",
    data_axis: str = "data",
    model_axis: str = "model",
):
    """Inference: ``fn(model, indices, mask) -> logits`` of this
    process's data shard, whole on every process of its model group
    (``state_example`` may be the state or its model)."""
    del data_axis
    group, n, shard = _model_coords(mesh, model_axis)
    _check_rows(num_embeddings, n, model_axis)
    _table(getattr(state_example, "model", state_example), table_key,
           num_embeddings // n)

    def forward(model: nn.Module, indices: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            table = _table(model, table_key, num_embeddings // n)
            bag = psum(_bag_contrib(table, indices, mask, shard), group)
            return dense_apply(model, bag)

    return forward
