"""Tensor (Megatron) parallelism and the per-shard step every sharded
layout shares (counterpart of :mod:`tpudist.parallel.tensor_parallel`).

tpudist states a layout as a ``PartitionSpec`` per parameter and lets
GSPMD partition one global program.  Here the layout is the same rule
language (path pattern → spec, first match wins, unmatched leaves
replicate), with specs as tuples of axis names (``P(None, "model")`` is
``(None, "model")``), but the program is written per shard: each process
holds the block of every leaf its spec gives it (:func:`shard_tree`), the
model's modules issue the tensor-parallel collectives themselves
(:class:`~tpudist_torch.models.transformer.TransformerLM` with
``tp_axis=``), and :func:`make_spmd_train_step` gathers what is sharded
over a batch axis (ZeRO-3), averages the gradients over the batch axes and
steps the optimizer on the local blocks.

The port's parameters are ``nn.Module`` parameters named as the module
names them (``blocks.0.attn.qkv.weight``), matched with ``/`` for ``.``
(``blocks/0/attn/qkv/weight``), and laid out as torch lays them out: an
``nn.Linear`` weight is ``[out, in]``, flax's kernel ``[in, out]``
transposed.  So :func:`transformer_tp_rules` names the port's leaves and
states tpudist's Megatron layout in torch's order: a column-parallel
projection shards dimension 0 of its weight (``P(None, "model")`` on the
flax kernel), a row-parallel one dimension 1.

A fused projection (``qkv`` is ``(3, H, Dh)`` along its output rows,
GQA's ``kv`` ``(2, Hkv, Dh)``) is cut into whole heads of each part: its
spec entry is a :class:`Parts` axis name, which cuts each of the parts
into the axis's blocks and keeps block ``r`` of every part.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.distributed as dist
from torch import nn

from tpudist_torch.parallel.common import all_gather
from tpudist_torch.parallel.data_parallel import all_reduce_sum
from tpudist_torch.runtime.mesh import axis_index, axis_size
from tpudist_torch.train.state import TrainState
from tpudist_torch.utils.trees import _leaves

# loss_fn(model, batch, generator) -> (loss, aux) on this process's batch
# shard (the mean over its rows), through a model laid out for the mesh
LossFn = Callable[[nn.Module, tuple, torch.Generator],
                  tuple[torch.Tensor, dict]]

Rules = Sequence[tuple[str, tuple]]


class Parts(str):
    """An axis name in a spec that cuts its dimension as ``parts`` equal
    pieces, each into the axis's blocks: block ``r`` of the dimension is
    block ``r`` of every piece, in order.  It compares equal to the axis
    name, so specs read as tpudist's."""

    def __new__(cls, axis: str, parts: int):
        self = super().__new__(cls, axis)
        self.parts = parts
        return self

    def __reduce__(self):
        return Parts, (str(self), self.parts)


def _parts(entry) -> int:
    return getattr(entry, "parts", 1)


def _named_leaves(params: Any) -> list[tuple[str, Any]]:
    """``(name, leaf)`` in parameter order: a module's (or a state's
    model's) named parameters, a mapping's items, a tree's ``/`` paths."""
    params = getattr(params, "model", params)
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    if isinstance(params, Mapping) and all(
            not isinstance(v, (Mapping, list, tuple))
            for v in params.values()):
        return list(params.items())
    return list(_leaves(params))


def spec_tree_from_rules(params: Any, rules: Rules) -> dict[str, tuple]:
    """``{name: spec}`` over the leaves of ``params`` (a module, a
    :class:`TrainState`, a ``state_dict``-like mapping or a nested tree),
    in parameter order: each name, with ``/`` for ``.``, is matched
    against the ``rules`` patterns (``re.search``, first match wins);
    unmatched leaves replicate (``()``)."""
    compiled = [(re.compile(pat), tuple(spec)) for pat, spec in rules]
    out = {}
    for name, _ in _named_leaves(params):
        path = name.replace(".", "/")
        out[name] = next((spec for pat, spec in compiled
                          if pat.search(path)), ())
    return out


def transformer_tp_rules(axis: str = "model") -> Rules:
    """tpudist's Megatron layout of a
    :class:`~tpudist_torch.models.transformer.TransformerLM`, in the
    port's names and torch's weight order: ``qkv``/``q``/``kv`` and
    ``up`` column-parallel (dimension 0 of the ``[out, in]`` weight;
    ``qkv`` and ``kv`` cut by whole heads of each part), ``proj`` and
    ``down`` row-parallel (dimension 1), the token table split by
    vocabulary rows, the head by vocabulary columns (its weight's rows),
    the position table and the norms replicated.  GQA needs
    ``num_kv_heads % tp == 0`` (the model raises)."""
    return [
        (r"attn/qkv/weight", (Parts(axis, 3), None)),
        (r"attn/q/weight", (axis, None)),
        (r"attn/kv/weight", (Parts(axis, 2), None)),
        (r"attn/proj/weight", (None, axis)),
        (r"mlp/up/weight", (axis, None)),
        (r"mlp/down/weight", (None, axis)),
        (r"tok_embed/weight", (axis, None)),
        (r"pos_embed/weight", ()),
        (r"lm_head/weight", (axis, None)),
    ]


def _axis_coords(mesh, axis: str) -> tuple[int, int]:
    """``(index, size)`` of this process on ``axis``; ``mesh`` may also be
    a mapping ``{axis: (index, size)}`` (a cut made without a process
    group, as the converters do)."""
    if isinstance(mesh, Mapping):
        return mesh[axis]
    return axis_index(mesh, axis), axis_size(mesh, axis)


def cut_leaf(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This process's block of ``x`` by ``spec``: dimension ``i`` cut into
    ``spec[i]``'s blocks (a tuple of axes: the first major), each
    :class:`Parts` piece separately; ``None`` keeps it whole."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        index, n = 0, 1
        for a in axes:
            i, size = _axis_coords(mesh, a)
            index, n = index * size + i, n * size
        parts = _parts(entry)
        if x.shape[dim] % (n * parts):
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} not "
                             f"divisible into {parts} x {entry}={n} blocks")
        x = torch.cat([p.chunk(n, dim)[index]
                       for p in x.chunk(parts, dim)], dim)
    return x


def join_blocks(blocks: Sequence[torch.Tensor], dim: int,
                parts: int = 1) -> torch.Tensor:
    """The inverse of one axis's cut along ``dim``: the blocks of every
    process, in order, joined (piece by piece for ``parts`` > 1)."""
    pieces = [b.chunk(parts, dim) for b in blocks]
    return torch.cat([torch.cat([p[k] for p in pieces], dim)
                      for k in range(parts)], dim)


def shard_tree(tree: Mapping[str, Any], mesh,
               specs: Mapping[str, tuple]) -> dict[str, torch.Tensor]:
    """Each leaf's block on this process (:func:`cut_leaf`), copied:
    tpudist's ``device_put`` with a ``NamedSharding`` per leaf.  ``tree``
    is a mapping of names to tensors or arrays (a whole model's
    ``state_dict``); leaves without a spec are kept whole."""
    out = {}
    for name, leaf in tree.items():
        t = torch.as_tensor(leaf)
        out[name] = cut_leaf(t, specs.get(name, ()), mesh).clone()
    return out


def gather_tree(tree: Mapping[str, torch.Tensor], mesh,
                specs: Mapping[str, tuple]) -> dict[str, torch.Tensor]:
    """The whole leaves back from every process's blocks (the inverse of
    :func:`shard_tree`), on every process: one all-gather per sharded
    dimension and axis.  A collective: every process of the mesh calls
    it with the same names in the same order."""
    out = {}
    with torch.no_grad():
        for name, t in tree.items():
            t = t.detach()
            for dim, entry in reversed(list(enumerate(specs.get(name, ())))):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                for a in reversed(axes):
                    group = mesh.get_group(a)
                    n = dist.get_world_size(group)
                    parts = 1 if len(axes) > 1 else _parts(entry)
                    blocks = all_gather(t.contiguous(), group,
                                        dim).chunk(n, dim)
                    t = join_blocks(blocks, dim, parts)
            out[name] = t
    return out


def shard_batch(batch: Any, mesh, axis: str | tuple = "data") -> Any:
    """This process's rows of every batch tensor: the leading dimension
    cut over ``axis`` (a tuple of axes: the first major)."""
    spec = (axis,)
    if isinstance(batch, torch.Tensor):
        return cut_leaf(batch, spec, mesh)
    return type(batch)(cut_leaf(torch.as_tensor(x), spec, mesh)
                       for x in batch)


def assign_params(model: nn.Module,
                  tensors: Mapping[str, torch.Tensor]) -> nn.Module:
    """Replace ``model``'s parameters by ``tensors`` (by name, on the
    parameter's device and dtype), whatever their shapes: a sharded
    state's parameters are the blocks this process keeps, which a
    ZeRO-3 step gathers before each use.  Every parameter must be
    named."""
    params = dict(model.named_parameters())
    missing = set(params) - set(tensors)
    extra = set(tensors) - set(params)
    if missing or extra:
        raise ValueError(f"parameters not given: {sorted(missing)}; "
                         f"unknown: {sorted(extra)}")
    with torch.no_grad():
        for name, p in params.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            mod._parameters[leaf] = nn.Parameter(
                torch.as_tensor(tensors[name]).to(device=p.device,
                                                   dtype=p.dtype).clone(),
                requires_grad=p.requires_grad)
    return model


def sharded_state(model: nn.Module, params: Mapping[str, Any], optimizer,
                  mesh, specs: Mapping[str, tuple],
                  seed: int = 0) -> TrainState:
    """A :class:`TrainState` of ``model`` holding this process's blocks of
    the whole ``params`` by ``specs``; the optimizer is made over the
    blocks, so its state (Adam's moments) is sharded alike."""
    assign_params(model, shard_tree(params, mesh, specs))
    return TrainState.create(model, optimizer, seed=seed)


def make_tp_state(model: nn.Module, params: Mapping[str, Any], optimizer,
                  mesh, rules: Rules | None = None,
                  seed: int = 0) -> tuple[TrainState, dict]:
    """Shard the whole ``params`` (a ``state_dict``) by ``rules``
    (default :func:`transformer_tp_rules`) into ``model``, which is built
    for the layout (``tp_axis=`` over ``mesh``), and build the state over
    the blocks.  Returns ``(state, param_specs)``."""
    specs = spec_tree_from_rules(model, rules or transformer_tp_rules())
    return sharded_state(model, params, optimizer, mesh, specs,
                         seed), specs


class _Gathered:
    """``model`` called with the given tensors in place of its
    parameters (``torch.func.functional_call``); other attributes are
    the model's."""

    def __init__(self, model: nn.Module, tensors: dict) -> None:
        self._model, self._tensors = model, tensors

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self._model, self._tensors, args,
                                          kwargs)

    def __getattr__(self, name):
        return getattr(self._model, name)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Sequence) -> set:
    """The mesh axes a spec shards over."""
    return {a for entry in spec for a in _entry_axes(entry)}


class ShardedParams:
    """How a step treats each parameter of a layout: the dimensions it
    gathers before use (those sharded over a batch axis: ZeRO-3), and
    the batch axes its gradient is summed over after the backward (those
    its spec does not name)."""

    def __init__(self, mesh, param_specs: Mapping[str, tuple],
                 batch_axes: Sequence[str]) -> None:
        self.mesh, self.batch_axes = mesh, tuple(batch_axes)
        self.specs = dict(param_specs)
        self.gathers: dict[str, list[tuple[int, str]]] = {}
        self.sums: dict[str, tuple[str, ...]] = {}
        for name, spec in self.specs.items():
            dims = []
            for d, entry in enumerate(spec):
                axes = _entry_axes(entry)
                hit = [a for a in axes if a in self.batch_axes]
                if hit and (len(axes) > 1 or _parts(entry) > 1):
                    raise ValueError(
                        f"{name}: spec {spec} gathers dimension {d} over "
                        f"{entry}; a batch axis must shard a dimension "
                        "alone")
                dims += [(d, a) for a in hit]
            self.gathers[name] = dims
            self.sums[name] = tuple(a for a in self.batch_axes
                                    if a not in spec_axes(spec))
        self.n_batch = math.prod(axis_size(mesh, a) for a in self.batch_axes)

    def check(self, model: nn.Module) -> list[tuple[str, nn.Parameter]]:
        """The model's named parameters, once they are the layout's and
        every MoE layer routes over the batch axes (a GSPMD program routes
        over its global batch)."""
        from tpudist_torch.models.moe import MoEMLP

        named = list(model.named_parameters())
        if [n for n, _ in named] != list(self.specs):
            raise ValueError("param_specs name other parameters than the "
                             "model's (in its order)")
        for name, m in model.named_modules():
            if not isinstance(m, MoEMLP):
                continue
            axes = m.routing.axes if m.routing is not None else None
            if axes != self.batch_axes:
                raise ValueError(
                    f"{name} routes over {axes}, the step's batch over "
                    f"{self.batch_axes}: build the model with "
                    f"routing_axes={self.batch_axes}")
        return named

    def full(self, named) -> dict[str, torch.Tensor] | None:
        """The gathered tensors by name (None when nothing is gathered):
        each batch-axis dimension joined, its VJP the reduce-scatter."""
        if not any(self.gathers.values()):
            return None
        out = {}
        for name, p in named:
            t = p
            for d, a in self.gathers[name]:
                t = all_gather(t, self.mesh.get_group(a), d)
            out[name] = t
        return out

    def shard_index(self) -> int:
        """This process's data shard: its row-major index over the batch
        axes (every process of a shard draws the same random stream)."""
        index = 0
        for a in self.batch_axes:
            index = index * axis_size(self.mesh, a) + axis_index(self.mesh,
                                                                 a)
        return index

    def sync(self, named) -> None:
        """Each gradient summed over the batch axes its spec does not
        name (a gathered dimension's reduce-scatter summed the rest), then
        divided by the batch axes' size: the mean over data shards."""
        by_axes: dict[tuple, list[torch.Tensor]] = {}
        for name, p in named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            by_axes.setdefault(self.sums[name], []).append(p.grad)
        for axes, grads in by_axes.items():
            all_reduce_sum(grads, [self.mesh.get_group(a) for a in axes])
            for g in grads:
                g.div_(self.n_batch)

    def mean(self, values: list[torch.Tensor]) -> list[torch.Tensor]:
        """Metrics averaged over the batch axes."""
        values = [v.detach().clone() for v in values]
        all_reduce_sum(values, [self.mesh.get_group(a)
                                for a in self.batch_axes])
        return [v / self.n_batch for v in values]


def make_spmd_train_step(loss_fn: LossFn, mesh, param_specs: Mapping[str,
                                                                    tuple],
                         donate: bool = True, *,
                         batch_axes: Sequence[str] = ("data",)):
    """Build ``train_step(state, *batch) -> (state, metrics)`` for any
    layout of ``param_specs`` over ``mesh``: tpudist's GSPMD step written
    out per shard.

    ``batch`` is this process's block of the global batch (its rows over
    ``batch_axes``), and ``loss_fn`` returns the mean loss over it through
    ``state.model``, whose modules issue their own tensor- or
    expert-parallel collectives.  A leaf sharded over a batch axis (ZeRO-3,
    :func:`~tpudist_torch.parallel.fsdp.fsdp_specs`) is all-gathered
    before the forward, its gradient reduce-scattered back to the block
    by the gather's VJP; every gradient is then summed over the batch axes
    its spec does not name and divided by their size: the mean over data
    shards.  Leaves sharded over a model or expert axis keep their
    gradients local; replicated leaves there are complete on every process
    (the Megatron f/g pair), so no gradient is ever summed over an axis
    whose processes hold the same contribution.  An MoE model must be
    built with ``routing_axes`` equal to ``batch_axes`` (it then routes
    over the global batch, as the GSPMD program does), else the step
    raises ``ValueError``.  The loss and the aux
    entries are averaged over the batch axes.  Every collective runs on
    its axis's group whatever its size, so a mesh of one-process axes
    still issues each of them.  ``loss_fn`` gets the generator of its data
    shard (:meth:`TrainState.generator`; tpudist's ``fold_in(rng,
    axis_index)``).  ``donate`` is accepted for tpudist's signature."""
    del donate
    layout = ShardedParams(mesh, param_specs, batch_axes)

    def train_step(state: TrainState, *batch):
        named = layout.check(state.model)
        state.optimizer.zero_grad(set_to_none=True)
        full = layout.full(named)
        model = state.model if full is None else _Gathered(state.model, full)
        loss, aux = loss_fn(model, tuple(batch),
                            state.generator(layout.shard_index()))
        loss.backward()
        layout.sync(named)
        keys = list(aux)
        vals = layout.mean([loss] + [torch.as_tensor(aux[k]) for k in keys])
        return state.apply_gradients(), {"loss": vals[0],
                                         **dict(zip(keys, vals[1:]))}

    train_step.param_specs = dict(param_specs)
    train_step.batch_axes = tuple(batch_axes)
    return train_step
