"""FSDP / ZeRO-3: parameters and optimizer state sharded over the data
axis (counterpart of :mod:`tpudist.parallel.fsdp`).

tpudist shards each leaf's largest divisible dimension over the axis and
lets GSPMD gather before each use.  Here the schedule is written out
(:func:`~tpudist_torch.parallel.tensor_parallel.make_spmd_train_step`):
each process keeps its block of every sharded leaf as the parameter, so
the optimizer's state (Adam's moments) is made over the blocks; a step
all-gathers the blocks into whole tensors inside the differentiated
function, whose VJP reduce-scatters each gradient straight back to the
block (the ZeRO-3 schedule: whole gradients never persist), divides by
the axis size, averages the replicated leaves' gradients, and steps the
optimizer on the blocks alone.

With ``tp_rules`` a leaf matching a tensor-parallel rule keeps that
axis's claim and the FSDP axis takes the largest of the remaining
dimensions: the 2-D (fsdp × model) layout.  Dimensions are chosen on the
flax order of each leaf (an ``nn.Linear`` weight's ``[out, in]`` read as
``[in, out]``, a convolution's OIHW as HWIO), so a tie breaks toward the
later flax dimension, as tpudist's ``max((shape[d], d))`` does, and the
port shards the logical dimension tpudist's spec names.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from torch import nn

from tpudist_torch.parallel.tensor_parallel import (
    Rules,
    make_spmd_train_step,
    sharded_state,
    spec_tree_from_rules,
    _named_leaves,
)
from tpudist_torch.runtime.mesh import axis_size


def _flax_order(params: Any) -> dict[str, tuple[int, ...]]:
    """For each parameter, the torch dimensions in flax's order (flax
    dimension ``i`` is torch dimension ``order[i]``): reversed for an
    ``nn.Linear`` weight, HWIO for a convolution's OIHW weight, as they
    are for the rest (and for every leaf of a mapping or a tree)."""
    model = getattr(params, "model", params)
    out = {name: tuple(range(getattr(t, "ndim", 0)))
           for name, t in _named_leaves(params)}
    if isinstance(model, nn.Module):
        for mod_name, mod in model.named_modules():
            key = f"{mod_name}.weight" if mod_name else "weight"
            if key not in out:
                continue
            if isinstance(mod, nn.Linear):
                out[key] = (1, 0)
            elif isinstance(mod, nn.Conv2d):
                out[key] = (2, 3, 1, 0)
    return out


def _shard_leaf_spec(shape: Sequence[int], axis: str, axis_size: int,
                     taken: tuple | None = None) -> tuple:
    """tpudist's choice on a flax-ordered shape: the largest
    not-yet-taken dimension divisible by ``axis_size`` (ties: the later
    one), sharded over ``axis``; replicated when nothing divides."""
    base = list(taken) if taken is not None else [None] * len(shape)
    base += [None] * (len(shape) - len(base))
    candidates = [(shape[d], d) for d in range(len(shape))
                  if base[d] is None and shape[d] % axis_size == 0
                  and shape[d] >= axis_size]
    if not candidates:
        return tuple(base) if taken is not None else ()
    _, dim = max(candidates)
    base[dim] = axis
    return tuple(base)


def _size(mesh, axis: str) -> int:
    if isinstance(mesh, Mapping):
        return int(mesh[axis])
    return axis_size(mesh, axis)


def fsdp_specs(params: Any, mesh, axis: str = "data",
               tp_rules: Rules | None = None) -> dict[str, tuple]:
    """``{name: spec}`` sharding every leaf of ``params`` (a module, a
    :class:`TrainState` or a mapping) over ``axis``: the largest
    dimension divisible by the axis size, on the leaf's flax order;
    indivisible leaves replicate.  With ``tp_rules`` a matching leaf
    starts from its rule's spec and the FSDP axis takes a remaining
    dimension.  ``mesh`` is the mesh, or a mapping ``{axis: size}``."""
    n = _size(mesh, axis)
    order = _flax_order(params)
    tp = spec_tree_from_rules(params, tp_rules) if tp_rules else {}
    out = {}
    for name, leaf in _named_leaves(params):
        perm = order[name]
        shape = [leaf.shape[d] for d in perm]
        claim = tp.get(name, ())
        taken = None
        if claim:
            claim = list(claim) + [None] * (len(perm) - len(claim))
            taken = tuple(claim[d] for d in perm)
        flax_spec = _shard_leaf_spec(shape, axis, n, taken)
        if not flax_spec:
            out[name] = ()
            continue
        spec = [None] * len(perm)
        for i, d in enumerate(perm):
            spec[d] = flax_spec[i]
        out[name] = tuple(spec)
    return out


def make_fsdp_state(model: nn.Module, params: Mapping[str, Any], optimizer,
                    mesh, axis: str = "data", tp_rules: Rules | None = None,
                    seed: int = 0):
    """Shard the whole ``params`` (a ``state_dict``) FSDP-style into
    ``model`` (built for any tensor-parallel claim of ``tp_rules``) and
    build the state over the blocks, its optimizer state sharded alike.
    Returns ``(state, param_specs)``."""
    specs = fsdp_specs(model, mesh, axis, tp_rules)
    return sharded_state(model, params, optimizer, mesh, specs,
                         seed), specs


def make_fsdp_train_step(loss_fn, mesh, param_specs: Mapping[str, tuple],
                         donate: bool = True, *, axis: str = "data"):
    """The ZeRO-3 step over ``param_specs`` from :func:`fsdp_specs`:
    tpudist's GSPMD program, which its tests found reducing gradients with
    an all-reduce; written out here it is :func:`make_zero3_train_step`'s
    schedule (all-gather, reduce-scatter), over the batch axis ``axis``."""
    return make_spmd_train_step(loss_fn, mesh, param_specs, donate,
                                batch_axes=(axis,))


def make_zero3_train_step(loss_fn, mesh, param_specs: Mapping[str, tuple],
                          state_example=None, axis: str = "data",
                          donate: bool = True):
    """ZeRO-3 with the schedule written out: each step all-gathers every
    leaf sharded over ``axis`` (one dimension each) from the blocks,
    computes this process's gradients on its batch shard, reduce-scatters
    them back to the blocks' owners and divides by the axis size, averages
    the replicated leaves' gradients over ``axis``, and steps the optimizer
    on the local blocks only, so Adam's moments stay sharded.  ``loss_fn``
    is the mean loss over this process's rows; it gets the random stream
    of its shard (tpudist's ``fold_in(rng, axis_index(axis))``).
    ``state_example`` is accepted for tpudist's signature (the specs come
    from ``param_specs``)."""
    del state_example
    return make_spmd_train_step(loss_fn, mesh, param_specs, donate,
                                batch_axes=(axis,))
