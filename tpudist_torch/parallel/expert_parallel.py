"""Expert parallelism: MoE expert stacks sharded over an ``expert`` axis
(counterpart of :mod:`tpudist.parallel.expert_parallel`).

tpudist states it as a layout (the stacks ``P("expert", None, None)``,
the router replicated) and lets GSPMD partition the dispatch, which its
tests found lowering to replicated tokens plus an all-reduce; its
``shard_map`` step runs the canonical all-to-all dispatch instead.  Both
are written out here, the collectives in
:class:`~tpudist_torch.models.moe.MoEMLP` (``ep_axis=``):

* :func:`make_ep_train_step` — the batch sharded over ``data`` only; the
  model built with ``ep_tokens="replicated"``: each expert process applies
  its own experts to the data shard's tokens and the partial outputs are
  summed over the expert group;
* :func:`make_ep_shard_train_step` — the batch sharded over ``(data,
  expert)``; the model built with ``ep_tokens="sharded"``: the all-to-all
  pair, and tpudist's sum contract for the loss.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
from torch import nn

from tpudist_torch.parallel.data_parallel import all_reduce_sum
from tpudist_torch.parallel.tensor_parallel import (
    Rules,
    make_spmd_train_step,
    make_tp_state,
    spec_axes,
    spec_tree_from_rules,
)
from tpudist_torch.train.state import TrainState


def moe_ep_rules(axis: str = "expert") -> Rules:
    """Partition rules for :class:`~tpudist_torch.models.moe.
    MoETransformerLM`: the expert stacks sharded on their expert
    dimension, the router replicated, everything else (attention,
    embeddings, norms) replicated; compose with
    :func:`~tpudist_torch.parallel.tensor_parallel.transformer_tp_rules`
    or :func:`~tpudist_torch.parallel.fsdp.fsdp_specs`."""
    return [
        (r"moe/w_up", (axis, None, None)),
        (r"moe/w_down", (axis, None, None)),
        (r"moe/router", ()),
    ]


def make_ep_state(model: nn.Module, params: Mapping[str, Any], optimizer,
                  mesh, axis: str = "expert", extra_rules: Rules = (),
                  seed: int = 0) -> tuple[TrainState, dict]:
    """Shard the whole ``params`` over ``axis`` (plus any
    ``extra_rules``, which win on conflict) into ``model`` (built with
    ``ep_axis=axis``) and build the state over the blocks.  Returns
    ``(state, param_specs)``."""
    rules = list(extra_rules) + list(moe_ep_rules(axis))
    return make_tp_state(model, params, optimizer, mesh, rules=rules,
                         seed=seed)


def make_ep_train_step(loss_fn, mesh, param_specs: Mapping[str, tuple],
                       donate: bool = True, *, data_axis: str = "data"):
    """DP×EP: tpudist's GSPMD program as it lowers, replicated tokens
    plus an all-reduce.  ``batch`` is this process's rows over
    ``data_axis`` (the expert processes of a data shard hold the same
    rows), the model is built with ``ep_axis`` and
    ``ep_tokens="replicated"``, and ``loss_fn`` returns the mean loss over
    the rows.  Gradients are averaged over ``data_axis`` alone: each
    expert stack's gradient is its process's, every replicated leaf's is
    whole on every expert process."""
    return make_spmd_train_step(loss_fn, mesh, param_specs, donate,
                                batch_axes=(data_axis,))


def make_ep_shard_train_step(
    loss_fn: Callable[[nn.Module, tuple], torch.Tensor],
    mesh,
    state_example: TrainState,
    data_axis: str = "data",
    expert_axis: str = "expert",
    donate: bool = True,
):
    """The explicit DP×EP step, tpudist's ``shard_map`` contract:

    * the model is built with ``ep_axis=expert_axis`` (and
      ``ep_tokens="sharded"``), so each MoE layer routes this process's
      tokens to all experts and ships them through the all-to-all pair;
    * ``batch`` is this process's rows over ``(data_axis, expert_axis)``;
    * ``loss_fn(model, batch) -> scalar`` returns this shard's loss
      CONTRIBUTION: the global loss is its sum over every process
      (per-token sums over the GLOBAL token count, aux terms over the
      shard count).

    Expert-sharded leaves get complete expert-axis gradients through the
    reverse all-to-alls and are summed over ``data_axis``; replicated
    leaves see this process's tokens and are summed over both axes; the
    loss metric is the sum over both."""
    del donate
    specs = spec_tree_from_rules(state_example, moe_ep_rules(expert_axis))
    groups = {a: mesh.get_group(a) for a in (data_axis, expert_axis)}
    sums = [tuple(groups[a] for a in ((data_axis,) if expert_axis in
                                      spec_axes(s) else
                                      (data_axis, expert_axis)))
            for s in specs.values()]

    def train_step(state: TrainState, *batch):
        params = list(state.model.parameters())
        if len(params) != len(sums):
            raise ValueError("the state's model has other parameters than "
                             "state_example's")
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, tuple(batch))
        loss.backward()
        by_groups: dict[tuple, list[torch.Tensor]] = {}
        for p, gs in zip(params, sums):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            by_groups.setdefault(gs, []).append(p.grad)
        for gs, grads in by_groups.items():
            all_reduce_sum(grads, list(gs))
        total = loss.detach().clone()
        all_reduce_sum([total], list(groups.values()))
        return state.apply_gradients(), {"loss": total}

    train_step.param_specs = specs
    return train_step
