"""The data-parallel train step for one process (counterpart of
:mod:`tpudist.parallel.data_parallel`).

On one GPU the JAX step's ``pmean`` over the data axis is the identity, so
the step is: gradients of ``loss_fn`` on the batch, averaged over
``accum_steps`` micro-batches, then one optimizer step.  The all-reduce
across processes is not ported yet: with an initialised
``torch.distributed`` group of more than one rank the step raises.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch import nn

from tpudist_torch.train.state import TrainState

# loss_fn(model, batch, generator) -> (loss, aux_dict); batch is a tuple of
# tensors
LossFn = Callable[[nn.Module, tuple, torch.Generator],
                  tuple[torch.Tensor, dict]]

_DP_TODO = ("make_dp_train_step across processes (the gradient all-reduce) "
            "is not ported yet (ROADMAP Queue A 7: parallel strategies on "
            "torch.distributed, data_parallel)")


def make_dp_train_step(loss_fn: LossFn, accum_steps: int = 1):
    """Build ``train_step(state, *batch) -> (state, metrics)``.

    ``metrics["loss"]`` and the ``aux`` entries are detached device
    scalars (reading them syncs the host).  With ``accum_steps > 1`` the
    batch is split into that many sequential micro-batches whose
    gradients and metrics are averaged — the same numerics as the single
    pass, activation memory divided by ``accum_steps``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def train_step(state: TrainState, *batch: Any):
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise NotImplementedError(_DP_TODO)
        for x in batch:
            if x.shape[0] % accum_steps:
                raise ValueError(f"batch {x.shape[0]} not divisible by "
                                 f"accum_steps={accum_steps}")
        state.optimizer.zero_grad(set_to_none=True)
        micro = zip(*(x.chunk(accum_steps) for x in batch))
        loss_sum, aux_sum = None, {}
        for mb in micro:
            loss, aux = loss_fn(state.model, tuple(mb), state.generator)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for k, v in aux.items():
                v = torch.as_tensor(v).detach()
                aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            for p in state.model.parameters():
                if p.grad is not None:
                    p.grad.mul_(inv)
            loss_sum = loss_sum * inv
            aux_sum = {k: v * inv for k, v in aux_sum.items()}
        return state.apply_gradients(), {"loss": loss_sum, **aux_sum}

    return train_step
