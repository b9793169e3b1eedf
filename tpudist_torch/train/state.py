"""Train state (counterpart of :mod:`tpudist.train.state`).

The JAX state is a pytree of params, optimizer state, step and PRNG key;
here the model holds the parameters, the optimizer its state, and a
``torch.Generator`` stands in for the key.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Iterable

import torch
from torch import nn

_SHARDED_TODO = ("TrainState.create_sharded is not ported yet (ROADMAP "
                 "Queue A: parallel strategies on torch.distributed, "
                 "MeshSpec)")

# params -> optimizer, the counterpart of an optax GradientTransformation
OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


def adam(lr: float) -> OptimizerFactory:
    """The twin of ``optax.adam(lr)``: betas 0.9/0.999, eps 1e-8 outside
    the square root, bias-corrected moments.  optax's update is
    ``-lr·m̂/(√v̂ + eps)`` with ``m̂ = m/(1 − β₁ᵗ)``, ``v̂ = v/(1 − β₂ᵗ)``;
    ``torch.optim.Adam`` computes ``-(lr/(1 − β₁ᵗ))·m/(√v/√(1 − β₂ᵗ) +
    eps)``, the same quantity."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator

    @classmethod
    def create(cls, model: nn.Module, optimizer: OptimizerFactory,
               seed: int = 0) -> "TrainState":
        """``optimizer`` builds the optimizer over the model's parameters
        (e.g. :func:`adam`); ``seed`` seeds the generator on the model's
        device."""
        device = next(model.parameters()).device
        return cls(step=0, model=model,
                   optimizer=optimizer(model.parameters()),
                   generator=torch.Generator(device=device).manual_seed(seed))

    @classmethod
    def create_sharded(cls, *args, **kwargs) -> "TrainState":
        raise NotImplementedError(_SHARDED_TODO)

    def apply_gradients(self) -> "TrainState":
        """One optimizer step on the gradients the parameters hold."""
        self.optimizer.step()
        self.step += 1
        return self
