"""Train state (counterpart of :mod:`tpudist.train.state`).

The JAX state is a pytree of params, optimizer state, step and PRNG key;
here the model holds the parameters, the optimizer its state, and an
integer ``seed`` stands in for the key.  torch has no ``fold_in`` or
``split``, so the random stream a step hands its loss is derived with
:func:`fold_in` from (seed, data-shard index, step, micro-batch index):
tpudist's stream in structure, not in bits.
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

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    """SplitMix64's finaliser (Steele, Lea and Flood, 2014): a bijection
    of 64-bit integers whose every output bit depends on every input
    bit."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, *data: int) -> int:
    """A 64-bit seed derived from ``seed`` and ``data``, one SplitMix64
    round per value: ``h = mix(seed)``, then ``h = mix(h ^ d)`` for each
    ``d`` in turn (the counterpart of chained ``jax.random.fold_in``)."""
    h = _splitmix64(seed & _MASK64)
    for d in data:
        h = _splitmix64(h ^ (d & _MASK64))
    return h


def sgd(lr: float, momentum: float | None = None) -> OptimizerFactory:
    """The twin of ``optax.sgd(lr, momentum)``: SGD without weight decay
    (``p -= lr * g``); with ``momentum`` m, the trace ``t = g + m·t``
    (zero at first) and ``p -= lr * t``, which is ``torch.optim.SGD``'s
    update without dampening."""
    return functools.partial(torch.optim.SGD, lr=lr,
                             momentum=momentum or 0.0)


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
    seed: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: OptimizerFactory,
               seed: int = 0) -> "TrainState":
        """``optimizer`` builds the optimizer over the model's parameters
        (e.g. :func:`adam`, :func:`sgd`); ``seed`` is the root of every
        step's random stream (:meth:`generator`)."""
        return cls(step=0, model=model,
                   optimizer=optimizer(model.parameters()), seed=seed)

    def generator(self, shard: int = 0, micro: int = 0) -> torch.Generator:
        """This step's generator for data shard ``shard`` and micro-batch
        ``micro``, on the model's device: seeded with ``fold_in(seed,
        shard, step, micro)``, so shards, micro-batches and steps draw
        distinct streams that repeat from the same seed (tpudist folds the
        shard and micro-batch indices into a key it splits every
        step)."""
        device = next(self.model.parameters()).device
        return torch.Generator(device=device).manual_seed(
            fold_in(self.seed, shard, self.step, micro))

    @classmethod
    def create_sharded(cls, *args, **kwargs) -> "TrainState":
        raise NotImplementedError(_SHARDED_TODO)

    def apply_gradients(self) -> "TrainState":
        """One optimizer step on the gradients the parameters hold."""
        self.optimizer.step()
        self.step += 1
        return self
