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


def adamw(lr: float, weight_decay: float = 1e-4) -> OptimizerFactory:
    """The twin of ``optax.adamw(lr, weight_decay=...)`` at optax's
    defaults (betas 0.9/0.999, eps 1e-8, weight decay 1e-4 — torch's
    ``AdamW`` defaults to 1e-2).  optax adds ``wd·p`` to Adam's update
    before scaling by ``-lr``: ``p - lr·(m̂/(√v̂ + eps) + wd·p)``;
    ``torch.optim.AdamW`` decays first, ``p·(1 - lr·wd)``, then takes
    Adam's step: the same quantity."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def init_optimizer_state(optimizer: torch.optim.Optimizer
                         ) -> torch.optim.Optimizer:
    """Make the per-parameter state a torch optimizer creates only at its
    first step, as optax's ``init`` does: zero moments and a step count of
    0 (Adam, AdamW), a zero momentum trace (SGD with momentum; plain SGD
    keeps none).  These are the values that first step would create, so
    its update is unchanged, and no parameter moves (a zero-gradient step
    would apply AdamW's decay and count a step).  Parameters that already
    have state are left as they are; another optimizer class raises."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if optimizer.state.get(p):
                continue
            if isinstance(optimizer, torch.optim.Adam):
                state = optimizer.state[p]
                # torch keeps the count on the host unless the update runs
                # on the device (``capturable``/``fused``)
                on_device = group["capturable"] or group["fused"]
                state["step"] = torch.zeros(
                    (), dtype=(torch.float64 if torch.get_default_dtype()
                               == torch.float64 and not group["fused"]
                               else torch.float32),
                    device=p.device if on_device else "cpu")
                for key in ("exp_avg", "exp_avg_sq") + (
                        ("max_exp_avg_sq",) if group["amsgrad"] else ()):
                    state[key] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            elif isinstance(optimizer, torch.optim.SGD):
                if group["momentum"] != 0:
                    optimizer.state[p]["momentum_buffer"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            else:
                raise NotImplementedError(
                    f"init_optimizer_state knows Adam, AdamW and SGD, not "
                    f"{type(optimizer).__name__}")
    return optimizer


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
    def create_sharded(cls, model: nn.Module, optimizer: OptimizerFactory,
                       spec, mesh=None, seed: int = 0,
                       params=None) -> "TrainState":
        """A state laid out by a :class:`tpudist_torch.parallel.mesh.
        MeshSpec` (``mesh`` defaults to ``spec.build()``): this process's
        blocks of the parameters by the spec's composed rules (tp/ep
        rules first, fsdp takes a remaining dimension), the optimizer
        made over the blocks.  ``params`` is the whole model's
        ``state_dict`` (default: ``model``'s own, for a model built
        unsharded); a model built for a tp/ep layout takes it from the
        whole model."""
        from tpudist_torch.parallel.mesh import make_composed_state

        if mesh is None:
            mesh = spec.build()
        if params is None:
            params = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}
        state, _ = make_composed_state(model, params, optimizer, spec, mesh,
                                       seed=seed)
        return state

    def apply_gradients(self) -> "TrainState":
        """One optimizer step on the gradients the parameters hold."""
        self.optimizer.step()
        self.step += 1
        return self
