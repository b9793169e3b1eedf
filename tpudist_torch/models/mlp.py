"""Configurable MLP (counterpart of :mod:`tpudist.models.mlp`), the twin
of the DDP example's ``Model`` (``mnist_ddp_elastic.py:133-159``): 784 →
features, then ``hidden_layers`` × (features → features), then → 10, ReLU
between layers; the reference configuration is ``hidden_layers=5,
features=1024``.

Parameters are f32; each layer computes in ``compute_dtype`` (the input
and the weights cast at use, as flax's ``Dense(dtype=...)`` does), and
the logits come back in f32 (f64 under f64 compute, the parity checks'
reference).  ``dense.{i}`` is flax's ``Dense_{i}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.utils.device import resolve_device
from tpudist_torch.utils.init import lecun_normal_


def linear_as(x: torch.Tensor, layer: nn.Linear,
          dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (input, weight and bias cast)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def logits_dtype(x: torch.Tensor) -> torch.Tensor:
    """Logits widened to at least f32 (bf16 compute returns f32, as
    tpudist's models do; f64 compute stays f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class MLP(nn.Module):
    def __init__(self, hidden_layers: int = 5, features: int = 1024,
                 num_classes: int = 10, in_features: int = 784,
                 compute_dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        widths = [in_features] + [features] * (hidden_layers + 1)
        self.dense = nn.ModuleList(
            [nn.Linear(a, b, device=device)
             for a, b in zip(widths[:-1], widths[1:])]
            + [nn.Linear(features, num_classes, device=device)])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MLP":
        """flax's initialisers, drawn from ``generator`` (on the model's
        device): lecun_normal kernels, zero biases."""
        for layer in self.dense:
            lecun_normal_(layer.weight, generator)
            layer.bias.zero_()
        return self

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``x`` ``[N, ...]`` (NHWC images flatten to 784) → logits (f32,
        f64 under f64 compute).
        ``generator`` is accepted as every model's random stream and not
        used: the MLP draws nothing."""
        del generator
        x = x.reshape(x.shape[0], -1)
        for layer in self.dense[:-1]:
            x = F.relu(linear_as(x, layer, self.compute_dtype))
        return logits_dtype(linear_as(x, self.dense[-1], self.compute_dtype))
