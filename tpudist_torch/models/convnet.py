"""LeNet-style ConvNet (counterpart of :mod:`tpudist.models.convnet`), the
twin of the Horovod examples' ``Net`` (``mnist_horovod.py:9-25``):
conv(1→10, k5) + maxpool + relu, conv(10→20, k5) + dropout + maxpool +
relu, flatten(320) → fc(50) → relu → dropout → fc(10), logits out (the
log-softmax lives in the loss).

Layout: NHWC in, as flax takes it.  The convolutions run on the
``permute(0, 3, 1, 2)`` view, which is channels_last in memory, so cuDNN
needs no layout copy.  The flatten follows flax's ``(h, w, c)`` order (4
· 4 · 20 = 320), or ``Dense_0``'s rows would be permuted.

Dropout is flax's: with ``train=True`` each element is kept with
probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, the mask drawn
with ``torch.rand`` from the ``generator`` the step hands the loss
(:meth:`tpudist_torch.train.state.TrainState.generator`);
``torch.nn.functional.dropout`` takes no generator.  Names follow flax's:
``conv{j}`` is ``Conv_{j}``, ``dense{j}`` is ``Dense_{j}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.mlp import linear_as, logits_dtype
from tpudist_torch.utils.device import resolve_device
from tpudist_torch.utils.init import lecun_normal_


def flax_dropout(x: torch.Tensor, rate: float,
                 generator: torch.Generator | None) -> torch.Tensor:
    """flax's ``nn.Dropout(rate)`` in training: keep with probability
    ``1 - rate``, scale kept elements by ``1 / (1 - rate)``."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs the step's generator")
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class ConvNet(nn.Module):
    def __init__(self, num_classes: int = 10, width_mult: int = 1,
                 dropout_rate: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32,
                 input_hw: tuple[int, int] = (28, 28),
                 device=None) -> None:
        """``input_hw`` sets ``dense0``'s width, which flax infers from
        the first input: ``h' · w' · 20 · width_mult`` with ``h' = ((h -
        4) // 2 - 4) // 2`` (320 at 28 × 28)."""
        super().__init__()
        device = resolve_device(device)
        w = width_mult
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        h_out, w_out = (((n - 4) // 2 - 4) // 2 for n in input_hw)
        self.conv0 = nn.Conv2d(1, 10 * w, 5, device=device)
        self.conv1 = nn.Conv2d(10 * w, 20 * w, 5, device=device)
        self.dense0 = nn.Linear(h_out * w_out * 20 * w, 50 * w,
                                device=device)
        self.dense1 = nn.Linear(50 * w, num_classes, device=device)
        for conv in (self.conv0, self.conv1):
            conv.weight.data = conv.weight.data.contiguous(
                memory_format=torch.channels_last)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ConvNet":
        """flax's initialisers, drawn from ``generator`` (on the model's
        device): lecun_normal kernels, zero biases."""
        for layer in (self.conv0, self.conv1, self.dense0, self.dense1):
            lecun_normal_(layer.weight, generator)
            layer.bias.zero_()
        return self

    def _conv(self, x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """NHWC ``x`` ``[N, 28, 28, 1]`` → logits ``[N, classes]`` (f32, f64
        under f64 compute);
        ``train=True`` applies the two dropouts from ``generator``."""
        rate = self.dropout_rate if train else 0.0
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.relu(F.max_pool2d(self._conv(x, self.conv0), 2, 2))
        x = flax_dropout(self._conv(x, self.conv1), rate, generator)
        x = F.relu(F.max_pool2d(x, 2, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c)
        x = F.relu(linear_as(x, self.dense0, self.compute_dtype))
        x = flax_dropout(x, rate, generator)
        return logits_dtype(linear_as(x, self.dense1, self.compute_dtype))
