"""flax's parameter initialisers, drawn from a ``torch.Generator``."""

from __future__ import annotations

import math

import torch
from torch import nn

# lecun_normal: a normal of std sqrt(1 / fan_in) truncated at two standard
# deviations, divided by the truncated normal's own std
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` into ``w`` in place, with fan-in the
    product of every dimension but the first (``[out, in, kh, kw]`` or
    ``[out, in]``)."""
    std = 1.0 / math.sqrt(w[0].numel()) / _TRUNC_STD
    tmp = torch.empty(w.shape, device=w.device)
    nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    w.copy_(tmp)
