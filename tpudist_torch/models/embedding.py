"""EmbeddingBag + Linear classifier (counterpart of
:mod:`tpudist.models.embedding`), the twin of ``HybridModel``
(``server_model_data_parallel.py:34-46``): an EmbeddingBag(100, 16,
mode="sum") lookup feeding a Linear(16, 8).

The ragged (indices, offsets) pair is tpudist's static-shape ``[batch,
max_len]`` index matrix plus a float mask
(:func:`tpudist_torch.data.synthetic.ragged_embedding_batches`), and the
bag-sum is the mask-weighted gather-sum.  The table is the parameter
``embedding`` and the head the module ``fc``, flax's names.
"""

from __future__ import annotations

import torch
from torch import nn

from tpudist_torch.models.mlp import linear_as, logits_dtype
from tpudist_torch.utils.device import resolve_device
from tpudist_torch.utils.init import lecun_normal_


class EmbeddingBagClassifier(nn.Module):
    def __init__(self, num_embeddings: int = 100, embedding_dim: int = 16,
                 num_classes: int = 8,
                 compute_dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.embedding = nn.Parameter(torch.zeros(
            num_embeddings, embedding_dim, device=device))
        self.fc = nn.Linear(embedding_dim, num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator
                     ) -> "EmbeddingBagClassifier":
        """flax's initialisers from ``generator``: the table normal(1),
        the head lecun_normal with a zero bias."""
        self.embedding.normal_(0.0, 1.0, generator=generator)
        lecun_normal_(self.fc.weight, generator)
        self.fc.bias.zero_()
        return self

    def forward(self, indices: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``indices`` and ``mask`` ``[B, L]`` → logits ``[B, classes]``
        (f32, f64 under f64 compute); ``generator`` is accepted and not
        used."""
        del generator
        dt = self.compute_dtype
        rows = self.embedding[indices.long()].to(dt)
        bag = torch.einsum("blh,bl->bh", rows, mask.to(dt))
        return logits_dtype(linear_as(bag, self.fc, dt))
