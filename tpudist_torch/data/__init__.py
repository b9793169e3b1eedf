"""The port's data sources (counterpart of :mod:`tpudist.data`): so far
the synthetic token streams of the LM examples and the ResNet50 pipeline's
synthetic images."""

from tpudist_torch.data.synthetic import (
    markov_tokens,
    random_tokens,
    synthetic_images,
)

__all__ = ["markov_tokens", "random_tokens", "synthetic_images"]
