"""The port's data sources (counterpart of :mod:`tpudist.data`): so far
the synthetic token streams of the LM examples."""

from tpudist_torch.data.synthetic import markov_tokens, random_tokens

__all__ = ["markov_tokens", "random_tokens"]
