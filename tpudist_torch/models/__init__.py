"""The port's models (counterpart of :mod:`tpudist.models`): the
TransformerLM inference forward, its generation loop and the
continuous-batching ServeLoop."""

from tpudist_torch.models.convert import from_flax_params
from tpudist_torch.models.generate import greedy_generate
from tpudist_torch.models.serving import Completion, Request, ServeLoop
from tpudist_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    blank_cache,
    sdpa,
)

__all__ = [
    "Completion",
    "Request",
    "ServeLoop",
    "TransformerConfig",
    "TransformerLM",
    "blank_cache",
    "from_flax_params",
    "greedy_generate",
    "sdpa",
]
