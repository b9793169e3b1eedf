"""The port's models (counterpart of :mod:`tpudist.models`): the
TransformerLM forward, its generation loop, the continuous-batching
ServeLoop, the Mixture-of-Experts LM, and ResNet50 with its pipeline
stages."""

from tpudist_torch.models.convert import (
    from_flax_moe_params,
    from_flax_params,
    from_flax_resnet_params,
)
from tpudist_torch.models.generate import greedy_generate
from tpudist_torch.models.moe import MoEConfig, MoEMLP, MoETransformerLM
from tpudist_torch.models.resnet import ResNet50, resnet50_stages
from tpudist_torch.models.serving import Completion, Request, ServeLoop
from tpudist_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    blank_cache,
    sdpa,
)

__all__ = [
    "Completion",
    "MoEConfig",
    "MoEMLP",
    "MoETransformerLM",
    "Request",
    "ResNet50",
    "ServeLoop",
    "TransformerConfig",
    "TransformerLM",
    "blank_cache",
    "from_flax_moe_params",
    "from_flax_params",
    "from_flax_resnet_params",
    "greedy_generate",
    "resnet50_stages",
    "sdpa",
]
