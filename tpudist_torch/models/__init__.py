"""The port's models (counterpart of :mod:`tpudist.models`): the
TransformerLM forward, its generation loops (greedy, sampled, beam, and
sharded over tensor and sequence axes) and speculative decoding, the
continuous-batching ServeLoop, the Mixture-of-Experts LM, ResNet50 with
its pipeline stages, and the MNIST models (MLP, ConvNet) and the
embedding-bag classifier."""

from tpudist_torch.models.convert import (
    from_flax_convnet_params,
    from_flax_embedding_params,
    from_flax_mlp_params,
    from_flax_moe_params,
    from_flax_params,
    from_flax_resnet_params,
    from_flax_resnet_stages,
    from_flax_stacked_blocks,
    stack_block_params,
    unstack_block_params,
)
from tpudist_torch.models.convnet import ConvNet
from tpudist_torch.models.beam import beam_search_generate
from tpudist_torch.models.embedding import EmbeddingBagClassifier
from tpudist_torch.models.generate import (
    apply_cache_constraint,
    greedy_generate,
    sample_generate,
    sp_generate,
    tp_generate,
    tp_sp_generate,
)
from tpudist_torch.models.mlp import MLP
from tpudist_torch.models.moe import MoEConfig, MoEMLP, MoETransformerLM
from tpudist_torch.models.resnet import ResNet50, resnet50_stages
from tpudist_torch.models.serving import Completion, Request, ServeLoop
from tpudist_torch.models.speculative import (
    AdaptiveDraftPolicy,
    adaptive_speculative_generate,
    sp_speculative_generate,
    speculative_generate,
    tp_sp_speculative_generate,
    tp_speculative_generate,
)
from tpudist_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    blank_cache,
    sdpa,
)

__all__ = [
    "AdaptiveDraftPolicy",
    "Completion",
    "ConvNet",
    "EmbeddingBagClassifier",
    "MLP",
    "MoEConfig",
    "MoEMLP",
    "MoETransformerLM",
    "Request",
    "ResNet50",
    "ServeLoop",
    "TransformerConfig",
    "TransformerLM",
    "adaptive_speculative_generate",
    "apply_cache_constraint",
    "beam_search_generate",
    "blank_cache",
    "from_flax_convnet_params",
    "from_flax_embedding_params",
    "from_flax_mlp_params",
    "from_flax_moe_params",
    "from_flax_params",
    "from_flax_resnet_params",
    "from_flax_resnet_stages",
    "from_flax_stacked_blocks",
    "greedy_generate",
    "resnet50_stages",
    "sample_generate",
    "sdpa",
    "sp_generate",
    "sp_speculative_generate",
    "speculative_generate",
    "stack_block_params",
    "tp_generate",
    "tp_sp_generate",
    "tp_sp_speculative_generate",
    "tp_speculative_generate",
    "unstack_block_params",
]
