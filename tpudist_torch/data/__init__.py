"""The port's data layer (counterpart of :mod:`tpudist.data`): datasets,
the epoch-seeded sharding sampler, the per-process loader and its device
prefetch, and the synthetic streams (LM tokens, ResNet50 images,
embedding bags)."""

from tpudist_torch.data.device_prefetch import DevicePrefetch, device_prefetch
from tpudist_torch.data.loader import ShardedLoader
from tpudist_torch.data.mnist import MNIST_MEAN, MNIST_STD, Dataset, load_mnist
from tpudist_torch.data.sampler import ShardedSampler
from tpudist_torch.data.synthetic import (
    markov_tokens,
    ragged_embedding_batches,
    random_tokens,
    synthetic_images,
)

__all__ = [
    "Dataset",
    "DevicePrefetch",
    "MNIST_MEAN",
    "MNIST_STD",
    "ShardedLoader",
    "ShardedSampler",
    "device_prefetch",
    "load_mnist",
    "markov_tokens",
    "ragged_embedding_batches",
    "random_tokens",
    "synthetic_images",
]
