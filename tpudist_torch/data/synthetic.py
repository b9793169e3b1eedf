"""Synthetic data made with numpy from a seed: token streams for LM
training (the ``--data`` streams of ``examples/long_context_lm_tpu.py``),
the ResNet50 pipeline's random images and the embedding model's ragged
bags (the port's copies of ``tpudist.data.synthetic.synthetic_images``
and ``ragged_embedding_batches``)."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def markov_tokens(batch: int, seq_len: int, vocab: int,
                  seed: int) -> np.ndarray:
    """``[batch, seq_len]`` int64 tokens of a fixed token-permutation
    language: next token = perm[current] over the first ``min(1024,
    vocab)`` ids, each row from its own random start.  Position-independent
    and learnable, so the training loss falls."""
    rng = np.random.default_rng(seed)
    pattern = min(1024, vocab)
    perm = rng.permutation(pattern)
    stream = np.empty((batch, seq_len), np.int64)
    tok = rng.integers(0, pattern, batch)
    for i in range(seq_len):
        stream[:, i] = tok
        tok = perm[tok]
    return stream


def random_tokens(batch: int, seq_len: int, vocab: int,
                  seed: int) -> np.ndarray:
    """``[batch, seq_len]`` uniform int64 tokens: nothing to learn (a
    throughput stream)."""
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq_len))


def synthetic_images(batch: int, *, hw: int = 128, channels: int = 3,
                     num_classes: int = 1000,
                     seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """One batch of random NHWC f32 images ``[batch, hw, hw, channels]``
    and one-hot f32 labels ``[batch, num_classes]``: the reference's
    ResNet50 stream (``model_parallel_ResNet50.py:208-217``), drawn as
    tpudist draws it, so the same seed gives the same arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, hw, hw, channels), dtype=np.float32)
    labels = rng.integers(0, num_classes, size=batch)
    one_hot = np.zeros((batch, num_classes), dtype=np.float32)
    one_hot[np.arange(batch), labels] = 1.0
    return x, one_hot


def ragged_embedding_batches(
    num_batches: int,
    batch: int = 10,
    *,
    num_embeddings: int = 100,
    max_len: int = 10,
    min_len: int = 2,
    num_classes: int = 8,
    seed: int = 0,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield ``(indices [B, max_len] int32, mask [B, max_len] f32, target
    [B] int32)``: each sample a random ragged bag of embedding rows
    (``server_model_data_parallel.py:49-68``), the reference's offsets as
    a padding mask; drawn as tpudist draws them, so the same seed gives
    the same arrays."""
    rng = np.random.default_rng(seed)
    for _ in range(num_batches):
        lengths = rng.integers(min_len, max_len + 1, size=batch)
        indices = rng.integers(0, num_embeddings,
                               size=(batch, max_len)).astype(np.int32)
        mask = (np.arange(max_len)[None, :] < lengths[:, None]).astype(
            np.float32)
        target = rng.integers(0, num_classes, size=batch).astype(np.int32)
        yield indices, mask, target
