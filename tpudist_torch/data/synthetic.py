"""Synthetic data made with numpy from a seed: token streams for LM
training (the ``--data`` streams of ``examples/long_context_lm_tpu.py``)
and the ResNet50 pipeline's random images (the port's copy of
``tpudist.data.synthetic.synthetic_images``)."""

from __future__ import annotations

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
