"""Synthetic token streams for LM training, made with numpy from a seed
(the ``--data`` streams of ``examples/long_context_lm_tpu.py``)."""

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
