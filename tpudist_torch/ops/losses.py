"""Losses (counterpart of :mod:`tpudist.ops.losses`).

All are computed from *logits* in float32, with the log-softmax in its
stable logsumexp form.
"""

from __future__ import annotations

import torch


def log_softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return logits - torch.logsumexp(logits, dim=dim, keepdim=True)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    return cross_entropy_per_token(logits, labels).mean()


def cross_entropy_per_token(logits: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """UNREDUCED cross-entropy, one value per label.

    Rank-general: ``logits [..., C]`` with ``labels [...]`` (``[N, C]``/
    ``[N]`` rows or ``[B, S, V]``/``[B, S]`` sequences); the gather runs
    on the last axis, and mismatched shapes raise rather than broadcast
    into a gather of wrong targets."""
    if logits.shape[:-1] != labels.shape:
        raise ValueError(
            f"logits {tuple(logits.shape)} must be labels shape "
            f"{tuple(labels.shape)} + one trailing class axis")
    logp = log_softmax(logits.float())
    return -torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0]


def nll_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """NLL over log_softmax outputs, from logits: exactly
    :func:`cross_entropy`."""
    return cross_entropy(logits, labels)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.square(pred.float() - target.float()).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction correct."""
    return (logits.argmax(dim=-1) == labels).float().mean()
