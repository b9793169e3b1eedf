"""Beam-search decoding (counterpart of :mod:`tpudist.models.beam`).

Width-W beam search over the KV-cached decode of
:mod:`tpudist_torch.models.generate`:

* beams fold into the batch dimension: the model runs on ``[B·W]`` rows;
  the prompt is prefilled once on ``[B]`` and each K/V buffer repeated W
  times along it;
* each step expands every live beam over the vocabulary, takes the top W
  of the ``[B, W·V]`` joint scores (the lowest index first among equal
  scores, as ``lax.top_k``), and gathers the cache rows to the winning
  parents (one cache copy a step, the price of exact search);
* a beam that emitted a stop token freezes: it contributes one child,
  itself continued by ``pad_token`` at an unchanged score.

With ``decode_attention="flash"`` the prefill runs K1 and each step K2.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from tpudist_torch.models.generate import (
    _blank_cache,
    _is_stop,
    _prefill,
    _stop_array,
    build_model,
    sequence_lengths,
)

_NEG_INF = -1.0e9


def _top(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest values and their
    indices, the lowest index first among equal values."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]
    return x.gather(-1, order), order


@torch.no_grad()
def beam_search_generate(
    cfg,
    params: Mapping[str, Any],
    prompt,
    max_new_tokens: int,
    *,
    beam_size: int = 4,
    length_penalty: float = 0.0,
    decode_attention: str = "dense",
    prefill_chunk: int | None = None,
    stop_tokens: Sequence[int] | None = None,
    pad_token: int = 0,
    return_scores: bool = False,
    device=None,
):
    """Beam-search ``max_new_tokens`` past ``prompt``.

    Args:
      beam_size: beams kept per batch row (W).
      length_penalty: GNMT-style ``((5 + len) / 6) ** alpha`` score
        normalization applied at the final ranking (0: rank by raw
        log-probability); it matters only with ``stop_tokens``.
      decode_attention: ``"flash"`` (K1, K2) or ``"dense"`` (their plain
        versions).
      stop_tokens: EOS set; a beam that emits one freezes (its later
        positions are ``pad_token`` and its score stops accumulating).
      return_scores: also return the per-beam log-probabilities.
      device: where to run (default ``cuda``).

    Returns ``[B, W, prompt_len + max_new_tokens]`` int32 hypotheses
    sorted best-first per batch row, plus ``[B, W]`` raw log-prob scores
    when ``return_scores`` is set.  With ``stop_tokens`` the return is
    ``(tokens, lengths[, scores])``.
    """
    model = build_model(cfg, params, device=device,
                        decode_attention=decode_attention)
    cfg = model.cfg
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    if beam_size > cfg.vocab_size:
        raise ValueError(
            f"beam_size {beam_size} exceeds vocab_size {cfg.vocab_size} "
            "(top-k over the next-token distribution cannot seed more "
            "beams than there are tokens)")
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    dev = model.device
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.from_numpy(np.array(prompt, dtype=np.int64))
    prompt = prompt.to(device=dev, dtype=torch.long)
    b, prompt_len = prompt.shape
    if prompt_len < 1:
        raise ValueError("prompt must hold at least one token")
    w = beam_size
    stop_arr = _stop_array(stop_tokens, dev)
    total = prompt_len + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(
            f"prompt_len + max_new_tokens = {total} exceeds "
            f"max_seq_len {cfg.max_seq_len}")
    v = cfg.vocab_size

    # prefill once on [B] (every beam shares the prompt), then repeat
    # each K/V row W times along the folded batch
    cache, logits = _prefill(model, _blank_cache(model, b), prompt,
                             prefill_chunk)
    cache = [{k: (x.repeat_interleave(w, 0) if x.dim() >= 3 else x)
              for k, x in layer.items()} for layer in cache]
    logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)   # [B, V]
    scores, first = _top(logp0, w)                             # [B, W]
    done = (_is_stop(first, stop_arr) if stop_arr is not None
            else torch.zeros((b, w), dtype=torch.bool, device=dev))
    out = torch.full((b, w, max_new_tokens), pad_token, dtype=torch.long,
                     device=dev)
    out[:, :, 0] = first
    prev = first
    frozen_row = torch.full((v,), _NEG_INF, device=dev)
    frozen_row[pad_token] = 0.0
    for t in range(1, max_new_tokens):
        pos = torch.full((b * w, 1), prompt_len + t - 1, dtype=torch.long,
                         device=dev)
        logits, cache = model(prev.reshape(b * w, 1), positions=pos,
                              cache=cache)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(
            b, w, v)
        # live beams expand over the vocab; a finished beam contributes
        # one child: itself continued by pad_token at an unchanged score
        cand = torch.where(done[:, :, None],
                           frozen_row + scores[:, :, None],
                           scores[:, :, None] + logp)
        scores, flat = _top(cand.reshape(b, w * v), w)
        parent, token = flat // v, flat % v
        row = (torch.arange(b, device=dev)[:, None] * w + parent).reshape(-1)
        cache = [{k: (x.index_select(0, row) if x.dim() >= 3 else x)
                  for k, x in layer.items()} for layer in cache]
        out = out.gather(1, parent[:, :, None].expand(-1, -1,
                                                      max_new_tokens))
        done = done.gather(1, parent)
        out[:, :, t] = torch.where(done, torch.full_like(token, pad_token),
                                   token)
        if stop_arr is not None:
            done = done | _is_stop(token, stop_arr)
        prev = token

    generated = out
    if stop_arr is not None:
        hit = _is_stop(generated, stop_arr).long()
        after = (torch.cumsum(hit, dim=-1) - hit) > 0
        generated = torch.where(after, torch.full_like(generated, pad_token),
                                generated)
        lengths = sequence_lengths(generated, stop_arr, prompt_len)
    else:
        lengths = torch.full((b, w), total, dtype=torch.long, device=dev)

    # final ranking: GNMT length normalization on the generated length
    norm = ((5.0 + (lengths - prompt_len)) / 6.0) ** length_penalty
    order = torch.argsort(-scores / norm, dim=1, stable=True)
    scores = scores.gather(1, order)
    lengths = lengths.gather(1, order)
    generated = generated.gather(1, order[:, :, None].expand(
        -1, -1, max_new_tokens))
    tokens = torch.cat([prompt[:, None].expand(b, w, prompt_len),
                        generated], dim=-1).to(torch.int32)
    result = (tokens,)
    if stop_arr is not None:
        result += (lengths.to(torch.int32),)
    if return_scores:
        result += (scores,)
    return result[0] if len(result) == 1 else result
