"""Autoregressive generation with a KV cache (counterpart of
:mod:`tpudist.models.generate`).

The JAX rollout is one compiled program (``lax.scan`` over positions);
here it is a Python loop of eager steps whose index arithmetic stays on the
device, so no step waits on the host.  Prefill chunks run kernel K1 and
decode steps kernel K2 (the JAX package's ``decode_attention="flash"``).

Sampling draws from an explicit ``torch.Generator``; it does not reproduce
``jax.random``'s bits (greedy decoding is exact either way).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from tpudist_torch.models.convert import from_flax_params
from tpudist_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    blank_cache,
)
from tpudist_torch.utils.device import resolve_device

# (logits [B, V], generator) -> next token [B] (int64)
SelectFn = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def serving_layout(cfg: TransformerConfig, params: Mapping[str, Any],
                   ) -> tuple[TransformerConfig, dict]:
    """Normalize ``(cfg, params)`` for serving: the unrolled layout, and
    the port's ``state_dict``.  A flax tree (a scanned checkpoint
    included) is converted with :func:`from_flax_params`; a state_dict
    passes through; ``scan_layers`` is flipped off."""
    if "tok_embed" in params or "params" in params:
        params = from_flax_params(params, cfg)
    if cfg.scan_layers:
        cfg = dataclasses.replace(cfg, scan_layers=False)
    return cfg, dict(params)


def build_model(cfg: TransformerConfig, params: Mapping[str, Any], *,
                device=None, **model_kw) -> TransformerLM:
    """A decode-ready :class:`TransformerLM` on ``device`` (default cuda)
    holding ``params`` (a state_dict or a flax tree)."""
    cfg, sd = serving_layout(cfg, params)
    model = TransformerLM(cfg, device=resolve_device(device), **model_kw)
    model.load_state_dict(sd)
    return model.eval()


def _stop_array(stop_tokens: Sequence[int] | None, device
                ) -> torch.Tensor | None:
    if stop_tokens is None:
        return None
    toks = tuple(int(t) for t in stop_tokens)
    if not toks:
        raise ValueError("stop_tokens must be non-empty when given")
    return torch.tensor(toks, dtype=torch.int64, device=device)


def _is_stop(tokens: torch.Tensor, stop_arr: torch.Tensor) -> torch.Tensor:
    return torch.isin(tokens, stop_arr)


def sequence_lengths(generated: torch.Tensor, stop_arr: torch.Tensor,
                     prompt_len: int) -> torch.Tensor:
    """Per-sequence total lengths: prompt + generated up to and INCLUDING
    the first stop token (or all of ``generated`` if none fired)."""
    hit = _is_stop(generated, stop_arr).long()
    strictly_after = torch.cumsum(hit, dim=-1) - hit
    return prompt_len + (strictly_after == 0).sum(dim=-1)


def _blank_cache(model: TransformerLM, batch: int, *, per_row: bool = False,
                 side_slots: int = 0, paged: bool = False) -> list[dict]:
    """Fresh zeroed KV cache for ``model`` (cache_index 0, empty slots),
    allocated from its config on its device.  ``paged``: the slot cache
    of a ``cache_layout="paged"`` model, one block pool per layer sized
    by its ``kv_num_blocks`` / ``kv_block_size``, with a page table."""
    pool = {}
    if paged:
        pool = dict(kv_block_size=model.kv_block_size,
                    kv_num_blocks=model.kv_num_blocks)
    return blank_cache(model.cfg, batch, device=model.device,
                       per_row=per_row, side_slots=side_slots, **pool)


def _prefill(model: TransformerLM, cache: list[dict], prompt: torch.Tensor,
             prefill_chunk: int | None):
    """Ingest the prompt into the cache in chunks of ``prefill_chunk``
    tokens (None = one shot), each attending causally over everything
    cached so far.  Returns ``(cache, last-chunk logits)``."""
    prompt_len = prompt.shape[1]
    chunk = prompt_len if prefill_chunk is None else min(prefill_chunk,
                                                         prompt_len)
    logits = None
    for lo in range(0, prompt_len, chunk):
        piece = prompt[:, lo:lo + chunk]
        pos = torch.arange(lo, lo + piece.shape[1],
                           device=prompt.device)[None, :]
        logits, cache = model(piece, positions=pos, cache=cache)
    return cache, logits


@torch.no_grad()
def _rollout(model: TransformerLM, prompt: torch.Tensor,
             max_new_tokens: int, select: SelectFn,
             generator: torch.Generator | None = None,
             prefill_chunk: int | None = None,
             stop_tokens: Sequence[int] | None = None,
             pad_token: int = 0):
    """Shared KV-cached decode loop; ``select`` picks the next token from
    each step's last-position logits.  With ``stop_tokens`` every position
    after a sequence's first stop token is frozen to ``pad_token`` and the
    return is ``(tokens, lengths)``."""
    cfg = model.cfg
    dev = model.device
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.from_numpy(np.array(prompt, dtype=np.int64))
    prompt = prompt.to(device=dev, dtype=torch.long)
    b, prompt_len = prompt.shape
    stop_arr = _stop_array(stop_tokens, dev)  # validate before device work
    if prompt_len < 1:
        raise ValueError("prompt must hold at least one token")
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    total = prompt_len + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(
            f"prompt_len + max_new_tokens = {total} exceeds "
            f"max_seq_len {cfg.max_seq_len}")
    cache = _blank_cache(model, b)
    cache, logits = _prefill(model, cache, prompt, prefill_chunk)
    tok = select(logits[:, -1], generator)
    done = (_is_stop(tok, stop_arr) if stop_arr is not None
            else torch.zeros((b,), dtype=torch.bool, device=dev))
    out = [tok]
    for t in range(1, max_new_tokens):
        pos = torch.full((b, 1), prompt_len + t - 1, dtype=torch.long,
                         device=dev)
        logits, cache = model(tok[:, None], positions=pos, cache=cache)
        nxt = select(logits[:, -1], generator)
        if stop_arr is not None:
            nxt = torch.where(done, torch.full_like(nxt, pad_token), nxt)
            done = done | _is_stop(nxt, stop_arr)
        out.append(nxt)
        tok = nxt
    generated = torch.stack(out, dim=1)
    tokens = torch.cat([prompt, generated], dim=1).to(torch.int32)
    if stop_arr is None:
        return tokens
    return tokens, sequence_lengths(generated, stop_arr, prompt_len)


def greedy_generate(
    cfg: TransformerConfig,
    params: Mapping[str, Any],
    prompt,
    max_new_tokens: int,
    prefill_chunk: int | None = None,
    stop_tokens: Sequence[int] | None = None,
    pad_token: int = 0,
    *,
    device=None,
):
    """Greedy-decode ``max_new_tokens`` past ``prompt``.

    Args:
      cfg: the model configuration.
      params: the port's state_dict, or a flax parameter tree (converted;
        scanned checkpoints unstacked).
      prompt: ``[batch, prompt_len]`` int tokens, ``prompt_len >= 1``.
      prefill_chunk: prompt tokens per prefill call (None = one shot).
      stop_tokens: optional EOS set; positions past a sequence's first
        stop token freeze to ``pad_token`` and per-sequence lengths are
        returned alongside the tokens.
      device: where to run (default ``cuda``; raises if there is none).

    Returns ``[batch, prompt_len + max_new_tokens]`` int32 on the device
    (plus ``[batch]`` lengths when ``stop_tokens`` is given).
    """
    model = build_model(cfg, params, device=device)
    return _rollout(model, prompt, max_new_tokens, _make_select(0.0, None,
                                                               None),
                    prefill_chunk=prefill_chunk, stop_tokens=stop_tokens,
                    pad_token=pad_token)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k highest logits to -inf (last axis)."""
    if k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Mask to the nucleus: the smallest prefix of probability-sorted
    tokens whose cumulative probability reaches ``p`` (the argmax is always
    kept)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep every token whose PREDECESSORS sum below p; the cutoff is the
    # SMALLEST kept logit
    keep_sorted = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]],
                            dim=-1) < p
    cutoff = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < cutoff, float("-inf"))


def _filtered_logits(logits: torch.Tensor, temperature: float,
                     top_k: Optional[int],
                     top_p: Optional[float]) -> torch.Tensor:
    """The scale-then-top_k-then-top_p pipeline, in one place.  Requires
    ``temperature > 0``."""
    logits = logits.float() / temperature
    if top_k is not None:
        logits = top_k_filter(logits, top_k)
    if top_p is not None:
        logits = top_p_filter(logits, top_p)
    return logits


def _make_select(temperature: float, top_k: Optional[int],
                 top_p: Optional[float]) -> SelectFn:
    """Validated token-selection fn (``temperature == 0`` is greedy
    argmax over f32 logits, first index on ties)."""
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0 < top_p <= 1:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")

    def select(logits: torch.Tensor,
               generator: torch.Generator | None) -> torch.Tensor:
        if temperature == 0.0:
            return torch.argmax(logits.float(), dim=-1)
        probs = torch.softmax(
            _filtered_logits(logits, temperature, top_k, top_p), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return select
