"""Autoregressive generation with a KV cache (counterpart of
:mod:`tpudist.models.generate`).

The JAX rollout is one compiled program (``lax.scan`` over positions);
here it is a Python loop of eager steps whose index arithmetic stays on the
device, so no step waits on the host.  Prefill chunks run kernel K1 and
decode steps kernel K2 (the JAX package's ``decode_attention="flash"``).

Sampling draws from an explicit ``torch.Generator``; it does not reproduce
``jax.random``'s bits (greedy decoding is exact either way).

The sharded rollouts (:func:`tp_generate`, :func:`sp_generate`,
:func:`tp_sp_generate`) run one process a shard over a
``torch.distributed`` mesh: every process of the mesh calls them with
the same arguments and gets the same tokens.  Each holds its block of the
Megatron weights (``tp``) and its shard of every cache leaf, cut by the
cache constraint (:func:`apply_cache_constraint`): its KV heads, its
sequence slots, or both.  No process holds another's shard at any step.
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


def apply_cache_constraint(cache: list[dict], constraint, mesh=None
                           ) -> list[dict]:
    """Cut each cache leaf to this process's shard: ``constraint`` maps a
    leaf to its spec (a tuple of mesh axes or None per dimension, as
    :func:`~tpudist_torch.parallel.tensor_parallel.cut_leaf` reads it; the
    twin of a ``PartitionSpec``) or to None, which leaves the leaf whole.
    Raises where a spec cannot be applied (no ``mesh``, more entries than
    the leaf has dimensions, a dimension the axes do not divide); it
    never ignores one.  ``constraint=None`` returns ``cache``."""
    if constraint is None:
        return cache
    from tpudist_torch.parallel.tensor_parallel import cut_leaf

    out = []
    for layer in cache:
        new = {}
        for name, x in layer.items():
            spec = constraint(x)
            if spec is None or all(e is None for e in spec):
                new[name] = x
                continue
            if mesh is None:
                raise ValueError(f"cache_constraint shards {name} by "
                                 f"{tuple(spec)} but no mesh was given")
            if len(spec) > x.dim():
                raise ValueError(f"cache_constraint's spec {tuple(spec)} "
                                 f"has more entries than {name} "
                                 f"{tuple(x.shape)} has dimensions")
            new[name] = cut_leaf(x, spec, mesh)
        out.append(new)
    return out


def _blank_cache(model: TransformerLM, batch: int, *, per_row: bool = False,
                 side_slots: int = 0, paged: bool = False,
                 constraint=None, mesh=None) -> list[dict]:
    """Fresh zeroed KV cache for ``model`` (cache_index 0, empty slots),
    allocated from its config on its device: this process's shard of a
    sharded model's cache (its KV heads and slots).  ``paged``: the slot
    cache of a ``cache_layout="paged"`` model, one block pool per layer
    sized by its ``kv_num_blocks`` / ``kv_block_size``, with a page
    table.  With ``constraint`` the whole cache's shapes (on the ``meta``
    device: nothing is allocated) are cut by
    :func:`apply_cache_constraint`, and the shards must be the ones the
    model decodes."""
    pool = {}
    if paged:
        pool = dict(kv_block_size=model.kv_block_size,
                    kv_num_blocks=model.kv_num_blocks)
    if constraint is None:
        return blank_cache(model.cfg, batch, device=model.device,
                           per_row=per_row, side_slots=side_slots,
                           kv_heads=model.cache_kv_heads,
                           seq_len=model.cache_seq_len, **pool)
    whole = blank_cache(model.cfg, batch, device=torch.device("meta"),
                        per_row=per_row, side_slots=side_slots, **pool)
    cache = [{k: torch.zeros(v.shape, dtype=v.dtype, device=model.device)
              for k, v in layer.items()}
             for layer in apply_cache_constraint(whole, constraint, mesh)]
    want = blank_cache(model.cfg, batch, device=torch.device("meta"),
                       per_row=per_row, side_slots=side_slots,
                       kv_heads=model.cache_kv_heads,
                       seq_len=model.cache_seq_len, **pool)
    for got, exp in zip(cache, want):
        for name in exp:
            if got[name].shape != exp[name].shape:
                raise ValueError(
                    f"cache_constraint cuts {name} to "
                    f"{tuple(got[name].shape)}, but the model decodes a "
                    f"shard of {tuple(exp[name].shape)} (its decode_shard "
                    f"and tp_axis)")
    return cache


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
             pad_token: int = 0, cache_constraint=None, mesh=None):
    """Shared KV-cached decode loop; ``select`` picks the next token from
    each step's last-position logits.  With ``stop_tokens`` every position
    after a sequence's first stop token is frozen to ``pad_token`` and the
    return is ``(tokens, lengths)``.  ``cache_constraint`` (leaf -> spec
    or None) cuts the cache to this process's shard over ``mesh``
    (:func:`apply_cache_constraint`)."""
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
    cache = _blank_cache(model, b, constraint=cache_constraint, mesh=mesh)
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
    decode_attention: str = "flash",
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
      decode_attention: ``"flash"`` (K1 and K2) or ``"dense"`` (their
        plain versions).
      device: where to run (default ``cuda``; raises if there is none).

    Returns ``[batch, prompt_len + max_new_tokens]`` int32 on the device
    (plus ``[batch]`` lengths when ``stop_tokens`` is given).
    """
    model = build_model(cfg, params, device=device,
                        decode_attention=decode_attention)
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


def sample_generate(
    cfg: TransformerConfig,
    params: Mapping[str, Any],
    prompt,
    max_new_tokens: int,
    generator: torch.Generator | None = None,
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    decode_attention: str = "dense",
    prefill_chunk: int | None = None,
    stop_tokens: Sequence[int] | None = None,
    pad_token: int = 0,
    device=None,
):
    """Sample ``max_new_tokens`` past ``prompt`` with the standard
    controls: ``temperature`` scales the logits (0: greedy argmax),
    ``top_k`` keeps the k most probable tokens, ``top_p`` the smallest
    nucleus whose probability reaches p (after ``top_k`` when both are
    set); ``stop_tokens`` freezes a sequence at its first stop token and
    adds the ``[batch]`` lengths to the return.  Draws come from
    ``generator`` (on the model's device), in place of tpudist's
    ``key``."""
    model = build_model(cfg, params, device=device,
                        decode_attention=decode_attention)
    return _rollout(model, prompt, max_new_tokens,
                    _make_select(temperature, top_k, top_p), generator,
                    prefill_chunk=prefill_chunk, stop_tokens=stop_tokens,
                    pad_token=pad_token)


def _axis_size(mesh, axis: str) -> int:
    from tpudist_torch.runtime.mesh import axis_size

    return axis_size(mesh, axis)


def _sharded_layout(params, mesh, tp_axis, seq_axis, rules):
    """The ``decode_shard`` of a rollout sharded over ``tp_axis`` and/or
    ``seq_axis``, and this process's block of the whole ``params`` (the
    Megatron block over ``tp_axis`` by ``rules``; whole without it)."""
    if tp_axis and seq_axis:
        decode_shard = (mesh, (tp_axis, seq_axis), "heads_seq")
    elif seq_axis:
        decode_shard = (mesh, seq_axis, "seq")
    else:
        decode_shard = (mesh, tp_axis)
    if tp_axis:
        from tpudist_torch.parallel.tensor_parallel import (
            shard_tree,
            spec_tree_from_rules,
            transformer_tp_rules,
        )

        specs = spec_tree_from_rules(params,
                                     rules or transformer_tp_rules(tp_axis))
        params = shard_tree(params, mesh, specs)
    return decode_shard, params


def _sharded_generate(cfg, params, prompt, max_new_tokens, mesh, *,
                      tp_axis, seq_axis, cache_spec, rules, decode_attention,
                      prefill_chunk, generator, temperature, top_k, top_p,
                      stop_tokens, pad_token, device):
    """The common tail of :func:`tp_generate`, :func:`sp_generate` and
    :func:`tp_sp_generate`: this process's model (the Megatron layout over
    ``tp_axis``, its cache sharded as ``decode_shard`` says), its block of
    the weights, and :func:`_rollout` with the packed K/V buffers cut by
    ``cache_spec`` and the indices whole."""
    select = _make_select(temperature, top_k, top_p)
    decode_shard, params = _sharded_layout(params, mesh, tp_axis, seq_axis,
                                           rules)
    model = TransformerLM(cfg, tp_axis=tp_axis, mesh=mesh,
                          decode_shard=decode_shard,
                          decode_attention=decode_attention,
                          device=resolve_device(device))
    model.load_state_dict(params)
    model.eval()
    return _rollout(model, prompt, max_new_tokens, select, generator,
                    prefill_chunk=prefill_chunk, stop_tokens=stop_tokens,
                    pad_token=pad_token,
                    cache_constraint=lambda leaf: (cache_spec
                                                   if leaf.dim() == 3
                                                   else None),
                    mesh=mesh)


def tp_generate(
    cfg: TransformerConfig,
    params: Mapping[str, Any],
    prompt,
    max_new_tokens: int,
    mesh,
    axis: str = "model",
    rules=None,
    decode_attention: str = "dense",
    prefill_chunk: int | None = 512,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    stop_tokens: Sequence[int] | None = None,
    pad_token: int = 0,
    *,
    device=None,
):
    """Tensor-parallel decode (greedy by default; ``temperature`` /
    ``top_k`` / ``top_p`` with ``generator`` sample): each process of
    ``axis`` holds its block of the Megatron weights (``rules``, default
    :func:`~tpudist_torch.parallel.tensor_parallel.transformer_tp_rules`)
    and caches its own KV heads, so weight and cache memory scale 1/tp.
    Attention runs on the local heads (K1, K2 with ``"flash"``) with no
    collective; ``proj``/``down`` all-reduce and the logits are
    all-gathered as in training.  ``params`` is the whole model (a
    ``state_dict`` or a flax tree), the same on every process.  Requires
    ``kv_heads % tp == 0``.  Returns the same tokens as
    :func:`greedy_generate`, on every process."""
    cfg, params = serving_layout(cfg, params)
    tp = _axis_size(mesh, axis)
    if cfg.kv_heads % tp:
        raise ValueError(
            f"kv_heads {cfg.kv_heads} not divisible by {axis!r} size {tp}")
    return _sharded_generate(
        cfg, params, prompt, max_new_tokens, mesh, tp_axis=axis,
        seq_axis=None, cache_spec=(None, None, axis), rules=rules,
        decode_attention=decode_attention, prefill_chunk=prefill_chunk,
        generator=generator, temperature=temperature, top_k=top_k,
        top_p=top_p, stop_tokens=stop_tokens, pad_token=pad_token,
        device=device)


def sp_generate(
    cfg: TransformerConfig,
    params: Mapping[str, Any],
    prompt,
    max_new_tokens: int,
    mesh,
    axis: str = "seq",
    prefill_chunk: int | None = 512,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    stop_tokens: Sequence[int] | None = None,
    pad_token: int = 0,
    decode_attention: str = "dense",
    *,
    device=None,
):
    """Sequence-sharded-cache decode: the KV cache's sequence dim is split
    over ``axis`` (process ``i`` owns slots ``[i·S_loc, (i+1)·S_loc)``),
    so cache memory per process is 1/sp; the weights are replicated.  A
    token's K/V are written by the owner of its slot alone; each decode
    step is :func:`~tpudist_torch.ops.flash_decode.sp_flash_decode` and
    each prefill chunk attends to every slice in place, merged by LSE: no
    cache bytes move.  Requires ``max_seq_len % sp == 0``.  Returns the
    same tokens as :func:`greedy_generate`, on every process."""
    cfg, params = serving_layout(cfg, params)
    sp = _axis_size(mesh, axis)
    if cfg.max_seq_len % sp:
        raise ValueError(
            f"max_seq_len {cfg.max_seq_len} not divisible by {axis!r} "
            f"size {sp}")
    return _sharded_generate(
        cfg, params, prompt, max_new_tokens, mesh, tp_axis=None,
        seq_axis=axis, cache_spec=(None, axis, None), rules=None,
        decode_attention=decode_attention, prefill_chunk=prefill_chunk,
        generator=generator, temperature=temperature, top_k=top_k,
        top_p=top_p, stop_tokens=stop_tokens, pad_token=pad_token,
        device=device)


def tp_sp_generate(
    cfg: TransformerConfig,
    params: Mapping[str, Any],
    prompt,
    max_new_tokens: int,
    mesh,
    axis: str = "model",
    seq_axis: str = "seq",
    rules=None,
    decode_attention: str = "flash",
    prefill_chunk: int | None = 512,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    stop_tokens: Sequence[int] | None = None,
    pad_token: int = 0,
    *,
    device=None,
):
    """2-D sharded decode: the Megatron weights over ``axis`` and the KV
    cache over both its heads (``axis``) and its sequence
    (``seq_axis``), so cache memory per process is 1/(tp·sp).  Each
    process attends its (head block × cache slice); the partial softmaxes
    merge over ``seq_axis`` only.  Same tokens as
    :func:`greedy_generate`, on every process."""
    cfg, params = serving_layout(cfg, params)
    tp, sp = _axis_size(mesh, axis), _axis_size(mesh, seq_axis)
    if cfg.kv_heads % tp:
        raise ValueError(
            f"kv_heads {cfg.kv_heads} not divisible by {axis!r} size {tp}")
    if cfg.max_seq_len % sp:
        raise ValueError(
            f"max_seq_len {cfg.max_seq_len} not divisible by "
            f"{seq_axis!r} size {sp}")
    return _sharded_generate(
        cfg, params, prompt, max_new_tokens, mesh, tp_axis=axis,
        seq_axis=seq_axis, cache_spec=(None, seq_axis, axis), rules=rules,
        decode_attention=decode_attention, prefill_chunk=prefill_chunk,
        generator=generator, temperature=temperature, top_k=top_k,
        top_p=top_p, stop_tokens=stop_tokens, pad_token=pad_token,
        device=device)
