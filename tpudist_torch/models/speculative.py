"""Speculative decoding: a draft model proposes, the target verifies
(counterpart of :mod:`tpudist.models.speculative`).

A decode step at long context streams the whole KV cache once per token.
Speculative decoding spends that stream once per ROUND instead: a cheap
DRAFT model proposes ``num_draft`` (K) tokens one at a time, then the
TARGET scores all of them in one chunked forward.  Greedy speculative
decoding emits the target's own greedy tokens; sampled speculative
decoding emits tokens whose distribution is exactly the target's (accept
draft token x with probability min(1, p(x)/q(x)); on rejection resample
from norm(max(p - q, 0))).

On one card the rollout is a Python loop of eager rounds: the draft's K+1
single-token steps run kernel K2 (the scalar-index decode path; a draft
with an ``attention_window`` passes it to the kernel), the target's K+1
verify chunk runs kernel K1 at ``q_offset`` (the cached prefill path),
and both caches roll back by resetting their index (stale slots past it
are masked and overwritten).  Each round reads its accepted prefix length
``m`` on the host to place the next round; batched rows advance in
LOCKSTEP by the batch-min ``m + 1``, as in tpudist.

Sampling draws from an explicit ``torch.Generator``; it does not reproduce
``jax.random``'s bits (greedy decoding is exact either way).

The sharded rollouts (:func:`tp_speculative_generate`,
:func:`sp_speculative_generate`, :func:`tp_sp_speculative_generate`) run
one process a shard over a ``torch.distributed`` mesh, as the sharded
rollouts of :mod:`tpudist_torch.models.generate` do: the TARGET in the
Megatron layout and/or with a sequence-sharded cache (its verify chunk
attends each process's slice in place and merges by LSE), the small
DRAFT replicated on every process, so each drafts locally and every
process emits the same tokens.
"""

from __future__ import annotations

import time
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from tpudist_torch.models.generate import (
    _axis_size,
    _blank_cache,
    _filtered_logits,
    _is_stop,
    _make_select,
    _prefill,
    _rollout,
    _sharded_layout,
    _stop_array,
    build_model,
    sequence_lengths,
    serving_layout,
)
from tpudist_torch.models.transformer import (
    TransformerConfig,
    decode_shard_axes,
)
from tpudist_torch.utils.device import resolve_device


def _filtered_probs(logits: torch.Tensor, temperature: float,
                    top_k: Optional[int],
                    top_p: Optional[float]) -> torch.Tensor:
    """The (possibly filtered) categorical the rollout samples from, as
    PROBABILITIES, on the same filtering pipeline the selection uses
    (:func:`~tpudist_torch.models.generate._filtered_logits`).
    ``temperature == 0`` returns the argmax one-hot (greedy is the
    zero-temperature limit of the same rule)."""
    if temperature == 0.0:
        logits = logits.float()
        return torch.nn.functional.one_hot(
            logits.argmax(dim=-1), logits.shape[-1]).float()
    return torch.softmax(
        _filtered_logits(logits, temperature, top_k, top_p), dim=-1)


def _accept_and_next(p: torch.Tensor, q: torch.Tensor, draft: torch.Tensor,
                     generator: torch.Generator | None = None,
                     active: torch.Tensor | None = None):
    """The speculative accept/advance rule for one round, batched.

    Args:
      p: ``[B, K+1, V]`` target probabilities (``p[:, j]`` is the next-
        token distribution after draft token j; ``p[:, K]`` the bonus
        position).
      q: ``[B, K, V]`` draft probabilities (``q[:, j]`` is the one
        ``draft[:, j]`` was drawn from).
      draft: ``[B, K]`` proposed tokens.
      generator: randomness for the accept tests and the resample.
      active: optional ``[B]`` bool; FROZEN rows count as all-accept so
        they never drag the batch-min ``m`` down.

    Returns ``(m, emit, accepted)``: the batch-min accepted prefix length
    (0-D int64 on the device, 0..K), the ``[B]`` token emitted at position
    ``m + 1`` (the accepted draft where a row accepted past ``m``, else a
    resample of ``norm(max(p - q, 0))`` at ``m``, which at ``m == K`` is
    a sample of ``p[:, K]``) and the ``[B]`` per-row accepted counts."""
    b, k = draft.shape
    idx = draft.long()[..., None]
    p_at = p[:, :k].gather(-1, idx)[..., 0]                      # [B, K]
    q_at = q.gather(-1, idx)[..., 0]
    u = torch.rand((b, k), generator=generator, device=p.device)
    # greedy (one-hot p and q): accept iff the draft IS the target argmax
    ok = u * q_at.clamp_min(1e-20) < p_at
    if active is not None:
        ok = ok | ~active[:, None]
    accepted = torch.cumprod(ok.long(), dim=1).sum(dim=1)        # [B]
    m = accepted.min()
    # q padded with a zero row at K: the all-accepted bonus position
    # resamples from max(p - 0, 0) = p itself
    q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    at_m = m.view(1, 1, 1).expand(b, 1, p.shape[-1])
    p_m = p.gather(1, at_m)[:, 0]
    q_m = q_pad.gather(1, at_m)[:, 0]
    residual = (p_m - q_m).clamp_min(0.0)
    # an all-zero residual can only arise when p == q (rejection there
    # has probability 0); fall back to p so the draw stays defined
    residual = torch.where(residual.sum(-1, keepdim=True) > 0, residual, p_m)
    resampled = torch.multinomial(residual, 1, generator=generator)[:, 0]
    took_next = accepted > m
    next_draft = draft.long().gather(
        1, m.clamp(max=k - 1).view(1, 1).expand(b, 1))[:, 0]
    emit = torch.where(took_next, next_draft, resampled)
    return m, emit, accepted


def _set_cache_index(cache: list[dict], idx: int) -> list[dict]:
    """Roll the cache to ``idx`` tokens: every index leaf
    (``cache_index``, and ``side_index`` where present) is reset; K/V
    buffers are left as they are — slots past the index are masked by
    every cached-attention path and overwritten by the next write at that
    position."""
    for layer in cache:
        for name in ("cache_index", "side_index"):
            if name in layer:
                layer[name] = torch.full_like(layer[name], idx)
    return cache


def _validate_spec(target_cfg, draft_cfg, prompt_len: int,
                   max_new_tokens: int, num_draft: int) -> None:
    """tpudist's argument checks, in its order."""
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(
            f"draft vocab {draft_cfg.vocab_size} != target vocab "
            f"{target_cfg.vocab_size}")
    if num_draft < 1:
        raise ValueError(f"num_draft must be >= 1, got {num_draft}")
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if prompt_len < 1:
        raise ValueError("prompt must hold at least one token")
    # the verify chunk writes up to K cache slots past the last emitted
    # token, so both caches need headroom beyond prompt + max_new
    need = prompt_len + max_new_tokens + num_draft - 1
    for name, cfg in (("target", target_cfg), ("draft", draft_cfg)):
        if need > cfg.max_seq_len:
            raise ValueError(
                f"{name} max_seq_len {cfg.max_seq_len} < prompt_len + "
                f"max_new_tokens + num_draft - 1 = {need}")


def _as_prompt(prompt, dev) -> torch.Tensor:
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.from_numpy(np.array(prompt, dtype=np.int64))
    return prompt.to(device=dev, dtype=torch.long)


@torch.no_grad()
def speculative_generate(
    target_cfg: TransformerConfig,
    target_params: Mapping[str, Any],
    draft_cfg: TransformerConfig,
    draft_params: Mapping[str, Any],
    prompt,
    max_new_tokens: int,
    *,
    num_draft: int = 4,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    prefill_chunk: int | None = None,
    stop_tokens: Sequence[int] | None = None,
    pad_token: int = 0,
    return_stats: bool = False,
    decode_attention: str = "flash",
    draft_decode_attention: str = "flash",
    decode_shard: Any = None,
    cache_constraint: Any = None,
    draft_cache_constraint: Any = None,
    device=None,
):
    """Generate ``max_new_tokens`` past ``prompt`` with draft/verify
    speculative decoding.

    Args:
      target_cfg / target_params: the model whose output distribution the
        result follows exactly (a state_dict or a flax tree).
      draft_cfg / draft_params: the proposal model; only ``vocab_size``
        must match, and it may use sliding-window attention.
      num_draft: draft tokens proposed per verify round (K).
      generator: the ``torch.Generator`` of the accept tests and every
        draw (None: torch's default stream).
      temperature / top_k / top_p: sampling controls for both models
        (temperature 0 = greedy: the target's ``greedy_generate`` tokens,
        exact where the verify chunk's and the decode step's logits pick
        the same argmax).
      prefill_chunk: prompt tokens per prefill call (None = one shot).
      stop_tokens / pad_token: positions past a row's first stop token
        freeze to ``pad_token`` and per-row lengths are returned.
      return_stats: also return ``{"rounds", "draft_accepted"}``
        (accepted draft tokens summed over rounds and rows; ``rounds`` is
        0 when ``max_new_tokens == 1``).
      decode_attention / draft_decode_attention: each model's cached
        attention, ``"flash"`` (K1 and K2) or ``"dense"`` (their plain
        versions).
      decode_shard: shards the TARGET (``(mesh, axis[, kind])``, as on
        :class:`~tpudist_torch.models.transformer.TransformerLM`); a kind
        that shards heads builds it in the Megatron layout over that axis,
        and ``target_params`` is then this process's block of the weights
        (as :func:`tp_speculative_generate` cuts them).
      cache_constraint / draft_cache_constraint: leaf -> spec (or None)
        cutting each model's cache to this process's shard over the
        mesh of ``decode_shard``
        (:func:`~tpudist_torch.models.generate.apply_cache_constraint`);
        a shard that is not the one the model decodes raises.
      device: where to run (default ``cuda``; raises if there is none).

    Returns ``[B, prompt_len + max_new_tokens]`` int32 tokens, with
    ``(tokens, lengths)`` when ``stop_tokens`` is given and the stats dict
    appended when ``return_stats`` is set."""
    dev = resolve_device(device)
    prompt = _as_prompt(prompt, dev)
    b, prompt_len = prompt.shape
    _validate_spec(target_cfg, draft_cfg, prompt_len, max_new_tokens,
                   num_draft)
    k = num_draft
    stop_arr = _stop_array(stop_tokens, dev)
    select = _make_select(temperature, top_k, top_p)
    mesh = None if decode_shard is None else decode_shard[0]
    head_axis, _ = decode_shard_axes(decode_shard)
    target = build_model(target_cfg, target_params, device=dev,
                         decode_attention=decode_attention,
                         decode_shard=decode_shard, tp_axis=head_axis,
                         mesh=mesh if head_axis else None)
    draft = build_model(draft_cfg, draft_params, device=dev,
                        decode_attention=draft_decode_attention)

    # PREFILL both models on the prompt (K1)
    t_cache, t_logits = _prefill(
        target, _blank_cache(target, b, constraint=cache_constraint,
                             mesh=mesh), prompt, prefill_chunk)
    d_cache, _ = _prefill(
        draft, _blank_cache(draft, b, constraint=draft_cache_constraint,
                            mesh=mesh), prompt, prefill_chunk)
    first = select(t_logits[:, -1], generator)
    out = torch.zeros((b, max_new_tokens + k + 1), dtype=torch.long,
                      device=dev)
    out[:, 0] = first
    x = first
    emitted, rounds = 1, 0
    acc_total = torch.zeros((), dtype=torch.long, device=dev)
    t_idx = torch.arange(k + 1, device=dev)
    while emitted < max_new_tokens:
        n_cache = prompt_len + emitted - 1   # tokens resident in caches
        # DRAFT: K single-token proposals (K2) with their distributions;
        # a (K+1)-th step writes d_K's K/V for the all-accepted case
        tok, drafts, qs = x, [], []
        for j in range(k + 1):
            pos = torch.full((b, 1), n_cache + j, dtype=torch.long,
                             device=dev)
            logits, d_cache = draft(tok[:, None], positions=pos,
                                    cache=d_cache)
            if j == k:
                break
            qs.append(_filtered_probs(logits[:, -1], temperature, top_k,
                                      top_p))
            tok = select(logits[:, -1], generator)
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)                     # [B, K]
        q = torch.stack(qs, dim=1)                              # [B, K, V]
        # VERIFY: one target chunk over [x, d_1..d_K] (K1 at q_offset)
        verify = torch.cat([x[:, None], drafts], dim=1)
        logits, t_cache = target(verify, positions=(n_cache + t_idx)[None],
                                 cache=t_cache)
        p = _filtered_probs(logits, temperature, top_k, top_p)
        m_dev, emit, accepted = _accept_and_next(p, q, drafts, generator)
        m = int(m_dev)                       # the round's one host read
        # emit e_1..e_{m+1}: the accepted drafts, then the verify token
        e_buf = torch.cat([drafts, emit[:, None]], dim=1)
        e_buf[:, m] = emit
        out[:, emitted:emitted + k + 1] = e_buf
        new_len = n_cache + m + 1
        _set_cache_index(t_cache, new_len)
        _set_cache_index(d_cache, new_len)
        x = emit
        emitted += m + 1
        rounds += 1
        acc_total += accepted.sum()
    generated = out[:, :max_new_tokens]
    if stop_arr is not None:
        # EOS as in _rollout: keep each row's first stop token, freeze
        # everything after it to pad_token
        hit = _is_stop(generated, stop_arr).long()
        after_stop = (torch.cumsum(hit, dim=1) - hit) > 0
        generated = torch.where(after_stop,
                                torch.full_like(generated, pad_token),
                                generated)
    tokens = torch.cat([prompt, generated], dim=1).to(torch.int32)
    result = (tokens,) if stop_arr is None else (
        tokens, sequence_lengths(generated, stop_arr, prompt_len))
    if return_stats:
        result = result + ({"rounds": rounds,
                            "draft_accepted": int(acc_total)},)
    return result[0] if len(result) == 1 else result


def _sharded_speculative(target_cfg, target_params, draft_cfg, draft_params,
                         prompt, max_new_tokens, mesh, *, tp_axis, seq_axis,
                         cache_spec, rules, **kw):
    """The common tail of the sharded speculative entry points: both
    models in the serving layout, the target's weights cut to this
    process's block (``tp_axis``), its cache by ``cache_spec``, the
    draft's whole, then :func:`speculative_generate`."""
    target_cfg, target_params = serving_layout(target_cfg, target_params)
    draft_cfg, draft_params = serving_layout(draft_cfg, draft_params)
    decode_shard, target_params = _sharded_layout(
        target_params, mesh, tp_axis, seq_axis, rules)
    return speculative_generate(
        target_cfg, target_params, draft_cfg, draft_params, prompt,
        max_new_tokens, decode_shard=decode_shard,
        cache_constraint=lambda leaf: (cache_spec if leaf.dim() == 3
                                       else None),
        draft_cache_constraint=lambda leaf: None, **kw)


def tp_speculative_generate(
    target_cfg: TransformerConfig,
    target_params: Mapping[str, Any],
    draft_cfg: TransformerConfig,
    draft_params: Mapping[str, Any],
    prompt,
    max_new_tokens: int,
    mesh,
    axis: str = "model",
    rules=None,
    *,
    num_draft: int = 4,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    decode_attention: str = "dense",
    prefill_chunk: int | None = 512,
    stop_tokens: Sequence[int] | None = None,
    pad_token: int = 0,
    return_stats: bool = False,
    device=None,
):
    """Tensor-parallel speculative decoding: the TARGET in the Megatron
    layout over ``axis`` (weights and KV cache 1/tp a process, the
    :func:`~tpudist_torch.models.generate.tp_generate` layout), the DRAFT
    replicated, so every process drafts locally and the verify chunks are
    the only sharded compute.  Both models' cached attention follow
    ``decode_attention``.  ``target_params`` is the whole model, the same
    on every process.  Requires ``target_cfg.kv_heads % tp == 0``.  Same
    output contract as :func:`speculative_generate`, on every process."""
    tp = _axis_size(mesh, axis)
    if target_cfg.kv_heads % tp:
        raise ValueError(
            f"target kv_heads {target_cfg.kv_heads} not divisible by "
            f"{axis!r} size {tp}")
    return _sharded_speculative(
        target_cfg, target_params, draft_cfg, draft_params, prompt,
        max_new_tokens, mesh, tp_axis=axis, seq_axis=None,
        cache_spec=(None, None, axis), rules=rules, num_draft=num_draft,
        generator=generator, temperature=temperature, top_k=top_k,
        top_p=top_p, decode_attention=decode_attention,
        draft_decode_attention=decode_attention,
        prefill_chunk=prefill_chunk, stop_tokens=stop_tokens,
        pad_token=pad_token, return_stats=return_stats, device=device)


def tp_sp_speculative_generate(
    target_cfg: TransformerConfig,
    target_params: Mapping[str, Any],
    draft_cfg: TransformerConfig,
    draft_params: Mapping[str, Any],
    prompt,
    max_new_tokens: int,
    mesh,
    axis: str = "model",
    seq_axis: str = "seq",
    rules=None,
    *,
    num_draft: int = 4,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    prefill_chunk: int | None = 512,
    stop_tokens: Sequence[int] | None = None,
    pad_token: int = 0,
    return_stats: bool = False,
    decode_attention: str = "dense",
    device=None,
):
    """2-D sharded speculative decoding: the TARGET's weights Megatron-
    sharded over ``axis`` and its KV cache over heads (``axis``) and
    sequence (``seq_axis``), 1/(tp·sp) a process; the DRAFT replicated.
    Same output contract as :func:`speculative_generate`."""
    tp = _axis_size(mesh, axis)
    sp = _axis_size(mesh, seq_axis)
    if target_cfg.kv_heads % tp:
        raise ValueError(
            f"target kv_heads {target_cfg.kv_heads} not divisible by "
            f"{axis!r} size {tp}")
    if target_cfg.max_seq_len % sp:
        raise ValueError(
            f"target max_seq_len {target_cfg.max_seq_len} not divisible "
            f"by {seq_axis!r} size {sp}")
    return _sharded_speculative(
        target_cfg, target_params, draft_cfg, draft_params, prompt,
        max_new_tokens, mesh, tp_axis=axis, seq_axis=seq_axis,
        cache_spec=(None, seq_axis, axis), rules=rules,
        num_draft=num_draft, generator=generator, temperature=temperature,
        top_k=top_k, top_p=top_p, decode_attention=decode_attention,
        draft_decode_attention=decode_attention,
        prefill_chunk=prefill_chunk, stop_tokens=stop_tokens,
        pad_token=pad_token, return_stats=return_stats, device=device)


def sp_speculative_generate(
    target_cfg: TransformerConfig,
    target_params: Mapping[str, Any],
    draft_cfg: TransformerConfig,
    draft_params: Mapping[str, Any],
    prompt,
    max_new_tokens: int,
    mesh,
    axis: str = "seq",
    *,
    num_draft: int = 4,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    prefill_chunk: int | None = 512,
    stop_tokens: Sequence[int] | None = None,
    pad_token: int = 0,
    return_stats: bool = False,
    decode_attention: str = "dense",
    device=None,
):
    """Sequence-sharded speculative decoding: the TARGET's KV cache split
    over ``axis`` on its sequence dimension (1/sp a process; weights
    replicated), the DRAFT replicated.  Each verify chunk attends every
    process's slice in place and merges by LSE; no cache bytes move.
    Same output contract as :func:`speculative_generate`."""
    sp = _axis_size(mesh, axis)
    if target_cfg.max_seq_len % sp:
        raise ValueError(
            f"target max_seq_len {target_cfg.max_seq_len} not divisible "
            f"by {axis!r} size {sp}")
    return _sharded_speculative(
        target_cfg, target_params, draft_cfg, draft_params, prompt,
        max_new_tokens, mesh, tp_axis=None, seq_axis=axis,
        cache_spec=(None, axis, None), rules=None, num_draft=num_draft,
        generator=generator, temperature=temperature, top_k=top_k,
        top_p=top_p, decode_attention=decode_attention,
        draft_decode_attention=decode_attention,
        prefill_chunk=prefill_chunk, stop_tokens=stop_tokens,
        pad_token=pad_token, return_stats=return_stats, device=device)


class AdaptiveDraftPolicy:
    """Acceptance-driven choice of ``num_draft``: low acceptance makes long
    draft chunks WORSE than plain decode (the target still streams its
    cache once per round, but the round only advances by the batch-min
    accepted prefix plus one), so K shrinks with measured acceptance.

    With per-token acceptance ``a`` (i.i.d. over rows and positions) a
    batch-B round advances by ``E = 1 + sum_{j=1..K} a^(B*j)`` tokens and
    costs ``K * c_draft + c_verify``; :meth:`best_k` maximizes tokens per
    cost over the ladder.  ``a`` is recovered from the observed per-row
    acceptance (``draft_accepted / (rounds * B) = sum_{j=1..K} a^j``) by
    bisection.  Round costs are MEASURED (:meth:`observe_round_cost`, a
    linear fit in K between observed points) once any is known, with the
    analytic ``K * draft_cost_ratio + 1`` as the prior; with the plain
    per-token cost armed (:meth:`set_plain_cost`) :meth:`best_k` returns
    0 ("plain decode") when even the best K loses to it.  Pure Python:
    the same numbers as tpudist's policy on the same calls.

    Args:
      ladder: candidate K values.
      draft_cost_ratio: PRIOR c_draft / c_verify, used until a measured
        cost arrives.
      ema: smoothing of the acceptance and cost estimates.
      initial_acceptance: the acceptance estimate before any update.
    """

    def __init__(self, ladder: Sequence[int] = (4, 8, 16),
                 draft_cost_ratio: float = 0.1, ema: float = 0.5,
                 initial_acceptance: float = 0.8) -> None:
        if not ladder or any(k < 1 for k in ladder):
            raise ValueError(f"ladder must hold K >= 1, got {ladder}")
        if not 0 < draft_cost_ratio:
            raise ValueError("draft_cost_ratio must be > 0")
        self.ladder = tuple(sorted(ladder))
        self.r = float(draft_cost_ratio)
        self.ema = float(ema)
        self.acceptance = float(initial_acceptance)
        self.rounds_seen = 0
        self._round_cost: dict[int, float] = {}   # K -> seconds/round
        self._plain_tok_s: float | None = None    # seconds/token, plain

    # -- the algebra -------------------------------------------------------

    @staticmethod
    def _per_row_mean(a: float, k: int) -> float:
        """E[accepted prefix] for one row at per-token probability a."""
        return sum(a ** j for j in range(1, k + 1))

    @classmethod
    def infer_acceptance(cls, accept_rate: float, k: int) -> float:
        """Per-token acceptance probability ``a`` from the K-truncated
        mean accept fraction (``draft_accepted / (rounds*K*B)``)."""
        accept_rate = min(max(accept_rate, 0.0), 1.0)
        target = accept_rate * k
        lo, hi = 0.0, 1.0
        for _ in range(50):
            mid = (lo + hi) / 2
            if cls._per_row_mean(mid, k) < target:
                lo = mid
            else:
                hi = mid
        return (lo + hi) / 2

    def expected_tokens_per_round(self, a: float, k: int,
                                  batch: int) -> float:
        return 1.0 + sum(a ** (batch * j) for j in range(1, k + 1))

    # -- measured costs ----------------------------------------------------

    def observe_round_cost(self, k: int, seconds_per_round: float) -> None:
        """Fold one measured draft+verify round cost at chunk ``k`` into
        the cost model (EMA-smoothed per K)."""
        if seconds_per_round <= 0:
            return
        prev = self._round_cost.get(k)
        self._round_cost[k] = (
            seconds_per_round if prev is None
            else self.ema * seconds_per_round + (1 - self.ema) * prev)

    def set_plain_cost(self, seconds_per_token: float) -> None:
        """Arm the break-even gate with the measured plain-decode cost
        (EMA-smoothed once armed)."""
        if seconds_per_token <= 0:
            return
        prev = self._plain_tok_s
        self._plain_tok_s = (
            float(seconds_per_token) if prev is None
            else self.ema * float(seconds_per_token) + (1 - self.ema) * prev)

    @property
    def calibrated(self) -> bool:
        return bool(self._round_cost)

    def round_cost(self, k: int) -> float:
        """Seconds (measured) or c_verify units (the analytic prior) for
        one round at chunk ``k``: exact where observed; a least-squares
        linear-in-K fit where >= 2 Ks were observed; the one observed
        point scaled by the analytic shape at 1; the analytic shape at
        0."""
        if k in self._round_cost:
            return self._round_cost[k]
        pts = sorted(self._round_cost.items())
        if len(pts) >= 2:
            xs = [p[0] for p in pts]
            ys = [p[1] for p in pts]
            n = len(pts)
            mx = sum(xs) / n
            my = sum(ys) / n
            den = sum((x - mx) ** 2 for x in xs)
            slope = (sum((x - mx) * (y - my) for x, y in pts) / den
                     if den else 0.0)
            return max(my + slope * (k - mx), 1e-9)
        if len(pts) == 1:
            k0, c0 = pts[0]
            return c0 * (k * self.r + 1.0) / (k0 * self.r + 1.0)
        return k * self.r + 1.0

    def best_k(self, a: float | None = None, batch: int = 1,
               allow_plain: bool = True) -> int:
        """The ladder K maximizing expected tokens per unit cost at
        acceptance ``a`` (default: the running estimate), or ``0`` (plain
        decode) when the break-even gate is armed and even the best K
        loses to plain; ``allow_plain=False`` bypasses the gate."""
        a = self.acceptance if a is None else a

        def rate(k):
            return (self.expected_tokens_per_round(a, k, batch)
                    / self.round_cost(k))

        k_star = max(self.ladder, key=rate)
        if allow_plain and self.calibrated and self._plain_tok_s is not None:
            if rate(k_star) <= 1.0 / self._plain_tok_s:
                return 0
        return k_star

    # -- the feedback loop -------------------------------------------------

    @property
    def num_draft(self) -> int:
        return self.best_k()

    def update(self, stats: dict, batch: int, num_draft: int) -> None:
        """Fold one rollout's stats into the acceptance estimate (a
        ``rounds == 0`` observation changes nothing)."""
        rounds = int(stats["rounds"])
        if rounds == 0:
            return
        rate = float(stats["draft_accepted"]) / (rounds * num_draft * batch)
        a = self.infer_acceptance(rate, num_draft)
        w = self.ema if self.rounds_seen else 1.0
        self.acceptance = w * a + (1.0 - w) * self.acceptance
        self.rounds_seen += rounds


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def adaptive_speculative_generate(
    target_cfg: TransformerConfig,
    target_params: Mapping[str, Any],
    draft_cfg: TransformerConfig,
    draft_params: Mapping[str, Any],
    prompt,
    max_new_tokens: int,
    policy: AdaptiveDraftPolicy,
    *,
    segment_tokens: int = 128,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    prefill_chunk: int | None = None,
    return_stats: bool = False,
    probe_plain: bool = True,
    reprobe_every: int = 4,
    device=None,
):
    """Speculative decoding with ``num_draft`` adapted to measured
    acceptance, in segments of ``segment_tokens``: each segment is one
    :func:`speculative_generate` rollout at the policy's current K (or a
    plain rollout where the break-even gate says so), and its stats and
    wall time update the policy before the next.  K changes the schedule,
    never the accept rule, so the output stays exact.

    With ``probe_plain`` the second segment runs the plain rollout, timed
    once more on the same input, to arm the gate; every ``reprobe_every``
    plain segments in a row one speculative segment re-probes the draft.
    Each K's first segment at a given length is left out of the measured
    costs (as in tpudist, where it holds the compile).

    Returns tokens ``[B, prompt_len + max_new_tokens]`` (and, with
    ``return_stats``, ``{"ks", "acceptance", "rounds",
    "draft_accepted"}``, ``ks`` holding 0 for a plain segment)."""
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if segment_tokens < 1:
        raise ValueError(
            f"segment_tokens must be >= 1, got {segment_tokens}")
    dev = resolve_device(device)
    toks = _as_prompt(prompt, dev)
    batch = toks.shape[0]
    remaining = max_new_tokens
    seg_stats: dict = {"ks": [], "acceptance": [], "rounds": 0,
                       "draft_accepted": 0}
    uses: dict[tuple[int, int], int] = {}
    seg_i = 0
    plain_streak = 0
    plain_model = None
    select = _make_select(temperature, top_k, top_p)
    while remaining > 0:
        n = min(segment_tokens, remaining)
        k_seg = policy.best_k(batch=batch)
        if probe_plain and policy._plain_tok_s is None and seg_i == 1:
            k_seg = 0   # the plain probe segment (arms the gate below)
        elif (k_seg == 0 and reprobe_every > 0
                and plain_streak >= reprobe_every):
            # a gate-locked policy would never see the draft recover
            k_seg = policy.best_k(batch=batch, allow_plain=False)
        plain_streak = plain_streak + 1 if k_seg == 0 else 0
        t0 = time.perf_counter()
        if k_seg == 0:
            if plain_model is None:
                plain_model = build_model(target_cfg, target_params,
                                          device=dev)

            def plain_call(t):
                return _rollout(plain_model, t, n, select, generator,
                                prefill_chunk=prefill_chunk).long()

            toks_in = toks
            toks = plain_call(toks_in)
            _sync(dev)
            dt = time.perf_counter() - t0
            if uses.get((0, n), 0) >= 1:
                policy.set_plain_cost(dt / n)
            elif policy._plain_tok_s is None:
                # re-time the same call so the gate arms in one probe
                t1 = time.perf_counter()
                plain_call(toks_in)
                _sync(dev)
                policy.set_plain_cost((time.perf_counter() - t1) / n)
            stats = {"rounds": 0, "draft_accepted": 0}
        else:
            toks, stats = speculative_generate(
                target_cfg, target_params, draft_cfg, draft_params, toks,
                n, num_draft=k_seg, generator=generator,
                temperature=temperature, top_k=top_k, top_p=top_p,
                prefill_chunk=prefill_chunk, return_stats=True, device=dev)
            toks = toks.long()
            _sync(dev)
            dt = time.perf_counter() - t0
            rounds = int(stats["rounds"])
            if rounds > 0 and uses.get((k_seg, n), 0) >= 1:
                policy.observe_round_cost(k_seg, dt / rounds)
            policy.update(stats, batch, k_seg)
        uses[(k_seg, n)] = uses.get((k_seg, n), 0) + 1
        seg_stats["ks"].append(k_seg)
        seg_stats["acceptance"].append(policy.acceptance)
        seg_stats["rounds"] += int(stats["rounds"])
        seg_stats["draft_accepted"] += int(stats["draft_accepted"])
        remaining -= n
        seg_i += 1
    toks = toks.to(torch.int32)
    return (toks, seg_stats) if return_stats else toks
