"""Continuous-batching serving loop, core (counterpart of
:mod:`tpudist.models.serving`).

``num_slots`` decode lanes each own one row of a dense KV cache whose
``cache_index`` is a ``[B]`` vector, so every lane decodes at its own
length through the per-row attention path.  Between host syncs the loop
runs a SEGMENT of up to ``steps_per_sync`` decode ticks; each tick
writes its K/V to a segment-local side buffer and attends main cache +
side buffer in one flash-decode kernel call (K2), and the segment ends
with one merge of side into main (the JAX loop's
``decode_attention="flash"``; a sliding-window model has no per-row
kernel and decodes through the plain banded mask without side buffers).
Admission prefills the prompt into a fresh batch-1 cache through the
flash-forward kernel (K1) — in one go, or one ``prefill_chunk`` per loop
iteration interleaved with decode segments (``chunked_prefill``) — and
inserts the row into the freed slot.  Per-request budgets and stop tokens
freeze a lane inside the segment; the host finalizes completions in finish
order and reuses the slot.

``cache_layout="paged"`` keeps the slots' K/V in one block pool per layer
instead (PagedAttention; :mod:`tpudist_torch.models.kv_pages` is the host
half): admission allocates the prompt's blocks and reserves the rest of the
request's footprint, and QUEUES (FIFO) while the pool lacks the blocks;
each segment grows every decoding lane's pages first and stamps the page
table into the cache; each tick attends the frozen pool through the page
table plus the side buffer in one paged flash-decode kernel call (K5); the
segment's merge scatters the side tokens into pool pages; a finished
request frees its blocks.  With ``prefix_sharing`` (chunked admission) a
prompt whose leading blocks are cached ALIASES them copy-on-write and
prefills only the rest.  Prefill stays dense, into the batch-1 cache, and
the finish scatters that row into the slot's own pages.

The loop keeps up to ``pipeline_depth`` segments in flight (default 2,
as in tpudist).  Each dispatch chains the device state at once; its emits
and ``corrupt`` flags are copied device-to-host into pinned buffers by
non-blocking copies on a side stream, after an event recorded on the
compute stream (the twin of tpudist's ``copy_to_host_async``), and the
host drains the OLDEST segment — waiting on that copy's event — while the
next one computes.  Each lane carries tpudist's ``seq`` stamp (the first
segment whose emits can hold its tokens), so a drain feeds only the lanes
a segment carries.  At depth 1 each tick reads the lanes' ``active.any()``
on the host for its early exit (tpudist's ``while_loop`` condition); at
depth >= 2 a segment issues all its ticks without a host read: each tick
copies ``active.any()`` into a pinned flag, and a tick leaves once the
flag of the tick two before it has landed and says no lane is active (at
most two ticks run with every lane frozen, which emit pad and merge
nothing).  Each request's greedy tokens and finish reason are the same
at every depth (a lane's rows are its own).  The finish ORDER is too
unless a lane frees while requests wait: deeper, the host learns of the
finish a segment later, so the next admission lands a segment later and
finishes close together may swap places (tpudist's loop alike).
Counters are plain attributes (``stats``, ``prefix_stats``) and, under
tpudist's names and units, the process-global :mod:`tpudist_torch.obs`
registry's ``serve/*`` metrics (host values only: no metric reads the
card); admissions, chunks, segments and swaps are ``obs`` spans, traced
requests (``Request.trace``) record their lifecycle in ``obs.events``,
and ``run`` is guarded by the flight recorder.

Requests may carry deadlines: a queued request past its deadline
completes ``reason="timeout"``; a lane past it is frozen on the device and
finalized with the tokens drained so far, and each segment's length is
clamped against the tightest deadline by the measured seconds per token.
With segments in flight, a killed paged lane keeps its blocks as a ZOMBIE
until every segment dispatched before the kill has drained.
:meth:`ServeLoop.request_swap` rebinds the weights once every lane and
segment has drained (no request straddles two weight versions), and
``run(source=, sink=)`` is service mode: incremental intake, completions
streamed as they finish.

``decode_mode="speculative"`` runs each segment as ROUNDS: the draft
model (dense, per row, no side buffer) takes K+1 single-token steps (K2,
or the banded mask for a windowed draft), then the target verifies
``[tok, d_1..d_K]`` as one chunk through the sided path (K+1 launches of
K2 or K5 a layer, one per query, as tpudist's wrappers loop), the round
takes :func:`~tpudist_torch.models.speculative._accept_and_next` and both
caches roll back by ``K - m``.  Each round reads ``com`` (tokens emitted
in the segment) and ``any(active)`` on the host, at every depth; the side
buffer holds ``steps_per_sync + K_max`` slots, which a round never
overruns.  Admission is one-shot (the target's plus a draft prefill into
the same slot); ``num_draft="adaptive"`` lets
:class:`~tpudist_torch.models.speculative.AdaptiveDraftPolicy` pick K from
``spec_ladder`` on the measured acceptance and round costs.

``role="prefill"`` / ``"decode"`` split a fleet: a prefill loop exports a
finished prompt's pool pages and its sampled first token as a KV HANDOFF
payload (``Completion(reason="handoff", handoff=payload)``); a decode loop
ADOPTS a ``Request.kv_handoff`` into freshly allocated blocks, or falls
back to an ordinary prefill when any gate fails (structure, length, block
size, hash chain, layer count and shape, weights version).  Payload layers
are ``[n_blocks, block, Hkv·D]`` host arrays in tpudist's layer order:
numpy for f32, CPU tensors for bf16 (numpy has no bf16 without
``ml-dtypes``; a numpy bf16 bit pattern is read too).  With
``preempt="migrate"`` a blocked higher-priority request PARKS the
lowest-priority decoding lane (its payload kept whole in host RAM) and
resumes it through the adopt path when pressure clears;
:meth:`ServeLoop.request_migrate` / :meth:`ServeLoop.request_evacuate`
hand lanes out as ``reason="migrate"`` completions in service mode.  Every
export first drains the segments in flight, so no zombie's blocks and no
half-merged segment are ever exported.

The host-RAM tier (:mod:`tpudist_torch.models.kv_tier`, budget
``TPUDIST_KV_HOST_TIER_BYTES``) backs the prefix cache: a block it evicts
is copied to pinned host memory under its chain hash, an admission whose
chain walk runs past the pool-resident prefix re-admits the spilled
blocks (a copy on a side stream) instead of re-prefilling them, a parked
lane's pages spill into it block by block, and a weight swap flushes it.
The overload ladder is ported: past ``degrade_queue`` waiting
requests best-effort budgets are clamped, past ``max_queue`` the overflow
is shed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import time
import warnings
from collections import deque
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from tpudist_torch import obs
from tpudist_torch.models.generate import (
    _blank_cache,
    _make_select,
    _prefill,
    _stop_array,
    build_model,
    serving_layout,
)
from tpudist_torch.models.kv_pages import BlockPool, PrefixCache, chain_hashes
from tpudist_torch.models.kv_tier import HostTier, tier_budget_from_env
from tpudist_torch.models.speculative import (
    AdaptiveDraftPolicy,
    _accept_and_next,
    _filtered_probs,
    _set_cache_index,
)
from tpudist_torch.models.transformer import TransformerConfig
from tpudist_torch.runtime import faults
from tpudist_torch.utils.device import resolve_device


def _park_hash(rid, i: int) -> int:
    """The host-tier key of a parked lane's ``i``-th KV block: a 63-bit
    blake2b digest of ``(rid, i)``, disjoint from prefix chain hashes
    with overwhelming probability (tpudist's key, bit for bit)."""
    d = hashlib.blake2b(f"park:{rid}:{i}".encode(), digest_size=8)
    return int.from_bytes(d.digest(), "big") >> 1


@dataclasses.dataclass
class Request:
    """One serving request: a prompt and its generation budget.
    ``priority`` orders load shedding (lowest class first); ``deadline_s``
    is an absolute time on the loop's clock (``time.time`` unless swapped)
    past which the request completes ``reason="timeout"``.
    ``prefix_hash`` is an opaque client-stamped hash of the prompt's shared
    prefix (:func:`tpudist_torch.models.kv_pages.request_prefix_hash`); a
    loop with prefix sharing on records the recent ones
    (:meth:`ServeLoop.prefix_summary`) for a router's affinity."""

    prompt: np.ndarray            # [L] int tokens, L >= 1
    max_new_tokens: int
    rid: Any = None               # caller's correlation id
    deadline_s: float | None = None
    priority: int = 0             # 0 = best-effort; higher = keep longer
    # the fleet's tracing context (obs.events.TraceContext, None for
    # untraced local runs): keys this loop's lifecycle events to the one
    # fleet-wide id that survives a redispatch
    trace: Any = None
    prefix_hash: int | None = None
    # a KV migration payload (a prefill loop's handoff or a migrated
    # lane): a decode-capable paged loop ADOPTS its pages; None, or a
    # payload failing a gate, means an ordinary prefill
    kv_handoff: Any = None
    # pull-mode fleet prefix cache: a KV transport ref to a peer-exported
    # prefix payload, resolved and installed by the replica worker before
    # admission (a miss installs nothing: the full prefill is exact)
    prefix_ref: str | None = None


@dataclasses.dataclass
class Completion:
    rid: Any
    prompt: np.ndarray
    tokens: np.ndarray            # the generated tokens (stop included)
    # "stop" | "length"; "rejected" (load-shed at a full queue);
    # "timeout" (past its deadline, queued or in flight); "invalid" (a
    # malformed request in service mode); "corrupt_segment" (non-finite
    # logits or an out-of-vocab token); "handoff" (a prefill loop
    # exported the prompt's KV: ``handoff``); "migrate" (handed out by
    # request_migrate / request_evacuate, ``handoff`` the payload or
    # None for a request that never held a lane)
    reason: str
    handoff: Any = None           # KV migration payload


@dataclasses.dataclass
class ServeStats:
    """Cumulative host-side tallies (the JAX loop's obs counters)."""

    requests: int = 0             # admitted
    rejected: int = 0
    degrade_clamped: int = 0      # best-effort budgets clamped when degraded
    tokens: int = 0               # finalized generated tokens
    segments: int = 0
    ticks: int = 0                # decode ticks run across all segments
    corrupt_segments: int = 0
    prompt_tokens: int = 0
    decode_tokens: int = 0        # tokens emitted by decode segments
    prefill_seconds: float = 0.0  # prefill dispatches (synchronized at depth 1)
    # segment dispatch -> emits drained on the host; segments in flight
    # together overlap, so at depth >= 2 the sum exceeds the wall time
    decode_seconds: float = 0.0
    host_wait_seconds: float = 0.0  # blocked on a segment's emits copy
    timeouts: int = 0
    invalid: int = 0
    swaps: int = 0                # weight rebinds applied
    spec_rounds: int = 0          # speculative draft+verify rounds
    spec_accepted: int = 0        # accepted draft tokens (live rows)
    spec_row_rounds: int = 0      # live rows summed over rounds
    # draft steps = verify queries (K+1 of each a round): the K2/K5
    # launches a speculative segment makes per layer
    spec_draft_steps: int = 0
    spec_k: int = 0               # the K of the last speculative segment
    adoptions: int = 0            # handoffs admitted by adopting pages
    handoff_fallbacks: int = 0    # handoffs re-prefilled (a gate failed)
    preempted: int = 0            # lanes parked by priority preemption
    resumed: int = 0              # parked lanes put back in the queue
    migrated_out: int = 0         # reason="migrate" completions


def _index_leaves(cache: list[dict]):
    """(cache_index [B], side_index 0-D | None): every layer carries the
    same values, so the first layer's suffice."""
    return cache[0]["cache_index"], cache[0].get("side_index")


def _host_array(t: torch.Tensor):
    """A payload layer on the host: numpy for f32, a CPU tensor for the
    types numpy lacks (bf16)."""
    t = t.detach().cpu()
    return t.numpy() if t.dtype == torch.float32 else t


def _pinned(t: torch.Tensor, stream) -> torch.Tensor:
    """``t`` (a host tensor) in pinned memory when the loop runs on a card
    (``stream`` set), else as it is."""
    return t.contiguous().pin_memory() if stream is not None else t


def _payload_tensor(x) -> torch.Tensor:
    """A payload layer as a tensor: a tensor as it is, a numpy array by
    its dtype, a numpy bf16 (``ml-dtypes``, whose dtype numpy reads as a
    raw 2-byte void) by its bit pattern."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.array(x, copy=True, order="C")
    if arr.dtype.itemsize == 2 and (arr.dtype.kind == "V"
                                    or arr.dtype.name == "bfloat16"):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _insert_dense(cache: list[dict], cache1: list[dict], slot: int,
                  true_len: int) -> None:
    """Copy a prefilled dense batch-1 cache into row ``slot`` of the same
    model's dense per-row cache ``cache`` and stamp its length."""
    for big, small in zip(cache, cache1):
        big["cached_key"][slot].copy_(small["cached_key"][0])
        big["cached_value"][slot].copy_(small["cached_value"][0])
        big["cache_index"][slot] = true_len


class ServeLoop:
    """Continuous-batching server over one model.

    Args:
      cfg / params: the model; ``params`` is the port's state_dict or a
        flax parameter tree (converted; scanned checkpoints unstacked).
      num_slots: decode lanes (the B of the slot cache).
      steps_per_sync: decode ticks per segment (and side-buffer capacity).
      prefill_chunk: admission prefill chunk; prompts are right-padded to
        a multiple of it (capped at ``max_seq_len``).
      stop_tokens / pad_token: EOS semantics as in ``greedy_generate``.
      temperature / top_k / top_p / generator: sampling (0 = greedy).
      pipeline_depth: segments in flight before the host blocks on the
        oldest one's emits (1 = the synchronous loop).  Greedy tokens
        are the same at every depth (the finish order, see the module
        docstring, unless lanes free while requests wait); a sampled run
        draws a different stream at depth >= 2 (a segment's ticks past
        its last live one still draw).
      max_queue: bound on WAITING requests; overflow is shed — lowest
        ``priority`` first, newest first within a class — as
        ``reason="rejected"`` completions.
      degrade_queue / degrade_max_new: soft overload watermark (default
        ``max_queue // 2``); while more requests wait, admissions clamp
        best-effort (``priority <= 0``) budgets to ``degrade_max_new``.
      preempt: "degrade" (the ladder above) or "migrate" (paged only):
        priority-first admission, and a blocked higher-priority request
        parks the lowest-priority decoding lane instead of clamping it;
        the lane resumes byte-identical through the adopt path.
      decode_mode: "plain" or "speculative" (draft-K proposal and one
        target verify chunk per round; the target's greedy tokens).
      draft_cfg / draft_params: the proposal model (speculative only): the
        target's vocabulary, a ``max_seq_len`` covering the target's.
      num_draft: draft tokens per round, an int, or "adaptive" to let
        :class:`AdaptiveDraftPolicy` pick from ``spec_ladder``.
      spec_ladder: candidate K values for the adaptive policy.
      chunked_prefill: admit one prompt chunk per loop iteration between
        decode segments instead of the whole prompt at once (same chunk
        grid, same tokens); plain decode only (speculative admission is
        one-shot, as in tpudist).
      cache_layout: "dense" (per-slot ``[B, S]`` K/V buffers) or "paged"
        (one block pool per layer plus per-slot page tables).
      kv_block_size: tokens per KV block (paged only), a positive
        multiple of 8.
      kv_num_blocks: pool capacity (paged only); ``None`` sizes it to full
        dense capacity, ``num_slots × ceil(max_seq_len / block)``.
      prefix_sharing: copy-on-write prefix sharing (paged layout with
        chunked prefill; off otherwise).
      role: "both" (the unified loop), "prefill" (paged, chunked, plain:
        every request ends ``reason="handoff"`` with its KV payload, and
        no decode segment is ever dispatched) or "decode" (paged: adopts
        ``Request.kv_handoff`` payloads, prefills the rest).
      device: where to run (default ``cuda``; raises if there is none).
    """

    def __init__(
        self,
        cfg: TransformerConfig,
        params: Mapping[str, Any],
        num_slots: int,
        *,
        steps_per_sync: int = 32,
        prefill_chunk: int = 512,
        stop_tokens: Sequence[int] | None = None,
        pad_token: int = 0,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        generator: torch.Generator | None = None,
        pipeline_depth: int = 2,
        cache_layout: str = "dense",
        kv_block_size: int = 128,
        kv_num_blocks: int | None = None,
        max_queue: int | None = None,
        degrade_queue: int | None = None,
        degrade_max_new: int = 32,
        decode_mode: str = "plain",
        draft_cfg: TransformerConfig | None = None,
        draft_params: Mapping[str, Any] | None = None,
        num_draft: int | str = "adaptive",
        spec_ladder: Sequence[int] = (2, 4, 8),
        chunked_prefill: bool = True,
        prefix_sharing: bool = True,
        role: str = "both",
        preempt: str = "degrade",
        device=None,
    ) -> None:
        device = resolve_device(device)
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_queue is not None and max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        if degrade_queue is None and max_queue is not None:
            degrade_queue = max(1, max_queue // 2)
        if degrade_queue is not None and degrade_queue < 0:
            raise ValueError(
                f"degrade_queue must be >= 0, got {degrade_queue}")
        if degrade_max_new < 1:
            raise ValueError(
                f"degrade_max_new must be >= 1, got {degrade_max_new}")
        if steps_per_sync < 1:
            raise ValueError(
                f"steps_per_sync must be >= 1, got {steps_per_sync}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if cache_layout not in ("dense", "paged"):
            raise ValueError(f"cache_layout must be 'dense' or 'paged', got "
                             f"{cache_layout!r}")
        if cache_layout == "paged" and cfg.attention_window is not None:
            raise ValueError(
                "cache_layout='paged' has no sliding-window trim yet; "
                "serve windowed models with the dense layout")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be 'both', 'prefill', or 'decode', "
                             f"got {role!r}")
        if role == "prefill" and not (cache_layout == "paged"
                                      and chunked_prefill
                                      and decode_mode == "plain"):
            raise ValueError(
                "role='prefill' needs cache_layout='paged' with chunked "
                "prefill under plain decode: the handoff exports pool "
                "pages at the chunked-admission finish")
        if role == "decode" and cache_layout != "paged":
            raise ValueError(
                "role='decode' needs cache_layout='paged': handoff "
                "adoption scatters migrated pages into the block pool")
        if preempt not in ("degrade", "migrate"):
            raise ValueError(f"preempt must be 'degrade' or 'migrate', got "
                             f"{preempt!r}")
        if preempt == "migrate" and cache_layout != "paged":
            raise ValueError(
                "preempt='migrate' needs cache_layout='paged': "
                "preemption exports the victim slot's pool pages")
        if decode_mode not in ("plain", "speculative"):
            raise ValueError(f"decode_mode must be 'plain' or 'speculative', "
                             f"got {decode_mode!r}")
        self.decode_mode = decode_mode
        self.role = role
        self.preempt = preempt
        self._spec_ladder: tuple[int, ...] = ()
        self._k_max = 0
        if decode_mode == "speculative":
            if draft_cfg is None or draft_params is None:
                raise ValueError(
                    "decode_mode='speculative' needs draft_cfg and "
                    "draft_params")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target "
                    f"vocab {cfg.vocab_size}")
            if draft_cfg.max_seq_len < cfg.max_seq_len:
                raise ValueError(
                    f"draft max_seq_len {draft_cfg.max_seq_len} < target "
                    f"{cfg.max_seq_len}: the draft cache mirrors each "
                    "lane's position, so it needs the same coverage")
            if isinstance(num_draft, int):
                if num_draft < 1:
                    raise ValueError(
                        f"num_draft must be >= 1, got {num_draft}")
                self._spec_ladder = (int(num_draft),)
            elif num_draft == "adaptive":
                self._spec_ladder = tuple(sorted(
                    int(x) for x in spec_ladder))
                if not self._spec_ladder or self._spec_ladder[0] < 1:
                    raise ValueError(
                        f"spec_ladder must hold K >= 1, got {spec_ladder}")
            else:
                raise ValueError(
                    f"num_draft must be an int or 'adaptive', got "
                    f"{num_draft!r}")
            self._k_max = self._spec_ladder[-1]
        if cfg.attention_window is not None:
            warnings.warn(
                "ServeLoop with a sliding-window model uses DENSE per-row "
                "attention (the per-row flash kernel has no window trim): "
                "every decode step reads the whole cache", stacklevel=2)
        # side-buffer mode (no window): steps write a segment-local buffer
        # at a scalar index and one merge per segment scatters side -> main;
        # a speculative segment's last round can write a whole K+1 verify
        # chunk past the steps_per_sync - 1 tokens already kept
        self.side = (steps_per_sync + self._k_max
                     if cfg.attention_window is None else 0)
        if self.side > cfg.max_seq_len:
            raise ValueError(
                f"the side buffer (steps_per_sync {steps_per_sync} + "
                f"num_draft {self._k_max} = {self.side}) exceeds "
                f"max_seq_len {cfg.max_seq_len}")
        paged = cache_layout == "paged"
        block = nb = 0
        self.pool = None
        if paged:
            block = int(kv_block_size)
            nb = (num_slots * -(-cfg.max_seq_len // block)
                  if kv_num_blocks is None else int(kv_num_blocks))
            # the host half: free list, per-slot block lists, and the page
            # table each segment stamps into the cache
            self.pool = BlockPool(nb, block, num_slots, cfg.max_seq_len)
        self.kv_block_size = block
        self.kv_num_blocks = nb
        self.cache_layout = cache_layout
        # paged: one block past the allocator's range is the merge's sink
        # for side slots that must not land (frozen lanes, dead table
        # entries), so the merge needs no host read of which ones do
        self._cfg_in = cfg
        self.model = build_model(cfg, params, device=device,
                                 serve_side_slots=self.side,
                                 cache_layout=cache_layout,
                                 kv_block_size=block,
                                 kv_num_blocks=nb + 1 if paged else 0)
        self.cfg = self.model.cfg
        self.device = self.model.device
        self.B = num_slots
        self.steps = steps_per_sync
        # emit columns a segment returns past the deferred-first column
        self._emit_width = steps_per_sync + self._k_max
        self.pipeline_depth = int(pipeline_depth)
        self.prefill_chunk = prefill_chunk
        self.pad_token = int(pad_token)
        # the speculative admission prefills the draft in the same one-shot
        # pass, so chunked prefill is plain decode's only
        self.chunked = bool(chunked_prefill) and decode_mode == "plain"
        # prefix sharing needs the pool (shared blocks live there) and the
        # chunked admission (a hit starts its worklist past the prefix)
        self._prefix_cache = (PrefixCache(self.pool)
                              if prefix_sharing and self.chunked and paged
                              else None)
        # the host-RAM spill tier under the prefix cache: its evictions
        # land there instead of vanishing (TPUDIST_KV_HOST_TIER_BYTES,
        # 0 disables); copies to and from it run on a side stream
        self._tier: HostTier | None = None
        self._tier_stream = None
        self.tier_stats = {"readmit_seconds": 0.0, "readmit_blocks": 0,
                           "saved_prefill_tokens": 0}
        if self._prefix_cache is not None:
            budget = tier_budget_from_env()
            if budget > 0:
                self._tier = HostTier(budget)
                self._prefix_cache.spill_hook = self._spill_block
                if self.pool is not None and self.model.device.type == "cuda":
                    self._tier_stream = torch.cuda.Stream(self.model.device)
        # recently admitted Request.prefix_hash values, LRU-bounded
        self._affinity_recent: dict[int, None] = {}
        # prompt_tokens: every admitted prompt position; prefill_tokens:
        # the positions actually recomputed (past a cached prefix)
        self.prefix_stats = {"requests": 0, "hits": 0, "hit_tokens": 0,
                             "prompt_tokens": 0, "prefill_tokens": 0}
        self.max_queue = None if max_queue is None else int(max_queue)
        self.degrade_queue = (None if degrade_queue is None
                              else int(degrade_queue))
        self.degrade_max_new = int(degrade_max_new)
        self._degraded = False
        self._stop = _stop_array(stop_tokens, self.device)
        self._stop_set = (set(self._stop.tolist())
                          if self._stop is not None else set())
        self._select = _make_select(temperature, top_k, top_p)
        self._temperature = float(temperature)
        self._top_k, self._top_p = top_k, top_p
        self._generator = generator
        if generator is None and temperature > 0:
            self._generator = torch.Generator(self.device).manual_seed(0)
        # the slot cache: VECTOR index leaves (one position per slot), in
        # side mode the side buffers (the JAX loop's _with_side_buffers)
        # and, paged, the pools and page table instead of dense rows
        self.cache = _blank_cache(self.model, num_slots, per_row=True,
                                  side_slots=self.side, paged=paged)
        if decode_mode == "speculative":
            # the draft decodes DENSE per row without side buffers (its
            # cache is small by construction): [num_slots, Sd] rows
            self.draft_cfg = draft_cfg
            self.draft_model = build_model(draft_cfg, draft_params,
                                           device=device)
            self.draft_cache = _blank_cache(self.draft_model, num_slots,
                                            per_row=True)
            self._spec_policy = (AdaptiveDraftPolicy(self._spec_ladder)
                                 if num_draft == "adaptive" else None)
            # per-K dispatch counts: each K's first dispatch stays out of
            # the measured cost model (as tpudist's, which holds a compile)
            self._spec_uses: dict[int, int] = {}
        dev = self.device
        self._tok = torch.full((num_slots,), self.pad_token,
                               dtype=torch.long, device=dev)
        self._active = torch.zeros((num_slots,), dtype=torch.bool,
                                   device=dev)
        self._remaining = torch.zeros((num_slots,), dtype=torch.long,
                                      device=dev)
        # deferred first-from-prefill tokens, one lane per slot: the next
        # segment's emits carry them home as column 0
        self._first = torch.full((num_slots,), self.pad_token,
                                 dtype=torch.long, device=dev)
        # EMA of measured seconds per generated token (feeds _plan_steps)
        self._step_ema: float | None = None
        self._clock = time.time
        self._pending_swap: dict | None = None
        # the version of the loaded weights: stamped into migration
        # payloads, checked at adoption (tpudist's default, 0)
        self.weights_version = 0
        # rid -> parked lane ({"req", "payload"}), whole in host RAM
        self._parked: dict[Any, dict] = {}
        # router-side migration intents, consumed by the run loop
        self._migrate_rids: set[str] = set()
        self._evacuate = False
        self.stats = ServeStats()
        self._init_obs()
        # lifetime tokens drained to the host: the trip point of the
        # TPUDIST_FAULT_NAN_AFTER_TOKENS injection
        self._served_tokens = 0
        # depth >= 2 on a card: the side stream of the emits' copies, the
        # pinned emits buffers (one per segment in flight, each with the
        # event of its copy) and the pinned early-exit flags (one a tick)
        self._copy_stream = None
        self._ring: list[dict] = []
        self._flags: list[tuple[torch.Tensor, Any]] = []
        self.pinned_reuse_waits = 0   # a ring buffer reused before its copy
        self.segment_host_reads = 0   # per-tick early-exit host reads
        self.spec_host_reads = 0      # a speculative segment's per-round reads

    def _init_obs(self) -> None:
        """tpudist's ``serve/*`` metrics, same names and units, in the
        process-global registry (host values only)."""
        self._obs_requests = obs.counter("serve/requests", unit="reqs")
        self._obs_tokens = obs.counter("serve/tokens", unit="tokens")
        self._obs_prompt_tokens = obs.counter("serve/prompt_tokens",
                                              unit="tokens")
        self._obs_prefill_tokens = obs.counter("serve/prefill_tokens",
                                               unit="tokens")
        self._obs_rejected = obs.counter("serve/rejected", unit="reqs")
        self._obs_timeouts = obs.counter("serve/timeouts", unit="reqs")
        self._obs_corrupt = obs.counter("serve/corrupt_segments",
                                        unit="segments")
        self._obs_segments = obs.counter("serve/segments", unit="segments")
        self._obs_queue = obs.gauge("serve/queue_depth", unit="reqs")
        self._obs_degraded = obs.gauge("serve/degraded", unit="bool")
        self._obs_degrade_clamped = obs.counter("serve/degrade_clamped",
                                                unit="reqs")
        self._obs_latency = obs.histogram("serve/request_latency", unit="s")
        # enqueue -> admit, sliding-window so the router's SLO gate reads
        # the last minute; <= 0 disables the window
        wait_window = float(
            os.environ.get("TPUDIST_SERVE_WAIT_WINDOW_S", "60"))
        self._obs_queue_wait = obs.histogram(
            "serve/queue_wait_s", unit="s",
            window_s=wait_window if wait_window > 0 else None)
        self._obs_host_wait = obs.histogram("serve/host_wait", unit="s")
        self._obs_depth = obs.gauge("serve/pipeline_depth", unit="segments")
        self._obs_swaps = obs.counter("serve/swaps", unit="swaps")
        self._obs_weights_version = obs.gauge("serve/weights_version",
                                              unit="version")
        self._obs_dispatches = obs.counter("serve/dispatches",
                                           unit="dispatches")
        self._obs_steps_per_dispatch = obs.gauge("serve/steps_per_dispatch",
                                                 unit="tokens")
        self._obs_spec_k = obs.gauge("serve/spec_k", unit="tokens")
        self._obs_spec_accept = obs.gauge("serve/spec_accept_rate",
                                          unit="ratio")
        self._obs_spt = obs.gauge(
            "serve/seconds_per_token", unit="s",
            help="EMA of realized seconds per generated token "
                 "(dispatch->drain wall / tokens; the replica's "
                 "service rate)")
        self._obs_adoptions = obs.counter("serve/adoptions", unit="reqs")
        self._obs_handoff_fallbacks = obs.counter(
            "serve/handoff_fallbacks", unit="reqs")
        self._obs_preempted = obs.counter("serve/preempted", unit="reqs")
        self._obs_resumed = obs.counter("serve/resumed", unit="reqs")
        self._obs_migrated_out = obs.counter("serve/migrated_out",
                                             unit="reqs")

    @property
    def params(self) -> dict:
        """The served weights as the port's state_dict (what a fleet
        snapshot restores into)."""
        return self.model.state_dict()

    @params.setter
    def params(self, tree) -> None:
        """Load a state_dict or a flax tree (converted) into the model."""
        _, sd = serving_layout(self._cfg_in, tree)
        self.model.load_state_dict(sd)

    # -- device work ---------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # the early exit at depth >= 2 reads the flag of the tick this many
    # before: the host runs ahead of the card by about a tick, so that
    # flag has usually landed, and a late one only costs an idle tick
    _EXIT_LAG = 2

    def _exit_flag(self, i: int, active: torch.Tensor):
        """Tick ``i``'s copy of ``active.any()``: a pinned flag written by
        a non-blocking copy on the compute stream, with the event that
        says it landed (on the CPU the value itself, at once)."""
        anyone = active.any()
        if self.device.type != "cuda":
            return anyone, None
        while len(self._flags) <= i:
            self._flags.append((torch.empty((), dtype=torch.bool,
                                            pin_memory=True),
                                torch.cuda.Event()))
        flag, ev = self._flags[i]
        flag.copy_(anyone, non_blocking=True)
        ev.record()
        return flag, ev

    @torch.no_grad()
    def _segment(self, n_steps: int, poison: bool = False):
        """One multi-token segment: up to ``n_steps`` decode ticks, leaving
        early once every lane is frozen (at depth 1 by a host read of
        ``active.any()`` each tick; deeper, by a lagged pinned flag, see
        the module docstring).  Returns the ``[B, 1 + steps]`` emits
        (column 0 carries the admission-deferred first tokens, columns
        past the ticks run are pad) and the per-lane ``corrupt`` flags of
        the in-graph NaN/inf guard.  ``poison`` (the fault harness's
        ``NAN_AFTER_TOKENS``) NaN-floods every tick's logits."""
        stop_arr = self._stop
        pad = self.pad_token
        S = self.cfg.max_seq_len
        dev = self.device
        cache, tok = self.cache, self._tok
        active, remaining = self._active, self._remaining
        lived = torch.zeros((self.B,), dtype=torch.long, device=dev)
        corrupt = torch.zeros((self.B,), dtype=torch.bool, device=dev)
        E = torch.full((self.B, self.steps), pad, dtype=torch.long,
                       device=dev)
        lag = None if self.pipeline_depth == 1 else self._EXIT_LAG
        flags = []
        for i in range(n_steps):
            if lag is None:
                self.segment_host_reads += 1
                if not bool(active.any()):   # the one host sync of a tick
                    break
            elif i >= lag:
                flag, ev = flags[i - lag]
                if (ev is None or ev.query()) and not bool(flag):
                    break
            self.stats.ticks += 1
            main_idx, side_idx = _index_leaves(cache)
            pos = main_idx if side_idx is None else main_idx + side_idx
            pos = pos.clamp(max=S - 1)
            # a row active at step ENTRY writes a real token's K/V this
            # step — the merge later scatters exactly these side slots
            lived = lived + active.long()
            logits, cache = self.model(tok[:, None], positions=pos[:, None],
                                       cache=cache)
            last = logits[:, -1]
            if poison:
                last = torch.full_like(last, float("nan"))
            # integrity guard: freeze (not emit) lanes whose logits are no
            # longer finite
            bad = active & ~torch.isfinite(last).all(dim=-1)
            corrupt = corrupt | bad
            active = active & ~bad
            nxt = self._select(last, self._generator)
            E[:, i] = torch.where(active, nxt, pad)
            remaining = remaining - active.long()
            hit_stop = (torch.isin(nxt, stop_arr) if stop_arr is not None
                        else torch.zeros_like(active))
            active = active & ~hit_stop & (remaining > 0)
            tok = torch.where(active, nxt, pad)
            if lag is not None:
                flags.append(self._exit_flag(i, active))
        if self.side:
            self._merge(cache, lived)
        self._tok, self._active, self._remaining = tok, active, remaining
        return torch.cat([self._first[:, None], E], dim=1), corrupt

    @torch.no_grad()
    def _segment_spec(self, n_steps: int, k: int):
        """The speculative segment: rounds of K+1 draft steps and one
        K+1-token target verify chunk until at least ``n_steps`` tokens
        are emitted or every lane is frozen (tpudist's
        ``_segment_spec_impl``, round for round).

        * Frozen lanes count as all-accept in :func:`_accept_and_next`, so
          they never drag the batch-min ``m`` down; their emits are pad
          and the ``lived``-masked merge drops their side writes.
        * Both caches roll back by ``K - m`` after the verify (the side
          counter in the sided and paged layouts, the per-row
          ``cache_index`` without side buffers; the draft's per-row
          ``cache_index``), so resident K/V tracks the emitted tokens.
        * A lane that stops or runs out of budget mid-round contributes
          ``min(stop_pos + 1, remaining)`` real tokens and freezes.

        Each round begins with ONE host read, of ``com`` (tokens emitted
        so far), ``any(active)`` and the two acceptance tallies.  Returns
        the ``[B, 1 + steps + K_max]`` emits (column 0 the deferred first
        tokens), the per-lane ``corrupt`` flags (always clear: this path,
        as tpudist's, has no in-graph guard; the drain's range check
        stands in) and the host stats ``(emitted, rounds, accepted,
        active_row_rounds)``."""
        stop_arr = self._stop
        pad = self.pad_token
        S = self.cfg.max_seq_len
        Sd = self.draft_cfg.max_seq_len
        dev = self.device
        B, width = self.B, self._emit_width
        gen, temp = self._generator, self._temperature
        top_k, top_p = self._top_k, self._top_p
        cache, d_cache = self.cache, self.draft_cache
        tok, active, remaining = self._tok, self._active, self._remaining
        # one sink column past the window takes the columns past m
        E = torch.full((B, width + 1), pad, dtype=torch.long, device=dev)
        t_idx = torch.arange(k + 1, device=dev)
        zero = torch.zeros((), dtype=torch.long, device=dev)
        com, acc_sum, act_rounds = zero, zero, zero
        lived = torch.zeros((B,), dtype=torch.long, device=dev)
        index_name = "side_index" if self.side else "cache_index"
        rounds = 0
        while True:
            self.spec_host_reads += 1
            emitted, live, acc, act = torch.stack(
                [com, active.any().long(), acc_sum, act_rounds]).tolist()
            if emitted >= n_steps or not live:
                break
            main_idx, side_idx = _index_leaves(cache)
            n_pos = (main_idx if side_idx is None
                     else main_idx + side_idx).long()
            # DRAFT: K proposals with their distributions; a (K+1)-th step
            # writes d_K's K/V for the all-accepted case
            d_tok, drafts, qs = tok, [], []
            for j in range(k + 1):
                d_idx = d_cache[0]["cache_index"].long()
                logits, d_cache = self.draft_model(
                    d_tok[:, None], positions=d_idx.clamp(max=Sd - 1)[:, None],
                    cache=d_cache)
                if j == k:
                    break
                last = logits[:, -1]
                qs.append(_filtered_probs(last, temp, top_k, top_p))
                d_tok = self._select(last, gen)
                drafts.append(d_tok)
            drafts = torch.stack(drafts, dim=1)                  # [B, K]
            q = torch.stack(qs, dim=1)                           # [B, K, V]
            # VERIFY: one target chunk over [tok, d_1..d_K] per lane
            verify = torch.cat([tok[:, None], drafts], dim=1)
            positions = (n_pos[:, None] + t_idx[None, :]).clamp(max=S - 1)
            t_logits, cache = self.model(verify, positions=positions,
                                         cache=cache)
            p = _filtered_probs(t_logits, temp, top_k, top_p)
            m, emit, accepted = _accept_and_next(p, q, drafts, gen,
                                                 active=active)
            shift = (k - m).to(torch.int32)
            for layer in cache:
                layer[index_name] = layer[index_name] - shift
            for layer in d_cache:
                layer["cache_index"] = layer["cache_index"] - shift
            # the round's window: accepted drafts, the verify token at m
            e_buf = torch.cat([drafts, emit[:, None]], dim=1)
            e_buf = e_buf.scatter(1, m.view(1, 1).expand(B, 1),
                                  emit[:, None])
            upto = t_idx <= m                                    # [K+1]
            if stop_arr is not None:
                hit = torch.isin(e_buf, stop_arr) & upto[None, :]
                stop_pos = torch.where(hit, t_idx[None, :],
                                       m + 1).amin(dim=1)        # [B]
            else:
                stop_pos = (m + 1).expand(B)
            # REAL tokens this round: what the drain will consume, up to
            # the stop (inclusive), the budget and the batch-min window
            real = torch.where(
                active, torch.minimum(torch.minimum(stop_pos + 1, remaining),
                                      m + 1), 0)
            lived = lived + real
            remaining = remaining - real
            cols = torch.where(upto, com + t_idx, width)
            E[:, cols] = torch.where(active[:, None], e_buf, pad)
            acc_sum = acc_sum + torch.where(active, accepted, 0).sum()
            act_rounds = act_rounds + active.long().sum()
            active = active & (stop_pos >= m + 1) & (remaining > 0)
            tok = torch.where(active, emit, pad)
            com = com + m + 1
            rounds += 1
        if self.side:
            self._merge(cache, lived)
        self.cache, self.draft_cache = cache, d_cache
        self._tok, self._active, self._remaining = tok, active, remaining
        emits = torch.cat([self._first[:, None], E[:, :width]], dim=1)
        corrupt = torch.zeros((B,), dtype=torch.bool, device=dev)
        return emits, corrupt, (emitted, rounds, acc, act)

    def _merge(self, cache: list[dict], lived: torch.Tensor) -> None:
        """End of segment: write each layer's side buffer into the main
        cache at every row's own offset, advance the per-row lengths by
        ``lived`` (the row's real side tokens — a frozen row's garbage
        side writes never land), reset the side counter.  Near the cache
        end the ``cap``-wide write window shifts below ``idx[r]`` and the
        side row is re-aligned so live token ``t`` still lands at
        ``idx[r] + t``."""
        if self.pool is not None:
            return self._merge_paged(cache, lived)
        S = self.cfg.max_seq_len
        cap = self.side
        p = torch.arange(cap, device=self.device)
        for layer in cache:
            idx = layer["cache_index"].long()
            start = idx.clamp(max=S - cap)
            src = p[None, :] - (idx - start)[:, None]              # [B, cap]
            live = ((src >= 0) & (src < lived[:, None]))[..., None]
            tgt = (start[:, None] + p[None, :])[..., None]
            gidx = src.clamp(0, cap - 1)[..., None]
            for name, side_name in (("cached_key", "side_key"),
                                    ("cached_value", "side_value")):
                main, side = layer[name], layer[side_name]
                shape = (self.B, cap, main.shape[2])
                cur = main.gather(1, tgt.expand(shape))
                shifted = side.gather(1, gidx.expand(shape)).to(main.dtype)
                main.scatter_(1, tgt.expand(shape),
                              torch.where(live, shifted, cur))
            layer["cache_index"] = (idx + lived).clamp(max=S).to(torch.int32)
            layer["side_index"] = torch.zeros_like(layer["side_index"])

    def _merge_paged(self, cache: list[dict], lived: torch.Tensor) -> None:
        """End of segment, paged: row ``r``'s live side token ``t`` lands
        at logical position ``idx[r] + t``, i.e. pool block
        ``table[r, pos // block]`` row ``pos % block``.  Entries that must
        not land (``t >= lived[r]`` or ``pos >= max_seq_len``: a frozen
        row's garbage side slots, a dead table entry naming another
        owner's block) are sent to the pool's sink block past the
        allocator's range instead — the JAX merge drops them through an
        out-of-range index, which an ``index_put_`` would not — so the
        merge reads nothing back on the host."""
        S = self.cfg.max_seq_len
        bs = self.kv_block_size
        first = cache[0]
        idx = first["cache_index"].long()                   # [B]
        tbl = first["page_table"]                           # [B, M]
        t = torch.arange(self.side, device=self.device)[None, :]
        pos = idx[:, None] + t                              # [B, cap]
        live = (t < lived[:, None]) & (pos < S)
        col = (pos // bs).clamp(max=tbl.shape[1] - 1)
        page = torch.where(live, tbl.gather(1, col).long(),
                           self.pool.num_blocks)
        off = torch.where(live, pos % bs, 0)
        for layer in cache:
            for name, side_name in (("paged_key", "side_key"),
                                    ("paged_value", "side_value")):
                pool = layer[name]
                pool[page, off] = layer[side_name].to(pool.dtype)
            layer["cache_index"] = (idx + lived).clamp(max=S).to(torch.int32)
            layer["side_index"] = torch.zeros_like(layer["side_index"])

    def _stamp_table(self) -> None:
        """Push the host allocator's page table into the cache: one
        non-blocking copy from a pinned snapshot (a pageable one would
        make the host wait for the card), shared by every layer (nothing
        writes a layer's table in place between stamps but the insert,
        which writes them all alike)."""
        tbl = torch.from_numpy(self.pool.table)
        if self.device.type == "cuda":
            tbl = tbl.pin_memory().to(self.device, non_blocking=True)
        else:
            tbl = tbl.clone()
        for layer in self.cache:
            layer["page_table"] = tbl

    def _pad_prompt(self, prompt: np.ndarray):
        """Right-pad to a chunk multiple CAPPED at the cache size (an
        uncapped pad past max_seq_len would clamp the final chunk's write
        backwards onto real prompt positions)."""
        L = int(prompt.size)
        chunk = min(self.prefill_chunk, self.cfg.max_seq_len)
        Lp = min(-(-L // chunk) * chunk, self.cfg.max_seq_len)
        padded = np.full((1, Lp), self.pad_token, np.int64)
        padded[0, :L] = prompt
        return padded, chunk

    def _insert(self, cache1: list[dict], slot: int, true_len: int,
                pages: np.ndarray | None = None, write_block: int = 0) -> None:
        """Copy the prefilled batch-1 cache into slot ``slot`` and stamp its
        true length (side buffers are left alone: side_index is 0 between
        segments).  Paged: the dense ``[S, F]`` row is cut into blocks and
        written into the slot's pages ``pages`` — only blocks under the
        prompt and at or past ``write_block`` (shared prefix blocks are
        read in place, never rewritten), selected on the host so no other
        owner's block can be hit."""
        if self.pool is None:
            _insert_dense(self.cache, cache1, slot, true_len)
            return
        bs = self.kv_block_size
        m = pages.shape[0]
        sel = [j for j in range(m) if j * bs < true_len and j >= write_block]
        dst = torch.as_tensor(pages[sel], dtype=torch.long,
                              device=self.device)
        src = torch.as_tensor(sel, dtype=torch.long, device=self.device)
        row_pages = torch.as_tensor(pages, dtype=torch.int32,
                                    device=self.device)
        for big, small in zip(self.cache, cache1):
            for name, dname in (("paged_key", "cached_key"),
                                ("paged_value", "cached_value")):
                row = small[dname][0]                        # dense [S, F]
                blocks = torch.nn.functional.pad(
                    row, (0, 0, 0, m * bs - row.shape[0])).view(m, bs, -1)
                big[name][dst] = blocks[src].to(big[name].dtype)
            big["page_table"][slot] = row_pages
            big["cache_index"][slot] = true_len

    def _gather_prefix(self, pages: np.ndarray) -> list[dict]:
        """A fresh dense batch-1 prefill cache whose rows hold the slot's
        pool blocks ``pages`` (its full page row) in logical order: the
        shared prefix's K/V exactly as the admission that registered it
        wrote them (rows past the prefix carry whatever the referenced
        blocks hold; suffix chunks overwrite them before any read)."""
        cache1 = _blank_cache(self.model, 1)
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        S = self.cfg.max_seq_len
        for big, small in zip(self.cache, cache1):
            for name, dname in (("paged_key", "cached_key"),
                                ("paged_value", "cached_value")):
                rows = big[name][idx].reshape(-1, big[name].shape[2])[:S]
                small[dname][0, :rows.shape[0]] = rows.to(small[dname].dtype)
        return cache1

    def _stamp_lane(self, slot: int, first: torch.Tensor,
                    max_new: int) -> None:
        """The lane stamps that finish an admission, on the device: the
        first token feeds the next tick and waits in ``_first`` for the
        next segment's emits; the lane is active unless the budget is one
        token or the first token is a stop."""
        self._tok[slot] = first
        self._active[slot] = max_new > 1
        if self._stop is not None and max_new > 1:
            self._active[slot] = ~torch.isin(first, self._stop)
        self._remaining[slot] = max_new - 1
        self._first[slot] = first

    @torch.no_grad()
    def _admit_oneshot(self, prompt: np.ndarray, slot: int, max_new: int,
                       pages: np.ndarray | None) -> None:
        """One-shot admission: chunked prefill of the padded prompt into a
        fresh batch-1 cache, insertion into the slot (paged: into its
        ``pages``), lane stamps."""
        L = int(prompt.size)
        padded, chunk = self._pad_prompt(prompt)
        cache1 = _blank_cache(self.model, 1)
        cache1, logits = _prefill(
            self.model, cache1, torch.as_tensor(padded, device=self.device),
            chunk)
        _set_cache_index(cache1, L)
        last = logits[0, L - 1 - (padded.shape[1] - logits.shape[1])]
        first = self._select(last[None, :], self._generator)[0]
        self._insert(cache1, slot, L, pages)
        if self.decode_mode == "speculative":
            self._draft_prefill(padded, chunk, slot, L)
        self._stamp_lane(slot, first, max_new)

    @torch.no_grad()
    def _draft_prefill(self, padded: np.ndarray, chunk: int, slot: int,
                       true_len: int) -> None:
        """The draft's half of a speculative admission: prefill the same
        padded prompt (K1) into a batch-1 draft cache and insert it into
        the draft cache's row ``slot``."""
        d1 = _blank_cache(self.draft_model, 1)
        d1, _ = _prefill(self.draft_model, d1,
                         torch.as_tensor(padded, device=self.device), chunk)
        _insert_dense(self.draft_cache, d1, slot, true_len)

    @torch.no_grad()
    def _prefill_chunk(self, cache1: list[dict], toks: np.ndarray,
                       off: int):
        """ONE prompt chunk through the scalar-index prefill path, write
        cursor forced to ``off`` — the same chunk grid as the one-shot
        path, so chunking changes when prefill work runs, never its
        result."""
        _set_cache_index(cache1, off)
        pos = off + torch.arange(toks.shape[1], device=self.device)[None, :]
        logits, cache1 = self.model(torch.as_tensor(toks, device=self.device),
                                    positions=pos, cache=cache1)
        return cache1, logits

    @torch.no_grad()
    def _admit_finish(self, pf: dict, slot: int) -> None:
        """The tail of a chunked admission: insert the prefilled batch-1
        cache (paged: skipping shared blocks below ``write_block``), select
        the first token from the last chunk's logits (position ``L - 1`` is
        row ``L - 1 - off`` of that chunk), stamp the lane."""
        cache1 = _set_cache_index(pf["cache1"], pf["L"])
        self._insert(cache1, slot, pf["L"], pf["pages"], pf["write_block"])
        last = pf["logits"][0, pf["L"] - 1 - pf["off_last"]]
        first = self._select(last[None, :], self._generator)[0]
        self._stamp_lane(slot, first, pf["max_new"])

    # -- the host loop -------------------------------------------------------

    def _validate(self, req: Request) -> None:
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError("request prompt must be a non-empty 1-D "
                             "token array")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(
                f"request prompt must be integer token ids, got dtype "
                f"{prompt.dtype}")
        if req.max_new_tokens < 1:
            raise ValueError("request max_new_tokens must be >= 1")
        if prompt.size + req.max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"request needs {prompt.size + req.max_new_tokens} cache "
                f"slots > max_seq_len {self.cfg.max_seq_len}")
        if (self.decode_mode == "speculative"
                and prompt.size + req.max_new_tokens + self._k_max - 1
                > self.cfg.max_seq_len):
            raise ValueError(
                f"speculative serving needs prompt + max_new + "
                f"num_draft - 1 <= max_seq_len "
                f"({prompt.size + req.max_new_tokens + self._k_max - 1} "
                f"> {self.cfg.max_seq_len}): the verify chunk writes up "
                "to num_draft slots past the last emitted token")
        if self.pool is not None:
            need = self.pool.request_blocks(prompt.size, req.max_new_tokens)
            if need > self.pool.num_blocks:
                raise ValueError(
                    f"request reserves {need} KV blocks > pool capacity "
                    f"{self.pool.num_blocks}; it could never be admitted "
                    "(raise kv_num_blocks or shrink the request)")

    def _prefix_plan(self, prompt: np.ndarray,
                     L: int) -> tuple[list[int], int, bool]:
        """Match ``prompt`` against the prefix cache: ``(shared_blocks,
        suffix_start, cow)``.  ``suffix_start`` is the first position
        prefill must compute; a FULL-prompt hit still recomputes position
        ``L - 1`` (the first output logit has to come from somewhere), a
        write into the last shared block — the ``cow`` split.  With a host
        tier the chain walk continues past the pool-resident run: spilled
        blocks extending the match are re-admitted into freshly pinned
        cached pages and shared like blocks that never left."""
        blocks = self._prefix_cache.match(prompt)
        if self._tier is not None and len(self._tier):
            chain = chain_hashes(prompt, self.kv_block_size)
            blocks = blocks + self._readmit_tiered(chain, len(blocks))
        if not blocks:
            return [], 0, False
        matched = len(blocks) * self.kv_block_size
        if matched >= L:
            return blocks, L - 1, True
        return blocks, matched, False

    def prefix_summary(self, limit: int = 64) -> list[int]:
        """The most recently admitted ``Request.prefix_hash`` values while
        prefix sharing is on (a router's affinity key); empty when it is
        off."""
        return list(self._affinity_recent)[-limit:]

    def flush_prefix_cache(self) -> None:
        """Drop every cached prefix: idle blocks return to the free list
        (the pool then drains to fully free once no slot is live), and
        every host-tier entry."""
        if self._prefix_cache is not None:
            self._prefix_cache.flush()
        if self._tier is not None:
            self._tier.flush()
        self._affinity_recent.clear()

    # -- the host-RAM tier (tpudist_torch.models.kv_tier) -----------------

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t``: pinned, and on the tier's side stream,
        when ``t`` lives on a card (the caller waits on the stream)."""
        if self._tier_stream is None:
            return t.detach().to("cpu", copy=True)
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        return out

    @torch.no_grad()
    def _page_blocks(self, blocks) -> list[list[dict]]:
        """Host copies of the pool blocks ``blocks``, one per block, each
        ``[{"k": [bs, F], "v": [bs, F]}]`` a layer.  On a card the copies
        run on the side stream after the work queued so far, and are
        complete on return (a spilled page is recycled next)."""
        side = self._tier_stream
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(self.device))
        with (torch.cuda.stream(side) if side is not None
              else contextlib.nullcontext()):
            out = [[{"k": self._to_host(node["paged_key"][blk]),
                     "v": self._to_host(node["paged_value"][blk])}
                    for node in self.cache] for blk in blocks]
        if side is not None:
            side.synchronize()
        return out

    def _spill_block(self, h: int, blk: int, parent: int | None) -> None:
        """PrefixCache spill hook: copy an evicted idle block's pages to
        the host tier before its pin (and page) drop; the block is
        refcount 0 and still pinned, so its bytes are stable."""
        self._tier.put(h, self._page_blocks([blk])[0], parent=parent,
                       version=self.weights_version)

    def _readmit_tiered(self, chain: list[int], start: int) -> list[int]:
        """Re-admit the longest run of tiered blocks extending a chain
        match at ``start``: take each entry (version-checked), land it in
        a freshly pinned cached page, and index it back into the prefix
        cache.  Allocation never evicts (paging one block in must not page
        another out), so when only reclaimable cached pages are left the
        walk stops and the rest re-prefills.  Returns the installed pool
        blocks in chain order."""
        t0 = time.perf_counter()
        taken: list[tuple[int, int | None, int, list]] = []
        j = start
        while j < len(chain):
            if not self._tier.has(chain[j], version=self.weights_version):
                break
            blk = self.pool.alloc_cached_block()
            if blk is None:
                break
            layers = self._tier.take(chain[j], version=self.weights_version)
            if layers is None:
                self.pool.cache_unpin(blk)
                break
            taken.append((chain[j], chain[j - 1] if j else None, blk,
                          layers))
            j += 1
        n = self._scatter_install(taken)
        if n:
            self.tier_stats["readmit_blocks"] += n
            self.tier_stats["readmit_seconds"] += time.perf_counter() - t0
        return [t[2] for t in taken]

    @torch.no_grad()
    def _scatter_install(self, taken: list[tuple[int, int | None, int,
                                                 list]]) -> int:
        """Write ``taken``'s block bytes (``(hash, parent, pool_block,
        layers)`` each) into their pages — on a card one host-to-device
        copy a layer and side on the tier's stream, which the serving
        stream then waits for — and index each block in the prefix
        cache after the write."""
        if not taken:
            return 0
        dev = self.device
        pages = torch.as_tensor([t[2] for t in taken], dtype=torch.long,
                                device=dev)
        side = self._tier_stream
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(dev))
        with (torch.cuda.stream(side) if side is not None
              else contextlib.nullcontext()):
            for li, node in enumerate(self.cache):
                for name, key in (("paged_key", "k"), ("paged_value", "v")):
                    parts = [_payload_tensor(t[3][li][key])
                             for t in taken]
                    src = torch.empty((len(parts), *parts[0].shape),
                                      dtype=parts[0].dtype,
                                      pin_memory=side is not None)
                    torch.stack(parts, out=src)
                    node[name][pages] = src.to(
                        dev, dtype=node[name].dtype,
                        non_blocking=side is not None)
        if side is not None:
            torch.cuda.current_stream(dev).wait_stream(side)
            side.synchronize()
        for h, parent, blk, _ in taken:
            self._prefix_cache.install(h, blk, parent)
        return len(taken)

    def prefix_residency(self, limit: int = 256) -> dict:
        """Resident prefix chain hashes for a fleet directory:
        ``{"chains": [...], "tiered": [...]}``, the prefix cache's entries
        and then the host tier's (``tiered`` the subset in the tier), most
        recently used last, at most ``limit``."""
        if self._prefix_cache is None:
            return {"chains": [], "tiered": []}
        hbm = list(self._prefix_cache._entries)
        tiered = self._tier.hashes() if self._tier is not None else []
        chains = (hbm + tiered)[-int(limit):]
        tset = set(tiered)
        return {"chains": chains,
                "tiered": [h for h in chains if h in tset]}

    def export_prefix(self, chain: Sequence[int]) -> dict | None:
        """The owner's half of a prefix pull: the longest leading run of
        ``chain`` resident here — pool pages read from the device, host
        tier entries read in place (peeked, not taken) — as a
        migration-style payload a peer installs with
        :meth:`install_prefix`; None when the first link is not
        resident."""
        if self._prefix_cache is None or self.pool is None:
            return None
        chain = [int(h) for h in chain]
        hbm_blocks: list[int] = []
        for h in chain:
            blk = self._prefix_cache._entries.get(h)
            if blk is None:
                break
            hbm_blocks.append(blk)
        tier_layers: list[list] = []
        if self._tier is not None:
            while len(hbm_blocks) + len(tier_layers) < len(chain):
                layers = self._tier.peek_layers(
                    chain[len(hbm_blocks) + len(tier_layers)],
                    version=self.weights_version)
                if layers is None:
                    break
                tier_layers.append(layers)
        n = len(hbm_blocks) + len(tier_layers)
        if not n:
            return None
        pool_layers = (self._gather_layers(hbm_blocks) if hbm_blocks
                       else None)
        layers_out = []
        for li in range(len(self.cache)):
            out = {}
            for key in ("k", "v"):
                parts = ([_payload_tensor(pool_layers[li][key])]
                         if pool_layers else [])
                parts += [_payload_tensor(tl[li][key])[None]
                          for tl in tier_layers]
                out[key] = _host_array(torch.cat(parts, dim=0))
            layers_out.append(out)
        return {"key": None, "rid": None, "prompt": [],
                "chain": chain[:n], "block_size": int(self.kv_block_size),
                "version": int(self.weights_version), "layers": layers_out}

    def install_prefix(self, prompt, payload: dict) -> int:
        """The requester's half of a prefix pull: verify ``payload``
        against ``prompt``'s own chain (block size, version, links, layer
        shapes) and install its blocks as cached idle pages, so the next
        admission of ``prompt`` shares them.  Returns the blocks
        installed (0 when a gate fails or nothing fits)."""
        if self._prefix_cache is None or self.pool is None:
            return 0
        try:
            bs = int(payload["block_size"])
            version = int(payload["version"])
            chain = [int(h) for h in payload["chain"]]
            layers = payload["layers"]
        except (KeyError, TypeError, ValueError):
            return 0
        want = chain_hashes(np.asarray(prompt, np.int64), self.kv_block_size)
        n = len(chain)
        if (bs != self.kv_block_size or version != self.weights_version
                or n == 0 or chain != want[:n]
                or len(layers) != len(self.cache)):
            return 0
        flat = self.cache[0]["paged_key"].shape[2]
        arrs = []
        for layer in layers:
            try:
                k = _payload_tensor(layer["k"])
                v = _payload_tensor(layer["v"])
            except (KeyError, TypeError, ValueError):
                return 0
            if k.dim() != 3 or tuple(k.shape) != (n, bs, flat) \
                    or v.shape != k.shape:
                return 0
            arrs.append((k, v))
        taken: list[tuple[int, int | None, int, list]] = []
        try:
            for j in range(n):
                if chain[j] in self._prefix_cache._entries:
                    continue   # the local copy wins (first-wins install)
                blk = self.pool.alloc_cached_block()
                if blk is None:
                    break
                taken.append((chain[j], want[j - 1] if j else None, blk,
                              [{"k": arrs[li][0][j], "v": arrs[li][1][j]}
                               for li in range(len(self.cache))]))
            installed = self._scatter_install(taken)
            if self._tier is not None:
                # a pulled link also spilled here is pool-resident now
                for h, _, _, _ in taken:
                    self._tier.discard(h)
            return installed
        except Exception:
            for _, _, blk, _ in taken:
                if blk not in self._prefix_cache._entries.values():
                    self.pool.cache_unpin(blk)
            raise

    def tier_drained(self) -> bool | None:
        """The tier's invariants (no hash both tiered and pool-resident)
        and whether it is empty; None without a tier."""
        if self._tier is None:
            return None
        resident = (self._prefix_cache._entries.keys()
                    if self._prefix_cache is not None else ())
        self._tier.check(resident)
        return len(self._tier) == 0

    def _admit(self, slot: int, req: Request) -> dict:
        """Admit ``req`` into ``slot``: the one-shot path dispatches the
        prefill and lane stamps now; the chunked path returns a slot state
        with a ``prefill`` worklist the run loop advances one chunk per
        iteration.  The first token stays on the device until the next
        segment's emits carry it home."""
        self._validate(req)
        prompt = np.asarray(req.prompt, np.int64)
        L = int(prompt.size)
        max_new = int(req.max_new_tokens)
        self.stats.prompt_tokens += L
        self._obs_prompt_tokens.inc(L)
        self.prefix_stats["requests"] += 1
        self.prefix_stats["prompt_tokens"] += L
        if req.prefix_hash is not None and self._prefix_cache is not None:
            self._affinity_recent.pop(int(req.prefix_hash), None)
            self._affinity_recent[int(req.prefix_hash)] = None
            while len(self._affinity_recent) > 128:
                self._affinity_recent.pop(next(iter(self._affinity_recent)))
        if (req.kv_handoff is not None and self.pool is not None
                and self.role != "prefill"):
            # adopt the migrated pages (no prefill) unless a gate fails;
            # then fall through to an ordinary admission of the prompt
            st = self._admit_adopt(slot, req, prompt, L)
            if st is not None:
                return st
            self.stats.handoff_fallbacks += 1
            self._obs_handoff_fallbacks.inc()
        if self.chunked:
            return self._admit_start(slot, req, prompt, L, max_new)
        self.prefix_stats["prefill_tokens"] += L
        self._obs_prefill_tokens.inc(L)
        pages = None
        if self.pool is not None:
            # allocate-on-admit: pages under the prompt now, the rest of
            # the worst-case footprint reserved (growth cannot fail)
            self.pool.admit(slot, L, max_new)
            pages = self.pool.table[slot].copy()
        t0 = time.perf_counter()
        self._admit_oneshot(prompt, slot, max_new, pages)
        if self.pipeline_depth == 1:
            # device-synchronized prefill time; deeper, the admission
            # must not wait for the segments in flight
            self._sync()
        self.stats.prefill_seconds += time.perf_counter() - t0
        return {"req": req, "tokens": [], "pending_first": True}

    def _admit_start(self, slot: int, req: Request, prompt: np.ndarray,
                     L: int, max_new: int) -> dict:
        """The host half of a chunked admission: pool admit — with cached
        prefix blocks ALIASED in and, on a full-prompt hit, the last one
        split copy-on-write (the finish insert rewrites the split block
        whole, which IS the copy) — the batch-1 prefill cache (gathered
        from the shared blocks on a hit), and the chunk worklist: the
        one-shot path's chunk grid, starting at the chunk that holds
        ``suffix_start`` (positions below it in that chunk are recomputed
        to identical bytes).  The prefix is registered only after the
        finish insert has written its blocks (``advance_admissions``)."""
        suffix_start = write_block = 0
        pages = None
        if self._prefix_cache is not None:
            blocks, suffix_start, cow = self._prefix_plan(prompt, L)
            self.pool.admit(slot, L, max_new, shared=blocks)
            if cow:
                self.pool.cow_write(slot, len(blocks) - 1)
            write_block = suffix_start // self.kv_block_size
            if blocks:
                self.prefix_stats["hits"] += 1
                self.prefix_stats["hit_tokens"] += (
                    len(blocks) * self.kv_block_size)
        elif self.pool is not None:
            self.pool.admit(slot, L, max_new)
        self.prefix_stats["prefill_tokens"] += L - suffix_start
        self._obs_prefill_tokens.inc(L - suffix_start)
        if self.pool is not None:
            pages = self.pool.table[slot].copy()
        cache1 = (self._gather_prefix(pages) if suffix_start
                  else _blank_cache(self.model, 1))
        padded, C = self._pad_prompt(prompt)
        Lp = padded.shape[1]
        chunks = [(off, min(C, Lp - off))
                  for off in range((suffix_start // C) * C, Lp, C)]
        return {"req": req, "tokens": [], "pending_first": True,
                "prefill": {"cache1": cache1, "padded": padded,
                            "chunks": chunks, "logits": None, "off_last": 0,
                            "L": L, "max_new": max_new, "pages": pages,
                            "write_block": write_block}}

    # -- KV handoff and migration ------------------------------------------

    def _gather_layers(self, pages) -> list[dict]:
        """The pool blocks ``pages`` of every layer, in tpudist's layer
        order, on the host (one sync)."""
        idx = torch.as_tensor(np.asarray(pages, np.int64),
                              device=self.device)
        return [{"k": _host_array(layer["paged_key"][idx]),
                 "v": _host_array(layer["paged_value"][idx])}
                for layer in self.cache]

    def _build_handoff(self, slot: int, req: Request, pf: dict) -> dict:
        """Export ``slot``'s finished prefill as a handoff payload (its
        pool pages and the sampled first token) and free the slot; the
        export freeze guarantees the pages read are this slot's."""
        manifest = self.pool.export_slot(slot)
        prompt = np.asarray(req.prompt, np.int32)
        payload = {
            "key": None,
            "rid": req.rid,
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(req.max_new_tokens),
            # the exporter's first token rides along: the adopter emits
            # it instead of re-running the prompt's last logit
            "first": int(self._first[slot]),
            "true_len": int(pf["L"]),
            "block_size": int(self.kv_block_size),
            "chain": chain_hashes(prompt, self.kv_block_size),
            "published_at": time.time(),
            "layers": self._gather_layers(manifest["blocks"]),
        }
        self.pool.complete_export(slot)
        return payload

    def _build_migration(self, slot: int, st: dict) -> dict:
        """Export an IN-FLIGHT decode lane as a migration payload and free
        the slot.  The caller has drained every segment in flight (the
        host token list is final, no merge can touch the pages) and frozen
        the lane.  ``generated`` carries every emitted token but the last,
        which travels as ``first`` (the adopter's deferred first token
        re-emits it); the pages cover prompt + generated; ``version``
        keeps a weight roll from mixing KV across versions."""
        req = st["req"]
        tokens = st["tokens"]
        prompt = np.asarray(req.prompt, np.int32)
        if st.get("pending_first") or not tokens:
            # the first token is still on the device (a fresh admission,
            # or an adoption whose seeded tokens ride ``generated``)
            first = int(self._first[slot])
            generated = [int(t) for t in tokens]
        else:
            first = int(tokens[-1])
            generated = [int(t) for t in tokens[:-1]]
        prompt_eff = (np.concatenate([prompt, np.asarray(generated,
                                                         np.int32)])
                      if generated else prompt)
        true_len = int(prompt.size) + len(generated)
        manifest = self.pool.export_slot(slot)
        # the pool grows lanes a segment ahead; the adopter allocates
        # exactly ceil(true_len / block), so only those pages go
        n_used = -(-true_len // self.kv_block_size)
        payload = {
            "key": None,
            "rid": req.rid,
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "first": first,
            "generated": generated,
            "true_len": true_len,
            "block_size": int(self.kv_block_size),
            "chain": chain_hashes(prompt_eff, self.kv_block_size),
            "published_at": time.time(),
            "version": int(self.weights_version),
            "layers": self._gather_layers(manifest["blocks"][:n_used]),
        }
        self.pool.complete_export(slot)
        return payload

    @torch.no_grad()
    def _admit_adopt(self, slot: int, req: Request, prompt: np.ndarray,
                     L: int) -> dict | None:
        """Admit ``req`` by ADOPTING its payload's pages into freshly
        allocated blocks and stamping the lane with the carried ``first``
        (no prefill).  ``None`` when a gate fails — structure, lengths,
        block size, hash chain, layer count and shape, weights version —
        and the caller prefills instead.  A mid-decode payload's
        ``generated`` tokens seed the slot's output and shrink its budget,
        so the completion carries the whole sequence."""
        payload = req.kv_handoff
        try:
            first = int(payload["first"])
            true_len = int(payload["true_len"])
            bs = int(payload["block_size"])
            chain = [int(h) for h in payload["chain"]]
            generated = [int(t) for t in payload.get("generated", ())]
            layers = payload["layers"]
        except (KeyError, TypeError, ValueError):
            return None
        if "version" in payload:
            # KV computed under one weights version never continues under
            # another: refuse and re-prefill under this loop's weights
            try:
                if int(payload["version"]) != self.weights_version:
                    return None
            except (TypeError, ValueError):
                return None
        prompt_eff = (np.concatenate([prompt, np.asarray(generated,
                                                         np.int32)])
                      if generated else prompt)
        L_eff = L + len(generated)
        max_new = int(req.max_new_tokens) - len(generated)
        if (true_len != L_eff or bs != self.kv_block_size or max_new < 1
                or chain != chain_hashes(prompt_eff, self.kv_block_size)
                or len(layers) != len(self.cache)):
            return None
        flat = self.cache[0]["paged_key"].shape[2]
        blocks = self.pool.adopt_blocks(slot, L_eff, max_new)
        kv = []
        for layer in layers:
            try:
                k = _payload_tensor(layer["k"])
                v = _payload_tensor(layer["v"])
            except (KeyError, TypeError, ValueError):
                k = v = None
            if (k is None or k.dim() != 3
                    or tuple(k.shape) != (len(blocks), bs, flat)
                    or v.shape != k.shape):
                # shape lies past the chain check: un-admit, and the
                # fallback prefill takes the slot instead
                self.pool.free_slot(slot)
                return None
            kv.append((k, v))
        dev = self.device
        pages = torch.as_tensor(blocks, dtype=torch.long, device=dev)
        row = torch.as_tensor(self.pool.table[slot], dtype=torch.int32,
                              device=dev)
        for node, (k, v) in zip(self.cache, kv):
            for name, t in (("paged_key", k), ("paged_value", v)):
                node[name][pages] = t.to(device=dev, dtype=node[name].dtype)
            node["page_table"][slot] = row
            node["cache_index"][slot] = L_eff
        if self.decode_mode == "speculative":
            padded, chunk = self._pad_prompt(prompt_eff)
            self._draft_prefill(padded, chunk, slot, L_eff)
        self._stamp_lane(slot, torch.tensor(first, device=dev), max_new)
        self.stats.adoptions += 1
        self._obs_adoptions.inc()
        obs.recorder.record("serve_adopt", slot=slot, prompt_len=L,
                            blocks=len(blocks), generated=len(generated))
        return {"req": req, "tokens": list(generated),
                "pending_first": True}

    def _fits(self, req: Request) -> bool:
        """Whether the pool can take ``req`` now: its full reservation,
        less the blocks a cached prefix lends it, plus the copy-on-write
        block a full-prompt hit draws."""
        L = int(np.asarray(req.prompt).size)
        if self._prefix_cache is None:
            return self.pool.can_admit(L, int(req.max_new_tokens))
        n_sh = self._prefix_cache.peek(req.prompt)
        cow = int(n_sh * self.kv_block_size >= L)
        return self.pool.can_admit(L, int(req.max_new_tokens), shared=n_sh,
                                   cow=cow)

    def _plan_steps(self, slot_state) -> int:
        """Per-dispatch segment length: ``steps_per_sync``, clamped against
        the tightest live deadline using the measured per-token EMA (so a
        timeout would be seen within about one token of expiry)."""
        if self._step_ema is None or self._step_ema <= 0:
            return self.steps
        deadlines = [st["req"].deadline_s for st in slot_state
                     if st is not None and not st.get("zombie")
                     and st["req"].deadline_s is not None]
        if not deadlines:
            return self.steps
        slack = min(deadlines) - self._clock()
        if slack <= self._step_ema:
            return 1
        return max(1, min(self.steps, int(slack / self._step_ema)))

    def request_swap(self, params_fn, *, version: int | None = None,
                     on_swapped=None) -> None:
        """Schedule a DRAIN-GATED weight hot-swap: admission pauses, every
        lane already decoding runs to completion on the OLD weights, every
        segment in flight drains, and only then is ``params_fn()`` called
        and its tree (a state_dict or a flax tree, converted) loaded into
        the model before admission resumes — no request straddles two
        weight versions.  ``params_fn`` returning ``None`` (a missing
        snapshot) keeps the old weights, but the swap still completes:
        ``on_swapped()`` fires either way.  ``version`` (when applied)
        becomes :attr:`weights_version`.  Callable between :meth:`run`
        calls or during one from the ``source``/``sink`` callbacks (the
        loop is single-threaded); the latest request wins."""
        self._pending_swap = {"fn": params_fn, "version": version,
                              "on_swapped": on_swapped}

    def request_migrate(self, rids) -> None:
        """Ask the loop to hand the named requests OUT at the next safe
        point (service mode): each leaves as a ``reason="migrate"``
        completion carrying its exported KV (a lane) or nothing (queued).
        Unknown rids are ignored: the request finished first."""
        self._migrate_rids.update(str(r) for r in rids)

    def request_evacuate(self) -> None:
        """Ask the loop to hand EVERYTHING out (queued, parked and in
        flight) at the next safe point (service mode; a drain); the flag
        clears after one pass."""
        self._evacuate = True

    def _spec_k(self, live: int) -> int:
        """The segment's draft length: the fixed ``num_draft``, or the
        adaptive policy's pick at the live-lane count (never 0: inside a
        speculative segment there is no plain round)."""
        if self._spec_policy is None:
            return self._spec_ladder[0]
        return int(self._spec_policy.best_k(batch=max(live, 1),
                                            allow_plain=False))

    def _apply_swap(self, swap: dict, seq: int) -> None:
        with obs.span("serve/swap", version=swap["version"]):
            tree = swap["fn"]()
            if tree is not None:
                self.params = tree
                self.stats.swaps += 1
                self._obs_swaps.inc()
                if swap["version"] is not None:
                    self._obs_weights_version.set(int(swap["version"]))
                    self.weights_version = int(swap["version"])
                # cached prefix KV was computed under the old weights; the
                # loop is drained, so every cached block returns to the pool
                self.flush_prefix_cache()
        obs.recorder.record("serve_swap", seq=seq, version=swap["version"],
                            applied=tree is not None)
        if swap["on_swapped"] is not None:
            swap["on_swapped"]()

    def _fetch_start(self, seq: int, emits: torch.Tensor,
                     corrupt: torch.Tensor):
        """Start the segment's emits on their way to the host.  On a card
        at depth >= 2: pinned buffer ``seq % depth`` of the ring receives
        non-blocking copies on the side stream, after an event on the
        compute stream; returns ``(buffers, event)``.  Otherwise the
        values themselves (a CUDA tensor's ``.cpu()`` waits for it)."""
        if self.device.type != "cuda" or self.pipeline_depth == 1:
            return (emits.cpu().numpy(), corrupt.cpu().numpy()), None
        slot = self._ring[seq % len(self._ring)]
        if slot["event"] is not None and not slot["event"].query():
            # the drain order makes this unreachable: the buffer's last
            # segment drained (its event waited on) before this dispatch
            self.pinned_reuse_waits += 1
            slot["event"].synchronize()
        side = self._copy_stream
        side.wait_event(torch.cuda.current_stream(self.device)
                        .record_event())
        with torch.cuda.stream(side):
            slot["emits"].copy_(emits, non_blocking=True)
            slot["corrupt"].copy_(corrupt, non_blocking=True)
            slot["event"] = side.record_event()
        # the sources were made on the compute stream and are read on the
        # side one: keep their memory out of reuse until the copies end
        emits.record_stream(side)
        corrupt.record_stream(side)
        return (slot["emits"], slot["corrupt"]), slot["event"]

    def _fetch_wait(self, fetched) -> tuple[np.ndarray, np.ndarray]:
        (emits, corrupt), event = fetched
        if event is None:
            return emits, corrupt
        event.synchronize()
        return emits.numpy().copy(), corrupt.numpy().copy()

    def _ready_ring(self) -> None:
        """The pinned emits buffers of a run at depth >= 2 on a card."""
        if self.device.type != "cuda" or self.pipeline_depth == 1:
            return
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        shape = (self.B, 1 + self._emit_width)
        while len(self._ring) < self.pipeline_depth:
            self._ring.append({
                "emits": torch.empty(shape, dtype=torch.long,
                                     pin_memory=True),
                "corrupt": torch.empty((self.B,), dtype=torch.bool,
                                       pin_memory=True),
                "event": None})
        del self._ring[self.pipeline_depth:]

    def run(self, requests: Sequence[Request] = (), *, source=None,
            sink=None, idle_wait_s: float = 0.005) -> list[Completion]:
        """Serve every request to completion; returns completions in
        FINISH order, each with its generated tokens.

        Up to ``pipeline_depth`` segments are in flight (see the module
        docstring); the drain applies the same stop/budget rules as the
        synchronous loop, so each request's greedy tokens are the same at
        any depth.

        SERVICE MODE — ``source`` / ``sink`` make the batch runner a
        long-lived replica loop:

        * ``source()`` is polled once per loop iteration and returns an
          iterable of new requests (``[]``: open but idle; the loop sleeps
          ``idle_wait_s`` when there is nothing to do), or ``None`` to
          CLOSE intake — the loop then drains everything and returns.
          Requests that fail validation there complete
          ``reason="invalid"`` instead of raising.
        * ``sink(completion)`` fires at every finalize, rejections and
          timeouts included; the full list is still returned.

        With segments in flight, a killed paged lane (deadline, corrupt
        token) cannot hand its blocks back at once: segments dispatched
        before the kill still carry its pre-kill mask and pages, and a
        recycled block would be written by their merge.  It is parked as
        a ZOMBIE (finalized for the caller, not admittable, blocks held)
        until the drain passes the kill point; segments dispatched after
        the kill see the lane frozen on the device.

        ``preempt="migrate"``, roles and migration intents are served
        here too: a prefill-role loop ends each request at its handoff;
        before any lane is exported (parked, migrated out) every segment
        in flight is drained, so the host token list is final and no
        merge can write the exported pages."""
        for req in requests:  # fail BEFORE any slot is touched, not mid-run
            self._validate(req)
        self._ready_ring()
        pending: deque[Request] = deque()
        slot_state: list[dict | None] = [None] * self.B
        done: list[Completion] = []
        # (seq, fetched emits, n_steps, K, speculative stats, t_dispatch)
        inflight: deque[tuple] = deque()
        seq = 0   # segments dispatched so far == index of the next one
        closed = source is None
        stats = self.stats
        synced = self.pipeline_depth == 1
        # id(request) -> its enqueue time, for serve/queue_wait_s
        t_enq: dict[int, float] = {}
        swap_pause_logged = False   # one swap_pause event per barrier

        def emit(comp: Completion) -> None:
            done.append(comp)
            if sink is not None:
                sink(comp)

        def tev(kind: str, req: Request, **fields) -> None:
            """One lifecycle event of a TRACED request into the tracing
            ring; untraced local runs stay out of it."""
            tc = getattr(req, "trace", None)
            if tc is not None:
                obs.events.record(kind, trace=tc.trace_id, **fields)

        def complete_unadmitted(req: Request, reason: str) -> None:
            t_enq.pop(id(req), None)
            if reason == "rejected":
                stats.rejected += 1
                self._obs_rejected.inc()
            elif reason == "timeout":
                stats.timeouts += 1
                self._obs_timeouts.inc()
            elif reason == "invalid":
                stats.invalid += 1
            tev(reason, req, stage="queue")
            emit(Completion(
                rid=req.rid, prompt=np.asarray(req.prompt),
                tokens=np.zeros((0,), np.int32), reason=reason))

        def intake(batch, strict: bool) -> None:
            """Queue new requests; in service mode (``strict=False``) a
            request that fails validation completes ``"invalid"``."""
            for req in batch:
                if not strict:
                    try:
                        self._validate(req)
                    except ValueError:
                        complete_unadmitted(req, "invalid")
                        continue
                t_enq[id(req)] = time.perf_counter()
                pending.append(req)

        def shed() -> None:
            """Overload ladder.  Past the soft ``degrade_queue`` watermark
            the loop goes DEGRADED (admissions clamp best-effort budgets,
            see ``admit_free``).  Past ``max_queue`` waiting requests it
            sheds: the lowest priority class first, newest first within a
            class, so earlier arrivals keep their FIFO place."""
            self._degraded = (self.degrade_queue is not None
                              and len(pending) > self.degrade_queue)
            self._obs_degraded.set(1.0 if self._degraded else 0.0)
            while (self.max_queue is not None
                   and len(pending) > self.max_queue):
                lowest = min(r.priority for r in pending)
                victim = max(i for i, r in enumerate(pending)
                             if r.priority == lowest)
                req = pending[victim]
                del pending[victim]
                complete_unadmitted(req, "rejected")
            self._obs_queue.set(len(pending))

        def finalize(slot: int, reason: str, *,
                     free_pool: bool = True) -> None:
            st = slot_state[slot]
            tev("finalize", st["req"], slot=slot, reason=reason,
                tokens=len(st["tokens"]))
            emit(Completion(
                rid=st["req"].rid, prompt=np.asarray(st["req"].prompt),
                tokens=np.asarray(st["tokens"], np.int32), reason=reason))
            stats.tokens += len(st["tokens"])
            self._obs_tokens.inc(len(st["tokens"]))
            if "t_admit" in st:
                self._obs_latency.record(time.perf_counter() - st["t_admit"])
            slot_state[slot] = None
            if self.pool is not None and free_pool:
                # free-on-finalize: blocks and the unused reservation
                # return now (the lane is frozen on the device, and the
                # merge sinks its side slots, so nothing writes them)
                self.pool.free_slot(slot)

        def kill(slot: int, reason: str) -> None:
            """A host-side kill (deadline, corrupt token): freeze the lane
            on the device and finalize it; a paged lane with segments in
            flight parks as a zombie until they drain."""
            self._active[slot] = False
            if self.pool is not None and inflight \
                    and "prefill" not in slot_state[slot]:
                finalize(slot, reason, free_pool=False)
                slot_state[slot] = {"zombie": True, "free_at": seq}
            else:
                # mid-prefill the lane was never active, so no segment
                # merges for it and its chunks wrote only the transient
                # batch-1 cache: the refund is safe now
                finalize(slot, reason)

        def expire_inflight() -> None:
            """Kill lanes whose deadline passed, with the tokens drained
            so far."""
            now = None
            for slot in range(self.B):
                st = slot_state[slot]
                if (st is None or st.get("zombie")
                        or st["req"].deadline_s is None):
                    continue
                if now is None:
                    now = self._clock()
                if now > st["req"].deadline_s:
                    stats.timeouts += 1
                    self._obs_timeouts.inc()
                    obs.recorder.record("serve_timeout", slot=slot, seq=seq,
                                        tokens=len(st["tokens"]))
                    tev("timeout", st["req"], stage="decode", slot=slot,
                        tokens=len(st["tokens"]))
                    kill(slot, "timeout")

        def admit_free() -> None:
            """Expire queued deadlines, then fill free lanes from the
            queue (none while a swap waits); a one-shot admission's tokens
            first surface in the NEXT dispatched segment (index ``seq``),
            so its drain is gated on that stamp."""
            nonlocal pending, swap_pause_logged
            if pending:
                now = None
                kept: deque[Request] = deque()
                for req in pending:
                    if req.deadline_s is not None:
                        if now is None:
                            now = self._clock()
                        if now > req.deadline_s:
                            complete_unadmitted(req, "timeout")
                            continue
                    kept.append(req)
                pending = kept
            if self._pending_swap is not None:
                # the swap barrier: no admissions until it lands
                if not swap_pause_logged:
                    swap_pause_logged = True
                    for req in pending:
                        tev("swap_pause", req, queued=len(pending),
                            version=self._pending_swap.get("version"))
                self._obs_queue.set(len(pending))
                return
            for slot in range(self.B):
                if slot_state[slot] is None and pending:
                    # preempt="migrate" admits the best waiting class
                    # first (FIFO within a class)
                    sel = (max(range(len(pending)),
                               key=lambda i: (pending[i].priority, -i))
                           if self.preempt == "migrate" else 0)
                    req = pending[sel]
                    if self.pool is not None and not self._fits(req):
                        # capacity gate: QUEUE instead of overrunning the
                        # pool, FIFO (a smaller request behind the head
                        # never jumps it, which would starve long prompts)
                        break
                    del pending[sel]
                    t_q = t_enq.pop(id(req), None)
                    if (self.preempt != "migrate" and self._degraded
                            and req.priority <= 0
                            and req.max_new_tokens > self.degrade_max_new):
                        # degraded mode: best-effort traffic gets a short
                        # answer instead of (later) no answer; a copy, the
                        # caller's Request is never mutated
                        req = dataclasses.replace(
                            req, max_new_tokens=self.degrade_max_new)
                        stats.degrade_clamped += 1
                        self._obs_degrade_clamped.inc()
                        tev("degrade_clamp", req, stage="replica",
                            max_new=self.degrade_max_new)
                    if t_q is not None:
                        self._obs_queue_wait.record(
                            time.perf_counter() - t_q)
                    with obs.span("serve/admit", slot=slot):
                        st = self._admit(slot, req)
                    st["t_admit"] = time.perf_counter()
                    if "prefill" not in st:
                        st["seq"] = seq
                    slot_state[slot] = st
                    stats.requests += 1
                    self._obs_requests.inc()
                    L_req = int(np.asarray(req.prompt).size)
                    obs.recorder.record(
                        "serve_admit", slot=slot, seq=seq,
                        prompt_len=L_req, max_new=req.max_new_tokens)
                    tev("admit", req, slot=slot, seq=seq,
                        prompt_len=L_req, max_new=req.max_new_tokens)
            self._obs_queue.set(len(pending))

        def drain(slot: int, emit_row) -> None:
            """Feed a slot's newly visible tokens (column 0 = the
            admission-deferred first token, then the segment's emits)
            through the stop/budget rules; the first hit finalizes before
            any frozen-row pad could be consumed."""
            st = slot_state[slot]
            row = [int(t) for t in emit_row]
            first_col = st["pending_first"]
            st["pending_first"] = False
            if not first_col:
                row = row[1:]               # column 0 is a stale first
            for j, t in enumerate(row):
                if not 0 <= t < self.cfg.vocab_size:
                    # an id outside the vocab can only come from scrambled
                    # device memory or a bad transfer
                    stats.corrupt_segments += 1
                    self._obs_corrupt.inc()
                    obs.recorder.record(
                        "serve_corrupt_segment", slot=slot,
                        token=t, tokens=len(st["tokens"]))
                    tev("corrupt_segment", st["req"], slot=slot,
                        token=t, tokens=len(st["tokens"]))
                    kill(slot, "corrupt_segment")
                    return
                st["tokens"].append(t)
                self._served_tokens += 1
                if j > 0 or not first_col:
                    stats.decode_tokens += 1
                if t in self._stop_set:
                    finalize(slot, "stop")
                    return
                if len(st["tokens"]) >= st["req"].max_new_tokens:
                    finalize(slot, "length")
                    return

        def advance_admissions() -> None:
            """Chunked prefill: advance every prefilling lane by ONE prompt
            chunk; when its worklist is empty, finish it (insert + first
            token + lane stamps) so it joins the next segment, its drain
            gated on that segment's index."""
            t0 = time.perf_counter()
            worked = handed = False
            for slot in range(self.B):
                st = slot_state[slot]
                if st is None or "prefill" not in st:
                    continue
                worked = True
                pf = st["prefill"]
                if pf["chunks"]:
                    off, w = pf["chunks"].pop(0)
                    with obs.span("serve/prefill_chunk", slot=slot,
                                  off=off, width=w):
                        pf["cache1"], pf["logits"] = self._prefill_chunk(
                            pf["cache1"], pf["padded"][:, off:off + w], off)
                    pf["off_last"] = off
                    tev("prefill_chunk", st["req"], slot=slot,
                        off=off, width=w, left=len(pf["chunks"]))
                    continue
                with obs.span("serve/admit_finish", slot=slot):
                    self._admit_finish(pf, slot)
                if self._prefix_cache is not None:
                    # registered only now that the insert has written the
                    # blocks: an earlier admission matching them would
                    # gather unwritten pages (first-wins per hash)
                    self._prefix_cache.register(
                        pf["padded"][0, :pf["L"]],
                        self.pool._slot_blocks[slot])
                    if self._tier is not None and len(self._tier):
                        # every full block of the prompt is pool-resident
                        # now: drop a surviving tier copy (a re-admit that
                        # stopped early left deeper links spilled)
                        for h in chain_hashes(pf["padded"][0, :pf["L"]],
                                              self.kv_block_size):
                            self._tier.discard(h)
                del st["prefill"]
                tev("prefill_done", st["req"], slot=slot, seq=seq,
                    prompt_len=pf["L"])
                if self.role == "prefill":
                    # the prefill role's job ends here: the lane never
                    # decodes; its pages and first token leave as the
                    # handoff, and the slot frees at once
                    self._active[slot] = False
                    payload = self._build_handoff(slot, st["req"], pf)
                    tev("handoff_export", st["req"], slot=slot, seq=seq,
                        prompt_len=pf["L"],
                        blocks=-(-pf["L"] // self.kv_block_size))
                    emit(Completion(
                        rid=st["req"].rid,
                        prompt=np.asarray(st["req"].prompt),
                        tokens=np.zeros((0,), np.int32), reason="handoff",
                        handoff=payload))
                    self._obs_latency.record(
                        time.perf_counter() - st["t_admit"])
                    slot_state[slot] = None
                    handed = True
                    continue
                st["seq"] = seq
            if worked:
                if synced:
                    self._sync()
                stats.prefill_seconds += time.perf_counter() - t0
            if handed:
                # no decode dispatch will come to refill the freed lanes
                admit_free()
                shed()

        def busy_decode() -> bool:
            """Lanes a segment could advance (zombies and prefill-phase
            lanes, inactive on the device, excluded)."""
            return any(st is not None and not st.get("zombie")
                       and "prefill" not in st for st in slot_state)

        def can_work() -> bool:
            """Decode work a dispatch could advance.  A queued request
            alone also counts (an empty segment, as the JAX loop runs
            while lanes are still prefilling, and the drain that refunds a
            zombie's blocks), except behind a swap barrier, which keeps it
            out of every lane."""
            if self.role == "prefill":
                return False
            return busy_decode() or (bool(pending)
                                     and self._pending_swap is None)

        def maybe_swap() -> None:
            """Apply a pending swap once nothing is in flight and no lane
            is occupied (zombies included)."""
            if (self._pending_swap is None or inflight
                    or any(st is not None for st in slot_state)):
                return
            nonlocal swap_pause_logged
            swap, self._pending_swap = self._pending_swap, None
            swap_pause_logged = False   # the next swap logs its pause again
            self._apply_swap(swap, seq)
            admit_free()   # the barrier is down; refill lanes now
            shed()

        def dispatch() -> None:
            """Chain one more segment on the device and start its emits'
            copy to the host; no host wait at depth >= 2."""
            nonlocal seq
            n = self._plan_steps(slot_state)
            k = 0
            if self.decode_mode == "speculative":
                k = self._spec_k(sum(1 for st in slot_state
                                     if st is not None
                                     and not st.get("zombie")))
            if self.pool is not None:
                # grow-on-decode-boundary: every decoding lane's pages
                # cover the segment's worst case (drawn from its admit-time
                # reservation, so this cannot fail); prefilling lanes and
                # zombies do not grow.  Then the table goes to the device.
                for slot, st in enumerate(slot_state):
                    if (st is not None and not st.get("zombie")
                            and "prefill" not in st):
                        # a speculative segment's last round may emit a
                        # whole K+1 window past n - 1
                        self.pool.grow(slot, n + k)
                self._stamp_table()
            t0 = time.perf_counter()
            spec = None
            with obs.span("serve/segment", steps=n, seq=seq):
                if k:
                    emits_dev, corrupt_dev, spec = self._segment_spec(n, k)
                    stats.spec_k = k
                    self._obs_spec_k.set(k)
                else:
                    emits_dev, corrupt_dev = self._segment(
                        n, faults.poison_logits(self._served_tokens))
            self._obs_segments.inc()
            self._obs_dispatches.inc()
            for slot, st in enumerate(slot_state):
                if (st is not None and not st.get("zombie")
                        and "prefill" not in st):
                    tev("segment", st["req"], slot=slot, seq=seq,
                        steps=n, tokens=len(st["tokens"]),
                        spt=(round(self._step_ema, 6)
                             if self._step_ema is not None else None))
            inflight.append((seq, self._fetch_start(seq, emits_dev,
                                                    corrupt_dev),
                             n, k, spec, t0))
            seq += 1
            stats.segments += 1
            self._obs_depth.set(len(inflight))
            # fault harness: a configured kill-after-K-segments SIGKILLs
            # here, mid-decode, with segments in flight
            faults.on_segment()

        def drain_oldest() -> None:
            """Resolve the oldest segment in flight: wait for its copy,
            then feed every lane whose stamp says this segment carries its
            tokens, and refund the zombies it was the last to hold."""
            s_idx, fetched, n, k, spec, t_disp = inflight.popleft()
            self._obs_depth.set(len(inflight))
            t0 = time.perf_counter()
            emits, corrupt = self._fetch_wait(fetched)
            now = time.perf_counter()
            stats.host_wait_seconds += now - t0
            dt = now - t_disp
            stats.decode_seconds += dt
            # tpudist's drain reads a segment only when a lane takes its
            # tokens; its host_wait and per-dispatch gauges follow that
            read = any(st is not None and not st.get("zombie")
                       and "seq" in st and st["seq"] <= s_idx
                       for st in slot_state)
            if read:
                self._obs_host_wait.record(now - t0)
            if spec is not None:
                n, rounds, acc, act = spec   # n: tokens the segment emitted
                stats.spec_rounds += rounds
                stats.spec_draft_steps += rounds * (k + 1)
                stats.spec_accepted += acc
                stats.spec_row_rounds += act
                if read and act > 0 and k > 0:
                    self._obs_spec_accept.set(acc / (act * k))
                policy = self._spec_policy
                if policy is not None and act > 0:
                    policy.update({"rounds": act, "draft_accepted": acc},
                                  batch=1, num_draft=k)
                if policy is not None and rounds > 0:
                    # each K's first dispatch stays out of the cost model
                    if self._spec_uses.get(k, 0) >= 1:
                        policy.observe_round_cost(k, dt / rounds)
                    self._spec_uses[k] = self._spec_uses.get(k, 0) + 1
            if n > 0:
                per = dt / n
                self._step_ema = (per if self._step_ema is None
                                  else 0.7 * self._step_ema + 0.3 * per)
                if read:
                    self._obs_spt.set(self._step_ema)
            if read:
                self._obs_steps_per_dispatch.set(n)
            for slot in range(self.B):
                st = slot_state[slot]
                if (st is None or st.get("zombie") or "seq" not in st
                        or st["seq"] > s_idx):
                    continue
                if corrupt[slot]:
                    # the guard froze this lane before emitting anything
                    # from the bad step, but the segment's earlier columns
                    # come from the same poisoned state: discard them all
                    stats.corrupt_segments += 1
                    self._obs_corrupt.inc()
                    obs.recorder.record(
                        "serve_corrupt_segment", slot=slot,
                        seq=s_idx, tokens=len(st["tokens"]))
                    tev("corrupt_segment", st["req"], slot=slot,
                        seq=s_idx, tokens=len(st["tokens"]))
                    finalize(slot, "corrupt_segment")
                else:
                    drain(slot, emits[slot, :1 + n])
            # every segment dispatched before a kill (index < free_at) has
            # drained once s_idx reaches free_at - 1
            for slot in range(self.B):
                st = slot_state[slot]
                if (st is not None and st.get("zombie")
                        and s_idx >= st["free_at"] - 1):
                    self.pool.free_slot(slot)
                    slot_state[slot] = None

        # -- live KV migration (preemption, rebalance, drain) -------------

        def quiesce() -> None:
            """Drain EVERY segment in flight: each lane's host token list
            is then final, zombies are refunded, and no merge can touch
            the pages an export reads."""
            while inflight:
                drain_oldest()

        def export_lane(slot: int) -> dict:
            """Freeze ``slot`` on the device, export it as a migration
            payload and release the lane (no completion: the caller parks
            it or hands it out)."""
            self._active[slot] = False
            payload = self._build_migration(slot, slot_state[slot])
            slot_state[slot] = None
            return payload

        def park(slot: int) -> None:
            """Export ``slot`` and park it here, to resume through the
            adopt path: with a host tier its pages spill into the tier
            block by block (pinned; an eviction of any of them downgrades
            the resume to a re-prefill, byte-identical), else the payload
            stays whole in host RAM."""
            req = slot_state[slot]["req"]
            n_gen = len(slot_state[slot]["tokens"])
            payload = export_lane(slot)
            entry: dict = {"req": req, "t_q": time.perf_counter()}
            keys: list[int] = []
            if self._tier is not None and payload["layers"]:
                parent = None
                n_blk = int(_payload_tensor(payload["layers"][0]["k"])
                            .shape[0])
                for i in range(n_blk):
                    h = _park_hash(req.rid, i)
                    blk = [{"k": _pinned(_payload_tensor(l["k"])[i],
                                         self._tier_stream),
                            "v": _pinned(_payload_tensor(l["v"])[i],
                                         self._tier_stream)}
                           for l in payload["layers"]]
                    if not self._tier.put(h, blk, parent=parent,
                                          version=self.weights_version):
                        # refused (budget): keep the payload whole
                        for k in keys:
                            self._tier.discard(k)
                        keys = []
                        break
                    keys.append(h)
                    parent = h
            if keys:
                entry["meta"] = {k: v for k, v in payload.items()
                                 if k != "layers"}
                entry["keys"] = keys
            else:
                entry["payload"] = payload
            self._parked[req.rid] = entry
            stats.preempted += 1
            self._obs_preempted.inc()
            obs.recorder.record("serve_preempt", slot=slot,
                                tokens=n_gen, parked=len(self._parked))
            tev("preempt", req, stage="replica", slot=slot,
                tokens=n_gen, parked=len(self._parked))

        def unpark(entry: dict) -> dict | None:
            """A parked lane's payload, its tiered blocks taken back; None
            when any was evicted or flushed (the resume re-prefills)."""
            if "payload" in entry:
                return entry["payload"]
            blocks = []
            for h in entry["keys"]:
                blk = self._tier.take(h, version=self.weights_version)
                if blk is None:
                    drop_parked(entry)
                    return None
                blocks.append(blk)
            layers = [{key: _host_array(torch.stack(
                [b[li][key] for b in blocks])) for key in ("k", "v")}
                for li in range(len(blocks[0]) if blocks else 0)]
            return {**entry["meta"], "layers": layers}

        def drop_parked(entry: dict) -> None:
            for h in entry.get("keys", ()):
                self._tier.discard(h)
            entry.pop("keys", None)
            entry.pop("payload", None)

        def migrate_out(req: Request, payload: dict | None,
                        stage: str) -> None:
            """Hand a request out as a ``reason="migrate"`` completion,
            with its lane's payload or none (it never held a lane, or was
            mid-prefill: a re-prefill elsewhere gives the same bytes)."""
            t_enq.pop(id(req), None)
            stats.migrated_out += 1
            self._obs_migrated_out.inc()
            tev("migrate_export", req, stage=stage,
                tokens=(len(payload.get("generated", ())) + 1
                        if payload else 0),
                refless=payload is None)
            emit(Completion(rid=req.rid, prompt=np.asarray(req.prompt),
                            tokens=np.zeros((0,), np.int32),
                            reason="migrate", handoff=payload))

        def do_migrates() -> bool:
            """Serve the migration intents: everything (evacuate) or the
            named requests, queued, parked or in a lane.  Batch mode has
            no one to resume a migrated request, so there the intents
            are dropped."""
            nonlocal pending
            if not (self._evacuate or self._migrate_rids):
                return False
            evac, wanted = self._evacuate, set(self._migrate_rids)
            self._migrate_rids.clear()
            self._evacuate = False
            if sink is None and source is None:
                return False

            def chosen(req) -> bool:
                return evac or str(req.rid) in wanted

            moved = False
            kept: deque[Request] = deque()
            for req in pending:
                if chosen(req):
                    migrate_out(req, None, "queue")
                    moved = True
                else:
                    kept.append(req)
            pending = kept
            for rid in list(self._parked):
                if chosen(self._parked[rid]["req"]):
                    entry = self._parked.pop(rid)
                    migrate_out(entry["req"], unpark(entry), "parked")
                    moved = True
            lanes = [slot for slot, st in enumerate(slot_state)
                     if st is not None and not st.get("zombie")
                     and chosen(st["req"])]
            if self.pool is not None and lanes:
                quiesce()
                for slot in lanes:
                    st = slot_state[slot]
                    if st is None or st.get("zombie"):
                        continue     # it finished during the quiesce
                    if "prefill" in st:
                        # mid-prefill: no finished prefix to export
                        self.pool.free_slot(slot)
                        slot_state[slot] = None
                        migrate_out(st["req"], None, "prefill")
                    else:
                        migrate_out(st["req"], export_lane(slot), "decode")
                    moved = True
            return moved

        def maybe_preempt() -> bool:
            """Priority preemption (``preempt="migrate"``): when the loop
            is degraded, or the best waiting request is blocked (no free
            lane, or the pool cannot take it) while a strictly lower
            priority lane decodes, quiesce and PARK the lowest-priority
            lane (of those, the one with the most tokens) instead of
            clamping it."""
            if (self.preempt != "migrate" or self.pool is None
                    or self.role == "prefill" or not pending):
                return False

            def victims() -> list[tuple[int, int, int]]:
                top = max(r.priority for r in pending)
                return sorted(
                    (st["req"].priority, -len(st["tokens"]), slot)
                    for slot, st in enumerate(slot_state)
                    if st is not None and not st.get("zombie")
                    and "prefill" not in st and st["req"].priority < top)

            if not victims():
                return False
            if not self._degraded:
                top_req = max(pending, key=lambda r: r.priority)
                blocked = not any(st is None for st in slot_state)
                if not blocked:
                    blocked = not self.pool.can_admit(
                        int(np.asarray(top_req.prompt).size),
                        int(top_req.max_new_tokens))
                if not blocked:
                    return False
            quiesce()   # drains may finalize lanes: pick again after
            vs = victims()
            if not vs:
                return False
            park(vs[0][2])
            return True

        def maybe_resume() -> bool:
            """Put the oldest parked request back at the FRONT of the
            queue, carrying its payload, once pressure clears (or intake
            has closed); one past its deadline completes "timeout"."""
            if not self._parked or self._pending_swap is not None:
                return False
            if not closed and self._degraded:
                return False
            rid = next(iter(self._parked))
            req = self._parked[rid]["req"]
            if req.deadline_s is not None and self._clock() > req.deadline_s:
                drop_parked(self._parked.pop(rid))
                complete_unadmitted(req, "timeout")
                return True
            if not any(st is None for st in slot_state):
                return False
            if not self.pool.can_admit(int(np.asarray(req.prompt).size),
                                       int(req.max_new_tokens)):
                return False
            entry = self._parked.pop(rid)
            payload = unpark(entry)
            resumed = (dataclasses.replace(req, kv_handoff=payload)
                       if payload is not None else req)
            t_enq[id(resumed)] = entry["t_q"]
            pending.appendleft(resumed)
            stats.resumed += 1
            self._obs_resumed.inc()
            obs.recorder.record("serve_resume", fallback=payload is None,
                                parked=len(self._parked))
            tev("resume", req, stage="replica", fallback=payload is None,
                parked=len(self._parked))
            return True

        # an unhandled exception mid-serve dumps the flight recorder's
        # bundle (admission ring, final snapshot) before propagating
        with obs.recorder.guard("serve_loop", num_slots=self.B,
                                requests=len(requests),
                                pipeline_depth=self.pipeline_depth):
            intake(requests, strict=True)
            admit_free()
            shed()
            while True:
                if not closed:
                    batch = source()
                    if batch is None:
                        closed = True
                    elif batch:
                        intake(batch, strict=False)
                        admit_free()
                        shed()
                expire_inflight()
                if (self.preempt == "migrate"
                        and self._pending_swap is not None
                        and source is not None):
                    # fast swap: hand in-flight work to peers so the
                    # barrier drains in about one handoff instead of the
                    # longest decode
                    self._evacuate = True
                if do_migrates() | maybe_preempt() | maybe_resume():
                    admit_free()
                    shed()
                advance_admissions()
                if can_work():
                    dispatch()
                # drain when the pipeline is full, or when nothing is left
                # to dispatch and only drains remain
                while inflight and (len(inflight) >= self.pipeline_depth
                                    or not can_work()):
                    drain_oldest()
                    admit_free()
                maybe_swap()
                if not (pending or inflight or self._parked
                        or any(st is not None for st in slot_state)):
                    if closed:
                        break
                    time.sleep(idle_wait_s)
            # the queue drained on the way out: an idle loop is not
            # degraded
            self._degraded = False
            self._obs_degraded.set(0.0)
        return done
