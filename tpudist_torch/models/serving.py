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
Counters are plain attributes (``stats``, ``prefix_stats``).

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

Not ported yet — each raises ``NotImplementedError`` naming its ROADMAP
item: speculative decoding, the prefill/decode roles and preemption by
migration; the paged layout's host-RAM tier is absent (its prefix cache
evicts without spilling).  The overload ladder is ported: past
``degrade_queue`` waiting requests best-effort budgets are clamped, past
``max_queue`` the overflow is shed.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from tpudist_torch.models.generate import (
    _blank_cache,
    _make_select,
    _prefill,
    _stop_array,
    build_model,
    serving_layout,
)
from tpudist_torch.models.kv_pages import BlockPool, PrefixCache
from tpudist_torch.models.transformer import TransformerConfig
from tpudist_torch.utils.device import resolve_device


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
    prefix_hash: int | None = None


@dataclasses.dataclass
class Completion:
    rid: Any
    prompt: np.ndarray
    tokens: np.ndarray            # the generated tokens (stop included)
    # "stop" | "length"; "rejected" (load-shed at a full queue);
    # "timeout" (past its deadline, queued or in flight); "invalid" (a
    # malformed request in service mode); "corrupt_segment" (non-finite
    # logits or an out-of-vocab token)
    reason: str


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


def _index_leaves(cache: list[dict]):
    """(cache_index [B], side_index 0-D | None): every layer carries the
    same values, so the first layer's suffice."""
    return cache[0]["cache_index"], cache[0].get("side_index")


def _set_cache_index(cache: list[dict], idx: int) -> list[dict]:
    """Roll the cache to ``idx`` tokens: every index (``cache_index``, and
    ``side_index`` where present) is reset; K/V buffers are left as they
    are — slots past the index are masked by every cached-attention path
    and overwritten by the next write at that position."""
    for layer in cache:
        for name in ("cache_index", "side_index"):
            if name in layer:
                layer[name] = torch.full_like(layer[name], idx)
    return cache


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
      preempt: "degrade" (the ladder above); "migrate" is not ported.
      chunked_prefill: admit one prompt chunk per loop iteration between
        decode segments instead of the whole prompt at once (same chunk
        grid, same tokens).
      cache_layout: "dense" (per-slot ``[B, S]`` K/V buffers) or "paged"
        (one block pool per layer plus per-slot page tables).
      kv_block_size: tokens per KV block (paged only), a positive
        multiple of 8.
      kv_num_blocks: pool capacity (paged only); ``None`` sizes it to full
        dense capacity, ``num_slots × ceil(max_seq_len / block)``.
      prefix_sharing: copy-on-write prefix sharing (paged layout with
        chunked prefill; off otherwise).
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
        if preempt not in ("degrade", "migrate"):
            raise ValueError(f"preempt must be 'degrade' or 'migrate', got "
                             f"{preempt!r}")
        if preempt == "migrate":
            raise NotImplementedError(
                "preempt='migrate' is not ported yet (ROADMAP Queue A: "
                "speculative decoding, roles and preemption)")
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
        if decode_mode not in ("plain", "speculative"):
            raise ValueError(f"decode_mode must be 'plain' or 'speculative', "
                             f"got {decode_mode!r}")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be 'both', 'prefill', or 'decode', "
                             f"got {role!r}")
        if decode_mode != "plain" or role != "both":
            raise NotImplementedError(
                "speculative decoding and the prefill/decode roles are not "
                "ported yet (ROADMAP Queue A: speculative decoding, roles "
                "and preemption)")
        if cfg.attention_window is not None:
            warnings.warn(
                "ServeLoop with a sliding-window model uses DENSE per-row "
                "attention (the per-row flash kernel has no window trim): "
                "every decode step reads the whole cache", stacklevel=2)
        # side-buffer mode (no window): steps write a segment-local buffer
        # at a scalar index and one merge per segment scatters side -> main
        self.side = steps_per_sync if cfg.attention_window is None else 0
        if self.side > cfg.max_seq_len:
            raise ValueError(f"steps_per_sync {steps_per_sync} exceeds "
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
        self.pipeline_depth = int(pipeline_depth)
        self.prefill_chunk = prefill_chunk
        self.pad_token = int(pad_token)
        self.chunked = bool(chunked_prefill)
        # prefix sharing needs the pool (shared blocks live there) and the
        # chunked admission (a hit starts its worklist past the prefix)
        self._prefix_cache = (PrefixCache(self.pool)
                              if prefix_sharing and self.chunked and paged
                              else None)
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
        self._generator = generator
        if generator is None and temperature > 0:
            self._generator = torch.Generator(self.device).manual_seed(0)
        # the slot cache: VECTOR index leaves (one position per slot), in
        # side mode the side buffers (the JAX loop's _with_side_buffers)
        # and, paged, the pools and page table instead of dense rows
        self.cache = _blank_cache(self.model, num_slots, per_row=True,
                                  side_slots=self.side, paged=paged)
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
        self.weights_version: int | None = None
        self.stats = ServeStats()
        # depth >= 2 on a card: the side stream of the emits' copies, the
        # pinned emits buffers (one per segment in flight, each with the
        # event of its copy) and the pinned early-exit flags (one a tick)
        self._copy_stream = None
        self._ring: list[dict] = []
        self._flags: list[tuple[torch.Tensor, Any]] = []
        self.pinned_reuse_waits = 0   # a ring buffer reused before its copy
        self.segment_host_reads = 0   # per-tick early-exit host reads

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
    def _segment(self, n_steps: int):
        """One multi-token segment: up to ``n_steps`` decode ticks, leaving
        early once every lane is frozen (at depth 1 by a host read of
        ``active.any()`` each tick; deeper, by a lagged pinned flag, see
        the module docstring).  Returns the ``[B, 1 + steps]`` emits
        (column 0 carries the admission-deferred first tokens, columns
        past the ticks run are pad) and the per-lane ``corrupt`` flags of
        the in-graph NaN/inf guard."""
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
            for big, small in zip(self.cache, cache1):
                big["cached_key"][slot].copy_(small["cached_key"][0])
                big["cached_value"][slot].copy_(small["cached_value"][0])
                big["cache_index"][slot] = true_len
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
        self._stamp_lane(slot, first, max_new)

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
        write into the last shared block — the ``cow`` split."""
        blocks = self._prefix_cache.match(prompt)
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
        (the pool then drains to fully free once no slot is live)."""
        if self._prefix_cache is not None:
            self._prefix_cache.flush()
        self._affinity_recent.clear()

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
        self.prefix_stats["requests"] += 1
        self.prefix_stats["prompt_tokens"] += L
        if req.prefix_hash is not None and self._prefix_cache is not None:
            self._affinity_recent.pop(int(req.prefix_hash), None)
            self._affinity_recent[int(req.prefix_hash)] = None
            while len(self._affinity_recent) > 128:
                self._affinity_recent.pop(next(iter(self._affinity_recent)))
        if self.chunked:
            return self._admit_start(slot, req, prompt, L, max_new)
        self.prefix_stats["prefill_tokens"] += L
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

    def _apply_swap(self, swap: dict) -> None:
        tree = swap["fn"]()
        if tree is not None:
            _, sd = serving_layout(self._cfg_in, tree)
            self.model.load_state_dict(sd)
            self.stats.swaps += 1
            if swap["version"] is not None:
                self.weights_version = int(swap["version"])
            # cached prefix KV was computed under the old weights; the
            # loop is drained, so every cached block returns to the pool
            self.flush_prefix_cache()
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
        shape = (self.B, 1 + self.steps)
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
        the kill see the lane frozen on the device."""
        for req in requests:  # fail BEFORE any slot is touched, not mid-run
            self._validate(req)
        self._ready_ring()
        pending: deque[Request] = deque()
        slot_state: list[dict | None] = [None] * self.B
        done: list[Completion] = []
        # (seq, fetched emits, n_steps, t_dispatch)
        inflight: deque[tuple] = deque()
        seq = 0   # segments dispatched so far == index of the next one
        closed = source is None
        stats = self.stats
        synced = self.pipeline_depth == 1

        def emit(comp: Completion) -> None:
            done.append(comp)
            if sink is not None:
                sink(comp)

        def complete_unadmitted(req: Request, reason: str) -> None:
            if reason == "rejected":
                stats.rejected += 1
            elif reason == "timeout":
                stats.timeouts += 1
            elif reason == "invalid":
                stats.invalid += 1
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
                pending.append(req)

        def shed() -> None:
            """Overload ladder.  Past the soft ``degrade_queue`` watermark
            the loop goes DEGRADED (admissions clamp best-effort budgets,
            see ``admit_free``).  Past ``max_queue`` waiting requests it
            sheds: the lowest priority class first, newest first within a
            class, so earlier arrivals keep their FIFO place."""
            self._degraded = (self.degrade_queue is not None
                              and len(pending) > self.degrade_queue)
            while (self.max_queue is not None
                   and len(pending) > self.max_queue):
                lowest = min(r.priority for r in pending)
                victim = max(i for i, r in enumerate(pending)
                             if r.priority == lowest)
                req = pending[victim]
                del pending[victim]
                complete_unadmitted(req, "rejected")

        def finalize(slot: int, reason: str, *,
                     free_pool: bool = True) -> None:
            st = slot_state[slot]
            emit(Completion(
                rid=st["req"].rid, prompt=np.asarray(st["req"].prompt),
                tokens=np.asarray(st["tokens"], np.int32), reason=reason))
            stats.tokens += len(st["tokens"])
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
                    kill(slot, "timeout")

        def admit_free() -> None:
            """Expire queued deadlines, then fill free lanes from the
            queue (none while a swap waits); a one-shot admission's tokens
            first surface in the NEXT dispatched segment (index ``seq``),
            so its drain is gated on that stamp."""
            nonlocal pending
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
                return  # the swap barrier: no admissions until it lands
            for slot in range(self.B):
                if slot_state[slot] is None and pending:
                    if self.pool is not None and not self._fits(pending[0]):
                        # capacity gate: QUEUE instead of overrunning the
                        # pool, FIFO (a smaller request behind the head
                        # never jumps it, which would starve long prompts)
                        break
                    req = pending.popleft()
                    if (self._degraded and req.priority <= 0
                            and req.max_new_tokens > self.degrade_max_new):
                        # degraded mode: best-effort traffic gets a short
                        # answer instead of (later) no answer; a copy, the
                        # caller's Request is never mutated
                        req = dataclasses.replace(
                            req, max_new_tokens=self.degrade_max_new)
                        stats.degrade_clamped += 1
                    st = self._admit(slot, req)
                    if "prefill" not in st:
                        st["seq"] = seq
                    slot_state[slot] = st
                    stats.requests += 1

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
                    kill(slot, "corrupt_segment")
                    return
                st["tokens"].append(t)
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
            worked = False
            for slot in range(self.B):
                st = slot_state[slot]
                if st is None or "prefill" not in st:
                    continue
                worked = True
                pf = st["prefill"]
                if pf["chunks"]:
                    off, w = pf["chunks"].pop(0)
                    pf["cache1"], pf["logits"] = self._prefill_chunk(
                        pf["cache1"], pf["padded"][:, off:off + w], off)
                    pf["off_last"] = off
                    continue
                self._admit_finish(pf, slot)
                if self._prefix_cache is not None:
                    # registered only now that the insert has written the
                    # blocks: an earlier admission matching them would
                    # gather unwritten pages (first-wins per hash)
                    self._prefix_cache.register(
                        pf["padded"][0, :pf["L"]],
                        self.pool._slot_blocks[slot])
                del st["prefill"]
                st["seq"] = seq
            if worked:
                if synced:
                    self._sync()
                stats.prefill_seconds += time.perf_counter() - t0

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
            return busy_decode() or (bool(pending)
                                     and self._pending_swap is None)

        def maybe_swap() -> None:
            """Apply a pending swap once nothing is in flight and no lane
            is occupied (zombies included)."""
            if (self._pending_swap is None or inflight
                    or any(st is not None for st in slot_state)):
                return
            swap, self._pending_swap = self._pending_swap, None
            self._apply_swap(swap)
            admit_free()   # the barrier is down; refill lanes now
            shed()

        def dispatch() -> None:
            """Chain one more segment on the device and start its emits'
            copy to the host; no host wait at depth >= 2."""
            nonlocal seq
            n = self._plan_steps(slot_state)
            if self.pool is not None:
                # grow-on-decode-boundary: every decoding lane's pages
                # cover the segment's worst case (drawn from its admit-time
                # reservation, so this cannot fail); prefilling lanes and
                # zombies do not grow.  Then the table goes to the device.
                for slot, st in enumerate(slot_state):
                    if (st is not None and not st.get("zombie")
                            and "prefill" not in st):
                        self.pool.grow(slot, n)
                self._stamp_table()
            t0 = time.perf_counter()
            emits_dev, corrupt_dev = self._segment(n)
            inflight.append((seq, self._fetch_start(seq, emits_dev,
                                                    corrupt_dev), n, t0))
            seq += 1
            stats.segments += 1

        def drain_oldest() -> None:
            """Resolve the oldest segment in flight: wait for its copy,
            then feed every lane whose stamp says this segment carries its
            tokens, and refund the zombies it was the last to hold."""
            s_idx, fetched, n, t_disp = inflight.popleft()
            t0 = time.perf_counter()
            emits, corrupt = self._fetch_wait(fetched)
            now = time.perf_counter()
            stats.host_wait_seconds += now - t0
            dt = now - t_disp
            stats.decode_seconds += dt
            per = dt / n
            self._step_ema = (per if self._step_ema is None
                              else 0.7 * self._step_ema + 0.3 * per)
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
            advance_admissions()
            if can_work():
                dispatch()
            # drain when the pipeline is full, or when nothing is left to
            # dispatch and only drains remain
            while inflight and (len(inflight) >= self.pipeline_depth
                                or not can_work()):
                drain_oldest()
                admit_free()
            maybe_swap()
            if not (pending or inflight
                    or any(st is not None for st in slot_state)):
                if closed:
                    break
                time.sleep(idle_wait_s)
        # the queue drained on the way out: an idle loop is not degraded
        self._degraded = False
        return done
