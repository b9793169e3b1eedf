"""Decoder-only transformer LM, training and inference forward
(counterpart of :mod:`tpudist.models.transformer`).

The same model as the JAX package's ``TransformerLM`` with the same
numerics: pre-LayerNorm blocks (epsilon 1e-6, f32 statistics, f32 scale
and bias), bias-free projections run in ``compute_dtype``, tanh-approximate
GELU, f32 logits.  Weights come from a flax checkpoint through
:func:`tpudist_torch.models.convert.from_flax_params`.

Projection and embedding weights are stored in ``param_dtype``.  The JAX
model keeps f32 params and casts them to ``compute_dtype`` at each use
(``Dense(dtype=compute_dtype)``); training builds the port's model with
``param_dtype=torch.float32`` to do the same, so the optimizer updates f32
master weights.  Left as ``None``, ``param_dtype`` is ``compute_dtype``:
the serve path stores its weights in the compute dtype and casts nothing.
With ``remat=True`` each block's activations are recomputed in the
backward (``torch.utils.checkpoint``, the twin of ``nn.remat``).

The flax ``cache`` collection becomes an explicit cache: a list with one
dict per layer holding the packed ``[B, S, Hkv·D]`` ``cached_key`` /
``cached_value`` buffers, the ``cache_index`` (a 0-D int32 tensor, or a
``[B]`` vector for the per-row serve mode) and, in the side-buffer serve
mode, ``side_key`` / ``side_value`` / ``side_index``.  The PAGED layout
(``cache_layout="paged"``) holds ``paged_key`` / ``paged_value`` block
pools ``[kv_num_blocks, kv_block_size, Hkv·D]`` and a ``[B, M]`` int32
``page_table`` in place of the dense buffers: slot ``b``'s position ``p``
lives at ``pool[page_table[b, p // block], p % block]``.  A forward with a
cache writes the new K/V into those buffers IN PLACE (the JAX version
returns updated copies; at 8k context a copy per step would cost more than
the step), advances the index, and returns ``(logits, cache)``.  Index
arithmetic stays on the device, so a decode step never waits on the host.

Each attention layer picks its path from the cache node it is handed, so
one paged model serves both its slot pool and the dense batch-1 cache that
admission prefills into (the JAX ServeLoop builds a second, dense model for
that).

Cached attention always goes through the kernel wrappers (the JAX
package's ``decode_attention="flash"``): prefill chunks through the
flash-forward kernel (K1), dense decode steps through the flash-decode
kernel (K2), paged decode steps through the paged flash-decode kernel
(K5).  On CPU tensors the wrappers run their plain versions.  The one
cached branch without a kernel is the per-row decode of a sliding-window
model without side buffers (the JAX package has none either); it runs
the plain masked softmax and is off the serve path's main configuration.

``cfg.scan_layers`` is accepted and changes nothing: PyTorch runs
eagerly, so there is no trace to shrink; the model runs its unrolled
``ModuleList``, and ``from_flax_params`` unstacks a scanned checkpoint.

Tensor parallelism (``tp_axis=`` over a ``mesh``): tpudist's Megatron
layout, with the collectives written out as the layers run.  Each process
holds ``H/tp`` query and ``Hkv/tp`` KV heads (``qkv``/``q``/``kv``
column-parallel, whole heads of each of q, k and v), ``proj`` row-parallel
and followed by the all-reduce, ``up`` column- and ``down`` row-parallel
likewise, the token table's rows of its vocabulary block (a masked lookup,
then the all-reduce) and the head's columns of it (the logits all-gathered
before they leave the model); norms and the position table are
replicated.  ``id_fwd_psum_bwd`` starts each column-parallel product and
``psum_fwd_id_bwd`` ends each row-parallel one, so every replicated
parameter's gradient is complete on every process of the axis.  Attention
runs over the local heads through the model's ``attention_fn`` (K1, K3 and
K4 at the shard's shapes on the card).  A group of one process still
issues every collective.  Weights cross with
:func:`~tpudist_torch.parallel.tensor_parallel.make_tp_state` or
:func:`~tpudist_torch.models.convert.from_flax_tp_params`.

Not ported yet: sharded decode (``decode_shard``, and a cache on a
tensor-parallel model: ``tp_generate``) and the per-row speculative verify
chunk without side buffers.  Each raises ``NotImplementedError`` naming
its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tpudist_torch.ops.flash_attention import _flash_forward
from tpudist_torch.ops.flash_decode import flash_decode, paged_flash_decode
from tpudist_torch.utils.device import resolve_device

# (q, k, v, *, causal, window=None) on [batch, seq, heads, head_dim] tensors
AttentionFn = Callable[..., torch.Tensor]

_SHARD_TODO = ("sharded decode (decode_shard) is not ported yet (ROADMAP "
               "Queue A: serving breadth, sharded decode)")
_VERIFY_TODO = ("a per-row multi-token verify chunk without side buffers is "
                "not ported yet (ROADMAP Queue A: speculative decoding, "
                "roles and preemption)")
_TP_DECODE_TODO = ("a cache on a tensor-parallel model (tpudist's "
                   "tp_generate) is not ported yet (ROADMAP Queue A 9); "
                   "gather the parameters and decode on one card")
_PAGED_WINDOW = ("the paged cache has no sliding-window trim yet; use "
                 "cache_layout='dense' for windowed models")


def _masked_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The attention numerics every plain path shares: scaled f32 QKᵀ,
    finfo-min mask fill, f32 softmax, cast back.  ``mask`` is boolean,
    broadcastable to [B, H, Sq, Sk] (True = attend)."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Expand grouped K/V heads to Q's head count (GQA → MHA view): KV
    head ``j`` serves query heads ``[j·g, (j+1)·g)``."""
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    return k, v


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Plain scaled-dot-product attention on [B, S, H, D] tensors; K/V may
    carry fewer (grouped) heads, and ``window`` restricts each query to the
    last ``window`` positions.  Softmax statistics in f32."""
    k, v = repeat_kv(q, k, v)
    mask = None
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril(diagonal=s_k - s_q)
        if window is not None:
            pos_q = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q)
            mask = mask & (pos_q - torch.arange(s_k, device=q.device)[None]
                           < window)
    elif window is not None:
        raise ValueError("window requires causal=True")
    return _masked_attend(q, k, v, mask)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    num_layers: int = 2
    num_heads: int = 4
    embed_dim: int = 128
    mlp_ratio: int = 4
    max_seq_len: int = 512
    compute_dtype: torch.dtype = torch.float32
    # grouped-query attention: K/V heads (None = num_heads, plain MHA)
    num_kv_heads: int | None = None
    # sliding-window attention width (None = full causal attention)
    attention_window: int | None = None
    # the JAX package's scanned layer stack; the port always runs the
    # unrolled layout (from_flax_params unstacks scanned checkpoints)
    scan_layers: bool = False

    @property
    def head_dim(self) -> int:
        if self.embed_dim % self.num_heads:
            raise ValueError(f"embed_dim {self.embed_dim} not divisible by "
                             f"num_heads {self.num_heads}")
        return self.embed_dim // self.num_heads

    @property
    def kv_heads(self) -> int:
        kv = self.num_kv_heads or self.num_heads
        if self.num_heads % kv:
            raise ValueError(f"num_heads {self.num_heads} not a multiple of "
                             f"num_kv_heads {kv}")
        return kv


def blank_cache(cfg: TransformerConfig, batch: int, *,
                device: torch.device, per_row: bool = False,
                side_slots: int = 0, kv_block_size: int = 0,
                kv_num_blocks: int = 0) -> list[dict[str, torch.Tensor]]:
    """A fresh zeroed KV cache: one dict per layer with the packed
    ``[batch, max_seq_len, Hkv·D]`` K/V buffers and a 0-D ``cache_index``
    (``per_row``: a ``[batch]`` vector, the serve mode), plus
    ``[batch, side_slots, Hkv·D]`` side buffers and a 0-D ``side_index``
    when ``side_slots > 0``.  With ``kv_num_blocks > 0`` the layer is
    PAGED instead: ``[kv_num_blocks, kv_block_size, Hkv·D]`` pools, a
    ``[batch, ceil(max_seq_len / kv_block_size)]`` int32 ``page_table``
    (0 is a valid pool index) and a ``[batch]`` ``cache_index``.  Zeros,
    not empty: masked positions are never attended, but a NaN bit pattern
    times a zero probability would still poison a sum."""
    flat = cfg.kv_heads * cfg.head_dim
    layers = []
    for _ in range(cfg.num_layers):
        if kv_num_blocks > 0:
            m = -(-cfg.max_seq_len // kv_block_size)
            pool = (kv_num_blocks, kv_block_size, flat)
            layer = {
                "paged_key": torch.zeros(pool, dtype=cfg.compute_dtype,
                                         device=device),
                "paged_value": torch.zeros(pool, dtype=cfg.compute_dtype,
                                           device=device),
                "page_table": torch.zeros((batch, m), dtype=torch.int32,
                                          device=device),
                "cache_index": torch.zeros((batch,), dtype=torch.int32,
                                           device=device),
            }
        else:
            layer = {
                "cached_key": torch.zeros((batch, cfg.max_seq_len, flat),
                                          dtype=cfg.compute_dtype,
                                          device=device),
                "cached_value": torch.zeros((batch, cfg.max_seq_len, flat),
                                            dtype=cfg.compute_dtype,
                                            device=device),
                "cache_index": torch.zeros((batch,) if per_row else (),
                                           dtype=torch.int32, device=device),
            }
        if side_slots:
            layer["side_key"] = torch.zeros((batch, side_slots, flat),
                                            dtype=cfg.compute_dtype,
                                            device=device)
            layer["side_value"] = torch.zeros_like(layer["side_key"])
            layer["side_index"] = torch.zeros((), dtype=torch.int32,
                                              device=device)
        layers.append(layer)
    return layers


def check_cache_layout(cfg: TransformerConfig, cache_layout: str,
                       kv_block_size: int, kv_num_blocks: int) -> None:
    """The paged layout's construction-time contract (the JAX module
    raises the same errors at its first paged call)."""
    if cache_layout not in ("dense", "paged"):
        raise ValueError(f"cache_layout must be 'dense' or 'paged', got "
                         f"{cache_layout!r}")
    if cache_layout != "paged":
        return
    if kv_block_size < 1 or kv_num_blocks < 1:
        raise ValueError(
            "cache_layout='paged' needs kv_block_size and kv_num_blocks > 0 "
            f"(got {kv_block_size}, {kv_num_blocks})")
    if cfg.attention_window is not None:
        raise ValueError(_PAGED_WINDOW)


class LayerNorm(nn.Module):
    """flax ``LayerNorm(dtype=compute_dtype)``: f32 mean and (fast)
    variance, epsilon 1e-6, f32 ``scale``/``bias``, output cast to the
    compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype, device) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True)
               - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias
        return y.to(self.dtype)


class Dense(nn.Linear):
    """flax ``Dense(use_bias=False, dtype=compute_dtype)``: the weight is
    stored in ``param_dtype`` and cast to ``compute_dtype`` at use (no
    cast when the two agree)."""

    def __init__(self, n_in: int, n_out: int, cfg: TransformerConfig,
                 param_dtype: torch.dtype | None, device) -> None:
        super().__init__(n_in, n_out, bias=False,
                         dtype=param_dtype or cfg.compute_dtype, device=device)
        self.compute_dtype = cfg.compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(self.compute_dtype))


class Embed(nn.Embedding):
    """flax ``Embed(dtype=compute_dtype)``: the table in ``param_dtype``,
    looked-up rows in ``compute_dtype``."""

    def __init__(self, n: int, dim: int, cfg: TransformerConfig,
                 param_dtype: torch.dtype | None, device) -> None:
        super().__init__(n, dim, dtype=param_dtype or cfg.compute_dtype,
                         device=device)
        self.compute_dtype = cfg.compute_dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, attention_fn: AttentionFn = sdpa,
                 *, serve_side_slots: int = 0, cache_layout: str = "dense",
                 kv_block_size: int = 0, kv_num_blocks: int = 0,
                 decode_shard: Any = None, param_dtype=None,
                 device=None, tp: "TensorParallel | None" = None) -> None:
        super().__init__()
        # cfg is the single source of truth for the sliding window: a
        # factory built with its own window that disagrees is rejected
        fw = getattr(attention_fn, "factory_window", None)
        if fw is not None and fw != cfg.attention_window:
            raise ValueError(
                f"attention_fn was built with window={fw} but "
                f"cfg.attention_window={cfg.attention_window}; set the "
                "window on TransformerConfig (the single source of "
                "truth) or make the two agree")
        check_cache_layout(cfg, cache_layout, kv_block_size, kv_num_blocks)
        if decode_shard is not None:
            raise NotImplementedError(_SHARD_TODO)
        self.cfg = cfg
        self.attention_fn = attention_fn
        self.serve_side_slots = serve_side_slots
        self.tp = tp or TensorParallel()
        n = self.tp.size
        self.tp.check(cfg.num_heads, "num_heads")
        self.tp.check(cfg.kv_heads, "kv_heads")
        self.h, self.h_kv = cfg.num_heads // n, cfg.kv_heads // n
        e, d, pd = cfg.embed_dim, cfg.head_dim, param_dtype
        if cfg.kv_heads == cfg.num_heads:
            self.qkv = Dense(e, 3 * self.h * d, cfg, pd, device)
        else:  # GQA: separate projections, K/V at the grouped head count
            self.q = Dense(e, self.h * d, cfg, pd, device)
            self.kv = Dense(e, 2 * self.h_kv * d, cfg, pd, device)
        self.proj = Dense(self.h * d, e, cfg, pd, device)

    def forward(self, x: torch.Tensor, causal: bool = True,
                cache: dict | None = None) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        h, h_kv, d = self.h, self.h_kv, cfg.head_dim
        x = self.tp.enter(x)
        if cfg.kv_heads == cfg.num_heads:
            q, k, v = self.qkv(x).reshape(b, s, 3, h, d).unbind(2)
        else:
            q = self.q(x).reshape(b, s, h, d)
            k, v = self.kv(x).reshape(b, s, 2, h_kv, d).unbind(2)
        if cache is not None:
            out = self._cached_attend(q, k, v, cache)
        else:
            out = self.attention_fn(q, k, v, causal=causal,
                                    window=cfg.attention_window)
        return self.tp.leave(self.proj(out.reshape(b, s, h * d)))

    def _cached_attend(self, q, k, v, cache):
        """Decoding against the layer's cache.  ``s == 1`` is the per-token
        decode step; ``s > 1`` is PREFILL — the chunk lands in the cache and
        attends causally over itself and everything cached before it.  A
        ``[B]`` cache_index selects the per-row serve path, a paged node
        (``paged_key``) the paged serve path."""
        if "paged_key" in cache:
            return self._paged_attend(q, k, v, cache)
        cfg = self.cfg
        b, s, _, d = q.shape
        h_kv = k.shape[2]
        flat = h_kv * d
        ck, cv, idx = (cache["cached_key"], cache["cached_value"],
                       cache["cache_index"])
        if idx.dim() == 1:
            return self._serve_attend(q, k, v, cache)
        S = cfg.max_seq_len
        # the JAX dynamic_update_slice clamps its start to S - s; so does
        # this write (queries still sit at the unclamped idx)
        at = idx.clamp(max=S - s).long() + torch.arange(s, device=q.device)
        ck.index_copy_(1, at, k.reshape(b, s, flat).to(ck.dtype))
        cv.index_copy_(1, at, v.reshape(b, s, flat).to(cv.dtype))
        cache["cache_index"] = idx + s
        k4, v4 = ck.view(b, S, h_kv, d), cv.view(b, S, h_kv, d)
        if s > 1:
            return self._prefill_attend(q, k4, v4, idx)
        return flash_decode(q, ck, cv, idx + 1, window=cfg.attention_window,
                            packed_kv_heads=h_kv)

    def _serve_attend(self, q, k, v, cache):
        """One decode step with PER-ROW cache positions: row ``r``'s K/V
        land at its own ``idx[r]`` and it attends over its first
        ``idx[r] + 1`` slots.  With ``serve_side_slots > 0`` (the ServeLoop
        configuration) the write goes to the segment-local side buffer
        instead (:meth:`_serve_attend_sided`).  A sliding-window model
        takes the plain banded mask here: the per-row kernel has no
        per-row window trim, in the JAX package either, so the ServeLoop
        warns and serves such a model without side buffers."""
        if self.serve_side_slots > 0:
            return self._serve_attend_sided(q, k, v, cache)
        cfg = self.cfg
        b, s, _, d = q.shape
        if s > 1:
            raise NotImplementedError(_VERIFY_TODO)
        h_kv = k.shape[2]
        flat = h_kv * d
        S = cfg.max_seq_len
        ck, cv, idx = (cache["cached_key"], cache["cached_value"],
                       cache["cache_index"])
        rows = torch.arange(b, device=q.device)
        at = idx.clamp(max=S - 1).long()
        ck[rows, at] = k.reshape(b, flat).to(ck.dtype)
        cv[rows, at] = v.reshape(b, flat).to(cv.dtype)
        cache["cache_index"] = idx + 1
        if cfg.attention_window is None:
            return flash_decode(q, ck, cv, idx + 1, packed_kv_heads=h_kv)
        pos = torch.arange(S, device=q.device)[None, :]
        mask = (pos <= idx[:, None]) & (idx[:, None] - pos
                                        < cfg.attention_window)  # [B, S]
        k_rep, v_rep = repeat_kv(q, ck.view(b, S, h_kv, d),
                                 cv.view(b, S, h_kv, d))
        return _masked_attend(q, k_rep, v_rep, mask[:, None, None, :])

    def _serve_attend_sided(self, q, k, v, cache):
        """The side-buffer serve step: ``cache_index`` stays the MAIN-cache
        per-row length for the whole segment, and the step's K/V go to the
        side buffer at the scalar in-segment index (every row writes the
        same side slot; frozen rows' writes are dropped by the segment
        merge).  Attention is ONE flash-decode call over the frozen main
        cache at each row's length plus the side buffer's live positions,
        in the same online softmax."""
        self._write_side(k, v, cache)
        return flash_decode(q, cache["cached_key"], cache["cached_value"],
                            cache["cache_index"], side_k=cache["side_key"],
                            side_v=cache["side_value"],
                            side_len=cache["side_index"],
                            packed_kv_heads=k.shape[2])

    def _write_side(self, k, v, cache) -> None:
        """Stage the step's K/V in the side buffer at the scalar in-segment
        index (clamped so an ``s``-token chunk fits) and advance it."""
        b, s, h_kv, d = k.shape
        cap = self.serve_side_slots
        sk, sv, sidx = cache["side_key"], cache["side_value"], cache["side_index"]
        at = sidx.clamp(max=cap - s).long() + torch.arange(s, device=k.device)
        sk.index_copy_(1, at, k.reshape(b, s, h_kv * d).to(sk.dtype))
        sv.index_copy_(1, at, v.reshape(b, s, h_kv * d).to(sv.dtype))
        cache["side_index"] = sidx + s

    def _paged_attend(self, q, k, v, cache):
        """One decode step against the PAGED cache: the pool is frozen
        within a segment, so the step's K/V stage in the side buffer (the
        ServeLoop's segment merge scatters them into pool pages through
        the page table), and attention is ONE paged flash-decode call (K5)
        over the pool at each row's length plus the side buffer's live
        positions.  Raises the JAX module's errors: per-row vector
        ``cache_index`` only, no sliding window, side buffers required."""
        if cache["cache_index"].dim() == 0:
            raise ValueError(
                "the paged cache decodes through per-row vector "
                "cache_index only (ServeLoop with cache_layout='paged'); "
                "scalar-index rollouts use the dense layout")
        if self.cfg.attention_window is not None:
            raise ValueError(_PAGED_WINDOW)
        if self.serve_side_slots <= 0:
            raise ValueError(
                "cache_layout='paged' requires serve_side_slots > 0 (the "
                "pool is frozen within a segment; tokens stage in the side "
                "buffer)")
        self._write_side(k, v, cache)
        return paged_flash_decode(
            q, cache["paged_key"], cache["paged_value"], cache["page_table"],
            cache["cache_index"], packed_kv_heads=k.shape[2],
            side_k=cache["side_key"], side_v=cache["side_value"],
            side_len=cache["side_index"])

    def _prefill_attend(self, q, k_all, v_all, idx):
        """Chunk prefill: queries at global positions ``[idx, idx + s)``
        attend over the cache's first ``idx + s`` slots, causally, through
        kernel K1 at ``q_offset = idx`` (its causal limit also skips the
        not-yet-written slots; no query padding is needed — the kernel
        masks its ragged edge)."""
        out, _ = _flash_forward(q, k_all, v_all, True, q_offset=idx,
                                window=self.cfg.attention_window)
        return out


class TensorParallel:
    """A model's tensor- (or expert-) parallel axis: its name, the process
    group (None:
    no axis, every method the identity), its size and this process's
    index on it.  ``enter`` is Megatron's f (identity forward, all-reduce
    of the cotangent), ``leave`` its g (all-reduce forward, identity
    backward)."""

    def __init__(self, axis: str | None = None, mesh=None) -> None:
        self.axis, self.group, self.size, self.index = axis, None, 1, 0
        if axis is not None and mesh is not None:
            self.group = mesh.get_group(axis)
            self.size = mesh.size(list(mesh.mesh_dim_names).index(axis))
            self.index = mesh.get_local_rank(axis)

    def check(self, count: int, what: str) -> None:
        if count % self.size:
            raise ValueError(f"{what} {count} not divisible by "
                             f"{self.axis!r} size {self.size}")

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        from tpudist_torch.parallel.common import id_fwd_psum_bwd

        return id_fwd_psum_bwd(x, self.group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        from tpudist_torch.parallel.common import psum_fwd_id_bwd

        return psum_fwd_id_bwd(x, self.group)

    def exchange(self, x: torch.Tensor, split: int,
                 concat: int) -> torch.Tensor:
        """The tiled all-to-all over the axis (``lax.all_to_all``)."""
        from tpudist_torch.parallel.common import all_to_all

        return all_to_all(x, self.group, split, concat)

    def join(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every process's block of ``x`` joined along ``dim``; the VJP
        keeps this process's block of the (whole) cotangent."""
        from tpudist_torch.parallel.common import all_gather_fwd_slice_bwd

        return all_gather_fwd_slice_bwd(x, self.group, dim)


class MLPBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, param_dtype=None,
                 device=None, tp: TensorParallel | None = None) -> None:
        super().__init__()
        self.tp = tp or TensorParallel()
        hidden = cfg.mlp_ratio * cfg.embed_dim
        self.tp.check(hidden, "mlp width")
        hidden //= self.tp.size
        self.up = Dense(cfg.embed_dim, hidden, cfg, param_dtype, device)
        self.down = Dense(hidden, cfg.embed_dim, cfg, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax nn.gelu defaults to the tanh approximation
        h = F.gelu(self.up(self.tp.enter(x)), approximate="tanh")
        return self.tp.leave(self.down(h))


class VocabParallelEmbed(Embed):
    """The token table's rows of this process's vocabulary block: a
    lookup of the ids in the block (others give zero rows), summed over
    the axis in ``param_dtype`` (one real row and zeros: exact), then
    cast."""

    def __init__(self, n: int, dim: int, cfg: TransformerConfig,
                 param_dtype, device, tp: TensorParallel) -> None:
        tp.check(n, "vocab_size")
        super().__init__(n // tp.size, dim, cfg, param_dtype, device)
        self.tp = tp

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.weight.shape[0]
        local = ids - self.tp.index * rows
        hit = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), self.weight)
        x = torch.where(hit[..., None], x, torch.zeros_like(x))
        return self.tp.leave(x).to(self.compute_dtype)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, attention_fn: AttentionFn,
                 device=None, param_dtype=None,
                 tp: TensorParallel | None = None, **attn_kw) -> None:
        super().__init__()
        self.ln1 = LayerNorm(cfg.embed_dim, cfg.compute_dtype, device)
        self.attn = CausalSelfAttention(cfg, attention_fn, device=device,
                                        param_dtype=param_dtype, tp=tp,
                                        **attn_kw)
        self.ln2 = LayerNorm(cfg.embed_dim, cfg.compute_dtype, device)
        self.mlp = MLPBlock(cfg, param_dtype, device, tp)

    def forward(self, x: torch.Tensor, causal: bool = True,
                cache: dict | None = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), causal, cache)
        return x + self.mlp(self.ln2(x))


class TransformerLM(nn.Module):
    """Decoder-only LM: tokens ``[B, S]`` int -> logits ``[B, S, vocab]``
    f32.  With ``cache`` (see :func:`blank_cache`) the forward decodes
    against it, updates it in place and returns ``(logits, cache)``.

    Runs on ``cuda`` unless ``device`` says otherwise; parameters are
    created on that device (load weights with ``load_state_dict`` of
    :func:`~tpudist_torch.models.convert.from_flax_params`' output, or draw
    random ones with :meth:`init_weights`).  ``param_dtype`` (default:
    ``compute_dtype``) is the storage type of the projection and
    embedding weights; ``remat`` recomputes each block in the backward.
    ``cache_layout="paged"`` with ``kv_block_size`` / ``kv_num_blocks``
    sizes the slot cache :func:`~tpudist_torch.models.generate._blank_cache`
    builds for it as a block pool (the serve path's side buffers,
    ``serve_side_slots > 0``, are then required).  ``tp_axis`` over
    ``mesh`` builds this process's shard of the Megatron layout (the
    module docstring): parameters at the shard's shapes, the logits
    whole on every process of the axis."""

    def __init__(self, cfg: TransformerConfig, *,
                 attention_fn: AttentionFn = sdpa, remat: bool = False,
                 param_dtype: torch.dtype | None = None,
                 serve_side_slots: int = 0, cache_layout: str = "dense",
                 kv_block_size: int = 0, kv_num_blocks: int = 0,
                 decode_shard: Any = None, tp_axis: str | None = None,
                 mesh=None, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.remat = remat
        self.kv_block_size, self.kv_num_blocks = kv_block_size, kv_num_blocks
        dt, pd = cfg.compute_dtype, param_dtype
        tp = self.tp = TensorParallel(tp_axis, mesh)
        if tp.group is None:
            self.tok_embed = Embed(cfg.vocab_size, cfg.embed_dim, cfg, pd,
                                   device)
        else:
            self.tok_embed = VocabParallelEmbed(
                cfg.vocab_size, cfg.embed_dim, cfg, pd, device, tp)
        self.pos_embed = Embed(cfg.max_seq_len, cfg.embed_dim, cfg, pd,
                               device)
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg, attention_fn, device, param_dtype=pd, tp=tp,
                         serve_side_slots=serve_side_slots,
                         cache_layout=cache_layout,
                         kv_block_size=kv_block_size,
                         kv_num_blocks=kv_num_blocks,
                         decode_shard=decode_shard)
            for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.embed_dim, dt, device)
        tp.check(cfg.vocab_size, "vocab_size")
        self.lm_head = Dense(cfg.embed_dim, cfg.vocab_size // tp.size, cfg,
                             pd, device)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights drawn from ``generator`` (on the model's device)
        with flax's default initializers: truncated-normal Dense kernels of
        std 1/sqrt(fan_in), normal embeddings of std 1/sqrt(embed_dim),
        LayerNorm scale 1 and bias 0.  Drawn in f32, then cast."""
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                std = 1.0 / math.sqrt(p.shape[1])
                w = torch.empty(p.shape, device=p.device)
                if "embed" in name:
                    w.normal_(0.0, std, generator=generator)
                else:
                    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                p.copy_(w)
        return self

    def forward(self, tokens: torch.Tensor, *,
                positions: torch.Tensor | None = None,
                cache: list[dict] | None = None, causal: bool = True):
        if cache is not None and self.tp.group is not None:
            raise NotImplementedError(_TP_DECODE_TODO)
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        x = self.tok_embed(tokens) + self.pos_embed(positions)
        for i, blk in enumerate(self.blocks):
            if cache is not None:
                x = blk(x, causal, cache[i])
            elif self.remat:
                x = torch.utils.checkpoint.checkpoint(blk, x, causal,
                                                      use_reentrant=False)
            else:
                x = blk(x, causal)
        logits = self.lm_head(self.tp.enter(self.ln_f(x)))
        if self.tp.group is not None:
            logits = self.tp.join(logits, -1)
        logits = logits.float()
        return logits if cache is None else (logits, cache)
