"""Flash attention, forward and backward (counterpart of
:mod:`tpudist.ops.flash_attention`).

:func:`_flash_forward` keeps the JAX function's contract — ``[B, S, H, D]``
queries, ``[B, Sk, Hkv, D]`` keys/values (GQA by index), global
``q_offset``/``k_offset`` for the causal mask, an optional sliding
``window`` — and returns ``(out [B, Sq, H, D], lse [B, H, Sq] f32)``.
:func:`flash_block_grads` is its backward: ``(dQ, dK, dV)`` from the saved
``(q, k, v, out, lse)`` and the output gradient, with P recomputed from
the LSE and dS = P ∘ (dO·Vᵀ − Δ), Δ = rowsum(dO ∘ O).
:func:`flash_attention` ties the two into a ``torch.autograd.Function``,
and :func:`flash_attention_fn` is the model's ``attention_fn`` factory.

On a CUDA tensor each function launches its kernels: K1
(``csrc/flash_attention.cu``, the Hopper port of the Pallas
``_flash_kernel``) forward, then K3 and K4 (``csrc/flash_attention_bwd.cu``,
the ports of ``_flash_bwd_dq_fused_kernel`` and ``_flash_bwd_dkv_kernel``)
backward; with Δ given (the ring backward) K8, the port of
``_flash_bwd_dq_kernel``, takes K3's place.  On a CPU tensor it runs the
block-free plain PyTorch version of the same function
(``_flash_forward_plain``, :func:`flash_block_grads_plain`).
There is no fallback from the first to the second.

The JAX functions' ``block_q``/``block_k``/``interpret`` arguments are not
carried over: tiles are the kernels' own choice (64 query rows or keys).
Long walks over key tiles (K1, K3, K8) or query tiles (K4) are cut over
several CTAs by host planners from the shape and the card's SM count:
:func:`_fwd_plan` for K1 (never from Sq or the offsets, so a query row's
result does not depend on the prefill chunk it arrives in) and
:func:`_bwd_plan` for the backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpudist_torch.ops import _cuda

_NEG_BIG = -1e30
# Sentinel distinguishing "caller didn't pass window" (the factory's window
# applies) from an explicit window=None (full causal attention).
_UNSET = object()

_c_ll = ctypes.c_longlong
FLASH_FORWARD = _cuda.Kernel(
    "flash_attention", "tpudist_flash_forward",
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [_c_ll] * 12
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
# K3 (dQ and Δ), K8 (dQ from a given Δ) and K4 (dK, dV) share one argument
# list: dtype; q k v dO O lse delta dQ dK dV; B Sq Sk H Hkv D; the (b, s, h)
# strides of q k v dO O dQ dK dV; q/k offsets, causal, window; scale; the
# f32 partials dQ dK dV; splits, chunk; stream
_BWD_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
             + [_c_ll] * 24 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])
FLASH_BWD_DQ = _cuda.Kernel("flash_attention_bwd", "tpudist_flash_bwd_dq",
                            _BWD_ARGS)
FLASH_BWD_DQ_DELTA = _cuda.Kernel("flash_attention_bwd",
                                  "tpudist_flash_bwd_dq_delta", _BWD_ARGS)
FLASH_BWD_DKV = _cuda.Kernel("flash_attention_bwd", "tpudist_flash_bwd_dkv",
                             _BWD_ARGS)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def _offset_positions(offset, n: int, device) -> torch.Tensor:
    """Global positions ``offset + [0, n)``; ``offset`` an int or a 0-D
    tensor (the cache index, read without a host sync)."""
    base = torch.arange(n, device=device)
    if isinstance(offset, torch.Tensor):
        return base + offset.to(device=device, dtype=torch.long)
    return base + int(offset)


def _keep_mask(sq: int, sk: int, device, q_offset, k_offset, window):
    """``[Sq, Sk]`` boolean: key visible to query under the causal mask at
    global positions and, with ``window``, inside the band."""
    q_pos = _offset_positions(q_offset, sq, device)[:, None]
    k_pos = _offset_positions(k_offset, sk, device)[None, :]
    keep = k_pos <= q_pos
    if window is not None:
        keep = keep & (q_pos - k_pos < window)
    return keep


def _forward_partial_plain(q, k, v, causal, q_offset, k_offset, window):
    """``(o, m, l)``: the unnormalised f32 output ``[B, Sq, H, D]``, the
    row max of the scaled scores (floored at ``-1e30``) and the row sum of
    ``exp(s - m)`` (``[B, H, Sq]`` each), over the whole ``[B, H, Sq, Sk]``
    score matrix at once: masked scores ``-inf``, probabilities rounded to
    the value dtype before ``P·V``, f32 accumulation."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    group = h // h_kv
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * d ** -0.5
    if causal:
        keep = _keep_mask(sq, sk, q.device, q_offset, k_offset, window)
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_BIG)
    p = torch.exp(s - m)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
    return o, m[..., 0], p.sum(dim=-1)


def _flash_forward_plain(q, k, v, causal=True, *, q_offset=0, k_offset=0,
                         window=None):
    """The plain version: the whole ``[B, H, Sq, Sk]`` score matrix at
    once, with the kernel's numerics — f32 scores, masked entries ``-inf``,
    the running max floored at ``-1e30`` (a fully masked row gives zeros
    and an LSE of about ``-1e30``), probabilities rounded to the value
    dtype before ``P·V``, f32 accumulation."""
    o, m, l = _forward_partial_plain(q, k, v, causal, q_offset, k_offset,
                                     window)
    l = l.clamp_min(1e-30)
    out = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    return out, m + torch.log(l)


def _flash_forward_split_plain(q, k, v, causal=True, *, q_offset=0,
                               k_offset=0, window=None, plan):
    """K1's split walk as plain PyTorch: split s of ``plan`` takes the keys
    ``[s·chunk·64, (s+1)·chunk·64)`` (absolute key positions), its partial
    ``(o, m, l)`` over that slice at the slice's offset, and the partials
    are merged in split order by the log-sum-exp identity, as
    ``flash_fwd_merge_kernel`` merges them: ``M = max m_s``, ``L = Σ l_s
    e^(m_s − M)``, ``O = Σ o_s e^(m_s − M) / L``, ``LSE = M + log L``.  A
    split with no live key for a row (``m_s = −1e30``, ``l_s = 0``) adds
    nothing; a row with none gives O = 0 and LSE = −1e30.  One split is
    :func:`_flash_forward_plain`."""
    if plan.splits == 1:
        return _flash_forward_plain(q, k, v, causal, q_offset=q_offset,
                                    k_offset=k_offset, window=window)
    sk, width = k.shape[1], plan.chunk * _FWD_BK
    parts = [_forward_partial_plain(q, k[:, lo:lo + width],
                                    v[:, lo:lo + width], causal, q_offset,
                                    k_offset + lo, window)
             for lo in range(0, sk, width)]
    big_m = torch.stack([m for _, m, _ in parts]).amax(0)
    big_l = torch.zeros_like(big_m)
    o = torch.zeros(parts[0][0].shape, device=q.device)
    for o_s, m_s, l_s in parts:
        wt = torch.exp(m_s - big_m)
        big_l = big_l + l_s * wt
        o = o + o_s * wt.transpose(1, 2)[..., None]
    live = big_l > 0
    out = (o / big_l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(q.dtype)
    lse = torch.where(live, big_m + torch.log(big_l.clamp_min(1e-30)),
                      torch.full_like(big_m, _NEG_BIG))
    return out, lse


def _flash_forward(q, k, v, causal=True, *, q_offset=0, k_offset=0,
                   window=None):
    """Flash-attention forward: ``(out [B, Sq, H, D], lse [B, H, Sq] f32)``.

    ``q_offset``/``k_offset`` shift the causal mask to global positions
    (chunked prefill passes the cache index, a device scalar, as
    ``q_offset``); ``window`` keeps only keys with ``q_pos - k_pos <
    window`` and, as in the JAX kernel, applies only when ``causal``.
    K/V are read through their strides, so a packed ``[B, S, Hkv·D]``
    cache viewed as ``[B, S, Hkv, D]`` is read in place."""
    if q.device.type == "cpu":
        return _flash_forward_plain(q, k, v, causal, q_offset=q_offset,
                                    k_offset=k_offset, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"_flash_forward runs on cuda or cpu, got "
                         f"{q.device}")
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    _check_inputs("_flash_forward", q, (("q", q), ("k", k), ("v", v)), k, v)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if sq == 0 or b == 0:
        return out, lse
    _fwd_launch(q, k, v, out, lse, causal=causal, q_offset=q_offset,
                k_offset=k_offset, window=window,
                plan=_fwd_plan_for(q, k, causal=causal, window=window))
    return out, lse


def _fwd_launch(q, k, v, out, lse, *, causal, q_offset, k_offset, window,
                plan) -> None:
    """One K1 call under ``plan``: with ``plan.splits > 1`` the partials'
    workspace (``torch.empty``; the merge runs inside the same call)."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    offs = []
    for name, off in (("q_offset", q_offset), ("k_offset", k_offset)):
        if isinstance(off, torch.Tensor):
            if off.numel() != 1 or off.device != q.device:
                raise ValueError(f"{name} must be an int or a one-element "
                                 f"tensor on {q.device}")
            offs += [off.reshape(()).to(torch.int32), 0]
        else:
            offs += [None, int(off)]
    parts = [None, None]
    if plan.splits > 1:
        parts = [torch.empty((plan.splits, b, h, sq, n), dtype=torch.float32,
                             device=q.device) for n in (d, 2)]
    FLASH_FORWARD(
        _DTYPES[q.dtype], _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v),
        _cuda.ptr(out), _cuda.ptr(lse), b, sq, sk, h, h_kv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3],
        _cuda.ptr(offs[0]), offs[1], _cuda.ptr(offs[2]), offs[3],
        int(bool(causal)), int(window) if (causal and window) else 0,
        d ** -0.5, *(_cuda.ptr(t) for t in parts), plan.splits, plan.chunk,
        _cuda.stream_handle(q.device))


def _check_inputs(fn: str, q, tensors, k, v) -> None:
    """The kernels' common argument checks: dtype, device, layout, head
    dim, GQA divisibility and matching K/V shapes."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"{fn} kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    for name, t in tensors:
        _cuda.check_cuda_tensor(name, t, q.dtype, q.device, 4)
    b, _, h, d = q.shape
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{fn} kernel takes head_dim in {_HEAD_DIMS}, got "
                         f"{d}")
    if h % k.shape[2]:
        raise ValueError(f"num_heads {h} not a multiple of kv heads "
                         f"{k.shape[2]}")


# ---- backward --------------------------------------------------------------

def flash_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ∘ O) per query position, as ``[B, H, S]`` float32."""
    return (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_block_plain(q, k, v, dout, lse, delta, *, causal, q_offset=0,
                     k_offset=0, window=None):
    """The per-block backward math of the Pallas ``_bwd_block`` over the
    whole block at once: ``(p, ds)`` as ``[B, H, Sq, Sk]`` f32, with P
    recomputed as ``exp(s − lse)`` (masked scores ``-inf``, so P is 0
    there) and dS = P ∘ (dO·Vᵀ − Δ).  K/V are expanded to the query
    heads."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    group = h // h_kv
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * d ** -0.5
    if causal:
        keep = _keep_mask(sq, sk, q.device, q_offset, k_offset, window)
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vf)
    ds = p * (dp - delta[..., None])
    return p, ds


def _flash_bwd_dq_plain(q, k, v, dout, out, lse, *, causal, q_offset=0,
                        k_offset=0, window=None, delta=None):
    """K3's plain version: ``(dq, delta)``, Δ from ``out`` unless given.
    dS is rounded to q's dtype before ``dS·K``, the product accumulates in
    f32 and carries ``scale = D^-0.5``."""
    if delta is None:
        delta = flash_delta(out, dout)
    group = q.shape[2] // k.shape[2]
    _, ds = _bwd_block_plain(q, k, v, dout, lse, delta, causal=causal,
                             q_offset=q_offset, k_offset=k_offset,
                             window=window)
    kf = k.float().repeat_interleave(group, dim=2)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), kf)
    return (dq * q.shape[-1] ** -0.5).to(q.dtype), delta


def _flash_bwd_dkv_plain(q, k, v, dout, lse, delta, *, causal, q_offset=0,
                         k_offset=0, window=None):
    """K4's plain version: ``(dk, dv)`` summed over each KV head's group
    of query heads; dS is rounded to q's dtype before ``dSᵀ·Q`` and P to
    dO's dtype before ``Pᵀ·dO``; dK carries the scale."""
    b, _, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    p, ds = _bwd_block_plain(q, k, v, dout, lse, delta, causal=causal,
                             q_offset=q_offset, k_offset=k_offset,
                             window=window)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * d ** -0.5
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    dk = dk.reshape(b, sk, h_kv, h // h_kv, d).sum(3)
    dv = dv.reshape(b, sk, h_kv, h // h_kv, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_block_grads_plain(q, k, v, dout, lse, delta=None, *, causal,
                            q_offset=0, k_offset=0, window=None, out=None):
    """The plain version of :func:`flash_block_grads`: K3's and K4's plain
    versions in turn, with the kernels' rounding points (products
    accumulate in f32)."""
    if delta is None and out is None:
        raise ValueError("flash_block_grads needs `out` when delta=None")
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset,
              window=window)
    dq, delta = _flash_bwd_dq_plain(q, k, v, dout, out, lse, delta=delta,
                                    **kw)
    dk, dv = _flash_bwd_dkv_plain(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


# The backward kernels' tiles (csrc/flash_attention_bwd.cu): K3/K8 walk a
# 64-row q-tile's 64-key tiles, K4 a 64-key tile's (q-tile, group member)
# steps over q-tiles of _bwd_bq(D) rows
_BWD_ROWS = 64
# The planner splits a walk only where it would set the pace: when the
# longest walk is more than twice the card's fair share of all the steps
# (the total over _CTAS_PER_SM CTAs an SM), and then so that no CTA takes
# more than _SPLIT_STEPS tile steps.  A grid of several waves whose
# longest walks start first (the kernels order them so) is balanced
# already, and a split only adds its partials' traffic.  At D = 64 an SM
# holds 4 CTAs of K3/K8 and 2 of K4 (their registers); 3 is the value the
# H100 runs chose (scripts/flash_bwd_compare.py): it splits K4 at B=1,
# S=8192, 1.55x faster, and neither kernel at the training shape, where
# a split cost 8-10%.
_SPLIT_STEPS = 32
_CTAS_PER_SM = 3


def _bwd_bq(d: int) -> int:
    """K4's queries per step: 32 at head dim 128 (the register budget),
    64 below."""
    return 32 if d >= 128 else 64


def _dq_walks(sq, sk, q_offset, k_offset, causal, window):
    """``[(first key, key tiles)]`` that each 64-row q-tile of K3/K8 walks:
    from the window band's first tile to the causal limit (the kernels'
    ``dq_walk``)."""
    walks = []
    for q0 in range(0, sq, _BWD_ROWS):
        lo, hi = 0, sk
        if causal:
            hi = max(0, min(sk, q_offset + min(sq, q0 + _BWD_ROWS)
                            - k_offset))
            if window:
                lo = max(0, q_offset + q0 - (window - 1) - k_offset)
        lo = lo // _BWD_ROWS * _BWD_ROWS
        walks.append((lo, -(-(hi - lo) // _BWD_ROWS) if hi > lo else 0))
    return walks


def _dkv_walks(sq, sk, d, q_offset, k_offset, causal, window):
    """``[(first query, q-tiles)]`` that each 64-key tile of K4 walks, each
    q-tile once per member of the GQA group: from the causal diagonal to
    the window band's end (the kernels' ``dkv_walk``)."""
    bq = _bwd_bq(d)
    walks = []
    for k0 in range(0, sk, _BWD_ROWS):
        lo, hi = 0, sq
        if causal:
            lo = max(0, k_offset + k0 - q_offset)
            if window:
                hi = max(0, min(sq, k_offset + min(sk, k0 + _BWD_ROWS) - 1
                                + window - q_offset))
        lo = lo // bq * bq
        walks.append((lo, -(-(hi - lo) // bq) if hi > lo else 0))
    return walks


class BwdPlan(NamedTuple):
    """How many CTAs share one output tile's walk (``splits``) and how many
    steps each takes (``chunk``): split s takes steps ``[s·chunk,
    (s+1)·chunk)``.  K3 and K8 take the ``dq`` pair, K4 the ``dkv`` one."""
    dq_splits: int
    dq_chunk: int
    dkv_splits: int
    dkv_chunk: int


def _split(walks: list[int], heads: int, sm_count: int, steps: int):
    """``(splits, chunk)`` for output tiles whose walks take ``walks``
    steps each, ``heads`` times over."""
    longest = max(walks)
    fair = heads * sum(walks) / (_CTAS_PER_SM * sm_count)
    if longest <= steps or longest <= 2 * fair:
        return 1, max(longest, 1)
    splits = -(-longest // steps)
    return splits, -(-longest // splits)


@functools.lru_cache(maxsize=512)
def _bwd_plan(b, sq, sk, h, h_kv, d, *, causal, q_offset, k_offset, window,
              sm_count, steps=_SPLIT_STEPS) -> BwdPlan:
    """The backward kernels' split plan, from the shape, the offsets, the
    window and the card's SM count (never from data).  ``window`` counts
    only when ``causal``.  ``steps`` is the longest walk a split CTA may
    take (the tests shorten it to split small shapes)."""
    window = int(window) if (causal and window) else 0
    group = h // h_kv
    dq = [n for _, n in _dq_walks(sq, sk, q_offset, k_offset, causal,
                                  window)]
    dkv = [group * n for _, n in _dkv_walks(sq, sk, d, q_offset, k_offset,
                                            causal, window)]
    return BwdPlan(*_split(dq, b * h, sm_count, steps),
                   *_split(dkv, b * h_kv, sm_count, steps))


def _launch_split(kernel, plan: BwdPlan) -> tuple[int, int]:
    """``(splits, chunk)`` of one backward kernel: K3 and K8 take the
    same (one tiling, one split, one summation order), K4 its own."""
    if kernel is FLASH_BWD_DKV:
        return plan.dkv_splits, plan.dkv_chunk
    return plan.dq_splits, plan.dq_chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_plan_for(q, k, *, causal, q_offset=0, k_offset=0,
                  window=None) -> BwdPlan:
    """The plan K3, K8 and K4 take on these CUDA inputs."""
    b, sq, h, d = q.shape
    return _bwd_plan(b, sq, k.shape[1], h, k.shape[2], d,
                     causal=bool(causal), q_offset=int(q_offset),
                     k_offset=int(k_offset),
                     window=int(window) if (causal and window) else 0,
                     sm_count=_sm_count(q.device.index or 0))


# K1 walks a 64-row q-tile's 64-key tiles (csrc/flash_attention.cu)
_FWD_BK = 64


class FwdPlan(NamedTuple):
    """K1's split: ``splits`` CTAs share each q-tile's key walk, split s
    taking the key tiles ``[s·chunk, (s+1)·chunk)`` in absolute key
    positions (one split: the whole walk)."""
    splits: int
    chunk: int


@functools.lru_cache(maxsize=512)
def _fwd_plan(b, sk, h, *, causal, window, sm_count,
              steps=_SPLIT_STEPS) -> FwdPlan:
    """K1's split plan, from Sk, the window, the batch and query head
    counts and the card's SM count — never from Sq or the offsets, so that
    a query row's keys fall into the same splits, merged in the same
    order, whatever prefill chunk the row arrives in.  Not knowing Sq, it
    plans for the smallest call, one q-tile per (batch, head), whose walk
    is bounded by Sk (or the window's band): the backward's fair-share rule
    (:func:`_split`) then splits a walk longer than ``steps`` tiles when
    the B·H CTAs of one q-tile row leave the card short (B·H < 1.5 × SMs;
    a long query call fills it anyway, and then pays only the partials'
    traffic)."""
    window = int(window) if (causal and window) else 0
    tiles = max(1, -(-sk // _FWD_BK))
    walk = tiles
    if window:   # a q-tile's band spans 63 + window keys
        walk = min(tiles, -(-(window + _FWD_BK - 1) // _FWD_BK) + 1)
    splits, chunk = _split([walk], b * h, sm_count, steps)
    if splits == 1:
        return FwdPlan(1, tiles)
    return FwdPlan(-(-tiles // chunk), chunk)


def _fwd_plan_for(q, k, *, causal, window=None, sm_count=None) -> FwdPlan:
    """The plan K1 takes on these inputs (``sm_count``: the card's by
    default).  It takes no query length and no offsets."""
    if sm_count is None:
        sm_count = _sm_count(q.device.index or 0)
    return _fwd_plan(q.shape[0], k.shape[1], q.shape[2],
                     causal=bool(causal),
                     window=int(window) if (causal and window) else 0,
                     sm_count=sm_count)


def _bwd_launch(kernel, q, k, v, dout, out, lse, delta, dq, dk, dv, *,
                causal, q_offset, k_offset, window) -> None:
    """One K3, K8 or K4 call: the plan, the partials' workspace when it
    splits (its sum runs inside the same call), the launch."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    window = int(window) if (causal and window) else 0
    plan = _bwd_plan_for(q, k, causal=causal, q_offset=q_offset,
                         k_offset=k_offset, window=window)
    dkv = kernel is FLASH_BWD_DKV
    splits, chunk = _launch_split(kernel, plan)
    parts = [None, None, None]
    if splits > 1:
        shape = (splits, b, h_kv, sk, d) if dkv else (splits, b, h, sq, d)
        ws = [torch.empty(shape, dtype=torch.float32, device=q.device)
              for _ in range(2 if dkv else 1)]
        parts = [None] + ws if dkv else ws + [None, None]
    strides = []
    for t in (q, k, v, dout, out, dq, dk, dv):
        strides += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    kernel(_DTYPES[q.dtype], *(_cuda.ptr(t) for t in (
        q, k, v, dout, out, lse, delta, dq, dk, dv)),
        b, sq, sk, h, h_kv, d, *strides, int(q_offset), int(k_offset),
        int(bool(causal)), window, d ** -0.5,
        *(_cuda.ptr(t) for t in parts), splits, chunk,
        _cuda.stream_handle(q.device))


def _flash_bwd_dq(q, k, v, dout, out, lse, *, causal, q_offset=0,
                  k_offset=0, window=None):
    """Kernel K3: ``(dq, delta)``.  Δ is computed in the kernel from the
    dO and O tiles and written out as ``[B, H, Sq]`` f32 for K4."""
    b, sq, h, d = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _bwd_launch(FLASH_BWD_DQ, q, k, v, dout, out, lse, delta, dq, None,
                None, causal=causal, q_offset=q_offset, k_offset=k_offset,
                window=window)
    return dq, delta


def _flash_bwd_dq_delta(q, k, v, dout, lse, delta, *, causal, q_offset=0,
                        k_offset=0, window=None):
    """Kernel K8: ``dq`` from the caller's Δ (``[B, H, Sq]`` f32), with
    K3's tiling and summation order: fed the Δ K3 writes, K8's dQ is K3's
    bit for bit."""
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _bwd_launch(FLASH_BWD_DQ_DELTA, q, k, v, dout, None, lse, delta, dq,
                None, None, causal=causal, q_offset=q_offset,
                k_offset=k_offset, window=window)
    return dq


def _flash_bwd_dkv(q, k, v, dout, lse, delta, *, causal, q_offset=0,
                   k_offset=0, window=None):
    """Kernel K4: ``(dk, dv)``, each summed over the KV head's group of
    query heads; a walk the planner splits has its partials added in
    split order (no atomics)."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch(FLASH_BWD_DKV, q, k, v, dout, None, lse, delta, None, dk,
                dv, causal=causal, q_offset=q_offset, k_offset=k_offset,
                window=window)
    return dk, dv


def flash_block_grads(q, k, v, dout, lse, delta=None, *, causal,
                      q_offset=0, k_offset=0, window=None, out=None):
    """``(dQ, dK, dV)`` of one attention block given the final softmax
    statistics ``lse`` (``[B, H, Sq]`` f32) and ``out``.

    On CUDA tensors: kernel K3 (dQ, and Δ from the O and dO tiles) then
    kernel K4 (dK, dV).  ``delta`` given (``[B, H, Sq]`` f32, the ring
    backward's route, the Pallas ``_flash_bwd_dq_kernel``): kernel K8 (dQ
    from that Δ) then K4 with the same Δ; ``out`` is not needed then.  On
    CPU tensors: :func:`flash_block_grads_plain`, which takes either.
    Offsets are ints on the kernel path."""
    if q.device.type == "cpu":
        return flash_block_grads_plain(
            q, k, v, dout, lse, delta, causal=causal, q_offset=q_offset,
            k_offset=k_offset, window=window, out=out)
    if q.device.type != "cuda":
        raise ValueError(f"flash_block_grads runs on cuda or cpu, got "
                         f"{q.device}")
    if delta is None and out is None:
        raise ValueError("flash_block_grads needs `out` when delta=None")
    if not (isinstance(q_offset, int) and isinstance(k_offset, int)):
        raise ValueError("flash_block_grads kernels take int offsets")
    like_q = (("dout", dout),) + ((("out", out),) if delta is None else ())
    _check_inputs("flash_block_grads", q,
                  (("q", q), ("k", k), ("v", v)) + like_q, k, v)
    for name, t in like_q:
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} must equal "
                             f"q's {tuple(q.shape)}")
    b, sq, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32
                              or t.shape != (b, h, sq)
                              or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [B, H, Sq] = "
                             f"{(b, h, sq)} float32 tensor on {q.device}")
    if b == 0 or sq == 0 or k.shape[1] == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset,
              window=window)
    if delta is None:
        dq, delta = _flash_bwd_dq(q, k, v, dout, out, lse, **kw)
    else:
        dq = _flash_bwd_dq_delta(q, k, v, dout, lse, delta, **kw)
    dk, dv = _flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The port of the JAX ``custom_vjp`` (``_flash_fwd``/``_flash_bwd``):
    forward K1, saving ``(q, k, v, out, lse)``; backward K3 then K4."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _flash_forward(q, k, v, causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_block_grads(
            q, k, v, dout.contiguous(), lse, None, causal=ctx.causal,
            window=ctx.window, out=out)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Fused attention on ``[B, S, H, D]`` tensors, differentiable; a
    drop-in for :func:`tpudist_torch.models.transformer.sdpa` (the same
    ``AttentionFn`` contract).  K/V may carry fewer (grouped) heads.
    ``window`` enables sliding-window attention and requires
    ``causal=True``."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"num_heads {q.shape[2]} must be a multiple of kv heads "
            f"{k.shape[2]} (GQA)")
    if window is not None and (not causal or window < 1):
        raise ValueError(
            f"window={window} requires causal=True and window >= 1")
    return _FlashAttention.apply(q, k, v, causal, window)


def flash_attention_fn(window: int | None = None):
    """``AttentionFn`` factory for :class:`TransformerLM`:
    ``TransformerLM(cfg, attention_fn=flash_attention_fn())``.  The
    factory's window is published as ``attend.factory_window`` so the
    model rejects one that disagrees with ``cfg.attention_window``."""
    factory_window = window

    def attend(q, k, v, *, causal: bool = True, window=_UNSET):
        eff = factory_window if window is _UNSET else window
        return flash_attention(q, k, v, causal=causal, window=eff)

    attend.factory_window = factory_window
    return attend
