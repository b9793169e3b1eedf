"""Flash decode: one query token per head against the KV cache
(counterpart of :mod:`tpudist.ops.flash_decode`).

:func:`flash_decode` keeps the JAX function's contract: ``q [B, 1, H, D]``;
caches ``[B, S, Hkv, D]`` or packed ``[B, S, Hkv·D]`` with
``packed_kv_heads``; a scalar or per-row ``[B]`` ``cache_len``; an optional
side buffer whose first ``side_len`` positions are attended after the main
cache in the same softmax; a sliding ``window`` (scalar length only);
``return_lse``; and the multi-query ``s_q > 1`` form as repeated
single-query calls.

On a CUDA tensor it launches kernel K2 (``csrc/flash_decode.cu``, the
Hopper port of the Pallas ``_decode_kernel``: a split-K grid plus an LSE
merge); on a CPU tensor it runs :func:`flash_decode_plain`.  There is no
fallback from the first to the second.

``paged_flash_decode``, ``flash_decode_q8`` and ``sp_flash_decode`` wait
for later slices.
"""

from __future__ import annotations

import ctypes

import torch

from tpudist_torch.ops import _cuda

_NEG_BIG = -1e30

_c_ll = ctypes.c_longlong
FLASH_DECODE = _cuda.Kernel(
    "flash_decode", "tpudist_flash_decode",
    [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
    + [_c_ll] * 16
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_void_p])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 32


def _split_keys() -> int:
    """Keys per split-K chunk, as the kernel library was compiled."""
    fn = _cuda.library("flash_decode").tpudist_flash_decode_split_keys
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def _as_4d(cache: torch.Tensor, packed_kv_heads: int | None, d: int):
    """``[B, S, Hkv, D]`` view of a 4-D or packed 3-D cache (no copy)."""
    if cache.dim() == 4:
        return cache
    if packed_kv_heads is None:
        raise ValueError("a 3-D packed cache needs packed_kv_heads=H_kv")
    if cache.shape[2] != packed_kv_heads * d:
        raise ValueError(f"packed cache minor dim {cache.shape[2]} != "
                         f"H_kv*D = {packed_kv_heads * d}")
    return cache.unflatten(2, (packed_kv_heads, d))


def _validate(q, k_cache, cache_len, window, side_k, packed_kv_heads):
    b, _, h, d = q.shape
    k4 = _as_4d(k_cache, packed_kv_heads, d)
    h_kv = k4.shape[2]
    if h % h_kv:
        raise ValueError(f"num_heads {h} not a multiple of kv heads {h_kv}")
    per_row = isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1
    if per_row and window is not None:
        raise ValueError(
            "per-row cache lengths compose with window=None only (the "
            "sliding-window trim needs one length for the whole batch)")
    if per_row and cache_len.shape[0] != b:
        raise ValueError(f"per-row cache_len has {cache_len.shape[0]} "
                         f"entries for batch {b}")
    if side_k is not None:
        if not per_row or window is not None:
            raise ValueError(
                "side buffers require per-row cache_len and window=None "
                "(the continuous-batching serve configuration)")
        if side_k.dim() != k_cache.dim():
            raise ValueError("side buffers must match the cache layout (both "
                             "packed 3-D or both [B, S, H_kv, D])")
    return per_row


def flash_decode_plain(q, k_cache, v_cache, cache_len, *, window=None,
                       return_lse=False, side_k=None, side_v=None,
                       side_len=0, packed_kv_heads=None):
    """The plain version of single-query :func:`flash_decode`: every
    position's score at once, with the kernel's numerics (f32 scores,
    ``-inf`` masking, max floored at ``-1e30``, probabilities rounded to
    the value dtype before ``P·V``)."""
    b, _, h, d = q.shape
    k4 = _as_4d(k_cache, packed_kv_heads, d)
    v4 = _as_4d(v_cache, packed_kv_heads, d)
    s, h_kv = k4.shape[1], k4.shape[2]
    g = h // h_kv
    dev = q.device
    qf = q.float().reshape(b, h_kv, g, d)
    scale = d ** -0.5
    lens = torch.as_tensor(cache_len, device=dev).to(torch.long)
    lens = lens.reshape(-1, 1, 1, 1) if lens.dim() == 1 else lens
    pos = torch.arange(s, device=dev)
    keep = pos < lens
    if window is not None:
        keep = keep & (pos >= lens - window)
    sc = torch.einsum("bjgd,bsjd->bjgs", qf, k4.float()) * scale
    sc = sc.masked_fill(~keep, float("-inf"))
    vals = v4
    if side_k is not None:
        sk4 = _as_4d(side_k, packed_kv_heads, d).to(k4.dtype)
        sv4 = _as_4d(side_v, packed_kv_heads, d).to(v4.dtype)
        sl = torch.as_tensor(side_len, device=dev).to(torch.long)
        side_keep = torch.arange(sk4.shape[1], device=dev) < sl
        ss = torch.einsum("bjgd,bsjd->bjgs", qf, sk4.float()) * scale
        sc = torch.cat([sc, ss.masked_fill(~side_keep, float("-inf"))], -1)
        vals = torch.cat([v4, sv4], dim=1)
    m = sc.amax(dim=-1, keepdim=True).clamp_min(_NEG_BIG)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bjgs,bsjd->bjgd", p.to(vals.dtype).float(),
                     vals.float()) / l
    out = o.reshape(b, 1, h, d).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).reshape(b, h)


def _launch_kernel(q, k_cache, v_cache, cache_len, *, window, return_lse,
                   side_k, side_v, side_len, packed_kv_heads):
    """One K2 launch (split pass + merge) for single-query decode."""
    dev = q.device
    b, _, h, d = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_decode kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_decode kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {d}")
    k4 = _as_4d(k_cache, packed_kv_heads, d)
    v4 = _as_4d(v_cache, packed_kv_heads, d)
    s, h_kv = k4.shape[1], k4.shape[2]
    if h // h_kv > _MAX_GROUP:
        raise ValueError(f"flash_decode kernel takes at most {_MAX_GROUP} "
                         f"query heads per KV head, got {h // h_kv}")
    _cuda.check_cuda_tensor("q", q, q.dtype, dev, 4)
    for name, t in (("k_cache", k4), ("v_cache", v4)):
        _cuda.check_cuda_tensor(name, t, q.dtype, dev, 4)
        if t.shape != (b, s, h_kv, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(b, s, h_kv, d)}")
    split = _split_keys()
    n_main = -(-s // split)
    cap = 0
    sk4 = sv4 = None
    if side_k is not None:
        sk4 = _as_4d(side_k, packed_kv_heads, d)
        sv4 = _as_4d(side_v, packed_kv_heads, d)
        cap = sk4.shape[1]
        for name, t in (("side_k", sk4), ("side_v", sv4)):
            _cuda.check_cuda_tensor(name, t, q.dtype, dev, 4)
            if t.shape != (b, cap, h_kv, d):
                raise ValueError(f"{name} shape {tuple(t.shape)} != "
                                 f"{(b, cap, h_kv, d)}")
    n_split = n_main + -(-cap // split)
    g = h // h_kv
    m_part = torch.empty((b * h_kv, n_split, g), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b * h_kv, n_split, g, d), dtype=torch.float32,
                           device=dev)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, h), dtype=torch.float32, device=dev)
           if return_lse else None)

    def length(x, name):
        """(device int32 tensor | None, stride, immediate value)"""
        if not isinstance(x, torch.Tensor):
            return None, 0, int(x)
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        x = x.to(torch.int32).contiguous()
        return x, (1 if x.dim() == 1 else 0), 0

    len_t, len_stride, len_val = length(cache_len, "cache_len")
    side_t, _, side_val = length(side_len, "side_len")
    zeros = (0, 0, 0)
    FLASH_DECODE(
        _DTYPES[q.dtype], _cuda.ptr(q), _cuda.ptr(k4), _cuda.ptr(v4),
        _cuda.ptr(sk4), _cuda.ptr(sv4), _cuda.ptr(out), _cuda.ptr(lse),
        _cuda.ptr(m_part), _cuda.ptr(l_part), _cuda.ptr(acc_part),
        b, h, h_kv, d, s, cap, n_main, n_split,
        q.stride(0), q.stride(2), *k4.stride()[:3], *v4.stride()[:3],
        *(sk4.stride()[:3] if sk4 is not None else zeros),
        *(sv4.stride()[:3] if sv4 is not None else zeros),
        out.stride(0), out.stride(2),
        _cuda.ptr(len_t), len_stride, len_val, _cuda.ptr(side_t), side_val,
        int(window) if window is not None else 0, d ** -0.5,
        _cuda.stream_handle(dev))
    return (out, lse) if return_lse else out


def flash_decode(q, k_cache, v_cache, cache_len, *, window=None,
                 return_lse=False, side_k=None, side_v=None, side_len=0,
                 packed_kv_heads=None):
    """One decode step of attention.

    Args:
      q: ``[B, s_q, H, D]`` — the current token's queries (``s_q`` > 1 is
        the speculative verify chunk, see below).
      k_cache / v_cache: ``[B, S, Hkv, D]``, or packed ``[B, S, Hkv·D]``
        with ``packed_kv_heads=Hkv``; slots ``>= cache_len`` are ignored.
      cache_len: valid positions INCLUDING the current token — an int, a
        0-D tensor, or a per-row ``[B]`` int tensor (the serve loop).
      window: attend to the last ``window`` positions only (scalar
        ``cache_len`` only).
      return_lse: also return the per-head log-sum-exp ``[B, H]`` f32.
      side_k / side_v / side_len: the serve loop's segment-local K/V
        staging (same layout as the cache), whose first ``side_len``
        positions are attended after the main cache in the same softmax.
        Requires per-row ``cache_len`` and ``window=None``.

    MULTI-QUERY (``s_q > 1``, side buffers required): query ``j`` sees the
    main cache at the per-row lengths plus side positions
    ``< side_len - (s_q - 1 - j)`` — ``s_q`` single-query calls.

    Returns ``[B, s_q, H, D]`` (plus ``[B, H]`` lse when requested).
    """
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_decode runs on cuda or cpu, got {q.device}")
    one = (_launch_kernel if q.device.type == "cuda"
           else flash_decode_plain)
    _validate(q, k_cache, cache_len, window, side_k, packed_kv_heads)
    s_q = q.shape[1]
    if s_q > 1:
        if side_k is None:
            raise ValueError(
                "multi-query flash_decode needs side buffers (the "
                "in-segment tokens' K/V staging); prefill-style chunks "
                "against the main cache go through the prefill kernel")
        if return_lse:
            raise ValueError(
                "return_lse composes with single-query decode only")
        return torch.cat([
            one(q[:, j:j + 1], k_cache, v_cache, cache_len, window=window,
                return_lse=False, side_k=side_k, side_v=side_v,
                side_len=side_len - (s_q - 1 - j),
                packed_kv_heads=packed_kv_heads)
            for j in range(s_q)], dim=1)
    return one(q, k_cache, v_cache, cache_len, window=window,
               return_lse=return_lse, side_k=side_k, side_v=side_v,
               side_len=side_len, packed_kv_heads=packed_kv_heads)
