"""Flash decode: one query token per head against the KV cache
(counterpart of :mod:`tpudist.ops.flash_decode`).

:func:`flash_decode` keeps the JAX function's contract: ``q [B, 1, H, D]``;
caches ``[B, S, Hkv, D]`` or packed ``[B, S, Hkv·D]`` with
``packed_kv_heads``; a scalar or per-row ``[B]`` ``cache_len``; an optional
side buffer whose first ``side_len`` positions are attended after the main
cache in the same softmax; a sliding ``window`` (scalar length only);
``return_lse``; and the multi-query ``s_q > 1`` form as repeated
single-query calls.  ``pos_offset`` makes the cache one slice of a
longer, sequence-sharded one: slot ``j`` holds global position
``pos_offset + j``, and ``cache_len`` and ``window`` stay global.

On a CUDA tensor it launches kernel K2 (``csrc/flash_decode.cu``, the
Hopper port of the Pallas ``_decode_kernel``: a split-K grid of
``_SPLIT_KEYS`` keys a split plus an LSE merge); on a CPU tensor it runs
:func:`flash_decode_plain`.  There is no fallback from the first to the
second.  :func:`_flash_decode_split_plain`
(and its paged and int8 forms) is the kernel's split walk and merge in
plain PyTorch, held against the JAX package on the CPU and against the
kernels on the card.

:func:`paged_flash_decode` is the same step against a paged block pool
read through a page table (kernel K5 on CUDA tensors,
:func:`paged_flash_decode_plain` — :func:`paged_gather_kv` then
:func:`flash_decode_plain` — on CPU tensors), and :func:`flash_decode_q8`
the same step over an int8 cache from :func:`quantize_kv` (kernel K6,
:func:`flash_decode_q8_plain`).  :func:`sp_flash_decode` is the
sequence-sharded step: each rank of a process group runs K2 on its slice
at ``pos_offset = rank · S_loc`` and the partial softmaxes merge by
log-sum-exp (one ``[B, H]`` all-gather, one all-reduce of the output).
"""

from __future__ import annotations

import ctypes

import torch

from tpudist_torch.ops import _cuda

_NEG_BIG = -1e30

_c_ll = ctypes.c_longlong
FLASH_DECODE = _cuda.Kernel(
    "flash_decode", "tpudist_flash_decode",
    [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
    + [_c_ll] * 16
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
       ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
PAGED_FLASH_DECODE = _cuda.Kernel(
    "flash_decode", "tpudist_paged_flash_decode",
    [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
    + [_c_ll] * 16
    + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
       ctypes.c_void_p])
FLASH_DECODE_Q8 = _cuda.Kernel(
    "flash_decode", "tpudist_flash_decode_q8",
    [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
    + [_c_ll] * 16
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
       ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 32


# keys a split of K2, K5 and K6 takes.  Every size the kernel is held at
# (_SPLIT_SIZES; it takes any multiple of 16 up to 256) was timed at
# twelve shapes of the port's callers (scripts/kernel_variants.py
# decode_splits; PERF.md): the fastest follows the live lengths, which
# only the device holds, and no rule over the shapes beat a fixed 128
# (one giving each SM 3 CTAs over the capacity lost up to 1.55x).  K5
# takes K2's, so the two split a row alike.
_SPLIT_KEYS = 128
_SPLIT_SIZES = (32, 64, 128, 256)


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


def _check_offset(pos_offset) -> None:
    """``pos_offset`` is one global position for the whole batch: an int
    or a 0-D tensor (the Pallas metadata carries a single offset)."""
    if isinstance(pos_offset, torch.Tensor) and pos_offset.dim() != 0:
        raise ValueError(f"pos_offset must be an int or a 0-D tensor, got "
                         f"shape {tuple(pos_offset.shape)}")


def _global_keep(s, cache_len, window, pos_offset, dev):
    """``[.., S]`` mask of the slots a query attends: slot ``j`` is global
    position ``pos_offset + j``, live below ``cache_len`` and, with a
    window, at or past ``cache_len - window``."""
    lens = torch.as_tensor(cache_len, device=dev).to(torch.long)
    lens = lens.reshape(-1, 1, 1, 1) if lens.dim() == 1 else lens
    pos = torch.arange(s, device=dev) + (
        pos_offset.to(device=dev, dtype=torch.long)
        if isinstance(pos_offset, torch.Tensor) else int(pos_offset))
    keep = pos < lens
    if window is not None:
        keep = keep & (pos >= lens - window)
    return keep


def _validate(q, k_cache, cache_len, window, side_k, packed_kv_heads,
              pos_offset=0):
    _check_offset(pos_offset)
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
                       side_len=0, packed_kv_heads=None, pos_offset=0):
    """The plain version of single-query :func:`flash_decode`: every
    position's score at once, with the kernel's numerics (f32 scores,
    ``-inf`` masking, max floored at ``-1e30``, probabilities rounded to
    the value dtype before ``P·V``).  A slice with no live position gives
    ``out = 0`` and ``lse = -1e30``."""
    b, _, h, d = q.shape
    k4 = _as_4d(k_cache, packed_kv_heads, d)
    v4 = _as_4d(v_cache, packed_kv_heads, d)
    s, h_kv = k4.shape[1], k4.shape[2]
    g = h // h_kv
    dev = q.device
    qf = q.float().reshape(b, h_kv, g, d)
    scale = d ** -0.5
    keep = _global_keep(s, cache_len, window, pos_offset, dev)
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


def _split_walk(qf, k, v, keep, ck, *, k_weight, p_dtype, v_weight=None):
    """The split pass and merge of K2/K5/K6 in plain PyTorch: the keys of
    ``k``/``v`` ``[B, n·ck, Hkv, D]`` fall in ``n`` splits of ``ck``; a
    split's partial is its max ``m`` over its live keys (``keep [B|1,
    n·ck]``), ``l = Σ p`` and ``acc = Σ round(p)·v`` with ``p = exp(s -
    m)``, ``s = (q·k)·k_weight`` (a number or ``[B, Hkv, n·ck]``), P
    rounded to ``p_dtype`` — or, with ``v_weight [B, Hkv, n·ck]`` (K6),
    ``round_bf16(p·v_weight)`` while ``l`` sums the unscaled ``p``.  The
    merge, as ``decode_merge_kernel``: ``M = max(max_s m_s, -1e30)``, the
    live splits weighted ``exp(m_s - M)``, ``O = Σ w·acc / max(L,
    1e-30)``, ``LSE = M + log max(L, 1e-30)``; a dead split (no live key)
    adds nothing.  ``qf [B, Hkv, g, D]`` f32.  Returns ``(out [B, Hkv, g,
    D] f32, lse [B, Hkv, g])``."""
    b, sk, h_kv, d = k.shape
    n = sk // ck
    if isinstance(k_weight, torch.Tensor):
        k_weight = k_weight[:, :, None, :]
    sc = torch.einsum("bjgd,bsjd->bjgs", qf, k.float()) * k_weight
    sc = sc.masked_fill(~keep[:, None, None, :], float("-inf"))
    sc = sc.unflatten(-1, (n, ck))                      # [B, Hkv, g, n, ck]
    m = sc.amax(-1)
    live = m > float("-inf")
    p = torch.exp(sc - torch.where(live, m, torch.zeros_like(m))[..., None])
    l = p.sum(-1)
    if v_weight is not None:
        pv = (p * v_weight.unflatten(-1, (n, ck))[:, :, None]).to(
            torch.bfloat16)
    else:
        pv = p.to(p_dtype)
    acc = torch.einsum("bjgns,bnsjd->bjgnd", pv.float(),
                       v.float().unflatten(1, (n, ck)))
    big_m = m.amax(-1).clamp_min(_NEG_BIG)
    w = torch.where(live, torch.exp(m - big_m[..., None]),
                    torch.zeros_like(m))
    big_l = (l * w).sum(-1).clamp_min(1e-30)
    out = (acc * w[..., None]).sum(-2) / big_l[..., None]
    return out, big_m + torch.log(big_l)


def _pad_keys(x, n_keys):
    """``x [B, S, ...]`` zero-padded along S to ``n_keys``."""
    pad = n_keys - x.shape[1]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)


def _flash_decode_split_plain(q, k_cache, v_cache, cache_len, *, split_keys,
                              window=None, return_lse=False, side_k=None,
                              side_v=None, side_len=0, packed_kv_heads=None,
                              pos_offset=0):
    """Single-query :func:`flash_decode` as K2 walks it: the main cache in
    splits of ``split_keys`` keys (the last one ragged), the side buffer
    in splits of its own, each split's partial and the merge in split
    order as :func:`_split_walk` computes them.  ``split_keys`` is the
    wrappers' ``_SPLIT_KEYS``; with one split it is
    :func:`flash_decode_plain`."""
    b, _, h, d = q.shape
    k4 = _as_4d(k_cache, packed_kv_heads, d)
    v4 = _as_4d(v_cache, packed_kv_heads, d)
    s, h_kv = k4.shape[1], k4.shape[2]
    dev, ck = q.device, split_keys
    main = -(-s // ck) * ck
    keep = _global_keep(s, cache_len, window, pos_offset, dev).reshape(-1, s)
    keep = _pad_keys(keep.expand(b, s), main)
    keys, vals = _pad_keys(k4, main), _pad_keys(v4, main)
    if side_k is not None:
        sk4 = _as_4d(side_k, packed_kv_heads, d).to(k4.dtype)
        sv4 = _as_4d(side_v, packed_kv_heads, d).to(v4.dtype)
        cap = sk4.shape[1]
        side = -(-cap // ck) * ck
        sl = torch.as_tensor(side_len, device=dev).to(torch.long)
        side_keep = (torch.arange(cap, device=dev) < sl).expand(b, cap)
        keep = torch.cat([keep, _pad_keys(side_keep, side)], 1)
        keys = torch.cat([keys, _pad_keys(sk4, side)], 1)
        vals = torch.cat([vals, _pad_keys(sv4, side)], 1)
    qf = q.float().reshape(b, h_kv, h // h_kv, d)
    out, lse = _split_walk(qf, keys, vals, keep, ck, k_weight=d ** -0.5,
                           p_dtype=v4.dtype)
    out = out.reshape(b, 1, h, d).to(q.dtype)
    return (out, lse.reshape(b, h)) if return_lse else out


def _paged_flash_decode_split_plain(q, k_pool, v_pool, page_table, cache_len,
                                    *, split_keys, packed_kv_heads,
                                    side_k=None, side_v=None, side_len=0):
    """Single-query :func:`paged_flash_decode` as K5 walks it: K2's split
    walk (:func:`_flash_decode_split_plain`) over the gathered view."""
    return _flash_decode_split_plain(
        q, paged_gather_kv(k_pool, page_table),
        paged_gather_kv(v_pool, page_table), cache_len,
        split_keys=split_keys, side_k=side_k, side_v=side_v,
        side_len=side_len, packed_kv_heads=packed_kv_heads)


def _flash_decode_q8_split_plain(q, k_q8, k_scale, v_q8, v_scale, cache_len,
                                 *, split_keys, window=None,
                                 return_lse=False, pos_offset=0):
    """:func:`flash_decode_q8` as K6 walks it: splits of ``split_keys``
    keys with the int8 numerics of :func:`flash_decode_q8_plain`."""
    b, _, h, d = q.shape
    s, h_kv = k_q8.shape[1], k_q8.shape[2]
    dev, ck = q.device, split_keys
    main = -(-s // ck) * ck
    keep = _global_keep(s, cache_len, window, pos_offset, dev).reshape(-1, s)
    keep = _pad_keys(keep.expand(b, s), main)

    def per_key(scale):   # [B, S, Hkv, 1] -> [B, Hkv, main]
        return _pad_keys(scale[..., 0], main).permute(0, 2, 1)

    qf = q.to(torch.bfloat16).float().reshape(b, h_kv, h // h_kv, d)
    out, lse = _split_walk(qf, _pad_keys(k_q8, main), _pad_keys(v_q8, main),
                           keep, ck, k_weight=per_key(k_scale) * d ** -0.5,
                           p_dtype=torch.bfloat16,
                           v_weight=per_key(v_scale))
    out = out.reshape(b, 1, h, d).to(q.dtype)
    return (out, lse.reshape(b, h)) if return_lse else out


def _check_query(fn: str, q: torch.Tensor, h_kv: int) -> None:
    """What every decode kernel takes: f32 or bf16 queries (the cache type
    too, except K6's int8), a head_dim it was compiled for, at most
    ``_MAX_GROUP`` query heads per KV head, 16-byte-aligned rows."""
    h, d = q.shape[2], q.shape[3]
    if q.dtype not in _DTYPES:
        raise ValueError(f"{fn} kernel takes float32 or bfloat16 queries, "
                         f"got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{fn} kernel takes head_dim in {_HEAD_DIMS}, got "
                         f"{d}")
    if h // h_kv > _MAX_GROUP:
        raise ValueError(f"{fn} kernel takes at most {_MAX_GROUP} query "
                         f"heads per KV head, got {h // h_kv}")
    _cuda.check_cuda_tensor("q", q, q.dtype, q.device, 4)


def _device_int32(x, name, dev):
    """``x`` as a contiguous int32 tensor on ``dev`` (no implicit move
    between devices)."""
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    return x.to(torch.int32).contiguous()


def _length(x, name, dev):
    """A length argument as the kernels take it: ``(device int32 tensor |
    None, stride, immediate value)`` — a per-row ``[B]`` tensor has stride
    1, a 0-D tensor stride 0, an int travels by value."""
    if not isinstance(x, torch.Tensor):
        return None, 0, int(x)
    x = _device_int32(x, name, dev)
    return x, (1 if x.dim() == 1 else 0), 0


def _launch_kernel(q, k_cache, v_cache, cache_len, *, window, return_lse,
                   side_k, side_v, side_len, packed_kv_heads, pos_offset=0):
    """One K2 launch (split pass + merge) for single-query decode."""
    dev = q.device
    b, _, h, d = q.shape
    k4 = _as_4d(k_cache, packed_kv_heads, d)
    v4 = _as_4d(v_cache, packed_kv_heads, d)
    s, h_kv = k4.shape[1], k4.shape[2]
    _check_query("flash_decode", q, h_kv)
    for name, t in (("k_cache", k4), ("v_cache", v4)):
        _cuda.check_cuda_tensor(name, t, q.dtype, dev, 4)
        if t.shape != (b, s, h_kv, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(b, s, h_kv, d)}")
    split = _SPLIT_KEYS
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

    len_t, len_stride, len_val = _length(cache_len, "cache_len", dev)
    side_t, _, side_val = _length(side_len, "side_len", dev)
    off_t, _, off_val = _length(pos_offset, "pos_offset", dev)
    zeros = (0, 0, 0)
    FLASH_DECODE(
        _DTYPES[q.dtype], _cuda.ptr(q), _cuda.ptr(k4), _cuda.ptr(v4),
        _cuda.ptr(sk4), _cuda.ptr(sv4), _cuda.ptr(out), _cuda.ptr(lse),
        _cuda.ptr(m_part), _cuda.ptr(l_part), _cuda.ptr(acc_part),
        b, h, h_kv, d, s, cap, n_main, n_split, split,
        q.stride(0), q.stride(2), *k4.stride()[:3], *v4.stride()[:3],
        *(sk4.stride()[:3] if sk4 is not None else zeros),
        *(sv4.stride()[:3] if sv4 is not None else zeros),
        out.stride(0), out.stride(2),
        _cuda.ptr(len_t), len_stride, len_val, _cuda.ptr(side_t), side_val,
        _cuda.ptr(off_t), off_val,
        int(window) if window is not None else 0, d ** -0.5,
        _cuda.stream_handle(dev))
    return (out, lse) if return_lse else out


def flash_decode(q, k_cache, v_cache, cache_len, *, window=None,
                 return_lse=False, side_k=None, side_v=None, side_len=0,
                 packed_kv_heads=None, pos_offset=0):
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
      pos_offset: this buffer's first global position (an int or a 0-D
        tensor): slot ``j`` holds position ``pos_offset + j`` — one rank's
        slice of a sequence-sharded cache.  ``cache_len`` and ``window``
        stay global; a slice with no live position returns ``out = 0``
        and ``lse = -1e30``, which weighs nothing in an LSE merge.

    MULTI-QUERY (``s_q > 1``, side buffers required): query ``j`` sees the
    main cache at the per-row lengths plus side positions
    ``< side_len - (s_q - 1 - j)`` — ``s_q`` single-query calls.

    Returns ``[B, s_q, H, D]`` (plus ``[B, H]`` lse when requested).
    """
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_decode runs on cuda or cpu, got {q.device}")
    one = (_launch_kernel if q.device.type == "cuda"
           else flash_decode_plain)
    _validate(q, k_cache, cache_len, window, side_k, packed_kv_heads,
              pos_offset)
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
                packed_kv_heads=packed_kv_heads, pos_offset=pos_offset)
            for j in range(s_q)], dim=1)
    return one(q, k_cache, v_cache, cache_len, window=window,
               return_lse=return_lse, side_k=side_k, side_v=side_v,
               side_len=side_len, packed_kv_heads=packed_kv_heads,
               pos_offset=pos_offset)


# ---- paged KV: kernel K5 ----------------------------------------------------

def paged_gather_kv(pool: torch.Tensor, page_table: torch.Tensor
                    ) -> torch.Tensor:
    """Gather a paged pool into a contiguous per-slot view: ``[N, bs, F]``
    pool + ``[B, M]`` page table -> ``[B, M*bs, F]`` (slot ``b``'s logical
    position ``p`` lands at row ``p``).  The plain path's first half and
    the view K5 is held against on the card."""
    b, m = page_table.shape
    _, bs, flat = pool.shape
    return pool[page_table.reshape(-1).long()].reshape(b, m * bs, flat)


def paged_flash_decode_plain(q, k_pool, v_pool, page_table, cache_len, *,
                             packed_kv_heads, side_k=None, side_v=None,
                             side_len=0):
    """The plain version of single-query :func:`paged_flash_decode`:
    :func:`paged_gather_kv` of both pools, then :func:`flash_decode_plain`
    over the gathered view."""
    return flash_decode_plain(
        q, paged_gather_kv(k_pool, page_table),
        paged_gather_kv(v_pool, page_table), cache_len, side_k=side_k,
        side_v=side_v, side_len=side_len, packed_kv_heads=packed_kv_heads)


def _validate_paged(q, k_pool, page_table, cache_len, packed_kv_heads,
                    side_k):
    """The JAX function's contract errors, in its order."""
    b, _, h, d = q.shape
    if k_pool.dim() != 3:
        raise ValueError(f"paged pools are packed 3-D [N, block, Hkv*D]; "
                         f"got {tuple(k_pool.shape)}")
    _, block, flat = k_pool.shape
    h_kv = packed_kv_heads
    if flat != h_kv * d:
        raise ValueError(f"pool minor dim {flat} != H_kv*D = {h_kv * d}")
    if h % h_kv:
        raise ValueError(f"num_heads {h} not a multiple of kv heads {h_kv}")
    if block < 8 or block % 8:
        raise ValueError(f"block_size must be a multiple of 8, got {block}")
    if not isinstance(cache_len, torch.Tensor) or cache_len.dim() != 1 \
            or cache_len.shape[0] != b:
        shape = (tuple(cache_len.shape) if isinstance(cache_len, torch.Tensor)
                 else ())
        raise ValueError(f"paged decode takes per-row cache_len [B={b}]; "
                         f"got {shape}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be [B={b}, max_blocks]; got "
                         f"{tuple(page_table.shape)}")
    if side_k is not None and side_k.dim() != 3:
        raise ValueError("side buffers must be packed 3-D [B, cap, Hkv*D]")


def _launch_paged(q, k_pool, v_pool, page_table, cache_len, *,
                  packed_kv_heads, side_k, side_v, side_len):
    """One K5 launch (split pass through the page table + merge)."""
    dev = q.device
    b, _, h, d = q.shape
    h_kv = packed_kv_heads
    g = h // h_kv
    _check_query("paged_flash_decode", q, h_kv)
    bs = k_pool.shape[1]
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        _cuda.check_cuda_tensor(name, t, q.dtype, dev, 3)
        if t.shape != k_pool.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(k_pool.shape)}")
    kp4, vp4 = (t.unflatten(2, (h_kv, d)) for t in (k_pool, v_pool))
    table = _device_int32(page_table, "page_table", dev)
    m = table.shape[1]
    lens = _device_int32(cache_len, "cache_len", dev)
    split = _SPLIT_KEYS
    n_main = -(-(m * bs) // split)
    cap = 0
    sk4 = sv4 = None
    if side_k is not None:
        cap = side_k.shape[1]
        for name, t in (("side_k", side_k), ("side_v", side_v)):
            _cuda.check_cuda_tensor(name, t, q.dtype, dev, 3)
            if t.shape != (b, cap, h_kv * d):
                raise ValueError(f"{name} shape {tuple(t.shape)} != "
                                 f"{(b, cap, h_kv * d)}")
        sk4, sv4 = side_k.unflatten(2, (h_kv, d)), side_v.unflatten(2,
                                                                    (h_kv, d))
    n_split = n_main + -(-cap // split)
    m_part = torch.empty((b * h_kv, n_split, g), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b * h_kv, n_split, g, d), dtype=torch.float32,
                           device=dev)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=dev)
    side_t, _, side_val = _length(side_len, "side_len", dev)
    zeros = (0, 0, 0)
    PAGED_FLASH_DECODE(
        _DTYPES[q.dtype], _cuda.ptr(q), _cuda.ptr(k_pool),
        _cuda.ptr(v_pool), _cuda.ptr(side_k), _cuda.ptr(side_v),
        _cuda.ptr(out), _cuda.ptr(None), _cuda.ptr(m_part),
        _cuda.ptr(l_part), _cuda.ptr(acc_part), _cuda.ptr(table),
        b, h, h_kv, d, m, bs, cap, n_main, n_split, split,
        q.stride(0), q.stride(2), *kp4.stride()[:3], *vp4.stride()[:3],
        *(sk4.stride()[:3] if sk4 is not None else zeros),
        *(sv4.stride()[:3] if sv4 is not None else zeros),
        out.stride(0), out.stride(2), _cuda.ptr(lens), _cuda.ptr(side_t),
        side_val, d ** -0.5, _cuda.stream_handle(dev))
    return out


def paged_flash_decode(q, k_pool, v_pool, page_table, cache_len, *,
                       packed_kv_heads, side_k=None, side_v=None,
                       side_len=0):
    """One decode step of attention against a PAGED KV cache.

    K/V live in one block pool ``[num_blocks, block_size, Hkv·D]`` per
    layer and slot ``b``'s logical position ``p`` is
    ``pool[page_table[b, p // block_size], p % block_size]``.

    Args:
      q: ``[B, s_q, H, D]`` current-token queries.
      k_pool / v_pool: ``[num_blocks, block_size, Hkv·D]`` packed pools
        (``block_size`` a positive multiple of 8).
      page_table: ``[B, max_blocks]`` int32 pool indices; entries past a
        row's live blocks must hold a valid index (0) and are never
        followed.
      cache_len: ``[B]`` per-row valid lengths including the current
        token.
      packed_kv_heads: ``Hkv`` of the packed minor dim.
      side_k / side_v / side_len: the serve loop's segment-local staging
        (``[B, cap, Hkv·D]``), attended after the pool in the same
        softmax, as on :func:`flash_decode`.

    ``s_q > 1`` (side buffers required) is ``s_q`` single-query calls:
    query ``j`` sees side positions ``< side_len - (s_q - 1 - j)``.

    On a CUDA tensor it launches kernel K5; on a CPU tensor it runs
    :func:`paged_flash_decode_plain`.  Returns ``[B, s_q, H, D]``.
    """
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"paged_flash_decode runs on cuda or cpu, got "
                         f"{q.device}")
    s_q = q.shape[1]
    if s_q > 1:
        if side_k is None:
            raise ValueError(
                "multi-query paged_flash_decode needs side buffers "
                "(in-segment tokens stage there; the pool is frozen "
                "within a segment)")
        return torch.cat([
            paged_flash_decode(
                q[:, j:j + 1], k_pool, v_pool, page_table, cache_len,
                packed_kv_heads=packed_kv_heads, side_k=side_k,
                side_v=side_v, side_len=side_len - (s_q - 1 - j))
            for j in range(s_q)], dim=1)
    _validate_paged(q, k_pool, page_table, cache_len, packed_kv_heads,
                    side_k)
    one = (_launch_paged if q.device.type == "cuda"
           else paged_flash_decode_plain)
    return one(q, k_pool, v_pool, page_table, cache_len,
               packed_kv_heads=packed_kv_heads, side_k=side_k,
               side_v=side_v, side_len=side_len)


# ---- int8 KV: kernel K6 -----------------------------------------------------

def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of K/V:
    ``[..., D] -> (int8 [..., D], f32 scale [..., 1])`` with
    ``scale = max|x| / 127`` floored at 1e-8 and ``round(x / scale)``
    (half to even), elementwise f32 as in the JAX package.  Returns
    ``(k_q8, k_scale, v_q8, v_scale)``."""
    def q(x):
        x32 = x.float()
        scale = (x32.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
        return torch.round(x32 / scale).to(torch.int8), scale

    kq, ks = q(k)
    vq, vs = q(v)
    return kq, ks, vq, vs


def _validate_q8(q, k_q8, cache_len, window, pos_offset):
    b, s_q, h, d = q.shape
    _check_offset(pos_offset)
    if s_q != 1:
        raise ValueError("flash_decode_q8 consumes one query token")
    if k_q8.dim() != 4:
        raise ValueError("packed caches compose with the bf16 path only")
    if h % k_q8.shape[2]:
        raise ValueError(f"num_heads {h} not a multiple of kv heads "
                         f"{k_q8.shape[2]}")
    per_row = isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1
    if per_row and window is not None:
        raise ValueError(
            "per-row cache lengths compose with window=None only (the "
            "sliding-window trim needs one length for the whole batch)")
    if per_row and cache_len.shape[0] != b:
        raise ValueError(f"per-row cache_len has {cache_len.shape[0]} "
                         f"entries for batch {b}")


def flash_decode_q8_plain(q, k_q8, k_scale, v_q8, v_scale, cache_len, *,
                          window=None, return_lse=False, pos_offset=0):
    """The plain version of :func:`flash_decode_q8`, with the Pallas int8
    numerics: q rounded to bf16; scores ``(q·k_int8) · (k_scale · D^-½)``
    in f32; ``p = exp(s - m)``; the value product over
    ``round_bf16(p · v_scale)`` while the normalizer sums the unscaled
    ``p``."""
    b, _, h, d = q.shape
    s, h_kv = k_q8.shape[1], k_q8.shape[2]
    g = h // h_kv
    dev = q.device
    qf = q.to(torch.bfloat16).float().reshape(b, h_kv, g, d)
    keep = _global_keep(s, cache_len, window, pos_offset, dev)
    ks = (k_scale[..., 0] * d ** -0.5).permute(0, 2, 1)[:, :, None, :]
    sc = torch.einsum("bjgd,bsjd->bjgs", qf, k_q8.float()) * ks
    sc = sc.masked_fill(~keep, float("-inf"))
    m = sc.amax(dim=-1, keepdim=True).clamp_min(_NEG_BIG)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    vs = v_scale[..., 0].permute(0, 2, 1)[:, :, None, :]
    pv = (p * vs).to(torch.bfloat16).float()
    o = torch.einsum("bjgs,bsjd->bjgd", pv, v_q8.float()) / l
    out = o.reshape(b, 1, h, d).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).reshape(b, h)


def _launch_q8(q, k_q8, k_scale, v_q8, v_scale, cache_len, *, window,
               return_lse, pos_offset=0):
    """One K6 launch (split pass over int8 tiles + merge)."""
    dev = q.device
    b, _, h, d = q.shape
    s, h_kv = k_q8.shape[1], k_q8.shape[2]
    g = h // h_kv
    _check_query("flash_decode_q8", q, h_kv)
    for name, t in (("k_cache_q8", k_q8), ("v_cache_q8", v_q8)):
        _cuda.check_cuda_tensor(name, t, torch.int8, dev, 4)
        if t.shape != (b, s, h_kv, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(b, s, h_kv, d)}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.device != dev or t.dtype != torch.float32 \
                or t.shape != (b, s, h_kv, 1):
            raise ValueError(f"{name} must be float32 {(b, s, h_kv, 1)} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    split = _SPLIT_KEYS
    n_split = -(-s // split)
    m_part = torch.empty((b * h_kv, n_split, g), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b * h_kv, n_split, g, d), dtype=torch.float32,
                           device=dev)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, h), dtype=torch.float32, device=dev)
           if return_lse else None)
    len_t, len_stride, len_val = _length(cache_len, "cache_len", dev)
    off_t, _, off_val = _length(pos_offset, "pos_offset", dev)
    FLASH_DECODE_Q8(
        _DTYPES[q.dtype], _cuda.ptr(q), _cuda.ptr(k_q8), _cuda.ptr(k_scale),
        _cuda.ptr(v_q8), _cuda.ptr(v_scale), _cuda.ptr(out), _cuda.ptr(lse),
        _cuda.ptr(m_part), _cuda.ptr(l_part), _cuda.ptr(acc_part),
        b, h, h_kv, d, s, n_split, split,
        q.stride(0), q.stride(2), *k_q8.stride()[:3], *v_q8.stride()[:3],
        *k_scale.stride()[:3], *v_scale.stride()[:3],
        out.stride(0), out.stride(2),
        _cuda.ptr(len_t), len_stride, len_val, _cuda.ptr(off_t), off_val,
        int(window) if window is not None else 0, d ** -0.5,
        _cuda.stream_handle(dev))
    return (out, lse) if return_lse else out


def flash_decode_q8(q, k_cache_q8, k_scale, v_cache_q8, v_scale, cache_len,
                    *, window=None, pos_offset=0, return_lse=False):
    """:func:`flash_decode` over an int8 KV cache from :func:`quantize_kv`.

    Args:
      q: ``[B, 1, H, D]`` queries (bf16 or f32; rounded to bf16 for the
        score product, as the Pallas kernel does).
      k_cache_q8 / v_cache_q8: ``[B, S, Hkv, D]`` int8.
      k_scale / v_scale: ``[B, S, Hkv, 1]`` f32 per-(token, head) scales.
      cache_len, window, return_lse: as on :func:`flash_decode`.
      pos_offset: as on :func:`flash_decode` (a sequence-sharded int8
        cache).

    On a CUDA tensor it launches kernel K6; on a CPU tensor it runs
    :func:`flash_decode_q8_plain`.  Returns ``[B, 1, H, D]`` in
    ``q.dtype`` (plus ``[B, H]`` f32 lse when requested).
    """
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_decode_q8 runs on cuda or cpu, got "
                         f"{q.device}")
    _validate_q8(q, k_cache_q8, cache_len, window, pos_offset)
    one = _launch_q8 if q.device.type == "cuda" else flash_decode_q8_plain
    return one(q, k_cache_q8, k_scale, v_cache_q8, v_scale, cache_len,
               window=window, return_lse=return_lse, pos_offset=pos_offset)


# ---- sequence-sharded decode ------------------------------------------------

def lse_merge(out: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """Merge attention partials computed over disjoint key slices, one a
    process of ``group``, by log-sum-exp: ``out [B, s, H, D]`` with
    ``lse [B, H]`` (one query) or ``[B, H, s]``.  One all-gather of the
    LSE, one f32 all-reduce of the weighted outputs, then the cast back;
    no key or value moves.  A slice with no live key (``lse = -1e30``)
    weighs exactly zero; ``group=None`` is a group of one."""
    from tpudist_torch.parallel.common import all_gather, psum

    every = all_gather(lse[None], group, 0)              # [n, B, H(, s)]
    w = torch.exp(lse - torch.logsumexp(every, dim=0))
    w = w[:, None, :, None] if lse.dim() == 2 else w.transpose(1, 2)[
        ..., None]
    return psum(out.float() * w, group).to(out.dtype)


def sp_flash_decode(q, k_shard, v_shard, cache_len, group, *, window=None,
                    packed_kv_heads=None, plain=False):
    """Sequence-parallel flash decode: the KV cache's sequence dim is
    split over the processes of ``group`` (process ``i`` of ``n`` owns
    global slots ``[i·S_loc, (i+1)·S_loc)``).  Each runs
    :func:`flash_decode` (K2 on a CUDA tensor) on its slice at
    ``pos_offset = i·S_loc`` with global masking, and :func:`lse_merge`
    combines the partial softmaxes.  ``q`` is replicated; returns the
    replicated ``[B, 1, H, D]``.  ``plain`` runs
    :func:`flash_decode_plain` on the slice instead (the model's
    ``decode_attention="dense"``).  ``group=None`` is one process owning
    the whole cache."""
    import torch.distributed as dist

    rank = 0 if group is None else dist.get_rank(group)
    attend = flash_decode_plain if plain else flash_decode
    out, lse = attend(q, k_shard, v_shard, cache_len, window=window,
                      return_lse=True, packed_kv_heads=packed_kv_heads,
                      pos_offset=rank * k_shard.shape[1])
    return lse_merge(out, lse, group)
