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
backward.  On a CPU tensor it runs the block-free plain PyTorch version of
the same function (``_flash_forward_plain``, :func:`flash_block_grads_plain`).
There is no fallback from the first to the second.

The JAX functions' ``block_q``/``block_k``/``interpret`` arguments are not
carried over: tiles are the kernels' own choice (64 query rows or keys).
"""

from __future__ import annotations

import ctypes

import torch

from tpudist_torch.ops import _cuda

_NEG_BIG = -1e30
# Sentinel distinguishing "caller didn't pass window" (the factory's window
# applies) from an explicit window=None (full causal attention).
_UNSET = object()
_RING_TODO = ("flash_block_grads with an explicit delta (the ring backward's "
              "dQ kernel B7) is not ported yet (ROADMAP Queue A: parallel "
              "strategies, ring_attention)")

_c_ll = ctypes.c_longlong
FLASH_FORWARD = _cuda.Kernel(
    "flash_attention", "tpudist_flash_forward",
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [_c_ll] * 12
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
# K3 (dQ and Δ) and K4 (dK, dV) share one argument list: dtype; q k v dO
# O lse delta dQ dK dV; B Sq Sk H Hkv D; the (b, s, h) strides of q k v dO
# O dQ dK dV; q/k offsets, causal, window; scale; stream
_BWD_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
             + [_c_ll] * 24 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])
FLASH_BWD_DQ = _cuda.Kernel("flash_attention_bwd", "tpudist_flash_bwd_dq",
                            _BWD_ARGS)
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


def _flash_forward_plain(q, k, v, causal=True, *, q_offset=0, k_offset=0,
                         window=None):
    """The plain version: the whole ``[B, H, Sq, Sk]`` score matrix at
    once, with the kernel's numerics — f32 scores, masked entries ``-inf``,
    the running max floored at ``-1e30`` (a fully masked row gives zeros
    and an LSE of about ``-1e30``), probabilities rounded to the value
    dtype before ``P·V``, f32 accumulation."""
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
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
    out = (o / l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
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
    offs = []
    for name, off in (("q_offset", q_offset), ("k_offset", k_offset)):
        if isinstance(off, torch.Tensor):
            if off.numel() != 1 or off.device != q.device:
                raise ValueError(f"{name} must be an int or a one-element "
                                 f"tensor on {q.device}")
            offs += [off.reshape(()).to(torch.int32), 0]
        else:
            offs += [None, int(off)]
    FLASH_FORWARD(
        _DTYPES[q.dtype], _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v),
        _cuda.ptr(out), _cuda.ptr(lse), b, sq, sk, h, h_kv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3],
        _cuda.ptr(offs[0]), offs[1], _cuda.ptr(offs[2]), offs[3],
        int(bool(causal)), int(window) if (causal and window) else 0,
        d ** -0.5, _cuda.stream_handle(q.device))
    return out, lse


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


def _bwd_launch(kernel, q, k, v, dout, out, lse, delta, dq, dk, dv, *,
                causal, q_offset, k_offset, window) -> None:
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    strides = []
    for t in (q, k, v, dout, out, dq, dk, dv):
        strides += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    kernel(_DTYPES[q.dtype], *(_cuda.ptr(t) for t in (
        q, k, v, dout, out, lse, delta, dq, dk, dv)),
        b, sq, sk, h, h_kv, d, *strides, int(q_offset), int(k_offset),
        int(bool(causal)), int(window) if (causal and window) else 0,
        d ** -0.5, _cuda.stream_handle(q.device))


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


def _flash_bwd_dkv(q, k, v, dout, lse, delta, *, causal, q_offset=0,
                   k_offset=0, window=None):
    """Kernel K4: ``(dk, dv)``, each summed over the KV head's group of
    query heads inside one block (no atomics)."""
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
    kernel K4 (dK, dV).  ``delta`` given is the ring backward's route
    (the Pallas ``_flash_bwd_dq_kernel``), which has no kernel here yet:
    it raises on CUDA.  On CPU tensors: :func:`flash_block_grads_plain`,
    which takes either.  Offsets are ints on the kernel path."""
    if q.device.type == "cpu":
        return flash_block_grads_plain(
            q, k, v, dout, lse, delta, causal=causal, q_offset=q_offset,
            k_offset=k_offset, window=window, out=out)
    if q.device.type != "cuda":
        raise ValueError(f"flash_block_grads runs on cuda or cpu, got "
                         f"{q.device}")
    if delta is not None:
        raise NotImplementedError(_RING_TODO)
    if out is None:
        raise ValueError("flash_block_grads needs `out` when delta=None")
    if not (isinstance(q_offset, int) and isinstance(k_offset, int)):
        raise ValueError("flash_block_grads kernels take int offsets")
    _check_inputs("flash_block_grads", q, (("q", q), ("k", k), ("v", v),
                                           ("dout", dout), ("out", out)),
                  k, v)
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"dout/out shapes {tuple(dout.shape)}/"
                         f"{tuple(out.shape)} must equal q's "
                         f"{tuple(q.shape)}")
    b, sq, h, _ = q.shape
    if (lse.dtype != torch.float32 or lse.shape != (b, h, sq)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous [B, H, Sq] = "
                         f"{(b, h, sq)} float32 tensor on {q.device}")
    if b == 0 or sq == 0 or k.shape[1] == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset,
              window=window)
    dq, delta = _flash_bwd_dq(q, k, v, dout, out, lse, **kw)
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
