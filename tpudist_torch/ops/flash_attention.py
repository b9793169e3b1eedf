"""Flash-attention forward (counterpart of :mod:`tpudist.ops.flash_attention`).

:func:`_flash_forward` keeps the JAX function's contract — ``[B, S, H, D]``
queries, ``[B, Sk, Hkv, D]`` keys/values (GQA by index), global
``q_offset``/``k_offset`` for the causal mask, an optional sliding
``window`` — and returns ``(out [B, Sq, H, D], lse [B, H, Sq] f32)``.

On a CUDA tensor it launches kernel K1 (``csrc/flash_attention.cu``, the
Hopper port of the Pallas ``_flash_kernel``); on a CPU tensor it runs
:func:`_flash_forward_plain`, the block-free PyTorch version of the same
function.  There is no fallback from the first to the second.

The autograd wrapper (``flash_attention``) and the backward kernels wait
for the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from tpudist_torch.ops import _cuda

_NEG_BIG = -1e30

_c_ll = ctypes.c_longlong
FLASH_FORWARD = _cuda.Kernel(
    "flash_attention", "tpudist_flash_forward",
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [_c_ll] * 12
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def _offset_positions(offset, n: int, device) -> torch.Tensor:
    """Global positions ``offset + [0, n)``; ``offset`` an int or a 0-D
    tensor (the cache index, read without a host sync)."""
    base = torch.arange(n, device=device)
    if isinstance(offset, torch.Tensor):
        return base + offset.to(device=device, dtype=torch.long)
    return base + int(offset)


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
        q_pos = _offset_positions(q_offset, sq, q.device)[:, None]
        k_pos = _offset_positions(k_offset, sk, q.device)[None, :]
        keep = k_pos <= q_pos
        if window is not None:
            keep = keep & (q_pos - k_pos < window)
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
    if q.dtype not in _DTYPES:
        raise ValueError(f"_flash_forward kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _cuda.check_cuda_tensor(name, t, q.dtype, q.device, 4)
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"_flash_forward kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {d}")
    if h % h_kv:
        raise ValueError(f"num_heads {h} not a multiple of kv heads {h_kv}")
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
            off = off.reshape(()).to(torch.int32)
            offs += [off, 0]
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
