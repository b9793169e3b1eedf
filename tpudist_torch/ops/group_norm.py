"""GroupNorm (counterpart of :mod:`tpudist.ops.group_norm`).

Two paths, as in the JAX package, over NHWC ``[B, H, W, C]``:

* :func:`group_norm` — the closed form with tpudist's own gradient

      x̂  = (x − μ)·rstd,  g = dy·γ
      dx = rstd·(g − mean_G(g) − x̂·mean_G(g·x̂))
      dγ = Σ_{B,H,W} dy·x̂        dβ = Σ_{B,H,W} dy

  as a ``torch.autograd.Function``: f32 statistics, the variance as
  ``E[x²] − mean²``, eps inside the rsqrt, and ``x`` with the ``[B, G]``
  mean and rstd saved (not x̂).  Plain tensor ops, as tpudist leaves it to
  XLA: no kernel.
* :func:`group_norm_act` (``plain``, ``relu``) and
  :func:`group_norm_add_relu` (``relu(gn(x) + residual)``, the Bottleneck
  tail) — GroupNorm fused with its activation, one kernel per direction.
  On a CUDA tensor the forward is kernel K9 and the backward K10
  (``csrc/group_norm.cu``, the Hopper ports of the Pallas
  ``_fused_fwd_kernel`` and ``_fused_bwd_kernel``); on a CPU tensor their
  plain versions :func:`_fused_fwd_plain` and :func:`_fused_bwd_plain`.
  There is no fallback from the first to the second.  K10 recomputes the
  ReLU mask from the pre-activation, as the Pallas kernel does; the
  kernels and the plain versions evaluate it with one expression
  (:func:`_pre_activation`, ``csrc/group_norm.cuh``).

The kernels read memory as ``[B, H·W, C]``: their wrappers take
contiguous NHWC tensors and raise on any other layout (they never copy).
tpudist's 2 MB switch (``_slab_fits``: larger slabs take the closed form)
is a VMEM limit; K9 and K10 hold no slab on chip, so the fused modes take
them at any size.

:class:`GroupNorm` is the module: ``scale``/``bias`` of ``[C]``, eps 1e-6
(tpudist's, not torch's 1e-5), ``fused="none"|"relu"|"add_relu"``.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from tpudist_torch.ops import _cuda
from tpudist_torch.utils.device import resolve_device

GN_FWD = _cuda.Kernel(
    "group_norm", "tpudist_group_norm_fwd",
    # dtype mode; x res scale bias part y mean rstd; b hw c groups splits;
    # eps; stream
    [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p])
GN_BWD = _cuda.Kernel(
    "group_norm", "tpudist_group_norm_bwd",
    # dtype mode; x dy res scale bias mean rstd part_dscale part_dbias dx
    # dres; b hw c groups splits; stream
    [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
    + [ctypes.c_void_p])

MODES = {"plain": 0, "relu": 1, "add_relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_VECTORS = 512      # 16-byte vectors in a row of C channels
_ELEMS_PER_CTA = 8192       # the kernels' target work per CTA


# ---- the closed form -------------------------------------------------------

def _stats(x32: torch.Tensor, groups: int, eps: float):
    """``[B, G]`` mean and rstd of ``x32`` (``[B, ..., C]`` f32) over all
    but the batch axis and each group's channels."""
    b, c = x32.shape[0], x32.shape[-1]
    xg = x32.reshape(b, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3))
    var = xg.square().mean(dim=(1, 3)) - mean.square()
    return mean, torch.rsqrt(var + eps)


def _expand(v: torch.Tensor, shape, groups: int) -> torch.Tensor:
    """``[B, G]`` group statistic -> broadcastable ``[B, 1, ..., 1, C]``."""
    b, c = shape[0], shape[-1]
    return v.repeat_interleave(c // groups, dim=1).reshape(
        b, *([1] * (len(shape) - 2)), c)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or f64 where it is f64: the closed form's statistics
    are f32 as tpudist's, and an f64 input (which tpudist never sees, JAX
    having x64 off) keeps its precision."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


class _GroupNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        x32 = _wide(x)
        mean, rstd = _stats(x32, groups, eps)
        xhat = (x32 - _expand(mean, x.shape, groups)) * _expand(
            rstd, x.shape, groups)
        ctx.groups = groups
        ctx.save_for_backward(x, mean, rstd, scale)
        return (xhat * scale.float() + bias.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, scale = ctx.saved_tensors
        groups, shape = ctx.groups, x.shape
        b, c = shape[0], shape[-1]
        n = x[0].numel() // groups
        x32, dy32 = _wide(x), _wide(dy)
        rstd_c = _expand(rstd, shape, groups)
        xhat = (x32 - _expand(mean, shape, groups)) * rstd_c
        g = dy32 * scale.float()
        m1 = g.reshape(b, -1, groups, c // groups).sum(dim=(1, 3)) / n
        m2 = (g * xhat).reshape(b, -1, groups, c // groups).sum(
            dim=(1, 3)) / n
        dx = (rstd_c * (g - _expand(m1, shape, groups)
                        - xhat * _expand(m2, shape, groups))).to(x.dtype)
        axes = tuple(range(x.dim() - 1))
        dscale = (dy32 * xhat).sum(dim=axes).to(scale.dtype)
        dbias = dy32.sum(dim=axes).to(scale.dtype)
        return dx, dscale, dbias, None, None


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """Normalize ``x`` [B, H, W, C] over (H, W, C/groups) per group; affine
    ``scale``/``bias`` are [C].  Stats in f32 (f64 for an f64 ``x``),
    output in ``x.dtype``."""
    return _GroupNorm.apply(x, scale, bias, groups, eps)


# ---- K9 and K10's plain versions ------------------------------------------

def _pre_activation(x32, mean_c, rstd_c, scale, bias, res32):
    """``(x̂, pre)``: ``x̂ = (x − mean)·rstd`` and ``pre = x̂·γ + β (+
    res)``, each op rounded to f32 in this order — the expression K9 and
    K10 evaluate (``csrc/group_norm.cuh``), so the ReLU masks agree."""
    xhat = (x32 - mean_c) * rstd_c
    pre = xhat * scale + bias
    if res32 is not None:
        pre = pre + res32
    return xhat, pre


def _group_sum(v: torch.Tensor, groups: int) -> torch.Tensor:
    """``[B, HW, C]`` -> ``[B, G]`` sums over rows and each group's
    channels."""
    b, _, c = v.shape
    return v.reshape(b, -1, groups, c // groups).sum(dim=(1, 3))


def _fused_fwd_plain(x3, scale, bias, res3, groups: int, eps: float,
                     mode: str):
    """K9's plain version over ``x3 [B, HW, C]``: ``(y, mean, rstd)``,
    ``y`` in x's dtype, ``mean``/``rstd`` ``[B, G]`` f32."""
    x32 = x3.float()
    mean, rstd = _stats(x32, groups, eps)
    _, pre = _pre_activation(
        x32, _expand(mean, x3.shape, groups), _expand(rstd, x3.shape, groups),
        scale.float(), bias.float(), None if res3 is None else res3.float())
    if mode != "plain":
        pre = torch.relu(pre)
    return pre.to(x3.dtype), mean, rstd


def _fused_bwd_plain(x3, dy3, scale, bias, mean, rstd, res3, groups: int,
                     mode: str):
    """K10's plain version: ``(dx, part_dscale, part_dbias, dres)`` with
    the per-sample ``[B, C]`` partials of ``Σ dym·x̂`` and ``Σ dym``
    (``dym``: dy masked by ``pre > 0`` in the ReLU modes) and ``dres``
    (``None`` outside add_relu)."""
    b, hw, c = x3.shape
    n = hw * (c // groups)
    x32, dy32 = x3.float(), dy3.float()
    rstd_c = _expand(rstd, x3.shape, groups)
    xhat, pre = _pre_activation(
        x32, _expand(mean, x3.shape, groups), rstd_c, scale.float(),
        bias.float(), None if res3 is None else res3.float())
    if mode != "plain":
        dy32 = torch.where(pre > 0.0, dy32, 0.0)
    g = dy32 * scale.float()
    m1 = _group_sum(g, groups) / n
    m2 = _group_sum(g * xhat, groups) / n
    dx = rstd_c * (g - _expand(m1, x3.shape, groups)
                   - xhat * _expand(m2, x3.shape, groups))
    dres = dy32.to(res3.dtype) if mode == "add_relu" else None
    return (dx.to(x3.dtype), (dy32 * xhat).sum(dim=1), dy32.sum(dim=1),
            dres)


# ---- the kernel wrappers ---------------------------------------------------

def _splits(hw: int, c: int) -> int:
    """CTAs per sample: about ``_ELEMS_PER_CTA`` elements each, whole
    rows, none empty."""
    want = max(1, min(hw, -(-hw * c // _ELEMS_PER_CTA)))
    rows = -(-hw // want)
    return -(-hw // rows)


def _check_layout(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """A kernel operand: contiguous NHWC of x's shape, dtype and device
    (its memory is then ``[B, H·W, C]``)."""
    if t.shape != like.shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(like.shape)}")
    if not t.is_contiguous():
        raise ValueError(
            f"{name} must be contiguous NHWC ([B, H·W, C] in memory); got "
            f"strides {t.stride()} for shape {tuple(t.shape)} (a "
            f"channels-first tensor seen as NHWC is not)")
    _cuda.check_cuda_tensor(name, t.view(t.shape[0], -1, t.shape[-1]),
                            like.dtype, like.device, 3)


def _check_kernel_args(x, groups: int, mode: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"group_norm kernels run on cuda or cpu, got "
                         f"{x.device}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"group_norm kernels take float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, c = x.shape[0], x.shape[-1]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if c * x.element_size() > 16 * _MAX_ROW_VECTORS:
        raise ValueError(f"group_norm kernels take rows of at most "
                         f"{16 * _MAX_ROW_VECTORS} bytes, got C={c} of "
                         f"{x.dtype}")
    if b > 65535:
        raise ValueError(f"group_norm kernels take at most 65535 samples, "
                         f"got {b}")


def _affine(t: torch.Tensor, c: int, device) -> torch.Tensor:
    """``scale``/``bias`` as the kernels read them: ``[C]`` f32."""
    if t.shape != (c,) or t.device != device:
        raise ValueError(f"scale/bias must be [{c}] on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.float().contiguous()


def _fused_call_fwd(x, scale, bias, residual, groups: int, eps: float,
                    mode: str):
    """``(y, mean, rstd)`` of the fused forward over NHWC ``x``: kernel K9
    on CUDA tensors, :func:`_fused_fwd_plain` on CPU tensors."""
    if (residual is not None) != (mode == "add_relu"):
        raise ValueError("residual must be given exactly in add_relu mode")
    b, h, w, c = x.shape
    if x.device.type == "cpu":
        y, mean, rstd = _fused_fwd_plain(
            x.reshape(b, h * w, c), scale, bias,
            None if residual is None else residual.reshape(b, h * w, c),
            groups, eps, mode)
        return y.reshape(x.shape), mean, rstd
    _check_kernel_args(x, groups, mode)
    _check_layout("x", x, x)
    if residual is not None:
        _check_layout("residual", residual, x)
    splits = _splits(h * w, c)
    part = torch.empty(b * splits * groups * 2, dtype=torch.float32,
                       device=x.device)
    y = torch.empty_like(x)
    mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    GN_FWD(_DTYPES[x.dtype], MODES[mode], _cuda.ptr(x), _cuda.ptr(residual),
           _cuda.ptr(_affine(scale, c, x.device)),
           _cuda.ptr(_affine(bias, c, x.device)), _cuda.ptr(part),
           _cuda.ptr(y), _cuda.ptr(mean), _cuda.ptr(rstd), b, h * w, c,
           groups, splits, float(eps), _cuda.stream_handle(x.device))
    return y, mean, rstd


def _fused_call_bwd(x, dy, scale, bias, mean, rstd, residual, groups: int,
                    mode: str):
    """``(dx, dscale, dbias, dres)`` of the fused backward: kernel K10 on
    CUDA tensors, :func:`_fused_bwd_plain` on CPU tensors; the partials
    of ``dscale``/``dbias`` are summed here (``dres`` is ``None`` outside
    add_relu)."""
    if (residual is not None) != (mode == "add_relu"):
        raise ValueError("residual must be given exactly in add_relu mode")
    b, h, w, c = x.shape
    if x.device.type == "cpu":
        dx, pds, pdb, dres = _fused_bwd_plain(
            x.reshape(b, h * w, c), dy.reshape(b, h * w, c), scale, bias,
            mean, rstd,
            None if residual is None else residual.reshape(b, h * w, c),
            groups, mode)
        dx = dx.reshape(x.shape)
        if dres is not None:
            dres = dres.reshape(x.shape)
    else:
        _check_kernel_args(x, groups, mode)
        _check_layout("x", x, x)
        _check_layout("dy", dy, x)
        if residual is not None:
            _check_layout("residual", residual, x)
        for name, t in (("mean", mean), ("rstd", rstd)):
            if t.shape != (b, groups) or t.dtype != torch.float32 \
                    or not t.is_contiguous() or t.device != x.device:
                raise ValueError(f"{name} must be contiguous [{b}, {groups}] "
                                 f"f32 on {x.device}")
        splits = _splits(h * w, c)
        pds = torch.empty((b * splits, c), dtype=torch.float32,
                          device=x.device)
        pdb = torch.empty_like(pds)
        dx = torch.empty_like(x)
        dres = torch.empty_like(x) if mode == "add_relu" else None
        GN_BWD(_DTYPES[x.dtype], MODES[mode], _cuda.ptr(x), _cuda.ptr(dy),
               _cuda.ptr(residual), _cuda.ptr(_affine(scale, c, x.device)),
               _cuda.ptr(_affine(bias, c, x.device)), _cuda.ptr(mean),
               _cuda.ptr(rstd), _cuda.ptr(pds), _cuda.ptr(pdb), _cuda.ptr(dx),
               _cuda.ptr(dres), b, h * w, c, groups, splits,
               _cuda.stream_handle(x.device))
        dx = dx.reshape(x.shape)
    return (dx, pds.sum(dim=0).to(scale.dtype),
            pdb.sum(dim=0).to(bias.dtype), dres)


# ---- the fused ops under autograd ------------------------------------------

class _GroupNormAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, mode):
        if mode not in ("plain", "relu"):
            raise ValueError(f"group_norm_act mode must be 'plain' or "
                             f"'relu', got {mode!r}")
        y, mean, rstd = _fused_call_fwd(x, scale, bias, None, groups, eps,
                                        mode)
        ctx.groups, ctx.mode = groups, mode
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        # autograd may hand over a gradient of another layout (a sum's
        # expanded ones); the kernel reads contiguous NHWC
        dx, dscale, dbias, _ = _fused_call_bwd(
            x, dy.contiguous(), scale, bias, mean, rstd, None, ctx.groups,
            ctx.mode)
        return dx, dscale, dbias, None, None, None


class _GroupNormAddRelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, residual, groups, eps):
        y, mean, rstd = _fused_call_fwd(x, scale, bias, residual, groups,
                                        eps, "add_relu")
        ctx.groups = groups
        ctx.save_for_backward(x, scale, bias, mean, rstd, residual)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd, residual = ctx.saved_tensors
        dx, dscale, dbias, dres = _fused_call_bwd(
            x, dy.contiguous(), scale, bias, mean, rstd, residual,
            ctx.groups, "add_relu")
        return dx, dscale, dbias, dres, None, None


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int = 32, eps: float = 1e-6,
                   mode: str = "relu") -> torch.Tensor:
    """Fused ``act(group_norm(x))`` (``mode`` in {"plain", "relu"}): K9
    forward, K10 backward."""
    return _GroupNormAct.apply(x, scale, bias, groups, eps, mode)


def group_norm_add_relu(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, residual: torch.Tensor,
                        groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """Fused ``relu(group_norm(x) + residual)`` — the Bottleneck tail — in
    one kernel per direction; ``residual`` has x's shape and dtype."""
    return _GroupNormAddRelu.apply(x, scale, bias, residual, groups, eps)


# ---- the module ------------------------------------------------------------

class GroupNorm(nn.Module):
    """tpudist's ``GroupNorm`` twin (itself ``flax.linen.GroupNorm``'s):
    ``scale`` (ones) and ``bias`` (zeros) of ``[C]`` in ``param_dtype``,
    the output cast to ``dtype`` when given.

    ``fused``:
      * ``"none"`` — :func:`group_norm` (the closed form);
      * ``"relu"`` — ``relu(gn(x))`` through K9/K10;
      * ``"add_relu"`` — ``relu(gn(x) + residual)`` (pass ``residual``).
    Unlike tpudist there is no size switch: the kernels serve any slab.
    ``num_channels`` is torch's explicit form of the ``C`` that flax reads
    from the first input."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 epsilon: float = 1e-6, dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32,
                 fused: str = "none", device=None) -> None:
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"channels {num_channels} not divisible by "
                             f"num_groups {num_groups}")
        if fused not in ("none", "relu", "add_relu"):
            raise ValueError(f"unknown fused mode {fused!r}")
        device = resolve_device(device)
        self.num_groups, self.epsilon = num_groups, epsilon
        self.dtype, self.fused = dtype, fused
        self.scale = nn.Parameter(torch.ones(num_channels, dtype=param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, dtype=param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if x.shape[-1] != self.scale.shape[0]:
            raise ValueError(f"x has {x.shape[-1]} channels, the module "
                             f"{self.scale.shape[0]}")
        if (residual is not None) != (self.fused == "add_relu"):
            raise ValueError(
                f"residual must be passed exactly when fused='add_relu' "
                f"(got fused={self.fused!r})")
        g, eps = self.num_groups, self.epsilon
        if self.fused == "none":
            y = group_norm(x, self.scale, self.bias, g, eps)
        elif self.fused == "relu":
            y = group_norm_act(x, self.scale, self.bias, g, eps, "relu")
        else:
            y = group_norm_add_relu(x, self.scale, self.bias,
                                    residual.to(x.dtype), g, eps)
        return y if self.dtype is None else y.to(self.dtype)


GroupNormFast = GroupNorm  # explicit-intent alias
