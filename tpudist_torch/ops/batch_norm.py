"""BatchNorm with tpudist's closed-form gradient (counterpart of
:mod:`tpudist.ops.batch_norm`).

Per-channel statistics over every axis but the last (NHWC: B, H, W), in
f32, the variance as ``E[x²] − mean²``:

    x̂  = (x − μ_c)·rstd_c,  g = dy·γ
    dx = rstd·(g − mean_c(g) − x̂·mean_c(g·x̂))
    dγ = Σ dy·x̂          dβ = Σ dy

:class:`BatchNorm` is ``flax.linen.BatchNorm``'s twin, as tpudist's is:
``scale``/``bias`` parameters, ``mean``/``var`` running buffers (tpudist's
``batch_stats``) updated with momentum 0.9, eps 1e-5.  With
``axis_name`` set, the batch statistics are averaged over the world's
processes under autograd (the DDP SyncBatchNorm story, tpudist's
plain-autodiff ``pmean`` branch); in a world of one process it is the
local branch.  Plain torch: no kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from tpudist_torch.utils.device import resolve_device


def _axes(x: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(x.dim() - 1))


class _BatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x32 = x.float()
        mean = x32.mean(dim=_axes(x))
        var = x32.square().mean(dim=_axes(x)) - mean.square()
        rstd = torch.rsqrt(var + eps)
        y = ((x32 - mean) * rstd * scale.float() + bias.float()).to(x.dtype)
        ctx.mark_non_differentiable(mean, var)
        ctx.save_for_backward(x, scale, mean, rstd)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        # the statistics are non-differentiable exports
        x, scale, mean, rstd = ctx.saved_tensors
        axes = _axes(x)
        n = x.numel() // x.shape[-1]
        x32, dy32 = x.float(), dy.float()
        xhat = (x32 - mean) * rstd
        g = dy32 * scale.float()
        m1 = g.sum(dim=axes) / n
        m2 = (g * xhat).sum(dim=axes) / n
        dx = (rstd * (g - m1 - xhat * m2)).to(x.dtype)
        dscale = (dy32 * xhat).sum(dim=axes).to(scale.dtype)
        dbias = dy32.sum(dim=axes).to(scale.dtype)
        return dx, dscale, dbias, None


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5):
    """Training-mode batch norm over NHWC (stats per channel, f32).

    Returns ``(y, mean, var)``; ``mean``/``var`` are NON-differentiable
    exports for the running-average update."""
    return _BatchNormTrain.apply(x, scale, bias, eps)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` twin backed by :func:`batch_norm_train`.

    ``axis_name`` (tpudist: the pmapped data axis): when set and the world
    has more than one process, the statistics are all-reduced over the
    world (a data-parallel run's data axis) under autograd.
    ``num_features`` is torch's explicit form of the ``C`` that flax
    reads from the first input."""

    def __init__(self, num_features: int, use_running_average: bool = False,
                 momentum: float = 0.9, epsilon: float = 1e-5,
                 dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32,
                 axis_name: str | None = None, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.use_running_average = use_running_average
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.axis_name = axis_name
        c = num_features
        self.scale = nn.Parameter(torch.ones(c, dtype=param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=param_dtype,
                                             device=device))
        self.register_buffer("mean", torch.zeros(c, dtype=torch.float32,
                                                 device=device))
        self.register_buffer("var", torch.ones(c, dtype=torch.float32,
                                               device=device))

    def _sync_groups(self) -> list:
        if self.axis_name is None:
            return []
        # imported here: the parallel package imports the models, which
        # import this module
        from tpudist_torch.parallel.data_parallel import axis_groups

        return axis_groups(None, [self.axis_name])

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.mean.mul_(m).add_((1 - m) * mean)
        self.var.mul_(m).add_((1 - m) * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias = self.scale.float(), self.bias.float()
        groups = [] if self.use_running_average else self._sync_groups()
        if self.use_running_average:
            rstd = torch.rsqrt(self.var + self.epsilon)
            y = ((x.float() - self.mean) * rstd * scale + bias).to(x.dtype)
        elif groups:
            # cross-process statistics stay on plain autodiff, as in
            # tpudist: the closed form treats its exported statistics as
            # constants, which would drop their gradient through the
            # all-reduce
            from torch.distributed import get_world_size
            from torch.distributed.nn.functional import all_reduce

            x32 = x.float()
            stats = torch.stack([x32.mean(dim=_axes(x)),
                                 x32.square().mean(dim=_axes(x))])
            for group in groups:
                stats = all_reduce(stats, group=group) / get_world_size(group)
            mean = stats[0]
            var = stats[1] - mean.square()
            rstd = torch.rsqrt(var + self.epsilon)
            y = ((x32 - mean) * rstd * scale + bias).to(x.dtype)
            self._update(mean.detach(), var.detach())
        else:
            y, mean, var = batch_norm_train(x, self.scale, self.bias,
                                            self.epsilon)
            self._update(mean, var)
        return y if self.dtype is None else y.to(self.dtype)
