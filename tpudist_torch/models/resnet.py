"""ResNet50, structured as pipeline stages (counterpart of
:mod:`tpudist.models.resnet`).

The reference's two-shard ResNet50 (``model_parallel_ResNet50.py:39-139``):
Bottleneck stacks with a 1x1-conv projection, split after layer2 — stage
1 = conv7x7/s2 + norm + relu + maxpool + layer1 (64×3) + layer2 (128×4,
s2), stage 2 = layer3 (256×6, s2) + layer4 (512×3, s2) + avgpool +
fc(2048→1000).  tpudist's choices, kept here: NHWC in and f32 logits out,
f32 parameters cast to ``compute_dtype`` at each use, GroupNorm by
default (the closed form, ``fused="none"``, as tpudist builds it), and an
arbitrary ``num_stages`` split at block granularity.

Layout: module interfaces are NHWC.  A convolution runs on the
``permute(0, 3, 1, 2)`` view of its input — an NHWC-contiguous tensor
seen as NCHW is channels_last — with channels_last weights, and returns
the NHWC view of its output, so no layout copy is made around it.

flax's ``"SAME"`` padding is computed per side: at an even input a
stride-2 3×3 conv pads (0, 1), which torch's symmetric ``padding`` cannot
express, so such a conv pads explicitly and convolves with padding 0.
Module and parameter names follow flax's call order (``Conv_j`` ->
``conv{j}``, ``GroupNorm_j``/``BatchNorm_j`` -> ``norm{j}``), so
:func:`tpudist_torch.models.convert.from_flax_resnet_params` maps a flax
tree leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.ops.batch_norm import BatchNorm
from tpudist_torch.ops.group_norm import GroupNorm
from tpudist_torch.utils.device import resolve_device
from tpudist_torch.utils.init import lecun_normal_

STAGE_SIZES = (3, 4, 6, 3)  # ResNet50 Bottleneck counts per layer group
STAGE_WIDTHS = (64, 128, 256, 512)
STEM_WIDTH = 64


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial axis: ``(before,
    after)``, the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, dtype=compute_dtype)`` over NHWC:
    the ``[out, in, kh, kw]`` weight is stored in f32 (channels_last) and
    cast at use.  ``padding`` is ``"SAME"`` or a symmetric pixel count."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: str | int = "SAME",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None) -> None:
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.zeros(
            c_out, c_in, k, k, device=device).contiguous(
                memory_format=torch.channels_last))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        pad = self.padding
        if pad == "SAME":
            (ht, hb), (wl, wr) = (_same_pads(n, self.k, self.stride)
                                  for n in xc.shape[2:])
            if ht == hb and wl == wr:
                pad = (ht, wl)
            else:
                xc = F.pad(xc, (wl, wr, ht, hb))
                pad = 0
        y = F.conv2d(xc, self.weight.to(self.compute_dtype),
                     stride=self.stride, padding=pad)
        return y.permute(0, 2, 3, 1)


class _FlaxGroupNorm(nn.Module):
    """``flax.linen.GroupNorm`` (``norm="group_flax"``, the autodiff
    baseline): ``var = max(0, E[x²] − mean²)``, ``y = (x − mean)·(rsqrt(var
    + eps)·γ) + β`` in f32, differentiated by autograd."""

    def __init__(self, c: int, groups: int = 32, epsilon: float = 1e-6,
                 dtype: torch.dtype | None = None, device=None) -> None:
        super().__init__()
        self.groups, self.epsilon, self.dtype = groups, epsilon, dtype
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        xg = x.float().reshape(b, -1, self.groups, c // self.groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg.square().mean(dim=(1, 3), keepdim=True)
               - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.reshape(
            self.groups, c // self.groups)
        y = ((xg - mean) * mul + self.bias.reshape(
            self.groups, c // self.groups)).reshape(x.shape)
        return y.to(self.dtype or torch.promote_types(x.dtype, y.dtype))


class _FlaxBatchNorm(nn.Module):
    """``flax.linen.BatchNorm(use_running_average=False, momentum=0.9)``
    (``norm="batch_flax"``, the autodiff baseline): per-channel statistics
    as :class:`_FlaxGroupNorm`'s, the running buffers updated with them."""

    def __init__(self, c: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 dtype: torch.dtype | None = None, device=None) -> None:
        super().__init__()
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(x.dim() - 1))
        x32 = x.float()
        mean = x32.mean(dim=axes)
        var = (x32.square().mean(dim=axes) - mean.square()).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) \
            + self.bias
        with torch.no_grad():
            m = self.momentum
            self.mean.mul_(m).add_((1 - m) * mean)
            self.var.mul_(m).add_((1 - m) * var)
        return y.to(self.dtype or torch.promote_types(x.dtype, y.dtype))


def _norm(norm: str, dtype: torch.dtype,
          device) -> Callable[[int], nn.Module]:
    """``channels -> module`` for each of tpudist's norms."""
    if norm == "group":   # the closed-form GroupNorm (fused="none")
        return lambda c: GroupNorm(c, 32, dtype=dtype,
                                   param_dtype=torch.float32, device=device)
    if norm == "group_flax":
        return lambda c: _FlaxGroupNorm(c, 32, dtype=dtype, device=device)
    if norm == "batch":   # statistics all-reduced over the world's processes
        return lambda c: BatchNorm(c, momentum=0.9, dtype=dtype,
                                   axis_name="data", device=device)
    if norm == "batch_local":
        return lambda c: BatchNorm(c, momentum=0.9, dtype=dtype,
                                   device=device)
    if norm == "batch_flax":
        return lambda c: _FlaxBatchNorm(c, momentum=0.9, dtype=dtype,
                                        device=device)
    if norm == "none":    # ablation/benchmark control: no normalization
        return lambda c: nn.Identity()
    raise ValueError(f"unknown norm {norm!r}")


class Bottleneck(nn.Module):
    """1x1 reduce → 3x3 → 1x1 expand (×4), post-norm, with a projection
    shortcut when the shape changes; ``relu(residual + y)``."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 norm: str = "group",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None) -> None:
        super().__init__()
        mk = _norm(norm, compute_dtype, device)
        out_c = features * 4
        kw = dict(compute_dtype=compute_dtype, device=device)
        self.conv0 = Conv(in_features, features, 1, **kw)
        self.norm0 = mk(features)
        self.conv1 = Conv(features, features, 3, strides, **kw)
        self.norm1 = mk(features)
        self.conv2 = Conv(features, out_c, 1, **kw)
        self.norm2 = mk(out_c)
        # flax names the projection's conv and norm after the y branch's
        # (Conv_3, GroupNorm_3): the converter relies on it
        self.needs_proj = in_features != out_c or strides != 1
        if self.needs_proj:
            self.conv3 = Conv(in_features, out_c, 1, strides, **kw)
            self.norm3 = mk(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm0(self.conv0(x)))
        y = F.relu(self.norm1(self.conv1(y)))
        y = self.norm2(self.conv2(y))
        residual = x
        if self.needs_proj:
            residual = self.norm3(self.conv3(x))
        return F.relu(residual + y)


class ResNetStem(nn.Module):
    """conv7x7/s2 + norm + relu + 3x3 maxpool/s2."""

    def __init__(self, norm: str = "group",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv0 = Conv(3, STEM_WIDTH, 7, 2, padding=3,
                          compute_dtype=compute_dtype, device=device)
        self.norm0 = _norm(norm, compute_dtype, device)(STEM_WIDTH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm0(self.conv0(x.to(self.compute_dtype))))
        # -inf padding, as flax's max_pool
        return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2,
                            padding=1).permute(0, 2, 3, 1)


class ResNetHead(nn.Module):
    """Global avgpool + fc(2048→num_classes); f32 logits."""

    def __init__(self, num_classes: int = 1000,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc = nn.Linear(STAGE_WIDTHS[-1] * 4, num_classes,
                            device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # jnp.mean of a bf16 array sums in f32 and rounds the mean
        # (an f64 model keeps f64 here and in its logits)
        x = x.to(torch.promote_types(x.dtype, torch.float32)).mean(
            dim=(1, 2)).to(x.dtype)
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.fc.weight.to(cd),
                        self.fc.bias.to(cd)).to(
                            torch.promote_types(cd, torch.float32))


@dataclasses.dataclass(frozen=True)
class _BlockSpecEntry:
    features: int
    strides: int


def _block_plan() -> list[_BlockSpecEntry]:
    plan = []
    for group, (count, width) in enumerate(zip(STAGE_SIZES, STAGE_WIDTHS)):
        for i in range(count):
            stride = 2 if (i == 0 and group > 0) else 1
            plan.append(_BlockSpecEntry(width, stride))
    return plan


def _in_features(plan: Sequence[_BlockSpecEntry], i: int) -> int:
    """Channels entering block ``i`` of ``plan``."""
    return STEM_WIDTH if i == 0 else plan[i - 1].features * 4


class ResNetSegment(nn.Module):
    """A contiguous run of Bottleneck blocks; optionally carries the stem
    (first segment) and the head (last segment).  ``in_features`` is the
    channel count entering the first block (the stem's 64 for the first
    segment)."""

    def __init__(self, blocks: Sequence[_BlockSpecEntry],
                 with_stem: bool = False, with_head: bool = False,
                 num_classes: int = 1000, norm: str = "group",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 in_features: int = STEM_WIDTH, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.stem = (ResNetStem(norm, compute_dtype, device) if with_stem
                     else None)
        chain = []
        for b in blocks:
            chain.append(Bottleneck(in_features, b.features, b.strides, norm,
                                    compute_dtype, device))
            in_features = b.features * 4
        self.blocks = nn.ModuleList(chain)
        self.head = (ResNetHead(num_classes, compute_dtype, device)
                     if with_head else None)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ResNetSegment":
        """Random weights drawn from ``generator`` (on the model's device)
        with flax's initializers: lecun_normal conv and Dense kernels
        (truncated normal, std sqrt(1 / fan_in)), zero Dense bias, norm
        scale 1 and bias 0."""
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                lecun_normal_(p, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem is not None:
            x = self.stem(x)
        x = x.to(self.compute_dtype)
        for block in self.blocks:
            x = block(x)
        if self.head is not None:
            x = self.head(x)
        return x


def resnet50_stages(num_stages: int = 2, num_classes: int = 1000,
                    norm: str = "group",
                    compute_dtype: torch.dtype = torch.bfloat16,
                    device=None) -> list[ResNetSegment]:
    """Split ResNet50's 16 Bottleneck blocks into ``num_stages``
    contiguous segments.  ``num_stages=2`` reproduces the reference split
    (blocks 0-6 = layer1+layer2 with the stem; blocks 7-15 = layer3+layer4
    with the head)."""
    plan = _block_plan()
    if num_stages == 2:
        cuts = [7]  # after layer2, the reference's split point
    else:
        per = -(-len(plan) // num_stages)
        cuts = [per * i for i in range(1, num_stages)]
    bounds = [0, *cuts, len(plan)]
    return [ResNetSegment(plan[bounds[s]:bounds[s + 1]],
                          with_stem=(s == 0),
                          with_head=(s == num_stages - 1),
                          num_classes=num_classes, norm=norm,
                          compute_dtype=compute_dtype,
                          in_features=_in_features(plan, bounds[s]),
                          device=device)
            for s in range(num_stages)]


class ResNet50(ResNetSegment):
    """The whole network as one segment (for single-device and pure-DP
    runs): NHWC images in, ``[B, num_classes]`` f32 logits out."""

    def __init__(self, num_classes: int = 1000, norm: str = "group",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None) -> None:
        super().__init__(_block_plan(), with_stem=True, with_head=True,
                         num_classes=num_classes, norm=norm,
                         compute_dtype=compute_dtype, device=device)
