"""The fused MoE expert MLP (counterpart of :mod:`tpudist.ops.moe_dispatch`).

:func:`fused_moe_mlp` keeps the JAX function's contract: ``x [T, d]``,
stacked expert weights ``w_up [E, d, f]`` / ``w_down [E, f, d]``, router
choices ``top_idx`` / ``top_vals [T, k]``; it returns ``[T, d]``, exact (no
capacity, no dropping).  The (token, choice) slots are sorted by expert
with each group's start padded to ``block_rows``
(:func:`tpudist_torch.models.moe._counting_sort`), so every block of
``block_rows`` sorted rows belongs to one expert; the grouped GEMM computes
``gelu(xs @ w_up[e]) @ w_down[e] * gate`` per block with the intermediate
kept on-chip, and the combine outside is a gather and a sum over choices.

On a CUDA tensor the grouped GEMM is kernel K7 (``csrc/moe_gmm.cu``, the
Hopper port of the Pallas ``_gmm_kernel``); a shape it cannot serve
raises.  K7 has two paths, chosen by dtype and shape (:func:`gmm_variant`):
``wgmma`` for bf16 at ``block_rows`` a multiple of 64 and ``d`` 256 or
512, ``mma.sync`` for the rest.  Tiles past the groups' rows (the layout's
trailing pad blocks) are written as zeros without a product; their count
travels as a device scalar (:func:`_live_rows`), so no host sync is
added.  On a CPU tensor the grouped GEMM is the plain PyTorch version
:func:`_gmm_plain`.  There is no fallback from the first to the second.

The backward has no kernel, as in the JAX package: :class:`_FusedMoE`
rematerialises through the differentiable ragged path
(:func:`tpudist_torch.models.moe._ragged_moe`), one extra forward's FLOPs
for a trainable fused dispatch.  The JAX function's ``interpret`` argument
is not carried over.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpudist_torch.ops import _cuda

MOE_GMM = _cuda.Kernel(
    "moe_gmm", "tpudist_moe_gmm",
    # dtype; xs gate w_up w_down block_expert live_rows ys; np_pad d f e
    # block_rows; stream
    [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
    + [ctypes.c_void_p])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 512   # both paths' f32 accumulators cover at most 512 columns


def gmm_variant(dtype: torch.dtype, d: int, f: int, block_rows: int) -> str:
    """The path K7 takes on the card for this dtype and shape, as the
    kernel library decides it: ``"wgmma"`` or ``"mma.sync"`` (needs the
    built library)."""
    fn = _cuda.library("moe_gmm").tpudist_moe_gmm_variant
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    code = fn(_DTYPES.get(dtype, -1), d, f, block_rows)
    if code < 0:
        raise ValueError(f"K7 takes no path for {dtype}, d={d}, f={f}, "
                         f"block_rows={block_rows}")
    return "wgmma" if code == 1 else "mma.sync"


def _block_expert(starts: torch.Tensor, nb: int, e: int,
                  block_rows: int) -> torch.Tensor:
    """``[nb]`` int32 expert id of each block, as the JAX function builds
    it: one count per group start at its block (an expert with no rows
    shares its start with the next, so the block takes the later id),
    cumsum − 1, clipped to ``[0, e)`` (trailing pad blocks take
    ``e − 1``)."""
    idx = torch.clamp(starts // block_rows, max=nb - 1)
    ids = torch.zeros(nb, dtype=torch.int32, device=starts.device)
    ids.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return torch.clamp(torch.cumsum(ids, 0) - 1, 0, e - 1).to(torch.int32)


def _live_rows(group_sizes: torch.Tensor, block_rows: int) -> torch.Tensor:
    """The rows the padded groups cover, ``starts[-1] + padded[-1]``, as a
    0-D int32 tensor on the groups' device (no host sync): the blocks at
    or past it are the layout's trailing pad blocks, which hold no slot."""
    padded = (group_sizes + block_rows - 1) // block_rows * block_rows
    return padded.sum().to(torch.int32)


def _fused_layout(x, top_idx, top_vals, e: int, block_rows: int):
    """The kernel's inputs: ``(pos [N], xs [NP, d], gate [NP, 1] f32,
    block_expert [NP / block_rows] int32, live_rows)`` (:func:`_live_rows`).
    Pad slots gather row 0 and carry gate 0."""
    from tpudist_torch.models.moe import _counting_sort

    k = top_idx.shape[1]
    pos, order, sizes, starts, np_pad = _counting_sort(
        top_idx.reshape(-1), e, block_rows=block_rows)
    xs = x[order // k]                                   # slot -> token row
    gate = torch.zeros((np_pad, 1), dtype=torch.float32, device=x.device)
    gate[pos, 0] = top_vals.reshape(-1).float()
    block_expert = _block_expert(starts, np_pad // block_rows, e, block_rows)
    return pos, xs, gate, block_expert, _live_rows(sizes, block_rows)


def _expert_runs(block_expert: torch.Tensor) -> list[tuple[int, int]]:
    """``[(expert, number of blocks), ...]`` of the consecutive runs of
    one expert in ``block_expert`` (read on the host)."""
    experts, runs = torch.unique_consecutive(block_expert,
                                             return_counts=True)
    return list(zip(experts.tolist(), runs.tolist()))


def _gmm_plain(block_expert, xs, gate, w_up, w_down, block_rows: int, *,
               runs: list[tuple[int, int]] | None = None):
    """K7's plain version: for each run of blocks of one expert,
    ``round(gelu_tanh(xs @ w_up[e]) in f32)`` to the input dtype, then
    ``(h @ w_down[e]) * gate`` in f32, cast to the input dtype.  Products
    accumulate in f32.  ``runs`` (:func:`_expert_runs`) may be given to
    keep the host out of the call."""
    ys = torch.empty_like(xs)
    row = 0
    for ex, n in (_expert_runs(block_expert) if runs is None else runs):
        rows = slice(row, row + n * block_rows)
        h = F.gelu(xs[rows].float() @ w_up[ex].float(), approximate="tanh")
        y = (h.to(xs.dtype).float() @ w_down[ex].float()) * gate[rows]
        ys[rows] = y.to(xs.dtype)
        row += n * block_rows
    return ys


def _check_kernel_shapes(x, w_up, w_down, block_rows: int) -> None:
    """K7's constraints, raised as ``ValueError`` before any work.  Every
    call takes float32 or bfloat16, d_model a multiple of 16 up to 512,
    d_ff a multiple of 16 and block_rows a multiple of 8 (the mma.sync
    path's tiles: 16 rows, or 8 live rows of 16).  Within those, bfloat16
    at block_rows a multiple of 64 and d_model 256 or 512 takes the wgmma
    path (128-row tiles at multiples of 128, else 64; any such d_ff, the
    last chunk zero-filled)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_moe_mlp kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    d, (e, d_up, f) = x.shape[1], w_up.shape
    if d % 16 or d > _MAX_D:
        raise ValueError(f"fused_moe_mlp kernel takes d_model a multiple of "
                         f"16 up to {_MAX_D}, got {d}")
    if f % 16:
        raise ValueError(f"fused_moe_mlp kernel takes d_ff a multiple of "
                         f"16, got {f}")
    if block_rows <= 0 or block_rows % 8:
        raise ValueError(f"fused_moe_mlp kernel takes block_rows a "
                         f"multiple of 8, got {block_rows}")
    if d_up != d or tuple(w_down.shape) != (e, f, d):
        raise ValueError(f"w_up {tuple(w_up.shape)} / w_down "
                         f"{tuple(w_down.shape)} do not match x "
                         f"{tuple(x.shape)}")


def _gmm(block_expert, xs, gate, w_up, w_down, block_rows: int,
         live_rows: torch.Tensor):
    """The grouped GEMM: kernel K7 on CUDA tensors, :func:`_gmm_plain` on
    CPU tensors.  K7 writes the blocks at or past ``live_rows``
    (:func:`_live_rows`), the trailing pad blocks, as zeros without a
    product; the plain version computes them, at gate 0."""
    if xs.device.type == "cpu":
        return _gmm_plain(block_expert, xs, gate, w_up, w_down, block_rows)
    if xs.device.type != "cuda":
        raise ValueError(f"fused_moe_mlp runs on cuda or cpu, got "
                         f"{xs.device}")
    _check_kernel_shapes(xs, w_up, w_down, block_rows)
    np_pad, d = xs.shape
    e, _, f = w_up.shape
    for name, t, nd in (("xs", xs, 2), ("w_up", w_up, 3),
                        ("w_down", w_down, 3)):
        _cuda.check_cuda_tensor(name, t, xs.dtype, xs.device, nd)
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nb = np_pad // block_rows
    if np_pad % block_rows:
        raise ValueError(f"{np_pad} slot rows are not a multiple of "
                         f"block_rows={block_rows}")
    if (gate.dtype != torch.float32 or tuple(gate.shape) != (np_pad, 1)
            or gate.device != xs.device or not gate.is_contiguous()):
        raise ValueError(f"gate must be a contiguous [{np_pad}, 1] float32 "
                         f"tensor on {xs.device}")
    if (block_expert.dtype != torch.int32 or tuple(block_expert.shape)
            != (nb,) or block_expert.device != xs.device
            or not block_expert.is_contiguous()):
        raise ValueError(f"block_expert must be a contiguous [{nb}] int32 "
                         f"tensor on {xs.device}")
    if (live_rows.dtype != torch.int32 or live_rows.numel() != 1
            or live_rows.device != xs.device):
        raise ValueError(f"live_rows must be a one-element int32 tensor on "
                         f"{xs.device}")
    ys = torch.empty_like(xs)
    MOE_GMM(_DTYPES[xs.dtype], _cuda.ptr(xs), _cuda.ptr(gate),
            _cuda.ptr(w_up), _cuda.ptr(w_down), _cuda.ptr(block_expert),
            _cuda.ptr(live_rows), _cuda.ptr(ys), np_pad, d, f, e,
            block_rows, _cuda.stream_handle(xs.device))
    return ys


def _fused_moe_fwd_only(x, w_up, w_down, top_idx, top_vals,
                        block_rows: int):
    t, d = x.shape
    e = w_up.shape[0]
    k = top_idx.shape[1]
    pos, xs, gate, block_expert, live = _fused_layout(x, top_idx, top_vals,
                                                      e, block_rows)
    ys = _gmm(block_expert, xs, gate, w_up, w_down, block_rows, live)
    # combine: the gate is folded in already — gather + sum over choices
    return ys[pos].reshape(t, k, d).sum(1).to(x.dtype)


class _FusedMoE(torch.autograd.Function):
    """The port of the JAX ``custom_vjp`` (``_fused_fwd``/``_fused_bwd``):
    forward through the grouped GEMM, backward by rematerialisation
    through ``_ragged_moe`` (no backward kernel, as in the JAX package).
    Gradients for ``x``, ``w_up``, ``w_down`` and ``top_vals``; none for
    ``top_idx``."""

    @staticmethod
    def forward(ctx, x, w_up, w_down, top_idx, top_vals, block_rows):
        ctx.save_for_backward(x, w_up, w_down, top_idx, top_vals)
        return _fused_moe_fwd_only(x, w_up, w_down, top_idx, top_vals,
                                   block_rows)

    @staticmethod
    def backward(ctx, g):
        from tpudist_torch.models.moe import _ragged_moe

        x, w_up, w_down, top_idx, top_vals = ctx.saved_tensors
        leaves = [t.detach().requires_grad_()
                  for t in (x, w_up, w_down, top_vals)]
        with torch.enable_grad():
            out = _ragged_moe(leaves[0], leaves[1], leaves[2], top_idx,
                              leaves[3])
        dx, dwu, dwd, dtv = torch.autograd.grad(out, leaves, g)
        return dx, dwu, dwd, None, dtv, None


def fused_moe_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                  top_idx: torch.Tensor, top_vals: torch.Tensor, *,
                  block_rows: int = 128) -> torch.Tensor:
    """MoE MLP layer through the fused grouped GEMM (K7 on CUDA tensors).

    Same contract as :func:`tpudist_torch.models.moe._ragged_moe`.  Group
    starts are padded to ``block_rows``; pad slots carry gate 0 and their
    rows are never read by the combine.  Differentiable: the backward
    rematerialises through the ragged path."""
    return _FusedMoE.apply(x, w_up, w_down, top_idx, top_vals, block_rows)
