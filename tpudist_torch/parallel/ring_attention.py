"""Sequence parallelism: ring attention and Ulysses all-to-all (counterpart
of :mod:`tpudist.parallel.ring_attention`).

Each process of the mesh's sequence axis holds one block of the sequence,
``[B, S/n, H, D]``, in global order (process ``i`` of the axis holds
positions ``[i·S/n, (i+1)·S/n)``).  Three interchangeable strategies plug
into :class:`~tpudist_torch.models.transformer.TransformerLM` through its
``attention_fn`` hook:

* :func:`ring_attention_fn` — Q stays, K/V blocks travel the ring one hop
  a step and each step folds its block into an online softmax (plain
  PyTorch; autograd runs the ring backwards through :class:`_Rotate`).
* :func:`ulysses_attention_fn` — two all-to-alls trade the sharded
  sequence for a sharded head axis around exact full-sequence attention.
* :func:`ring_flash_attention_fn` — the ring with each block's work done
  by the flash kernels at global offsets (K1 forward; K8 and K4 backward
  against the ring's final LSE and Δ) and a backward ring of its own in
  which the dK/dV accumulators travel with their blocks back to their
  owner.  The production long-context path: memory linear in S.

tpudist's ``lax.scan`` bodies are the module-level step functions
(:func:`_ring_step`, :func:`_ring_flash_fwd_step`,
:func:`_ring_flash_bwd_step`); :func:`_ring_rotate` is the only code of the
ring that touches the process group.  Every factory takes the ``mesh``
whose ``axis_name`` is the sequence axis; without one the ring has one
process (tpudist's ring over a one-device axis).

:func:`make_sp_train_step` is the DP×SP train step over a ``data × seq``
mesh and :func:`sp_forward` its forward alone.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from tpudist_torch.models.transformer import repeat_kv, sdpa
from tpudist_torch.ops.flash_attention import (
    _UNSET,
    _flash_forward,
    _keep_mask,
    flash_block_grads,
    flash_delta,
)
from tpudist_torch.parallel.data_parallel import all_reduce_sum, axis_groups
from tpudist_torch.runtime.mesh import axis_index
from tpudist_torch.train.state import TrainState

_NEG_BIG = -1e30  # finite stand-in for -inf: keeps the online-softmax
                  # recurrence NaN-free on fully masked rows


def _seq_group(mesh, axis_name: str):
    """The process group of the sequence axis; None for a ring of one."""
    if mesh is not None:
        return mesh.get_group(axis_name)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise ValueError(
            f"sequence-parallel attention over {dist.get_world_size()} "
            f"processes needs the mesh whose {axis_name!r} axis it runs on "
            "(pass mesh=)")
    return None


def _ring_coords(group) -> tuple[int, int]:
    """``(n, my)``: the ring's size and this process's place on it."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _ring_rotate(tensors, group, reverse: bool = False) -> list:
    """Send each tensor to the next process of the ring (``my + 1``) and
    receive the previous one's (``my − 1``) in one ``batch_isend_irecv``:
    ``lax.ppermute`` with ``perm = [(i, i + 1 mod n)]``.  ``reverse``
    rotates the other way (the transpose, for autograd).  A ring of one
    returns its inputs."""
    n, my = _ring_coords(group)
    if n == 1:
        return list(tensors)
    step = -1 if reverse else 1
    dst = dist.get_global_rank(group, (my + step) % n)
    src = dist.get_global_rank(group, (my - step) % n)
    sends = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    ops = []
    for t, o in zip(sends, outs):
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, o, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """:func:`_ring_rotate` under autograd: the gradient of a rotation is
    the rotation the other way."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_ring_rotate(tensors, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_ring_rotate(grads, ctx.group, reverse=True))


# ---- the plain ring ---------------------------------------------------------

def _ring_step(qf, kb, vb, m, l, o, my: int, src: int, *, causal: bool,
               window):
    """One step of the plain ring: fold the resident K/V block (global
    block ``src``) into the online softmax ``(m, l, o)`` of this process's
    queries (block ``my``).  f32 throughout; masked logits are ``-inf``
    and the running max is floored at ``-1e30``."""
    s_loc = qf.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", qf,
                          kb.float()) * qf.shape[-1] ** -0.5
    if causal:
        keep = _keep_mask(s_loc, kb.shape[1], qf.device, my * s_loc,
                          src * s_loc, window)
        logits = logits.masked_fill(~keep, float("-inf"))
    new_m = torch.maximum(m, logits.amax(-1).clamp_min(_NEG_BIG))
    p = torch.exp(logits - new_m[..., None])
    corr = torch.exp(m - new_m)
    l = l * corr + p.sum(-1)
    o = o * corr.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, vb.float())
    return new_m, l, o


def ring_attention_fn(axis_name: str = "seq", *, mesh=None) -> Callable:
    """An ``AttentionFn`` computing exact attention over the sequence axis
    of ``mesh`` by rotating K/V around the ring (GQA K/V are expanded
    first; :func:`ring_flash_attention_fn` keeps them grouped)."""
    group = _seq_group(mesh, axis_name)

    def attend(q, k, v, *, causal: bool = True, window: int | None = None):
        if window is not None and not causal:
            raise ValueError("window requires causal=True")
        k, v = repeat_kv(q, k, v)
        n, my = _ring_coords(group)
        b, s_loc, h, d = q.shape
        qf = q.float()
        m = torch.full((b, h, s_loc), _NEG_BIG, device=q.device)
        l = torch.zeros((b, h, s_loc), device=q.device)
        o = torch.zeros((b, s_loc, h, d), device=q.device)
        kb, vb = k, v
        for step in range(n):
            m, l, o = _ring_step(qf, kb, vb, m, l, o, my, (my - step) % n,
                                 causal=causal, window=window)
            if step < n - 1:
                kb, vb = _Rotate.apply(group, kb, vb)
        denom = l.clamp_min(1e-30).transpose(1, 2)[..., None]
        return (o / denom).to(q.dtype)

    return attend


# ---- Ulysses ----------------------------------------------------------------

def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk ``j`` of dim 0 to process ``j`` of the group; the result's
    chunk ``i`` came from process ``i``."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``[B, S/n, H, D]`` -> ``[B, S, H/n, D]``: the whole sequence, this
    process's ``n``-th of the heads."""
    b, s, h, d = x.shape
    x = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    x = _all_to_all(x, group)
    return x.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse: ``[B, S, H/n, D]`` -> ``[B, S/n, H, D]``."""
    b, s, hn, d = x.shape
    x = x.reshape(b, n, s // n, hn, d).permute(1, 0, 2, 3, 4).contiguous()
    x = _all_to_all(x, group)
    return x.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hn, d)


class _Reshard(torch.autograd.Function):
    """One of the two all-to-alls under autograd; each is the other's
    transpose."""

    @staticmethod
    def forward(ctx, x, group, n, to_heads):
        ctx.group, ctx.n, ctx.to_heads = group, n, to_heads
        fn = _seq_to_heads if to_heads else _heads_to_seq
        return fn(x, group, n)

    @staticmethod
    def backward(ctx, g):
        fn = _heads_to_seq if ctx.to_heads else _seq_to_heads
        return fn(g.contiguous(), ctx.group, ctx.n), None, None, None


def ulysses_attention_fn(axis_name: str = "seq", *, mesh=None) -> Callable:
    """All-to-all sequence parallelism over the sequence axis of ``mesh``:
    trade the sharded sequence for sharded heads around an exact
    full-sequence :func:`sdpa`.  Needs ``num_heads % n == 0``; K/V stay
    grouped through the all-to-all when ``kv_heads % n == 0``."""
    group = _seq_group(mesh, axis_name)

    def attend(q, k, v, *, causal: bool = True, window: int | None = None):
        n, _ = _ring_coords(group)
        if n == 1:
            return sdpa(q, k, v, causal=causal, window=window)
        if q.shape[2] % n:
            raise ValueError(f"num_heads {q.shape[2]} not divisible by the "
                             f"sequence axis size {n}")
        if k.shape[2] % n:
            k, v = repeat_kv(q, k, v)
        qh, kh, vh = (_Reshard.apply(x, group, n, True) for x in (q, k, v))
        out = sdpa(qh, kh, vh, causal=causal, window=window)
        return _Reshard.apply(out, group, n, False)

    return attend


# ---- ring flash attention ---------------------------------------------------

def _rowstat(c: torch.Tensor) -> torch.Tensor:
    """``[B, H, S]`` row statistic -> ``[B, S, H, 1]``."""
    return c.transpose(1, 2)[..., None]


def _ring_flash_fwd_step(q, kb, vb, o, lse, my: int, src: int, *,
                         causal: bool, window):
    """One forward step: K1 on the resident block at global offsets
    (``my·S_loc`` for the queries, ``src·S_loc`` for the keys), its
    ``(out, lse)`` merged into the f32 accumulator ``o`` and the running
    ``lse`` by the log-sum-exp identity.  A block wholly in the queries'
    future gives O = 0 and an LSE of -1e30, which adds nothing."""
    s_loc = q.shape[1]
    ob, lse_b = _flash_forward(q, kb, vb, causal, q_offset=my * s_loc,
                               k_offset=src * s_loc, window=window)
    new_lse = torch.logaddexp(lse, lse_b)
    o = (o * _rowstat(torch.exp(lse - new_lse))
         + ob.float() * _rowstat(torch.exp(lse_b - new_lse)))
    return o, new_lse


def _ring_flash_bwd_step(q, kb, vb, dout, lse, delta, dq, dk, dv, my: int,
                         src: int, *, causal: bool, window):
    """One backward step: K8 (dQ from the ring's Δ) and K4 (dK, dV) on the
    resident block against the FINAL ``lse``, added in place to the f32
    accumulators ``dq`` (this process's) and ``dk``/``dv`` (the resident
    block's, which travel with it)."""
    s_loc = q.shape[1]
    dq_b, dk_b, dv_b = flash_block_grads(
        q, kb, vb, dout, lse, delta, causal=causal, q_offset=my * s_loc,
        k_offset=src * s_loc, window=window)
    dq.add_(dq_b)
    dk.add_(dk_b)
    dv.add_(dv_b)
    return dq, dk, dv


class _RingFlash(torch.autograd.Function):
    """The port of tpudist's ring-level ``custom_vjp``: forward ring of
    :func:`_ring_flash_fwd_step`, saving ``(q, k, v, out, lse)``; backward
    ring of :func:`_ring_flash_bwd_step` with Δ from the final output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, group):
        n, my = _ring_coords(group)
        b, s_loc, h, d = q.shape
        o = torch.zeros((b, s_loc, h, d), device=q.device)
        lse = torch.full((b, h, s_loc), _NEG_BIG, device=q.device)
        kb, vb = k, v
        for step in range(n):
            o, lse = _ring_flash_fwd_step(q, kb, vb, o, lse, my,
                                          (my - step) % n, causal=causal,
                                          window=window)
            if step < n - 1:
                kb, vb = _ring_rotate((kb, vb), group)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.group = causal, window, group
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        n, my = _ring_coords(ctx.group)
        dout = dout.contiguous()
        delta = flash_delta(out, dout)
        dq = torch.zeros(q.shape, device=q.device)
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        kb, vb = k, v
        for step in range(n):
            _ring_flash_bwd_step(q, kb, vb, dout, lse, delta, dq, dk, dv, my,
                                 (my - step) % n, causal=ctx.causal,
                                 window=ctx.window)
            # the accumulators ride home with their blocks; the blocks
            # themselves are not needed after the last step
            if step < n - 1:
                kb, vb, dk, dv = _ring_rotate((kb, vb, dk, dv), ctx.group)
            else:
                dk, dv = _ring_rotate((dk, dv), ctx.group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_flash_attention_fn(axis_name: str = "seq",
                            block_q: int | None = None,
                            block_k: int | None = None,
                            window: int | None = None, *,
                            mesh=None) -> Callable:
    """:func:`ring_attention_fn` with each block's work done by the flash
    kernels (no ``[S/n, S/n]`` logits) and a second ring for the
    gradients.  ``block_q``/``block_k`` keep tpudist's interface and its
    check that they divide the local sequence length; the kernels tile
    with their own 64.  The factory's ``window`` is published as
    ``attend.factory_window`` so the model rejects one that disagrees
    with ``cfg.attention_window``."""
    factory_window = window
    group = _seq_group(mesh, axis_name)

    def attend(q, k, v, *, causal: bool = True, window=_UNSET):
        window = factory_window if window is _UNSET else window
        s_loc = q.shape[1]
        if q.shape[2] % k.shape[2]:
            raise ValueError(
                f"num_heads {q.shape[2]} must be a multiple of kv heads "
                f"{k.shape[2]} (GQA)")
        bq = s_loc if block_q is None else min(block_q, s_loc)
        bk = s_loc if block_k is None else min(block_k, s_loc)
        if s_loc % bq or s_loc % bk:
            raise ValueError(
                f"block sizes ({bq}, {bk}) must divide the local sequence "
                f"length {s_loc}")
        if window is not None and (not causal or window < 1):
            raise ValueError(
                f"window={window} requires causal=True and window >= 1")
        return _RingFlash.apply(q, k, v, causal, window, group)

    attend.factory_window = factory_window
    return attend


# ---- the DP×SP step --------------------------------------------------------

def _positions(tokens: torch.Tensor, mesh, seq_axis: str) -> torch.Tensor:
    """Global positions of this process's sequence block."""
    s_loc = tokens.shape[1]
    return (axis_index(mesh, seq_axis) * s_loc
            + torch.arange(s_loc, device=tokens.device))[None, :]


def _check_mesh(mesh, *axes: str) -> None:
    names = mesh.mesh_dim_names or ()
    for a in axes:
        if a not in names:
            raise ValueError(f"mesh has axes {names}, not {a!r}")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"mesh of {mesh.size()} processes, the world has "
                         f"{dist.get_world_size()}")


def make_sp_train_step(
    model: nn.Module,
    loss_per_token: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mesh,
    total_tokens: int,
    data_axis: str = "data",
    seq_axis: str = "seq",
):
    """DP×SP transformer train step: the batch split over ``data``, the
    sequence over ``seq``, the parameters replicated.

    ``model`` is a :class:`TransformerLM` built with the matching
    ``attention_fn`` on the same mesh (``ring_flash_attention_fn(seq_axis,
    mesh=mesh)``, ...).  ``train_step(state, tokens, targets)`` takes this
    process's ``[B/nd, S/ns]`` blocks (:func:`~tpudist_torch.runtime.mesh.
    local_block`); ``loss_per_token(logits, targets) -> [tokens]`` returns
    UNREDUCED losses, summed here and divided by ``total_tokens``, so the
    sum of the gradients over the whole ``data × seq`` grid is the global
    batch's gradient; the loss is summed the same way."""
    _check_mesh(mesh, data_axis, seq_axis)

    def train_step(state: TrainState, tokens: torch.Tensor,
                   targets: torch.Tensor):
        if state.model is not model:
            raise ValueError("state.model is not the model this step was "
                             "built for")
        state.optimizer.zero_grad(set_to_none=True)
        logits = model(tokens, positions=_positions(tokens, mesh, seq_axis))
        per_tok = loss_per_token(logits.reshape(-1, logits.shape[-1]),
                                 targets.reshape(-1))
        loss = per_tok.sum() / total_tokens
        loss.backward()
        loss = loss.detach().reshape(1)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        all_reduce_sum(grads + [loss],
                       axis_groups(mesh, (data_axis, seq_axis)))
        return state.apply_gradients(), {"loss": loss.reshape(())}

    return train_step


def sp_forward(model: nn.Module, mesh, data_axis: str = "data",
               seq_axis: str = "seq"):
    """Sequence-parallel forward pass: ``fn(tokens) -> logits`` on this
    process's ``[B/nd, S/ns]`` block (tpudist's ``fn(params, tokens)``;
    here the model holds its parameters)."""
    _check_mesh(mesh, data_axis, seq_axis)

    def fwd(tokens: torch.Tensor) -> torch.Tensor:
        return model(tokens, positions=_positions(tokens, mesh, seq_axis))

    return fwd
