"""Mixture-of-Experts layers and LM (counterpart of :mod:`tpudist.models.moe`).

The same model as the JAX package's with the same numerics: a router
``Linear(d, E)`` run in f32 (flax promotes bf16 input against the f32
kernel), softmax gates, top-k choices renormalised over the chosen experts,
the Switch load-balancing aux loss, and ``E`` tanh-GELU expert MLPs whose
stacked weights ``w_up [E, d, f]`` / ``w_down [E, f, d]`` are stored in f32
and cast to the compute dtype at each use.

Three dispatches, as in the JAX package:

* ``"einsum"``: the GShard ``[T, E, C]`` one-hot dispatch/combine
  (capacity-bounded, drops overflow tokens);
* ``"ragged"``: slots sorted by expert (a counting sort), one matrix
  product per expert over its contiguous group, and the inverse
  permutation with a gate-weighted sum — no capacity, no dropping;
* ``"fused"``: the ragged layout through the fused grouped GEMM
  (:func:`tpudist_torch.ops.moe_dispatch.fused_moe_mlp`, kernel K7 on the
  card), the ``[T·k, f]`` intermediate kept on-chip.

Expert parallelism (``ep_axis=`` over a ``mesh``, the ``einsum``
dispatch only, as in tpudist): each process holds ``E/n`` experts, the
stacks' rows ``[r·E/n, (r+1)·E/n)``, and routes over all ``E``.  Two
schedules, by where the tokens are:

* ``ep_tokens="sharded"`` (tpudist's ``ep_axis``): every process routes
  its own tokens, an all-to-all sends the ``[E, C, d]`` blocks to the
  experts' owners as ``[E/n, n·C, d]``, the local experts run, and the
  reverse all-to-all brings the outputs back (its VJP is the reverse
  exchange, so the expert stacks' gradients are complete over the axis);
* ``ep_tokens="replicated"`` (tpudist's GSPMD program, which lowers to
  this): every process of the axis holds the same tokens, applies its own
  experts to its columns of the dispatch, and the partial outputs are
  summed over the axis (``psum_fwd_id_bwd``).  ``x`` and the combine
  weights enter the expert path through ``id_fwd_psum_bwd``, so their
  cotangents, hence the router's and every upstream gradient, are whole on
  every process; the aux loss, identical on all of them, is not summed.

Routing over a sharded batch (``routing_axes=`` over a ``mesh``, any
dispatch): tpudist's GSPMD program sees the logical global batch, so its
routing is a function of every token.  A process that holds a shard of
that batch, its rows over ``routing_axes`` (the first major, as
:func:`~tpudist_torch.parallel.tensor_parallel.shard_batch` cuts them),
routes as that program does (:class:`RoutingGroup`): the load-balance
term from the group's summed statistics over the global token count, the
capacity from the global ``T``, and each token's slot from its global
position (per expert, in token order, k-th choices after the (k−1)-th
over the whole batch).  Slots are the global ones, so ``[T, E, C]``
carries the global capacity; each process runs the experts on its own
tokens only.  Without ``routing_axes`` a process's tokens are the whole
batch (tpudist's ``shard_map`` and single-device semantics).

The ragged ``jax.lax.ragged_dot`` becomes one ``torch.matmul`` per
expert; the group sizes are read on the host (one sync per call).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.transformer import (
    AttentionFn,
    CausalSelfAttention,
    Dense,
    Embed,
    LayerNorm,
    TensorParallel,
    TransformerConfig,
    sdpa,
)
from tpudist_torch.ops.moe_dispatch import fused_moe_mlp
from tpudist_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    aux_loss_weight: float = 1e-2
    # "einsum" | "ragged" | "fused" (see the module docstring)
    dispatch: str = "einsum"
    # "fused" only: slot rows per kernel block.  Group starts pad to this,
    # wasting up to E*fused_block_rows rows of expert FLOPs.
    fused_block_rows: int = 128


class RoutingGroup:
    """The processes whose tokens make one batch for routing: ``axes`` of
    ``mesh``, over which a GSPMD-twin step shards the batch (the first
    axis major).  Every process of the group holds as many tokens, this
    one the ``index``-th block of the ``size``.  An axis missing from the
    mesh raises ``ValueError``."""

    def __init__(self, mesh, axes) -> None:
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        missing = [a for a in axes if a not in names]
        if not axes or missing:
            raise ValueError(f"routing axes {tuple(axes)}: {missing or axes} "
                             f"not in the mesh's axes {names}")
        self.axes = tuple(axes)
        self.groups = [mesh.get_group(a) for a in self.axes]
        self.size, self.index = 1, 0
        for a in self.axes:
            n = mesh.size(names.index(a))
            self.size, self.index = (self.size * n,
                                     self.index * n + mesh.get_local_rank(a))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group; its VJP sums the cotangent over the
        group too (``psum``), so a term that every process computes from
        the sum gets its whole gradient back once the step averages over
        the batch axes."""
        from tpudist_torch.parallel.common import psum

        for g in self.groups:
            x = psum(x, g)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[size, *x.shape]``: every process's ``x`` in shard order (for
        integer counts: no gradient)."""
        from tpudist_torch.parallel.common import all_gather

        x = x[None]
        for g in reversed(self.groups):
            x = all_gather(x, g, 0)
        return x


def _gate_choices(gates: torch.Tensor, top_k: int,
                  group: RoutingGroup | None = None):
    """Shared routing head: top-k expert choices (value-descending, as
    ``jax.lax.top_k``) with renormalised gate mass, and the Switch
    load-balancing aux loss, over ``group``'s tokens when given (its
    first choices' counts and its gate sums summed over the group, over
    the global token count)."""
    e = gates.shape[-1]
    top_vals, top_idx = torch.topk(gates, top_k, dim=-1, sorted=True)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    first = F.one_hot(top_idx[:, 0], e).to(gates.dtype)
    if group is None:
        frac_tokens, mean_gates = first.mean(0), gates.mean(0)
    else:
        frac_tokens, mean_gates = (
            group.sum(torch.stack([first.sum(0), gates.sum(0)]))
            / (gates.shape[0] * group.size))
    aux = torch.sum(frac_tokens * mean_gates) * e
    return top_vals, top_idx, aux


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k_routing(gates: torch.Tensor, top_k: int, capacity: int,
                   group: RoutingGroup | None = None):
    """GShard routing: from router probabilities ``gates [T, E]`` build
    ``dispatch [T, E, C]`` (one-hot: token t to expert e at slot c),
    ``combine [T, E, C]`` (dispatch weighted by the renormalised gate) and
    the aux loss.  Slots are assigned in token order per expert, k-th
    choices after the (k−1)-th; slots past ``capacity`` are dropped.

    With ``group`` the tokens are block ``group.index`` of the group's
    batch and the slots are those of the whole batch: round k at an
    expert starts after every shard's earlier rounds there and the lower
    shards' round k (one all-gather of the ``[k, E]`` counts)."""
    t, e = gates.shape
    top_vals, top_idx, aux = _gate_choices(gates, top_k, group)
    onehots = F.one_hot(top_idx, e)                             # [T, k, E]
    counts = onehots.sum(0)                                     # [k, E]
    if group is not None:
        shards = group.gather(counts)                           # [n, k, E]
        counts = shards.sum(0)
        lower = shards[:group.index].sum(0)
    else:
        lower = torch.zeros_like(counts)
    starts = torch.cumsum(counts, 0) - counts + lower           # [k, E]
    dispatch = torch.zeros((t, e, capacity), dtype=gates.dtype,
                           device=gates.device)
    combine = torch.zeros_like(dispatch)
    for k in range(top_k):
        onehot = onehots[:, k]                                  # [T, E]
        pos = starts[k][None, :] + torch.cumsum(onehot, 0) - onehot
        keep = (pos < capacity) & (onehot > 0)
        sel = _one_hot(pos, capacity, gates.dtype) \
            * keep[..., None].to(gates.dtype)                  # [T, E, C]
        dispatch = dispatch + sel
        combine = combine + sel * top_vals[:, k, None, None]
    return dispatch, combine, aux


def _counting_sort(flat_e: torch.Tensor, e: int,
                   block_rows: int | None = None):
    """Expert-grouped slot assignment as a counting sort, the JAX
    function's method: the rank of each assignment within its expert from
    one ``[E, N]`` one-hot cumsum, plus its group's start, is its
    destination slot ``pos`` (the inverse permutation the combine needs);
    one scatter of ``arange`` builds the forward ``order``.

    ``block_rows`` pads each group's start to a block multiple (the fused
    kernel's layout).  Returns ``(pos [N], order [NP], group_sizes [E],
    starts [E], np_pad)`` with ``np_pad = (N // block_rows + E) ·
    block_rows`` (``N`` unpadded); unused slots of ``order`` are 0."""
    n = flat_e.shape[0]
    dev = flat_e.device
    onehot = (torch.arange(e, device=dev)[:, None]
              == flat_e[None, :]).long()                        # [E, N]
    within = torch.cumsum(onehot, 1) - onehot
    group_sizes = onehot.sum(1)
    padded = (group_sizes if block_rows is None
              else (group_sizes + block_rows - 1) // block_rows * block_rows)
    starts = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        torch.cumsum(padded, 0)[:-1]])
    pos = ((within + starts[:, None]) * onehot).sum(0)          # [N]
    np_pad = n if block_rows is None else (n // block_rows + e) * block_rows
    order = torch.zeros(np_pad, dtype=torch.long, device=dev)
    order[pos] = torch.arange(n, device=dev)
    return pos, order, group_sizes, starts, np_pad


def _ragged_moe(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                top_idx: torch.Tensor, top_vals: torch.Tensor) -> torch.Tensor:
    """Sorted dispatch + grouped matmuls: assignments grouped by expert
    (:func:`_counting_sort`), one ``torch.matmul`` per expert and product
    over its contiguous group (``jax.lax.ragged_dot``), then the inverse
    permutation and the gate-weighted sum (the gate in ``y``'s dtype,
    after the product).  Differentiable."""
    t, d = x.shape
    k = top_idx.shape[1]
    e = w_up.shape[0]
    pos, order, group_sizes, _, _ = _counting_sort(top_idx.reshape(-1), e)
    xs = x[order // k]
    sizes = group_sizes.tolist()
    h = F.gelu(torch.cat([g @ w_up[i] for i, g in
                          enumerate(torch.split(xs, sizes))]),
               approximate="tanh")
    ys = torch.cat([g @ w_down[i] for i, g in
                    enumerate(torch.split(h, sizes))])          # [N, d]
    y = ys[pos].reshape(t, k, d)
    return torch.sum(y * top_vals[:, :, None].to(y.dtype), dim=1)


class MoEMLP(nn.Module):
    """Router + ``num_experts`` tanh-GELU MLPs on ``[tokens, d_model]``;
    returns ``(out, aux_loss)``.  Parameters (f32): ``router.weight [E,
    d]`` and the stacks ``w_up [E, d, f]``, ``w_down [E, f, d]``.

    ``ep_axis`` over ``mesh`` holds this process's ``E/n`` experts and
    runs the ``ep_tokens`` schedule (the module docstring; ``None``
    without a mesh: a group of one).  It raises ``ValueError`` under the
    ragged and fused dispatches, which are single-shard in the JAX package
    too.  ``routing_axes`` over ``mesh`` routes over the batch those axes
    shard (:class:`RoutingGroup`; ``None``: this process's tokens are the
    whole batch); under ``ep_tokens="replicated"`` it may not name
    ``ep_axis``, whose processes hold the same tokens."""

    def __init__(self, d_model: int, d_ff: int, moe: MoEConfig,
                 ep_axis: str | None = None, *, mesh=None,
                 ep_tokens: str = "sharded",
                 routing_axes: tuple[str, ...] | None = None,
                 device=None) -> None:
        super().__init__()
        if moe.dispatch in ("ragged", "fused"):
            if ep_axis is not None:
                raise ValueError(
                    f"dispatch={moe.dispatch!r} is single-shard (the EP "
                    "all-to-all transports the [E, C, d] block layout); "
                    "use dispatch='einsum' with ep_axis")
        elif moe.dispatch != "einsum":
            raise ValueError(f"unknown dispatch {moe.dispatch!r} "
                             f"(expected einsum|ragged|fused)")
        if ep_tokens not in ("sharded", "replicated"):
            raise ValueError(f"ep_tokens must be 'sharded' or 'replicated', "
                             f"got {ep_tokens!r}")
        if ep_tokens == "replicated" and ep_axis in (routing_axes or ()):
            raise ValueError(f"routing axes {tuple(routing_axes)} name the "
                             f"expert axis {ep_axis!r}, over which tokens "
                             "are replicated")
        self.moe = moe
        self.ep_tokens = ep_tokens
        self.ep = TensorParallel(ep_axis, mesh)
        self.routing = (None if routing_axes is None
                        else RoutingGroup(mesh, routing_axes))
        e = moe.num_experts
        self.ep.check(e, "num_experts")
        local = e // self.ep.size
        self.router = nn.Linear(d_model, e, bias=False, dtype=torch.float32,
                                device=device)
        self.w_up = nn.Parameter(torch.empty(local, d_model, d_ff,
                                             device=device))
        self.w_down = nn.Parameter(torch.empty(local, d_ff, d_model,
                                               device=device))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        moe = self.moe
        t, e = x.shape[0], moe.num_experts
        # flax Dense(dtype=None): bf16 input against the f32 kernel runs
        # in f32
        gates = torch.softmax(F.linear(x.float(), self.router.weight), -1)
        w_up, w_down = self.w_up.to(x.dtype), self.w_down.to(x.dtype)
        if moe.dispatch in ("ragged", "fused"):
            top_vals, top_idx, aux = _gate_choices(gates, moe.top_k,
                                                   self.routing)
            if moe.dispatch == "fused":
                out = fused_moe_mlp(x, w_up, w_down, top_idx, top_vals,
                                    block_rows=moe.fused_block_rows)
            else:
                out = _ragged_moe(x, w_up, w_down, top_idx, top_vals)
            return out, aux.float()
        # tpudist's capacity, of the global batch
        if self.routing is not None:
            t *= self.routing.size
        capacity = max(1, int(moe.capacity_factor * t * moe.top_k / e))
        dispatch, combine, aux = _top_k_routing(gates, moe.top_k, capacity,
                                                self.routing)
        dispatch, combine = dispatch.to(x.dtype), combine.to(x.dtype)
        ep = self.ep
        if ep.group is not None and self.ep_tokens == "replicated":
            # this process's experts only; partial outputs summed
            cols = slice(ep.index * w_up.shape[0],
                         (ep.index + 1) * w_up.shape[0])
            x, combine = ep.enter(x), ep.enter(combine)
            dispatch, combine = dispatch[:, cols], combine[:, cols]
        expert_in = torch.einsum("tec,td->ecd", dispatch, x)
        if ep.group is not None and self.ep_tokens == "sharded":
            # [E, C, d] to the experts' owners as [E/n, n·C, d]
            expert_in = ep.exchange(expert_in, 0, 1)
        h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, w_up),
                   approximate="tanh")
        expert_out = torch.einsum("ecf,efd->ecd", h, w_down)
        if ep.group is not None and self.ep_tokens == "sharded":
            expert_out = ep.exchange(expert_out, 1, 0)
        out = torch.einsum("tec,ecd->td", combine, expert_out)
        if ep.group is not None and self.ep_tokens == "replicated":
            out = ep.leave(out)
        return out, aux.float()


class MoEDecoderBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, moe: MoEConfig,
                 attention_fn: AttentionFn = sdpa, device=None,
                 **ep_kw) -> None:
        super().__init__()
        f32 = torch.float32
        self.ln1 = LayerNorm(cfg.embed_dim, cfg.compute_dtype, device)
        self.attn = CausalSelfAttention(cfg, attention_fn, param_dtype=f32,
                                        device=device)
        self.ln2 = LayerNorm(cfg.embed_dim, cfg.compute_dtype, device)
        self.moe = MoEMLP(cfg.embed_dim, cfg.mlp_ratio * cfg.embed_dim, moe,
                          device=device, **ep_kw)

    def forward(self, x: torch.Tensor, causal: bool = True):
        x = x + self.attn(self.ln1(x), causal)
        h = self.ln2(x)
        b, s, d = h.shape
        out, aux = self.moe(h.reshape(b * s, d))
        return x + out.reshape(b, s, d), aux


class MoETransformerLM(nn.Module):
    """Decoder-only LM with an MoE MLP in every block: tokens ``[B, S]``
    -> ``(logits [B, S, vocab] f32, aux_loss)``, the aux loss already
    weighted by ``aux_loss_weight``; add it to the training loss.

    Runs on ``cuda`` unless ``device`` says otherwise.  Parameters are
    stored in f32 and cast to ``compute_dtype`` at use, as flax stores
    the JAX model's (load them with ``load_state_dict`` of
    :func:`~tpudist_torch.models.convert.from_flax_moe_params`' output,
    or draw random ones with :meth:`init_weights`).  ``ep_axis`` over
    ``mesh`` shards every MoE layer's experts, and ``routing_axes`` over
    ``mesh`` routes every MoE layer over the batch those axes shard
    (:class:`MoEMLP`)."""

    def __init__(self, cfg: TransformerConfig, moe: MoEConfig, *,
                 attention_fn: AttentionFn = sdpa, ep_axis: str | None = None,
                 mesh=None, ep_tokens: str = "sharded",
                 routing_axes: tuple[str, ...] | None = None,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.moe = cfg, moe
        f32 = torch.float32
        self.tok_embed = Embed(cfg.vocab_size, cfg.embed_dim, cfg, f32,
                               device)
        self.pos_embed = Embed(cfg.max_seq_len, cfg.embed_dim, cfg, f32,
                               device)
        self.blocks = nn.ModuleList(
            MoEDecoderBlock(cfg, moe, attention_fn, device, ep_axis=ep_axis,
                            mesh=mesh, ep_tokens=ep_tokens,
                            routing_axes=routing_axes)
            for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.embed_dim, cfg.compute_dtype, device)
        self.lm_head = Dense(cfg.embed_dim, cfg.vocab_size, cfg, f32, device)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MoETransformerLM":
        """Random weights drawn from ``generator`` (on the model's device)
        with flax's default initializers: truncated-normal kernels of std
        1/sqrt(fan_in), where the expert stacks count the expert axis as
        receptive field (``lecun_normal`` on ``[E, d, f]``: fan_in E·d);
        normal embeddings of std 1/sqrt(embed_dim); LayerNorm scale 1 and
        bias 0."""
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            elif "embed" in name:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]),
                          generator=generator)
            else:
                # [out, in] Linear weights, or [E, fan_in, fan_out] stacks
                fan_in = p.shape[1] * (p.shape[0] if p.dim() == 3 else 1)
                std = 1.0 / math.sqrt(fan_in)
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
        return self

    def forward(self, tokens: torch.Tensor, *, causal: bool = True,
                positions: torch.Tensor | None = None):
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        x = self.tok_embed(tokens) + self.pos_embed(positions)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            x, aux = blk(x, causal)
            aux_total = aux_total + aux
        logits = self.lm_head(self.ln_f(x)).float()
        return logits, self.moe.aux_loss_weight * aux_total
