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

The explicit expert-parallel path (``ep_axis``: ``all_to_all`` across
processes) is not ported yet.  The ragged ``jax.lax.ragged_dot`` becomes
one ``torch.matmul`` per expert; the group sizes are read on the host
(one sync per call).
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
    TransformerConfig,
    sdpa,
)
from tpudist_torch.ops.moe_dispatch import fused_moe_mlp
from tpudist_torch.utils.device import resolve_device

_EP_TODO = ("MoEMLP with ep_axis (the expert-parallel all_to_all across "
            "processes) is not ported yet (ROADMAP Queue A 7: parallel "
            "strategies on torch.distributed, expert_parallel)")


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


def _gate_choices(gates: torch.Tensor, top_k: int):
    """Shared routing head: top-k expert choices (value-descending, as
    ``jax.lax.top_k``) with renormalised gate mass, and the Switch
    load-balancing aux loss."""
    e = gates.shape[-1]
    top_vals, top_idx = torch.topk(gates, top_k, dim=-1, sorted=True)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    frac_tokens = F.one_hot(top_idx[:, 0], e).to(gates.dtype).mean(0)
    aux = torch.sum(frac_tokens * gates.mean(0)) * e
    return top_vals, top_idx, aux


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k_routing(gates: torch.Tensor, top_k: int, capacity: int):
    """GShard routing: from router probabilities ``gates [T, E]`` build
    ``dispatch [T, E, C]`` (one-hot: token t to expert e at slot c),
    ``combine [T, E, C]`` (dispatch weighted by the renormalised gate) and
    the aux loss.  Slots are assigned in token order per expert, k-th
    choices after the (k−1)-th; slots past ``capacity`` are dropped."""
    t, e = gates.shape
    top_vals, top_idx, aux = _gate_choices(gates, top_k)
    dispatch = torch.zeros((t, e, capacity), dtype=gates.dtype,
                           device=gates.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros(e, dtype=torch.long, device=gates.device)
    for k in range(top_k):
        onehot = F.one_hot(top_idx[:, k], e)                   # [T, E]
        pos = counts[None, :] + torch.cumsum(onehot, 0) - onehot
        keep = (pos < capacity) & (onehot > 0)
        sel = _one_hot(pos, capacity, gates.dtype) \
            * keep[..., None].to(gates.dtype)                  # [T, E, C]
        dispatch = dispatch + sel
        combine = combine + sel * top_vals[:, k, None, None]
        counts = counts + onehot.sum(0)
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

    ``ep_axis`` (the JAX module's explicit expert-parallel path) raises:
    ``ValueError`` under the ragged and fused dispatches, which are
    single-shard in the JAX package too, and ``NotImplementedError``
    under ``einsum`` until expert parallelism is ported."""

    def __init__(self, d_model: int, d_ff: int, moe: MoEConfig,
                 ep_axis: str | None = None, *, device=None) -> None:
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
        elif ep_axis is not None:
            raise NotImplementedError(_EP_TODO)
        self.moe = moe
        e = moe.num_experts
        self.router = nn.Linear(d_model, e, bias=False, dtype=torch.float32,
                                device=device)
        self.w_up = nn.Parameter(torch.empty(e, d_model, d_ff,
                                             device=device))
        self.w_down = nn.Parameter(torch.empty(e, d_ff, d_model,
                                               device=device))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        moe = self.moe
        t, e = x.shape[0], moe.num_experts
        # flax Dense(dtype=None): bf16 input against the f32 kernel runs
        # in f32
        gates = torch.softmax(F.linear(x.float(), self.router.weight), -1)
        w_up, w_down = self.w_up.to(x.dtype), self.w_down.to(x.dtype)
        if moe.dispatch in ("ragged", "fused"):
            top_vals, top_idx, aux = _gate_choices(gates, moe.top_k)
            if moe.dispatch == "fused":
                out = fused_moe_mlp(x, w_up, w_down, top_idx, top_vals,
                                    block_rows=moe.fused_block_rows)
            else:
                out = _ragged_moe(x, w_up, w_down, top_idx, top_vals)
            return out, aux.float()
        capacity = max(1, int(moe.capacity_factor * t * moe.top_k / e))
        dispatch, combine, aux = _top_k_routing(gates, moe.top_k, capacity)
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
        h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, w_up),
                   approximate="tanh")
        expert_out = torch.einsum("ecf,efd->ecd", h, w_down)
        out = torch.einsum("tec,ecd->td", combine.to(x.dtype), expert_out)
        return out, aux.float()


class MoEDecoderBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, moe: MoEConfig,
                 attention_fn: AttentionFn = sdpa, device=None) -> None:
        super().__init__()
        f32 = torch.float32
        self.ln1 = LayerNorm(cfg.embed_dim, cfg.compute_dtype, device)
        self.attn = CausalSelfAttention(cfg, attention_fn, param_dtype=f32,
                                        device=device)
        self.ln2 = LayerNorm(cfg.embed_dim, cfg.compute_dtype, device)
        self.moe = MoEMLP(cfg.embed_dim, cfg.mlp_ratio * cfg.embed_dim, moe,
                          device=device)

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
    or draw random ones with :meth:`init_weights`)."""

    def __init__(self, cfg: TransformerConfig, moe: MoEConfig, *,
                 attention_fn: AttentionFn = sdpa, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.moe = cfg, moe
        f32 = torch.float32
        self.tok_embed = Embed(cfg.vocab_size, cfg.embed_dim, cfg, f32,
                               device)
        self.pos_embed = Embed(cfg.max_seq_len, cfg.embed_dim, cfg, f32,
                               device)
        self.blocks = nn.ModuleList(
            MoEDecoderBlock(cfg, moe, attention_fn, device)
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
