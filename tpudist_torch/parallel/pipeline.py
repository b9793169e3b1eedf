"""Micro-batched pipeline model parallelism over a mesh's stage axis
(counterpart of :mod:`tpudist.parallel.pipeline`).

The reference's RPC pipeline (``model_parallel_ResNet50.py:142-184``)
chains micro-batches master → worker1 → worker2 and lets
``dist_autograd`` run the backward across the workers.  tpudist compiles
the whole schedule into one SPMD ``lax.scan`` with ``ppermute`` hops.
Here each process of the mesh's ``stage`` axis runs its own stage (or its
own ``V`` chunks of an interleaved stack) eagerly:

* every process walks the same static tick tables — the GPipe fill-drain
  and interleaved forward tables (:func:`_interleave_schedule`; GPipe is
  its ``V = 1`` case) and the 1F1B tables (:func:`_one_f_one_b_schedule`),
  copied from tpudist table for table — and computes only on the ticks
  its column names: idle ticks compute nothing;
* activations and cotangents travel between stage ``p`` and ``p ± 1`` by
  :func:`_stage_hop`, one ``batch_isend_irecv`` a tick on the stage group
  (NCCL on cards, gloo on the CPU), posted only where the receiver's
  table banks an arrival — the only code of the pipeline that touches the
  group;
* the backward is driven tick by tick, never by autograd's engine across
  ranks: the GPipe family walks its forward table in reverse, 1F1B takes
  its own backward ticks and recomputes the chunk from the banked input
  (tpudist's per-tick ``jax.vjp``); every backward tick is one explicit
  ``torch.autograd.backward`` followed by the hop of the input's
  cotangent.

The numerics are tpudist's: heterogeneous stage boundaries travel in
``buf_dtype`` (f32 by default; an integer boundary raises), the loss
exists on the last stage only, 1F1B seeds each micro-batch's cotangent
with ``1/M``, and each micro-batch is a contiguous slice of the local
batch (``x.reshape(M, b // M, ...)``).  Plain GPipe holds every stage's
parameters on every process and sums the stage-local gradients over the
stage group before averaging over data; packed, stacked, interleaved and
1F1B hold only their own stage's slice and average over data; the
real-model mode's ``extra`` gradients (embedding, head) are summed over
the stages, then averaged over data; the loss metric is
``pmean(psum(loss, stage), data)``.

Parameters are modules: a plain GPipe step indexes ``state.model[s]``
(an ``nn.ModuleList`` of stages, or a :class:`ParamTree` of per-stage
trees), the other steps read ``state.model.tree()`` of a
:class:`ParamTree` holding this process's slice
(:func:`shard_stage_params` cuts it; :func:`stacked_state_specs` says
which leaves are sliced).

One card holds one NCCL rank, and gloo has no CUDA send/recv: a step
handed CUDA tensors on a gloo group raises.  ``mesh=None`` with
``local_stages=P`` runs all ``P`` stages in this one process through the
same tick functions and tables, the hops handing tensors over in memory;
the parameters then hold every stage's slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn

from tpudist_torch.parallel.data_parallel import all_reduce_sum, axis_groups
from tpudist_torch.runtime.mesh import axis_index, axis_size, local_block
from tpudist_torch.train.state import TrainState
from tpudist_torch.utils.device import resolve_device
from tpudist_torch.utils.trees import _leaves, tree_map

# A stage is a function (stage_params, activations[mb, ...]) -> out[mb, ...]
StageFn = Callable[[Any, torch.Tensor], torch.Tensor]

# ---- parameters as a tree ---------------------------------------------------

def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(np.asarray(x))


class ParamTree(nn.Module):
    """A parameter pytree as a module: the leaves of a nested mapping,
    list or tuple of tensors (or arrays) become parameters, and
    :meth:`tree` gives the tree back with those parameters at its leaves
    — tpudist's ``state.params`` for steps whose stage functions take
    parameter trees.  ``tree[k]`` is the tree's top-level entry ``k``.
    Leaves are copied onto ``device`` (``cuda`` unless given), in their
    own dtype unless ``dtype`` is given."""

    def __init__(self, tree: Any, *, device=None,
                 dtype: torch.dtype | None = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self._template = tree_map(lambda _: None, tree)
        self.leaves = nn.ParameterList(
            nn.Parameter(_tensor(x).to(device=device, dtype=dtype,
                                       copy=True))
            for _, x in _leaves(tree))

    def tree(self) -> Any:
        it = iter(self.leaves)
        return tree_map(lambda _: next(it), self._template)

    def __getitem__(self, key):
        return self.tree()[key]


def _model_tree(state_or_model) -> Any:
    model = getattr(state_or_model, "model", state_or_model)
    if not isinstance(model, ParamTree):
        raise TypeError("this pipeline step reads its parameters as a tree: "
                        "state.model must be a ParamTree, got "
                        f"{type(model).__name__}")
    return model.tree()


def _as_tree(x) -> Any:
    if isinstance(x, TrainState) or isinstance(x, ParamTree):
        return _model_tree(x)
    return x


def stacked_state_specs(params, n_stages: int, stage_axis: str = "stage",
                        overrides: Mapping[str, tuple] | None = None
                        ) -> dict[str, tuple]:
    """Which leaves a stage-sharded step slices: ``{path: spec}`` over the
    leaves of ``params`` (a tree, a :class:`ParamTree` or a
    :class:`TrainState` holding one), each path ``/``-joined.  A leaf
    stacked ``[n_stages, ...]`` gets ``(stage_axis,)``: its leading dim is
    cut over the stage axis, as ``P(stage_axis)`` places it; any other
    leaf ``()``: held whole.  The leading-dim test is tpudist's
    heuristic; ``overrides`` (``{path_substring: spec}``, first match
    wins) pins the spec of every leaf whose path contains the substring.
    The optimizer's state mirrors its parameter (:func:`state_specs_like`).
    """
    specs = {}
    for path, leaf in _leaves(_as_tree(params)):
        hit = next((s for pat, s in (overrides or {}).items()
                    if pat in path), None)
        if hit is not None:
            specs[path] = tuple(hit)
        elif getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == n_stages:
            specs[path] = (stage_axis,)
        else:
            specs[path] = ()
    return specs


def state_specs_like(state: TrainState, param_specs: Mapping[str, tuple],
                     mirrors: Mapping[str, bool] | None = None) -> dict:
    """The specs of a whole :class:`TrainState` from its parameters':
    ``{"params": param_specs, "opt_state": {index: {key: spec}}}``, the
    optimizer's entry ``key`` of parameter ``index`` (in
    ``state.model.parameters()`` order, the tree's leaf order) taking its
    parameter's spec when it has the parameter's shape (Adam's moments)
    and ``()`` when it is a scalar (the step count).  Another shape is
    ambiguous and raises, as tpudist's does, unless ``mirrors``
    (``{key_substring: bool}``) says whether it mirrors its parameter."""
    specs = list(param_specs.values())
    params = list(state.model.parameters())
    if len(specs) != len(params):
        raise ValueError(f"{len(specs)} param specs for {len(params)} "
                         "parameters")
    opt = {}
    for i, (p, spec) in enumerate(zip(params, specs)):
        entry = {}
        for key, val in state.optimizer.state.get(p, {}).items():
            flag = next((f for pat, f in (mirrors or {}).items()
                         if pat in key), None)
            shape = tuple(getattr(val, "shape", ()))
            if flag is None and shape not in ((), tuple(p.shape)):
                raise ValueError(
                    f"optimizer state {key!r} of parameter {i} has shape "
                    f"{shape}, its parameter {tuple(p.shape)}; pass "
                    f"mirrors={{{key!r}: True}} to give it the parameter's "
                    f"spec or {{{key!r}: False}} to hold it whole")
            mirrored = flag if flag is not None else shape == tuple(p.shape)
            entry[key] = tuple(spec) if mirrored else ()
        opt[i] = entry
    return {"params": dict(param_specs), "opt_state": opt}


def shard_stage_params(tree: Any, mesh, specs: Mapping[str, tuple]) -> Any:
    """This process's part of a stage-stacked tree (leaves numpy arrays or
    tensors, returned as tensors): a leaf whose spec is ``(axis, ...)`` is
    cut to this process's contiguous block along its leading dim (what a
    ``P(axis)`` sharding puts on a device), the rest is kept whole.
    ``mesh=None`` keeps every leaf whole: all stages run in this
    process."""
    def cut(path_leaf):
        path, leaf = path_leaf
        t = _tensor(leaf)
        spec = specs[path]
        return t if mesh is None or not spec else local_block(t, mesh, spec)

    it = _leaves(tree)
    return tree_map(lambda _: cut(next(it)), tree)


# ---- the schedule tables (tpudist's, table for table) -----------------------

@dataclasses.dataclass(frozen=True)
class _OneFOneBSchedule:
    """Static 1F1B schedule tables, all [T, P] int32 (-1 = nothing).

    kind   -1 idle / 0 forward / 1 backward
    m      micro-batch executed this tick
    v      local virtual-chunk index executed this tick (0 when V == 1)
    frecv  act-buffer slot banking the activation arriving at tick start
    crecv  cot-buffer slot banking the cotangent arriving at tick start
    fread  act-buffer slot holding the executed micro-batch's INPUT
           activation (-1: read from xs — chunk 0); kept across fwd,
           freed at bwd (the recompute source)
    cread  cot-buffer slot holding the incoming cotangent for a backward
           tick (-1: the LAST chunk seeds from the loss)
    Qa/Qc  act/cot buffer sizes — bounded by the in-flight cap (~P·V at
           the first device), not by M·V as in GPipe
    """

    T: int
    Qa: int
    Qc: int
    kind: np.ndarray
    m: np.ndarray
    v: np.ndarray
    frecv: np.ndarray
    crecv: np.ndarray
    fread: np.ndarray
    cread: np.ndarray


def _canonical_interleaved_order(P: int, V: int,
                                 M: int) -> list[list[tuple]]:
    """The canonical Megatron-LM interleaved-1F1B op order, per device:
    ``[(kind, m, v), ...]`` with kind 0=forward, 1=backward.

    Device p runs ``W(p) = min(2(P-p-1) + (V-1)P, MV)`` warmup forwards,
    then strict 1F1B alternation, then the backward cooldown.  The k-th
    forward (0-indexed) executes micro-batch ``(k // PV)·P + k % P`` on
    local chunk ``(k % PV) // P``.  Requires ``M % P == 0`` (the Megatron
    interleaving condition)."""
    total = M * V

    def mb(k: int, forward: bool) -> tuple[int, int]:
        v = (k % (P * V)) // P
        if not forward:
            v = V - 1 - v
        return (k // (P * V)) * P + k % P, v

    ops: list[list[tuple]] = []
    for p in range(P):
        warmup = min((P - p - 1) * 2 + (V - 1) * P, total)
        seq: list[tuple] = []
        fk = bk = 0
        for _ in range(warmup):
            seq.append((0, *mb(fk, True)))
            fk += 1
        while fk < total:
            seq.append((0, *mb(fk, True)))
            fk += 1
            seq.append((1, *mb(bk, False)))
            bk += 1
        while bk < total:
            seq.append((1, *mb(bk, False)))
            bk += 1
        ops.append(seq)
    return ops


def _one_f_one_b_schedule(P: int, M: int, V: int = 1) -> _OneFOneBSchedule:
    """Event-driven simulation of the 1F1B schedule, plain (V=1) or
    interleaved (V>1: chunk ``c = v·P + p`` lives on device ``c mod P``).

    V>1 with ``M % P == 0`` follows the canonical per-device op order
    (:func:`_canonical_interleaved_order`), each device running its next
    op the first tick its input has arrived.  Other configurations take
    greedy priorities: backward work first (oldest micro-batch, deepest
    chunk), else a forward (deepest ready chunk) while the in-flight count
    stays under the cap — ``P - p`` at V=1, ``2(P-p-1) + (V-1)P + 1`` at
    V>1.  A forward output hops one device down the ring and a cotangent
    one device up, landing at the next tick's start; the LAST chunk's
    backward unlocks itself one tick after its forward."""
    L = P * V
    order = (_canonical_interleaved_order(P, V, M)
             if V > 1 and M % P == 0 else None)
    ptr = [0] * P
    if V == 1:
        caps = [P - p for p in range(P)]
    else:
        caps = [2 * (P - p - 1) + (V - 1) * P + 1 for p in range(P)]
    act_slot: list[dict] = [dict() for _ in range(P)]   # (m, v) -> slot
    cot_slot: list[dict] = [dict() for _ in range(P)]
    free_a: list[list[int]] = [[] for _ in range(P)]
    free_c: list[list[int]] = [[] for _ in range(P)]
    next_a = [0] * P
    next_c = [0] * P
    fwd_ready: list[set] = [set() for _ in range(P)]    # {(m, v)}
    bwd_ready: list[set] = [set() for _ in range(P)]
    arriving_f: list[tuple | None] = [None] * P
    arriving_c: list[tuple | None] = [None] * P
    self_ready: dict[int, int] = {}  # last chunk: m -> unlock tick
    next_launch = 0  # chunk 0 (device 0, v 0) feeds micro-batches in order
    in_flight = [0] * P
    bwd_done = [0] * P
    cols: dict[str, list] = {k: [] for k in
                             ("kind", "m", "v", "frecv", "crecv",
                              "fread", "cread")}

    def alloc(free: list[int], nxt: list[int], p: int) -> int:
        if free[p]:
            return free[p].pop()
        nxt[p] += 1
        return nxt[p] - 1

    def do_backward(p: int, m: int, v: int, row: dict,
                    nc: list) -> None:
        row["kind"][p], row["m"][p], row["v"][p] = 1, m, v
        if (m, v) in act_slot[p]:
            s = act_slot[p].pop((m, v))
            row["fread"][p] = s
            free_a[p].append(s)
        if (m, v) in cot_slot[p]:
            s = cot_slot[p].pop((m, v))
            row["cread"][p] = s
            free_c[p].append(s)
        in_flight[p] -= 1
        bwd_done[p] += 1
        if v * P + p > 0:  # cotangent to chunk c-1 (one device up the ring)
            nc[(p - 1) % P] = (m, v - 1 if p == 0 else v)

    def do_forward(p: int, m: int, v: int, row: dict, nf: list,
                   t: int) -> None:
        row["kind"][p], row["m"][p], row["v"][p] = 0, m, v
        row["fread"][p] = act_slot[p].get((m, v), -1)
        in_flight[p] += 1
        if v * P + p < L - 1:  # activation to chunk c+1 (one device down)
            nf[(p + 1) % P] = (m, v + 1 if p == P - 1 else v)
        else:
            self_ready[m] = t + 1

    t = 0
    while any(d < M * V for d in bwd_done):
        row = {k: [-1] * P for k in cols}
        # 1. arrivals land
        nf, nc = [None] * P, [None] * P
        for p in range(P):
            if arriving_f[p] is not None:
                mv = arriving_f[p]
                s = alloc(free_a, next_a, p)
                act_slot[p][mv] = s
                row["frecv"][p] = s
                fwd_ready[p].add(mv)
            if arriving_c[p] is not None:
                mv = arriving_c[p]
                s = alloc(free_c, next_c, p)
                cot_slot[p][mv] = s
                row["crecv"][p] = s
                bwd_ready[p].add(mv)
        for m, tick in list(self_ready.items()):
            if tick <= t:
                bwd_ready[P - 1].add((m, V - 1))
                del self_ready[m]
        # 2. execution
        for p in range(P):
            if order is not None:
                # canonical mode: run this device's NEXT op the first
                # tick its input is present; never reorder
                if ptr[p] >= len(order[p]):
                    continue
                kind, m, v = order[p][ptr[p]]
                if kind == 1:
                    if (m, v) not in bwd_ready[p]:
                        continue
                    bwd_ready[p].discard((m, v))
                    do_backward(p, m, v, row, nc)
                else:
                    launch = p == 0 and v == 0
                    if not launch and (m, v) not in fwd_ready[p]:
                        continue
                    if launch:
                        next_launch += 1
                    else:
                        fwd_ready[p].discard((m, v))
                    do_forward(p, m, v, row, nf, t)
                ptr[p] += 1
                continue
            # greedy mode: backward first, else forward under the cap
            if bwd_ready[p]:
                m, v = min(bwd_ready[p], key=lambda mv: (mv[0], -mv[1]))
                bwd_ready[p].discard((m, v))
                do_backward(p, m, v, row, nc)
                continue
            # chunk-0 launches appear as a virtual ready entry so the
            # deepest-chunk-first priority arbitrates launches vs deeper
            # forwards uniformly
            candidates = set(fwd_ready[p])
            if p == 0 and next_launch < M:
                candidates.add((next_launch, 0))
            if in_flight[p] >= caps[p]:
                # the cap must never strangle the cotangent SOURCE: the
                # last chunk's forward unlocks its own backward one tick
                # later, so it is exempt
                candidates = {mv for mv in candidates
                              if p == P - 1 and mv[1] == V - 1}
            if candidates:
                m, v = min(candidates, key=lambda mv: (-mv[1], mv[0]))
                if (m, v) in fwd_ready[p]:
                    fwd_ready[p].discard((m, v))
                else:
                    next_launch += 1
                do_forward(p, m, v, row, nf, t)
        arriving_f, arriving_c = nf, nc
        for k in cols:
            cols[k].append(row[k])
        t += 1
        if t > 8 * L * M + 6 * L:  # pragma: no cover - schedule bug guard
            raise RuntimeError("1F1B scheduler did not converge")
    return _OneFOneBSchedule(
        T=t, Qa=max(max(next_a), 1), Qc=max(max(next_c), 1),
        **{k: np.asarray(val, np.int32) for k, val in cols.items()},
    )


@dataclasses.dataclass(frozen=True)
class _InterleaveSchedule:
    """Static conflict-free forward schedule of the GPipe family (GPipe
    itself is ``V = 1``).  All tables are [T, P] int32; -1 = nothing.

    exec_v    local virtual-chunk index executed this tick
    exec_m    micro-batch index executed this tick
    recv_slot queue slot storing the activation arriving at tick start
    read_slot queue slot holding the executed chunk's input (-1: from xs)
    out_m     micro-batch index whose FINAL output this tick produces
    """

    T: int
    Q: int
    exec_v: np.ndarray
    exec_m: np.ndarray
    recv_slot: np.ndarray
    read_slot: np.ndarray
    out_m: np.ndarray


def _interleave_schedule(P: int, V: int, M: int) -> _InterleaveSchedule:
    """Greedy list scheduling of the interleaved pipeline: chunk ``c =
    v·P + p`` (device ``p``, local slice ``v``) may run micro-batch ``m``
    once its input is present; outputs hop one device down the ring and
    arrive at the next tick's start.  Devices pick drain-first (highest
    ``v``, then lowest ``m``).  At ``V = 1`` this is the GPipe fill-drain
    schedule (span ``M + P - 1``)."""
    L = P * V
    avail: list[dict] = [dict() for _ in range(P)]
    for m in range(M):
        avail[0][(m, 0)] = 0  # stage-0 inputs come straight from xs
    slot_of: list[dict] = [dict() for _ in range(P)]
    free: list[list[int]] = [list(range(L * M)) for _ in range(P)]
    arriving: list[tuple | None] = [None] * P  # (m, v) landing at tick start
    cols: dict[str, list] = {k: [] for k in
                             ("exec_v", "exec_m", "recv_slot", "read_slot",
                              "out_m")}
    remaining = L * M
    max_slot = -1
    t = 0
    while remaining or any(a is not None for a in arriving):
        row = {k: [-1] * P for k in cols}
        # 1. arrivals (sender executed last tick)
        for p in range(P):
            if arriving[p] is not None:
                m, v = arriving[p]
                s = free[p].pop(0)
                max_slot = max(max_slot, s)
                slot_of[p][(m, v)] = s
                avail[p][(m, v)] = t
                row["recv_slot"][p] = s
        arriving = [None] * P
        # 2. execution (drain-first: highest v, then lowest m)
        for p in range(P):
            ready = [(m, v) for (m, v), tk in avail[p].items() if tk <= t]
            if not ready:
                continue
            m, v = min(ready, key=lambda mv: (-mv[1], mv[0]))
            del avail[p][(m, v)]
            row["exec_v"][p], row["exec_m"][p] = v, m
            if (m, v) in slot_of[p]:
                s = slot_of[p].pop((m, v))
                row["read_slot"][p] = s
                free[p].insert(0, s)
            c = v * P + p
            if c == L - 1:
                row["out_m"][p] = m
            else:
                arriving[(p + 1) % P] = (m, v + (1 if p == P - 1 else 0))
            remaining -= 1
        for k in cols:
            cols[k].append(row[k])
        t += 1
        if t > 4 * L * M + L:  # pragma: no cover - schedule bug guard
            raise RuntimeError("interleave scheduler did not converge")
    return _InterleaveSchedule(
        T=t, Q=max(max_slot + 1, 1),
        **{k: np.asarray(v, np.int32) for k, v in cols.items()},
    )


def interleave_params(stacked: Any, n_stages: int, virtual_stages: int
                      ) -> Any:
    """Permute a ``[P·V, ...]``-stacked tree (arrays or tensors) from
    chunk order into device order: position ``p·V + v`` holds chunk ``v·P
    + p``, which runs on device ``p`` as its local slice ``v``; leaves of
    another leading dim pass through."""
    P, V = n_stages, virtual_stages
    idx = np.array([v * P + p for p in range(P) for v in range(V)])

    def perm(leaf):
        if not (getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == P * V):
            return leaf
        if isinstance(leaf, torch.Tensor):
            return leaf[torch.as_tensor(idx, device=leaf.device)]
        return leaf[idx]

    return tree_map(perm, stacked)


# ---- the stage ring and its hop ---------------------------------------------

def _check_wire(group, t: torch.Tensor) -> None:
    if t.is_cuda and dist.get_backend(group) == "gloo":
        raise ValueError(
            "pipeline hops of CUDA tensors need an NCCL group: gloo has no "
            "CUDA send/recv (one card holds one NCCL rank; run several "
            "stages on one card with mesh=None, local_stages=P)")


def _stage_hop(send_f, send_c, recv_f, recv_c, group):
    """One tick's exchange along the stage ring, in one
    ``batch_isend_irecv``: ``send_f`` to the next stage (``my + 1 mod
    n``, tpudist's ``ppermute`` with ``[(i, i + 1)]``), ``send_c`` to the
    previous one (``[(i, i − 1)]``), and the previous stage's activation
    and the next stage's cotangent received into new tensors of the specs
    ``recv_f``/``recv_c`` (``(shape, dtype, device)``; None: nothing
    comes).  Each end posts a message exactly where the tables say, so
    both post it at the same tick."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (my + 1) % n)
    prv = dist.get_global_rank(group, (my - 1) % n)
    ops, got = [], [None, None]
    for t, peer, tag in ((send_f, nxt, 0), (send_c, prv, 1)):
        if t is not None:
            _check_wire(group, t)
            ops.append(dist.P2POp(dist.isend, t.contiguous(), peer, group,
                                  tag))
    for i, (spec, peer) in enumerate(((recv_f, prv), (recv_c, nxt))):
        if spec is not None:
            got[i] = torch.empty(spec[0], dtype=spec[1], device=spec[2])
            _check_wire(group, got[i])
            ops.append(dist.P2POp(dist.irecv, got[i], peer, group, i))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got[0], got[1]


class _StageRing:
    """Where a pipeline's stages run: one a process along the mesh's
    stage axis (hops by :func:`_stage_hop`), or, with ``mesh=None`` and
    ``local_stages=P``, all ``P`` in this process (hops hand tensors
    over)."""

    def __init__(self, mesh, stage_axis: str, data_axis: str,
                 local_stages: int | None) -> None:
        self.mesh = mesh
        if mesh is None:
            if local_stages is None or local_stages < 1:
                raise ValueError("pass the mesh whose stage axis the "
                                 "pipeline runs on, or mesh=None with "
                                 "local_stages=P to run its P stages in "
                                 "this process")
            self.n, self.mine, self.group = local_stages, \
                list(range(local_stages)), None
            self.stage_groups, self.data_groups, self.n_data = [], [], 1
            return
        if local_stages is not None:
            raise ValueError("local_stages runs every stage in this process: "
                             "pass it with mesh=None")
        self.n = axis_size(mesh, stage_axis)
        self.n_data = axis_size(mesh, data_axis)
        self.mine = [axis_index(mesh, stage_axis)]
        self.group = mesh.get_group(stage_axis) if self.n > 1 else None
        if self.group is not None:
            # NCCL: a P2P batch may be a group's first collective only if
            # every rank joins it, and the first ticks' hops do not
            on_card = dist.get_backend(self.group) == "nccl"
            dist.all_reduce(torch.zeros(1, device="cuda" if on_card
                                        else "cpu"), group=self.group)
        self.stage_groups = axis_groups(mesh, [stage_axis])
        self.data_groups = axis_groups(mesh, [data_axis])

    def check(self, *tensors: torch.Tensor) -> None:
        """CUDA tensors on a gloo group raise before any work."""
        if self.mesh is None:
            return
        for t in tensors:
            _check_wire(None, t)

    def hop(self, sends: dict, expects: dict) -> dict:
        """``sends`` ``{p: (f, c)}`` of this tick's stages; ``expects``
        ``{p: (f_spec, c_spec)}`` of what their tables bank next tick.
        Returns ``{p: (f, c)}``: stage p's activation from p − 1 and
        cotangent from p + 1."""
        if self.group is not None:
            (p,) = self.mine
            return {p: _stage_hop(*sends[p], *expects[p], self.group)}
        n, out = self.n, {}
        for p in self.mine:
            got = (sends[(p - 1) % n][0], sends[(p + 1) % n][1])
            for g, spec, what in zip(got, expects[p], ("activation",
                                                       "cotangent")):
                if (g is None) != (spec is None):
                    raise RuntimeError(f"pipeline schedule fault: stage {p} "
                                       f"{'expects' if g is None else 'got'}"
                                       f" an unscheduled {what}")
            out[p] = got
        return out


def _check_microbatchable(b: int, num_microbatches: int) -> None:
    if b % num_microbatches:
        raise ValueError(
            f"local batch {b} not divisible by {num_microbatches} "
            "micro-batches")


def _microbatches(x: torch.Tensor, m: int) -> torch.Tensor:
    _check_microbatchable(x.shape[0], m)
    return x.reshape(m, x.shape[0] // m, *x.shape[1:])


def _sync_and_step(state: TrainState, ring: _StageRing, loss: torch.Tensor,
                   stage_summed: Sequence[torch.Tensor] = (),
                   leaf_sums: Sequence[tuple] = ()):
    """tpudist's sync after the schedule: the loss and the gradients of
    ``stage_summed`` summed over the stage axis, then every gradient and
    the loss averaged over data, then each parameter's gradient summed
    over the groups ``leaf_sums`` gives it (by parameter order; a 3-D
    step's replicated leaves over a tensor axis); then the optimizer's
    step."""
    params = list(state.model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_sum([loss] + [p.grad for p in stage_summed],
                   ring.stage_groups)
    grads = [p.grad for p in params]
    all_reduce_sum(grads + [loss], ring.data_groups)
    if ring.n_data > 1:
        inv = 1.0 / ring.n_data
        for g in grads:
            g.mul_(inv)
        loss.mul_(inv)
    by_groups: dict[tuple, list[torch.Tensor]] = {}
    for g, groups in zip(grads, leaf_sums):
        if groups:
            by_groups.setdefault(groups, []).append(g)
    for groups, same in by_groups.items():
        all_reduce_sum(same, list(groups))
    return state.apply_gradients(), {"loss": loss}


# ---- abstract evaluation (tpudist's eval_shape) -----------------------------

def _meta(tree: Any) -> Any:
    return tree_map(lambda t: torch.empty_like(t, device="meta")
                    if isinstance(t, torch.Tensor) else t, tree)


class _Bound(nn.Module):
    def __init__(self, fn, params: nn.Module) -> None:
        super().__init__()
        self.fn, self.params = fn, params

    def forward(self, x):
        return self.fn(self.params, x)


def _abstract(fn, params, x: torch.Tensor) -> torch.Tensor:
    """``fn(params, x)`` on meta tensors: the output's shape and dtype,
    no FLOPs."""
    with torch.no_grad():
        if isinstance(params, nn.Module):
            holder = _Bound(fn, params)
            swap = {k: torch.empty_like(v, device="meta") for k, v in
                    [*holder.named_parameters(), *holder.named_buffers()]}
            return torch.func.functional_call(holder, swap, (x,))
        return fn(_meta(params), x)


def _boundary_specs(stage_fns, params, mb_shape, x_dtype,
                    buf_dtype) -> list[tuple]:
    """``(shape, dtype)`` of each stage's input and of the last output,
    by abstract evaluation; a non-floating boundary raises (it cannot
    round-trip through the ``buf_dtype`` buffer)."""
    def checked(spec):
        if not spec[1].is_floating_point:
            raise ValueError(
                f"stage-boundary dtype {spec[1]} cannot round-trip through "
                f"the {buf_dtype} pipeline buffer; move integer inputs (e.g. "
                "token-id embedding) inside stage 0")
        return spec

    specs = [checked((tuple(mb_shape), x_dtype))]
    for fn, p in zip(stage_fns, params):
        out = _abstract(fn, p, torch.empty(specs[-1][0], dtype=specs[-1][1],
                                           device="meta"))
        specs.append(checked((tuple(out.shape), out.dtype)))
    return specs


# ---- the GPipe family: forward table, then the same table in reverse --------

class _ChunkWalk:
    """One stage's part of a GPipe-family step: the forward table walked
    forward, building each chunk's autograd graph (tpudist's
    ``_run_schedule`` and the interleaved scan), then in reverse, one
    explicit backward a tick (the transposed scan).  ``run(v, buf)``
    applies local chunk ``v`` to a transport buffer; ``encode`` makes
    chunk 0's buffer from a micro-batch of ``xs``; ``in_spec(v)`` is the
    ``(shape, dtype, device)`` of chunk v's input buffer and
    ``out_spec(v)`` of its output."""

    def __init__(self, p: int, sched: _InterleaveSchedule, n: int, run,
                 encode, xs: torch.Tensor, in_spec, out_spec,
                 train: bool) -> None:
        self.p, self.s, self.n, self.run, self.encode = p, sched, n, run, \
            encode
        self.xs, self.in_spec, self.out_spec = xs, in_spec, out_spec
        self.train = train
        self.queue: dict[int, torch.Tensor] = {}
        self.saved: dict[tuple, tuple] = {}
        self.outputs: dict[int, torch.Tensor] = {}
        self.cots: dict[tuple, torch.Tensor] = {}

    def _exec(self, t: int, p: int | None = None) -> tuple[int, int]:
        p = self.p if p is None else p
        return int(self.s.exec_v[t, p]), int(self.s.exec_m[t, p])

    def fwd_expect(self, t: int) -> tuple:
        """What this stage banks at the start of forward tick ``t``."""
        if t >= self.s.T or self.s.recv_slot[t, self.p] < 0:
            return None, None
        q = (self.p - 1) % self.n
        return self.in_spec(self._exec(t - 1, q)[0] + (q == self.n - 1)), \
            None

    def fwd_tick(self, t: int, recv: tuple) -> tuple:
        s, p = self.s, self.p
        if s.recv_slot[t, p] >= 0:
            self.queue[int(s.recv_slot[t, p])] = recv[0]
        v, m = self._exec(t)
        if v < 0:
            return None, None
        read = int(s.read_slot[t, p])
        if read >= 0:
            buf = self.queue.pop(read)
            if self.train:
                buf.requires_grad_()
        else:
            buf = self.encode(self.xs[m])
        y = self.run(v, buf)
        if self.train:
            self.saved[(m, v)] = (buf if read >= 0 else None, y)
        if s.out_m[t, p] >= 0:
            self.outputs[m] = y
            return None, None
        return y.detach(), None

    def bwd_expect(self, t: int) -> tuple:
        """What arrives for reverse tick ``t``: the cotangent the next
        stage sent at reverse tick ``t + 1`` for one of our outputs."""
        if t < 0 or t + 1 >= self.s.T:
            return None, None
        q = (self.p + 1) % self.n
        vq, _ = self._exec(t + 1, q)
        if vq < 0 or vq * self.n + q == 0:
            return None, None
        return None, self.out_spec(vq - (q == 0))

    def bwd_tick(self, t: int, recv: tuple) -> tuple:
        if recv[1] is not None:
            q = (self.p + 1) % self.n
            vq, mq = self._exec(t + 1, q)
            self.cots[(mq, vq - (q == 0))] = recv[1]
        v, m = self._exec(t)
        if v < 0:
            return None, None
        buf, y = self.saved.pop((m, v))
        torch.autograd.backward(y, self.cots.pop((m, v)))
        if buf is None:
            return None, None
        return None, buf.grad if buf.grad is not None \
            else torch.zeros_like(buf)


def _gpipe_run(ring: _StageRing, sched: _InterleaveSchedule, walks, V: int,
               decode, loss_fn=None, target=None):
    """Walk the forward table on this process's stages, then (with a
    ``loss_fn``) the loss on the last stage and the table in reverse.
    Returns the loss (zero off the last stage) or, without a loss, the
    last stage's decoded outputs (None elsewhere)."""
    inbox = {w.p: (None, None) for w in walks}
    for t in range(sched.T):
        sends = {w.p: w.fwd_tick(t, inbox[w.p]) for w in walks}
        inbox = ring.hop(sends, {w.p: w.fwd_expect(t + 1) for w in walks})
    last = next((w for w in walks if w.p == ring.n - 1), None)
    outs = None
    if last is not None:
        ys = [last.outputs[m] for m in range(len(last.outputs))]
        outs = torch.cat([decode(y) for y in ys])
    if loss_fn is None:
        return outs
    device = walks[0].xs.device
    loss = torch.zeros((), dtype=torch.float32, device=device)
    if last is not None:
        full = loss_fn(outs, target)
        for m, g in enumerate(torch.autograd.grad(full, ys)):
            last.cots[(m, V - 1)] = g
        loss = full.detach().float().clone()
    inbox = {w.p: (None, None) for w in walks}
    for t in reversed(range(sched.T)):
        sends = {w.p: w.bwd_tick(t, inbox[w.p]) for w in walks}
        inbox = ring.hop(sends, {w.p: w.bwd_expect(t - 1) for w in walks})
    return loss


def _checkpointed(fn, remat: bool):
    if not remat:
        return fn
    return lambda *a: torch.utils.checkpoint.checkpoint(
        fn, *a, use_reentrant=False)


def _hetero_walks(ring, sched, stage_fns, stage_params, xs, specs,
                  buf_dtype, remat, train):
    """Walks of heterogeneous stages whose boundaries travel as
    ``buf_dtype`` buffers (tpudist's flattened, padded buffers, unpadded:
    each hop carries its own boundary's shape)."""
    dev = xs.device

    def buf_spec(s):
        return (specs[s][0], buf_dtype, dev)

    walks = []
    for p, params in zip(ring.mine, stage_params):
        def run(v, buf, p=p, params=params):
            def stage(b):
                return stage_fns[p](params, b.to(specs[p][1])).to(buf_dtype)
            return _checkpointed(stage, remat)(buf)

        walks.append(_ChunkWalk(
            p, sched, ring.n, run, lambda x: x.to(buf_dtype), xs,
            in_spec=lambda v, p=p: buf_spec(p),
            out_spec=lambda v, p=p: buf_spec(p + 1), train=train))
    return walks


def _cached_specs(cache: dict, stage_fns, params, xs, buf_dtype):
    key = (tuple(xs.shape[1:]), xs.dtype)
    if key not in cache:
        cache[key] = _boundary_specs(stage_fns, params, xs.shape[1:],
                                     xs.dtype, buf_dtype)
    return cache[key]


def make_pipeline_train_step(
    stage_fns: Sequence[StageFn],
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mesh,
    num_microbatches: int,
    data_axis: str = "data",
    stage_axis: str = "stage",
    remat: bool = False,
    donate: bool = True,
    buf_dtype: torch.dtype = torch.float32,
    *,
    local_stages: int | None = None,
):
    """Build ``train_step(state, x, y) -> (state, metrics)``: heterogeneous
    GPipe with every stage's parameters on every process.

    ``state.model[s]`` is stage ``s``'s parameters (an ``nn.ModuleList``
    of stage modules, or a :class:`ParamTree` of per-stage trees) and
    ``stage_fns[s](state.model[s], a)`` its function.  ``x``/``y`` are
    this process's data shard (every stage of a data row gets the same);
    the batch is split into ``num_microbatches`` contiguous micro-batches
    (the reference's ``xs.split(split_size)``).  Each process runs its
    stage of the GPipe fill-drain table, the loss ``loss_fn(out, y)`` is
    taken on the last stage over the whole local batch, the backward
    walks the table in reverse; gradients are summed over the stage
    group (each process holds only its own stage's), then averaged over
    data.  ``remat`` recomputes each stage application in the backward
    (``torch.utils.checkpoint``).  ``donate`` is accepted for tpudist's
    signature: an eager step updates the parameters in place."""
    del donate
    ring = _StageRing(mesh, stage_axis, data_axis, local_stages)
    if len(stage_fns) != ring.n:
        raise ValueError(
            f"{len(stage_fns)} stage fns but mesh {stage_axis}={ring.n}")
    M = num_microbatches
    sched = _interleave_schedule(ring.n, 1, M)
    cache: dict = {}

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        ring.check(x, y, *state.model.parameters())
        xs = _microbatches(x, M)
        all_params = [state.model[s] for s in range(ring.n)]
        specs = _cached_specs(cache, stage_fns, all_params, xs, buf_dtype)
        state.optimizer.zero_grad(set_to_none=True)
        walks = _hetero_walks(ring, sched, stage_fns,
                              [all_params[p] for p in ring.mine], xs, specs,
                              buf_dtype, remat, train=True)
        out_dtype = specs[-1][1]
        loss = _gpipe_run(ring, sched, walks, 1, lambda a: a.to(out_dtype),
                          loss_fn, y)
        return _sync_and_step(state, ring, loss,
                              list(state.model.parameters()))

    return train_step


def make_pipeline_forward(
    stage_fns: Sequence[StageFn],
    mesh,
    num_microbatches: int,
    data_axis: str = "data",
    stage_axis: str = "stage",
    buf_dtype: torch.dtype = torch.float32,
    *,
    local_stages: int | None = None,
):
    """Inference-only pipelined forward: ``fn(params, x) -> out`` with
    ``params[s]`` stage ``s``'s parameters; every stage of a data row
    returns its shard's output (summed over the stage group, where only
    the last stage's is not zero, as tpudist's ``psum``)."""
    ring = _StageRing(mesh, stage_axis, data_axis, local_stages)
    M = num_microbatches
    sched = _interleave_schedule(ring.n, 1, M)
    cache: dict = {}

    def forward(params, x: torch.Tensor) -> torch.Tensor:
        all_params = [params[s] for s in range(ring.n)]
        ring.check(x)
        xs = _microbatches(x, M)
        specs = _cached_specs(cache, stage_fns, all_params, xs, buf_dtype)
        with torch.no_grad():
            walks = _hetero_walks(ring, sched, stage_fns,
                                  [all_params[p] for p in ring.mine], xs,
                                  specs, buf_dtype, False, train=False)
            out_shape, out_dtype = specs[-1]
            outs = _gpipe_run(ring, sched, walks, 1,
                              lambda a: a.to(out_dtype))
            if outs is None:
                outs = torch.zeros((x.shape[0], *out_shape[1:]),
                                   dtype=out_dtype, device=x.device)
            all_reduce_sum([outs], ring.stage_groups)
        return outs

    return forward


# ---- packed: heterogeneous stages, stage-sharded parameters -----------------

@dataclasses.dataclass(frozen=True)
class StagePacking:
    """What maps heterogeneous per-stage parameter trees onto one
    ``[n_stages, width]`` buffer shardable over the stage axis."""

    treedefs: tuple  # per stage: the tree with None at its leaves
    shapes: tuple    # per stage: tuple of leaf shapes
    dtypes: tuple    # per stage: tuple of leaf dtypes
    width: int       # padded flat width = widest stage's element count

    @property
    def n_stages(self) -> int:
        return len(self.treedefs)


def _sorted_leaves(tree: Any) -> list:
    """Leaves in ``jax.tree.flatten``'s order (mapping keys sorted), so a
    packed row is tpudist's bit for bit."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _sorted_unflatten(template: Any, leaves) -> Any:
    if isinstance(template, Mapping):
        got = {k: _sorted_unflatten(template[k], leaves)
               for k in sorted(template)}
        return {k: got[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_sorted_unflatten(v, leaves)
                              for v in template)
    return next(leaves)


def pack_stage_params(stage_params: Sequence[Any],
                      buf_dtype: torch.dtype = torch.float32):
    """Flatten heterogeneous per-stage trees (arrays or tensors, e.g. each
    stage module's ``state_dict()``) into one ``[n_stages, width]``
    tensor (each stage's leaves raveled in ``jax.tree.flatten``'s order,
    mapping keys sorted, concatenated,
    zero-padded to the widest stage) plus the :class:`StagePacking` that
    inverts it.  Cut over the stage axis (:func:`shard_stage_params` with
    ``{".": ("stage",)}``), each process holds only its own stage's
    row."""
    treedefs, shapes, dtypes, vecs = [], [], [], []
    for tree in stage_params:
        leaves = [_tensor(x) for x in _sorted_leaves(tree)]
        for leaf in leaves:
            if not leaf.dtype.is_floating_point:
                raise ValueError(
                    f"packed pipeline params must be floating to share one "
                    f"buffer; got {leaf.dtype}")
        treedefs.append(tree_map(lambda _: None, tree))
        shapes.append(tuple(tuple(leaf.shape) for leaf in leaves))
        dtypes.append(tuple(leaf.dtype for leaf in leaves))
        vecs.append(torch.cat([leaf.reshape(-1).to(buf_dtype)
                               for leaf in leaves]) if leaves
                    else torch.zeros((0,), dtype=buf_dtype))
    width = max(v.shape[0] for v in vecs)
    flat = torch.stack([torch.nn.functional.pad(v, (0, width - v.shape[0]))
                        for v in vecs])
    return flat, StagePacking(tuple(treedefs), tuple(shapes), tuple(dtypes),
                              width)


def unpack_stage(vec: torch.Tensor, meta: StagePacking, s: int) -> Any:
    """Stage ``s``'s parameter tree from its flat ``[width]`` row: views
    of ``vec`` reshaped and cast to each leaf's dtype (differentiable: the
    gradients land in ``vec``)."""
    sizes = [math.prod(shape) for shape in meta.shapes[s]]
    # one split, so the backward writes the row's gradient in one piece
    parts = vec[:sum(sizes)].split(sizes)
    leaves = [part.reshape(shape).to(dt) for part, shape, dt in
              zip(parts, meta.shapes[s], meta.dtypes[s])]
    return _sorted_unflatten(meta.treedefs[s], iter(leaves))


def unpack_stage_params(flat: torch.Tensor, meta: StagePacking) -> tuple:
    """Invert :func:`pack_stage_params` (for export)."""
    return tuple(unpack_stage(flat[s], meta, s)
                 for s in range(meta.n_stages))


def make_packed_pipeline_train_step(
    stage_fns: Sequence[StageFn],
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mesh,
    num_microbatches: int,
    meta: StagePacking,
    state_example: TrainState,
    data_axis: str = "data",
    stage_axis: str = "stage",
    remat: bool = False,
    donate: bool = True,
    buf_dtype: torch.dtype = torch.float32,
    *,
    local_stages: int | None = None,
):
    """Heterogeneous GPipe with STAGE-SHARDED parameters: the schedule and
    numerics of :func:`make_pipeline_train_step`, but ``state.model`` is a
    :class:`ParamTree` holding this process's ``[1, width]`` row of
    :func:`pack_stage_params`' buffer (all ``[n_stages, width]`` with
    ``local_stages``), so a process holds the widest stage's parameters
    and moments, not the sum.  Each stage unpacks its own row
    (:func:`unpack_stage`) for ``stage_fns[s](tree, a)``; the optimizer
    runs elementwise on the row (padding gets zero gradients); gradients
    are averaged over data only."""
    del donate
    ring = _StageRing(mesh, stage_axis, data_axis, local_stages)
    if meta.n_stages != ring.n or len(stage_fns) != ring.n:
        raise ValueError(
            f"{len(stage_fns)} stage fns / {meta.n_stages} packed stages "
            f"but mesh {stage_axis}={ring.n}")
    rows = tuple(_model_tree(state_example).shape)
    if rows != (len(ring.mine), meta.width):
        raise ValueError(f"packed params {rows}, want {(len(ring.mine), meta.width)}"
                         " (this process's rows of the packed buffer)")
    structs = [_sorted_unflatten(meta.treedefs[s], iter([
        torch.empty(sh, dtype=dt, device="meta")
        for sh, dt in zip(meta.shapes[s], meta.dtypes[s])]))
        for s in range(ring.n)]
    M = num_microbatches
    sched = _interleave_schedule(ring.n, 1, M)
    cache: dict = {}

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        ring.check(x, y, *state.model.parameters())
        xs = _microbatches(x, M)
        specs = _cached_specs(cache, stage_fns, structs, xs, buf_dtype)
        state.optimizer.zero_grad(set_to_none=True)
        vec = _model_tree(state)
        # each stage's leaves as their own tensors for the step: the
        # micro-batches' gradients accumulate leaf by leaf, and the row's
        # gradient is written once at the end
        trees = [unpack_stage(vec[i].detach(), meta, p)
                 for i, p in enumerate(ring.mine)]
        leaves = [[leaf.requires_grad_() for leaf in _sorted_leaves(t)]
                  for t in trees]
        walks = _hetero_walks(ring, sched, stage_fns, trees, xs, specs,
                              buf_dtype, remat, train=True)
        out_dtype = specs[-1][1]
        loss = _gpipe_run(ring, sched, walks, 1, lambda a: a.to(out_dtype),
                          loss_fn, y)
        vec.grad = torch.stack([torch.nn.functional.pad(torch.cat(
            [(leaf.grad if leaf.grad is not None else torch.zeros_like(leaf))
             .reshape(-1).to(vec.dtype) for leaf in row]),
            (0, meta.width - sum(leaf.numel() for leaf in row)))
            for row in leaves])
        return _sync_and_step(state, ring, loss)

    return train_step


# ---- stacked and interleaved: homogeneous blocks ----------------------------

def _check_stacked(tree, per: int, what: str, full: int) -> None:
    for path, leaf in _leaves(tree):
        if not (getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == per):
            raise ValueError(
                f"{what} requires every param leaf stacked [{full}, ...], "
                f"this process holding its [{per}, ...] block; {path} has "
                f"shape {tuple(getattr(leaf, 'shape', ()))}")


def _chunk(tree, i: int) -> Any:
    return tree_map(lambda leaf: leaf[i], tree)


def _leaf_sums(mesh, state_example, state_specs, grad_sync_axes,
               data_axis: str, stage_axis: str) -> list[tuple]:
    """tpudist's per-leaf plan for a stacked step given ``state_specs``:
    each leaf's spec must shard its leading (stage) dimension over
    ``stage_axis``; its gradient is summed over every axis of
    ``grad_sync_axes`` (a sequence for every leaf, or ``{path: axes}`` by
    the tree's leaf paths) its spec does not name.  ``grad_sync_axes``
    is required when the mesh has axes beyond data and stage: a sum is
    right only for leaves whose cotangents are per-shard partials (used
    between the Megatron f and g), and would scale any other by the axis
    size.  Returns the groups to sum over, by parameter order."""
    from tpudist_torch.parallel.tensor_parallel import spec_axes

    pspecs = state_specs.get("params", state_specs)
    paths = [p for p, _ in _leaves(_model_tree(state_example))]
    if list(pspecs) != paths:
        raise ValueError(f"state_specs name {list(pspecs)}, the state's "
                         f"leaves are {paths}")
    for path, spec in pspecs.items():
        if not (len(spec) >= 1 and spec[0] == stage_axis):
            raise ValueError(
                f"state_specs param leaf {path} must shard its leading "
                f"(stage) dim over {stage_axis!r}; got {spec}")
    if grad_sync_axes is None:
        extra = tuple(a for a in (mesh.mesh_dim_names if mesh is not None
                                  else ())
                      if a not in (data_axis, stage_axis))
        if extra:
            raise ValueError(
                f"state_specs given with extra mesh axes {extra}: pass "
                f"grad_sync_axes explicitly — grad_sync_axes={extra} to "
                "psum partial-cotangent replicated leaves over them, "
                "grad_sync_axes=() if every replicated leaf's gradient is "
                "already complete, or a per-leaf mapping for mixed blocks")
        grad_sync_axes = ()
    if isinstance(grad_sync_axes, Mapping):
        if list(grad_sync_axes) != paths:
            raise ValueError(f"grad_sync_axes names {list(grad_sync_axes)}"
                             f", the state's leaves are {paths}")
        per_leaf = [tuple(grad_sync_axes[p]) for p in paths]
    else:
        per_leaf = [tuple(grad_sync_axes)] * len(paths)
    return [tuple(mesh.get_group(a) for a in sync
                  if a not in spec_axes(pspecs[path]))
            if mesh is not None else ()
            for path, sync in zip(paths, per_leaf)]


def _homogeneous_step(ring, sched, block_fn, loss_fn, V, M, remat,
                      leaf_sums=()):
    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        ring.check(x, y, *state.model.parameters())
        xs = _microbatches(x, M)
        tree = _model_tree(state)
        state.optimizer.zero_grad(set_to_none=True)
        spec = (tuple(xs.shape[1:]), xs.dtype, xs.device)
        walks = []
        for i, p in enumerate(ring.mine):
            def run(v, a, off=i * V):
                return _checkpointed(block_fn, remat)(_chunk(tree, off + v),
                                                      a)
            walks.append(_ChunkWalk(p, sched, ring.n, run, lambda a: a, xs,
                                    lambda v: spec, lambda v: spec,
                                    train=True))
        loss = _gpipe_run(ring, sched, walks, V, lambda a: a, loss_fn, y)
        return _sync_and_step(state, ring, loss, leaf_sums=leaf_sums)

    return train_step


def make_stacked_pipeline_train_step(
    block_fn: StageFn,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mesh,
    num_microbatches: int,
    state_example: TrainState,
    data_axis: str = "data",
    stage_axis: str = "stage",
    remat: bool = False,
    donate: bool = True,
    state_specs=None,
    grad_sync_axes=None,
    *,
    local_stages: int | None = None,
):
    """GPipe of HOMOGENEOUS blocks with stage-sharded parameters:
    ``state.model`` is a :class:`ParamTree` of the ``[n_stages, ...]``
    stacked block parameters cut to this process's ``[1, ...]`` slice
    (:func:`shard_stage_params` with :func:`stacked_state_specs`), and
    ``block_fn(chunk, a)`` maps activations to same-shaped activations.
    Gradients are averaged over data only.  ``train_step.bubble_fraction``
    is GPipe's ``(P-1)/(M+P-1)``.

    ``state_specs`` (:func:`state_specs_like` of ``{path: spec}``, each
    leading with ``stage_axis``) shards leaves over further axes too: the
    3-D DP×PP×TP step, whose ``block_fn`` is a tensor-parallel block built
    from :func:`~tpudist_torch.parallel.common.id_fwd_psum_bwd` and
    :func:`~tpudist_torch.parallel.common.psum_fwd_id_bwd` on the model
    axis's group, and the state holds this process's block of every leaf
    (:func:`shard_stage_params` with the same specs).  A leaf left
    replicated over a tensor axis and used between f and g gets per-shard
    partial gradients, summed over each ``grad_sync_axes`` axis missing
    from its spec (tpudist's opt-in: required whenever the mesh has axes
    beyond data and stage; ``()`` for none; ``{path: axes}`` per leaf)."""
    del donate
    ring = _StageRing(mesh, stage_axis, data_axis, local_stages)
    _check_stacked(_model_tree(state_example), len(ring.mine),
                   "stacked pipeline", ring.n)
    leaf_sums = ([] if state_specs is None else
                 _leaf_sums(mesh, state_example, state_specs,
                            grad_sync_axes, data_axis, stage_axis))
    M = num_microbatches
    step = _homogeneous_step(ring, _interleave_schedule(ring.n, 1, M),
                             block_fn, loss_fn, 1, M, remat, leaf_sums)
    step.bubble_fraction = (ring.n - 1) / (M + ring.n - 1)
    return step


def make_interleaved_pipeline_train_step(
    block_fn: StageFn,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mesh,
    num_microbatches: int,
    virtual_stages: int,
    state_example: TrainState,
    data_axis: str = "data",
    stage_axis: str = "stage",
    remat: bool = False,
    donate: bool = True,
    *,
    local_stages: int | None = None,
):
    """Interleaved (virtual-stage) GPipe of HOMOGENEOUS blocks: each stage
    holds ``virtual_stages`` chunks of the ``P·V``-deep stack, chunk ``c``
    on stage ``c mod P`` (stack them in device order with
    :func:`interleave_params`, then cut each process's ``[V, ...]``
    block); micro-batches loop the ring ``V`` times along
    :func:`_interleave_schedule`'s table, and the backward walks it in
    reverse.  ``train_step.schedule`` is the table,
    ``train_step.bubble_fraction`` ``(T − V·M)/T``."""
    del donate
    ring = _StageRing(mesh, stage_axis, data_axis, local_stages)
    V, M = virtual_stages, num_microbatches
    _check_stacked(_model_tree(state_example), V * len(ring.mine),
                   "interleaved pipeline", ring.n * V)
    sched = _interleave_schedule(ring.n, V, M)
    step = _homogeneous_step(ring, sched, block_fn, loss_fn, V, M, remat)
    step.schedule = sched
    step.bubble_fraction = (sched.T - V * M) / sched.T
    return step


# ---- 1F1B -------------------------------------------------------------------

class _OneFOneBStage:
    """One stage's 1F1B ticks (the body of tpudist's scan): bank the
    arrivals the table names; a forward tick runs chunk ``v`` without a
    graph and sends its output down the ring; a backward tick recomputes
    the chunk from the banked input (or, for chunk 0, from ``xs`` through
    the embedding), seeds the last chunk from the loss scaled ``1/M`` or
    takes the cotangent that came up the ring, runs one explicit
    backward (the chunk's gradients accumulate in its rows of the stacked
    parameters, the embedding's and head's in ``extra``) and sends the
    input's cotangent up the ring."""

    def __init__(self, p: int, sched: _OneFOneBSchedule, n: int, V: int,
                 chunk, chunk0_in, block_fn, seed_loss, ys, act_spec,
                 inv_m: float) -> None:
        self.p, self.s, self.n, self.V = p, sched, n, V
        self.chunk, self.chunk0_in, self.block_fn = chunk, chunk0_in, \
            block_fn
        self.seed_loss, self.ys, self.act_spec = seed_loss, ys, act_spec
        self.inv_m = inv_m
        self.act_q: dict[int, torch.Tensor] = {}
        self.cot_q: dict[int, torch.Tensor] = {}
        self.loss = torch.zeros((), dtype=torch.float32, device=act_spec[2])

    def expect(self, t: int) -> tuple:
        if t >= self.s.T:
            return None, None
        f, c = self.s.frecv[t, self.p], self.s.crecv[t, self.p]
        return (self.act_spec if f >= 0 else None,
                self.act_spec if c >= 0 else None)

    def tick(self, t: int, recv: tuple) -> tuple:
        s, p = self.s, self.p
        if s.frecv[t, p] >= 0:
            self.act_q[int(s.frecv[t, p])] = recv[0]
        if s.crecv[t, p] >= 0:
            self.cot_q[int(s.crecv[t, p])] = recv[1]
        kind = int(s.kind[t, p])
        if kind < 0:
            return None, None
        m, v, fread = int(s.m[t, p]), int(s.v[t, p]), int(s.fread[t, p])
        last = v * self.n + p == self.n * self.V - 1
        if kind == 0:
            with torch.no_grad():
                a = self.act_q[fread] if fread >= 0 else self.chunk0_in(m)
                out = self.block_fn(self.chunk(v), a)
            return (None if last else out.to(self.act_spec[1])), None
        a = (self.act_q.pop(fread).detach().requires_grad_()
             if fread >= 0 else None)
        with torch.enable_grad():
            out = self.block_fn(self.chunk(v),
                                a if a is not None else self.chunk0_in(m))
            if last:
                l_m = self.seed_loss(out, self.ys[m])
                torch.autograd.backward(l_m, torch.full_like(l_m,
                                                             self.inv_m))
                self.loss += (l_m.detach() * self.inv_m).float()
            else:
                cot = self.cot_q.pop(int(s.cread[t, p]))
                torch.autograd.backward(out, cot.to(out.dtype))
        if a is None:
            return None, None
        g = a.grad if a.grad is not None else torch.zeros_like(a)
        return None, g.to(self.act_spec[1])


def make_1f1b_pipeline_train_step(
    block_fn: StageFn,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None,
    mesh,
    num_microbatches: int,
    state_example: TrainState,
    data_axis: str = "data",
    stage_axis: str = "stage",
    donate: bool = True,
    virtual_stages: int = 1,
    embed_fn: Callable[[Any, torch.Tensor], torch.Tensor] | None = None,
    head_loss_fn: Callable[[Any, torch.Tensor, torch.Tensor],
                           torch.Tensor] | None = None,
    *,
    local_stages: int | None = None,
):
    """1F1B pipeline of HOMOGENEOUS blocks with stage-sharded parameters.

    ``state.model`` is a :class:`ParamTree` of the ``[P·V, ...]``-stacked
    block parameters (device order, :func:`interleave_params`), this
    process holding its ``[V, ...]`` block; ``block_fn(chunk, a)`` maps
    activations to same-shaped activations and ``loss_fn(out, y)`` is a
    mean over its micro-batch.  Each tick runs what
    :func:`_one_f_one_b_schedule`'s column for this stage says: a
    forward (its input banked), or a backward recomputed from the banked
    input — activation memory is the in-flight count, not ``M``.
    ``virtual_stages > 1`` is the interleaved (Megatron) 1F1B.

    Real-model mode (``embed_fn`` / ``head_loss_fn``): the tree is
    ``{"stages": stacked, "extra": extra}``, ``extra`` (embedding, final
    norm, head) held whole on every process; ``embed_fn(extra, x_mb)``
    makes chunk 0's activations (their shape and dtype may differ from
    the input's), ``head_loss_fn(extra, out, y_mb)`` replaces
    ``loss_fn`` on the last chunk.  ``extra``'s gradients come from the
    chunk-0 and last-chunk backward ticks and are summed over the stages,
    then averaged over data.  ``train_step.schedule`` is the table,
    ``train_step.bubble_fraction`` ``(T − 2·V·M)/T``."""
    del donate
    ring = _StageRing(mesh, stage_axis, data_axis, local_stages)
    M, V = num_microbatches, virtual_stages
    sched = _one_f_one_b_schedule(ring.n, M, V)
    extra_mode = embed_fn is not None or head_loss_fn is not None
    tree = _model_tree(state_example)
    if extra_mode:
        if not (isinstance(tree, Mapping) and set(tree) >= {"stages",
                                                            "extra"}):
            raise ValueError("embed_fn/head_loss_fn require the tree "
                             '{"stages": stacked_tree, "extra": extra_tree}')
        if head_loss_fn is None and loss_fn is None:
            raise ValueError("pass head_loss_fn or loss_fn for the last chunk")
        tree = tree["stages"]
    _check_stacked(tree, V * len(ring.mine), "1F1B pipeline",
                   ring.n * V)
    inv_m = 1.0 / M

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        ring.check(x, y, *state.model.parameters())
        xs, ys = _microbatches(x, M), _microbatches(y, M)
        tree = _model_tree(state)
        stages, extra = (tree["stages"], tree["extra"]) if extra_mode \
            else (tree, {})
        state.optimizer.zero_grad(set_to_none=True)
        if embed_fn is not None:
            act = _abstract(embed_fn, extra, xs[0].to("meta"))
            act_spec = (tuple(act.shape), act.dtype, x.device)

            def chunk0_in(m):
                return embed_fn(extra, xs[m])
        else:
            act_spec = (tuple(xs.shape[1:]), xs.dtype, x.device)

            def chunk0_in(m):
                return xs[m].to(act_spec[1])

        def seed_loss(out, ym):
            if head_loss_fn is not None:
                return head_loss_fn(extra, out, ym)
            return loss_fn(out, ym)

        stages_here = [
            _OneFOneBStage(p, sched, ring.n, V,
                           lambda v, off=i * V: _chunk(stages, off + v),
                           chunk0_in, block_fn, seed_loss, ys, act_spec,
                           inv_m)
            for i, p in enumerate(ring.mine)]
        inbox = {w.p: (None, None) for w in stages_here}
        for t in range(sched.T):
            sends = {w.p: w.tick(t, inbox[w.p]) for w in stages_here}
            inbox = ring.hop(sends, {w.p: w.expect(t + 1)
                                     for w in stages_here})
        loss = sum(w.loss for w in stages_here)
        return _sync_and_step(state, ring, loss,
                              [leaf for _, leaf in _leaves(extra)])

    train_step.schedule = sched
    train_step.bubble_fraction = (sched.T - 2 * V * M) / sched.T
    return train_step
