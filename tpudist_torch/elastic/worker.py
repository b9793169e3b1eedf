"""The TTL-driven elastic worker loop — rendezvous-driven recovery
(counterpart of :mod:`tpudist.elastic.worker`, its host data plane).

This is the piece that makes the coordination service (``native/coord.cpp``
+ :mod:`tpudist_torch.runtime.coord`) *drive* elastic training the way the
reference's control planes do: torchrun's c10d rendezvous re-forms the world
on membership change (`pytorch_elastic/mnist_ddp_elastic.py:5-6`) and
Horovod's elastic driver rolls back and re-assembles on host add/drop
(`horovod/horovod_mnist_elastic.py:55,108`).  Here, in one loop per worker:

1. heartbeat (TTL lease) starts before anything else — liveness IS
   membership;
2. :meth:`~tpudist_torch.runtime.coord.Rendezvous.join_live` forms the round from
   whatever workers are alive (world size *discovered*, not prescribed);
3. committed state is broadcast from the round's most advanced member so
   every participant resumes bitwise identically;
4. training runs with :class:`~tpudist_torch.runtime.collectives.HostCollectives`
   whose waits poll :meth:`ElasticMonitor.check` — a ``kill -9``'d peer
   surfaces as :class:`WorldChanged` at the next commit point OR mid-
   allreduce, whichever comes first (TTL detection, no exit-code polling);
5. on :class:`WorldChanged`: rollback to the last commit, fire reset
   callbacks (lr/√N rescale, `horovod_mnist_elastic.py:80-82`), bump the
   round, re-rendezvous at the new size, resume — within one commit
   interval of the pre-failure state.

Round agreement: the store key ``{ns}/round`` publishes the active round.
A fresh worker joining mid-run reads it and registers for ``round + 1``;
its heartbeat makes the incumbents' next ``check()`` raise
:class:`WorldChanged`, and everyone converges on ``round + 1`` — the grow
path and the shrink path are the same code.

Devices: a worker's state lives on :func:`worker_device`'s device.
Several workers may share one card on the host plane: its gang needs no
process group (the data plane is the store).  Survivors agree bit for bit
because every rank applies the same reduced bytes with the same optimizer
kernels on the same kind of device.

``data_plane="ici"`` (tpudist's per-round ``jax.distributed`` world,
``runtime/ici.py``) is a per-round ``torch.distributed`` process group
here (:mod:`tpudist_torch.runtime.ici`): NCCL on cards, gloo on the CPU,
or gloo on cards when asked for (one card holds one NCCL rank).
tpudist's flight-recorder dump of a crashed worker and its obs counters
wait for the observability plane, ROADMAP Queue A 10 — until then the
round events go to :data:`recorded` and the counts to :data:`counters`,
both plain.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from tpudist_torch.elastic.loop import WorldChanged
from tpudist_torch.elastic.state import (
    ElasticState,
    load_state_tree,
    state_tree,
)
from tpudist_torch.runtime.collectives import (
    CollectiveConfig,
    Handle,
    HostCollectives,
    PeerLost,
    _flatten,
)
from tpudist_torch.runtime.coord import (
    CoordClient,
    ElasticMonitor,
    Rendezvous,
)
from tpudist_torch.utils.device import resolve_device
from tpudist_torch.utils.logging import get_logger

log = get_logger(__name__)

# tpudist's obs counters and flight-recorder events, kept plain: counts by
# name, and the last round/world-change/peer-loss events with their wall
# time (``t``), which the elastic chip_smoke phase reads
counters = {"rounds": 0, "rendezvous_timeouts": 0, "world_changed": 0,
            "peer_lost": 0}
recorded: collections.deque = collections.deque(maxlen=1000)


def _record(event: str, **fields: Any) -> None:
    recorded.append({"event": event, "t": time.time(), **fields})


def worker_device(device: str | torch.device | None = None) -> torch.device:
    """The device an elastic worker trains on: ``device``, else
    ``TPUDIST_DEVICE`` (the launcher's), else ``cuda``.  A CUDA worker
    without an index takes card ``TPUDIST_LOCAL_RANK % device_count``, so
    a gang larger than the host's cards shares them.  Raises on a host
    without CUDA unless the CPU is asked for."""
    dev = resolve_device(device or os.environ.get("TPUDIST_DEVICE")
                         or "cuda")
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("TPUDIST_LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def _tree_map2(fn: Callable[[Any, Any], Any], a: Any, b: Any) -> Any:
    la, rebuild = _flatten(a)
    lb, _ = _flatten(b)
    return rebuild([fn(x, y) for x, y in zip(la, lb)])


def _nbytes(value: Any) -> int:
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return np.asarray(value).nbytes


@dataclasses.dataclass
class ElasticContext:
    """Per-round handles passed to the train function.

    ``collectives`` is the round's DATA plane: :class:`HostCollectives`
    (store-backed, ``data_plane="host"``) or :class:`~tpudist_torch.runtime.
    ici.IciCollectives` over the round's process group (``"ici"``), which
    is then ``mesh``; ``mesh`` stays None on the host plane."""

    rank: int
    world_size: int
    round: int
    collectives: Any
    monitor: ElasticMonitor
    mesh: Any = None
    data_plane: str = "host"

    def check(self) -> None:
        """Membership probe — call at commit points (the Horovod per-commit
        poll); raises :class:`WorldChanged` on TTL-detected add/drop."""
        self.monitor.check()


# train_fn(state, ctx) trains from state.host's position, calling
# state.commit() + ctx.check() at its commit points and
# ctx.collectives.allreduce_mean(...) for gradient sync.
TrainFn = Callable[[ElasticState, ElasticContext], None]


class OverlappedGradSync:
    """Microbatch gradient sync that overlaps wire time with compute —
    the ``hvd.DistributedOptimizer`` pattern (`mnist_horovod.py:53`:
    allreduce of microbatch ``m`` rides the background worker while the
    caller computes microbatch ``m+1``), with the final state BITWISE
    identical to the synchronous path.

    Usage inside a train function::

        sync = OverlappedGradSync(ctx.collectives)
        for mb in microbatches:
            sync.push(grad_fn(params, mb))   # starts the allreduce
            # ... next microbatch's forward/backward overlaps it ...
        total = sync.reduce()                # waits, sums in push order

    Determinism: handles are waited in submission order and summed in
    that same fixed order, so the result equals summing the synchronous
    allreduce outputs — no stale-gradient pipelining, no reordering.
    Falls back to synchronous allreduce when the plane has no async API
    (custom planes).  Values may be numpy arrays or tensors (a CUDA
    tensor's host copy starts when its bucket fires, so the caller may
    overwrite the gradient afterwards).

    **Bucketed backward-order mode** (``bucket_bytes`` set): instead of
    pushing whole trees per microbatch, the train loop streams named
    gradients in the order the backward pass produces them::

        sync = OverlappedGradSync(ctx.collectives, bucket_bytes=1 << 20)
        sync.hook(model)        # grad_ready(name, p.grad) from each
        loss.backward()         # parameter's post-accumulate-grad hook
        total = sync.reduce(mean=True)           # dict name -> gradient

    Step 1 records arrival order and greedily packs consecutive names
    into buckets of ``>= bucket_bytes``; :meth:`reduce` freezes that
    plan.  From step 2 on, a bucket's allreduce is submitted the moment
    its LAST member gradient lands — communication of early (deep)
    layers overlaps the rest of the backward pass.  Buckets are always
    SUBMITTED in plan order (a ready bucket waits for its predecessors),
    so every rank issues the same collectives in the same sequence even
    under arrival jitter — the op-id agreement `HostCollectives`
    requires.  The recorded order itself must match across ranks, which
    SPMD replicas guarantee (same model, same backward).  Each name
    belongs to exactly one bucket and cross-bucket results are merely
    merged (no arithmetic), so the result is bitwise what per-name
    synchronous allreduces would return."""

    def __init__(self, collectives: Any,
                 bucket_bytes: int | None = None) -> None:
        self._coll = collectives
        self._async = getattr(collectives, "allreduce_sum_async", None)
        self._handles: list[tuple[Handle | Any, bool]] = []
        if bucket_bytes is not None and bucket_bytes < 1:
            raise ValueError(f"bucket_bytes must be >= 1: {bucket_bytes}")
        self._bucket_bytes = bucket_bytes
        self._plan: list[list[str]] | None = None   # frozen after step 1
        self._member: dict[str, int] = {}           # name -> bucket index
        self._order: list[str] = []                 # step-1 arrival order
        self._pending: dict[str, np.ndarray] = {}   # landed, not yet fired
        self._counts: dict[str, int] = {}           # local adds per name
        self._inflight: list[tuple[int, Any, bool]] = []  # (bi, h, is_async)
        self._next_fire = 0                         # plan-order cursor
        self._open_bytes = 0                        # step-1 greedy packing

    def push(self, tree: Any) -> None:
        """Submit one microbatch's gradient tree for summing across ranks."""
        if self._pending or self._inflight or self._order \
                or self._plan is not None:
            raise ValueError(
                "push() cannot be mixed with grad_ready() on one "
                "OverlappedGradSync: the instance is in bucketed mode")
        if self._async is not None:
            self._handles.append((self._async(tree), True))
        else:
            self._handles.append((self._coll.allreduce_sum(tree), False))

    # -- bucketed backward-order mode ---------------------------------------

    def grad_ready(self, name: str, value: Any) -> None:
        """Hand over one named gradient in backward order; fires the
        owning bucket's allreduce once every member has landed (and all
        earlier-plan buckets have fired).  A repeat ``grad_ready`` for a
        name still pending accumulates locally (gradient accumulation
        across microbatches); repeats after the bucket fired are an
        error — stream each name's final contribution before its bucket
        closes."""
        if self._bucket_bytes is None:
            raise ValueError(
                "bucketed mode needs OverlappedGradSync(..., bucket_bytes=)")
        if self._handles:
            raise ValueError(
                "grad_ready() cannot be mixed with push() in one step")
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        if name in self._pending:
            self._pending[name] = self._pending[name] + value
            self._counts[name] += 1
            return
        if self._plan is not None and name not in self._member:
            raise ValueError(
                f"unknown gradient {name!r}: not in the step-1 plan "
                f"({sorted(self._member)})")
        if self._plan is None and name in self._member:
            raise ValueError(
                f"gradient {name!r} already fired this step; stream each "
                f"name once per step while its bucket is open")
        self._pending[name] = value
        self._counts[name] = 1
        if self._plan is None:
            self._order.append(name)
            self._member[name] = -1  # recorded; bucket assigned at freeze
            self._open_bytes += _nbytes(value)
            if self._open_bytes >= self._bucket_bytes:
                self._fire(list(self._order[len(self._order)
                                            - self._open_count():]))
        else:
            self._fire_ready()

    def hook(self, module: nn.Module) -> list:
        """Feed :meth:`grad_ready` from ``module``'s backward: each
        parameter's post-accumulate-grad hook hands over ``(name,
        p.grad)`` as the gradient lands, in backward order.  Returns the
        hook handles (``.remove()`` each to detach).  The gradient is
        copied when its bucket fires, so the parameters' ``.grad`` may be
        overwritten before :meth:`reduce`."""
        handles = []
        for name, p in module.named_parameters():
            if p.requires_grad:
                handles.append(p.register_post_accumulate_grad_hook(
                    lambda p, name=name: self.grad_ready(name, p.grad)))
        return handles

    def _open_count(self) -> int:
        """Names recorded but not yet fired (the open step-1 bucket)."""
        return len(self._pending)

    def _fire(self, names: list[str]) -> None:
        """Submit one bucket's allreduce (step-1 path: bucket = the open
        run of names)."""
        tree = {n: self._pending.pop(n) for n in names}
        bi = self._next_fire
        self._next_fire += 1
        for n in names:
            self._member[n] = bi
        if self._plan is None:
            self._open_bytes = 0
        if self._async is not None:
            self._inflight.append((bi, self._async(tree), True))
        else:
            self._inflight.append((bi, self._coll.allreduce_sum(tree), False))

    def _fire_ready(self) -> None:
        """Step >= 2: submit every plan-order-consecutive bucket whose
        members have all landed — plan order, not arrival order, so the
        collective sequence is rank-agreed."""
        assert self._plan is not None
        while self._next_fire < len(self._plan):
            names = self._plan[self._next_fire]
            if not all(n in self._pending for n in names):
                return
            self._fire(names)

    def reduce(self, mean: bool = False) -> Any:
        """Wait for every pushed allreduce (in push order) and return the
        elementwise sum; ``mean=True`` divides by ``pushes × world``.
        In bucketed mode: fire any trailing bucket, wait all in-flight
        buckets, and return ``{name: array}`` (``mean=True`` divides each
        by ``local_adds × world``).  Worker-thread errors (``PeerLost`` /
        ``WorldChanged``) re-raise here, exactly where the synchronous
        path would have raised."""
        if self._order or self._inflight or self._pending:
            return self._reduce_bucketed(mean)
        if not self._handles:
            raise ValueError("reduce() with no pushed gradients")
        handles, self._handles = self._handles, []
        total = None
        for h, is_handle in handles:
            out = h.wait() if is_handle else h
            total = out if total is None else _tree_map2(
                lambda x, y: x + y, total, out)
        if mean:
            scale = len(handles) * getattr(self._coll, "world", 1)
            total = _tree_map2(lambda x, _: x / scale, total, total)
        return total

    def _reduce_bucketed(self, mean: bool) -> dict[str, Any]:
        if self._plan is None:
            # freeze the step-1 plan: fired prefixes + the open remainder
            if self._pending:
                self._fire([n for n in self._order if n in self._pending])
            plan: list[list[str]] = [[] for _ in range(self._next_fire)]
            for n in self._order:
                plan[self._member[n]].append(n)
            self._plan = plan
        elif self._pending or self._next_fire < len(self._plan):
            missing = [n for names in self._plan[self._next_fire:]
                       for n in names if n not in self._pending]
            raise ValueError(
                f"reduce() before every gradient landed; missing: {missing}")
        inflight, self._inflight = self._inflight, []
        out: dict[str, Any] = {}
        for _bi, h, is_async in inflight:
            out.update(h.wait() if is_async else h)
        counts, self._counts = self._counts, {}
        self._order = []
        self._next_fire = 0
        self._open_bytes = 0
        if mean:
            world = getattr(self._coll, "world", 1)
            out = {n: v / (counts[n] * world) for n, v in out.items()}
        return out


def _next_round(client: CoordClient, round_id: int) -> int:
    """The round-advance rule, shared by every re-rendezvous path: strictly
    forward, and past the highest round the gang already formed (the
    published ``elastic/round``) — a laggard must chase the gang, never
    re-form a round behind it."""
    raw = client.get("elastic/round")
    published = -1 if raw is None else int(raw)
    return max(round_id + 1, published + 1)


def _drop_group(ici: Any, data_coll: Any, exc: BaseException) -> None:
    """Tear a dead round's process group down INSIDE the failure handler,
    before the re-rendezvous (tpudist's ``_drop_ici_world`` ordering): a
    gloo peer blocked on data that must transit this member only unblocks
    when this member's pairs close, and a blocked NCCL kernel only when
    the communicator is aborted; deferring it to the next ``form()``
    would leave that peer out of the new rendezvous."""
    if ici is None:
        return
    exc.__traceback__ = None  # traceback frames pin the round's buffers
    from tpudist_torch.runtime.ici import IciCollectives

    if isinstance(data_coll, IciCollectives):
        data_coll.release()
    ici.teardown()
    _record("ici_teardown", seconds=ici.last_teardown_s)


def _coord_client(coord_addr: str | None) -> CoordClient:
    addr = coord_addr or os.environ.get("TPUDIST_COORD_ADDR")
    if not addr:
        raise ValueError(
            "no coordination service address: pass coord_addr or launch "
            "under tpudist_torch.runtime.launch (which exports "
            "TPUDIST_COORD_ADDR)")
    host, port = addr.rsplit(":", 1)
    return CoordClient(host, int(port))


def run_elastic_worker(
    train_fn: TrainFn,
    state: ElasticState,
    coord_addr: str | None = None,
    worker_id: str | None = None,
    ttl_s: float = 2.0,
    heartbeat_interval_s: float = 0.5,
    max_rounds: int = 10,
    rendezvous_timeout_s: float = 60.0,
    data_plane: str = "host",
    coll_config: CollectiveConfig | None = None,
    ici_backend: str | None = None,
) -> ElasticState:
    """Run ``train_fn`` under TTL-heartbeat elastic supervision.

    Returns the final state after ``train_fn`` completes at some world
    size.  Raises after ``max_rounds`` re-rendezvous attempts (torchrun's
    ``--max-restarts``).

    ``data_plane`` selects where gradient bytes travel:

    * ``"host"`` — the store-backed :class:`HostCollectives` (the
      reference's gloo-on-CPU parity path, dynamic membership with zero
      backend state);
    * ``"ici"`` — each round forms a ``torch.distributed`` process group
      sized to the rendezvous and ``ctx.collectives`` is an
      :class:`~tpudist_torch.runtime.ici.IciCollectives` over it
      (``ctx.mesh``).  The store then carries only control traffic
      (rendezvous, the group store's address, the state broadcast at
      round formation).  A peer dying mid-collective surfaces as a
      classified collective failure or :class:`~tpudist_torch.runtime.ici.
      FormationTimeout` and is handled exactly like :class:`PeerLost`.
      The group's backend follows :func:`worker_device`: NCCL on a
      card, gloo on the CPU; ``ici_backend`` (default
      ``TPUDIST_ICI_BACKEND``) overrides it, and workers sharing a card
      must ask for gloo.

    ``coll_config`` tunes the host collectives (algorithm / bucket_bytes /
    compression — see :class:`~tpudist_torch.runtime.collectives
    .CollectiveConfig`); ``None`` reads the ``TPUDIST_COLL_*``
    environment, so launcher-spawned gangs agree on a plan without
    plumbing.
    """
    if data_plane not in ("host", "ici"):
        raise ValueError(f"unknown data_plane {data_plane!r}")
    client = _coord_client(coord_addr)
    wid = worker_id or f"w{os.getpid()}"
    monitor = ElasticMonitor(client, wid, ttl_s=ttl_s,
                             interval_s=heartbeat_interval_s)
    monitor.start(None)  # beat first: liveness is membership
    rdzv = Rendezvous(client)
    ici = None
    if data_plane == "ici":
        from tpudist_torch.runtime.ici import IciDataPlane

        ici = IciDataPlane(client, device=worker_device(),
                           backend=ici_backend)
    raw = client.get("elastic/round")
    round_id = 0 if raw is None else int(raw) + 1
    # soft assembly target for round 0: the launcher-declared gang size
    min_world = int(os.environ.get("TPUDIST_NUM_PROCESSES", "1"))
    rounds = 0
    first_round = True

    def recover(exc: BaseException, new_size: int) -> tuple[int, int]:
        """The shared WorldChanged/peer-loss recovery tail: drop the dead
        round's group FIRST (the ordering matters, see
        :func:`_drop_group`), roll back + fire reset callbacks, close the
        round's store keys, advance the round.  Returns the next
        ``(round_id, min_world)``.  Reads ``data_coll``/``coll``/
        ``round_id`` late-bound so it always acts on the current round."""
        _drop_group(ici, data_coll, exc)
        state.on_world_change(new_size)
        coll.close_round()
        return _next_round(client, round_id), new_size

    try:
        while True:
            try:
                rank, world, members = rdzv.join_live(
                    round_id, wid, timeout_s=rendezvous_timeout_s,
                    min_world=min_world, superseded_key="elastic/round")
            except TimeoutError:
                counters["rendezvous_timeouts"] += 1
                rounds += 1
                if rounds > max_rounds:
                    raise
                round_id = _next_round(client, round_id)
                continue
            counters["rounds"] += 1
            _record("elastic_round", round=round_id, rank=rank, world=world)
            monitor.resize(world)
            if rank == 0:
                # publish forward only: a lagging splinter round must never
                # regress the counter fresh joiners key off.  Best-effort
                # (get-then-set, not CAS): join_live's defer-while-live-
                # non-members rule keeps concurrent round formation out of
                # the steady state, and a racy regression only costs the
                # next joiner one extra WorldChanged cycle.
                raw = client.get("elastic/round")
                if raw is None or int(raw) < round_id:
                    client.set("elastic/round", str(round_id))
            coll = HostCollectives(client, rank, world, round_id,
                                   on_wait=monitor.check,
                                   config=coll_config)
            data_coll: Any = coll
            try:
                mesh = None
                if ici is not None:
                    # the round's group, formed after the control plane's
                    # collectives and before the state broadcast; a failed
                    # formation is a membership change like any other
                    from tpudist_torch.runtime.ici import IciCollectives

                    mesh = ici.form(round_id, rank, world,
                                    on_wait=monitor.check)
                    _record("ici_formed", round=round_id,
                            seconds=ici.last_form_s, backend=ici.backend)
                    data_coll = IciCollectives(mesh, on_check=monitor.check,
                                               device=ici.device)
                # bitwise state agreement across the new world (the
                # hvd.broadcast_parameters / TorchState re-broadcast role) —
                # INCLUDING the host position: a freshly-joined worker starts
                # from scratch and must adopt the root's (epoch, batch), or
                # its step stream would misalign with the incumbents'.  This
                # runs INSIDE the WorldChanged/PeerLost handler: the full
                # model state is transferred here, so a peer dying mid-
                # broadcast must trigger re-rendezvous, not a crash.
                fresh = first_round and state.restored_step is None
                # ROOT ELECTION: broadcast from the member with the MOST
                # committed progress (non-fresh beats fresh, then epoch,
                # then batch; ties -> lowest rank) — NOT blindly rank 0.
                # After a partial restart, the relaunched from-scratch
                # worker can sort back to rank 0; rooting there would
                # broadcast its initial state over the incumbents' and
                # silently wipe the run's progress.
                score = np.zeros(world, np.int64)
                score[rank] = ((0 if fresh else 1) << 52
                               | min(int(state.host.epoch),
                                     (1 << 20) - 1) << 32
                               | min(int(state.host.batch), (1 << 32) - 1))
                root = int(np.argmax(coll.allreduce_sum(score)))
                synced = coll.broadcast(
                    {"state": state_tree(state.state),
                     "host": np.asarray([state.host.epoch, state.host.batch,
                                         state.world_size, int(fresh)])},
                    root=root)
                load_state_tree(state.state, synced["state"])
                state.host.epoch = int(synced["host"][0])
                state.host.batch = int(synced["host"][1])
                # The rescale decision is keyed on the ROOT's flags, not
                # the local ones: everyone just adopted the root's state
                # (incl. the lr in the param groups), so a rank-local decision
                # would let ranks with asymmetric checkpoint availability
                # apply different rescales to the identical synced state.
                if int(synced["host"][3]):
                    # the elected root is fresh only when EVERY member is
                    # (election prefers any non-fresh state): initial
                    # formation — base hyperparameters are DEFINED for
                    # this world
                    state.world_size = world
                else:
                    # root's recorded world is the uniform "old" for the
                    # rescale (a restored durable commit may carry a world
                    # the restarted gang no longer has; a second death
                    # during re-rendezvous shifts it again)
                    state.world_size = int(synced["host"][2])
                    state.apply_world(world)  # fires reset callbacks if !=
                first_round = False
                state.commit()  # the agreed state is the rollback point
                log.info("round %d: rank %d of %d (%s)", round_id, rank,
                         world, ",".join(members))
                train_fn(state, ElasticContext(
                    rank, world, round_id, data_coll, monitor,
                    mesh=mesh, data_plane=data_plane))
                coll.barrier()  # all ranks finish before anyone leaves
                # what the round's control plane carried: on the ici
                # plane one allreduce (the root election's score), the
                # state broadcast and barriers, never a gradient
                _record("control_plane", round=round_id,
                        calls=dict(coll.calls),
                        bytes_posted=coll.bytes_posted,
                        data_calls=dict(getattr(data_coll, "calls", {})),
                        data_bytes=getattr(data_coll, "bytes", None))
                if ici is not None:
                    # the group dies with the run: tear down, wait for
                    # every member, reap the store processes
                    ici.finalize(rank, coll.barrier)
                coll.close()  # stop async worker/prefetcher threads
                return state
            except WorldChanged as e:
                counters["world_changed"] += 1
                _record("world_changed", round=round_id, old=world,
                        new=e.new_world_size)
                rounds += 1
                if rounds > max_rounds:
                    raise
                log.warning(
                    "round %d: world %d -> %d; rolling back to commit #%d "
                    "(epoch %d, batch %d)", round_id, world,
                    e.new_world_size, state.commits,
                    state._committed_host.epoch, state._committed_host.batch)
                mesh = None
                round_id, min_world = recover(e, e.new_world_size)
            except Exception as e:
                # PeerLost: a host-plane wait deadline fired before the
                # TTL did.  On the ici plane the same event surfaces as a
                # failed gloo/NCCL collective or a FormationTimeout; every
                # one of them is a membership change at the currently-live
                # size, and anything else is a real bug and propagates
                peerish = isinstance(e, PeerLost)
                if not peerish and ici is not None:
                    from tpudist_torch.runtime.ici import (
                        FormationTimeout,
                        is_collective_failure,
                    )

                    peerish = (isinstance(e, FormationTimeout)
                               or is_collective_failure(e))
                if not peerish:
                    raise
                counters["peer_lost"] += 1
                _record("peer_lost", round=round_id, error=str(e)[:200])
                rounds += 1
                if rounds > max_rounds:
                    raise
                # A failed collective says SOMETHING changed, not what: a
                # connection-reset arrives within milliseconds of a peer's
                # death, before its TTL lease expires, so an immediate
                # live() sample would still count the corpse and this
                # member's reset callbacks would fire with a stale world.
                # Poll until the lease drops or one TTL passes (transient
                # failures with nobody dead exit at the deadline with the
                # unchanged size and simply re-form).
                deadline = time.monotonic() + ttl_s + heartbeat_interval_s
                live = len(client.live())
                while live >= world and time.monotonic() < deadline:
                    time.sleep(heartbeat_interval_s / 2)
                    live = len(client.live())
                log.warning("round %d: %s; re-rendezvous at %d", round_id,
                            e, live)
                mesh = None
                round_id, min_world = recover(e, live)
    except BaseException as e:
        # tpudist dumps a post-mortem bundle here (its flight recorder,
        # ROADMAP Queue A 10); the port logs the escape and propagates
        log.error("elastic worker %s crashed in round %d after %d "
                  "re-rendezvous (%s: %s)", wid, round_id, rounds,
                  type(e).__name__, str(e)[:200])
        raise
    finally:
        if ici is not None:
            try:
                ici.teardown()  # idempotent; frees the round's group
                ici.close()     # and the spare store process
            except Exception:  # noqa: BLE001 - must not mask the cause
                pass
        monitor.stop(graceful=True)
