"""Resizable process-group data plane for elastic training (counterpart of
:mod:`tpudist.runtime.ici`).

On the store-backed plane (:class:`~tpudist_torch.runtime.collectives.
HostCollectives`) every gradient byte crosses the coordination store,
which is meant for control traffic only.  This module moves the data
plane onto ``torch.distributed``: after every rendezvous round the gang
forms a fresh process group sized to the round — NCCL when the workers
train on cards, gloo on the CPU — and gradient sync runs as that group's
collectives.  The store then carries only the rendezvous, the address of
the round's group store and the state broadcast at round formation.

How an in-process RESIZE works:

1. the previous round's group is torn down (:meth:`IciDataPlane.teardown`):
   its communicator is ABORTED first — ``destroy_process_group`` alone can
   hang on NCCL once a peer has died — then the group is destroyed;
2. the round's rank 0 spawns the round's ``TCPStore`` in its own detached
   process (:mod:`tpudist_torch.runtime.ici_service`: a store hosted by a
   worker would die with that worker, mid-formation) and publishes its
   address under ``{ns}/{round}/addr`` in the coordination store; every
   member connects and joins the group through a ``PrefixStore`` of the
   round, so no round ever reads another round's keys;
3. the round's group becomes the default process group; one allreduce of
   a one-element tensor, polled like every other collective, proves that
   every member joined.

tpudist snapshots the state to host numpy around a resize
(``host_snapshot``), because ``jax.extend.backend.clear_backends``
invalidates every ``jax.Array``.  A torch tensor outlives the process
group it was reduced over, so that helper has no counterpart here.

Failure detection is symmetric by construction, as in tpudist: every
collective is issued with ``async_op=True`` and POLLED
(:meth:`IciCollectives._wait_ready`), with the TTL membership probe
between polls, so a ``kill -9``'d member surfaces as ``WorldChanged`` on
every survivor within one TTL, wherever it sat in the ring.  A gloo peer
next to the dead one sees a connection error at once; it is classified by
:func:`is_collective_failure`.

The backend follows the worker's device; ``backend=`` (or
``TPUDIST_ICI_BACKEND`` for launcher-spawned gangs) overrides it.  NCCL
cannot put two ranks on one card: a gang that shares a card and asks for
NCCL raises, naming the override, and nothing here ever switches to gloo
by itself.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from tpudist_torch.runtime.collectives import PeerLost, _flatten
from tpudist_torch.runtime.coord import CoordClient
from tpudist_torch.utils.logging import get_logger

log = get_logger(__name__)

# message fragments of a failed gloo/NCCL collective or a dead round store:
# the process-group plane's counterpart of HostCollectives' PeerLost
_COLLECTIVE_FAILURE_MARKS = (
    "gloo",                     # "[gloo/transport/tcp/pair.cc] ..."
    "connection reset",
    "connection closed",        # gloo: "Connection closed by peer"
    "connection refused",
    "remote process exited",
    "nccl error",
    "processgroupnccl",
    "watchdog",                 # the NCCL watchdog's collective timeout
    "socket timeout",           # the round store's client
    "wait timeout",
    "timed out",
    "broken pipe",
)


# the group's own timeout (gloo's, and NCCL's watchdog); the TTL probe
# between polls fires long before it
_GROUP_TIMEOUT_S = 60.0


class FormationTimeout(RuntimeError):
    """The round's process group never formed (rank 0 vanished before
    publishing the store's address, or a peer died inside the join)."""


def is_collective_failure(exc: BaseException) -> bool:
    """Does this exception look like a peer loss inside the process-group
    plane (rather than a bug)?  ``torch.distributed``'s own backend, store
    and network errors always do; otherwise only a ``RuntimeError`` or
    ``ValueError`` whose message carries one of the marks above (gloo and
    NCCL surface failures as plain ``RuntimeError``).  ``ConnectionError``
    never does: the coordination client raises it, and a control-plane
    outage must propagate, not trigger a re-rendezvous against a dead
    store."""
    if isinstance(exc, ConnectionError):
        return False
    if isinstance(exc, (dist.DistBackendError, dist.DistNetworkError,
                        dist.DistStoreError)):
        return True
    if not isinstance(exc, (RuntimeError, ValueError)):
        return False
    msg = str(exc).lower()
    return any(mark in msg for mark in _COLLECTIVE_FAILURE_MARKS)


def live_groups() -> int:
    """Process groups this process holds (the default one included)."""
    from torch.distributed import distributed_c10d as c10d

    return len(c10d._world.pg_map)


def _abort(group: Any) -> None:
    """Abort ``group``'s communicators so that no pending collective keeps
    a survivor blocked (NCCL's ``ncclCommAbort``; gloo closes its pairs)."""
    from torch.distributed import distributed_c10d as c10d

    if hasattr(c10d, "_abort_process_group"):
        c10d._abort_process_group(group)
        return
    for kind in ("cuda", "cpu"):  # older torch: the backends themselves
        try:
            backend = group._get_backend(torch.device(kind))
        except RuntimeError:
            continue
        if hasattr(backend, "abort"):
            backend.abort()


def _card_identity(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}:{uuid if uuid is not None else device}"


class IciDataPlane:
    """Per-round ``torch.distributed`` group manager for the elastic
    worker.  One instance lives for the whole worker; :meth:`form` is
    called once per rendezvous round and returns the round's group.

    Args:
      client: coordination-store connection (main-thread use only).
      namespace: store key prefix for the address agreement.
      host_ip: the address peers reach this host's round store at when
        this process is the round's rank 0 (default loopback; multi-host
        launches set ``TPUDIST_HOST_IP``).
      device: the worker's device (buffers live there; picks the backend).
      backend: ``"nccl"`` or ``"gloo"``; default ``TPUDIST_ICI_BACKEND``,
        else NCCL for a CUDA device and gloo for the CPU.
      init_timeout_s: bound on the address agreement and the group's
        formation; past it :class:`FormationTimeout`.
    """

    def __init__(
        self,
        client: CoordClient,
        namespace: str = "ici",
        host_ip: str | None = None,
        device: str | torch.device = "cpu",
        backend: str | None = None,
        init_timeout_s: float = 30.0,
    ) -> None:
        self.client = client
        self.ns = namespace
        self.host_ip = (host_ip or os.environ.get("TPUDIST_HOST_IP")
                        or "127.0.0.1")
        self.device = torch.device(device)
        backend = backend or os.environ.get("TPUDIST_ICI_BACKEND") or (
            "nccl" if self.device.type == "cuda" else "gloo")
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                             f"{backend!r}")
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, got "
                             f"{self.device}")
        self.backend = backend
        self.init_timeout_s = init_timeout_s
        self.group: Any = None
        self.formed = 0           # rounds this plane formed a group for
        self.last_form_s = 0.0    # the last formation, address agreement in
        self.last_teardown_s = 0.0  # and the last teardown, in seconds
        self._active_round: int | None = None
        self._spawned: dict[int, subprocess.Popen] = {}  # pid -> its store
        # a store process started ahead of need (see ici_service): the
        # round this process leads takes it without waiting for a start
        self._spare: subprocess.Popen | None = None
        self._start_spare()

    # -- lifecycle ---------------------------------------------------------

    def form(self, round_id: int, rank: int, world: int,
             on_wait: Callable[[], None] | None = None) -> Any:
        """Form the round's process group (the default group from here
        on) and return it.  Raises :class:`FormationTimeout` when the
        address agreement or the join does not complete, which callers
        treat like any other membership change; a card shared by two NCCL
        ranks raises ``ValueError``."""
        self.teardown()
        if dist.is_initialized():
            raise RuntimeError(
                "a default process group exists that this plane did not "
                "form; the ici data plane owns the default group")
        t0 = time.perf_counter()
        addr = self._agree_address(round_id, rank, world, on_wait)
        host, port = addr.rsplit(":", 1)
        log.info("ici round %d: %s rank %d/%d at %s", round_id,
                 self.backend, rank, world, addr)
        deadline = time.monotonic() + self.init_timeout_s
        try:
            store = dist.TCPStore(
                host, int(port), is_master=False, wait_for_workers=False,
                timeout=timedelta(seconds=self.init_timeout_s))
            store = dist.PrefixStore(f"{self.ns}/{round_id}/", store)
            if self.backend == "nccl":
                self._check_cards(store, rank, world)
                # abort-on-error without tearing the process down: a dead
                # peer's round is aborted here, never by the watchdog's
                # default handler, which ends the whole process
                os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
            kw = ({"device_id": self.device} if self.backend == "nccl"
                  else {})
            dist.init_process_group(
                self.backend, store=store, rank=rank, world_size=world,
                timeout=timedelta(seconds=_GROUP_TIMEOUT_S), **kw)
        except ValueError:
            raise
        except Exception as e:  # noqa: BLE001 - every join failure is one
            self.teardown()
            raise FormationTimeout(
                f"ici round {round_id}: the {self.backend} group did not "
                f"form ({type(e).__name__}: {str(e)[:200]})") from e
        self.group = dist.group.WORLD
        self._active_round = round_id
        # everyone is in once one collective completes on every member
        probe = torch.ones(1, device=self.device)
        work = dist.all_reduce(probe, group=self.group, async_op=True)
        try:
            _poll([work], deadline, on_wait,
                  lambda: FormationTimeout(
                      f"ici round {round_id}: the {self.backend} group's "
                      f"first allreduce did not complete within "
                      f"{self.init_timeout_s}s"))
        except FormationTimeout:
            self.teardown()
            raise
        if int(probe.item()) != world:
            self.teardown()
            raise FormationTimeout(
                f"ici round {round_id}: {int(probe.item())} of {world} "
                "members joined")
        self.formed += 1
        self.last_form_s = time.perf_counter() - t0
        return self.group

    def _check_cards(self, store: Any, rank: int, world: int) -> None:
        """NCCL holds one rank a card: every member publishes its card's
        identity and every member raises alike when two share one."""
        store.set(f"card/{rank}", _card_identity(self.device))
        cards = [store.get(f"card/{r}").decode() for r in range(world)]
        if len(set(cards)) < world:
            raise ValueError(
                f"the ici plane's nccl backend needs one card a rank; "
                f"{world} ranks share {len(set(cards))} card(s). Ask for "
                "gloo explicitly (backend='gloo', or TPUDIST_ICI_BACKEND="
                "gloo for launcher-spawned gangs)")

    def teardown(self) -> None:
        """Abort and destroy the current round's group.  Idempotent; safe
        with peers already dead."""
        group, self.group = self.group, None
        self._active_round = None
        if group is None or not dist.is_initialized():
            return
        t0 = time.perf_counter()
        try:
            _abort(group)
        except Exception as e:  # noqa: BLE001 - teardown must proceed
            log.warning("ici teardown: abort failed (%s)", str(e)[:200])
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception as e:  # noqa: BLE001
                log.warning("ici teardown: destroy failed (%s)",
                            str(e)[:200])
        self.last_teardown_s = time.perf_counter() - t0

    def finalize(self, rank: int, barrier: Callable[[], None]) -> None:
        """End of run: tear the group down, wait until every member has,
        then let rank 0 reap every store process this plane spawned."""
        self.teardown()
        self.close()
        barrier()
        if rank == 0:
            self._sweep(upto=None)

    # -- the round store and the address agreement (control plane) --------

    def _agree_address(self, round_id: int, rank: int, world: int,
                       on_wait: Callable[[], None] | None) -> str:
        key = f"{self.ns}/{round_id}/addr"
        if rank == 0:
            port = self._spawn_service(round_id)
            addr = f"{self.host_ip}:{port}"
            self.client.set(key, addr)
            # reap stores two or more rounds stale: every member of this
            # round has torn down round - 1's group, so none can still be
            # talking to a round - 2 store (round - 1's could still be)
            self._sweep(upto=round_id - 2)
            return addr
        deadline = time.monotonic() + self.init_timeout_s
        while True:
            raw = self.client.get(key)
            if raw is not None:
                return raw.decode()
            if on_wait is not None:
                on_wait()
            if time.monotonic() > deadline:
                raise FormationTimeout(
                    f"rank 0 never published {key} within "
                    f"{self.init_timeout_s}s")
            self.client.wait(key, timeout_s=0.2)

    def _start_spare(self) -> None:
        self._errlog = os.path.join(
            tempfile.gettempdir(),
            f"tpudist_torch_ici_service_{os.getpid()}_{time.time_ns()}.log")
        # stderr to a file: the process may outlive this worker and must
        # not hold a harness's pipe open
        with open(self._errlog, "wb") as errlog:
            self._spare = subprocess.Popen(
                [sys.executable, "-m", "tpudist_torch.runtime.ici_service",
                 "--max-lifetime-s", "3600", "--parent-pid",
                 str(os.getpid())],
                stdout=subprocess.PIPE, stderr=errlog,
                start_new_session=True)  # detached: outlives this worker

    def _spawn_service(self, round_id: int) -> int:
        """Adopt the spare store process for this round (and start the
        next spare) and return its port; publish ``{ns}/{round}/svc`` =
        ``pid:host`` for the sweep."""
        import select
        import signal

        proc, errlog = self._spare, self._errlog
        self._spare = None
        if proc is None or proc.poll() is not None:
            self._start_spare()
            proc, errlog, self._spare = self._spare, self._errlog, None
        ready, _, _ = select.select([proc.stdout], [], [],
                                    self.init_timeout_s)
        line = proc.stdout.readline().split() if ready else []
        if len(line) != 2 or line[0] != b"ready":
            proc.kill()
            proc.wait()
            raise FormationTimeout(
                f"ici round {round_id}: the store process never came up "
                f"(its stderr is in {errlog})")
        proc.send_signal(signal.SIGUSR1)  # adopted: serves past this worker
        proc.stdout.close()
        self._spawned[proc.pid] = proc
        self.client.set(f"{self.ns}/{round_id}/svc",
                        f"{proc.pid}:{socket.gethostname()}")
        self._start_spare()
        return int(line[1])

    def close(self) -> None:
        """End the spare store process (idempotent; the spare also ends
        by itself when this process does)."""
        spare, self._spare = self._spare, None
        if spare is not None and spare.poll() is None:
            spare.terminate()
            try:
                spare.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                spare.kill()
                spare.wait()

    def _sweep(self, upto: int | None) -> None:
        """SIGTERM the store processes of rounds ``<= upto`` (all when
        None) and delete their keys.  Only this host's are reachable;
        others end at their ``--max-lifetime-s``."""
        me = socket.gethostname()
        for key in self.client.keys(f"{self.ns}/"):
            parts = key.split("/")
            if len(parts) != 3 or parts[2] not in ("svc", "addr"):
                continue
            try:
                r = int(parts[1])
            except ValueError:
                continue
            if upto is not None and r > upto:
                continue
            if parts[2] == "svc":
                raw = self.client.get(key)
                if raw is not None:
                    pid_s, _, host = raw.decode().partition(":")
                    if host == me:
                        try:
                            os.kill(int(pid_s), 15)
                        except (OSError, ValueError):
                            pass
                        own = self._spawned.pop(int(pid_s), None)
                        if own is not None:  # reap our own child
                            try:
                                own.wait(timeout=5.0)
                            except subprocess.TimeoutExpired:
                                own.kill()
            try:
                self.client.delete(key)
            except ConnectionError:
                return


def _poll(works: list, deadline: float,
          on_check: Callable[[], None] | None,
          on_deadline: Callable[[], BaseException]) -> None:
    """Wait for ``works`` by polling, with ``on_check`` (the TTL probe,
    rate-limited to one call per 100 ms) in between; a completed work's
    ``wait()`` re-raises its failure."""
    pending = list(works)
    next_check = 0.0
    while True:
        still = []
        for w in pending:
            if w.is_completed():
                w.wait()
            else:
                still.append(w)
        pending = still
        if not pending:
            return
        now = time.monotonic()
        if on_check is not None and now >= next_check:
            on_check()
            next_check = now + 0.1
        if time.monotonic() > deadline:
            raise on_deadline()
        time.sleep(0.0005)


def _accum(dtype: torch.dtype) -> torch.dtype:
    """The dtype a leaf is summed in: f32 for the half types (as the store
    plane accumulates them), its own otherwise."""
    return torch.float32 if dtype in (torch.float16, torch.bfloat16) \
        else dtype


class IciCollectives:
    """Gradient-sync collectives over the round's process group: the
    drop-in data plane for :class:`HostCollectives.allreduce_mean` (same
    tree in, same tree out: a tensor leaf comes back on its device in its
    dtype, anything else as numpy).

    Each call packs the tree into one flat buffer per dtype on the plane's
    device and issues one ``all_reduce`` per buffer with ``async_op=True``,
    then polls it (see the module docstring).  ``calls`` counts the
    collectives issued by kind and ``bytes`` the bytes they carried from
    this rank: the proof that gradients ride the group (tpudist's worker
    shows the compiled HLO's ``all-reduce`` instead).

    ``reduce_scatter`` rides NCCL's reduce-scatter; on gloo it is an
    ``all_reduce`` plus a slice (one backend, one path, on every torch
    version: gloo's reduce-scatter is recent and missing on CUDA tensors
    in older releases).  ``all_gather`` is ``torch.distributed.all_gather``
    on both."""

    def __init__(self, group: Any, on_check: Callable[[], None] | None = None,
                 timeout_s: float = 60.0,
                 device: str | torch.device = "cpu") -> None:
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)
        self.backend = dist.get_backend(group)
        self.on_check = on_check
        self.timeout_s = timeout_s
        self.calls: dict[str, int] = {}
        self.bytes = 0

    def release(self) -> None:
        """Drop the group reference; the object is unusable afterwards."""
        self.group = None

    def _count(self, kind: str, nbytes: int) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes += nbytes

    def _wait_ready(self, works: list) -> None:
        _poll(works, time.monotonic() + self.timeout_s, self.on_check,
              lambda: PeerLost(
                  f"ici collective not done within {self.timeout_s}s at "
                  f"world {self.world}"))

    # -- allreduce ----------------------------------------------------------

    def _issue_allreduce(self, tree: Any, scale: float | None
                         ) -> "IciAsyncHandle":
        if self.on_check is not None:
            # membership probe BEFORE entering the collective: a peer the
            # TTL already declared dead would leave us on an op that can
            # never complete
            self.on_check()
        leaves, rebuild = _flatten(tree)
        tensors = []
        for leaf in leaves:
            t = (leaf.detach() if isinstance(leaf, torch.Tensor)
                 else torch.as_tensor(np.asarray(leaf)))
            tensors.append(t)
        groups: dict[torch.dtype, list[int]] = {}
        for i, t in enumerate(tensors):
            groups.setdefault(_accum(t.dtype), []).append(i)
        bufs, works = [], []
        for dtype, idxs in groups.items():
            flat = torch.cat([tensors[i].reshape(-1).to(self.device, dtype)
                              for i in idxs])
            self._count("allreduce", flat.numel() * flat.element_size())
            works.append(dist.all_reduce(flat, group=self.group,
                                         async_op=True))
            bufs.append((idxs, flat))
        return IciAsyncHandle(self, works, bufs, leaves, tensors, rebuild,
                              scale)

    def allreduce_mean(self, tree: Any) -> Any:
        """Mean of a tree across the group's members."""
        return self._issue_allreduce(tree, 1.0 / self.world).wait()

    def allreduce_sum(self, tree: Any) -> Any:
        return self._issue_allreduce(tree, None).wait()

    def allreduce_mean_async(self, tree: Any) -> "IciAsyncHandle":
        """Issue now, wait later: the collective runs while the caller
        does host work; :meth:`IciAsyncHandle.wait` returns what the sync
        call would (or raises its failure)."""
        return self._issue_allreduce(tree, 1.0 / self.world)

    def allreduce_sum_async(self, tree: Any) -> "IciAsyncHandle":
        return self._issue_allreduce(tree, None)

    # -- reduce-scatter / all-gather (hier's intra-host legs) -------------

    def rs_bounds(self, n: int) -> list[tuple[int, int]]:
        """Per-member shard bounds of a length-``n`` vector: equal padded
        shards of ``ceil(n / world)`` elements, clamped to ``[0, n)``;
        identical on every member."""
        q = -(-n // self.world) if n else 0
        return [(min(n, p * q), min(n, (p + 1) * q))
                for p in range(self.world)]

    def _as_tensor(self, vec: Any) -> tuple[torch.Tensor, bool]:
        if isinstance(vec, torch.Tensor):
            return vec.detach().reshape(-1).to(self.device), False
        return torch.from_numpy(np.ascontiguousarray(vec).reshape(-1)) \
            .to(self.device), True

    @staticmethod
    def _back(t: torch.Tensor, as_numpy: bool) -> Any:
        return t.cpu().numpy() if as_numpy else t

    def reduce_scatter(self, vec: Any) -> Any:
        """SUM a same-length 1-D vector across members and return this
        member's :meth:`rs_bounds` shard of it."""
        if self.on_check is not None:
            self.on_check()
        t, as_numpy = self._as_tensor(vec)
        n = t.numel()
        lo, hi = self.rs_bounds(n)[self.rank]
        if n == 0:
            return self._back(t[:0], as_numpy)
        q = -(-n // self.world)
        padded = torch.zeros(q * self.world, dtype=t.dtype,
                             device=self.device)
        padded[:n] = t
        nbytes = padded.numel() * padded.element_size()
        if self.backend == "nccl":
            out = torch.empty(q, dtype=t.dtype, device=self.device)
            self._count("reduce_scatter", nbytes)
            work = dist.reduce_scatter(out, list(padded.chunk(self.world)),
                                       group=self.group, async_op=True)
        else:
            self._count("allreduce", nbytes)
            work = dist.all_reduce(padded, group=self.group, async_op=True)
            out = padded[self.rank * q:(self.rank + 1) * q]
        self._wait_ready([work])
        return self._back(out[:hi - lo], as_numpy)

    def all_gather(self, shard: Any, n: int) -> Any:
        """Inverse of :meth:`reduce_scatter`: every member contributes its
        ``rs_bounds`` shard of a length-``n`` vector and receives the
        whole vector, bitwise the concatenation of the shards."""
        if self.on_check is not None:
            self.on_check()
        t, as_numpy = self._as_tensor(shard)
        bounds = self.rs_bounds(n)
        lo, hi = bounds[self.rank]
        if t.numel() != hi - lo:
            raise ValueError(
                f"shard has {t.numel()} elements; rs_bounds expects "
                f"{hi - lo} for rank {self.rank} of n={n}")
        if n == 0:
            return self._back(t[:0], as_numpy)
        q = -(-n // self.world)
        buf = torch.zeros(q, dtype=t.dtype, device=self.device)
        buf[:t.numel()] = t
        parts = [torch.empty_like(buf) for _ in range(self.world)]
        self._count("all_gather", buf.numel() * buf.element_size())
        work = dist.all_gather(parts, buf, group=self.group, async_op=True)
        self._wait_ready([work])
        full = torch.cat([parts[p][:b - a]
                          for p, (a, b) in enumerate(bounds)])
        return self._back(full, as_numpy)


class IciAsyncHandle:
    """An allreduce in flight: issued at submit time; :meth:`wait` polls
    it (the same TTL-probing poll as the sync path, so a peer's death
    still surfaces as ``WorldChanged``/``PeerLost`` here) and rebuilds the
    tree."""

    def __init__(self, coll: IciCollectives, works: list, bufs: list,
                 leaves: list, tensors: list, rebuild: Callable,
                 scale: float | None) -> None:
        self._coll = coll
        self._works = works
        self._bufs = bufs
        self._leaves = leaves
        self._tensors = tensors
        self._rebuild = rebuild
        self.scale = scale

    def done(self) -> bool:
        return all(w.is_completed() for w in self._works)

    def wait(self, timeout_s: float | None = None) -> Any:
        self._coll._wait_ready(self._works)
        out: list[Any] = [None] * len(self._leaves)
        for idxs, flat in self._bufs:
            if self.scale is not None:
                flat = flat * self.scale if flat.is_floating_point() \
                    else flat.double() * self.scale
            off = 0
            for i in idxs:
                t = self._tensors[i]
                piece = flat[off:off + t.numel()].view(t.shape)
                off += t.numel()
                leaf = self._leaves[i]
                if isinstance(leaf, torch.Tensor):
                    if piece.is_floating_point() and t.is_floating_point():
                        piece = piece.to(t.dtype)
                    out[i] = piece.to(leaf.device)
                else:
                    out[i] = piece.cpu().numpy()
        return self._rebuild(out)


class IciIntraHost:
    """An :class:`IciCollectives` over ONE host's members, presented as
    the intra-host plane of ``HostCollectives(config=CollectiveConfig(
    algorithm="hier"), intra=...)``: hier's phases 1 and 3 ride the
    group's reduce-scatter and all-gather, and only the cross-host ring
    of one representative a host touches the store.  The group must hold
    exactly this rank's host group (host-contiguous ranks, as the
    launcher numbers a gang): make it with :func:`host_group`.

    The protocol (duck-typed by :class:`HostCollectives`): ``local_world``
    / ``local_index``, ``bounds(n)``, ``reduce_scatter(vec)`` and
    ``all_gather(shard, n)``."""

    def __init__(self, coll: IciCollectives) -> None:
        self._coll = coll
        self.local_world = coll.world
        self.local_index = coll.rank

    def bounds(self, n: int) -> list[tuple[int, int]]:
        return self._coll.rs_bounds(n)

    def reduce_scatter(self, vec: np.ndarray) -> np.ndarray:
        return self._coll.reduce_scatter(vec)

    def all_gather(self, shard: np.ndarray, n: int) -> np.ndarray:
        return self._coll.all_gather(shard, n)


def host_group(hosts: int) -> Any:
    """This rank's host subgroup of the default group, whose ``world``
    ranks split into ``hosts`` host-contiguous groups.  Every rank makes
    every subgroup (``new_group`` is collective), in host order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if hosts < 1 or world % hosts:
        raise ValueError(f"world {world} does not split into {hosts} hosts")
    per = world // hosts
    mine = None
    for h in range(hosts):
        g = dist.new_group(list(range(h * per, (h + 1) * per)))
        if h == rank // per:
            mine = g
    return mine
