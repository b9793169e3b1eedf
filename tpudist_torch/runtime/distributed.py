"""Process-group bootstrap and world introspection (counterpart of
:mod:`tpudist.runtime.distributed`).

tpudist runs one process per host and bootstraps it with
``jax.distributed.initialize``; here each process drives one device and
joins a ``torch.distributed`` process group: NCCL when the device is a
GPU, gloo when it is the CPU (the multi-process tests).  Rank ``r`` of a
host is bound to ``cuda:LOCAL_RANK``.

A single process needs no bootstrap: :func:`initialize` is a no-op there,
and every collective of the port's parallel modules is skipped for a
world of one.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

from tpudist_torch.utils.device import resolve_device

# what torchrun (torch.distributed.run) exports to every process it starts
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class DistributedContext:
    """What the reference reads from RANK/WORLD_SIZE; one device per
    process, so the device counts are the process counts' own."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def _launcher_env() -> tuple[str, int, int] | None:
    """``(init_method, world_size, rank)`` from the launcher's environment,
    or None when it exported none of it."""
    if not all(os.environ.get(k) for k in _LAUNCHER_ENV):
        return None
    addr = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return addr, int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None, *,
               store: dist.Store | None = None,
               device=None) -> DistributedContext:
    """Join the process group.  Idempotent.

    The group is made when (a) ``init_method`` (``tcp://host:port``,
    ``file://path``) or ``store`` is given, with ``world_size`` and
    ``rank``, or (b) the launcher's environment is set (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as torchrun sets
    them).  With neither, one process runs alone and nothing is made.
    ``device`` (default ``cuda``) picks the backend: NCCL on a GPU, with
    this process bound to ``cuda:LOCAL_RANK``, gloo on the CPU; there is
    no fallback from one to the other.  A bootstrap that was asked for
    and fails raises, rather than leaving N processes to train N models
    alone."""
    if dist.is_initialized():
        return world_info()
    explicit = init_method is not None or store is not None
    if not explicit:
        launcher = _launcher_env()
        if launcher is None:
            if world_size not in (None, 1):
                raise ValueError(f"world_size={world_size} needs an "
                                 "init_method or a store")
            return world_info()
        init_method, env_world, env_rank = launcher
        world_size = env_world if world_size is None else world_size
        rank = env_rank if rank is None else rank
    if world_size is None or rank is None:
        raise ValueError("initialize needs world_size and rank with an "
                         "init_method or a store")
    dev = resolve_device(device)
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(local_rank())
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize runs on cuda or cpu, got {dev}")
    try:
        dist.init_process_group(backend, init_method=init_method, store=store,
                                world_size=world_size, rank=rank)
    except Exception as exc:
        raise RuntimeError(
            f"process-group bootstrap failed ({backend}, rank {rank} of "
            f"{world_size}, {init_method or 'store'}): {exc}") from exc
    return world_info()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_info() -> DistributedContext:
    n = process_count()
    return DistributedContext(process_index=process_index(),
                              process_count=n, local_device_count=1,
                              global_device_count=n)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """Index of this process among the processes of its host
    (``LOCAL_RANK``, as torchrun sets it; 0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def _spawned_rank(rank: int, fn, world: int, init: str, device: str,
                  out_dir: str, args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank)        # one host: local == global
    initialize(init, world, rank, device=device)
    try:
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        shutdown()


def spawn_ranks(fn, world: int, *args, device: str = "cuda",
                timeout: float) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes on this
    host, each joined to one process group through :func:`initialize`
    (``cuda``: NCCL, rank ``r`` on ``cuda:r``; ``cpu``: gloo); their
    return values, by rank.  A rank that raises re-raises here; ranks
    still running after ``timeout`` seconds are killed and
    ``TimeoutError`` is raised."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(_spawned_rank,
                                 args=(fn, world, init, device, tmp, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} {device} rank(s) of "
                                   f"{getattr(fn, '__qualname__', fn)} "
                                   f"still running after {timeout:g} s; "
                                   "killed")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
