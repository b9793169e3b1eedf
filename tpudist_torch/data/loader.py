"""Batch iterator that lands each process's shard of the global batch on
its device (counterpart of :mod:`tpudist.data.loader`).

tpudist assembles the global batch on the host in ``[global_batch, ...]``
order, shard after shard, and places it under ``P('data', ...)``, so
device ``d`` of the data axis holds rows ``d·local_batch :
(d+1)·local_batch``.  Here one process is one data shard: rank ``r`` of
the data axis gathers exactly those rows, its own sampler's stream, and
copies them to its device.  So a world of ``W`` processes sees, rank by
rank, the global batches tpudist's loader makes over a ``W``-device data
mesh.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch.distributed as dist

from tpudist_torch.data.device_prefetch import device_prefetch
from tpudist_torch.data.sampler import ShardedSampler
from tpudist_torch.runtime.mesh import axis_index, axis_size
from tpudist_torch.utils.device import resolve_device


def _data_axis(mesh, data_axis: str) -> tuple[int, int]:
    """``(num_shards, shard)``: the data axis's size and this process's
    index on it (the world and this rank when ``mesh`` is None; one
    shard without a process group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    if mesh is None:
        return dist.get_world_size(), dist.get_rank()
    return axis_size(mesh, data_axis), axis_index(mesh, data_axis)


class ShardedLoader:
    """Iterates epoch-seeded batches of this process's data shard, as
    tensors on ``device``.

    Args:
      arrays: dataset arrays, all with leading dimension N (e.g. images,
        labels).
      global_batch: the batch over the whole data axis; must divide by the
        number of shards.  Each process gets ``local_batch`` rows of it.
      mesh / data_axis: the data axis (``mesh=None``: the whole world; no
        process group: one shard).  ``num_shards`` and ``shard`` set the
        layout directly instead (all processes of a layout must agree).
      shuffle / seed / drop_last: sampler behaviour (DistributedSampler
        semantics, see :mod:`tpudist_torch.data.sampler`).
      prefetch: batches assembled ahead of the consumer.  0 gathers with
        numpy on the consumer's thread.  With the native gather pool
        (:mod:`tpudist_torch.data.native`; ``pool`` is set) ``prefetch``
        gather jobs stay in flight on its C++ threads; without it a Python
        thread (:func:`device_prefetch`) runs the stream ahead
        (``thread_prefetch``).
      device: where batches land (default ``cuda``; ``"cpu"`` for the
        plain path).
    """

    def __init__(self, arrays: Sequence[np.ndarray], global_batch: int,
                 mesh=None, data_axis: str = "data", shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 0,
                 *, num_shards: int | None = None, shard: int | None = None,
                 device=None) -> None:
        n = len(arrays[0])
        for a in arrays:
            if len(a) != n:
                raise ValueError("all arrays must share leading dimension")
        if not isinstance(data_axis, str):
            raise NotImplementedError(
                "a data axis over several mesh axes (the composed dp x fsdp "
                "layout) is not ported yet (ROADMAP Queue A 7)")
        self.arrays = list(arrays)
        self.mesh = mesh
        self.data_axis = data_axis
        self.device = resolve_device(device)
        if (num_shards is None) != (shard is None):
            raise ValueError("give num_shards and shard together")
        if num_shards is None:
            num_shards, shard = _data_axis(mesh, data_axis)
        self.num_shards, self.shard = num_shards, shard
        if global_batch % self.num_shards:
            raise ValueError(f"global batch {global_batch} not divisible by "
                             f"{self.num_shards} shards")
        self.global_batch = global_batch
        self.local_batch = global_batch // self.num_shards
        self.sampler = ShardedSampler(n, self.num_shards, shard,
                                      shuffle=shuffle, seed=seed,
                                      drop_last=drop_last)
        self.drop_last = drop_last
        self.pool = None
        if prefetch > 0:
            from tpudist_torch.data import native

            if native.available():
                self.pool = native.GatherPool()
                # the C++ gather computes offsets from shape, not strides
                self.arrays = [np.ascontiguousarray(a) for a in self.arrays]
        self.prefetch = prefetch

    def __len__(self) -> int:
        return self.steps_per_epoch

    @property
    def thread_prefetch(self) -> bool:
        """True when :meth:`epoch` / :meth:`epoch_stacked` already run
        their stream ahead on a Python thread (``prefetch > 0``, no native
        pool).  A caller that adds its own prefetch layer (the trainer's
        ``_feed``) checks this and does not add a second one."""
        return self.pool is None and self.prefetch > 0

    @property
    def steps_per_epoch(self) -> int:
        shard_len = self.sampler.shard_size
        if self.drop_last:
            return shard_len // self.local_batch
        return -(-shard_len // self.local_batch)

    def valid_mask(self, step: int) -> np.ndarray:
        """Boolean mask of batch ``step``'s rows on this process: True
        for real samples, False for the wrap-around padding a
        ``drop_last=False`` sampler appends to equalise shards.  This
        shard's slice of tpudist's global mask; independent of the epoch
        (padding occupies fixed stream positions)."""
        lo = step * self.local_batch
        hi = min(lo + self.local_batch, self.sampler.shard_size)
        j = np.arange(lo, max(hi, lo))
        # element j of shard r sits at stream position r + j*num_shards;
        # positions >= n are wrap-around padding (sampler.indices)
        return self.shard + j * self.num_shards < self.sampler.n

    def _land(self, host: Iterator[tuple], thread: bool) -> Iterator[tuple]:
        return device_prefetch(host, depth=self.prefetch if thread else 0,
                               device=self.device)

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[tuple]:
        """One epoch of this shard's batches on the device; ``epoch`` seeds
        the shuffle (the ``sampler.set_epoch`` contract), ``start_step``
        skips the first batches (resume, or the tail after
        :meth:`epoch_stacked`)."""
        return self._land(self.host_epoch(epoch, start_step),
                          self.thread_prefetch)

    def host_epoch(self, epoch: int, start_step: int = 0) -> Iterator[tuple]:
        """:meth:`epoch`'s batches as host numpy arrays, for a caller that
        copies them to the device itself (the trainer's prefetch)."""
        order = self.sampler.indices(epoch)
        steps = self.steps_per_epoch

        def idx(step: int) -> np.ndarray:
            lo = step * self.local_batch
            return order[lo:lo + self.local_batch]

        return self._gather(idx, range(start_step, steps))

    def _gather(self, idx, keys) -> Iterator[tuple]:
        """The batches ``[arrays[idx(k)] for k in keys]``, through the
        native pool with ``prefetch`` jobs in flight when there is one."""
        if self.pool is None:
            for k in keys:
                i = idx(k)
                yield tuple(a[i] for a in self.arrays)
            return
        keys = list(keys)

        def submit(k) -> int:
            i = idx(k)
            out = [np.empty((len(i),) + a.shape[1:], a.dtype)
                   for a in self.arrays]
            return self.pool.submit(self.arrays, i, out)

        jobs = [submit(k) for k in keys[:self.prefetch]]
        try:
            for pos in range(len(keys)):
                if pos + self.prefetch < len(keys):
                    jobs.append(submit(keys[pos + self.prefetch]))
                yield tuple(self.pool.wait(jobs.pop(0)))
        finally:
            # an abandoned epoch (break, exception): reap in-flight jobs so
            # neither the buffers nor the C++ job objects leak
            for job in jobs:
                try:
                    self.pool.wait(job)
                except (RuntimeError, TimeoutError):
                    pass

    def stacked_groups(self, n_steps: int) -> int:
        """How many full ``n_steps`` groups :meth:`epoch_stacked` yields
        (only full-size batches stack, whatever ``drop_last`` says)."""
        return self.sampler.shard_size // self.local_batch // n_steps

    def epoch_stacked(self, epoch: int, n_steps: int) -> Iterator[tuple]:
        """Full groups of ``n_steps`` consecutive batches stacked on a
        leading steps dimension, ``[n_steps, local_batch, ...]`` per array
        on the device: the input of
        :func:`tpudist_torch.parallel.data_parallel.make_dp_train_loop`.
        Yields :meth:`stacked_groups` groups; drive the remaining batches
        with ``epoch(epoch, start_step=stacked_groups(n) * n)``."""
        return self._land(self.host_epoch_stacked(epoch, n_steps),
                          self.thread_prefetch)

    def host_epoch_stacked(self, epoch: int,
                           n_steps: int) -> Iterator[tuple]:
        """:meth:`epoch_stacked`'s groups as host numpy arrays."""
        order = self.sampler.indices(epoch)
        rows = n_steps * self.local_batch

        def idx(g: int) -> np.ndarray:
            return order[g * rows:(g + 1) * rows]

        for batch in self._gather(idx, range(self.stacked_groups(n_steps))):
            yield tuple(a.reshape(n_steps, self.local_batch, *a.shape[1:])
                        for a in batch)

    def __iter__(self) -> Iterator[tuple]:
        """Plain iteration is :meth:`epoch` 0."""
        return self.epoch(0)
