"""Epoch-seeded sharding sampler, the DistributedSampler equivalent (the
port's copy of :mod:`tpudist.data.sampler`, index for index):

* the index list is padded by wrap-around so every shard has equal length
  (``ceil(N / world) * world``), as
  ``torch.utils.data.DistributedSampler(drop_last=False)`` pads it;
* shard ``r`` takes indices ``perm[r::world]`` (rank-strided);
* ``shuffle=True`` permutes with a numpy generator seeded by
  ``seed + epoch`` (the ``set_epoch`` contract);
* ``shuffle=False`` keeps natural order.

In the port a shard is one process's: :class:`~tpudist_torch.data.loader.
ShardedLoader` gives rank ``r`` of the data axis shard ``r``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ShardedSampler:
    n: int
    num_shards: int
    shard: int
    shuffle: bool = False
    seed: int = 0
    drop_last: bool = False

    def __post_init__(self) -> None:
        if not (0 <= self.shard < self.num_shards):
            raise ValueError(f"shard {self.shard} out of range "
                             f"[0, {self.num_shards})")
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    @property
    def shard_size(self) -> int:
        if self.drop_last:
            return self.n // self.num_shards
        return -(-self.n // self.num_shards)  # ceil

    def indices(self, epoch: int | None = None) -> np.ndarray:
        epoch = self.epoch if epoch is None else epoch
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(
                self.n)
        else:
            order = np.arange(self.n)
        total = self.shard_size * self.num_shards
        if self.drop_last:
            order = order[:total]
        elif total > self.n:  # pad by wrap-around, as DistributedSampler does
            order = np.concatenate([order, order[: total - self.n]])
        return order[self.shard :: self.num_shards]
