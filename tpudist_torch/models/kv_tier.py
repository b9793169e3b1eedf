"""Host-RAM KV spill tier: the second level of the KV memory hierarchy
(counterpart of :mod:`tpudist.models.kv_tier`).

When the prefix cache (:class:`~tpudist_torch.models.kv_pages.PrefixCache`)
evicts an idle block under pool pressure, the :class:`ServeLoop
<tpudist_torch.models.serving.ServeLoop>` copies its pages into pinned
host memory and files them here under the block's rolling chain hash (the
hash names the block's content and its whole prefix, so a tier hit is as
trustworthy as a cache hit).  A later admission whose chain walk runs past
the pool-resident prefix continues into the tier and re-admits the
spilled blocks (a host-to-device copy on a side stream) instead of
re-prefilling them.  A preempted lane's pages park here block by block.

State machine of one chain hash ``h``::

      (uncached) --register--> pool-resident --evict+spill--> TIERED
          ^                        ^                            |
          |                        +---------re-admit-----------+
          +-----flush / budget-evict / version-mismatch---------+

A hash is never tiered and pool-resident at once (:meth:`check`).
Eviction is LRU over chain LEAVES only (an entry with a tier-resident
child stays: a chain walk needs consecutive hits), within the byte
budget of ``TPUDIST_KV_HOST_TIER_BYTES``.  Entries carry the weights
version they were computed under; a lookup under another version drops
the entry.

The tier itself only files what it is given: the serve loop hands it
host tensors (pinned when the pool lives on a card).  Its counters are
plain attributes: ``hits``, ``spills``, ``evictions`` and ``readmits`` in
blocks, ``spilled_bytes`` and ``readmitted_bytes``; under the JAX module's
names they are also :mod:`tpudist_torch.obs` metrics (``serve/tier_*``).
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from tpudist_torch import obs

__all__ = ["HostTier", "tier_budget_from_env", "DEFAULT_TIER_BYTES"]

# tpudist's default budget; TPUDIST_KV_HOST_TIER_BYTES=0 disables the tier
DEFAULT_TIER_BYTES = 64 * 1024 * 1024


def tier_budget_from_env(default: int = DEFAULT_TIER_BYTES) -> int:
    """Host-tier byte budget from ``TPUDIST_KV_HOST_TIER_BYTES``; ``0``
    (or any unparsable value) disables the tier."""
    raw = os.environ.get("TPUDIST_KV_HOST_TIER_BYTES")
    if raw is None:
        return int(default)
    try:
        return max(0, int(raw))
    except ValueError:
        return 0


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


class HostTier:
    """Bounded host-RAM store of spilled KV blocks, keyed by chain hash.

    One entry per block: ``hash -> {"layers": [{"k": [bs, F], "v": [bs,
    F]}, ...] (host tensors, one dict per paged layer in cache order),
    "parent": the previous chain link or None, "version": the weights
    version, "nbytes": the page bytes held}``."""

    def __init__(self, budget_bytes: int) -> None:
        self.budget_bytes = max(0, int(budget_bytes))
        self._entries: OrderedDict[int, dict] = OrderedDict()
        # _children[h]: tier-resident hashes whose parent link is h (an
        # entry with resident children is mid-chain, not evictable)
        self._children: dict[int, set[int]] = {}
        self._nbytes = 0
        self.hits = self.spills = self.evictions = self.readmits = 0
        self.spilled_bytes = self.readmitted_bytes = 0
        self._obs_blocks = obs.gauge("serve/tier_blocks", unit="blocks")
        self._obs_bytes = obs.gauge("serve/tier_bytes", unit="bytes")
        self._obs_budget = obs.gauge("serve/tier_budget_bytes",
                                     unit="bytes")
        self._obs_hits = obs.counter("serve/tier_hits", unit="blocks")
        self._obs_spills = obs.counter("serve/tier_spills", unit="blocks")
        self._obs_evictions = obs.counter("serve/tier_evictions",
                                          unit="blocks")
        self._obs_readmits = obs.counter("serve/tier_readmits",
                                         unit="blocks")
        self._obs_budget.set(self.budget_bytes)
        self._publish()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, h: int) -> bool:
        return int(h) in self._entries

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def hashes(self) -> list[int]:
        """Resident chain hashes, least recently used first."""
        return list(self._entries)

    def _publish(self) -> None:
        self._obs_blocks.set(len(self._entries))
        self._obs_bytes.set(self._nbytes)

    @staticmethod
    def _layers_nbytes(layers: list[dict]) -> int:
        return int(sum(l["k"].numel() * l["k"].element_size()
                       + l["v"].numel() * l["v"].element_size()
                       for l in layers))

    def put(self, h: int, layers: list[dict], *, parent: int | None,
            version: int = 0) -> bool:
        """File one spilled block (its host tensors are kept, not
        copied).  First wins per hash: a resident entry keeps its bytes
        and only moves to most recently used.  False when the tier is
        disabled, the entry alone exceeds the budget, or eviction cannot
        make room."""
        h = int(h)
        if h in self._entries:
            self._entries.move_to_end(h)
            return True
        layers = [{"k": _as_tensor(l["k"]), "v": _as_tensor(l["v"])}
                  for l in layers]
        n = self._layers_nbytes(layers)
        if not self.budget_bytes or n > self.budget_bytes:
            return False
        while self._nbytes + n > self.budget_bytes:
            if not self.evict_one():
                return False
        self._entries[h] = {"layers": layers, "parent": parent,
                            "version": int(version), "nbytes": n}
        if parent is not None:
            self._children.setdefault(int(parent), set()).add(h)
        self._nbytes += n
        self.spills += 1
        self.spilled_bytes += n
        self._obs_spills.inc()
        self._publish()
        return True

    def has(self, h: int, *, version: int | None = None) -> bool:
        """Residency under ``version`` (None: any), with no recency touch
        and no counter."""
        e = self._entries.get(int(h))
        if e is None:
            return False
        return version is None or e["version"] == int(version)

    def match_chain(self, hashes, *, version: int | None = None) -> int:
        """Length of the longest leading run of ``hashes`` resident under
        ``version``."""
        n = 0
        for h in hashes:
            if not self.has(h, version=version):
                break
            n += 1
        return n

    def take(self, h: int, *, version: int | None = None) -> list | None:
        """Remove and return ``h``'s layers for re-admission (a hit and a
        re-admit).  A version mismatch drops the entry and returns None:
        KV of other weights never flows back into the pool."""
        h = int(h)
        e = self._entries.get(h)
        if e is None:
            return None
        if version is not None and e["version"] != int(version):
            self._remove(h)
            self._publish()
            return None
        self._remove(h)
        self.hits += 1
        self.readmits += 1
        self.readmitted_bytes += e["nbytes"]
        self._obs_hits.inc()
        self._obs_readmits.inc()
        self._publish()
        return e["layers"]

    def peek_layers(self, h: int, *,
                    version: int | None = None) -> list | None:
        """``h``'s layers without removal (a pull-mode export reads them
        in place); a hit, and ``h`` becomes most recently used."""
        e = self._entries.get(int(h))
        if e is None:
            return None
        if version is not None and e["version"] != int(version):
            return None
        self._entries.move_to_end(int(h))
        self.hits += 1
        self._obs_hits.inc()
        return e["layers"]

    def _remove(self, h: int) -> None:
        e = self._entries.pop(h)
        self._nbytes -= e["nbytes"]
        parent = e["parent"]
        if parent is not None:
            sibs = self._children.get(int(parent))
            if sibs is not None:
                sibs.discard(h)
                if not sibs:
                    del self._children[int(parent)]

    def discard(self, h: int) -> None:
        """Drop ``h`` if resident, with no counter: the caller just made
        it pool-resident again, and a hash is never in both."""
        if int(h) in self._entries:
            self._remove(int(h))
            self._publish()

    def evict_one(self) -> bool:
        """Evict the least recently used chain leaf; False when the tier
        is empty (a finite parent forest always has a leaf)."""
        for h in self._entries:
            if not self._children.get(h):
                self._remove(h)
                self.evictions += 1
                self._obs_evictions.inc()
                self._publish()
                return True
        return False

    def flush(self) -> None:
        """Drop everything (a weight hot-swap invalidates cached KV)."""
        self._entries.clear()
        self._children.clear()
        self._nbytes = 0
        self._publish()

    def check(self, resident_hashes=()) -> None:
        """The tier's invariants: byte accounting exact, the budget kept,
        the children index derived exactly from the resident parent
        links, and no hash both tiered and in ``resident_hashes`` (the
        prefix cache's keys)."""
        n = sum(e["nbytes"] for e in self._entries.values())
        if n != self._nbytes:
            raise AssertionError(
                f"tier byte drift: entries hold {n}, recorded "
                f"{self._nbytes}")
        for h, e in self._entries.items():
            if e["nbytes"] != self._layers_nbytes(e["layers"]):
                raise AssertionError(f"tier entry {h} nbytes drift")
        if self.budget_bytes and self._nbytes > self.budget_bytes:
            raise AssertionError(
                f"tier over budget: {self._nbytes} > {self.budget_bytes}")
        want: dict[int, set[int]] = {}
        for h, e in self._entries.items():
            if e["parent"] is not None:
                want.setdefault(int(e["parent"]), set()).add(h)
        if want != self._children:
            raise AssertionError(
                f"tier children index drift: derived {want}, "
                f"recorded {self._children}")
        both = set(self._entries) & {int(h) for h in resident_hashes}
        if both:
            raise AssertionError(
                f"hashes simultaneously tiered and HBM-resident: "
                f"{sorted(both)}")
