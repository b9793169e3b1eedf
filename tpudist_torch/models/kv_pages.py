"""Paged KV cache: the host-side block-pool allocator, page table and
prefix cache (counterpart of :mod:`tpudist.models.kv_pages`).

The dense serve cache holds ``num_slots x max_seq_len`` K/V positions per
layer whatever the requests use.  The paged layout (PagedAttention, vLLM
SOSP '23) keeps ONE block pool per layer (``[num_blocks, block_size,
Hkv*D]`` on the device) plus a per-slot PAGE TABLE (``[num_slots,
max_blocks_per_slot]`` int32 pool indices): slot ``b``'s logical position
``p`` lives at ``pool[table[b, p // block_size], p % block_size]``, so KV
memory scales with the tokens requests reserve.

This module is the HOST half and is plain Python and numpy, the same
algorithm as the JAX package's so the two produce the same tables, free
lists and hashes from the same operations:

* **allocate-on-admit**: admission allocates blocks covering the prompt
  and RESERVES the rest of the worst-case footprint ``min(prompt +
  max_new_tokens, max_seq_len)``, so growth never fails mid-flight;
* **grow-on-decode-boundary**: before each segment every live slot's
  coverage advances by ``steps_per_sync`` tokens from its reservation;
* **free-on-finalize**: a finished request returns its blocks and its
  unused reservation at once.

Prefix sharing adds copy-on-write aliasing: per-block REFCOUNTS,
:meth:`BlockPool.share` (a cached prefix aliased read-only under a new
slot's leading positions), :meth:`BlockPool.cow_write` (the one legal
write into a shared region, the last shared block of a full-prompt hit,
moved onto a private copy) and :class:`PrefixCache` (rolling blake2b
hash chains to pool blocks, pinned so idle prefixes survive
``free_slot``, evicted LRU over refcount-0 entries on demand).

The tallies are plain attributes (:attr:`BlockPool.cow_splits`,
:attr:`PrefixCache.hits` / ``hit_tokens`` / ``evictions``, and the
``used_blocks`` / ``free_blocks`` / ``frag`` properties) and, under the
JAX module's names, :mod:`tpudist_torch.obs` metrics: the
``serve/kv_blocks_used`` / ``serve/kv_blocks_free`` / ``serve/kv_frag``
gauges and ``serve/cow_splits``, and the ``serve/prefix_*`` counters and
gauge.

The device half lives in :mod:`tpudist_torch.models.transformer`
(``CausalSelfAttention._paged_attend``) and
:func:`tpudist_torch.ops.flash_decode.paged_flash_decode` (kernel K5).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from collections.abc import Callable, Sequence

import numpy as np

from tpudist_torch import obs


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to cover ``tokens`` positions (ceil division)."""
    return -(-int(tokens) // block_size)


def _hash_bytes(data: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "big")


def chain_hashes(tokens: Sequence[int], block_size: int) -> list[int]:
    """Rolling hash chain over ``tokens``, one link per FULL block.

    Link ``j`` hashes block ``j``'s tokens together with link ``j-1``, so
    it names the block's content AND the entire prefix before it: two
    prompts share link ``j`` iff their first ``(j+1)*block_size`` tokens
    are identical.  blake2b over the int32 byte encoding keeps the chain
    deterministic across processes (and equal to the JAX package's)."""
    toks = np.asarray(tokens, np.int32)
    out: list[int] = []
    prev = b""
    for j in range(len(toks) // block_size):
        prev = hashlib.blake2b(
            prev + toks[j * block_size:(j + 1) * block_size].tobytes(),
            digest_size=8).digest()
        out.append(int.from_bytes(prev, "big"))
    return out


def request_prefix_hash(tokens: Sequence[int]) -> int:
    """64-bit hash of a token span, for wire-level prefix affinity:
    clients stamp ``Request.prefix_hash`` with it over the shared prefix
    they know about (a tenant's system prompt, say).  Opaque end to end —
    nothing needs to agree on block sizes."""
    return _hash_bytes(np.asarray(tokens, np.int32).tobytes())


class BlockPool:
    """Host-side allocator for the paged KV cache.

    Args:
      num_blocks: pool capacity (the device pools' leading dim).
      block_size: tokens per block; a positive multiple of 8 (the JAX
        kernel's sublane tile; the port keeps the contract, and kernel
        K5's 16-byte row loads need nothing more).
      num_slots: decode lanes (page-table rows).
      max_seq_len: model context; bounds ``max_blocks_per_slot``.

    The page table (:attr:`table`) is a ``[num_slots,
    max_blocks_per_slot]`` int32 array; rows fill left to right with the
    slot's blocks and UNALLOCATED entries hold 0 — a valid pool index (the
    per-row length is what keeps the kernel from following them).
    """

    def __init__(self, num_blocks: int, block_size: int, num_slots: int,
                 max_seq_len: int) -> None:
        if block_size < 8 or block_size % 8:
            raise ValueError(
                f"block_size must be a positive multiple of 8, got "
                f"{block_size}")
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_slots = int(num_slots)
        self.max_blocks_per_slot = blocks_for(max_seq_len, block_size)
        self.max_seq_len = int(max_seq_len)
        # LIFO free list: recently freed (hot) blocks are reused first
        self._free: list[int] = list(range(self.num_blocks - 1, -1, -1))
        self._slot_blocks: list[list[int]] = [[] for _ in range(num_slots)]
        # per-slot tokens covered so far (the grow watermark) and the
        # reservation cap (min(prompt + max_new, max_seq_len))
        self._watermark = [0] * num_slots
        self._cap = [0] * num_slots
        self._reserved_total = 0  # blocks promised but not yet allocated
        # COW bookkeeping: per-block slot-reference counts, the blocks the
        # prefix cache pins, and per-slot count of leading SHARED blocks
        self._refcount = [0] * self.num_blocks
        self._pinned: set[int] = set()
        self._shared_upto = [0] * num_slots
        self._prompt_len = [0] * num_slots
        # set by PrefixCache: frees >= 1 refcount-0 cached block on demand
        self._evict_hook: Callable[[], bool] | None = None
        # slots whose KV is being exported: slot -> the frozen block list.
        # Until complete_export or abort_export the slot may not be freed,
        # grown or COW-split.
        self._migrating: dict[int, list[int]] = {}
        self.table = np.zeros(
            (num_slots, self.max_blocks_per_slot), np.int32)
        self.cow_splits = 0       # copy-on-write splits (serve/cow_splits)
        self._obs_used = obs.gauge("serve/kv_blocks_used", unit="blocks")
        self._obs_free = obs.gauge("serve/kv_blocks_free", unit="blocks")
        self._obs_frag = obs.gauge("serve/kv_frag", unit="fraction")
        self._obs_cow = obs.counter("serve/cow_splits", unit="blocks")
        self._publish()

    # -- accounting --------------------------------------------------------

    def _evictable(self) -> int:
        """Cached-but-idle blocks: pinned by the prefix cache, referenced
        by no slot — reclaimable on demand through the eviction hook."""
        return sum(1 for b in self._pinned if self._refcount[b] == 0)

    @property
    def free_blocks(self) -> int:
        """Blocks neither live nor promised to a reservation.  Counts
        cached-but-idle blocks: they are evicted on demand, so they ARE
        capacity."""
        return len(self._free) + self._evictable() - self._reserved_total

    @property
    def used_blocks(self) -> int:
        """Blocks holding live, non-reclaimable data (a drained pool with
        a warm prefix cache is still drained)."""
        return self.num_blocks - len(self._free) - self._evictable()

    @property
    def frag(self) -> float:
        """Internal fragmentation of the LIVE set: the fraction of live
        token slots under no slot's coverage watermark, clamped to [0, 1]
        (shared blocks are counted once but covered by several slots)."""
        live = {b for blks in self._slot_blocks for b in blks}
        alloc_tokens = len(live) * self.block_size
        if not alloc_tokens:
            return 0.0
        return min(1.0, max(0.0, 1.0 - sum(self._watermark) / alloc_tokens))

    def _publish(self) -> None:
        """The occupancy gauges (free counts cached-but-idle blocks, as
        the router's load signal wants)."""
        evictable = self._evictable()
        self._obs_used.set(self.num_blocks - len(self._free) - evictable)
        self._obs_free.set(len(self._free) + evictable)
        self._obs_frag.set(self.frag)

    def check(self) -> None:
        """Allocator invariants: refcounts match slot references, nothing
        both free and referenced or pinned, shared blocks never writable,
        reservation arithmetic consistent, exporting slots frozen."""
        counts = [0] * self.num_blocks
        for slot, blks in enumerate(self._slot_blocks):
            if len(blks) != len(set(blks)):
                raise AssertionError(
                    f"slot {slot} references a block twice: {blks}")
            for blk in blks:
                counts[blk] += 1
        if counts != self._refcount:
            bad = [b for b in range(self.num_blocks)
                   if counts[b] != self._refcount[b]]
            raise AssertionError(
                f"refcount drift on blocks {bad}: "
                f"counted {[counts[b] for b in bad]}, "
                f"recorded {[self._refcount[b] for b in bad]}")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate blocks on the free list")
        bad = [b for b in free if counts[b] or b in self._pinned]
        if bad:
            raise AssertionError(
                f"blocks both free and referenced/pinned: {bad}")
        live = {b for b in range(self.num_blocks) if counts[b]}
        idle_cached = {b for b in self._pinned if not counts[b]}
        if len(live) + len(idle_cached) + len(free) != self.num_blocks:
            raise AssertionError(
                "leaked blocks: live + cached-idle + free != pool")
        for slot, blks in enumerate(self._slot_blocks):
            for j, blk in enumerate(blks):
                # a slot writes block j only past its shared boundary AND
                # past its prompt: an aliased or pinned block there is a
                # latent corruption
                writable = (j >= self._shared_upto[slot]
                            and (j + 1) * self.block_size
                            > self._prompt_len[slot])
                if writable and counts[blk] > 1:
                    raise AssertionError(
                        f"block {blk} aliased by {counts[blk]} slots but "
                        f"writable from slot {slot} (index {j}, shared "
                        f"boundary {self._shared_upto[slot]}, prompt "
                        f"{self._prompt_len[slot]})")
                if writable and blk in self._pinned:
                    raise AssertionError(
                        f"pinned block {blk} in slot {slot}'s writable "
                        "region — decode writes would corrupt the cache")
        if self._reserved_total < 0 or self._reserved_total > (
                len(self._free) + len(idle_cached)):
            raise AssertionError(
                f"reservation {self._reserved_total} outside reclaimable "
                f"capacity {len(self._free)} + {len(idle_cached)}")
        for slot, snapshot in self._migrating.items():
            if self._slot_blocks[slot] != snapshot:
                raise AssertionError(
                    f"slot {slot} mutated mid-migration: exported "
                    f"{snapshot}, now holds {self._slot_blocks[slot]}")
            bad = [b for b in snapshot if b in free]
            if bad:
                raise AssertionError(
                    f"in-migration blocks of slot {slot} on the free "
                    f"list: {bad}")
            bad = [b for b in snapshot if self._refcount[b] < 1]
            if bad:
                raise AssertionError(
                    f"in-migration blocks of slot {slot} unreferenced: "
                    f"{bad}")

    # -- allocation --------------------------------------------------------

    def request_blocks(self, prompt_len: int, max_new_tokens: int) -> int:
        """The full worst-case footprint of a request, in blocks."""
        total = min(prompt_len + max_new_tokens, self.max_seq_len)
        return blocks_for(total, self.block_size)

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  shared: int = 0, cow: int = 0) -> bool:
        """``shared`` blocks arrive by aliasing (no allocation); ``cow`` is
        the extra private block a copy-on-write split draws right after
        admit (full-prompt cache hits)."""
        return (self.request_blocks(prompt_len, max_new_tokens)
                - shared + cow <= self.free_blocks)

    def _take_block(self) -> int:
        if not self._free and not (
                self._evict_hook is not None and self._evict_hook()):
            raise RuntimeError("block pool exhausted")
        return self._free.pop()

    def admit(self, slot: int, prompt_len: int, max_new_tokens: int,
              shared: Sequence[int] = ()) -> None:
        """Allocate blocks covering the prompt and reserve the rest of the
        request's footprint; ``shared`` aliases existing blocks (refcount
        +1) under the slot's leading positions.  The caller checked
        :meth:`can_admit` with the same ``shared`` count (raises
        ``RuntimeError`` otherwise)."""
        if self._slot_blocks[slot]:
            raise RuntimeError(f"slot {slot} still holds blocks; "
                               "free_slot it before re-admitting")
        total = self.request_blocks(prompt_len, max_new_tokens)
        now = blocks_for(prompt_len, self.block_size)
        if len(shared) > now:
            raise ValueError(
                f"{len(shared)} shared blocks exceed the prompt's "
                f"{now}-block footprint")
        if total - len(shared) > self.free_blocks:
            raise RuntimeError(
                f"admit of {total - len(shared)} blocks exceeds free "
                f"{self.free_blocks} (call can_admit first)")
        self._cap[slot] = min(prompt_len + max_new_tokens,
                              self.max_seq_len)
        self._reserved_total += total - now
        if shared:
            self.share(slot, shared)
        self._grow_to(slot, now)
        self._watermark[slot] = prompt_len
        self._prompt_len[slot] = prompt_len
        self._publish()

    def share(self, slot: int, blocks: Sequence[int]) -> None:
        """Alias ``blocks`` under ``slot``'s leading positions (refcount
        +1 each).  The slot must be empty: a shared prefix comes first in
        a sequence, and is read-only for the slot except for the
        :meth:`cow_write` split of its final block."""
        blks = self._slot_blocks[slot]
        if blks:
            raise RuntimeError(
                f"share() into non-empty slot {slot}: a shared prefix "
                "must precede any private blocks")
        for blk in blocks:
            self._refcount[blk] += 1
            self.table[slot, len(blks)] = blk
            blks.append(blk)
        self._shared_upto[slot] = len(blks)

    def cow_write(self, slot: int, block_idx: int) -> int:
        """Make ``slot``'s block at ``block_idx`` privately writable,
        splitting (new private block, old refcount -1) if it is aliased or
        pinned.  Only the LAST shared block is a legal target.  Returns the
        block now under the slot; the caller's insert rewrites its content
        from the recomputed dense cache, which IS the copy."""
        if slot in self._migrating:
            raise RuntimeError(
                f"cow_write on slot {slot} while its KV is in migration")
        blks = self._slot_blocks[slot]
        old = blks[block_idx]
        if self._refcount[old] == 1 and old not in self._pinned:
            return old  # already private — write in place
        if block_idx != self._shared_upto[slot] - 1:
            raise RuntimeError(
                f"cow_write at index {block_idx} of slot {slot}, but only "
                f"the last shared block "
                f"({self._shared_upto[slot] - 1}) is writable")
        new = self._take_block()
        self._refcount[old] -= 1
        self._refcount[new] = 1
        blks[block_idx] = new
        self.table[slot, block_idx] = new
        self._shared_upto[slot] = block_idx
        self.cow_splits += 1
        self._obs_cow.inc()
        self._publish()
        return new

    def grow(self, slot: int, steps: int) -> None:
        """Advance ``slot``'s coverage by ``steps`` decode tokens (capped
        at its reservation), drawing on the reserved budget — this never
        fails for an admitted slot."""
        if slot in self._migrating:
            raise RuntimeError(
                f"grow on slot {slot} while its KV is in migration")
        target = min(self._watermark[slot] + steps, self._cap[slot])
        need = blocks_for(target, self.block_size)
        have = len(self._slot_blocks[slot])
        if need > have:
            self._reserved_total -= need - have
            self._grow_to(slot, need)
        self._watermark[slot] = target
        self._publish()

    def _grow_to(self, slot: int, count: int) -> None:
        blks = self._slot_blocks[slot]
        while len(blks) < count:
            blk = self._take_block()
            self._refcount[blk] = 1
            self.table[slot, len(blks)] = blk
            blks.append(blk)

    def free_slot(self, slot: int) -> None:
        """Drop ``slot``'s block references and its unused reservation;
        blocks reaching refcount 0 return to the free list unless the
        prefix cache pins them (those stay as cached-idle capacity)."""
        if slot in self._migrating:
            raise RuntimeError(
                f"free_slot on slot {slot} while its KV is in migration; "
                "complete_export or abort_export it first")
        blks = self._slot_blocks[slot]
        held = blocks_for(self._cap[slot], self.block_size) if blks else 0
        self._reserved_total -= max(held - len(blks), 0)
        drop = []
        for blk in blks:
            self._refcount[blk] -= 1
            if not self._refcount[blk] and blk not in self._pinned:
                drop.append(blk)
        self._free.extend(reversed(drop))
        blks.clear()
        self.table[slot, :] = 0
        self._watermark[slot] = 0
        self._cap[slot] = 0
        self._shared_upto[slot] = 0
        self._prompt_len[slot] = 0
        self._publish()

    # -- KV export and adoption --------------------------------------------

    def export_slot(self, slot: int) -> dict:
        """Begin exporting ``slot``'s KV: returns the manifest (the
        ORDERED block list, prompt length, watermark, shared boundary,
        block size) and freezes the slot until :meth:`complete_export` or
        :meth:`abort_export`."""
        blks = self._slot_blocks[slot]
        if not blks:
            raise RuntimeError(f"export_slot on empty slot {slot}")
        if slot in self._migrating:
            raise RuntimeError(f"slot {slot} already in migration")
        self._migrating[slot] = list(blks)
        return {
            "blocks": list(blks),
            "prompt_len": self._prompt_len[slot],
            "watermark": self._watermark[slot],
            "shared_upto": self._shared_upto[slot],
            "block_size": self.block_size,
        }

    def complete_export(self, slot: int) -> None:
        """Ack ``slot``'s export: the freeze lifts and the slot frees."""
        if slot not in self._migrating:
            raise RuntimeError(f"slot {slot} is not in migration")
        del self._migrating[slot]
        self.free_slot(slot)

    def abort_export(self, slot: int) -> None:
        """Cancel ``slot``'s export without freeing it (the export never
        mutated it)."""
        self._migrating.pop(slot, None)

    def adopt_blocks(self, slot: int, prompt_len: int,
                     max_new_tokens: int) -> list[int]:
        """Private pages for a migrated-in sequence: fresh blocks covering
        ``prompt_len`` positions plus :meth:`admit`'s reservation; the
        caller scatters the received K/V into the returned blocks."""
        self.admit(slot, prompt_len, max_new_tokens)
        return list(self._slot_blocks[slot])

    # -- prefix-cache pinning ----------------------------------------------

    def cache_pin(self, blk: int) -> None:
        self._pinned.add(blk)

    def cache_unpin(self, blk: int) -> None:
        """Drop the cache's pin; a block no slot references returns to the
        free list at once."""
        self._pinned.discard(blk)
        if not self._refcount[blk]:
            self._free.append(blk)
        self._publish()

    def alloc_cached_block(self) -> int | None:
        """A plain-free block, taken and PINNED as cached-idle (refcount
        0): the landing page of an install whose bytes arrive by scatter.
        Never evicts (installing one cached block must not page another
        out); ``None`` when only reclaimable-cached capacity is left."""
        if not self._free:
            return None
        blk = self._free.pop()
        self._pinned.add(blk)
        self._publish()
        return blk


class PrefixCache:
    """Host-side map from rolling prefix-hash chains to pool blocks.

    One entry per FULL block of a registered prompt (``chain_hashes(
    prompt)[j] -> block``).  :meth:`match` walks a new prompt's chain and
    collects blocks while hashes hit: the longest cached, block-aligned
    prefix.  Entries PIN their blocks, so an idle prefix survives
    ``free_slot``; eviction is LRU over entries no live slot references,
    run on demand by the pool when its free list is empty.  Registration
    is first-wins.

    Tallies (the JAX package's obs counters): :attr:`hits` (matches that
    found at least one block), :attr:`hit_tokens`, :attr:`evictions`.
    """

    def __init__(self, pool: BlockPool,
                 capacity_blocks: int | None = None) -> None:
        self.pool = pool
        self.capacity_blocks = capacity_blocks
        self._entries: OrderedDict[int, int] = OrderedDict()
        # chain-parent links (hash -> previous chain hash, None for a
        # prompt's first block), forwarded to the spill hook
        self._parent: dict[int, int | None] = {}
        # called as spill_hook(hash, block, parent) just before an evicted
        # block's pin drops (a host tier's chance to copy its bytes)
        self.spill_hook: Callable[[int, int, int | None], None] | None \
            = None
        pool._evict_hook = self._evict_for_pool
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0
        self._obs_hits = obs.counter("serve/prefix_hits", unit="requests")
        self._obs_hit_tokens = obs.counter(
            "serve/prefix_hit_tokens", unit="tokens")
        self._obs_evictions = obs.counter(
            "serve/prefix_evictions", unit="blocks")
        self._obs_cached = obs.gauge(
            "serve/prefix_cached_blocks", unit="blocks")

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, tokens: Sequence[int]) -> list[int]:
        """Blocks covering the longest cached prefix of ``tokens``.
        Touches the matched entries' LRU recency but takes no references:
        the caller aliases them through ``admit(..., shared=...)``."""
        out: list[int] = []
        for h in chain_hashes(tokens, self.pool.block_size):
            blk = self._entries.get(h)
            if blk is None:
                break
            self._entries.move_to_end(h)
            out.append(blk)
        if out:
            self.hits += 1
            self.hit_tokens += len(out) * self.pool.block_size
            self._obs_hits.inc()
            self._obs_hit_tokens.inc(len(out) * self.pool.block_size)
        return out

    def peek(self, tokens: Sequence[int]) -> int:
        """Matched block count WITHOUT touching recency or the tallies
        (admission control's capacity precheck)."""
        n = 0
        for h in chain_hashes(tokens, self.pool.block_size):
            if h not in self._entries:
                break
            n += 1
        return n

    def register(self, tokens: Sequence[int],
                 slot_blocks: Sequence[int]) -> int:
        """Pin and index ``tokens``'s fully covered blocks (first-wins per
        hash); ``slot_blocks`` is the owning slot's block list.  Returns
        the number of newly registered blocks."""
        added = 0
        hashes = chain_hashes(tokens, self.pool.block_size)
        for j, h in enumerate(hashes):
            if h in self._entries:
                self._entries.move_to_end(h)
                continue
            while (self.capacity_blocks is not None
                   and len(self._entries) >= self.capacity_blocks):
                if not self.evict_one():
                    break
            if (self.capacity_blocks is not None
                    and len(self._entries) >= self.capacity_blocks):
                break
            self._entries[h] = slot_blocks[j]
            self._parent[h] = hashes[j - 1] if j else None
            self.pool.cache_pin(slot_blocks[j])
            added += 1
        self._obs_cached.set(len(self._entries))
        self.pool._publish()
        return added

    def install(self, h: int, blk: int, parent: int | None) -> None:
        """Index an externally filled cached-idle block (from
        :meth:`BlockPool.alloc_cached_block`) under ``h``."""
        if h in self._entries:
            raise RuntimeError(
                f"install of already-resident prefix hash {h}")
        if blk not in self.pool._pinned or self.pool._refcount[blk]:
            raise RuntimeError(
                f"install target block {blk} is not cached-idle "
                "(use alloc_cached_block)")
        self._entries[h] = blk
        self._parent[h] = parent
        self._obs_cached.set(len(self._entries))
        self.pool._publish()

    def evict_one(self) -> bool:
        """Drop the least recently used entry whose block no live slot
        references.  False when every entry is in use."""
        for h, blk in self._entries.items():  # OrderedDict: LRU first
            if not self.pool._refcount[blk]:
                del self._entries[h]
                parent = self._parent.pop(h, None)
                if self.spill_hook is not None:
                    self.spill_hook(h, blk, parent)
                self.pool.cache_unpin(blk)
                self.evictions += 1
                self._obs_evictions.inc()
                self._obs_cached.set(len(self._entries))
                return True
        return False

    def _evict_for_pool(self) -> bool:
        """Pool callback: free at least one block into the free list."""
        return self.evict_one()

    def flush(self) -> None:
        """Drop every entry (cached KV is invalid once weights change).
        Blocks still referenced by live slots just lose their pin."""
        for h, blk in list(self._entries.items()):
            del self._entries[h]
            self.pool.cache_unpin(blk)
        self._parent.clear()
        self._obs_cached.set(0)
